"""``oatomobile_torch.sass``: the loops it finds in a SASS listing (the
format ``cuobjdump -sass`` prints), on a made-up listing."""

from oatomobile_torch import sass

LISTING = """
\tcode for sm_90a
\t\tFunction : _Z6kernelPf
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   MOV R1, c[0x0][0x28] ;      /* 0x0 */
        /*0010*/                   FMUL R2, R3, R4 ;           /* 0x0 */
        /*0020*/                   FMUL R5, R3, R4 ;           /* 0x0 */
        /*0030*/                   FADD R2, R2, R5 ;           /* 0x0 */
        /*0040*/                   FMUL R6, R3, R4 ;           /* 0x0 */
        /*0050*/                   FMUL R7, R3, R4 ;           /* 0x0 */
        /*0060*/               @P0 BRA 0x10 ;                  /* 0x0 */
        /*0070*/                   LDS R8, [R9] ;              /* 0x0 */
        /*0080*/              @!P1 BRA 0x0 ;                   /* 0x0 */
        /*0090*/                   BRA 0xb0 ;                  /* 0x0 */
        /*00a0*/                   NOP ;                       /* 0x0 */
        /*00b0*/                   EXIT ;                      /* 0x0 */
"""


def test_parse_reads_every_instruction_of_each_kernel():
  kernels = sass.parse(LISTING)
  assert list(kernels) == ["_Z6kernelPf"]
  instructions = kernels["_Z6kernelPf"]
  assert len(instructions) == 12
  assert instructions[6][:2] == (0x60, "BRA")


def test_loops_are_backward_branches_with_their_bodies():
  loops = sass.loops(sass.parse(LISTING)["_Z6kernelPf"])
  # The forward branch at 0x90 is no loop.
  assert [(l.start, l.end) for l in loops] == [(0x10, 0x60), (0x0, 0x80)]
  inner, outer = loops
  assert inner.instructions == 6 and inner.fmul == 4
  assert inner.tests_per_iteration == 1.0 and inner.innermost
  assert outer.instructions == 9 and not outer.innermost
