"""The seam of the port's native code, on the CPU: ``native/build.py``'s
build-if-stale rule (with g++), ``native/nvcc.py``'s ``Kernel`` registry
and the captured-step runner that reads it without naming a kernel."""

import ast
import glob
import importlib
import os
import shutil
import time

import pytest

from oatomobile_torch import paths
from oatomobile_torch.native import build, nvcc

OPS_DIR = os.path.join(paths.PACKAGE_DIR, "ops")
WRAPPERS = sorted(os.path.splitext(os.path.basename(path))[0]
                  for path in glob.glob(os.path.join(OPS_DIR, "*_cuda.py")))
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
TAIL = ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Each kernel's nvcc flags and library: a change rebuilds another binary.
COMMANDS = {
    "bev_cuda": ("bev_splat", ARCH + TAIL + ("-I", nvcc.CSRC)),
    "depthwise_cuda": ("depthwise_conv", ARCH + ("-fmad=false",) + TAIL),
    "dim_plan_cuda": ("dim_plan", ARCH + ("-fmad=false",) + TAIL),
    "group_norm_cuda": ("group_norm", ARCH + ("-fmad=false",) + TAIL),
}


def test_every_kernel_wrapper_is_listed():
  assert WRAPPERS == sorted(COMMANDS)


@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_each_wrapper_holds_one_registered_kernel(wrapper):
  module = importlib.import_module("oatomobile_torch.ops." + wrapper)
  kernels = [value for value in vars(module).values()
             if isinstance(value, nvcc.Kernel)]
  assert kernels == [module.KERNEL]
  assert nvcc.KERNELS.count(module.KERNEL) == 1
  for name in ("build", "_library", "launches", "build_log",
               "build_seconds"):
    assert not hasattr(module, name), name


@pytest.mark.parametrize("wrapper", sorted(COMMANDS))
def test_each_kernel_keeps_its_nvcc_command(wrapper):
  kernel = importlib.import_module("oatomobile_torch.ops." + wrapper).KERNEL
  name, flags = COMMANDS[wrapper]
  assert kernel.name == name and kernel.flags == flags
  assert kernel.path == os.path.join(paths.BUILD_DIR, "kernels",
                                     "lib{}.so".format(name))
  assert kernel.source == os.path.join(nvcc.CSRC, name + ".cu")
  for path in (kernel.source, *kernel.headers):
    assert os.path.exists(path), path


def test_the_step_runner_names_no_kernel():
  path = os.path.join(paths.PACKAGE_DIR, "graphs.py")
  with open(path) as fp:
    source = fp.read()
  imported = []
  for node in ast.walk(ast.parse(source)):
    if isinstance(node, ast.Import):
      imported += [alias.name for alias in node.names]
    elif isinstance(node, ast.ImportFrom):
      imported += [node.module] + [node.module + "." + alias.name
                                   for alias in node.names]
  assert not [m for m in imported if m.startswith("oatomobile_torch.ops")]
  for wrapper in WRAPPERS:
    assert wrapper not in source


def test_a_failed_launch_raises_in_the_kernels_words(monkeypatch):
  monkeypatch.setattr(nvcc, "KERNELS", [])
  kernel = nvcc.Kernel("probe", "probe.cu", (), lambda lib: lib)
  assert nvcc.KERNELS == [kernel] and not kernel.loaded
  kernel.check(0)
  with pytest.raises(RuntimeError,
                     match="probe kernel launch failed: CUDA error 700"):
    kernel.check(700)
  assert kernel.launches == 0  # the wrapper counts, not the check


# -- compile_library ----------------------------------------------------------


@pytest.fixture
def gxx():
  found = shutil.which("g++")
  if found is None:
    pytest.skip("needs g++")
  return [found, "-O0", "-shared", "-fPIC"]


def _sources(tmp_path, body="int seam_value() { return VALUE; }\n"):
  header = tmp_path / "value.h"
  header.write_text("#define VALUE 7\n")
  source = tmp_path / "seam.cc"
  source.write_text('#include "value.h"\nextern "C" ' + body)
  return str(source), str(header), str(tmp_path / "out" / "libseam.so")


def _age(path, seconds):
  """Moves ``path``'s mtime ``seconds`` into the past."""
  when = time.time() - seconds
  os.utime(path, (when, when))


def test_compile_library_builds_once_while_up_to_date(tmp_path, gxx):
  source, header, library = _sources(tmp_path)
  log, seconds = build.compile_library(gxx, source, library, (header,))
  assert isinstance(log, str) and seconds > 0 and os.path.exists(library)
  built = os.path.getmtime(library)
  assert build.compile_library(gxx, source, library, (header,)) is None
  assert os.path.getmtime(library) == built
  assert os.listdir(os.path.dirname(library)) == ["libseam.so"]


@pytest.mark.parametrize("touched", ["source", "header"])
def test_compile_library_rebuilds_when_a_source_is_newer(tmp_path, gxx,
                                                        touched):
  source, header, library = _sources(tmp_path)
  build.compile_library(gxx, source, library, (header,))
  for path in (source, header, library):
    _age(path, 100)
  os.utime(source if touched == "source" else header)
  assert build.compile_library(gxx, source, library, (header,)) is not None
  assert os.path.getmtime(library) > time.time() - 50


def test_compile_library_raises_and_leaves_no_temporary_file(tmp_path, gxx):
  source, header, library = _sources(tmp_path)
  build.compile_library(gxx, source, library, (header,))
  with open(library, "rb") as fp:
    good = fp.read()
  _age(library, 100)
  with open(source, "a") as fp:
    fp.write("this is not C++;\n")
  with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
    build.compile_library(gxx, source, library, (header,))
  assert os.listdir(os.path.dirname(library)) == ["libseam.so"]
  with open(library, "rb") as fp:
    assert fp.read() == good  # the last good build stays
