"""What the benchmark runs loads neither JAX nor the JAX package, and the
reference loads nothing of the program; top-level module names are
compared whole (the program's name begins with the JAX package's)."""

import os
import subprocess
import sys

from perfbench import registry

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "oatomobile_tpu")


def _tops(imports: str) -> set:
  code = ("import sys\n" + imports +
          "\nprint(' '.join(sorted({m.split('.', 1)[0] "
          "for m in sys.modules})))")
  env = dict(os.environ, PYTHONPATH=registry.ROOT)
  out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=registry.ROOT, env=env, timeout=300,
                       check=True)
  return set(out.stdout.split())


def test_the_harness_loads_no_jax():
  metrics = "".join(
      "registry.reader({!r})\n".format(m["name"])
      for m in registry.benchmark()["per_layer"])
  tops = _tops("from perfbench import registry, run, report, check, trace\n"
               "from perfbench.drivers import rollout\n"
               "from perfbench.counts import dim_flops, splat, peaks\n"
               "import oatomobile_torch.envs.batched\n"
               "import oatomobile_torch.baselines.learned.dim.policy\n" +
               metrics)
  assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)
  assert "oatomobile_torch" in tops


def test_the_reference_loads_nothing_of_the_program():
  tops = _tops("import perfbench.reference.rollout\n"
               "import perfbench.reference.policy.dim_policy\n"
               "import perfbench.reference.synth\n")
  assert not tops & (set(FORBIDDEN) | {"oatomobile_torch"})


def test_forbidden_loaded_compares_whole_names():
  from perfbench import run  # pylint: disable=import-outside-toplevel
  sys.modules.setdefault("jaxlike_probe", sys)
  try:
    assert "jaxlike_probe" not in run.forbidden_loaded()
  finally:
    del sys.modules["jaxlike_probe"]
