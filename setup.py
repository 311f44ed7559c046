"""Package installer.

Parity: /root/reference/setup.py (sdist packaging); dependency set reduced
to the single JAX stack.
"""

import os

from setuptools import find_packages, setup

_HERE = os.path.dirname(os.path.abspath(__file__))


def _version() -> str:
  about = {}
  with open(os.path.join(_HERE, "oatomobile_tpu", "_metadata.py")) as fp:
    exec(fp.read(), about)  # pylint: disable=exec-used
  return about["__version__"]


setup(
    name="oatomobile-tpu",
    version=_version(),
    description=("A TPU-native research framework for autonomous driving: "
                 "an XLA-compiled world model with the OATomobile API."),
    long_description=open(os.path.join(_HERE, "README.md")).read(),
    long_description_content_type="text/markdown",
    license="Apache License, Version 2.0",
    packages=find_packages(exclude=("tests",)),
    package_data={
        "oatomobile_tpu.benchmarks.carnovel": ["configs/*.json"],
        "oatomobile_tpu.benchmarks.corl2017": ["configs/*.json"],
        "oatomobile_tpu.native": ["*.cc"],
        "oatomobile_torch": ["csrc/*.cu", "csrc/*.cuh"],
        "oatomobile_torch.benchmarks.carnovel": ["configs/*.json"],
        "oatomobile_torch.benchmarks.corl2017": ["configs/*.json"],
        "oatomobile_torch.maps": ["benchmark_tasks.json"],
        "oatomobile_torch.native": ["*.cc"],
    },
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "numpy",
        "scipy",
    ],
    extras_require={
        "torch": ["torch"],       # as_torch dataset adapter
        "tf": ["tensorflow"],     # as_tensorflow dataset adapter
        "viz": ["matplotlib", "imageio"],
        "logging": ["wandb"],
        "test": ["pytest"],
    },
)
