"""Where the port writes what it builds: native libraries, the CUDA
kernel and the town caches.

Everything goes under ``build/oatomobile_torch`` beside the package (a
directory ``.gitignore`` lists), resolved from this file and never from
the working directory, so a fresh checkout builds into itself.
``OATOMOBILE_TORCH_BUILD_DIR`` overrides it.
"""

import os

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.environ.get(
    "OATOMOBILE_TORCH_BUILD_DIR",
    os.path.join(os.path.dirname(PACKAGE_DIR), "build", "oatomobile_torch"))
