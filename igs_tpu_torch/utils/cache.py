"""Where the port keeps what it compiles: the persistent build cache of
the CLI drivers.

Counterpart of ``igs_tpu/utils/cache.py``, which points JAX's on-disk
compilation cache at a directory so that repeated runs reuse compiled
executables. The port's compiled artifacts are its built libraries: the
CUDA kernels (``ops/cuda_build.py``, under ``<root>/cuda``) and the host
data plane (``ops/host_build.py``, under ``<root>/host``), each named by a
hash of its source and flags. ``enable_persistent_cache`` sets the root:

* by default ``build/`` of the checkout (listed in ``.gitignore``);
* ``path``, or else ``IGS_TPU_CACHE_DIR``, names another;
* an empty ``IGS_TPU_CACHE_DIR`` builds into a fresh temporary directory
  of this process, removed at exit: every run compiles from clean (the
  JAX helper's empty string turns its cache off).

A root that cannot be written raises: nothing runs without a place to
build. ``train_agm``, ``infer_stream`` and ``build_frame0`` call it where
the JAX CLIs do; without a call the root is the default.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from pathlib import Path
from typing import Optional

DEFAULT_ROOT = Path(__file__).resolve().parents[2] / "build"
ENV = "IGS_TPU_CACHE_DIR"

_root: Optional[Path] = None


def build_root() -> Path:
    """The directory the libraries are built under."""
    return _root or DEFAULT_ROOT


def enable_persistent_cache(path: Optional[str] = None) -> Path:
    """Set the build root (see the module's docstring) and return it; the
    directory is made and must be writable."""
    global _root
    env = os.environ.get(ENV)
    if env == "" and path is None:
        root = Path(tempfile.mkdtemp(prefix="igs_build_"))
        atexit.register(shutil.rmtree, root, ignore_errors=True)
    else:
        root = Path(path or env or DEFAULT_ROOT)
    try:
        root.mkdir(parents=True, exist_ok=True)
        with tempfile.NamedTemporaryFile(dir=root, prefix=".probe_"):
            pass
    except OSError as e:
        raise PermissionError(
            f"build cache {root} cannot be written ({e}); set {ENV} to a "
            "writable directory, or to '' to build into a temporary one"
        ) from e
    _root = root
    return root
