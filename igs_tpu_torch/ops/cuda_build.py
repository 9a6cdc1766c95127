"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source in ``igs_tpu_torch/csrc`` becomes a shared library with a
plain C interface, compiled for Hopper (``sm_90a``) at first use into
``<root>/cuda/``, the root being ``build/`` of the checkout (listed in
``.gitignore``) unless ``utils/cache.enable_persistent_cache`` named
another. The file name
carries a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source or header is rebuilt. Nothing is built at import: machines without nvcc import every
module. A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

from igs_tpu_torch.utils.cache import build_root

CSRC = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# what the last build of each source printed (ptxas registers/spills) and
# how long it took; chip_smoke.py reports both
BUILD_LOG: Dict[str, str] = {}
BUILD_SECONDS: Dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set CUDA_HOME or add it to PATH)")
    return path


def _target(source: str) -> Path:
    # the shared headers (csrc/*.cuh) count as part of every source
    text = (CSRC / source).read_bytes() + " ".join(NVCC_FLAGS).encode()
    for header in sorted(CSRC.glob("*.cuh")):
        text += header.read_bytes()
    digest = hashlib.sha256(text).hexdigest()[:16]
    return build_dir() / f"lib{Path(source).stem}_{digest}.so"


def build_dir() -> Path:
    """Where the libraries are built: ``<build root>/cuda``."""
    return build_root() / "cuda"


def build(sources: Sequence[str]) -> None:
    """Compile every missing library, one nvcc process per source, all
    started together."""
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources:
        so = _target(src)
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs.append((src, so, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, so, tmp, t0, proc in procs:
        out, _ = proc.communicate()
        BUILD_SECONDS[src] = time.perf_counter() - t0
        BUILD_LOG[src] = out
        if proc.returncode != 0:
            failed.append(f"{src}:\n{out}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


@functools.lru_cache(maxsize=None)
def load(source: str) -> ctypes.CDLL:
    """The library built from ``csrc/<source>``, built first if missing."""
    build([source])
    return ctypes.CDLL(str(_target(source)))
