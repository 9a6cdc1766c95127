"""Build the port's host library (``csrc/host/igsio.cpp``) with g++ and
load it with ctypes.

The counterpart of ``native/Makefile`` for the JAX package's data plane:
``g++ -O3 -march=native -fPIC -std=c++17 -shared … -lz -lpthread``, run
at first use into ``<build root>/host/`` (``build/host/`` of the checkout
unless ``utils/cache.enable_persistent_cache`` named another root). The
file name carries a hash of the source, the flags and the host's CPU
model (``-march=native`` code runs only where it was built), so an edited
source is rebuilt. The compiler writes a temporary name that is renamed
into place, so processes that build at once (test workers, ranks) each
load a whole library. Nothing is built at import; a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from igs_tpu_torch.utils.cache import build_root

HOST_SRC = Path(__file__).resolve().parents[1] / "csrc" / "host"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")
LIBS = ("-lz", "-lpthread")


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return os.uname().machine


def target(source: str) -> Path:
    """The library ``source`` builds into."""
    text = ((HOST_SRC / source).read_bytes()
            + " ".join(CXX_FLAGS + LIBS).encode() + _cpu_model().encode())
    digest = hashlib.sha256(text).hexdigest()[:16]
    return build_root() / "host" / f"lib{Path(source).stem}_{digest}.so"


def build(source: str) -> Path:
    """Compile ``csrc/host/<source>`` unless its library exists; return the
    library's path."""
    so = target(source)
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError(f"g++ not found: it builds {source}")
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(HOST_SRC / source), *LIBS]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stdout}")
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def load(source: str) -> ctypes.CDLL:
    """The library built from ``csrc/host/<source>``, built first if
    missing."""
    return ctypes.CDLL(str(build(source)))
