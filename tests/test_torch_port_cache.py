"""``igs_tpu_torch/utils/cache.enable_persistent_cache``, the counterpart
of the JAX CLIs' compilation cache: where the port builds its libraries
(the CUDA kernels' ``<root>/cuda``, the host library's ``<root>/host``).
The default is ``build/`` of the checkout; ``path`` and then
``IGS_TPU_CACHE_DIR`` override it; an empty ``IGS_TPU_CACHE_DIR`` builds
into a fresh temporary directory of each process (removed at exit); a
root that cannot be written raises. Each case runs in a subprocess, so
the module's state starts fresh."""

import os
import subprocess
import sys

from igs_tpu_torch.utils import cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import sys
from igs_tpu_torch.utils import cache
from igs_tpu_torch.ops import cuda_build, host_build
before = cache.build_root()
arg = sys.argv[1] if len(sys.argv) > 1 else None
root = cache.enable_persistent_cache(arg)
assert cache.build_root() == root
print(before)
print(root)
print(cuda_build.build_dir())
print(host_build.target("igsio.cpp").parent)
"""


def probe(env_value=None, *args):
    env = dict(os.environ)
    env.pop(cache.ENV, None)
    if env_value is not None:
        env[cache.ENV] = env_value
    r = subprocess.run([sys.executable, "-c", PROBE, *args], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=120)
    return r


def test_default_is_the_checkouts_build_dir():
    r = probe()
    assert r.returncode == 0, r.stderr
    before, root, cuda, host = r.stdout.split()
    assert before == root == os.path.join(ROOT, "build")
    assert cuda == os.path.join(ROOT, "build", "cuda")
    assert host == os.path.join(ROOT, "build", "host")


def test_env_and_path_override(tmp_path):
    r = probe(str(tmp_path / "from_env"))
    assert r.returncode == 0, r.stderr
    assert r.stdout.split()[1:] == [str(tmp_path / "from_env"),
                                    str(tmp_path / "from_env" / "cuda"),
                                    str(tmp_path / "from_env" / "host")]
    assert (tmp_path / "from_env").is_dir()
    r = probe(str(tmp_path / "from_env"), str(tmp_path / "from_arg"))
    assert r.returncode == 0, r.stderr
    assert r.stdout.split()[1] == str(tmp_path / "from_arg")


def test_empty_env_builds_into_a_fresh_directory():
    runs = [probe("") for _ in range(2)]
    roots = []
    for r in runs:
        assert r.returncode == 0, r.stderr
        before, root, cuda, host = r.stdout.split()
        assert before == os.path.join(ROOT, "build") != root
        assert os.path.basename(root).startswith("igs_build_")
        assert not os.path.exists(root)  # removed when the process ended
        roots.append(root)
    assert roots[0] != roots[1]


def test_empty_env_builds_the_host_library_there():
    env = dict(os.environ, **{cache.ENV: ""})
    r = subprocess.run(
        [sys.executable, "-c",
         "from igs_tpu_torch.utils import cache\n"
         "from igs_tpu_torch.ops import host_build\n"
         "root = cache.enable_persistent_cache()\n"
         "lib = host_build.build('igsio.cpp')\n"
         "assert str(lib).startswith(str(root)), (lib, root)\n"
         "assert lib.exists()\n"
         "print(lib)\n"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert not os.path.exists(r.stdout.strip())


def test_unwritable_root_raises(tmp_path):
    blocker = tmp_path / "a_file"
    blocker.write_text("not a directory")
    r = probe(str(blocker / "cache"))
    assert r.returncode != 0
    assert "PermissionError" in r.stderr and "cannot be written" in r.stderr
