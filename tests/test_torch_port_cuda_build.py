"""Port CUDA build: a library's file name follows its source, the shared
headers of ``csrc/`` and the flags, so an edited header rebuilds every
source; every quoted include of a source is a header in ``csrc/``."""

import re

from igs_tpu_torch.ops import cuda_build


def test_target_follows_source_and_shared_headers(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    first = cuda_build._target("k.cu")
    assert first.name.startswith("libk_") and first.suffix == ".so"
    assert cuda_build._target("k.cu") == first
    (tmp_path / "h.cuh").write_text("// v2\n")
    second = cuda_build._target("k.cu")
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert len({first, second, cuda_build._target("k.cu")}) == 3


def test_quoted_includes_are_headers_in_csrc():
    sources = sorted(cuda_build.CSRC.glob("*.cu"))
    assert len(sources) == 5
    for src in sources:
        for name in re.findall(r'#include "([^"]+)"', src.read_text()):
            assert (cuda_build.CSRC / name).is_file(), (src.name, name)
