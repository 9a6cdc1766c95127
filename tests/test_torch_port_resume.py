"""The port's checkpoint overlays (``utils/resume.py``) against the JAX
package's ``load_params_with_overlays``.

The JAX parameters of one tiny AGM-Net (seed 1) are written as the
reference's torch files through ``models/convert.state_dict_from_flax``: an
IGS ``.pth`` (every key, so its ``backbone.*`` keys must be left out, as
the JAX conversion leaves them) with and without a ``{"model": ...}``
wrapper, and a GMFlow file of the backbone's keys. Both packages overlay
them onto another tiny model (seed 0); the results must be equal tensor
for tensor, and each overlay must report the same count, greater than 0.
The JAX driver's native ``params.msgpack`` overlays in both packages too.
"""

import re

import numpy as np
import jax
import pytest
import torch

from igs_tpu.train import driver as jdriver
from igs_tpu.utils.resume import load_params_with_overlays as jax_overlays
from igs_tpu_torch.models.agm import AGMNet
from igs_tpu_torch.models.convert import load_flax_params, state_dict_from_flax
from igs_tpu_torch.train.driver import save_checkpoint
from igs_tpu_torch.utils.resume import load_params_with_overlays
from tests.torch_port_common import TINY, flax_params

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def weights():
    _, base, _ = flax_params(seed=0)
    _, other, _ = flax_params(seed=1)
    host = lambda p: jax.tree.map(np.asarray, p)
    return host(base), host(other)


def _port(params):
    m = AGMNet(**TINY)
    load_flax_params(m, params)
    return m


def _counts(text):
    return [int(n) for n in re.findall(r"loaded (\d+) ", text)]


def _write(tmp_path, other, wrap, extra=None):
    sd = state_dict_from_flax(other)
    igs = dict(sd, **(extra or {}))
    gm = {k[len("backbone."):]: v for k, v in sd.items()
          if k.startswith("backbone.")}
    igs_path, gm_path = str(tmp_path / "igs.pth"), str(tmp_path / "gm.pth")
    torch.save({"model": igs} if wrap else igs, igs_path)
    torch.save({"model": gm}, gm_path)
    return igs_path, gm_path


@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("gmflow", [False, True])
def test_overlays_match_jax(tmp_path, capsys, weights, wrap, gmflow):
    base, other = weights
    # a key of the right name and the wrong shape: skipped by both
    extra = {"upsample.weight": torch.zeros(1, 1, 3, 3)}
    igs_path, gm_path = _write(tmp_path, other, wrap, extra)
    system = {"backbone": {"pretrained_model_name_or_path":
                           gm_path if gmflow else ""}}
    opt = {"resume": igs_path}
    want = state_dict_from_flax(jax_overlays(
        jax.tree.map(np.asarray, base), system, opt))
    jax_out = capsys.readouterr().out
    model = load_params_with_overlays(_port(base), system, opt)
    port_out = capsys.readouterr().out
    got = model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        assert torch.equal(got[k], w), k
    assert _counts(port_out) == _counts(jax_out)
    assert all(n > 0 for n in _counts(port_out))
    assert len(_counts(port_out)) == (2 if gmflow else 1)
    theirs = state_dict_from_flax(other)
    ours = state_dict_from_flax(base)
    for k in got:
        if k.startswith("backbone."):
            # only the GMFlow file sets the backbone
            assert torch.equal(got[k], (theirs if gmflow else ours)[k]), k
        elif k == "upsample.weight":
            assert torch.equal(got[k], ours[k])  # the shape-checked load
        else:
            assert torch.equal(got[k], theirs[k]), k
    # the last MLP layer lands under its reference name
    assert torch.equal(got["render.mlp_net.layers.4.weight"],
                       theirs["render.mlp_net.layers.4.weight"])


def test_missing_paths_are_a_noop(tmp_path, weights):
    base, _ = weights
    model = _port(base)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    load_params_with_overlays(
        model, {"backbone": {"pretrained_model_name_or_path":
                             str(tmp_path / "none.pth")}},
        {"resume": str(tmp_path / "nope.pth")})
    load_params_with_overlays(model, {}, {})
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_msgpack_raises(tmp_path, capsys, weights):
    """A ``.msgpack`` resume, the JAX driver's native checkpoint, replaces
    every tensor after the GMFlow overlay, as the JAX overlay does, and
    prints its line; a file that is not such a checkpoint raises."""
    base, other = weights
    path = str(tmp_path / "params.msgpack")
    jdriver.save_checkpoint(path, base, step=5)
    _, gm_path = _write(tmp_path, other, wrap=False)
    system = {"backbone": {"pretrained_model_name_or_path": gm_path}}
    opt = {"resume": path}
    want = state_dict_from_flax(jax_overlays(
        jax.tree.map(np.asarray, other), system, opt))
    jax_out = capsys.readouterr().out
    model = load_params_with_overlays(_port(other), system, opt)
    port_out = capsys.readouterr().out
    got = model.state_dict()
    ours = state_dict_from_flax(base)
    assert set(got) == set(want) == set(ours)
    for k, w in want.items():
        assert torch.equal(got[k], w), k
        assert torch.equal(got[k], ours[k]), k  # the backbone's too
    line = f"loaded native checkpoint {path}"
    assert line in jax_out and line in port_out
    assert f"loaded {len(ours)} AGM tensors from it (step 5)" in port_out

    bad = tmp_path / "bad.msgpack"
    bad.write_bytes(b"\x80")
    with pytest.raises(ValueError, match="not a flax checkpoint"):
        load_params_with_overlays(_port(base), {}, {"resume": str(bad)})


def test_port_checkpoint_round_trips(tmp_path, capsys, weights):
    base, other = weights
    src = _port(other)
    path = str(tmp_path / "0" / "params.pth")
    save_checkpoint(path, src.state_dict(), {"count": 0}, step=3)
    model = load_params_with_overlays(_port(base), {}, {"resume": path})
    out = capsys.readouterr().out
    for k, v in src.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    assert _counts(out) == [len(src.state_dict())]
    assert "step 3" in out
