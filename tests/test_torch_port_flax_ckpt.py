"""The JAX package's native checkpoints in the port: flax's format
(``utils/flax_msgpack.py``) against ``flax.serialization``, the params
file through ``train/driver.load_flax_checkpoint`` and the optimizer
state through ``optimizer_state_from_flax``, against the JAX driver.

Tolerances. The format is exact: ``dumps`` writes ``to_bytes``'s bytes,
``loads`` returns its arrays bit for bit, and the converted state dict
equals ``state_dict_from_flax`` of the same params. Two train steps after
a resume from a JAX-written ``params.msgpack`` + ``.opt`` (frozen
backbone, so optax's ``masked``; once more inside ``MultiSteps`` with
two accumulation steps) are held to ROADMAP C18's bounds: loss to 1e-5
relative; each step's clipped gradient (recovered from Adam's first
moment, or MultiSteps' running mean) to 1e-4 of each tensor's largest
entry (plus 1e-3 relative and a 1e-7 floor, as in
``tests/test_torch_port_train.py``).
"""

import io

import numpy as np
import jax
import jax.numpy as jnp
import msgpack
import pytest
import torch
from flax import serialization

from igs_tpu.models.agm import AGMNet as JAGMNet
from igs_tpu.ops.anchors import select_anchors as jax_select_anchors
from igs_tpu.ops.rasterize import RasterSettings as JSettings
from igs_tpu.train import driver as jdriver
from igs_tpu_torch import train_agm
from igs_tpu_torch.data.synthetic import build_synthetic_scene
from igs_tpu_torch.models.agm import AGMNet
from igs_tpu_torch.models.convert import (
    flax_from_state_dict, load_flax_params, state_dict_from_flax)
from igs_tpu_torch.ops.anchors import AnchorState
from igs_tpu_torch.ops.rasterize import RasterSettings
from igs_tpu_torch.train.driver import (
    OptConfig, flax_optimizer_state, load_flax_checkpoint, make_optimizer,
    make_train_step, optimizer_state_from_flax, read_optimizer_state,
    save_checkpoint)
from igs_tpu_torch.utils import flax_msgpack
from tests.torch_port_common import TINY, flax_params, numpy_batch, \
    to_torch_gaussians

torch.set_num_threads(2)

HW = 32
TOTAL_STEPS = 10


@pytest.fixture(scope="module")
def params():
    _, p, _ = flax_params(local_ray=False)
    return jax.tree.map(np.asarray, p)


def _paths(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


# -- the format ---------------------------------------------------------------

@pytest.mark.parametrize("value", [
    None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
    -1, -32, -33, -128, -129, -32768, -32769, -(2 ** 31) - 1, 1.5, -0.0,
    "", "x" * 31, "y" * 32, "z" * 256, "z" * 65536, b"", b"\x00" * 300,
    [1, "a", None], list(range(16)), {"k": 1},
    {str(i): i for i in range(16)}], ids=repr)
def test_scalars_pack_as_msgpack(value):
    """Every plain msgpack family flax's files hold, in every length form,
    is written as msgpack writes it and read back."""
    want = msgpack.packb(value, use_bin_type=True)
    got = flax_msgpack.dumps(value)
    assert got == want
    assert flax_msgpack.loads(want) == value


def test_dumps_matches_flax_on_agmnet_params(params):
    """``to_bytes`` of AGMNet.init's tree, alone and in the JAX driver's
    checkpoint layout, with the array dtypes and numpy scalars flax writes
    as ext records."""
    for tree in (params, {"params": params, "step": 7},
                 {"a": np.arange(6, dtype=np.int32).reshape(2, 3),
                  "b": np.float32(2.5), "c": np.bool_(True),
                  "d": np.zeros((0, 4), np.float16), "e": np.int64(-3),
                  "g": np.float64(0.25), "h": 0.25, "i": True,
                  "f": jnp.ones((2, 2), jnp.bfloat16)}):
        want = serialization.to_bytes(tree)
        assert flax_msgpack.dumps(_host(serialization.to_state_dict(
            tree))) == want
        back = flax_msgpack.loads(want)
        assert flax_msgpack.dumps(back) == want
        for (pa, a), (pb, b) in zip(_paths(_host(tree)), _paths(back)):
            assert pa == pb
            a = np.asarray(a)
            b = b.float().numpy() if torch.is_tensor(b) else np.asarray(b)
            assert a.shape == b.shape
            np.testing.assert_array_equal(a.astype(b.dtype), b)


def _host(tree):
    """jax arrays → numpy, keeping the dicts' order (``jax.tree.map``
    would sort the keys, and the bytes follow the order)."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, jax.Array):
        return np.asarray(tree)
    return tree


def test_chunked_arrays_match_flax(monkeypatch):
    """Arrays above ``MAX_CHUNK_SIZE`` are written as flax chunks them and
    joined back on reading (a small limit stands in for flax's 1 GiB)."""
    import flax.serialization as fser

    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    rng = np.random.RandomState(0)
    tree = {"w": {"kernel": rng.normal(size=(10, 7)).astype(np.float32),
                  "bias": np.arange(4, dtype=np.float32)},
            "n": np.arange(33, dtype=np.int64), "step": 3}
    want = serialization.to_bytes(tree)
    assert flax_msgpack.dumps(tree, max_chunk_size=64) == want
    back = flax_msgpack.loads(want)
    for k in ("w",):
        for leaf in tree[k]:
            np.testing.assert_array_equal(back[k][leaf], tree[k][leaf])
    np.testing.assert_array_equal(back["n"], tree["n"])
    raw = msgpack.unpackb(want, raw=False, strict_map_key=False,
                          ext_hook=lambda c, d: c)
    assert raw["w"]["kernel"]["__msgpack_chunked_array__"] is True
    assert len(raw["w"]["kernel"]["chunks"]) == 5  # 280 bytes in 64s


@pytest.mark.parametrize("code", [2, 5, -1])
def test_unknown_ext_code_raises(code):
    # {"x": fixext 4 of ``code``}; msgpack-python writes no negative codes
    data = b"\x81\xa1x\xd6" + code.to_bytes(1, "big", signed=True) + b"abcd"
    with pytest.raises(ValueError, match=f"ext code {code}"):
        flax_msgpack.loads(data)


def test_is_flax_msgpack_tells_files_apart(tmp_path):
    torch.save({"count": 1}, tmp_path / "a.opt")
    head = (tmp_path / "a.opt").read_bytes()[:1]
    assert not flax_msgpack.is_flax_msgpack(head)
    buf = io.BytesIO()
    torch.save({"count": 1}, buf, _use_new_zipfile_serialization=False)
    assert not flax_msgpack.is_flax_msgpack(buf.getvalue()[:1])
    assert flax_msgpack.is_flax_msgpack(serialization.to_bytes({"a": 1}))


# -- params -------------------------------------------------------------------

def test_flax_checkpoint_loads_bit_equal(tmp_path, params):
    """The JAX driver's ``params.msgpack`` → the port's state dict, bit
    for bit ``state_dict_from_flax`` of the same params, with its step; a
    model that lacks a tensor or has another shape raises by name."""
    path = str(tmp_path / "params.msgpack")
    jdriver.save_checkpoint(path, params, step=11)
    model = AGMNet(local_ray=False, **TINY)
    sd, step = load_flax_checkpoint(path, model.state_dict())
    want = state_dict_from_flax(params)
    assert step == 11 and sorted(sd) == sorted(want)
    for k, v in want.items():
        assert sd[k].dtype == v.dtype and torch.equal(sd[k], v), k
    model.load_state_dict(sd)

    template = dict(model.state_dict())
    gone = template.pop("upsample.bias")
    with pytest.raises(KeyError, match="upsample.bias"):
        load_flax_checkpoint(path, template)
    template["upsample.bias"] = torch.zeros(gone.shape[0] + 1)
    with pytest.raises(ValueError, match="upsample.bias"):
        load_flax_checkpoint(path, template)
    template["upsample.bias"] = gone
    template["extra.weight"] = torch.zeros(2)
    with pytest.raises(KeyError, match="extra.weight"):
        load_flax_checkpoint(path, template)


def test_flax_from_state_dict_round_trips(params):
    back = flax_from_state_dict(state_dict_from_flax(params))
    want, got = _paths(params), _paths(back)
    assert [p for p, _ in want] == [p for p, _ in got]
    for (p, a), (_, b) in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape, p
        np.testing.assert_array_equal(a, b)
    # and flax writes the same bytes for both trees
    assert serialization.to_bytes(params) == serialization.to_bytes(back)


# -- the optimizer state ------------------------------------------------------

def _jax_inputs():
    _, p, g = flax_params(local_ray=False)
    batches = [numpy_batch(b=2, v=2, hw=HW, out_hw=(HW, HW), seed=s)
               for s in range(4)]
    state = jax_select_anchors(
        g.xyz, jnp.asarray(batches[0]["bounding_box"][0]), valid=g.valid,
        anchor_size=32, k=4, exact_knn=True)
    return p, g, batches, state


def _settings():
    js = JSettings(image_height=HW, image_width=HW, impl="pallas",
                   pallas_interpret=True, max_pairs=1 << 13, max_per_tile=128,
                   chunk=64, clamp_grads=True)
    ts = RasterSettings(image_height=HW, image_width=HW, impl="pallas",
                        max_pairs=1 << 13, max_per_tile=128, chunk=64,
                        clamp_grads=True)
    return js, ts


def _sd(tree):
    """An optax parameter tree → port names (masked leaves, stored as
    ``MaskedNode``, drop out)."""
    return state_dict_from_flax(_host(serialization.to_state_dict(tree)))


def _adam(state):
    for leaf in jax.tree_util.tree_leaves(
            state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu"):
            return leaf
    raise KeyError("no Adam state")


@pytest.mark.parametrize("accum", [1, 2], ids=["masked", "multisteps"])
def test_two_steps_after_flax_resume_match_jax(tmp_path, accum):
    """The JAX driver trains (two updates, and with MultiSteps one step
    into the next accumulation), writes ``params.msgpack`` and its
    ``.opt``, and both packages take two more steps from those files."""
    p0, g, batches, state = _jax_inputs()
    js, ts = _settings()
    cfg = OptConfig(warmup_steps=3, gradient_clip=0.1)
    rep = lambda x: None if x is None else jnp.stack([x] * 2)
    jmodel = JAGMNet(local_ray=False, **TINY)
    tx, _ = jdriver.make_optimizer(p0, cfg, TOTAL_STEPS, grad_accum=accum)
    step = jdriver.make_train_step(jmodel, tx, cfg, js)
    jstate, jgs = jax.tree.map(rep, state), jax.tree.map(rep, g)
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]

    # the JAX step donates its inputs: keep host copies for the templates
    host = jax.tree.map(np.asarray, p0)
    template = lambda: jax.tree.map(jnp.asarray, host)
    jparams, opt_state = p0, tx.init(p0)
    before = 2 * accum + (accum - 1)
    for i in range(before):
        jparams, opt_state, _ = step(jparams, opt_state, jb[i % 2], jstate,
                                     jgs)
    path = str(tmp_path / "params.msgpack")
    jdriver.save_checkpoint(path, jparams, opt_state, step=before)

    # the JAX side resumes as its CLI does
    jparams, _ = jdriver.load_checkpoint(path, template())
    with open(path + ".opt", "rb") as f:
        opt_state = serialization.from_bytes(tx.init(template()), f.read())
    mu_restored = _sd(_adam(opt_state).mu)
    want, want_mu, want_acc = [], [], []
    for i in range(2):
        jparams, opt_state, m = step(jparams, opt_state, jb[2 + i], jstate,
                                     jgs)
        want.append({k: float(v) for k, v in m.items()})
        want_mu.append(_sd(_adam(opt_state).mu))
        if accum > 1:
            want_acc.append(_sd(opt_state.acc_grads))

    model = AGMNet(local_ray=False, **TINY)
    sd, ck_step = load_flax_checkpoint(path, model.state_dict())
    assert ck_step == before
    model.load_state_dict(sd)
    model.train()
    optimizer, _ = make_optimizer(model, cfg, TOTAL_STEPS, grad_accum=accum)
    optimizer.load_state_dict(read_optimizer_state(path + ".opt", optimizer))
    assert optimizer.count == 2 and optimizer.mini_step == accum - 1
    assert not any(k.startswith("backbone.") for k in optimizer.params)
    mu0 = {k: v.clone() for k, v in optimizer.mu.items()}
    tstep = make_train_step(cfg, ts)
    tstate = AnchorState(*(torch.tensor(np.asarray(x)).expand(
        (2,) + x.shape) for x in state))
    tgs = to_torch_gaussians(g).map(lambda x: x.expand((2,) + x.shape))
    got = []
    for i in range(2):
        tb = {k: torch.from_numpy(v) for k, v in batches[2 + i].items()}
        got.append(tstep(model, optimizer, tb, tstate, tgs))
        if i == 0:
            mu1 = {k: v.clone() for k, v in optimizer.mu.items()}
    for w, m in zip(want, got):
        for k in ("loss", "loss_mse", "loss_ssim", "psnr"):
            assert float(m[k]) == pytest.approx(w[k], rel=1e-5), k

    def close(got_g, want_g, k):
        w = want_g.numpy()
        np.testing.assert_allclose(
            got_g.numpy(), w, rtol=1e-3,
            atol=1e-4 * float(np.abs(w).max()) + 1e-7, err_msg=k)

    b1 = cfg.beta1
    assert sorted(mu0) == sorted(mu_restored)
    assert all(torch.equal(mu0[k], mu_restored[k]) for k in mu0)
    port_mu = [mu0, mu1, optimizer.mu]
    jax_mu = [mu0, want_mu[0], want_mu[1]]
    updates = 2 if accum == 1 else 1
    assert [bool(m["updated"]) for m in got] == [True, accum == 1]
    for i in range(updates):  # the clipped gradient of each update
        for k in mu0:
            close((port_mu[i + 1][k] - b1 * port_mu[i][k]) / (1 - b1),
                  (jax_mu[i + 1][k] - b1 * jax_mu[i][k]) / (1 - b1), k)
    if accum > 1:  # step 2 starts the next accumulation
        for k in mu0:
            close(optimizer.acc[k], want_acc[1][k], k)
    assert optimizer.count == 2 + updates


@pytest.mark.parametrize("train_backbone,accum", [(False, 1), (False, 2),
                                                  (True, 1), (True, 2)])
def test_optimizer_state_layout_and_round_trip(train_backbone, accum):
    """``flax_optimizer_state`` writes optax's tree (the same paths and
    shapes as ``to_state_dict`` of ``make_optimizer``'s state, masked
    leaves empty), and reading it back restores the optimizer bit for
    bit."""
    _, p, _ = flax_params(local_ray=False)
    cfg = OptConfig(warmup_steps=3)
    tx, _ = jdriver.make_optimizer(p, cfg, TOTAL_STEPS, grad_accum=accum,
                                   train_backbone=train_backbone)
    want = serialization.to_state_dict(tx.init(p))

    model = AGMNet(local_ray=False, train_backbone=train_backbone, **TINY)
    load_flax_params(model, jax.tree.map(np.asarray, p))
    optimizer, _ = make_optimizer(model, cfg, TOTAL_STEPS, grad_accum=accum,
                                  train_backbone=train_backbone)
    gen = torch.Generator().manual_seed(0)
    for _ in range(2 * accum + accum - 1):
        for q in optimizer.params.values():
            q.grad = torch.randn(q.shape, generator=gen)
        optimizer.step()
    tree = flax_optimizer_state(optimizer, model.state_dict())
    got_paths = [(p_, np.shape(v)) for p_, v in _paths(tree)]
    want_paths = [(p_, np.shape(v)) for p_, v in _paths(want)]
    assert sorted(got_paths, key=str) == sorted(want_paths, key=str)

    again, _ = make_optimizer(model, cfg, TOTAL_STEPS, grad_accum=accum,
                              train_backbone=train_backbone)
    again.load_state_dict(optimizer_state_from_flax(
        flax_msgpack.loads(flax_msgpack.dumps(tree)), again))
    assert (again.count, again.mini_step) == (optimizer.count,
                                              optimizer.mini_step)
    for name in ("mu", "nu") + (("acc",) if accum > 1 else ()):
        a, b = getattr(optimizer, name), getattr(again, name)
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), (name, k)
    # optax reads it back too
    restored = serialization.from_state_dict(tx.init(p), tree)
    np.testing.assert_array_equal(
        np.asarray(_adam(restored).count), optimizer.count)


def test_wrong_optimizer_layout_raises():
    model = AGMNet(local_ray=False, **TINY)
    opt1, _ = make_optimizer(model, OptConfig(), TOTAL_STEPS)
    opt2, _ = make_optimizer(model, OptConfig(), TOTAL_STEPS, grad_accum=2)
    tree = flax_optimizer_state(opt2, model.state_dict())
    with pytest.raises(ValueError, match="MultiSteps"):
        optimizer_state_from_flax(tree, opt1)
    tree = flax_optimizer_state(opt1, model.state_dict())
    del tree["inner_state"]["1"]["0"]["mu"]["params"]["upsample"]
    with pytest.raises(KeyError, match="upsample"):
        optimizer_state_from_flax(tree, opt1)


def test_port_pth_and_opt_still_resume(tmp_path):
    """A port checkpoint's ``.opt`` is a torch file and reads as one."""
    model = AGMNet(local_ray=False, **TINY)
    optimizer, _ = make_optimizer(model, OptConfig(), TOTAL_STEPS)
    optimizer.count = 4
    path = str(tmp_path / "params.pth")
    save_checkpoint(path, model.state_dict(), optimizer.state_dict(), step=4)
    state = read_optimizer_state(path + ".opt", optimizer)
    assert state["count"] == 4 and sorted(state["mu"]) == sorted(
        optimizer.mu)


# -- the entry point ----------------------------------------------------------

TRAIN_SYSTEM = {
    "up_sample": True, "local_ray": False,
    "backbone": {"feature_channels": 32, "transformer": {"num_layers": 1}},
    "transformer": {"num_layers": 1},
    "triplane_encoder": {"unet": {"num_attention_heads": 2,
                                  "attention_head_dim": 16, "num_layers": 1}},
}


def _train_cfg(root, workspace):
    data = {"data_path": "toy_scene_pairs.json", "root_dir": str(root),
            "iter": "6000_compress", "input_height": 32, "input_width": 32,
            "output_height": 32, "output_width": 32, "num_input_views": 2,
            "num_output_views": 3, "up_sample": True,
            "background_color": [0.0, 0.0, 0.0]}
    opt = {"batch_size": 2, "lr": 4e-4, "num_epochs": 3, "warmup_steps": 2,
           "anchor_size": 32, "neighbor_k": 4, "eval_every": 100,
           "workspace": str(workspace)}
    return {"system": TRAIN_SYSTEM, "opt": opt,
            "data": {"data_cls": "igs.data.data.N3dDataset", "data": data}}


def test_train_agm_resumes_from_jax_files(tmp_path, capsys):
    """``train_agm.run(resume=<params.msgpack>)`` (ROADMAP C23: it crashed
    inside ``torch.load``) loads the params and the optax state that the
    JAX driver wrote, and trains on from them."""
    root = tmp_path / "scene"
    build_synthetic_scene(str(root), n_frames=5, n_cams=10, n_gaussians=96,
                          height=32, width=32, interval=2, motion_scale=0.3,
                          device="cpu")
    first = train_agm.run(_train_cfg(root, tmp_path / "a"), max_steps=1,
                          device="cpu", impl="pallas", max_per_tile=128)
    params = flax_from_state_dict(first["model"].state_dict())
    cfg = OptConfig(warmup_steps=2)
    tx, _ = jdriver.make_optimizer(params, cfg, 6)
    opt_state = tx.init(params)
    rng = np.random.RandomState(0)
    for _ in range(3):
        grads = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(
            np.float32), params)
        _, opt_state = tx.update(grads, opt_state, params)
    path = str(tmp_path / "jax" / "params.msgpack")
    jdriver.save_checkpoint(path, params, opt_state, step=3)
    capsys.readouterr()

    out = train_agm.run(_train_cfg(root, tmp_path / "b"), max_steps=1,
                        resume=path, device="cpu", impl="pallas",
                        max_per_tile=128)
    text = capsys.readouterr().out
    n = len(first["model"].state_dict())
    assert f"resumed params from {path} (step 3, {n} tensors)" in text
    assert f"restored optimizer state from {path}.opt" in text
    assert out["optimizer"].count == 4  # three restored, one taken
