"""``ops/attention.py`` against the JAX package's off-TPU attention routes,
on the CPU (the plain version; the kernels of ``csrc/attention.cu`` run
only on the card, where ``chip_smoke.py`` holds them to it).

Tolerances: float32 forward within 1e-5 and gradients within 1e-5 of
each tensor's largest entry (the two frameworks sum the products in other
orders, ~1e-7 relative). bf16 by C21's rule: the port's bf16 output
against JAX's bf16 output has an RMS at most 1.5 × and a max |·| at most
2 × those of JAX's own bf16-versus-f32 gap on the same inputs (JAX's
window route rounds its scores to bf16, the port keeps them in f32).

Also: the region-id exclusion against the JAX XLA route's additive −100
mask, the port's copy of the region table, an emulation of the kernels'
tile loops (online softmax over key tiles with masked and ragged tiles,
and the backward from the saved log-sum-exp) against the plain version,
and the wrapper's routes and refusals."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from igs_tpu.models import swin as jsw
from igs_tpu.models import transformer1d as jt1
from igs_tpu_torch.models import swin
from igs_tpu_torch.models.convert import _module_key, state_dict_from_flax
from igs_tpu_torch.ops import attention as attn_mod
from igs_tpu_torch.ops.attention import attention, attention_plain

torch.set_num_threads(2)
KEY = jax.random.PRNGKey(0)
BF16 = torch.bfloat16


def _t(x, dtype=torch.float32, grad=False):
    t = torch.from_numpy(np.array(x, np.float32)).to(dtype)
    return t.requires_grad_(grad)


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rms(x):
    return float(np.sqrt(np.mean(np.square(np.asarray(x, np.float64)))))


def _c21(port_bf16, jax_bf16, jax_f32):
    gap = np.asarray(jax_bf16, np.float64) - np.asarray(jax_f32, np.float64)
    err = np.asarray(port_bf16, np.float64) - np.asarray(jax_bf16, np.float64)
    assert _rms(gap) > 0
    assert _rms(err) <= 1.5 * _rms(gap), (_rms(err), _rms(gap))
    assert np.abs(err).max() <= 2.0 * np.abs(gap).max(), (
        np.abs(err).max(), np.abs(gap).max())


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# -- transformer1d.Attention: the single-block and the lax.map route -----

def _t1_inputs(length, dim=32, seed=0):
    return np.random.RandomState(seed).normal(
        size=(2, length, dim)).astype(np.float32)


def _port_t1(params, x, heads, head_dim, dtype=torch.float32):
    """The JAX module's projections around ``attention_plain``."""
    def w(name):
        return _t(params[name]["kernel"], dtype, grad=True)

    ws = {n: w(n) for n in ("to_q", "to_k", "to_v", "to_out")}
    bias = _t(params["to_out"]["bias"], dtype)
    b, length, _ = x.shape
    xt = x.to(dtype)

    def split(t):
        return t.reshape(b, length, heads, head_dim).transpose(1, 2)

    o = attention_plain(split(xt @ ws["to_q"]), split(xt @ ws["to_k"]),
                        split(xt @ ws["to_v"]), head_dim ** -0.5)
    o = o.transpose(1, 2).reshape(b, length, heads * head_dim)
    return (o @ ws["to_out"] + bias).float(), ws


@pytest.mark.parametrize("length,q_chunk", [(48, 1024), (80, 32)],
                         ids=["single-block", "chunked"])
def test_transformer1d_route_forward_and_grads(length, q_chunk):
    heads, head_dim = 2, 16
    x = _t1_inputs(length)
    jm = jt1.Attention(heads=heads, head_dim=head_dim, q_chunk=q_chunk)
    params = jm.init(KEY, jnp.asarray(x))["params"]
    cot = np.random.RandomState(9).normal(size=x.shape).astype(np.float32)

    def loss(p, xx):
        return jnp.sum(jm.apply({"params": p}, xx) * cot)

    want = jm.apply({"params": params}, jnp.asarray(x))
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = _t(x, grad=True)
    got, ws = _port_t1(params, xt, heads, head_dim)
    assert _max_rel(got.detach(), want) <= 1e-5
    (got * _t(cot)).sum().backward()
    assert _max_rel(xt.grad, gx) <= 1e-5
    for name in ("to_q", "to_k", "to_v", "to_out"):
        assert _max_rel(ws[name].grad, gp[name]["kernel"]) <= 1e-5, name


@pytest.mark.parametrize("length,q_chunk", [(48, 1024), (80, 32)],
                         ids=["single-block", "chunked"])
def test_transformer1d_route_bf16(length, q_chunk):
    heads, head_dim = 2, 16
    x = _t1_inputs(length, seed=1)
    outs = {}
    for name, dt in (("f32", None), ("bf16", jnp.bfloat16)):
        jm = jt1.Attention(heads=heads, head_dim=head_dim, q_chunk=q_chunk,
                           dtype=dt)
        params = jt1.Attention(heads=heads, head_dim=head_dim).init(
            KEY, jnp.asarray(x))["params"]
        outs[name] = _f32(jm.apply({"params": params}, jnp.asarray(x)))
    got, _ = _port_t1(params, _t(x), heads, head_dim, BF16)
    _c21(got.detach().numpy(), outs["bf16"], outs["f32"])


# -- swin.window_attention and full_attention ----------------------------

def _swin_inputs(b=2, h=16, w=16, c=32, seed=2):
    rng = np.random.RandomState(seed)
    return [rng.normal(size=(b, h * w, c)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("with_shift", [False, True],
                         ids=["unshifted", "shifted"])
def test_window_attention_forward_and_grads(with_shift):
    q, k, v = _swin_inputs()
    cot = np.random.RandomState(3).normal(size=q.shape).astype(np.float32)

    def jfn(q_, k_, v_):
        return jsw.window_attention(q_, k_, v_, 2, 16, 16,
                                    with_shift=with_shift)

    want = jfn(*map(jnp.asarray, (q, k, v)))
    grads = jax.grad(lambda *a: jnp.sum(jfn(*a) * cot), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    ts = [_t(x, grad=True) for x in (q, k, v)]
    got = swin.window_attention(*ts, 2, 16, 16, with_shift=with_shift)
    assert _max_rel(got.detach(), want) <= 1e-5
    (got * _t(cot)).sum().backward()
    for t, g in zip(ts, grads):
        assert _max_rel(t.grad, g) <= 1e-5


@pytest.mark.parametrize("with_shift", [False, True],
                         ids=["unshifted", "shifted"])
def test_window_attention_bf16(with_shift):
    q, k, v = _swin_inputs(seed=4)
    outs = {name: _f32(jsw.window_attention(
        *(jnp.asarray(x, dt) for x in (q, k, v)), 2, 16, 16,
        with_shift=with_shift)) for name, dt in (("f32", jnp.float32),
                                                 ("bf16", jnp.bfloat16))}
    got = swin.window_attention(*(_t(x, BF16) for x in (q, k, v)), 2, 16, 16,
                                with_shift=with_shift)
    assert got.dtype == BF16
    _c21(got.float().numpy(), outs["bf16"], outs["f32"])


def test_full_attention_forward_and_grads():
    q, k, v = _swin_inputs(h=8, w=10, seed=5)
    cot = np.random.RandomState(6).normal(size=q.shape).astype(np.float32)
    want = jsw.full_attention(*map(jnp.asarray, (q, k, v)))
    grads = jax.grad(
        lambda *a: jnp.sum(jsw.full_attention(*a) * cot), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    ts = [_t(x, grad=True) for x in (q, k, v)]
    c = q.shape[-1]
    got = attention(*(t[:, None] for t in ts), c ** -0.5)[:, 0]
    assert _max_rel(got.detach(), want) <= 1e-5
    (got * _t(cot)).sum().backward()
    for t, g in zip(ts, grads):
        assert _max_rel(t.grad, g) <= 1e-5


def test_unsplit_layer_route_matches_jax():
    """``TransformerLayer`` with one split takes the unsplit route
    (``attention`` with H = 1), the JAX package's plain einsums."""
    rng = np.random.RandomState(7)
    t0, t1 = (rng.normal(size=(2, 64, 32)).astype(np.float32)
              for _ in range(2))
    jm = jsw.TransformerLayer(32)
    v = jm.init(KEY, jnp.asarray(t0), jnp.asarray(t1), 8, 8, 1, False)
    prefix = "backbone.transformer.layer0.cross_attn_ffn"
    tree = v["params"]
    for part in reversed(prefix.split(".")):
        tree = {part: tree}
    cut = len(_module_key(prefix, 2)) + 1
    tm = swin.TransformerLayer(32)
    tm.load_state_dict({k[cut:]: w for k, w in
                        state_dict_from_flax(tree).items()}, strict=True)
    want = jm.apply(v, jnp.asarray(t0), jnp.asarray(t1), 8, 8, 1, False)
    got = tm.eval()(_t(t0), _t(t1), 8, 8, 1, False)
    assert _max_rel(got.detach(), want) <= 1e-5


# -- the region ids -------------------------------------------------------

def test_region_table_is_the_jax_one():
    for args in ((16, 16, 8, 8, 4, 4), (64, 64, 32, 32, 16, 16),
                 (12, 20, 6, 10, 3, 5)):
        got = swin.shift_window_region_ids(*args)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(
            got, jsw.shift_window_region_ids(*args).astype(np.int32))


def test_region_exclusion_matches_the_minus_100_mask():
    """Excluding cross-region keys and adding −100 to their scores agree
    while a row's scores spread by less than ~80; both grads too."""
    h = w = 16
    ids = swin.shift_window_region_ids(h, w, 8, 8, 4, 4)  # (4, 64)
    mask = jsw.shift_window_attn_mask(h, w, 8, 8, 4, 4)  # (4, 64, 64)
    rng = np.random.RandomState(8)
    q, k, v = (rng.normal(size=(3, 4, 64, 32)).astype(np.float32)
               for _ in range(3))
    scale = 32 ** -0.5
    ts = [_t(x, grad=True) for x in (q, k, v)]
    got = attention_plain(*ts, scale, torch.from_numpy(ids))
    cot = _t(rng.normal(size=q.shape))
    (got * cot).sum().backward()
    ts2 = [_t(x, grad=True) for x in (q, k, v)]
    s = torch.matmul(ts2[0], ts2[1].transpose(-1, -2)) * scale
    s = s + torch.from_numpy(mask)
    want = torch.matmul(torch.softmax(s, -1), ts2[2])
    (want * cot).sum().backward()
    assert float((got - want).abs().max().detach()) <= 1e-6
    for a, b in zip(ts, ts2):
        assert _max_rel(a.grad, b.grad) <= 1e-6


# -- the kernels' tile loops, emulated ------------------------------------

def _tiled(q, k, v, scale, ids, bq, bk, dout):
    """csrc/attention.cu's arithmetic in numpy, tile by tile: the forward's
    online softmax over key tiles (a row with no key yet keeps m = -inf
    and takes exp(-inf - 0) = 0), the lse it saves, and the dK/dV and dQ
    loops recomputing P from it."""
    b, h, length, c = q.shape
    o = np.zeros_like(q)
    lse = np.zeros((b, h, length), np.float64)
    dq, dk, dv = np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)

    def ok(bi, hi, rows, cols):
        keep = (rows[:, None] < length) & (cols[None, :] < length)
        if ids is not None:
            keep &= ids[hi, np.minimum(rows, length - 1)][:, None] == \
                ids[hi, np.minimum(cols, length - 1)][None, :]
        return keep

    for bi in range(b):
        for hi in range(h):
            for q0 in range(0, length, bq):
                rows = np.arange(q0, q0 + bq)
                qt = q[bi, hi, q0:q0 + bq]
                m = np.full(len(qt), -np.inf)
                l_ = np.zeros(len(qt))
                acc = np.zeros((len(qt), c))
                for k0 in range(0, length, bk):
                    cols = np.arange(k0, k0 + bk)
                    s = qt @ k[bi, hi, k0:k0 + bk].T * scale
                    keep = ok(bi, hi, rows[:len(qt)], cols[:s.shape[1]])
                    s = np.where(keep, s, -np.inf)
                    mn = np.maximum(m, s.max(1))
                    mu = np.where(mn == -np.inf, 0.0, mn)
                    alpha = np.exp(m - mu)
                    p = np.exp(s - mu[:, None])
                    l_ = l_ * alpha + p.sum(1)
                    m = mn
                    acc = acc * alpha[:, None] + p @ v[bi, hi, k0:k0 + bk]
                o[bi, hi, q0:q0 + bq] = acc / l_[:, None]
                lse[bi, hi, q0:q0 + bq] = m + np.log(l_)
            delta = (dout[bi, hi] * o[bi, hi]).sum(-1)
            for k0 in range(0, length, bk):
                cols = np.arange(k0, k0 + bk)[:len(k[bi, hi, k0:k0 + bk])]
                for q0 in range(0, length, bq):
                    rows = np.arange(q0, q0 + bq)[:len(q[bi, hi, q0:q0 + bq])]
                    s = q[bi, hi, q0:q0 + bq] @ k[bi, hi, k0:k0 + bk].T
                    p = np.where(ok(bi, hi, rows, cols),
                                 np.exp(s * scale - lse[bi, hi, rows, None]),
                                 0.0)
                    dp = dout[bi, hi, rows] @ v[bi, hi, cols].T
                    ds = p * (dp - delta[rows, None])
                    dv[bi, hi, cols] += p.T @ dout[bi, hi, rows]
                    dk[bi, hi, cols] += scale * ds.T @ q[bi, hi, rows]
                    dq[bi, hi, rows] += scale * ds @ k[bi, hi, cols]
    return o, lse, dq, dk, dv


@pytest.mark.parametrize("with_ids", [False, True], ids=["plain", "regions"])
def test_kernel_tile_loops_match_the_plain_version(with_ids):
    """Ragged L (70 over tiles of 16 and 32), and region ids laid out so
    that some key tiles hold no key of a query's region."""
    rng = np.random.RandomState(10)
    b, h, length, c = 2, 3, 70, 16
    q, k, v, dout = (rng.normal(size=(b, h, length, c)) for _ in range(4))
    ids = None
    if with_ids:
        ids = np.repeat(np.arange(5), 14)[None].repeat(h, 0).astype(np.int32)
        ids[1] = ids[1][::-1]
        ids[2] = rng.randint(0, 3, length)
    scale = c ** -0.5
    o, lse, dq, dk, dv = _tiled(q, k, v, scale, ids, 16, 32, dout)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    rid = None if ids is None else torch.from_numpy(ids)
    want = attention_plain(*[t.float() for t in ts], scale, rid)
    (want * torch.from_numpy(dout).float()).sum().backward()
    assert np.isfinite(o).all() and np.isfinite(dq).all()
    assert _max_rel(o, want.detach()) <= 1e-5
    for got, t in zip((dq, dk, dv), ts):
        assert _max_rel(got, t.grad) <= 1e-5
    s = np.einsum("bhlc,bhmc->bhlm", q, k) * scale
    if ids is not None:
        s = np.where(ids[None, :, :, None] == ids[None, :, None, :], s,
                     -np.inf)
    ref_lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + \
        s.max(-1)
    np.testing.assert_allclose(lse, ref_lse, rtol=1e-12, atol=1e-12)


# -- the wrapper ----------------------------------------------------------

def test_cpu_tensors_take_the_plain_version():
    rng = np.random.RandomState(11)
    q, k, v = (_t(rng.normal(size=(2, 2, 40, 32))) for _ in range(3))
    before = (attn_mod.attention_fwd_cuda.launches,
              attn_mod.attention_bwd_cuda.launches)
    got = attention(q, k, v, 0.2)
    assert torch.equal(got, attention_plain(q, k, v, 0.2))
    qs = q.transpose(1, 2).contiguous().transpose(1, 2)  # a strided view
    assert torch.equal(attention(qs, k, v, 0.2), got)
    assert (attn_mod.attention_fwd_cuda.launches,
            attn_mod.attention_bwd_cuda.launches) == before


def test_plain_version_chunks_agree():
    rng = np.random.RandomState(12)
    q, k, v = (_t(rng.normal(size=(1, 2, 100, 16))) for _ in range(3))
    whole = attention_plain(q, k, v, 0.25, chunk=1000)
    for chunk in (1, 7, 32):
        got = attention_plain(q, k, v, 0.25, chunk=chunk)
        assert float((got - whole).abs().max()) <= 1e-6


@pytest.mark.parametrize("case,exc,match", [
    ("3-d", ValueError, "must be \\(B, H, L, C\\)"),
    ("float16", TypeError, "float32 or bfloat16"),
    ("float64", TypeError, "float32 or bfloat16"),
    ("mixed", TypeError, "share one dtype"),
    ("shapes", ValueError, "share one shape"),
    ("head 24", ValueError, "head dim 24"),
    ("head 144", ValueError, "head dim 144"),
    ("head 8", ValueError, "head dim 8"),
    ("ids float", TypeError, "region_ids must be int32"),
    ("ids shape", ValueError, "region_ids must be \\(H, L\\)"),
])
def test_refusals_by_name(case, exc, match):
    def x(shape=(1, 2, 8, 32), dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)

    q, k, v, ids = x(), x(), x(), None
    if case == "3-d":
        q = torch.zeros(2, 8, 32)
    elif case in ("float16", "float64"):
        q = k = v = x(dtype=getattr(torch, case))
    elif case == "mixed":
        v = x(dtype=BF16)
    elif case == "shapes":
        k = x((1, 2, 9, 32))
    elif case.startswith("head"):
        c = int(case.split()[1])
        q = k = v = x((1, 2, 8, c))
    elif case == "ids float":
        ids = torch.zeros((2, 8))
    elif case == "ids shape":
        ids = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(exc, match=match):
        attention(q, k, v, 1.0, ids)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers launch on CUDA tensors only; on CPU tensors
    they raise before anything is built."""
    q = torch.zeros((1, 2, 8, 32))
    with pytest.raises(ValueError, match="CUDA"):
        attn_mod.attention_fwd_cuda(q, q, q, 1.0)
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        attn_mod.attention_bwd_cuda(q, q, q, q, lse, q, 1.0)


def test_tiles_are_the_kernel_instantiations():
    assert set(attn_mod.DEFAULT_BLOCK.values()) <= set(attn_mod.TILES)
    assert set(attn_mod.DEFAULT_BLOCK) == set(attn_mod.DTYPES)
    assert attn_mod.TILES == ((64, 64), (128, 64), (64, 128))
