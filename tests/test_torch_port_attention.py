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
the kernels' tile skip under region ids (the list of visited tiles is the
set of tiles with a live pair on the swin shift table, and skipping
leaves the emulation's bits unchanged), a numpy emulation of the f32
kernels' 3xTF32 products (within a tenth of the chip's f32 tolerances;
one TF32 term alone misses them), and the wrapper's routes and
refusals."""

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

def _region_bits(ids_row, r0, n):
    """csrc/attention.cu's region_bits: the OR of 1 << id over rows
    [r0, r0 + n) (all 32 bits for an id outside [0, 32))."""
    bits = 0
    for x in ids_row[r0:r0 + n]:
        bits |= (1 << int(x)) if 0 <= x < 32 else 0xFFFFFFFF
    return bits


def _live_tiles(ids_row, r0, rows, tile):
    """csrc/attention.cu's live_tiles: {tile index: uniform} for the tiles
    of ``tile`` rows whose region bits meet those of rows [r0, r0 + rows);
    uniform where both hold one and the same id."""
    own = _region_bits(ids_row, r0, rows)
    live = {}
    for i in range(-(-len(ids_row) // tile)):
        b = _region_bits(ids_row, i * tile, tile)
        if b & own:
            live[i] = bin(own).count("1") == 1 and b == own
    return live


def _tiled(q, k, v, scale, ids, bq, bk, dout, skip=False):
    """csrc/attention.cu's arithmetic in numpy, tile by tile: the forward's
    online softmax over key tiles (a row with no key yet keeps m = -inf
    and takes exp(-inf - 0) = 0), the lse it saves, and the dK/dV and dQ
    loops recomputing P from it. With ``skip`` (and ids) a pair of tiles
    whose region bits do not meet is left out, as the kernels do."""
    b, h, length, c = q.shape
    o = np.zeros_like(q)
    lse = np.zeros((b, h, length), np.float64)
    dq, dk, dv = np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)

    def visit(hi, r0, rows, tile):
        if not skip or ids is None:
            return range(0, length, tile)
        return [i * tile for i in _live_tiles(ids[hi], r0, rows, tile)]

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
                for k0 in visit(hi, q0, bq, bk):
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
                for q0 in visit(hi, k0, bk, bq):
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


@pytest.mark.parametrize("own,tile", [(64, 64), (128, 64), (128, 128),
                                       (128, 32), (64, 32)])
def test_tile_skip_list_is_the_live_pairs(own, tile):
    """On the swin shift table of a 64x64 map (2x2 windows of 1024
    tokens), for each block's own rows (``own``) against the tiles it
    visits (``tile``: the forward's and both backward kernels' shapes):
    a tile is listed iff some (row, column) pair of the two holds one id,
    flagged uniform iff every pair does; some tiles are skipped."""
    ids = swin.shift_window_region_ids(64, 64, 32, 32, 16, 16)
    length = ids.shape[1]
    skipped = 0
    for row in ids:
        for r0 in range(0, length, own):
            live = _live_tiles(row, r0, own, tile)
            for i in range(-(-length // tile)):
                same = row[r0:r0 + own, None] == \
                    row[None, i * tile:(i + 1) * tile]
                assert (i in live) == bool(same.any())
                if i in live:
                    assert live[i] == bool(same.all())
                skipped += i not in live
    assert skipped > 0


def test_tile_skip_leaves_the_results_unchanged():
    """The emulated tile loops on the swin shift table (64x64 map, 2x2
    windows as H, tiles of 64): skipping the tiles with no live pair
    gives the same bits as visiting them all, and the plain version's
    values."""
    rng = np.random.RandomState(13)
    ids = swin.shift_window_region_ids(64, 64, 32, 32, 16, 16)
    b, length, c = 1, ids.shape[1], 16
    q, k, v, dout = (rng.normal(size=(b, ids.shape[0], length, c))
                     for _ in range(4))
    scale = c ** -0.5
    full = _tiled(q, k, v, scale, ids, 64, 64, dout)
    skipped = _tiled(q, k, v, scale, ids, 64, 64, dout, skip=True)
    for a, s_ in zip(full, skipped):
        assert np.array_equal(a, s_)
    want = _plain64(q, k, v, dout, scale, ids)
    for got, w in zip(skipped[:1] + skipped[2:], want):
        assert _max_rel(got, w) <= 1e-12


def _plain64(q, k, v, dout, scale, ids):
    """The function and its VJP in float64 (autograd through plain ops):
    (o, dq, dk, dv) as numpy arrays."""
    ts = [torch.from_numpy(np.asarray(x, np.float64)).requires_grad_(True)
          for x in (q, k, v)]
    s = torch.matmul(ts[0], ts[1].transpose(-1, -2)) * scale
    if ids is not None:
        same = torch.from_numpy(ids[:, :, None] == ids[:, None, :])
        s = s.masked_fill(~same, float("-inf"))
    o = torch.matmul(torch.softmax(s, -1), ts[2])
    g = torch.autograd.grad(o, ts, torch.from_numpy(
        np.asarray(dout, np.float64)))
    return [o.detach().numpy()] + [x.numpy() for x in g]


# -- 3xTF32, emulated -----------------------------------------------------

TOL_ATTN_OUT = 2e-5  # chip_smoke.py's f32 tolerances, of the largest |entry|
TOL_ATTN_GRAD = 1e-4


def _tf32(x, ties):
    """float32 → the nearest value with a 10-bit mantissa (TF32), ties to
    even or away from zero (``cvt.rna``, the kernels' rounding)."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = u + (0xFFF + ((u >> 13) & 1) if ties == "even" else 0x1000)
    return (u & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _mm_tf32(a, b, terms, ties):
    """a @ b as the f32 kernels take it: each operand split into hi =
    tf32(x) and lo = tf32(x - hi); per 8-wide step of the sum, lo.hi,
    hi.lo, hi.hi (``terms`` 3; 1: hi.hi alone, plain TF32), each exact
    and added to an f32 accumulator."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ah, bh = _tf32(a, ties), _tf32(b, ties)
    al, bl = _tf32(a - ah, ties), _tf32(b - bh, ties)
    pairs = ((al, bh), (ah, bl), (ah, bh))[3 - terms:]
    acc = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    for k0 in range(0, a.shape[-1], 8):
        for x, y in pairs:
            part = x[..., k0:k0 + 8].astype(np.float64) @ \
                y[..., k0:k0 + 8, :].astype(np.float64)
            acc = (acc + part).astype(np.float32)
    return acc


def _attention_tf32(q, k, v, dout, scale, ids, terms, ties):
    """The f32 kernels' seven products through ``_mm_tf32``, the softmax
    and the rest in f32 → (o, dq, dk, dv)."""
    def mm(a, b):
        return _mm_tf32(a, b, terms, ties)

    kt = np.swapaxes(k, -1, -2)
    s = mm(q, kt) * np.float32(scale)
    if ids is not None:
        s = np.where(ids[None, :, :, None] == ids[None, :, None, :], s,
                     -np.inf)
    m = s.max(-1, keepdims=True)
    e = np.exp(s - m)
    lse = m + np.log(e.sum(-1, keepdims=True))
    p = np.exp(s - lse).astype(np.float32)
    o = mm(p, v)
    delta = (dout * o).sum(-1, keepdims=True, dtype=np.float32)
    dv = mm(np.swapaxes(p, -1, -2), dout)
    dp = mm(dout, np.swapaxes(v, -1, -2))
    ds = (p * (dp - delta)).astype(np.float32)
    dq = mm(ds, k) * np.float32(scale)
    dk = mm(np.swapaxes(ds, -1, -2), q) * np.float32(scale)
    return o, dq, dk, dv


def _tf32_case(shape, shifted, seed):
    rng = np.random.RandomState(seed)
    q, k, v, dout = (rng.normal(size=shape).astype(np.float32)
                     for _ in range(4))
    ids = None
    if shifted:
        ids = swin.shift_window_region_ids(32, 32, 16, 16, 8, 8)
    scale = shape[-1] ** -0.5
    return (q, k, v, dout, scale, ids), _plain64(q, k, v, dout, scale, ids)


def _errors(got, ref):
    """Each tensor's max |error| over its largest |entry|."""
    return [float(np.abs(g - r).max() / np.abs(r).max())
            for g, r in zip(got, ref)]


# the cases: the triplane's head dim over 512 tokens, and the swin shift
# (a 32x32 map's 2x2 windows of 256 tokens) at the swin head dim
TF32_CASES = [((1, 2, 512, 64), False), ((1, 4, 256, 128), True)]


@pytest.mark.parametrize("ties", ["away", "even"])
@pytest.mark.parametrize("case", range(len(TF32_CASES)),
                         ids=["triplane", "swin_shifted"])
def test_3xtf32_within_the_chip_tolerances(case, ties):
    """3xTF32 (the kernels' cvt.rna rounding, and ties to even) against
    the plain version in float64: the output within TOL_ATTN_OUT / 10 and
    each gradient within TOL_ATTN_GRAD / 10 of its largest entry, a
    margin of 10 under the chip's tolerances."""
    args, ref = _tf32_case(*TF32_CASES[case], seed=20 + case)
    err = _errors(_attention_tf32(*args, terms=3, ties=ties), ref)
    assert err[0] <= TOL_ATTN_OUT / 10, err
    assert max(err[1:]) <= TOL_ATTN_GRAD / 10, err


def test_plain_tf32_misses_the_chip_tolerances():
    """One TF32 product (hi.hi alone) is ~1e-3 off: the f32 kernels need
    the three terms."""
    args, ref = _tf32_case(*TF32_CASES[0], seed=20)
    err = _errors(_attention_tf32(*args, terms=1, ties="away"), ref)
    assert err[0] > TOL_ATTN_OUT and max(err[1:]) > TOL_ATTN_GRAD, err


def _smoke():
    """chip_smoke.py as a module (it imports no torch at the top)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("esz", [4, 2], ids=["f32", "bf16"])
def test_smoke_bounds_take_the_kernels_rates(esz):
    """The smoke's least times: bf16 at the tensor cores' bf16 rate, f32
    at 3xTF32's (three TF32 products at the TF32 rate), below the CUDA
    cores' f32 time that stands beside it; the backward does 5/2 the
    forward's products."""
    from igs_tpu_torch.utils import h100

    shape, pairs = (5, 8, 8192, 64), 5 * 8 * 8192 ** 2
    got = _smoke().attention_bounds(shape, pairs, esz)
    ops = 4 * 64 * pairs
    if esz == 2:
        want = h100.bound(0, ops, h100.BF16_TC_FLOPS)[0]
        assert "bound_cuda_core_ms" not in got
    else:
        want = h100.bound(0, 3 * ops, h100.TF32_TC_FLOPS)[0]
        core = h100.bound(0, ops, h100.FP32_FLOPS)[0]
        assert got["bound_cuda_core_ms"] == pytest.approx(core, rel=1e-12)
        assert got["bwd_bound_cuda_core_ms"] == pytest.approx(2.5 * core,
                                                              rel=1e-12)
        assert want < core
    assert got["bound_by"] == got["bwd_bound_by"] == "operations"
    assert got["bound_ms"] == pytest.approx(want, rel=1e-12)
    assert got["bwd_bound_ms"] == pytest.approx(2.5 * want, rel=1e-12)


def test_variant_tool_cases_are_the_smokes():
    """``tools/bench_attn_variants`` times the smoke's first three cases
    on the smoke's inputs."""
    from igs_tpu_torch.tools import bench_attn_variants as bv

    cs = _smoke()
    assert bv.CASES == cs.ATTN_CASES[:3] and bv.SWIN_MAP == cs.ATTN_SWIN_MAP
    cpu = torch.device("cpu")
    for shifted in (False, True):
        got, gids = bv.case_inputs(cpu, (1, 4, 1024, 16), shifted,
                                   torch.float32, 7)
        want, wids = cs.attention_inputs(cpu, (1, 4, 1024, 16), shifted,
                                         torch.float32, 7)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert (gids is None and wids is None) or torch.equal(gids, wids)


class _Lib:
    """A stand-in for a loaded library: an attribute per exported name."""

    def __init__(self, names):
        for name in names:
            setattr(self, name, type("Fn", (), {})())

    def __getattr__(self, name):
        raise AttributeError(name)


@pytest.mark.parametrize("exported", [
    ("fwd", "bwd", "delta", "count_tiles", "tile_pairs"),
    ("fwd", "bwd")], ids=["current", "older"])
def test_bind_types_what_the_library_exports(exported):
    """``ops/attention.bind`` types each entry the library has (an
    earlier source, as ``bench_attn_variants --parent`` builds, lacks
    the newer ones) and the error string."""
    lib = _Lib([f"igs_attention_{n}" for n in exported]
               + ["igs_cuda_error_string"])
    got = attn_mod.bind(lib)
    assert set(got) == set(exported) | {"error_string"}
    for name in exported:
        args, res = attn_mod.SIGNATURES[name]
        assert got[name].argtypes == args and got[name].restype == res


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
    assert attn_mod.TILES == ((64, 64), (128, 64), (128, 128))
