"""Tune the triplane attention (B=5, H=8, L=8192, C=64): the forward
kernel's tiles, the bf16 kernel, the chunked kv-bf16 variant, and the
backward kernel.

    python -m igs_tpu_torch.tools.bench_attn [--shape 5 8 8192 64]
        [--K 4] [--iters 3] [--device cpu]

Counterpart of ``tools/tools_bench_attn.py`` (inputs from
``RandomState(1)``, scale C^-½, ``timeit(K=4, iters=3)``). Lines: the
chunked float32 baseline (``attention_plain``: 1024-query chunks, the
JAX probe's ``lax.map``); B7 in float32 at each tile of
``ops.attention.TILES`` (the JAX probe's ``BlockSizes`` sweep: the TPU
kernel's block sizes have no Hopper counterpart, so the port sweeps its
own kernel's tile instantiations); B7 on bf16 copies of the inputs
(made before the timing, as the JAX probe's); the chunked variant with
k and v in bf16 and an f32 softmax (its products run on f32 copies of
the bf16-rounded values); and, beyond the JAX probe, B7 then B8 on a
seeded cotangent at the default tile in each type. Each line reports
its largest error against the chunked baseline. PyTorch's
``scaled_dot_product_attention`` backends appear only as ``library``
lines, yardsticks the port never calls. On ``--device cpu`` the kernel
lines run the plain version (no kernel is launched there).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from igs_tpu_torch.ops.attention import (DEFAULT_BLOCK, TILES, attention,
                                         attention_fwd_cuda, attention_plain)
from igs_tpu_torch.tools.probe import Probe, ms, parser

BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "MATH")


def inputs(shape, seed, dev):
    """q, k, v from ``RandomState(seed)`` in the JAX probe's order."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
            for _ in range(3)]


def forward(q, k, v, scale, block=None):
    """B7 on a CUDA tensor (at ``block``), the plain version on a CPU
    one."""
    if q.is_cuda:
        return attention_fwd_cuda(q, k, v, scale, block=block)[0]
    return attention_plain(q, k, v, scale)


def chunked_kv_bf16(q, kb, vb, scale, chunk=1024):
    """Scores and softmax in float32 over 1024-query chunks of q rounded
    to bf16 against bf16 k, P rounded to bf16, P·V summed in float32."""
    kt = kb.float().transpose(-1, -2)
    outs = []
    for s0 in range(0, q.shape[2], chunk):
        qb = q[:, :, s0:s0 + chunk].to(torch.bfloat16).float()
        p = torch.softmax(torch.matmul(qb, kt) * scale, dim=-1)
        outs.append(torch.matmul(p.to(torch.bfloat16).float(), vb.float()))
    return torch.cat(outs, dim=2)


def err(out, ref):
    return float((out.float() - ref).abs().max())


def library_lines(pr, q, k, v, ref, timing, prefix="library sdpa"):
    """SDPA under each backend, float32 inputs where it takes them and
    bf16 copies otherwise (the line says which), or unavailable."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    for name in BACKENDS:
        backend = getattr(SDPBackend, name)
        res = None
        for dtype in (torch.float32, torch.bfloat16):
            qq, kk, vv = (x.to(dtype) for x in (q, k, v))
            try:
                with sdpa_kernel(backend):
                    got = sdpa(qq, kk, vv)
            except RuntimeError as e:
                res = {"unavailable": str(e).splitlines()[0][:200]}
                continue

            def call(x, kk=kk, vv=vv, backend=backend):
                with sdpa_kernel(backend):
                    return sdpa(x, kk, vv)

            res = {"library": "scaled_dot_product_attention",
                   "dtype": str(dtype).replace("torch.", ""),
                   "max_abs_err": err(got, ref), "ms": ms(call, qq, **timing)}
            break
        pr.put(f"{prefix} {name.lower()}", res)


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--shape", type=int, nargs=4, default=[5, 8, 8192, 64],
                    metavar=("B", "H", "L", "C"))
    ap.add_argument("--K", type=int, default=4)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)
    pr = Probe("bench_attn", args)
    q, k, v = inputs(tuple(args.shape), 1, pr.dev)
    scale = args.shape[-1] ** -0.5
    t = dict(K=args.K, iters=args.iters)
    ref = attention_plain(q, k, v, scale)
    pr.put("chunked f32 baseline", ms(
        lambda x: attention_plain(x, k, v, scale), q, **t))
    for bq, bk in TILES:
        out = forward(q, k, v, scale, (bq, bk))
        pr.put(f"kernel f32 {bq}x{bk}", {
            "ms": ms(lambda x, b=(bq, bk): forward(x, k, v, scale, b), q, **t),
            "max_abs_err": err(out, ref)})
    qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
    for bq, bk in TILES:
        out = forward(qb, kb, vb, scale, (bq, bk))
        pr.put(f"kernel bf16 {bq}x{bk}", {
            "ms": ms(lambda x, b=(bq, bk): forward(x, kb, vb, scale, b), qb,
                     **t),
            "max_abs_err": err(out, ref)})
    out = chunked_kv_bf16(q, kb, vb, scale)
    pr.put("chunked kv-bf16 f32-softmax", {
        "ms": ms(lambda x: chunked_kv_bf16(x, kb, vb, scale), q, **t),
        "max_abs_err": err(out, ref)})
    del out
    dout = inputs(tuple(args.shape), 2, pr.dev)[0]
    for name, x in (("f32", (q, k, v)), ("bf16", (qb, kb, vb))):
        cot = dout.to(x[0].dtype)

        def fwd_bwd(qq, kk=x[1], vv=x[2], cot=cot):
            ins = [t_.detach().requires_grad_(True) for t_ in (qq, kk, vv)]
            with torch.enable_grad():
                o = attention(*ins, scale)
                return torch.autograd.grad(o, ins, cot)

        block = DEFAULT_BLOCK[x[0].dtype]
        pr.put(f"kernel {name} fwd+bwd {block[0]}x{block[1]}",
               ms(fwd_bwd, x[0], **t))
    if pr.dev.type == "cuda":
        library_lines(pr, q, k, v, ref, t)
    pr.write()
    return 0


if __name__ == "__main__":
    sys.exit(main())
