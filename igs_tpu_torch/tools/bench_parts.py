"""Component probe: the windowed blend kernels alone, the window gather
and its transpose, the projection's forward+backward, and the attention
kernel at the AGM triplane shape against a chunked plain version, with a
numerics check.

    python -m igs_tpu_torch.tools.bench_parts [--what blend|attn|all]
        [--n 150000] [--res 512] [--maxpt 512] [--attn 5 8 8192 64]
        [--device cpu]

Counterpart of ``tools/tools_bench_parts.py`` (150 000 Gaussians at
512², a 2^19 pair budget, windows of ``maxpt`` 512, colour mode). Lines:
the forward kernel B5a alone, B5a then B5b on a unit cotangent, the
window gather (``gather_tile_windows``) and the gather followed by its
transpose (``fold_tile_windows``), and the projection and feature pack,
forward and backward (the gradient of the pack's sum with respect to
all five parameter tensors). The port's kernels read each tile's pairs
in place, so the window gather is the plain versions' layout, timed as
the TPU's counterpart. Attention: the JAX probe's ``flash`` line (the
Pallas TPU flash attention) becomes the port's own kernel B7
(``ops.attention``; the plain version on ``--device cpu``), in float32
and on bf16 copies of the inputs (made before the timing), each against
the plain version that takes the softmax over 1024-query chunks
(``attention_plain``), at (B, H, L, C) = (5, 8, 8192, 64) float32; then
the chunked plain version itself. PyTorch's
``scaled_dot_product_attention`` follows under each of its backends
(flash, memory-efficient, math) as a library yardstick the port never
calls (``bench_attn.library_lines``): a backend that has no kernel for
float32 inputs on the device (flash on a card) runs on bfloat16 copies,
made before the timing, and the line says so; one that has none at all
is reported as unavailable.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from igs_tpu_torch.ops.blend import pack_features
from igs_tpu_torch.ops.blend_windowed import (blend_raw_bwd, blend_raw_fwd,
                                              fold_tile_windows,
                                              gather_tile_windows)
from igs_tpu_torch.ops.attention import attention_plain
from igs_tpu_torch.ops.projection import project
from igs_tpu_torch.tools.bench_attn import err, forward, library_lines
from igs_tpu_torch.tools.probe import (Probe, camera, ms, packed_inputs,
                                       parser, scene)


def blend_parts(pr, args):
    g = scene(args.n, pr.dev)
    cam = camera(args.res, pr.dev)
    proj, pairs, feats_t, gx, gy = packed_inputs(g, cam, "full",
                                                 args.max_pairs,
                                                 segred_aux=False)
    counts = torch.clamp_max(pairs.tile_count, args.maxpt)
    pr.put("tile_counts", {
        "max": int(pairs.tile_count.max()),
        "mean": float(pairs.tile_count.float().mean()),
        f"overflow@{args.maxpt}": int((pairs.tile_count > args.maxpt).sum())})
    k = dict(K=args.K, iters=args.iters)
    start = pairs.tile_start

    def fwd(ft):
        return blend_raw_fwd(ft, start, counts, gx, gy, "color")

    def fwd_bwd(ft):
        raw = fwd(ft)
        return blend_raw_bwd(ft, start, counts, gx, gy, "color", raw,
                             torch.ones_like(raw))

    def gather(ft):
        return gather_tile_windows(ft, start, args.maxpt)

    def gather_fold(ft):
        w = gather(ft)
        return fold_tile_windows(torch.ones_like(w), start, counts,
                                 ft.shape[1])

    def proj_pack(xyz, opacity, scaling, rotation, shs):
        params = [t.detach().requires_grad_(True)
                  for t in (xyz, opacity, scaling, rotation, shs)]
        with torch.enable_grad():
            p = project(params[0], torch.exp(params[2]),
                        torch.nn.functional.normalize(params[3], dim=-1),
                        torch.sigmoid(params[1]), cam, shs=params[4],
                        valid=g.valid)
            return torch.autograd.grad(pack_features(p).sum(), params)

    pr.put("blend fwd kernel", ms(fwd, feats_t, **k))
    pr.put("blend fwd+bwd kernels", ms(fwd_bwd, feats_t, **k))
    pr.put("window gather fwd", ms(gather, feats_t, **k))
    pr.put("window gather fwd+bwd", ms(gather_fold, feats_t, **k))
    pr.put("projection+pack fwd+bwd", ms(
        proj_pack, g.xyz, g.opacity, g.scaling, g.rotation, g.shs, **k))


def attn_parts(pr, args):
    b, h, length, c = args.attn
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, h, length, c)).astype(
        np.float32)).to(pr.dev) for _ in range(3))
    scale = c ** -0.5
    ref = attention_plain(q, k, v, scale)
    t = dict(K=args.attn_K, iters=args.iters)
    for label, dtype in (("attn kernel", torch.float32),
                         ("attn kernel bf16", torch.bfloat16)):
        qq, kk, vv = (x.to(dtype) for x in (q, k, v))
        pr.put(label, {
            "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": err(forward(qq, kk, vv, scale), ref),
            "ms": ms(lambda x, kk=kk, vv=vv: forward(x, kk, vv, scale), qq,
                     **t)})
    pr.put("attn chunked", ms(lambda x: attention_plain(x, k, v, scale), q,
                              **t))
    library_lines(pr, q, k, v, ref, t, prefix="attn")


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--what", default="all", choices=["blend", "attn", "all"])
    ap.add_argument("--n", type=int, default=150_000)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--maxpt", type=int, default=512)
    ap.add_argument("--attn", type=int, nargs=4, default=[5, 8, 8192, 64],
                    metavar=("B", "H", "L", "C"))
    ap.add_argument("--K", type=int, default=8)
    ap.add_argument("--attn-K", type=int, default=4)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--max-pairs", type=int, default=1 << 19)
    args = ap.parse_args(argv)
    pr = Probe("bench_parts", args)
    if args.what in ("blend", "all"):
        blend_parts(pr, args)
    if args.what in ("attn", "all"):
        attn_parts(pr, args)
    pr.write()
    return 0


if __name__ == "__main__":
    sys.exit(main())
