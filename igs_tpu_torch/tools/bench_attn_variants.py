"""Time B7 and B8 (``csrc/attention.cu``) against variants of the same
source that each take back one design choice, and against an earlier
commit's source, built and timed in one process on one card.

    mkdir -p build/parent_csrc
    git show <commit>:igs_tpu_torch/csrc/attention.cu \\
        > build/parent_csrc/attention.cu
    python -m igs_tpu_torch.tools.bench_attn_variants \\
        [--parent build/parent_csrc/attention.cu] [--variants a b ...]

The cases are the first three of ``chip_smoke.py``'s ``ATTN_CASES``
(the triplane and the swin windows, shifted and not), with the same
seeded inputs. Each variant is the committed source with text replaced
(``VARIANTS``; a variant whose text is gone raises), written under
``<build root>/attn_variants/`` and built by ``ops/cuda_build`` (one nvcc
for each, all started at once), its entry points bound by
``ops/attention.bind``; the parent's forward tiles are ``--parent-tiles``
(64x64, 128x64, 64x128 by default, the tiles before 128x128 replaced
64x128). The backward's D = rowsum(dO·O) is computed once in torch,
outside its timing, for every build (an older source may have no kernel
for it). Per case, dtype and build: the forward's ms
at each tile and the backward's (CUDA events over 5 and 3 eager launches
after one warm-up, the builds in turns), and each output's largest error
over its largest entry against the plain f32 version. Every line is JSON
on stdout, the card's name and power limit first; ``--out`` also writes
them all.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import torch

from igs_tpu_torch.ops import attention as A
from igs_tpu_torch.ops import cuda_build
from igs_tpu_torch.utils.cache import build_root

SRC = cuda_build.CSRC / "attention.cu"

# each variant takes back one choice of the committed source (old text →
# new text)
VARIANTS = {
    # the f32 backward at C = 128 in blocks of 64 rows (four warps)
    "f32_bwd_4_warps": [
        ("BQ = CB == 128 ? 128 : 64, BK = 32, NT = BQ * 2,",
         "BQ = 64, BK = 32, NT = BQ * 2,"),
        ("BK = CB == 128 ? 128 : 64, BQ = 32, NT = BK * 2,",
         "BK = 64, BQ = 32, NT = BK * 2,")],
    # one block an SM for the bf16 forward (no register bound)
    "one_block_an_sm": [("MINB = BK == 128 ? 1 : 2;", "MINB = 1;")],
    # f32 on mma.sync at every head dim (not wgmma at C <= 64)
    "f32_mma_sync": [
        ("if constexpr (CB <= 64 && BK == 64)\n    return run(attn_fwd_tf32",
         "if constexpr (false)\n    return run(attn_fwd_tf32"),
        ("  if constexpr (CB <= 64) {\n    using A = DkvTf32<CB>;",
         "  if constexpr (false) {\n    using A = DkvTf32<CB>;")],
    # the softmax and P through expf (natural base, the accurate call)
    "expf": [
        ("alpha[half] = ex2(m[half] - mu);",
         "alpha[half] = expf((m[half] - mu) * LN2);"),
        ("s[nb][e] = ex2(fmaf(s[nb][e], scale2, -mu));",
         "s[nb][e] = expf((s[nb][e] * scale2 - mu) * LN2);"),
        ("? ex2(fmaf(s[nb][e], scale2, -ls * LOG2E))",
         "? expf(s[nb][e] * scale2 * LN2 - ls)")],
    # every tile visited under region ids (scores still compared)
    "no_tile_skip": [
        ("const bool live = (b & own) != 0u;", "const bool live = true;")],
}
# chip_smoke.ATTN_CASES[:3]: (name, (B, H, L, C), swin shift ids)
CASES = (("triplane", (5, 8, 8192, 64), False),
         ("swin shifted", (80, 4, 1024, 128), True),
         ("swin", (80, 4, 1024, 128), False))
SWIN_MAP = 64  # the feature map whose 2x2 windows the swin cases hold


def case_inputs(dev, shape, shifted, dtype, seed):
    """q, k, v, a cotangent and the region ids, as chip_smoke.py's
    attention_inputs makes them."""
    from igs_tpu_torch.models.swin import shift_window_region_ids

    gen = torch.Generator(device=dev).manual_seed(seed)
    xs = [torch.randn(shape, generator=gen, device=dev).to(dtype)
          for _ in range(4)]
    ids = None
    if shifted:
        w = SWIN_MAP // 2
        ids = torch.from_numpy(shift_window_region_ids(
            SWIN_MAP, SWIN_MAP, w, w, w // 2, w // 2)).to(dev)
    return xs, ids


def build(named: dict) -> dict:
    """{name: source text} built at once → {name: bound entry points}."""
    root = build_root() / "attn_variants"
    root.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, text in named.items():
        paths[name] = str(root / f"{name}.cu")
        Path(paths[name]).write_text(text)
    cuda_build.build(list(paths.values()))
    return {name: A.bind(cuda_build.load(p)) for name, p in paths.items()}


def event_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--parent", default=None,
                    help="an earlier attention.cu to build and time too")
    ap.add_argument("--parent-tiles", default="64x64,128x64,64x128")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_attn_variants: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    lines = [{"card": card.strip()}]
    print(json.dumps(lines[0]), flush=True)
    src = SRC.read_text()
    named = {"committed": src}
    for name in args.variants:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise ValueError(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        named[name] = text
    tiles = {name: A.TILES for name in named}
    if args.parent:
        named["parent"] = Path(args.parent).read_text()
        tiles["parent"] = tuple(tuple(int(x) for x in t.split("x"))
                                for t in args.parent_tiles.split(","))
    t0 = time.perf_counter()
    libs = build(named)
    print(json.dumps({"built": list(libs),
                      "seconds": time.perf_counter() - t0}), flush=True)
    dev = torch.device("cuda")
    for ci, (case, shape, shifted) in enumerate(CASES):
        for dt in (torch.float32, torch.bfloat16):
            (q, k, v, do), ids = case_inputs(dev, shape, shifted, dt,
                                             100 + ci)
            scale = shape[-1] ** -0.5
            ins = [x.float().detach().requires_grad_(True) for x in (q, k, v)]
            ref = A.attention_plain(*ins, scale, ids)
            refs = [ref.detach()] + list(torch.autograd.grad(
                ref, ins, do.float()))
            del ins, ref
            bh, h, length, c = (shape[0] * shape[1], shape[1], shape[2],
                                shape[3])
            rid = None if ids is None else ids.data_ptr()
            bf16 = int(dt == torch.bfloat16)
            for name, lib in libs.items():
                row = {"build": name, "case": case,
                       "dtype": str(dt).replace("torch.", "")}
                o = torch.empty_like(q)
                lse = torch.empty(shape[:3], device=dev)

                def fwd(tile):
                    err = lib["fwd"](
                        q.data_ptr(), k.data_ptr(), v.data_ptr(), rid,
                        o.data_ptr(), lse.data_ptr(), bh, h, length, c,
                        scale, bf16, tile, None)
                    if err:
                        raise RuntimeError(f"{name}: forward error {err}")

                for ti, tile in enumerate(tiles[name]):
                    row[f"ms_{tile[0]}x{tile[1]}"] = event_ms(
                        lambda: fwd(ti), 5)
                block = A.DEFAULT_BLOCK[dt]
                fwd(tiles[name].index(block) if block in tiles[name] else 0)
                delta = (do.float() * o.float()).sum(-1).contiguous()
                g = [torch.empty_like(q) for _ in range(3)]

                def bwd():
                    err = lib["bwd"](
                        q.data_ptr(), k.data_ptr(), v.data_ptr(), rid,
                        do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        *(x.data_ptr() for x in g), bh, h, length, c, scale,
                        bf16, None)
                    if err:
                        raise RuntimeError(f"{name}: backward error {err}")

                row["bwd_ms"] = event_ms(bwd, 3)
                row["rel_err"] = dict(zip(
                    ("out", "dq", "dk", "dv"),
                    (float((a.float() - b).abs().max() / b.abs().max())
                     for a, b in zip([o] + g, refs))))
                print(json.dumps(row), flush=True)
                lines.append(row)
            del refs
            torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(lines, indent=1))


if __name__ == "__main__":
    main()
