"""Exact K-nearest neighbours and Morton-bucketed farthest-point sampling.

Counterpart of ``igs_tpu/ops/knn.py``. The JAX package can swap the exact
top-k for ``jax.lax.approx_max_k`` (recall ≈ 0.99); the port always
computes the exact top-k, which that path approximates. Ties go to the
lowest index, as ``lax.top_k`` breaks them.
"""

from __future__ import annotations

import math

import torch

_BIG = 1e30


def _ordered_key(d2: torch.Tensor) -> torch.Tensor:
    """Unique int64 keys ordered like (d2, column index)."""
    bits = d2.contiguous().view(torch.int32).to(torch.int64)
    # order-preserving map of IEEE floats onto signed integers
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    col = torch.arange(d2.shape[-1], device=d2.device, dtype=torch.int64)
    return (bits << 32) | col


def knn(points: torch.Tensor, queries: torch.Tensor, k: int,
        points_valid: torch.Tensor | None = None,
        chunk: int = 4096) -> tuple[torch.Tensor, torch.Tensor]:
    """For each query, the k nearest ``points``: (dists (Q,k), idx (Q,k)).

    Invalid points never match unless fewer than k valid ones exist.
    """
    pp = torch.sum(points * points, dim=-1)
    if points_valid is not None:
        pp = torch.where(points_valid, pp, torch.full_like(pp, _BIG))
    dists, idxs = [], []
    for q0 in range(0, queries.shape[0], chunk):
        qc = queries[q0:q0 + chunk]
        d2 = (torch.sum(qc * qc, dim=-1, keepdim=True)
              - 2.0 * qc @ points.T + pp[None, :])
        if points_valid is not None:
            d2 = torch.where(points_valid[None, :], d2, torch.full_like(d2, _BIG))
        key = torch.topk(_ordered_key(d2), k, dim=-1, largest=False).values
        idx = key & 0xFFFFFFFF
        dists.append(torch.gather(d2, 1, idx))
        idxs.append(idx)
    d2s = torch.cat(dists)
    return torch.sqrt(torch.clamp_min(d2s, 0.0)), torch.cat(idxs)


def knn_weights(anchors: torch.Tensor, points: torch.Tensor, k: int = 8,
                temperature: float = 10.0
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Anchor-interpolation weights: softmax(−temperature·distance) over
    each point's k nearest anchors (the reference's get_mask_fpsample
    tail, gs.py:1004-1009). Returns (weights (N, k), idx (N, k)) for every
    point; points outside the dynamic mask carry unused weights (gate
    them with the mask downstream). The JAX function's ``points_valid``
    is ignored there and left out here."""
    dist, idx = knn(anchors, points, k)
    return torch.softmax(-temperature * dist, dim=-1), idx


def _morton_order(points: torch.Tensor, valid: torch.Tensor,
                  bits: int = 10) -> torch.Tensor:
    """Sort order by 30-bit Morton code (invalid points last).

    The uint32 shifts of the reference run in int64 with masks.
    """
    v = valid[:, None]
    lo = torch.amin(torch.where(v, points, torch.full_like(points, _BIG)), 0)
    hi = torch.amax(torch.where(v, points, torch.full_like(points, -_BIG)), 0)
    extent = torch.clamp_min(hi - lo, 1e-8)
    top = float(2**bits - 1)
    grid = torch.clamp((points - lo) / extent * top, 0.0, top).to(torch.int64)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = (spread(grid[:, 0]) | (spread(grid[:, 1]) << 1)
            | (spread(grid[:, 2]) << 2))
    code = torch.where(valid, code, torch.full_like(code, 0xFFFFFFFF))
    return torch.argsort(code, stable=True)


def farthest_point_sampling(points: torch.Tensor, num_samples: int,
                            valid: torch.Tensor | None = None,
                            num_buckets: int = 64) -> torch.Tensor:
    """Bucketed FPS: ``num_samples`` indices into ``points``.

    Morton order cuts the points into spatially coherent buckets; greedy
    FPS runs in every bucket at once for its share of the samples. With
    fewer valid points than samples, indices repeat.
    """
    n = points.shape[0]
    dev = points.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    num_buckets = math.gcd(num_samples, num_buckets)
    per = num_samples // num_buckets

    order = _morton_order(points, valid)
    pts = points[order]
    val = valid[order]
    # valid points sort first; collapse invalid ones onto the first valid
    # so exhausted buckets fall back to a valid index
    pts = torch.where(val[:, None], pts, pts[0:1])

    bucket = max(1, n // num_buckets)
    usable = bucket * num_buckets
    bpts = pts[:usable].reshape(num_buckets, bucket, 3)
    bval = val[:usable].reshape(num_buckets, bucket)
    rows = torch.arange(num_buckets, device=dev)

    last = torch.argmax(bval.to(torch.uint8), dim=1)  # first valid (0 if none)
    mind2 = torch.full((num_buckets, bucket), _BIG, device=dev)
    neg = torch.full_like(mind2, -1.0)
    sel = [last]
    for _ in range(per - 1):
        d2 = torch.sum((bpts - bpts[rows, last][:, None, :]) ** 2, dim=-1)
        mind2 = torch.minimum(mind2, d2)
        last = torch.argmax(torch.where(bval, mind2, neg), dim=1)
        sel.append(last)
    flat = (torch.stack(sel, 1) + (rows * bucket)[:, None]).reshape(-1)
    return torch.where(val[flat], order[flat], order[0])
