"""Softmax attention over (B, H, L, C) in plain PyTorch: float32 scores
over chunks of queries, keys outside the query's region excluded, a
float32 softmax cast to v's type, then P·V in v's type.

``record(list)`` appends each call's (shape, pairs, dtype) to the list: the
benchmark counts attention's work from it (``igs_bench/flops.py``).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

from igs_bench.reference import lowp

QUERY_CHUNK = 1024
_CALLS = contextvars.ContextVar("igs_bench_attention_calls", default=None)


@contextlib.contextmanager
def record(calls: list):
    token = _CALLS.set(calls)
    try:
        yield calls
    finally:
        _CALLS.reset(token)


def region_pairs(shape, region_ids: Optional[torch.Tensor]) -> int:
    """The (query, key) pairs that the function needs: all of them, or
    those within one region."""
    b, h, length, _ = shape
    if region_ids is None:
        return b * h * length * length
    ids = region_ids.cpu().long()
    total = 0
    for row in ids:
        counts = torch.bincount(row)
        total += int((counts * counts).sum())
    return b * total


def attention(q, k, v, scale: float,
              region_ids: Optional[torch.Tensor] = None,
              chunk: int = QUERY_CHUNK,
              host_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``host_ids``: ``region_ids`` on the host, for ``record`` where the
    call runs on the meta device."""
    calls = _CALLS.get()
    if calls is not None:
        ids = region_ids if host_ids is None else host_ids
        calls.append((tuple(q.shape), region_pairs(q.shape, ids), q.dtype))
    q, k, v = (lowp.round_input(t, t.dtype) for t in (q, k, v))
    kt = k.float().transpose(-1, -2)
    outs = []
    for s0 in range(0, q.shape[2], chunk):
        s = torch.matmul(q[:, :, s0:s0 + chunk].float(), kt) * scale
        if region_ids is not None:
            same = region_ids[:, s0:s0 + chunk, None] == region_ids[:, None, :]
            s = s.masked_fill(~same, float("-inf"))
        outs.append(torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v))
    return torch.cat(outs, dim=2)
