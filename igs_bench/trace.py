"""The reduction of a ``torch.profiler`` trace to the benchmark's device
numbers: the union of the device's busy intervals, its time by operation
name, and the longest idle gaps named by what the host was doing."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _ns(event, what: str) -> int:
    """An event's start or duration in ns, across PyTorch versions."""
    fn = getattr(event, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(event, f"{what}_us")()) * 1000


def _events(prof):
    """(device events, host events): (name, start ns, end ns) each."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        end = start + _ns(e, "duration")
        row = (e.name(), start, end)
        if e.device_type() != DeviceType.CUDA:
            host.append(row)
        elif not _annotation(e):
            dev.append(row)
    return dev, host


def _annotation(event) -> bool:
    """A span of the host's drawn on the device's timeline (the
    ``record_function`` labels), not an operation of the device."""
    fn = getattr(event, "is_user_annotation", None)
    return bool(fn()) if fn is not None else event.name().startswith(
        "bench:")


def _union(intervals: np.ndarray) -> np.ndarray:
    """Merged (start, end) rows of ``intervals``, sorted."""
    if not len(intervals):
        return intervals
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    merged = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return np.array(merged, dtype=np.int64)


def _gap_name(host, starts, ends, is_span, lo: int, hi: int) -> str:
    """What the host was doing across the gap (lo, hi): the innermost of
    the benchmark's spans (``bench:``, else "pipeline") around the gap's
    middle, then the shortest host operation around it, or, where the
    host ran no operation (Python between calls), "python after" the last
    operation that began before the gap."""
    mid = (lo + hi) // 2
    cover = (starts <= mid) & (ends >= mid)
    length = ends - starts

    def shortest(mask):
        idx = np.nonzero(mask)[0]
        return int(idx[np.argmin(length[idx])]) if len(idx) else None

    span = shortest(cover & is_span)
    op = shortest(cover & ~is_span)
    if op is not None:
        what = host[op][0]
    else:
        idx = np.nonzero((starts <= lo) & ~is_span)[0]
        what = ("python after " + host[int(idx[np.argmax(starts[idx])])][0]
                if len(idx) else "python")
    return f"{host[span][0] if span is not None else 'pipeline'} > {what}"[
        :200]


def reduce_trace(prof, window_s: float, top: int = 10) -> Dict:
    """busy_s (the union of device intervals), window_s (as given: the
    traced span on the host clock), device seconds by operation name, and
    ``breakdown`` as the result line carries it."""
    dev, host = _events(prof)
    iv = np.array([(s, e) for _, s, e in dev], dtype=np.int64).reshape(-1, 2)
    merged = _union(iv)
    busy = float((merged[:, 1] - merged[:, 0]).sum()) * 1e-9 if len(merged) \
        else 0.0
    by_name: Dict[str, float] = {}
    for name, s, e in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps: List = []
    if len(merged) > 1:
        lo, hi = merged[:-1, 1], merged[1:, 0]
        order = np.argsort(lo - hi)[:top]  # longest first
        starts = np.array([s for _, s, _ in host], dtype=np.int64)
        ends = np.array([e for _, _, e in host], dtype=np.int64)
        is_span = np.array([n.startswith("bench:") for n, _, _ in host],
                           dtype=bool)
        gaps = [[_gap_name(host, starts, ends, is_span, int(lo[i]),
                           int(hi[i])), float(hi[i] - lo[i]) * 1e-9]
                for i in order]
    return {
        "busy_s": busy,
        "window_s": window_s,
        "device_seconds": by_name,
        "breakdown": {"device_ops": [[n[:200], s] for n, s in ops],
                      "idle_gaps": gaps},
    }


def seconds_matching(device_seconds: Dict[str, float], names) -> float:
    """The device seconds of the operations whose name holds any of
    ``names``."""
    return sum(s for n, s in device_seconds.items()
               if any(k in n for k in names))
