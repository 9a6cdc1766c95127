"""Step timers, memory stats, traces, spans, counters, debug snapshots and
launch counts.

Counterpart of ``igs_tpu/utils/profiling.py``:
  * ``StepTimer``: host-clock step durations; ``stop(result)`` first
    synchronizes every CUDA device that holds a tensor of ``result``;
  * ``device_memory_stats``: per card, from ``torch.cuda.memory_stats``,
    with the JAX version's keys (``bytes_limit_mb`` is the card's memory:
    PyTorch's allocator has no other limit);
  * ``trace(logdir)``: ``torch.profiler`` around the block, its Chrome
    trace written to ``logdir/trace.json``;
  * ``debug_dump_on_nonfinite`` and ``JsonlLogger``: the same files as the
    JAX versions.
``kernel_launches`` reads the launch counters of the port's kernel
wrappers, by the names ``chip_smoke.py`` reports.

Spans and counters, for a ``torch.profiler`` session (no switch of their
own: they are on exactly while a profiler is):
  * ``span(name)``: a ``record_function("igs:<name>")`` around the block,
    so the span sits in the profiler's timeline, on the clock of every
    device operation; a name is ``<layer>`` or ``<layer>.<stage>``
    (``stream.window``, ``agm.render``, ``refine.step``). With no
    profiler active it checks one flag and constructs nothing;
  * ``count(name, n)``: adds ``n`` (an int, or the sum of a tensor's
    elements, kept on its device with ``add_`` and never read back) to the
    counter ``name``;
    ``counters()`` reads them all (a tensor counter syncs its device
    then), ``reset_counters()`` clears them. With no profiler active
    ``count`` does nothing.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()
_counters: Dict[str, Union[int, torch.Tensor]] = {}
_counters_lock = threading.Lock()


def span(name: str):
    """The block as the span ``igs:<name>`` of an active ``torch.profiler``
    session; without one, a shared no-op context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(f"igs:{name}")


def count(name: str, n: Union[int, torch.Tensor]) -> None:
    """Add ``n`` to the counter ``name`` while a profiler is active. For a
    tensor ``n`` its elements' sum is added on its device: the counter is
    then an int64 device tensor summed with ``add_`` (outside inference
    mode, so that inference and autograd code may both add to it)."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    with _counters_lock:
        if isinstance(n, torch.Tensor):
            with torch.inference_mode(False):
                total = _counters.get(name)
                if total is None:
                    total = _counters[name] = torch.zeros(
                        (), dtype=torch.int64, device=n.device)
                total.add_(n.detach().sum())
        else:
            _counters[name] = _counters.get(name, 0) + int(n)


def counters() -> Dict[str, int]:
    """Every counter's total since the last reset (device totals read
    back here)."""
    with _counters_lock:
        return {k: int(v) for k, v in _counters.items()}


def reset_counters() -> None:
    with _counters_lock:
        _counters.clear()


def _cuda_devices(obj, found=None) -> set:
    found = set() if found is None else found
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            found.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, found)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _cuda_devices(v, found)
    return found


class StepTimer:
    """Accumulates device-synchronized step durations."""

    def __init__(self):
        self.durations: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.time()

    def stop(self, result=None) -> float:
        for dev in _cuda_devices(result):
            torch.cuda.synchronize(dev)
        dt = time.time() - self._t0
        self.durations.append(dt)
        return dt

    @contextlib.contextmanager
    def measure(self):
        self.start()
        out = {}
        yield out
        self.stop(out.get("result"))

    def summary(self) -> Dict[str, float]:
        if not self.durations:
            return {"count": 0}
        d = np.asarray(self.durations)
        return {
            "count": len(d),
            "mean_s": float(d.mean()),
            "median_s": float(np.median(d)),
            "p90_s": float(np.percentile(d, 90)),
            "total_s": float(d.sum()),
        }


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Per-card allocator stats in MiB ({} without a card)."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        st = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use_mb": st.get("allocated_bytes.all.current", 0)
            / 2**20,
            "peak_bytes_mb": st.get("allocated_bytes.all.peak", 0) / 2**20,
            "bytes_limit_mb": torch.cuda.get_device_properties(i).total_memory
            / 2**20,
        }
    return out


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` around the block (the CPU, and the cards when
    there are any); the Chrome trace goes to ``logdir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        with prof:
            yield prof
    finally:
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def debug_dump_on_nonfinite(workspace: str, tag: str, **arrays) -> bool:
    """If any array is non-finite, dump ALL of them to
    ``workspace/snapshot_<tag>.npz`` and return True."""
    arrays = {k: _numpy(v) for k, v in arrays.items()}
    bad = any(a.dtype.kind == "f" and not np.isfinite(a).all()
              for a in arrays.values())
    if bad:
        os.makedirs(workspace, exist_ok=True)
        np.savez_compressed(os.path.join(workspace, f"snapshot_{tag}.npz"),
                            **arrays)
    return bad


class JsonlLogger:
    """Append-only scalar logging."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path

    def log(self, step: int, **scalars):
        rec = {"step": step}
        rec.update({k: float(v) for k, v in scalars.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def kernel_launches() -> Dict[str, int]:
    """Launches of every kernel wrapper of the port since its last reset:
    the blends per mode, the scan, the count, the segscan layout probes
    and the attention forward and backward."""
    from igs_tpu_torch.ops import attention, blend, blend_windowed, count
    from igs_tpu_torch.ops import segred
    from igs_tpu_torch.tools import segscan_fold

    out = {}
    for name, fn in (("blend_fwd_packed", blend.blend_raw_packed_cuda),
                     ("blend_bwd_packed", blend.blend_raw_packed_bwd_cuda),
                     ("blend_fwd_win", blend_windowed.blend_raw_cuda),
                     ("blend_bwd_win", blend_windowed.blend_raw_bwd_cuda)):
        out.update({f"{name}/{m}": n for m, n in fn.launches_by_mode.items()})
    out["segmented_scan"] = segred.segmented_scan_cuda.launches
    out["count_contributions_packed"] = \
        count.count_contributions_packed_cuda.launches
    for v in segscan_fold.VARIANTS:
        out[f"segscan_fold/{v}"] = getattr(segscan_fold, f"{v}_cuda").launches
    out["attention_fwd"] = attention.attention_fwd_cuda.launches
    out["attention_bwd"] = attention.attention_bwd_cuda.launches
    return out
