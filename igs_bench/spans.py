"""The program's own spans and counters in a ``torch.profiler`` trace.

    python -m igs_bench.spans --workload <cell> --seed <n> --seconds <s>

runs the cell as ``igs_bench.run`` does, with ``--trace 1``, and prints
after its result line one JSON line for each profiler session the run
opened: the span table, the program's counters and ``layer_numbers``.

The port marks its layers with ``record_function("igs:<name>")`` spans
(``igs_tpu_torch/utils/profiling.span``), on the profiler's own clock, and
counts work with ``profiling.count`` while a profiler is active.

``span_table(prof)`` gives, for each span name: how many times it ran,
its host seconds, its self host seconds (less the host seconds of the
spans nested in it), the names of the spans it nests in, and the device
seconds of the operations it launched. A device operation belongs to
the innermost span whose host interval holds the start of the runtime
call that launched it (a host event named ``cuda…`` or ``cu…``: the
kineto events of some PyTorch versions carry no activity type). The
launch is matched by correlation id on any thread, so the work of
autograd's backward thread lands under the span that waits for it.
Operations whose launch no span holds, or whose launch the trace lacks,
are summed under ``NO_SPAN``.

``program_counters()`` reads the program's counters; a program without
them reads {}. The drivers keep no span table in what they observe, so
the per-layer metrics read only the counters (``h2d_mb.stream``,
``blend_ns_per_pair.stream``); ``layer_numbers`` gives the numbers a
table yields a window or a step, for this module's command.
"""

from __future__ import annotations

import contextlib
import json
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

PREFIX = "igs:"
NO_SPAN = "(no span)"

# (name, start ns, end ns, thread)
Span = Tuple[str, int, int, int]


def program_counters() -> Dict[str, int]:
    """The program's counters, {} where its profiling module has none."""
    from igs_tpu_torch.utils import profiling

    fn = getattr(profiling, "counters", None)
    return dict(fn()) if fn is not None else {}


def events(prof) -> Tuple[List[Span], Dict[int, int],
                          List[Tuple[int, int]]]:
    """(the ``igs:`` spans, the launch start of each runtime call by
    correlation id, the device operations as (correlation id, duration
    ns)) of a profiler's kineto events."""
    from torch.autograd import DeviceType

    from igs_bench.trace import _annotation, _ns

    spans, launches, ops = [], {}, []
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        dur = _ns(e, "duration")
        if e.device_type() == DeviceType.CUDA:
            if not _annotation(e):
                ops.append((int(e.correlation_id()), dur))
        elif e.name().startswith(PREFIX):
            spans.append((e.name(), start, start + dur,
                          int(e.start_thread_id())))
        elif e.name().startswith("cu"):  # a runtime or driver call
            launches[int(e.correlation_id())] = start
    return spans, launches, ops


def _parents(spans: List[Span]) -> List[Optional[int]]:
    """Each span's parent: the innermost span of its thread that holds
    it."""
    parent: List[Optional[int]] = [None] * len(spans)
    order = sorted(range(len(spans)),
                   key=lambda i: (spans[i][3], spans[i][1], -spans[i][2]))
    stack: List[int] = []
    thread = None
    for i in order:
        _, s, e, t = spans[i]
        if t != thread:
            stack, thread = [], t
        while stack and not (spans[stack[-1]][1] <= s
                             and e <= spans[stack[-1]][2]):
            stack.pop()
        parent[i] = stack[-1] if stack else None
        stack.append(i)
    return parent


def _innermost(spans: List[Span]):
    """(segment starts, segment ends, span index) of the elementary
    intervals between span boundaries that some span covers, each with
    the innermost covering span (the latest start, then the shortest)."""
    bounds = sorted({x for _, s, e, _ in spans for x in (s, e)})
    by_start = sorted(range(len(spans)), key=lambda i: spans[i][1])
    lo, hi, who = [], [], []
    active: List[int] = []
    j = 0
    for a, b in zip(bounds[:-1], bounds[1:]):
        while j < len(by_start) and spans[by_start[j]][1] <= a:
            active.append(by_start[j])
            j += 1
        active = [i for i in active if spans[i][2] > a]
        if active:
            lo.append(a)
            hi.append(b)
            who.append(max(active, key=lambda i: (spans[i][1],
                                                  -spans[i][2])))
    return (np.array(lo, dtype=np.int64), np.array(hi, dtype=np.int64),
            np.array(who, dtype=np.int64))


def attribute(spans: List[Span], launches: Dict[int, int],
              ops: List[Tuple[int, int]]) -> Dict[str, Dict]:
    """The table of ``span_table`` from plain rows (see ``events``)."""
    names = sorted({n for n, _, _, _ in spans})
    table = {n: {"count": 0, "host_s": 0.0, "self_host_s": 0.0,
                 "device_s": 0.0, "parents": set()} for n in names}
    parent = _parents(spans)
    for i, (n, s, e, _) in enumerate(spans):
        row = table[n]
        row["count"] += 1
        row["host_s"] += (e - s) * 1e-9
        row["self_host_s"] += (e - s) * 1e-9
        p = parent[i]
        row["parents"].add(spans[p][0] if p is not None else "")
        if p is not None:
            table[spans[p][0]]["self_host_s"] -= (e - s) * 1e-9
    none_s = 0.0
    if ops:
        lo, hi, who = _innermost(spans)
        t = np.array([launches.get(c, -1) for c, _ in ops], dtype=np.int64)
        dur = np.array([d for _, d in ops], dtype=np.int64) * 1e-9
        k = np.searchsorted(lo, t, side="right") - 1
        ok = (t >= 0) & (k >= 0)
        ok[ok] &= t[ok] < hi[k[ok]]
        acc = np.zeros(len(spans))
        np.add.at(acc, who[k[ok]], dur[ok])
        for i, (n, _, _, _) in enumerate(spans):
            table[n]["device_s"] += float(acc[i])
        none_s = float(dur[~ok].sum())
    for row in table.values():
        row["parents"] = sorted(row["parents"])
    table[NO_SPAN] = {"count": 0, "host_s": 0.0, "self_host_s": 0.0,
                      "device_s": none_s, "parents": []}
    return table


def span_table(prof) -> Dict[str, Dict]:
    """{span name (``igs:…``, and ``NO_SPAN``): count, host_s,
    self_host_s, device_s, parents} of a finished ``torch.profiler``
    session."""
    return attribute(*events(prof))


def device_s(table: Dict[str, Dict], names) -> float:
    """The device seconds attributed to the spans ``names``."""
    return sum(table[n]["device_s"] for n in names if n in table)


def count(table: Dict[str, Dict], name: str) -> int:
    return int(table.get(name, {}).get("count", 0))


AGM_NET = ("igs:agm.backbone", "igs:agm.motion", "igs:agm.condition",
           "igs:agm.triplane", "igs:agm.decode")
REFINE = ("igs:refine", "igs:refine.step", "igs:refine.densify")


def layer_numbers(table: Dict[str, Dict]) -> Dict[str, float]:
    """From a span table: a stream window's loop host ms (the window less
    its anchors, AGM-Net and refine) and the device ms of its anchors,
    AGM-Net's network and AGM-Net's renders; the refine's device ms a
    step; the optimizer's device ms a training step; and the share of the
    device seconds under some span. A number whose spans the table lacks
    is left out."""
    out: Dict[str, float] = {}
    windows = count(table, "igs:stream.window")
    if windows:
        host = table["igs:stream.window"]["host_s"] - sum(
            table[n]["host_s"] for n in ("igs:anchors", "igs:agm",
                                         "igs:refine") if n in table)
        out["loop_host_ms.stream"] = 1e3 * host / windows
        out["anchors_ms.stream"] = 1e3 * device_s(
            table, ["igs:anchors"]) / windows
        out["agm_net_ms.stream"] = 1e3 * device_s(table, AGM_NET) / windows
        out["agm_render_ms.stream"] = 1e3 * device_s(
            table, ["igs:agm.render"]) / windows
    steps = count(table, "igs:refine.step")
    if steps:
        out["refine_device_ms"] = 1e3 * device_s(table, REFINE) / steps
    steps = count(table, "igs:optim")
    if steps:
        out["optim_device_ms.train"] = 1e3 * device_s(
            table, ["igs:optim"]) / steps
    total = sum(row["device_s"] for row in table.values())
    if total > 0:
        out["span_device_share"] = 1.0 - device_s(table, [NO_SPAN]) / total
    return out


@contextlib.contextmanager
def capture():
    """Within the block, each ``torch.profiler.profile`` session opened
    through ``from torch.profiler import profile`` (as the drivers open
    theirs) appends, on its exit, its span table and the program's
    counters to the list the block is given."""
    import torch.profiler

    sessions: List[Dict] = []
    base = torch.profiler.profile

    class Kept(base):
        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            sessions.append({"spans": span_table(self),
                             "counters": program_counters()})
            return out

    torch.profiler.profile = Kept
    try:
        yield sessions
    finally:
        torch.profiler.profile = base


def main(argv: Optional[List[str]] = None) -> int:
    from igs_bench import run as bench_run

    argv = list(sys.argv[1:] if argv is None else argv) + ["--trace", "1"]
    with capture() as sessions:
        rc = bench_run.main(argv)
    for s in sessions:
        print(json.dumps({**s, "layers": layer_numbers(s["spans"])}),
              flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
