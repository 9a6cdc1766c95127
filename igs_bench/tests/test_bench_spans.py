"""``spans.py`` on synthetic kineto events: the span tree by nesting, host and
self host seconds, and each device operation under the innermost span
holding its launch, also when the launch ran on another thread (autograd's
backward thread) while the main thread waited in a span; then the readers
of the per-layer metrics, which read the counters, the numbers a table
yields a window, and the capture of a session."""

import pytest
from torch.autograd import DeviceType

from igs_bench import run as bench_run
from igs_bench import spans

MS = 1_000_000  # ns


class Event:
    """The kineto event interface ``spans.events`` and ``trace`` read (as
    PyTorch 2.11 has it: no ``activity_type``)."""

    def __init__(self, name, start, end, kind, thread=1, corr=0):
        self._name, self._start, self._dur = name, start, end - start
        self._kind, self._thread, self._corr = kind, thread, corr

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def start_thread_id(self):
        return self._thread

    def correlation_id(self):
        return self._corr

    def device_type(self):
        return (DeviceType.CUDA if self._kind in (
            "kernel", "gpu_memcpy", "gpu_user_annotation") else
            DeviceType.CPU)

    def is_user_annotation(self):
        return self._kind in ("user_annotation", "gpu_user_annotation")


class Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda _: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def _span(name, a, b, thread=1):
    return Event(name, a * MS, b * MS, "user_annotation", thread)


def _launch(at, corr, thread=1, name="cudaLaunchKernel"):
    return Event(name, at * MS, at * MS + MS // 100, "cuda_runtime", thread,
                 corr)


def _op(at, ms, corr, kind="kernel"):
    return Event(f"op{corr}", at * MS, at * MS + ms * MS, kind, corr=corr)


def clip():
    """One window: the copy, AGM-Net with a render, a refine of two steps
    whose backward launches from thread 2, and an operation launched
    outside every span."""
    return [
        _span("igs:stream.window", 0, 100),
        _span("igs:stream.h2d", 1, 5),
        _span("igs:agm", 10, 40),
        _span("igs:agm.render", 20, 30),
        _span("igs:refine", 50, 90),
        _span("igs:refine.step", 50, 70),
        _span("igs:refine.step", 70, 90),
        _span("bench:refine", 49, 91),
        _span("aten::add", 12, 13),
        # gpu-side copies of the annotations: not device work
        Event("igs:agm", 11 * MS, 41 * MS, "gpu_user_annotation"),
        _launch(2, 1, name="cudaMemcpyAsync"), _op(3, 8, 1, "gpu_memcpy"),
        _launch(12, 2), _op(14, 2, 2),
        _launch(25, 3), _op(26, 3, 3),
        _launch(55, 4), _op(56, 1, 4),
        _launch(60, 5, thread=2), _op(61, 4, 5),  # a backward's launch
        _launch(75, 6, thread=2), _op(76, 5, 6),
        _launch(95, 7), _op(96, 1, 7),  # in the window, in no stage
        _launch(120, 8), _op(121, 2, 8),  # after the window
        _op(130, 1, 9),  # its launch not in the trace
    ]


def test_span_table_nests_and_attributes_by_launch():
    table = spans.span_table(Prof(clip()))
    assert set(table) == {"igs:stream.window", "igs:stream.h2d", "igs:agm",
                          "igs:agm.render", "igs:refine", "igs:refine.step",
                          spans.NO_SPAN}
    want = {  # count, host ms, self host ms, device ms, parents
        "igs:stream.window": (1, 100, 100 - 4 - 30 - 40, 1, [""]),
        "igs:stream.h2d": (1, 4, 4, 8, ["igs:stream.window"]),
        "igs:agm": (1, 30, 20, 2, ["igs:stream.window"]),
        "igs:agm.render": (1, 10, 10, 3, ["igs:agm"]),
        "igs:refine": (1, 40, 0, 0, ["igs:stream.window"]),
        "igs:refine.step": (2, 40, 40, 1 + 4 + 5, ["igs:refine"]),
        spans.NO_SPAN: (0, 0, 0, 2 + 1, []),
    }
    for name, (n, host, own, dev, parents) in want.items():
        row = table[name]
        assert row["count"] == n, name
        assert row["host_s"] == pytest.approx(host * 1e-3), name
        assert row["self_host_s"] == pytest.approx(own * 1e-3), name
        assert row["device_s"] == pytest.approx(dev * 1e-3), name
        assert row["parents"] == parents, name


def test_spans_of_two_threads_nest_apart():
    """A span of thread 2 inside the interval of thread 1's span is no
    child of it; a launch during both goes to the later, inner one."""
    table = spans.span_table(Prof([
        _span("igs:train.backward", 0, 50),
        _span("igs:worker", 10, 20, thread=2),
        _launch(15, 1, thread=2), _op(16, 2, 1)]))
    assert table["igs:worker"]["parents"] == [""]
    assert table["igs:train.backward"]["self_host_s"] == pytest.approx(0.05)
    assert table["igs:worker"]["device_s"] == pytest.approx(2e-3)
    assert table["igs:train.backward"]["device_s"] == 0.0


def test_no_program_spans_reads_as_no_metric(monkeypatch):
    """A program without spans or counters (the parent of this benchmark's
    spans) leaves every device second outside a span, and the readers read
    nothing."""
    table = spans.span_table(Prof([_launch(1, 1), _op(2, 3, 1)]))
    assert table == {spans.NO_SPAN: {"count": 0, "host_s": 0.0,
                                     "self_host_s": 0.0,
                                     "device_s": pytest.approx(3e-3),
                                     "parents": []}}
    assert spans.layer_numbers(table) == {"span_device_share": 0.0}
    monkeypatch.setattr(spans, "program_counters", dict)
    for name in READINGS:
        assert bench_run.load_metric(name).read(_obs()) is None, name


READINGS = {  # metric: its reading of ``_obs`` and ``COUNTERS``
    "h2d_mb.stream": 992.0,
    "blend_ns_per_pair.stream": 1e9 * (0.2 + 0.3 + 0.01) / 3e9,
}
COUNTERS = {"stream.h2d_bytes": 1984 * 10**6,
            "raster.pairs_blended.fwd": 2 * 10**9,
            "raster.pairs_blended.bwd": 10**9}
LAYERS = {  # layer number: its reading of ``_table``
    "loop_host_ms.stream": 1e3 * (2.0 - 0.1 - 0.5 - 1.0) / 2,
    "anchors_ms.stream": 1e3 * 0.03 / 2,
    "agm_net_ms.stream": 1e3 * (0.05 + 0.02) / 2,
    "agm_render_ms.stream": 1e3 * 0.04 / 2,
    "refine_device_ms": 1e3 * (0.001 + 0.5 + 0.02) / 100,
    "optim_device_ms.train": 1e3 * 0.012 / 3,
    "span_device_share": 1.0 - 0.02 / 0.7,
}


def _row(count, host=0.0, device=0.0):
    return {"count": count, "host_s": host, "self_host_s": host,
            "device_s": device, "parents": []}


def _table():
    return {
        "igs:stream.window": _row(2, 2.0, 0.007),
        "igs:anchors": _row(2, 0.1, 0.03),
        "igs:agm": _row(2, 0.5, 0.0),
        "igs:agm.backbone": _row(2, 0.2, 0.05),
        "igs:agm.decode": _row(2, 0.1, 0.02),
        "igs:agm.render": _row(2, 0.1, 0.04),
        "igs:refine": _row(2, 1.0, 0.001),
        "igs:refine.step": _row(100, 0.9, 0.5),
        "igs:refine.densify": _row(4, 0.1, 0.02),
        "igs:optim": _row(3, 0.1, 0.012),
        spans.NO_SPAN: _row(0, 0.0, 0.02),
    }


def _obs():
    return {"trace": {
        "agm_forwards": 2,
        "device_seconds": {"void blend_fwd_kernel<0, 8>(float const*)": 0.2,
                           "void blend_bwd_kernel<0, 8>(float const*)": 0.3,
                           "void igs_blend::tile_order_kernel(int)": 0.01,
                           "void attn_fwd_bf16<64>()": 5.0}}}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader(name, monkeypatch):
    monkeypatch.setattr(spans, "program_counters", lambda: dict(COUNTERS))
    assert bench_run.load_metric(name).read(_obs()) == pytest.approx(
        READINGS[name])


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_number(name):
    assert spans.layer_numbers(_table())[name] == pytest.approx(
        LAYERS[name])


def test_capture_keeps_a_session_of_the_program():
    """A profiler session opened as the drivers open theirs leaves its
    span table and the program's counters; the profiler is restored."""
    import torch
    from igs_tpu_torch.utils import profiling

    base = torch.profiler.profile
    profiling.reset_counters()
    try:
        with spans.capture() as sessions:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU]):
                with profiling.span("stream.window"):
                    profiling.count("stream.h2d_bytes", 12)
                    torch.ones(4).sum()
    finally:
        profiling.reset_counters()
    assert torch.profiler.profile is base
    assert len(sessions) == 1
    assert sessions[0]["spans"]["igs:stream.window"]["count"] == 1
    assert sessions[0]["counters"] == {"stream.h2d_bytes": 12}
