"""The port's spans and counters (``utils/profiling.span``/``count``) on the
CPU: nothing is built or counted without a profiler; under one, a tiny
``StreamingPipeline.run`` (two windows of B=2 on the in-memory stream of
the pipeline tests, a three-step refine with one densify after each)
emits its span tree, its host-to-device bytes and its blended pairs, and
a train step its four stage spans; the calls the benchmark rebinds stay
where it rebinds them."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import igs_tpu_torch.stream.pipeline as pipeline_mod
from igs_tpu_torch.core.camera import Camera
from igs_tpu_torch.models.agm import AGMNet
from igs_tpu_torch.ops.rasterize import RasterSettings, build_pairs_packed
from igs_tpu_torch.stream.pipeline import StreamConfig, StreamingPipeline
from igs_tpu_torch.stream.refine import (
    RefineConfig, init_refine_state, refine_step)
from igs_tpu_torch.train.driver import (
    OptConfig, make_optimizer, make_train_step)
from igs_tpu_torch.utils import profiling
from tests.conftest import random_gaussians
from tests.torch_port_common import (
    TINY, MemoryStream, stream_items, to_torch_gaussians)

torch.set_num_threads(2)

OUT_HW = (40, 48)
CFG = dict(eval_batch_size=2, refine_gs=True, refine_iterations=3,
           max_num=320, anchor_size=32, neighbor_k=4, save_images=False,
           depth_view_res=16)
# a densify at step 2 of each refine
REFINE = RefineConfig(densification_interval=2)

# each span's parent in the stream loop, as ``igs:<name>`` ("" = root)
TREE = {
    "stream.window": "",
    "stream.collate": "stream.window",
    "stream.probe": "stream.window",
    "stream.h2d": "stream.window",
    "anchors": "stream.window",
    "agm": "stream.window",
    "agm.backbone": "agm",
    "agm.motion": "agm",
    "agm.condition": "agm",
    "agm.triplane": "agm",
    "agm.decode": "agm",
    "agm.render": "agm",
    "stream.readback": "stream.window",
    "refine.upload": "stream.window",
    "refine": "stream.window",
    "refine.step": "refine",
    "refine.densify": "refine.step",
    "stream.rerender": "stream.window",
}


def _stream(tmp_path):
    """(pipeline, dataset) of two windows, each ending in a refine on the
    key frame's four input views."""
    tg = to_torch_gaussians(random_gaussians(n=256, seed=3).pad_to(320))
    items = stream_items(n_items=4, out_hw=OUT_HW)
    rng = np.random.RandomState(5)
    refine = {k: {"images": [rng.uniform(0, 1, (3,) + OUT_HW).astype(
        np.float32) for _ in range(4)],
        "c2ws": list(items[0]["c2w_input"]), "FOV": items[0]["FOV"],
        "bg": np.zeros(3, np.float32)} for k in (2, 4)}
    for it in items:
        it["radius"] = np.float32(4.4)
    ds = MemoryStream(items, tg, refine)
    torch.manual_seed(0)
    model = AGMNet(local_ray=True, **TINY)
    settings = RasterSettings(image_height=OUT_HW[0], image_width=OUT_HW[1],
                              max_pairs=1 << 14)
    pipe = StreamingPipeline(model, ds, StreamConfig(
        workspace=str(tmp_path), **CFG), REFINE, settings, device="cpu")
    return pipe, ds


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """The tiny stream run once under a CPU profiler: (dataset, its
    ``igs:`` function events, the counters)."""
    pipe, ds = _stream(tmp_path_factory.mktemp("traced"))
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipe.run()
    events = [e for e in prof.events() if e.name.startswith("igs:")]
    counters = profiling.counters()
    profiling.reset_counters()
    return ds, events, counters


def _igs_parent(event):
    p = event.cpu_parent
    while p is not None and not p.name.startswith("igs:"):
        p = p.cpu_parent
    return "" if p is None else p.name[len("igs:"):]


def test_span_and_count_build_nothing_without_a_profiler(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("record_function built with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    profiling.reset_counters()
    with profiling.span("stream.window"):
        profiling.count("stream.h2d_bytes", 8)
        profiling.count("raster.pairs_blended.fwd", torch.ones(3))
    assert profiling.counters() == {}


def test_stream_run_emits_the_span_tree(traced):
    _, events, _ = traced
    parents = {}
    for e in events:
        parents.setdefault(e.name[len("igs:"):], set()).add(_igs_parent(e))
    assert parents == {k: {v} for k, v in TREE.items()}
    n = {k: sum(e.name == f"igs:{k}" for e in events) for k in TREE}
    assert n["stream.window"] == 2 and n["stream.probe"] == 1
    assert n["refine"] == 2 and n["refine.step"] == 6
    assert n["refine.densify"] == 2 and n["agm.render"] == 2


def test_h2d_bytes_are_the_arrays_the_run_copies(traced):
    """Every window's numpy batch and its anchor box; window 0's depth and
    the probe's background; each key frame's refine views and background
    and the re-render's background."""
    ds, _, counters = traced
    want = 0
    for w in range(2):
        batch = ds.collate(ds.items[2 * w: 2 * w + 2])
        want += sum(v.nbytes for v in batch.values()
                    if isinstance(v, np.ndarray))
        want += batch["bounding_box"][0].nbytes
        if w == 0:
            want += batch["depth"].nbytes + batch[
                "background_color"][0].nbytes
        r = ds.get_refine_data(2 * w + 2)
        want += np.stack(r["images"]).nbytes + r["bg"].nbytes
        want += batch["background_color"][0].nbytes
    assert counters["stream.h2d_bytes"] == want


def test_pairs_blended_are_the_pairs_of_one_refine_step():
    """One refine step blends its view's pairs once forward and once
    backward."""
    tg = to_torch_gaussians(random_gaussians(n=256, seed=3).pad_to(320))
    it = stream_items(n_items=1, out_hw=OUT_HW)[0]
    cam = Camera.from_c2w(it["c2w_input"][0], tuple(it["FOV"]), OUT_HW,
                          device="cpu")
    settings = RasterSettings(image_height=OUT_HW[0], image_width=OUT_HW[1],
                              max_pairs=1 << 14, outputs="color")
    state = init_refine_state(tg, capacity=320)
    gt = torch.rand((3,) + OUT_HW, generator=torch.Generator().manual_seed(1))
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        refine_step(state, cam, gt, torch.zeros(3), REFINE, settings)
    counters = profiling.counters()
    profiling.reset_counters()
    g = state.gaussians
    pairs = build_pairs_packed(g.get_xyz, g.get_opacity, g.get_scaling,
                               g.get_rotation, cam, valid=g.valid,
                               settings=settings)
    want = int(pairs.num_pairs.sum())
    assert want > 0
    assert counters == {"raster.pairs_blended.fwd": want,
                        "raster.pairs_blended.bwd": want}


class _Renders(torch.nn.Module):
    """A stand-in for AGM-Net in the train step: one parameter times a
    fixed image."""

    def __init__(self):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.ones(()))

    def forward(self, batch, anchor_state, gaussians, settings):
        img = batch["base"] * self.scale
        return {"images_pred": img,
                "overflow_tiles": torch.zeros(1, dtype=torch.int32)}


def test_train_step_emits_its_four_spans():
    model = _Renders()
    cfg = OptConfig()
    optimizer, _ = make_optimizer(model, cfg, total_steps=10)
    step = make_train_step(cfg, RasterSettings(image_height=16,
                                               image_width=16))
    gen = torch.Generator().manual_seed(2)
    batch = {"base": torch.rand(1, 2, 3, 16, 16, generator=gen),
             "images_output": torch.rand(1, 2, 3, 16, 16, generator=gen)}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(model, optimizer, batch, None, None)
    names = [e.name for e in prof.events() if e.name.startswith("igs:")]
    assert names == ["igs:train.forward", "igs:train.loss",
                     "igs:train.backward", "igs:optim"]


def test_run_calls_the_names_the_benchmark_rebinds(tmp_path, monkeypatch):
    """``run`` reaches ``select_anchors`` and ``refine_run`` through the
    pipeline module's globals, and calls ``pipe.model`` (a plain function
    once wrapped) for the forward only."""
    pipe, _ = _stream(tmp_path)
    calls = {"select_anchors": 0, "refine_run": 0, "model": 0}

    def counted(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    for name in ("select_anchors", "refine_run"):
        monkeypatch.setattr(pipeline_mod, name,
                            counted(name, getattr(pipeline_mod, name)))
    pipe.model = counted("model", pipe.model)
    pipe.run()
    assert calls == {"select_anchors": 2, "refine_run": 2, "model": 2}
