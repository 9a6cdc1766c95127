"""``free_view`` against the JAX pipeline's, and the two writers it needs
on a machine without PIL and imageio: the baseline JPEG encoder
(``data/jpeg.py``) against PIL, and the MJPEG-in-AVI writer
(``utils/saving.save_video``) against the JAX package's.

Both pipelines stream two windows (B=2) of the same in-memory stream
with the same weights, each on its own packed route (the JAX kernels in
interpret mode), with ``free_view`` on. The residual heads keep their
zero init (the JAX ``AGMNet.init`` and the port's ``ResidualDecoder``
both start there), so the deformed positions are the same bits in both
packages and the PLYs must be byte-equal in every column but the
rotation, where XLA's fused multiply-adds in the quaternion product move
some rows by a unit in the last place of its terms (the random heads of
the parity tests move every column by float32 rounding, which the PSNR
tests bound); the two writers are byte-equal on the same Gaussians. The
spiral renders are held to JAX's uint8 pixels within ±1 level on at most
1 % of the values (a blend reassociation can cross a rounding boundary;
measured: one value of the four frames' 23 040). The JPEG encoder writes
PIL's bytes (quality 92 and others; odd sizes and partial MCUs), so the
AVIs must have JAX's chunks and header fields, all but the three that
depend on the JPEG sizes (they came out byte-equal here).
"""

import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

from igs_tpu.ops.rasterize import RasterSettings as JSettings
from igs_tpu.stream.pipeline import StreamConfig as JStreamConfig
from igs_tpu.stream.pipeline import StreamingPipeline as JPipeline
from igs_tpu.stream.refine import RefineConfig as JRefineConfig
from igs_tpu.utils.saving import save_video as jax_save_video
from igs_tpu_torch.data import jpeg
from igs_tpu_torch.data.images import read_png
from igs_tpu_torch.data.ply import read_ply_vertices
from igs_tpu_torch.ops.rasterize import RasterSettings
from igs_tpu_torch.stream.pipeline import StreamConfig, StreamingPipeline
from igs_tpu_torch.stream.refine import RefineConfig
from igs_tpu_torch.utils.saving import avi_chunks, save_video
from tests.torch_port_common import (
    MemoryStream, flax_params, port_model, stream_items, to_torch_gaussians)

torch.set_num_threads(2)

OUT_HW = (40, 48)
BASE = dict(eval_batch_size=2, refine_gs=False, max_num=320, anchor_size=32,
            neighbor_k=4, save_images=False, depth_view_res=16,
            free_view=True)


def _pil_jpeg(img, quality):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _image(h, w, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 90 * np.sin(xx / 5.0 + c) * np.cos(yy / 7.0)
                    for c in range(3)], -1)
    return np.clip(img + rng.normal(0, 20, img.shape), 0, 255).astype(
        np.uint8)


# -- the JPEG encoder ---------------------------------------------------------

@pytest.mark.parametrize("h,w", [(37, 53), (16, 16), (40, 8), (1, 1),
                                 (9, 130), (64, 48)])
def test_jpeg_headers_and_pixels_match_pil(h, w):
    """Quality 92 (the video's): DQT, SOF0 and DHT byte-equal to PIL's;
    PIL's decodes of the two files within mean 0.5 and max 8 levels (they
    are equal: the whole file is PIL's bytes)."""
    img = _image(h, w, seed=h * 1000 + w)
    want = _pil_jpeg(img, 92)
    got = jpeg.encode_jpeg(img, 92)
    ws, gs = jpeg.segments(want), jpeg.segments(got)
    for marker in (0xDB, 0xC0, 0xC4):
        assert gs[marker] == ws[marker], hex(marker)
    assert len(gs[0xDB]) == 2 and len(gs[0xC4]) == 4
    a = np.asarray(Image.open(io.BytesIO(want))).astype(int)
    b = np.asarray(Image.open(io.BytesIO(got))).astype(int)
    d = np.abs(a - b)
    assert d.mean() <= 0.5 and d.max() <= 8
    assert got == want


@pytest.mark.parametrize("quality", [10, 49, 50, 75, 95, 100])
def test_jpeg_quality_scaling_matches_pil(quality):
    img = _image(37, 53, seed=quality)
    assert jpeg.encode_jpeg(img, quality) == _pil_jpeg(img, quality)


def test_jpeg_refuses_other_layouts():
    with pytest.raises(ValueError):
        jpeg.encode_jpeg(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError):
        jpeg.encode_jpeg(np.zeros((4, 4, 3), np.float32))


# -- the video ----------------------------------------------------------------

AVI_PAYLOAD_FIELDS = {  # (chunk, byte offsets of the fields that depend
    # on the JPEG payloads: max bytes/s and the largest frame)
    b"avih": {(4, 8), (28, 32)}, b"strh": {(36, 40)}}


def _same_layout(a: bytes, b: bytes) -> None:
    """The chunk sequence and every header field but those that depend on
    the JPEG sizes are equal; each 00dc chunk is one whole JPEG."""
    ca, cb = avi_chunks(a), avi_chunks(b)
    assert [c for c, _ in ca] == [c for c, _ in cb]
    for (fourcc, pa), (_, pb) in zip(ca, cb):
        if fourcc in AVI_PAYLOAD_FIELDS:
            keep = np.ones(len(pa), bool)
            for lo, hi in AVI_PAYLOAD_FIELDS[fourcc]:
                keep[lo:hi] = False
            assert np.array_equal(np.frombuffer(pa, np.uint8)[keep],
                                  np.frombuffer(pb, np.uint8)[keep]), fourcc
        elif fourcc == b"strf":
            assert pa == pb
        elif fourcc == b"00dc":
            assert pb[:2] == b"\xff\xd8" and pb[-2:] == b"\xff\xd9"


def test_avi_matches_jax(tmp_path):
    """A ``.mp4`` request writes ``<stem>.avi`` in both packages (the JAX
    one without an ffmpeg backend): the same layout, and here the same
    bytes."""
    frames = [_image(37, 53, seed=s) for s in range(3)]
    frames.append(np.zeros((37, 53, 3), np.float32) + 0.5)  # float frame
    want = jax_save_video(str(tmp_path / "jax" / "v.mp4"), frames, fps=30)
    timings = []
    got = save_video(str(tmp_path / "port" / "v.mp4"), frames, fps=30,
                     timings=timings)
    assert got.endswith("v.avi") and want.endswith("v.avi")
    assert len(timings) == 4
    a, b = open(want, "rb").read(), open(got, "rb").read()
    _same_layout(a, b)
    assert a == b
    assert [c for c, _ in avi_chunks(b)].count(b"00dc") == 4


def test_gif_is_refused(tmp_path):
    with pytest.raises(NotImplementedError, match="gif"):
        save_video(str(tmp_path / "v.gif"), [np.zeros((8, 8, 3), np.uint8)])


# -- the stream ---------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("free_view")
    jmodel, params, g = flax_params()
    for head in ("head_xyz", "head_rotation"):  # the init's zero heads
        params["params"]["render"][head]["kernel"] = (
            params["params"]["render"][head]["kernel"] * 0)
    tg = to_torch_gaussians(g)
    items = stream_items(n_items=4, out_hw=OUT_HW)
    js = JSettings(image_height=OUT_HW[0], image_width=OUT_HW[1],
                   impl="pallas_packed", pallas_interpret=True,
                   max_pairs=1 << 14)
    jcfg = JStreamConfig(exact_knn=True, workspace=str(root / "jax"), **BASE)
    want = JPipeline(jmodel, params, MemoryStream(items, g), jcfg,
                     JRefineConfig(), js).run(max_batches=2)
    cfg = StreamConfig(workspace=str(root / "port"), **BASE)
    ts = RasterSettings(image_height=OUT_HW[0], image_width=OUT_HW[1],
                        max_pairs=1 << 14)
    pipe = StreamingPipeline(port_model(params), MemoryStream(items, tg),
                             cfg, RefineConfig(), ts, device="cpu")
    got = pipe.run(max_batches=2)
    return root, want, got, pipe


def test_free_view_writes_what_jax_writes(runs):
    root, want, got, _ = runs
    for d in ("gs", "free_view"):
        assert sorted(os.listdir(root / "port" / d)) == sorted(
            os.listdir(root / "jax" / d))
    assert sorted(os.listdir(root / "port" / "gs")) == [
        f"{i}.ply" for i in range(4)]
    assert got["psnr"] == pytest.approx(want["psnr"], abs=0.01)


ROT = ("rot_0", "rot_1", "rot_2", "rot_3")


@pytest.mark.parametrize("frame", range(4))
def test_free_view_ply_is_byte_equal(runs, frame):
    """The same header, rows and bytes in every column but the rotation,
    whose quaternion product (the init's rotation bias times each
    Gaussian's rotation) XLA contracts into fused multiply-adds: there
    the two packages may differ by a unit in the last place of the
    product's terms, 2^-23 for a unit quaternion (measured: ≤ 6e-8, in
    8–14 % of the rows)."""
    root, _, got, _ = runs
    a = (root / "jax" / "gs" / f"{frame}.ply").read_bytes()
    b = (root / "port" / "gs" / f"{frame}.ply").read_bytes()
    assert len(a) == len(b)
    va, vb = read_ply_vertices(a), read_ply_vertices(b)
    assert a[:len(a) - va.nbytes] == b[:len(b) - vb.nbytes]  # the header
    assert len(vb) == got["points_num"][frame // 2] > 0
    for name in va.dtype.names:
        if name in ROT:
            assert np.abs(va[name] - vb[name]).max() <= 2.0 ** -23, name
        else:
            assert va[name].tobytes() == vb[name].tobytes(), name


def test_ply_writer_is_byte_equal(runs, tmp_path):
    """On the same Gaussians the port's writer and the JAX package's write
    the same bytes (the port's frame-3 Gaussians, read back from its PLY
    and written by both)."""
    from igs_tpu.data.ply import load_gaussian_ply as jax_load
    from igs_tpu.data.ply import save_gaussian_ply as jax_save
    from igs_tpu_torch.data.ply import load_gaussian_ply, save_gaussian_ply

    root = runs[0]
    src = str(root / "port" / "gs" / "3.ply")
    jax_save(str(tmp_path / "jax.ply"), jax_load(src))
    save_gaussian_ply(str(tmp_path / "port.ply"), load_gaussian_ply(src))
    a = (tmp_path / "jax.ply").read_bytes()
    assert a == (tmp_path / "port.ply").read_bytes()
    assert a == open(src, "rb").read()


@pytest.mark.parametrize("frame", range(4))
def test_free_view_png_matches_jax(runs, frame):
    root = runs[0]
    a = read_png(str(root / "jax" / "free_view" / f"{frame:05d}.png"))
    b = read_png(str(root / "port" / "free_view" / f"{frame:05d}.png"))
    assert a.shape == b.shape == OUT_HW + (3,) and b.dtype == np.uint8
    d = np.abs(a.astype(int) - b.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 0.01
    assert b.std() > 0  # the spiral view sees the Gaussians


def test_free_view_video_matches_jax(runs):
    root, _, _, pipe = runs
    a = (root / "jax" / "free_view.avi").read_bytes()
    b = (root / "port" / "free_view.avi").read_bytes()
    _same_layout(a, b)
    log = pipe.free_view_log
    assert log["video"] == str(root / "port" / "free_view.avi")
    assert [len(log[k]) for k in ("ply_s", "render_s", "png_s",
                                  "jpeg_s")] == [4] * 4
