"""``python -m igs_tpu_torch.prepare_data`` against the repo-root
``prepare_data.py`` (the JAX package's, with PIL and OpenCV): every
subcommand of both CLIs on the same seeded inputs, every output compared.

* ``cameras``, ``aabb``, ``points``, ``pairs``: equal JSON text and npz
  arrays, the same printed line.
* ``subsample``: PNG outputs' pixels equal (PIL's bilinear resize, bit
  for bit), JPEG outputs byte-equal to PIL's ``save`` at its defaults.
* ``extract-frames`` and ``panoptic``: stub ``ffmpeg``/``colmap``
  programs on ``PATH`` record their command lines and write fixed
  outputs; both CLIs record the same commands (up to the scene's root)
  and leave the same files: undistorted pixels equal to OpenCV's, equal
  database rows, the same manual model.
* A missing ``ffmpeg`` or ``colmap`` fails both.

The JAX CLI runs as a subprocess, the port's through ``main(argv)``
(its ``subsample`` pool spawns workers)."""

import json
import os
import shutil
import sqlite3
import stat
import subprocess
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

from igs_tpu_torch import prepare_data as port_cli
from tests.test_torch_port_colmap import write_sparse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYSTEM_PATH = "/usr/bin:/bin"

STUB = r'''#!{python}
"""Stand-in for {name}: records its arguments, writes fixed outputs."""
import os, re, sys
import numpy as np
sys.path.insert(0, {root!r})
from igs_tpu_torch.data.images import write_png
with open(os.environ["STUB_LOG"], "a") as f:
    f.write({name!r} + " " + " ".join(sys.argv[1:]) + "\n")
args = sys.argv[1:]
if {name!r} == "ffmpeg":
    a, b = map(int, re.search(r"between\(n,(\d+),(\d+)\)", " ".join(args))
               .groups())
    pattern = args[-1]
    seed = sum(map(ord, args[args.index("-i") + 1].split("/")[-1]))
    rng = np.random.RandomState(seed)
    for i in range(b - a + 1):
        write_png(pattern.replace("%d", str(i)),
                  rng.randint(0, 256, (6, 8, 3)).astype(np.uint8))
elif "--output_path" in args:
    out = args[args.index("--output_path") + 1]
    for fn in ("cameras.bin", "images.bin", "points3D.bin"):
        with open(os.path.join(out, fn), "wb") as f:
            f.write(fn.encode())
'''


def stub_dir(tmp_path):
    d = tmp_path / "stubs"
    d.mkdir(exist_ok=True)
    for name in ("ffmpeg", "colmap"):
        p = d / name
        p.write_text(STUB.format(python=sys.executable, name=name, root=ROOT))
        p.chmod(p.stat().st_mode | stat.S_IEXEC)
    return str(d)


def run_jax(args, env=None, check=True):
    r = subprocess.run([sys.executable, os.path.join(ROOT, "prepare_data.py"),
                        *args], capture_output=True, text=True, cwd=ROOT,
                       env=env)
    if check:
        assert r.returncode == 0, r.stderr
    return r


def run_port(args, capsys):
    port_cli.main(args)
    return capsys.readouterr().out


def test_cameras_aabb_points_pairs(tmp_path, capsys):
    sparse = str(tmp_path / "sparse")
    write_sparse(sparse, np.random.RandomState(0), model="PINHOLE")
    for side in ("jax", "port"):
        os.makedirs(tmp_path / side)
    outs = {}
    for side in ("jax", "port"):
        o = tmp_path / side
        cmds = [["cameras", "--sparse", sparse, "--out",
                 str(o / "3dgs_rade" / "cameras.json"), "--downscale", "2"],
                ["cameras", "--sparse", sparse, "--out", str(o / "c1.json")],
                ["aabb", "--sparse", sparse, "--scene-name", "a",
                 "--out", str(o / "bbox.json")],
                ["aabb", "--sparse", sparse, "--scene-name", "b",
                 "--padding", "0.3", "--out", str(o / "bbox.json")],
                ["points", "--sparse", sparse, "--out",
                 str(o / "points3D.npz")],
                ["pairs", "--scene-name", "s", "--frames", "13",
                 "--interval", "5", "--start", "1", "--out",
                 str(o / "pairs.json")]]
        printed = []
        for c in cmds:
            printed.append(run_jax(c).stdout if side == "jax"
                           else run_port(c, capsys))
        outs[side] = [p.replace(str(o), "<out>") for p in printed]
    assert outs["port"] == outs["jax"]
    for f in ("3dgs_rade/cameras.json", "c1.json", "bbox.json", "pairs.json"):
        assert (tmp_path / "port" / f).read_text() == (
            tmp_path / "jax" / f).read_text(), f
    want = np.load(tmp_path / "jax" / "points3D.npz")
    got = np.load(tmp_path / "port" / "points3D.npz")
    assert sorted(got.files) == sorted(want.files) == ["rgb", "xyz"]
    for k in want.files:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_subsample(tmp_path, capsys):
    rng = np.random.RandomState(1)
    src = tmp_path / "src"
    src.mkdir()
    Image.fromarray(rng.randint(0, 256, (101, 135, 3)).astype(np.uint8)
                    ).save(src / "a.png")
    Image.fromarray(rng.randint(0, 256, (64, 48, 4)).astype(np.uint8)
                    ).save(src / "b.png")
    Image.fromarray(rng.randint(0, 256, (50, 70)).astype(np.uint8)
                    ).save(src / "c.PNG")
    smooth = np.clip(np.add.outer(np.arange(90), np.arange(120))[:, :, None]
                     + rng.randint(0, 40, (90, 120, 3)), 0, 255)
    Image.fromarray(smooth.astype(np.uint8)).save(src / "d.jpg", quality=90)
    Image.fromarray(rng.randint(0, 256, (33, 47, 3)).astype(np.uint8)
                    ).save(src / "e.jpeg", quality=80)
    (src / "notes.txt").write_text("skipped")
    args = ["subsample", "--src", str(src), "--size", "37", "--workers", "2"]
    r = run_jax(args + ["--dst", str(tmp_path / "jax")])
    out = run_port(args + ["--dst", str(tmp_path / "port")], capsys)
    assert out.replace("port", "X") == r.stdout.replace("jax", "X")
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        "a.png", "b.png", "c.PNG", "d.jpg", "e.jpeg"]
    for n in names:
        j, p = tmp_path / "jax" / n, tmp_path / "port" / n
        if n.lower().endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(p)),
                                          np.asarray(Image.open(j)))
            assert Image.open(p).size == (37, 37)
        else:
            assert p.read_bytes() == j.read_bytes(), n


def _videos(src):
    os.makedirs(src)
    for cam in ("cam00", "cam01", "cam02"):
        (src / f"{cam}.mp4").write_bytes(b"not a video")


def walk(tmp_path, side):
    return sorted(os.path.relpath(os.path.join(d, f), tmp_path / side)
                  for d, _, fs in os.walk(tmp_path / side) for f in fs)


def _log(path):
    return [line.split() for line in open(path).read().splitlines()]


def test_extract_frames(tmp_path, capsys, monkeypatch):
    stubs = stub_dir(tmp_path)
    for side in ("jax", "port"):
        src = tmp_path / side / "scene"
        _videos(src)
        log = tmp_path / f"{side}.log"
        env = dict(os.environ, PATH=f"{stubs}:{SYSTEM_PATH}",
                   STUB_LOG=str(log))
        args = ["extract-frames", "--src", str(src) + "/", "--start", "2",
                "--end", "5"]
        if side == "jax":
            out = run_jax(args, env=env).stdout
        else:
            monkeypatch.setenv("PATH", env["PATH"])
            monkeypatch.setenv("STUB_LOG", str(log))
            out = run_port(args, capsys)
        assert "prepared 3 colmap_N/input dirs" in out
    norm = lambda side: [[w.replace(str(tmp_path / side), "<root>")
                          for w in line] for line in _log(
        tmp_path / f"{side}.log")]
    assert norm("port") == norm("jax")
    assert len(norm("port")) == 3
    want = walk(tmp_path, "jax")
    assert walk(tmp_path, "port") == want
    for f in want:
        if f.endswith(".png"):
            assert (tmp_path / "port" / f).read_bytes() == (
                tmp_path / "jax" / f).read_bytes(), f
    assert "scene/colmap_2/input/cam01.png" in want


def _panoptic_scene(src, rng, n_cams=3):
    cams = []
    for i in range(n_cams):
        w, h = 96, 64
        f = rng.uniform(70, 80)
        k = [[f, 0, w / 2 + rng.uniform(-2, 2)],
             [0, f * 1.01, h / 2 + rng.uniform(-2, 2)], [0, 0, 1]]
        u, _, vt = np.linalg.svd(rng.normal(size=(3, 3)))
        r = u @ vt * np.sign(np.linalg.det(u @ vt))
        cams.append({"name": f"00_{i:02d}", "type": "hd", "resolution":
                     [w, h], "K": k,
                     "distCoef": [-0.25 + 0.05 * i, 0.1, 0.001, -0.0005,
                                  -0.02],
                     "R": r.tolist(), "t": rng.normal(size=(3, 1)).tolist()})
    cams.append(dict(cams[0], name="00_00", type="vga"))
    os.makedirs(src)
    with open(src / "calibration_x.json", "w") as f:
        json.dump({"cameras": cams}, f)
    for off in (0, 1):
        inp = src / f"colmap_{off}" / "input"
        os.makedirs(inp)
        for c in cams[:n_cams]:
            if off == 1 and c["name"] == "00_02":
                continue  # a missing view is skipped
            img = rng.randint(0, 256, (64, 96, 3)).astype(np.uint8)
            cv2.imwrite(str(inp / f"hd_{c['name']}.png"), img)


def _rows(db):
    conn = sqlite3.connect(db)
    try:
        return {t: conn.execute(f"SELECT * FROM {t} ORDER BY 1").fetchall()
                for t in ("cameras", "images")}
    finally:
        conn.close()


def test_panoptic(tmp_path, capsys, monkeypatch):
    stubs = stub_dir(tmp_path)
    for side in ("jax", "port"):
        src = tmp_path / side / "scene"
        _panoptic_scene(src, np.random.RandomState(2))
        log = tmp_path / f"{side}.log"
        env = dict(os.environ, PATH=f"{stubs}:{SYSTEM_PATH}",
                   STUB_LOG=str(log))
        args = ["panoptic", "--src", str(src), "--start", "0", "--end", "2",
                "--width", "80", "--height", "48"]
        if side == "jax":
            out = run_jax(args, env=env).stdout
        else:
            monkeypatch.setenv("PATH", env["PATH"])
            monkeypatch.setenv("STUB_LOG", str(log))
            out = run_port(args, capsys)
        assert out.count(" done") == 2
    norm = lambda side: [[w.replace(str(tmp_path / side), "<root>")
                          for w in line] for line in _log(
        tmp_path / f"{side}.log")]
    assert norm("port") == norm("jax")
    assert [line[:2] for line in norm("port")] == [
        ["colmap", "feature_extractor"], ["colmap", "exhaustive_matcher"],
        ["colmap", "point_triangulator"]] * 2
    assert walk(tmp_path, "port") == walk(tmp_path, "jax")
    for f in walk(tmp_path, "jax"):
        j, p = tmp_path / "jax" / f, tmp_path / "port" / f
        if "/images/" in f:
            und = cv2.imread(str(p))
            assert und.shape == (48, 80, 3)
            np.testing.assert_array_equal(und, cv2.imread(str(j)))
        elif f.endswith(".db"):
            assert _rows(p) == _rows(j)
            assert len(_rows(p)["images"]) == (3 if "colmap_0" in f else 2)
        elif not f.endswith(".png"):
            assert p.read_bytes() == j.read_bytes(), f
    assert "scene/colmap_0/sparse/0/points3D.bin" in walk(tmp_path, "port")
    assert "scene/colmap_1/input_distorted/hd_00_01.png" in walk(tmp_path,
                                                                 "port")


@pytest.mark.parametrize("cmd", ["extract-frames", "panoptic"])
def test_missing_binary_fails_both(tmp_path, monkeypatch, cmd):
    assert shutil.which("ffmpeg", path=SYSTEM_PATH) is None
    assert shutil.which("colmap", path=SYSTEM_PATH) is None
    rng = np.random.RandomState(3)
    for side in ("jax", "port"):
        src = tmp_path / side / "scene"
        if cmd == "extract-frames":
            _videos(src)
            args = [cmd, "--src", str(src), "--end", "2"]
        else:
            _panoptic_scene(src, rng, n_cams=1)
            args = [cmd, "--src", str(src), "--end", "1", "--width", "80",
                    "--height", "48"]
        if side == "jax":
            r = run_jax(args, env=dict(os.environ, PATH=SYSTEM_PATH),
                        check=False)
            assert r.returncode != 0 and "CalledProcessError" in r.stderr
        else:
            monkeypatch.setenv("PATH", SYSTEM_PATH)
            with pytest.raises(subprocess.CalledProcessError):
                port_cli.main(args)
