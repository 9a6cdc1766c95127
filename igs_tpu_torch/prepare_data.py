"""Data-prep toolbox — the script/ directory equivalents: the port's
counterpart of the repo-root ``prepare_data.py``, with the same
subcommands, flags, defaults, outputs and printed lines.

The JAX program resizes with PIL and undistorts with OpenCV; the port
needs neither: ``subsample`` resizes through ``data/resize.py`` (PIL's
bilinear arithmetic, bit for bit) and writes PNGs through the port's
codec and JPEGs through ``data/jpeg.encode_jpeg`` at PIL's defaults
(quality 75, 4:2:0: PIL's bytes); ``panoptic`` undistorts through
``data/undistort.py`` (OpenCV's arithmetic). ``colmap`` and ``ffmpeg``
stay external programs, run as the JAX program runs them: a missing or
failing one fails the command.

Reference parity (SURVEY.md §2.2 script/ tools):
  * ``cameras``  — colmap sparse → cameras.json (my_copy_cams / scene/)
  * ``aabb``     — points3D percentile bbox → bbox.json (compute_aabb.py)
  * ``subsample``— 512² image resize into images_512/ (subsample.py, with a
                   process pool like the reference's mp.Pool(5))
  * ``pairs``    — key/candidate pair json generation
                   (generate_test_pair.ipynb / generate_train_pair.ipynb)
  * ``points``   — points3D.bin → points3D.npz for the frame-0 trainer
  * ``extract-frames`` — video → per-frame PNGs via ffmpeg + per-frame
                   colmap_N/input dirs (script/pre_input.py)
  * ``panoptic`` — Panoptic Sports calibration → undistorted images +
                   known-pose colmap db + triangulation (script/
                   process_panoptic.py); needs the colmap binary on PATH

Usage examples:
    python -m igs_tpu_torch.prepare_data cameras \
        --sparse scene/colmap_0/sparse/0 \
        --out scene/colmap_0/3dgs_rade/cameras.json
    python -m igs_tpu_torch.prepare_data aabb \
        --sparse scene/colmap_0/sparse/0 --scene-name sear_steak \
        --out data_root/bbox.json
    python -m igs_tpu_torch.prepare_data subsample \
        --src scene/colmap_0/images --dst scene/colmap_0/images_512 \
        --size 512
    python -m igs_tpu_torch.prepare_data pairs --scene-name sear_steak \
        --frames 300 --interval 5 \
        --out sear_steak_total_300_interval_5.json
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def cmd_cameras(args):
    from igs_tpu_torch.data.colmap import colmap_to_cameras_json

    cams = colmap_to_cameras_json(args.sparse, downscale=args.downscale)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(cams, f)
    print(f"wrote {len(cams)} cameras → {args.out}")


def cmd_aabb(args):
    from igs_tpu_torch.data.colmap import compute_aabb, read_points3d_bin

    xyz, _ = read_points3d_bin(os.path.join(args.sparse, "points3D.bin"))
    bbox = compute_aabb(xyz, padding=args.padding)
    existing = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            existing = json.load(f)
    existing[args.scene_name] = bbox
    with open(args.out, "w") as f:
        json.dump(existing, f, indent=2)
    print(f"{args.scene_name}: bbox {bbox}")


def cmd_points(args):
    from igs_tpu_torch.data.colmap import read_points3d_bin

    xyz, rgb = read_points3d_bin(os.path.join(args.sparse, "points3D.bin"))
    np.savez(args.out, xyz=xyz.astype(np.float32), rgb=rgb)
    print(f"wrote {len(xyz)} points → {args.out}")


def _resize_one(job):
    src, dst, size = job
    from igs_tpu_torch.data.images import read_image_as, write_png
    from igs_tpu_torch.data.jpeg import encode_jpeg
    from igs_tpu_torch.data.resize import resize_bilinear

    img = resize_bilinear(read_image_as(src, "RGB"), size, size)
    # the file type follows the suffix, as PIL's save(dst) picks it
    if dst.lower().endswith(".png"):
        write_png(dst, np.ascontiguousarray(img))
    else:
        with open(dst, "wb") as f:
            f.write(encode_jpeg(np.ascontiguousarray(img), quality=75))


def cmd_subsample(args):
    import multiprocessing as mp

    os.makedirs(args.dst, exist_ok=True)
    jobs = [
        (os.path.join(args.src, f), os.path.join(args.dst, f), args.size)
        for f in sorted(os.listdir(args.src))
        if f.lower().endswith((".png", ".jpg", ".jpeg"))
    ]
    # spawned workers: the parent may hold threads (torch's pools)
    with mp.get_context("spawn").Pool(args.workers) as pool:
        pool.map(_resize_one, jobs)
    print(f"resized {len(jobs)} images → {args.dst}")


def cmd_pairs(args):
    """Every interval-th frame is a key frame; each item pairs the key
    frame with the next candidate frame (generate_test_pair.ipynb)."""
    items = []
    for f in range(args.start, args.frames - 1):
        key = (f // args.interval) * args.interval
        items.append({
            "scene_name": args.scene_name,
            "cur_frame": f"colmap_{key}",
            "next_frame": f"colmap_{f + 1}",
            "keyframe": 1 if f % args.interval == 0 else 0,
        })
    split = {"train": items, "val": items}
    with open(args.out, "w") as f:
        json.dump(split, f, indent=1)
    print(f"wrote {len(items)} pairs → {args.out}")


def cmd_extract_frames(args):
    """Video frame extraction + colmap input prep (script/pre_input.py).

    Each <cam>.mp4 in --src becomes <cam>/N.png for N in [0, end-start);
    then colmap_N/input/<cam>.png per frame offset.
    """
    import glob
    import shutil
    import subprocess

    src = args.src.rstrip("/")
    videos = sorted(glob.glob(os.path.join(src, "*.mp4")))
    for v in videos:
        outdir = v[:-4]
        os.makedirs(outdir, exist_ok=True)
        have_all = all(
            os.path.exists(os.path.join(outdir, f"{i}.png"))
            for i in range(args.end - args.start))
        if have_all:
            continue
        cmd = (
            f"ffmpeg -i {v} -vf \"select='between(n,{args.start},"
            f"{args.end - 1})',setpts=PTS-STARTPTS\" -vsync vfr "
            f"-start_number 0 {outdir}/%d.png")
        print("running:", cmd)
        subprocess.run(cmd, shell=True, check=True)
    cam_dirs = sorted(
        d for d in glob.glob(os.path.join(src, "*"))
        if os.path.isdir(d) and not os.path.basename(d).startswith("colmap"))
    for off in range(args.end - args.start):
        dst = os.path.join(src, f"colmap_{off}", "input")
        os.makedirs(dst, exist_ok=True)
        for d in cam_dirs:
            f = os.path.join(d, f"{off}.png")
            if os.path.exists(f):
                shutil.copy(f, os.path.join(
                    dst, os.path.basename(d) + ".png"))
    print(f"prepared {args.end - args.start} colmap_N/input dirs")


def cmd_panoptic(args):
    """Panoptic Sports → colmap scenes (script/process_panoptic.py).

    Undistorts the hd cameras with OpenCV's arithmetic (principal point
    recentred; ``data/undistort.py``),
    seeds input.db + the manual text model with the calibrated poses, then
    runs colmap feature_extractor/exhaustive_matcher/point_triangulator.
    """
    import glob
    import shutil
    import subprocess

    from igs_tpu_torch.data.colmap_db import (
        rotmat2qvec, seed_known_poses_db, write_manual_model)
    from igs_tpu_torch.data.undistort import (
        imread_bgr, imwrite_bgr, init_undistort_rectify_map,
        optimal_new_camera_matrix, remap_linear)

    calib = glob.glob(os.path.join(args.src, "calibration*.json"))
    assert calib, f"no calibration*.json in {args.src}"
    with open(calib[0]) as f:
        data = json.load(f)
    hd = sorted((c for c in data["cameras"] if c.get("type") == "hd"),
                key=lambda c: c["name"])
    fw, fh = args.width, args.height

    for off in range(args.start, args.end):
        proj = os.path.join(args.src, f"colmap_{off}")
        raw = os.path.join(proj, "input_distorted")
        if os.path.exists(os.path.join(proj, "input")):
            os.rename(os.path.join(proj, "input"), raw)
        imgdir = os.path.join(proj, "images")
        os.makedirs(imgdir, exist_ok=True)

        cams, imgs = [], []
        for i, cam in enumerate(hd):
            k = np.array(cam["K"], float)
            dist = np.array(cam["distCoef"], float).flatten()
            w0, h0 = cam["resolution"]
            name = f"hd_{cam['name']}.png"
            path = os.path.join(raw, name)
            if not os.path.exists(path):
                continue
            img = imread_bgr(path)
            new_k, roi = optimal_new_camera_matrix(
                k, dist, (w0, h0), alpha=0)
            x, y, w, h = roi
            if w <= 0 or h <= 0:
                continue
            # principal point recentred, scaled to the target resolution
            w = int(min(new_k[0, 2], w - new_k[0, 2]) * 2)
            h = int(min(new_k[1, 2], h - new_k[1, 2]) * 2)
            ws, hs = fw / w, fh / h
            tk = np.array([
                [ws * new_k[0, 0], 0, fw / 2.0],
                [0, hs * new_k[1, 1], fh / 2.0],
                [0, 0, 1.0],
            ])
            m1, m2 = init_undistort_rectify_map(k, dist, None, tk, (fw, fh))
            und = remap_linear(img, m1, m2)
            imwrite_bgr(os.path.join(imgdir, name), und)

            cid = len(cams) + 1
            qvec = rotmat2qvec(np.array(cam["R"], float))
            tvec = np.array(cam["t"], float).flatten()
            params = [tk[0, 0], tk[1, 1], tk[0, 2], tk[1, 2]]
            cams.append({"camera_id": cid, "model": "PINHOLE",
                         "width": fw, "height": fh, "params": params})
            imgs.append({"image_id": cid, "camera_id": cid, "name": name,
                         "qvec": qvec, "tvec": tvec})

        seed_known_poses_db(os.path.join(proj, "input.db"), cams, imgs)
        write_manual_model(os.path.join(proj, "manual"), cams, imgs)

        sparse = os.path.join(proj, "distorted", "sparse")
        os.makedirs(sparse, exist_ok=True)
        db = os.path.join(proj, "input.db")
        for cmd in (
            f"colmap feature_extractor --database_path {db} "
            f"--image_path {imgdir}",
            f"colmap exhaustive_matcher --database_path {db}",
            f"colmap point_triangulator --database_path {db} "
            f"--image_path {imgdir} --output_path {sparse} "
            f"--input_path {os.path.join(proj, 'manual')}",
        ):
            print("running:", cmd)
            subprocess.run(cmd, shell=True, check=True)
        final = os.path.join(proj, "sparse", "0")
        os.makedirs(final, exist_ok=True)
        for fn in ("cameras.bin", "images.bin", "points3D.bin"):
            srcf = os.path.join(sparse, fn)
            if os.path.exists(srcf):
                shutil.move(srcf, os.path.join(final, fn))
        print(f"colmap_{off} done")


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("cameras")
    c.add_argument("--sparse", required=True)
    c.add_argument("--out", required=True)
    c.add_argument("--downscale", type=int, default=1)
    c.set_defaults(fn=cmd_cameras)

    a = sub.add_parser("aabb")
    a.add_argument("--sparse", required=True)
    a.add_argument("--scene-name", required=True)
    a.add_argument("--out", required=True)
    a.add_argument("--padding", type=float, default=0.1)
    a.set_defaults(fn=cmd_aabb)

    p = sub.add_parser("points")
    p.add_argument("--sparse", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_points)

    s = sub.add_parser("subsample")
    s.add_argument("--src", required=True)
    s.add_argument("--dst", required=True)
    s.add_argument("--size", type=int, default=512)
    s.add_argument("--workers", type=int, default=5)
    s.set_defaults(fn=cmd_subsample)

    g = sub.add_parser("pairs")
    g.add_argument("--scene-name", required=True)
    g.add_argument("--frames", type=int, required=True)
    g.add_argument("--interval", type=int, default=5)
    g.add_argument("--start", type=int, default=0)
    g.add_argument("--out", required=True)
    g.set_defaults(fn=cmd_pairs)

    e = sub.add_parser("extract-frames")
    e.add_argument("--src", required=True, help="dir of per-camera .mp4s")
    e.add_argument("--start", type=int, default=0)
    e.add_argument("--end", type=int, default=300)
    e.set_defaults(fn=cmd_extract_frames)

    pn = sub.add_parser("panoptic")
    pn.add_argument("--src", required=True, help="Panoptic scene dir")
    pn.add_argument("--start", type=int, default=0)
    pn.add_argument("--end", type=int, default=60)
    pn.add_argument("--width", type=int, default=1920)
    pn.add_argument("--height", type=int, default=1080)
    pn.set_defaults(fn=cmd_panoptic)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
