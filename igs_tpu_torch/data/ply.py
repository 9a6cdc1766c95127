"""3DGS PLY reading and writing in numpy (counterpart of
``igs_tpu/data/ply.py``).

The reference layout (x, y, z, nx, ny, nz, f_dc_*, f_rest_0..44,
opacity, scale_*, rot_*), binary little-endian only. Loading fuses a
``filter_3D`` column, when the file has one, into scale and opacity.
Saving writes the same bytes as the JAX package for the same Gaussians;
like it, it writes no ``filter_3D`` column (ROADMAP C).
"""

from __future__ import annotations

import io

import numpy as np
import torch

from igs_tpu_torch.core.gaussians import (
    Gaussians, fuse_3d_filter, inverse_sigmoid)

_PLY_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "ushort": "<u2", "int": "<i4", "int32": "<i4",
    "uint": "<u4", "uint32": "<u4",
}


def read_ply_vertices(path_or_bytes) -> np.ndarray:
    """The vertex element of a binary little-endian PLY, as a structured
    array over the payload."""
    if isinstance(path_or_bytes, bytes):
        data = path_or_bytes
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    header_end = data.index(b"end_header\n") + len(b"end_header\n")
    lines = [ln.strip() for ln in data[:header_end].decode("ascii").splitlines()]
    if lines[0] != "ply":
        raise ValueError("not a PLY file")
    fmt = [ln for ln in lines if ln.startswith("format")][0].split()[1]
    if fmt != "binary_little_endian":
        raise ValueError(f"unsupported PLY format {fmt}")
    count, props, in_vertex = None, [], False
    for ln in lines:
        if ln.startswith("element"):
            _, name, n = ln.split()
            in_vertex = name == "vertex"
            if in_vertex:
                count = int(n)
        elif ln.startswith("property") and in_vertex:
            _, typ, name = ln.split()
            props.append((name, _PLY_DTYPES[typ]))
    if count is None:
        raise ValueError("no vertex element")
    return np.frombuffer(data, dtype=np.dtype(props), count=count,
                         offset=header_end)


def _numbered(names, prefix):
    return sorted((nm for nm in names if nm.startswith(prefix)),
                  key=lambda s: int(s.split("_")[-1]))


def load_gaussian_ply(path, max_sh_degree: int = 3,
                      fuse_filter_3d: bool = True,
                      device="cpu") -> Gaussians:
    """A RaDe-GS/3DGS PLY → Gaussians (every row valid): SH [dc | rest]
    as (N, 16, 3); a ``filter_3D`` column fused into scale and opacity."""
    v = read_ply_vertices(path)
    names = v.dtype.names
    n = len(v)
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    opacity = np.asarray(v["opacity"], np.float32)[:, None]
    f_dc = np.stack([v["f_dc_0"], v["f_dc_1"], v["f_dc_2"]],
                    axis=1).astype(np.float32)[:, None, :]
    n_rest = 3 * (max_sh_degree + 1) ** 2 - 3
    rest_names = _numbered(names, "f_rest_")
    if len(rest_names) != n_rest:
        raise ValueError(f"{len(rest_names)} f_rest columns, want {n_rest}")
    rest = np.stack([v[nm] for nm in rest_names], axis=1).astype(np.float32)
    # stored channel-major (3, K) flattened → (N, K, 3)
    rest = rest.reshape(n, 3, n_rest // 3).transpose(0, 2, 1)
    shs = np.concatenate([f_dc, rest], axis=1)
    scaling = np.stack([v[nm] for nm in _numbered(names, "scale_")],
                       axis=1).astype(np.float32)
    rotation = np.stack([v[nm] for nm in _numbered(names, "rot")],
                        axis=1).astype(np.float32)
    if fuse_filter_3d and "filter_3D" in names:
        filt = torch.tensor(np.asarray(v["filter_3D"], np.float32)[:, None])
        scales_act, opacity_act = fuse_3d_filter(
            torch.from_numpy(scaling), torch.from_numpy(opacity), filt)
        scaling = np.log(scales_act.numpy())
        opacity = inverse_sigmoid(
            torch.clamp(opacity_act, 1e-7, 1 - 1e-7)).numpy()
    return Gaussians.create(xyz, opacity, rotation, scaling, shs,
                            device=device)


def save_gaussian_ply(path, gaussians: Gaussians, only_valid: bool = True):
    """Write the reference PLY layout (gs.py:297-342)."""
    def host(x):
        return x.detach().cpu().numpy()

    valid = host(gaussians.valid)
    sel = valid if only_valid else np.ones_like(valid, dtype=bool)
    xyz = host(gaussians.xyz)[sel]
    n = xyz.shape[0]
    normals = np.zeros_like(xyz)
    shs = host(gaussians.shs)[sel]  # (N, 16, 3)
    f_dc = shs[:, 0:1, :].transpose(0, 2, 1).reshape(n, -1)
    f_rest = shs[:, 1:, :].transpose(0, 2, 1).reshape(n, -1)
    opac = host(gaussians.opacity)[sel]
    scale = host(gaussians.scaling)[sel]
    rot = host(gaussians.rotation)[sel]

    cols = ["x", "y", "z", "nx", "ny", "nz"]
    cols += [f"f_dc_{i}" for i in range(3)]
    cols += [f"f_rest_{i}" for i in range(45)]
    cols += ["opacity"] + [f"scale_{i}" for i in range(scale.shape[1])]
    cols += [f"rot_{i}" for i in range(rot.shape[1])]
    attrs = np.concatenate(
        [xyz, normals, f_dc, f_rest, opac, scale, rot], axis=1).astype("<f4")
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {n}\n"
              + "".join(f"property float {c}\n" for c in cols)
              + "end_header\n")
    buf = io.BytesIO()
    buf.write(header.encode("ascii"))
    buf.write(np.rec.fromarrays(list(attrs.T), names=cols).tobytes())
    with open(path, "wb") as f:
        f.write(buf.getvalue())
