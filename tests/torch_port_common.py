"""Shared inputs for the port's parity tests: one tiny AGM-Net config, its
flax parameters, and numpy batches that both packages read."""

import numpy as np
import jax
import jax.numpy as jnp

from igs_tpu.core.gaussians import Gaussians as JGaussians
from igs_tpu.models.agm import AGMNet as JAGMNet
from igs_tpu.ops.anchors import select_anchors as jax_select_anchors
from igs_tpu.ops.rasterize import RasterSettings as JSettings
from igs_tpu_torch.core.gaussians import Gaussians
from igs_tpu_torch.models.agm import AGMNet
from igs_tpu_torch.models.convert import load_flax_params
from tests.conftest import random_gaussians

TINY = dict(feature_channels=32, backbone_layers=1, encoder_layers=1,
            encoder_heads=2, encoder_head_dim=16)


def to_torch_gaussians(g: JGaussians) -> Gaussians:
    return Gaussians.create(np.asarray(g.xyz), np.asarray(g.opacity),
                            np.asarray(g.rotation), np.asarray(g.scaling),
                            np.asarray(g.shs), valid=np.asarray(g.valid),
                            device="cpu")


def numpy_batch(b=2, v=4, hw=32, out_hw=(40, 48), seed=0):
    """collate()-layout batch: B candidates sharing one key frame (cur)
    and one eval camera, V input views on a ring."""
    rng = np.random.RandomState(seed)
    vout = v + 1
    c2w = np.zeros((vout, 4, 4), np.float32)
    for i in range(vout):
        th = (i / vout - 0.5) * 1.2
        pos = np.float32([4 * np.sin(th), 0.1 * np.sin(3 * th), -4 * np.cos(th)])
        z = -pos / np.linalg.norm(pos)
        x = np.cross([0.0, -1.0, 0.0], z)
        x /= np.linalg.norm(x)
        c2w[i, :3, :3] = np.stack([x, np.cross(z, x), z], 1)
        c2w[i, :3, 3] = pos
        c2w[i, 3, 3] = 1
    cur = rng.uniform(0, 1, (v, 3, hw, hw)).astype(np.float32)
    h8 = hw // 8 * 2
    batch = {
        "cur_images_input": np.stack([cur] * b),
        "next_images_input": rng.uniform(0, 1, (b, v, 3, hw, hw)).astype(
            np.float32),
        "images_output": rng.uniform(0, 1, (b, vout, 3) + out_hw).astype(
            np.float32),
        "depth": rng.uniform(3, 5, (b, v, hw, hw)).astype(np.float32),
        "local_rays": np.stack([rng.normal(size=(h8, h8, 3)).astype(
            np.float32)] * b),
        "rays": rng.normal(size=(b, v, h8, h8, 6)).astype(np.float32),
        "FOV": np.full((b, 2), 0.8, np.float32),
        "c2w_input": np.stack([c2w[1:]] * b),
        "c2w_output": np.stack([c2w] * b),
        "background_color": np.zeros((b, 3), np.float32),
        "bounding_box": np.stack([np.float32([[-1, -1, -1], [1, 1, 1]])] * b),
    }
    return batch


def flax_params(local_ray=True, n=256, max_num=320, seed=0):
    """Random flax AGMNet params with randomized residual heads (their
    zero init would hide conversion faults) + the start Gaussians."""
    model = JAGMNet(local_ray=local_ray, **TINY)
    g = random_gaussians(n=n, seed=3).pad_to(max_num)
    batch = numpy_batch(b=1)
    state = jax_select_anchors(g.xyz, jnp.asarray(batch["bounding_box"][0]),
                               valid=g.valid, anchor_size=32, k=4)
    settings = JSettings(image_height=40, image_width=48, impl="tiles",
                         max_pairs=1 << 14, max_per_tile=256, chunk=64)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    add_b = lambda x: None if x is None else x[None]
    params = jax.jit(lambda key: model.init(
        key, jb, jax.tree.map(add_b, state), jax.tree.map(add_b, g),
        settings))(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed + 7)
    params = jax.tree.map(lambda x: x, params)
    params["params"]["render"]["head_xyz"]["kernel"] = jnp.asarray(
        rng.normal(0, 0.02, (32, 3)), jnp.float32)
    params["params"]["render"]["head_rotation"]["kernel"] = jnp.asarray(
        rng.normal(0, 0.05, (32, 4)), jnp.float32)
    return model, params, g


def port_model(params, local_ray=True) -> AGMNet:
    model = AGMNet(local_ray=local_ray, **TINY)
    load_flax_params(model, params)
    return model.eval()


class MemoryStream:
    """An in-memory stream of collate()-layout items; the start Gaussians
    ride on the first window's batch as ``gs``."""

    def __init__(self, items, start_gs):
        self.items = items
        self.start_gs = start_gs

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def collate(self, items):
        batch = {k: np.stack([it[k] for it in items])
                 for k in items[0] if k not in ("keyframe", "idx")}
        batch["keyframe"] = [it["keyframe"] for it in items]
        if items[0]["idx"] == 0:
            batch["gs"] = [self.start_gs]
        return batch


def stream_items(n_items=4, interval=2, out_hw=(40, 48), gt_images=None):
    """Items of a key→candidate stream; ``gt_images[i]`` is the eval view
    of frame i+1."""
    base = numpy_batch(b=1, out_hw=out_hw)
    items = []
    for i in range(n_items):
        rng = np.random.RandomState(100 + i)
        it = {k: v[0] for k, v in base.items()}
        it["next_images_input"] = rng.uniform(0, 1, it["next_images_input"].shape
                                              ).astype(np.float32)
        it["images_output"] = it["images_output"].copy()
        if gt_images is not None:
            it["images_output"][0] = gt_images[i]
        it["keyframe"] = 1 if i % interval == 0 else 0
        it["idx"] = i
        items.append(it)
    return items
