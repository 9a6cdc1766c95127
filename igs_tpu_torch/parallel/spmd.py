"""The streaming window's AGM forward with the candidates split over ranks.

Counterpart of ``igs_tpu/parallel/spmd.py``. The candidate frames of a
window are independent (the key frame's anchors are replicated across
the batch), so each member of the mesh's ``data`` axis runs AGM-Net on its
slice of the candidates, with no collective inside the forward; the
outputs are then gathered along the batch axis, so every rank holds the
whole window's outputs. ``shared_cur`` and ``shared_window_pairs`` apply
per shard (each member's candidates still share the key frame and the
eval camera), as in the JAX package. Ranks outside the mesh receive the
outputs.
"""

from __future__ import annotations

from igs_tpu_torch.parallel.mesh import Mesh


def sharded_agm_apply(model, settings, depth_settings, mesh: Mesh,
                      shared_cur: bool = False,
                      shared_window_pairs: bool = False,
                      shared_pairs_drift_px: float = 8.0):
    """(batch, anchor_state, gaussians) → the AGM outputs of the whole
    batch, its candidates sharded over ``mesh``'s ``data`` axis. Every
    tensor of the inputs leads with the batch axis, divisible by the axis
    size; the model's parameters are the same on every rank."""

    def apply(batch, state, gaussians):
        out = None
        if mesh.member:
            local = model(
                shard_streaming_batch(mesh, batch),
                shard_streaming_batch(mesh, state),
                shard_streaming_batch(mesh, gaussians), settings,
                depth_settings=depth_settings, shared_cur=shared_cur,
                shared_window_pairs=shared_window_pairs,
                shared_pairs_drift_px=shared_pairs_drift_px)
            out = mesh.gather_batch(local, "data")
        return mesh.give_to_all(out)

    return apply


def shard_streaming_batch(mesh: Mesh, tree):
    """This rank's candidates: the slice of every tensor's leading axis."""
    return mesh.shard(tree, "data")
