"""The (data, tile) mesh of ranks.

Counterpart of ``igs_tpu/parallel/mesh.py``. A JAX mesh names devices and
the compiler places the collectives; here a ``Mesh`` names ranks of the
default group, knows this rank's coordinates, and holds one process group
per axis, over which its collectives run:

  * ``data``: candidate frames, batch items or frames (the reference's
    DDP axis);
  * ``tile``: rows of image tiles inside one render (the sharded refine).

A mesh may take fewer ranks than the group has (as JAX takes
``jax.devices()[:n]``); the others are not members, run nothing of the
mesh's work, and receive its result through ``give_to_all``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from igs_tpu_torch.parallel import distributed as D

AXES = ("data", "tile")


class Mesh:
    def __init__(self, ranks: np.ndarray, device=None):
        self.ranks = np.asarray(ranks, dtype=np.int64)  # (data, tile)
        self.device = torch.device(device) if device is not None else None
        me = D.process_index()
        hit = np.argwhere(self.ranks == me)
        self.coords = tuple(int(c) for c in hit[0]) if len(hit) else None
        self.groups: Dict[str, object] = {}
        world = D.process_count()
        # every rank of the default group creates every subgroup, in one
        # order (dist.new_group is collective over the default group)
        for axis in AXES:
            lines = self.ranks if axis == "tile" else self.ranks.T
            self.groups[axis] = None
            if lines.shape[1] == 1:
                continue
            for line in lines:
                members = sorted(int(r) for r in line)
                if len(members) == world:
                    group = dist.group.WORLD
                else:
                    group = dist.new_group(members,
                                           timeout=D.group_timeout())
                if self.coords is not None and me in members:
                    self.groups[axis] = group

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    @property
    def member(self) -> bool:
        return self.coords is not None

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        if self.coords is None:
            raise RuntimeError("this rank is not in the mesh")
        return self.coords[AXES.index(axis)]

    # -- collectives over one axis (members only) ------------------------------
    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """(axis size, *x.shape): the axis's members' ``x`` in order."""
        n = self.shape[axis]
        if n == 1:
            return x.detach()[None]
        return D.all_gather(x, self.groups[axis], size=n,
                            index=self.index(axis))

    def sum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum over the axis, the same bits on every member."""
        if self.shape[axis] == 1:
            return x
        return D.all_reduce(x, self.groups[axis])

    def mean(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        if self.shape[axis] == 1:
            return x
        return self.sum(x, axis) / self.shape[axis]

    def max(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        if self.shape[axis] == 1:
            return x
        return D.all_reduce(x, self.groups[axis], op="max")

    def gather_batch(self, tree, axis: str = "data"):
        """Every tensor of ``tree`` gathered along its leading axis: the
        members' shards joined in order."""
        if self.shape[axis] == 1:
            return tree
        return D.tree_map(
            lambda t: self.all_gather(t, axis).reshape(
                (-1,) + tuple(t.shape[1:])), tree)

    def shard(self, tree, axis: str = "data"):
        """This member's slice of the leading axis of every tensor."""
        n = self.shape[axis]
        if n == 1:
            return tree
        i = self.index(axis)

        def one(t):
            if t.shape[0] % n:
                raise ValueError(f"leading axis {t.shape[0]} not divisible "
                                 f"by mesh axis '{axis}' size {n}")
            per = t.shape[0] // n
            return t[i * per:(i + 1) * per]

        return D.tree_map(one, tree)

    def give_to_all(self, tree, device=None):
        """The mesh's result (held by its first rank) on every rank of the
        default group; members other than the first keep their own copy,
        which equals it. A no-op when the mesh covers the group."""
        if self.size == D.process_count():
            return tree
        src = int(self.ranks.reshape(-1)[0])
        return D.broadcast_tree(tree, src=src,
                                device=device or self.device)


def make_mesh(data: Optional[int] = None, tile: int = 1,
              ranks: Optional[Sequence[int]] = None, device=None) -> Mesh:
    """A (data, tile) mesh over ``ranks`` (default: every rank), laid out
    data-major. Raises unless ``data · tile`` is the number of ranks.
    Every rank of the default group must call it, in the same order as
    every other rank."""
    ranks = list(range(D.process_count()) if ranks is None else ranks)
    n = len(ranks)
    if data is None:
        data = n // tile
    if data * tile != n:
        raise ValueError(f"{data}×{tile} != {n} ranks")
    if n > D.process_count():
        raise ValueError(f"a mesh of {n} ranks, but {D.process_count()} "
                         "are up")
    return Mesh(np.asarray(ranks).reshape(data, tile), device=device)


def shard_batch(mesh: Mesh, batch):
    """This rank's slice of the leading (data) axis of every tensor of
    ``batch`` (the JAX function places the whole batch with the data-axis
    sharding; here each rank holds its shard)."""
    return mesh.shard(batch, "data")


def replicated(mesh: Mesh, tree):
    """Every tensor of ``tree`` as the mesh's first rank holds it, on every
    rank (parameters and state that each rank keeps whole)."""
    if D.process_count() == 1:
        return tree
    src = int(mesh.ranks.reshape(-1)[0])
    return D.broadcast_tree(tree, src=src, device=mesh.device)
