"""Process groups and the collectives of the port's parallel paths.

Counterpart of ``igs_tpu/parallel/distributed.py``. JAX drives every chip
of a host from one process; here each rank is a process, one per card
(or several sharing one card over gloo), joined by ``torch.distributed``:

  * ``init_distributed`` starts this process's rank from torchrun's
    environment (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``) or from explicit arguments; with neither it
    is a no-op, as the JAX version is without a cluster. The backend is
    ``nccl`` unless the caller names ``gloo``; it is never switched
    quietly.
  * ``make_global_mesh``, ``local_batch_slice`` and ``all_processes_mean``
    are the JAX functions' counterparts over the ranks.
  * ``all_gather``, ``all_reduce`` and ``broadcast_tree`` are the
    collectives the parallel paths build on, and each gives every rank
    the same bits, so replicated state stays replicated without
    re-syncs. Under ``nccl`` they are NCCL's own (``all_gather_into_
    tensor``, ``all_reduce``, ``broadcast``), whose results are the same
    on every rank. Under ``gloo``, whose ``all_gather`` refuses CUDA
    tensors, ``all_gather`` sums slot buffers in which each rank wrote
    its own bytes (exact for every dtype; n times the bytes of a native
    gather), and ``all_reduce`` sums the gathered slots on each rank in
    one order.
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
DEFAULT_TIMEOUT_S = 600.0
# the running group's collective timeout, which its subgroups take too
_timeout_s = DEFAULT_TIMEOUT_S


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def local_rank() -> int:
    """This rank's index on its host (torchrun's ``LOCAL_RANK``, else the
    global rank)."""
    return int(os.environ.get("LOCAL_RANK", process_index()))


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join this process to its group of ranks; True when the group has
    more than one rank.

    ``coordinator_address`` is ``host:port`` (TCP) or a ``file://`` path
    (a FileStore); unset, torchrun's ``MASTER_ADDR``/``MASTER_PORT`` are
    read, and ``num_processes``/``process_id`` default to ``WORLD_SIZE``/
    ``RANK``. With no address and no process count it does nothing and
    returns False. An explicit ``num_processes=1`` starts a group of one
    (and returns False). Under ``nccl`` the rank's card is
    ``cuda:LOCAL_RANK``. A collective that waits longer than
    ``timeout_s`` fails (the subgroups of ``mesh.make_mesh`` take the same
    limit). A second call returns the running group's answer.
    """
    if is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None:
        raise ValueError("init_distributed needs both a coordinator address "
                         "and a process count (or torchrun's environment)")
    if process_id is None:
        if num_processes != 1:
            raise ValueError("init_distributed needs this process's rank")
        process_id = 0
    backend = backend or "nccl"
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}; the port has {BACKENDS}")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend 'nccl' needs CUDA; name backend="
                               "'gloo' to run the ranks on the CPU")
        torch.cuda.set_device(local_rank())
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    global _timeout_s
    _timeout_s = timeout_s
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=timedelta(seconds=timeout_s))
    return num_processes > 1


def group_timeout() -> timedelta:
    """The running group's collective timeout."""
    return timedelta(seconds=_timeout_s)


def shutdown() -> None:
    """Leave the group (a no-op without one)."""
    if is_initialized():
        dist.destroy_process_group()


def make_global_mesh(tile: int = 1, device=None):
    """The (data, tile) mesh over every rank, rank-major as JAX lays out
    its processes' devices."""
    from igs_tpu_torch.parallel.mesh import make_mesh

    n = process_count()
    if n % tile:
        raise ValueError(f"{n} ranks not divisible by tile={tile}")
    return make_mesh(data=n // tile, tile=tile, device=device)


def local_batch_slice(global_batch: int) -> slice:
    """The [start, end) range of the global batch this rank feeds."""
    per = global_batch // process_count()
    r = process_index()
    return slice(r * per, (r + 1) * per)


def all_processes_mean(x) -> float:
    """A scalar's mean over every rank."""
    t = torch.as_tensor(x, dtype=torch.float64).reshape(())
    if process_count() == 1:
        return float(t)
    return float(all_reduce(t)) / process_count()


# -- collectives ---------------------------------------------------------------

def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` viewed as flat uint8."""
    x = x.detach().contiguous()
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    return x.reshape(-1).view(torch.uint8)


def _from_bytes(b: torch.Tensor, dtype, shape) -> torch.Tensor:
    if dtype == torch.bool:
        return b.view(torch.uint8).reshape(shape).bool()
    return b.view(dtype).reshape(shape)


def _nccl(group=None) -> bool:
    return dist.get_backend(group) == "nccl"


def all_gather(x: torch.Tensor, group=None, size: Optional[int] = None,
               index: Optional[int] = None) -> torch.Tensor:
    """(size, *x.shape): every rank's ``x``, in rank order within
    ``group``, on every rank (detached), bit for bit for any dtype.

    Under ``nccl`` with every rank writing its slot, NCCL's gather of the
    bytes. Otherwise each rank writes its bytes into its own slot of a
    zero buffer and the buffers are summed (``all_reduce``): byte + 0 is
    exact. ``size``/``index`` override the slot count and this rank's
    slot (None: a receiver that writes nothing).
    """
    if size is None:
        size = dist.get_world_size(group) if is_initialized() else 1
        index = dist.get_rank(group) if is_initialized() else 0
    if size == 1 and index == 0 and not is_initialized():
        return x.detach()[None]
    b = _as_bytes(x)
    nccl = _nccl(group)
    if nccl:  # NCCL carries CUDA tensors only
        b = b.cuda()
    if nccl and index is not None and size == dist.get_world_size(group):
        buf = torch.empty((size, b.numel()), dtype=torch.uint8,
                          device=b.device)
        dist.all_gather_into_tensor(buf, b, group=group)
    else:
        buf = torch.zeros((size, b.numel()), dtype=torch.uint8,
                          device=b.device)
        if index is not None:
            buf[index] = b
        dist.all_reduce(buf, group=group)
    return _from_bytes(buf.to(x.device), x.dtype, (size,) + tuple(x.shape))


def all_reduce(x: torch.Tensor, group=None, op: str = "sum") -> torch.Tensor:
    """The ``op`` ("sum" or "max") of every rank's ``x`` within ``group``,
    the same bits on every rank (detached): NCCL's ``all_reduce`` under
    ``nccl``, else the gathered slots reduced in rank order."""
    if not is_initialized():
        return x.detach()
    if _nccl(group):
        y = x.detach().cuda().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=group)
        return y.to(x.device)
    every = all_gather(x, group)
    return every.sum(0) if op == "sum" else every.amax(0)


# -- trees of tensors ----------------------------------------------------------

def tree_map(fn: Callable[[Any], Any], tree,
             is_leaf: Callable[[Any], bool] = torch.is_tensor):
    """``fn`` on every leaf (by default every tensor) of a tree of dicts,
    lists, tuples, NamedTuples and dataclasses (``Gaussians``); None and
    other values are kept."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, is_leaf) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, is_leaf) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name), is_leaf)
            for f in dataclasses.fields(tree)})
    return tree


def tree_leaves(tree) -> list:
    """The tensors of a tree, in ``tree_map``'s order."""
    out = []
    tree_map(lambda t: out.append(t), tree)
    return out


@dataclasses.dataclass(frozen=True)
class _Spec:
    shape: tuple
    dtype: torch.dtype


def broadcast_tree(tree, src: int = 0, device=None):
    """``tree`` of rank ``src`` (over every rank) on every rank, on
    ``device`` (when None, the device of this rank's own tree, or the
    CPU). Other ranks may pass None: the tree's layout travels first, then
    each tensor."""
    if process_count() == 1:
        return tree
    me = process_index() == src
    spec = [tree_map(lambda t: _Spec(tuple(t.shape), t.dtype), tree)
            if me else None]
    dist.broadcast_object_list(spec, src=src)
    own = tree_leaves(tree)
    dev = torch.device(device or (own[0].device if own else "cpu"))
    out = tree if me else tree_map(
        lambda sp: torch.empty(sp.shape, dtype=sp.dtype, device=dev),
        spec[0], is_leaf=lambda x: isinstance(x, _Spec))
    nccl = _nccl()  # CUDA tensors only
    for t in tree_leaves(out):
        b = _as_bytes(t) if me else torch.empty(
            t.numel() * t.element_size(), dtype=torch.uint8, device=dev)
        if nccl:
            b = b.cuda()
        dist.broadcast(b, src=src)
        if not me:
            t.copy_(_from_bytes(b.to(dev), t.dtype, t.shape))
    return out

