"""Starting ranks: under torchrun, or spawned by the port's own CLIs.

The parallel CLIs (``infer_stream``, ``train_agm``, ``build_frame0
--spmd``) join a group that torchrun started. When their config asks for
more than one rank and no group is up, they start their own ranks with
``spawn``: ``torch.multiprocessing`` processes that meet through a
``FileStore`` in a fresh directory, one per card under ``nccl``, or all
on one card (or the CPU) under ``gloo``. ``rank_plan`` decides which, and
raises by name where the cards present cannot hold the ranks asked for.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.multiprocessing as mp

from igs_tpu_torch.parallel import distributed as D

JOIN_TIMEOUT_S = 3600.0


def rank_plan(ranks: int, device: Optional[str], backend: Optional[str],
              share_card: bool = False) -> tuple[str, List[str]]:
    """(backend, the device of each rank) for ``ranks`` ranks.

    ``nccl`` (the default) puts rank r on ``cuda:r`` and needs a card a
    rank. ``gloo`` is taken only when named: on the CPU (``device``
    "cpu"), or with ``share_card`` every rank on the one card ``device``
    names (``cuda`` = ``cuda:0``)."""
    backend = backend or "nccl"
    if backend not in D.BACKENDS:
        raise ValueError(f"backend {backend!r}; the port has {D.BACKENDS}")
    dev = torch.device(device or "cuda")
    if dev.type == "cpu":
        if backend != "gloo":
            raise ValueError(f"{ranks} ranks on the CPU need backend 'gloo' "
                             "(nccl runs on cards only)")
        return backend, ["cpu"] * ranks
    if share_card:
        if backend != "gloo":
            raise ValueError("ranks sharing one card need backend 'gloo': "
                             "nccl refuses two ranks on one device")
        return backend, [str(torch.device("cuda", dev.index or 0))] * ranks
    cards = torch.cuda.device_count()
    if ranks > cards:
        raise ValueError(
            f"{ranks} ranks need {ranks} cards under {backend}, and {cards} "
            "are present: name backend 'gloo' with share_card to run them "
            "on one card")
    return backend, [f"cuda:{r}" for r in range(ranks)]


def _entry(rank: int, fn: Callable, nprocs: int, store: str, backend: str,
           devices: Sequence[str], out_dir: str, args: tuple,
           threads: Optional[int], timeout_s: float) -> None:
    if threads:
        torch.set_num_threads(threads)
    if backend == "nccl":
        os.environ["LOCAL_RANK"] = str(torch.device(devices[rank]).index or 0)
    # a collective waits no longer than the whole group may run
    D.init_distributed(f"file://{store}", nprocs, rank, backend=backend,
                       timeout_s=min(timeout_s, D.DEFAULT_TIMEOUT_S))
    try:
        result = fn(rank, devices[rank], *args)
    finally:
        D.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn(fn: Callable, nprocs: int, args: tuple = (),
          backend: str = "nccl", devices: Optional[Sequence[str]] = None,
          timeout_s: float = JOIN_TIMEOUT_S, workdir: Optional[str] = None,
          threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(rank, device, *args)`` in ``nprocs`` new processes joined in
    one group, and return each rank's return value (picklable), in rank
    order. ``fn`` must be importable by module (a top-level function).
    The rendezvous is a FileStore under ``workdir`` (a new temporary
    directory when None, removed after). A rank that raises fails the
    call; a group still running after ``timeout_s`` seconds is killed and
    the call raises ``TimeoutError``, and a collective that waits longer
    than that (or than ``distributed.DEFAULT_TIMEOUT_S``) fails. ``threads`` sets each rank's
    ``torch.set_num_threads`` (default: ranks on the CPU share this
    process's threads)."""
    devices = list(devices or ["cpu"] * nprocs)
    if threads is None and all(d == "cpu" for d in devices):
        threads = max(1, torch.get_num_threads() // nprocs)
    own = workdir is None
    work = tempfile.mkdtemp(prefix="igs_ranks_") if own else workdir
    os.makedirs(work, exist_ok=True)
    store = os.path.join(work, "store")
    if os.path.exists(store):
        os.remove(store)
    try:
        ctx = mp.start_processes(
            _entry, args=(fn, nprocs, store, backend, devices, work, args,
                          threads, timeout_s),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"{nprocs} ranks still running after "
                                   f"{timeout_s:.0f} s; killed")
        results = []
        for r in range(nprocs):
            with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        if own:
            shutil.rmtree(work, ignore_errors=True)


def rank_device(device: Optional[str], share_card: bool = False
                ) -> torch.device:
    """The device of this rank of a running group: the CPU or the shared
    card as named, else the card of its local rank."""
    dev = torch.device(device or "cuda")
    if dev.type == "cpu" or share_card or not D.is_initialized():
        return dev
    return torch.device("cuda", D.local_rank())


def run_ranked(fn: Callable, ranks: int, args: tuple = (),
               device: Optional[str] = None, backend: Optional[str] = None,
               share_card: bool = False, timeout_s: float = JOIN_TIMEOUT_S):
    """``fn(rank, device, *args)`` over ``ranks`` ranks; returns rank 0's
    value (this process's own, when it is a rank of a running group).

    In this process when it already belongs to a group (a spawned rank) or
    when torchrun's environment starts one, which must then hold at least
    ``ranks`` ranks; else, for more than one rank, in ranks spawned by
    ``spawn`` as ``rank_plan`` lays them out; else here, as rank 0."""
    D.init_distributed(backend=backend)  # torchrun's group, if any
    if D.is_initialized():
        if D.process_count() < ranks:
            raise ValueError(f"{ranks} ranks asked for, and the running "
                             f"group has {D.process_count()}")
        return fn(D.process_index(), str(rank_device(device, share_card)),
                  *args)
    if ranks <= 1:
        return fn(0, device, *args)
    backend, devices = rank_plan(ranks, device, backend, share_card)
    return spawn(fn, ranks, args, backend=backend, devices=devices,
                 timeout_s=timeout_s)[0]
