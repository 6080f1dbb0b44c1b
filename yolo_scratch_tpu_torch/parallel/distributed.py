"""Multi-process data parallelism over ``torch.distributed`` (port of
``parallel/distributed.py``).

* :func:`initialize` joins the default process group (gloo): at
  ``tcp://<coordinator>`` (or a ``file://`` / ``tcp://`` URL as given) with
  ``num_processes`` and ``process_id``, or with no arguments at torchrun's
  ``env://``.
* :func:`make_global_mesh` gathers every rank's device and applies the
  transport rule: NCCL when every rank has a card of its own, gloo when
  ranks share a card (NCCL refuses two ranks on one GPU) or run on the CPU.
  Both transports run on the device asked for; nothing moves to the CPU.
* :func:`barrier` all-reduces ones over the mesh and raises unless every
  rank answered.
* :func:`process_slice`: each process's share of a dataset, round-robin.
* :func:`spawn_ranks` starts one process a rank (start method ``spawn``),
  collects each rank's result and raises if any rank fails or overruns.
"""

from __future__ import annotations

import os
import queue
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from yolo_scratch_tpu_torch.parallel.mesh import Mesh


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join the default (gloo) process group. ``coordinator_address`` is
    ``host:port`` (tcp) or a full init URL (``file://...``); without it the
    rendezvous is torchrun's environment (``env://``)."""
    if coordinator_address is None:
        dist.init_process_group("gloo", init_method="env://")
        return
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group("gloo", init_method=url, world_size=num_processes,
                            rank=process_id)


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def process_slice(n: int, process_id: Optional[int] = None,
                  num_processes: Optional[int] = None) -> np.ndarray:
    """This process's sample indices: round-robin over the dataset (counts
    differ by at most 1; the CLI trims them to the same length)."""
    pid = dist.get_rank() if process_id is None else process_id
    nproc = dist.get_world_size() if num_processes is None else num_processes
    return np.arange(pid, n, nproc)


def rank_device(rank: int, device: str | torch.device) -> torch.device:
    """The device of the rank with host-local index ``rank``:
    ``cuda:(rank % cards)``, or the CPU. ``cuda`` without a card raises."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device type {dev.type!r}: want 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA GPU is visible; "
                           "pass --device cpu to run on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def device_map(n: int, device: str | torch.device) -> List[torch.device]:
    """The devices of ``n`` ranks on one host (:func:`rank_device`)."""
    return [rank_device(r, device) for r in range(n)]


def transport(devices: Sequence[torch.device], hosts: Optional[Sequence[str]] = None) -> str:
    """``"nccl"`` when every rank has a card of its own (on its host), else
    ``"gloo"``."""
    hosts = hosts or [""] * len(devices)
    keys = [(h, d.type, d.index) for h, d in zip(hosts, devices)]
    own_card = all(d.type == "cuda" for d in devices) and len(set(keys)) == len(keys)
    return "nccl" if own_card else "gloo"


def make_global_mesh(device: str | torch.device, process_local: bool = False) -> Mesh:
    """The mesh of every rank of the default group, this process on
    ``device``. Collectives go over NCCL when every rank has a card of its
    own, else over the default gloo group (:func:`transport`)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    world = dist.get_world_size()
    seen: List[Any] = [None] * world
    dist.all_gather_object(seen, (os.uname().nodename, str(dev)))
    devices = tuple(torch.device(d) for _, d in seen)
    group = dist.group.WORLD
    if transport(devices, [h for h, _ in seen]) == "nccl":
        group = dist.new_group(backend="nccl")
    return Mesh(devices, rank=dist.get_rank(), group=group, process_local=process_local)


def mesh_transport(mesh: Mesh) -> str:
    return str(dist.get_backend(mesh.group)) if mesh.group is not None else "none"


def barrier(mesh: Optional[Mesh] = None) -> None:
    """All-reduce a one from every rank over the mesh's group and raise
    unless the sum is the world size: a fail-fast check that every process
    joined (and a synchronisation point)."""
    if mesh is None or mesh.group is None:
        return
    ones = torch.ones((), dtype=torch.float32, device=mesh.device)
    dist.all_reduce(ones, group=mesh.group)
    if float(ones) != mesh.size:  # not an assert: must fire under python -O too
        raise RuntimeError(f"barrier: the all-reduce over the mesh saw {float(ones):.0f} of "
                           f"{mesh.size} ranks; some processes are missing")


def _rank_main(fn: Callable, rank: int, args: tuple, results) -> None:
    try:
        results.put((rank, True, fn(rank, *args)))
    except BaseException:  # the parent raises with this rank's traceback
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable, n: int, args: tuple = (), timeout: Optional[float] = None) -> list:
    """Run ``fn(rank, *args)`` in ``n`` processes (start method ``spawn``:
    ``fn`` and ``args`` are pickled, ``fn`` by import path) and return
    their results in rank order. Raises with the first failing rank's
    traceback, or after ``timeout`` seconds, or when a rank that reported
    does not exit within 60 s; every process is ended before this
    returns."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, args, results), daemon=False)
             for r in range(n)]
    for p in procs:
        p.start()
    out: dict = {}
    deadline = None if timeout is None else time.monotonic() + timeout
    exited: set = set()  # ranks seen dead without a result, given one more poll
    try:
        while len(out) < n:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"spawn_ranks: {n - len(out)} of {n} ranks gave no "
                                       f"result in {timeout} s") from None
                dead = {r for r, p in enumerate(procs) if p.exitcode is not None} - set(out)
                if dead & exited:
                    raise RuntimeError(f"spawn_ranks: ranks {sorted(dead & exited)} exited "
                                       f"({[procs[r].exitcode for r in sorted(dead)]}) "
                                       "without a result") from None
                exited |= dead
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{value}")
            out[rank] = value
        for p in procs:  # each rank has reported; its teardown gets a bounded wait
            p.join(60.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"spawn_ranks: ranks exited non-zero {bad}")
    return [out[r] for r in range(n)]
