"""Data-parallel meshes (port of ``parallel/mesh.py``).

The JAX package runs a mesh step as one jitted program over N devices in
one process. Here each rank of a mesh is a process of its own with one
device; the ranks meet in a ``torch.distributed`` process group (gloo, or
NCCL when every rank has a card of its own: ``parallel/distributed.py``).

* A :class:`Mesh` is the device of every rank (the device map), this
  process's rank in it and the process group. A mesh with no group is one
  process's devices: ``Predictor.shard_over`` serves one replica on each.
* :func:`make_mesh` builds such a one-process mesh over local devices and
  raises when fewer than ``n`` exist (the JAX package falls back to virtual
  CPU devices; the port does not hide the device).
* :func:`shard_batch` takes this rank's contiguous rows of a global batch
  (``P("dp")``): rank r of N takes rows ``[r·B/N, (r+1)·B/N)``. On a
  ``process_local`` mesh (``--multihost``) each process already holds its
  own rows, which stay as they are.
* :func:`replicate` broadcasts rank 0's tensors to every rank.
* :func:`make_sharded_train_step`: sync-BN over the global batch, the loss
  normalised by batch-wide sums over the ranks, gradients summed: the
  single-process step on the global batch (the jit-sharded JAX step).
* :func:`make_ddp_train_step`: BN over each rank's shard, each rank's own
  loss, gradients, loss and metrics averaged, the BN running statistics
  averaged (``sync_bn_stats``) or rank 0's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

from yolo_scratch_tpu_torch.parallel.collectives import broadcast_flat
from yolo_scratch_tpu_torch.train.state import ema_as_tree


@dataclass
class Mesh:
    """A 1-D data-parallel mesh. ``devices[r]`` is rank r's device; this
    process is ``rank``. ``group`` is the process group of the collectives
    (None: one process, no collectives). ``process_local``: each process
    feeds its own rows of every batch (``--multihost``), where otherwise
    every rank loads the same global batch and takes its rows."""

    devices: Tuple[torch.device, ...]
    rank: int = 0
    group: Any = None
    process_local: bool = False

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]

    @property
    def is_writer(self) -> bool:
        """Rank 0 alone writes files (checkpoints, logs) and prints."""
        return self.rank == 0


def make_mesh(n_devices: Optional[int] = None, device: str | torch.device = "cuda") -> Mesh:
    """A one-process mesh over ``n_devices`` local devices of ``device``'s
    type (``cuda``: cards 0..n-1, all of them by default; ``cpu``: n replicas
    on the CPU). Raises when fewer than n cards exist: no fallback to the
    CPU. A mesh whose replicas share a card is built as ``Mesh(devices)``."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return Mesh((dev,) * (n_devices or 1))
    if dev.type != "cuda":
        raise ValueError(f"make_mesh: device type {dev.type!r}; want 'cuda' or 'cpu'")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = n_devices or count
    if n < 1 or count < n:
        raise ValueError(f"mesh needs {n} CUDA devices but {count} are visible; build "
                         "Mesh(devices) to share a card, or pass device='cpu'")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def shard_batch(batch: Mapping[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's contiguous rows of a global batch (numpy or tensors);
    on a ``process_local`` mesh the process's own batch, unchanged."""
    if mesh.process_local:
        return dict(batch)
    B = len(batch["img"])
    if B % mesh.size:
        raise ValueError(f"batch {B} is not divisible by the mesh size {mesh.size}")
    b = B // mesh.size
    return {k: v[mesh.rank * b:(mesh.rank + 1) * b] for k, v in batch.items()}


def replicate(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Every rank's ``tensors`` become rank 0's, in place (a no-op on a
    one-process mesh)."""
    if mesh.group is not None:
        broadcast_flat(list(tensors), mesh.group)


def state_tensors(state) -> list:
    """The tensors of a train state (``train/state.py``) that every rank
    must hold alike: parameters, BN buffers, the EMA and Adam's moments."""
    model = state.model
    out = [*model.parameters(), *model.buffers(), *state.opt_state.mu, *state.opt_state.nu]
    return out + list((ema_as_tree(state) or {}).values())


def make_sharded_train_step(model, loss_cfg, mesh: Mesh, loss_fn=None, **step_kwargs):
    """The sync-BN step over ``mesh``: called on each rank with its rows
    (:func:`shard_batch`), it equals the one-process step on the global
    batch. ``loss_fn`` overrides the v8 loss of ``loss_cfg`` (YOLOX:
    ``yolox_loss_adapter``) and must take ``reduce=``; ``step_kwargs`` go
    to ``build_train_step_custom``."""
    from yolo_scratch_tpu_torch.train.steps import build_train_step_custom, v8_loss_adapter

    return build_train_step_custom(model, loss_fn or v8_loss_adapter(loss_cfg), mesh=mesh,
                                   bn_mode="sync", **step_kwargs)


def make_ddp_train_step(model, loss_fn, mesh: Mesh, sync_bn_stats: bool = True,
                        compute_dtype=None, remat: bool = False, **step_kwargs):
    """The DDP step over ``mesh`` (local BN): each rank's loss on its own
    rows, gradients, loss and metrics averaged over the ranks, BN running
    statistics averaged (``sync_bn_stats``) or taken from rank 0."""
    from yolo_scratch_tpu_torch.train.steps import build_train_step_custom

    return build_train_step_custom(model, loss_fn, compute_dtype=compute_dtype, remat=remat,
                                   mesh=mesh, bn_mode="local", sync_bn_stats=sync_bn_stats,
                                   **step_kwargs)
