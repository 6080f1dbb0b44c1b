"""``dryrun_multichip(n)``: one sync-BN data-parallel train step over n
gloo ranks on the CPU at a tiny size (the port of
``__graft_entry__.py::dryrun_multichip``), checking that every rank ends
with the same loss, parameters and BN statistics.

    python -m yolo_scratch_tpu_torch.parallel.dryrun 2
"""

from __future__ import annotations

import sys
import tempfile

import numpy as np
import torch

from yolo_scratch_tpu_torch.parallel import distributed as D

IMG, CH, NC, G = 64, 1, 5, 8


def _rank(rank: int, n: int, init_method: str) -> dict:
    from yolo_scratch_tpu_torch.losses.v8_loss import DetectionLossConfig
    from yolo_scratch_tpu_torch.models.builder import CONFIGS, build_yolo11
    from yolo_scratch_tpu_torch.parallel.mesh import (
        make_sharded_train_step,
        replicate,
        shard_batch,
        state_tensors,
    )
    from yolo_scratch_tpu_torch.train.optim import make_optimizer
    from yolo_scratch_tpu_torch.train.state import create_train_state

    torch.set_num_threads(1)
    D.initialize(init_method, n, rank)
    mesh = D.make_global_mesh("cpu")
    D.barrier(mesh)
    model = build_yolo11(CONFIGS / "yolo11_crater.json", ch=CH, nc=NC, scale="n")
    state = create_train_state(model, make_optimizer(1e-3), use_ema=True)
    replicate(state_tensors(state), mesh)
    B = 2 * n
    rng = np.random.RandomState(0)
    batch = {
        "img": rng.rand(B, IMG, IMG, CH).astype(np.float32),
        "gt_labels": np.zeros((B, G), np.int32),
        "gt_bboxes": np.tile(np.asarray([0.2, 0.2, 0.6, 0.6], np.float32), (B, G, 1)),
        "gt_mask": np.tile(np.asarray([True] + [False] * (G - 1)), (B, 1)),
    }
    step = make_sharded_train_step(model, DetectionLossConfig(nc=NC, strides=model.strides),
                                   mesh)
    state, metrics = step(state, shard_batch(batch, mesh))
    flat = torch.cat([t.detach().reshape(-1).double() for t in state_tensors(state)])
    return {"loss": float(metrics["loss"]), "state": flat.numpy()}


def dryrun_multichip(n_devices: int, timeout: float = 300.0) -> float:
    """Run the step on ``n_devices`` CPU ranks; raise unless the loss is
    finite and every rank holds the same state. Returns the loss."""
    with tempfile.TemporaryDirectory() as rdv:
        out = D.spawn_ranks(_rank, n_devices, (n_devices, f"file://{rdv}/rendezvous"),
                            timeout=timeout)
    loss = out[0]["loss"]
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    for r, o in enumerate(out[1:], 1):
        if o["loss"] != loss or not np.array_equal(o["state"], out[0]["state"]):
            raise RuntimeError(f"rank {r}'s loss or state differs from rank 0's")
    print(f"dryrun_multichip({n_devices}): ok, loss={loss:.4f}")
    return loss


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
