"""Rank programs for ``tests/test_torch_parallel*.py``: each runs in a
process of its own (``parallel/distributed.py::spawn_ranks``), joins a gloo
group at a ``file://`` rendezvous and writes its results to ``.npz`` files
that the test process compares with the JAX package. Imports torch and the
port only.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from yolo_scratch_tpu_torch.data.augment import AugmentConfig, augment_batch, batch_generator
from yolo_scratch_tpu_torch.losses.simota import YOLOXLossConfig
from yolo_scratch_tpu_torch.losses.v8_loss import DetectionLossConfig
from yolo_scratch_tpu_torch.models.builder import CONFIGS, build_yolo11
from yolo_scratch_tpu_torch.models.yolox import build_yolox
from yolo_scratch_tpu_torch.parallel import distributed as D
from yolo_scratch_tpu_torch.parallel.mesh import shard_batch
from yolo_scratch_tpu_torch.train.optim import cosine_epoch_schedule, make_optimizer
from yolo_scratch_tpu_torch.train.state import create_train_state
from yolo_scratch_tpu_torch.train.steps import (
    build_train_step_custom,
    v8_loss_adapter,
    yolox_loss_adapter,
)

LR = 1e-3
AUGMENT = AugmentConfig(hflip_p=0.5, mosaic_p=1.0, mixup_p=1.0)


def build(family: str, state_dict=None, dtype=torch.float32, seed: int = 0):
    """The crater YOLO11n (ch 1, nc 5) or YOLOX-nano (ch 3, nc 5) with its
    loss, holding ``state_dict`` (else the ``seed`` init)."""
    if family == "yolo11":
        model = build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n", seed=seed)
        loss_fn = v8_loss_adapter(DetectionLossConfig(nc=5, strides=model.strides))
    else:
        model = build_yolox("nano", nc=5, ch=3, seed=seed)
        loss_fn = yolox_loss_adapter(YOLOXLossConfig(nc=5, strides=tuple(model.strides)))
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model.to(dtype), loss_fn


def run_step(sc: dict, mesh=None) -> dict:
    """One train step of scenario ``sc`` from its initial weights (a fresh
    optimizer state and EMA, the schedule of a 10-epoch run of one step an
    epoch, TF32 off): on ``mesh``, this rank's step on its rows; without,
    the one-process step on the whole batch. Returns numpy arrays: loss,
    ``m.<metric>``, and per tensor ``grad.``, ``sd.`` (parameters and BN
    buffers after the step), ``mu.``, ``nu.``, ``ema.``."""
    dtype = torch.float64 if sc.get("f64") else torch.float32
    model, loss_fn = build(sc["family"], sc["state"], dtype)
    state = create_train_state(model, make_optimizer(cosine_epoch_schedule(LR, 10, 1)),
                               use_ema=True)
    step = build_train_step_custom(model, loss_fn, matmul_precision="highest",
                                   grad_accum=sc.get("grad_accum", 1), mesh=mesh,
                                   bn_mode=sc.get("bn_mode", "sync"),
                                   sync_bn_stats=sc.get("sync_bn_stats", True))
    batch = {k: torch.from_numpy(v) for k, v in sc["batch"].items()}
    batch["img"] = batch["img"].to(dtype)
    augment = rows = None
    if sc.get("augment"):
        augment = lambda b: augment_batch(b, batch_generator(7, 0, 0), AUGMENT)  # noqa: E731
        if mesh is not None:
            b = len(batch["img"]) // mesh.size
            rows = slice(mesh.rank * b, (mesh.rank + 1) * b)
    elif mesh is not None:
        batch = shard_batch(batch, mesh)
    state, metrics = step(state, batch, augment=augment, rows=rows)
    names = [n for n, _ in model.named_parameters()]
    out = {"loss": metrics.pop("loss").detach().numpy()}
    out.update({f"m.{k}": v.numpy() for k, v in metrics.items()})
    out.update({f"grad.{n}": p.grad.numpy() for n, p in model.named_parameters()})
    out.update({f"sd.{k}": v.detach().numpy() for k, v in model.state_dict().items()})
    out.update({f"mu.{n}": t.numpy() for n, t in zip(names, state.opt_state.mu)})
    out.update({f"nu.{n}": t.numpy() for n, t in zip(names, state.opt_state.nu)})
    out.update({f"ema.{n}": t.numpy() for n, t in state.ema.items()})
    return out


def steps_rank(rank: int, n: int, init_method: str, spec_path: str, out_dir: str) -> None:
    """Run every scenario of ``spec_path`` (a ``torch.save`` list) as rank
    ``rank`` of ``n`` CPU ranks; write ``<name>_r<rank>.npz``."""
    torch.set_num_threads(1)
    D.initialize(init_method, n, rank)
    mesh = D.make_global_mesh("cpu")
    D.barrier(mesh)
    for sc in torch.load(spec_path, weights_only=False):
        np.savez(Path(out_dir) / f"{sc['name']}_r{rank}.npz", **run_step(sc, mesh))


def load(out_dir, name: str, rank: int) -> dict:
    with np.load(Path(out_dir) / f"{name}_r{rank}.npz") as f:
        return {k: f[k] for k in f.files}


def trainer_config(**kw):
    from yolo_scratch_tpu_torch.train.trainer import TrainerConfig

    return TrainerConfig(epochs=1, lr=1e-3, val_conf=0.01, pre_nms_topk=64, max_det=20, **kw)


class ArrayDataset:
    """A map-style dataset over a list of (img, boxes xywh, labels) items."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def val_model():
    """The seed-0 crater YOLO11n with its class-bias priors zeroed (the
    prior alone puts every score near 1.6e-4, below any gate)."""
    model = build("yolo11")[0]
    with torch.no_grad():
        for cls in model.model[-1].cv3:
            cls[2].bias.zero_()
    return model


def self_labelled_val(model) -> list:
    """6 synthetic val images whose GT is 3 of ``model``'s own detections
    at conf 0.01 (so that validation finds true positives at init) plus one
    synthetic disk each."""
    from yolo_scratch_tpu_torch.data.synthetic import SyntheticDataset
    from yolo_scratch_tpu_torch.train.steps import make_eval_step

    items = [SyntheticDataset(n=14, img_size=64, seed=3)[i] for i in range(8, 14)]
    step = make_eval_step(model, conf_threshold=0.01, max_det=20, pre_nms_topk=64)
    boxes, _, labels, valid = step({"img": np.stack([it[0] for it in items]),
                                    "gt_labels": np.zeros((6, 1), np.int32),
                                    "gt_bboxes": np.zeros((6, 1, 4), np.float32),
                                    "gt_mask": np.zeros((6, 1), bool)})[1]
    out = []
    for i, (img, gt_boxes, gt_labels) in enumerate(items):
        b = boxes[i][valid[i]][:3].numpy()
        xywh = np.concatenate([(b[:, :2] + b[:, 2:]) / 2, b[:, 2:] - b[:, :2]], 1)
        out.append((img, np.concatenate([xywh, gt_boxes[:1]]).astype(np.float32),
                    np.concatenate([labels[i][valid[i]][:3].numpy(), gt_labels[:1]])
                    .astype(np.int32)))
    return out


def trainer_loaders(val_items=None):
    """8 synthetic train images in batches of 4; ``val_items`` in batches of
    4 (6 items: the second batch wrap-padded with 2 duplicates,
    ``sample_valid`` False)."""
    from yolo_scratch_tpu_torch.data.loader import Loader
    from yolo_scratch_tpu_torch.data.synthetic import SyntheticDataset

    ds = SyntheticDataset(n=8, img_size=64, channels=1, num_classes=5, seed=3)
    return (Loader(ds, 4, max_gt=8, shuffle=True, seed=0, prefetch=0),
            Loader(ArrayDataset(val_items), 4, max_gt=8, prefetch=0) if val_items else None)


def trainer_rank(rank: int, n: int, init_method: str, val_items) -> dict:
    """As a rank of ``n`` CPU ranks: validate :func:`val_model` on
    ``val_items`` through a sync-mode Trainer (device and host matching),
    then fit one epoch in local (DDP) mode. Returns the metrics and the
    history."""
    from yolo_scratch_tpu_torch.train.trainer import Trainer

    torch.set_num_threads(1)
    D.initialize(init_method, n, rank)
    mesh = D.make_global_mesh("cpu")
    D.barrier(mesh)
    out = {}
    for matching in (True, False):
        train, val = trainer_loaders(val_items)
        trainer = Trainer(val_model(), train, val, trainer_config(device_matching=matching),
                          mesh=mesh)
        out[f"val_{matching}"] = trainer.validate()
    train, val = trainer_loaders(val_items)
    trainer = Trainer(build("yolo11")[0], train, val, trainer_config(bn_mode="local"), mesh=mesh)
    out["fit_local"] = trainer.fit(resume=False)["history"]
    out["augmented"] = augmented_feeds(mesh)
    return out


def augmented_feeds(mesh) -> bool:
    """One augmented epoch (mosaic + mixup, 2 steps of 4 images) fed as
    ``--mesh`` feeds it (every rank the global batch) and as
    ``--multihost`` does (each process its 2 rows, the global batch
    gathered to augment it): whether the two runs end with the same
    parameters and BN statistics, exactly."""
    import dataclasses

    from yolo_scratch_tpu_torch.data.loader import Loader
    from yolo_scratch_tpu_torch.data.synthetic import SyntheticDataset
    from yolo_scratch_tpu_torch.train.trainer import Trainer

    ds = SyntheticDataset(n=8, img_size=64, channels=1, num_classes=5, seed=3)
    r = mesh.rank
    feeds = {"global": (Loader(ds, 4, max_gt=8, prefetch=0), mesh),
             "local": (Loader(ds, 2, max_gt=8, prefetch=0, indices=[2 * r, 2 * r + 1,
                                                                   4 + 2 * r, 5 + 2 * r]),
                       dataclasses.replace(mesh, process_local=True))}
    states = {}
    for name, (loader, m) in feeds.items():
        trainer = Trainer(build("yolo11")[0], loader, None, trainer_config(augment=AUGMENT),
                          mesh=m)
        trainer.train_epoch(0)
        states[name] = trainer.model.state_dict()
    return all(torch.equal(states["global"][k], states["local"][k]) for k in states["global"])


def card_val_rank(rank: int, n: int, init_method: str) -> dict:
    """As a rank of ``n`` sharing cuda:0 over gloo: this rank's rows of one
    validation batch through the mesh eval step (:func:`val_model`, 64 px,
    4 images). Returns kernel #1's launches in the step and whether its
    keep masks, and the step's detections, equal the plain sweep's."""
    from yolo_scratch_tpu_torch.data.loader import Loader
    from yolo_scratch_tpu_torch.data.synthetic import SyntheticDataset
    from yolo_scratch_tpu_torch.ops import nms_kernels as K
    from yolo_scratch_tpu_torch.ops.decode import _finish, select_candidates
    from yolo_scratch_tpu_torch.ops.matching import DEFAULT_THRESHOLDS
    from yolo_scratch_tpu_torch.train.steps import batch_to_device, make_eval_step

    D.initialize(init_method, n, rank)
    dev = torch.device("cuda", 0)
    mesh = D.make_global_mesh(dev)
    model = val_model().to(dev).eval()
    batch = next(iter(Loader(SyntheticDataset(n=4, img_size=64), 4, max_gt=8, prefetch=0)))
    step = make_eval_step(model, match_thresholds=DEFAULT_THRESHOLDS, mesh=mesh)
    b = batch_to_device(shard_batch(batch, mesh), dev)
    feats = step.forward(b)
    before = K.launches["nms_sweep_batched"]
    dets = step.from_feats(feats, b)[1]
    torch.cuda.synchronize()
    launched = K.launches["nms_sweep_batched"] - before
    with torch.inference_mode():
        boxes, scores, labels, valid, _ = select_candidates(
            feats, model.nc, model.strides, model.reg_max, 0.25, 2048)
        keep = K.nms_sweep_batched_plain(boxes, valid, 0.45)
        keep_kernel = K.nms_sweep_batched(boxes, valid, 0.45)
        ref = _finish(boxes, scores, labels, K._cap(keep, 300), 300, 64)
    return dict(transport=D.mesh_transport(mesh), launched=launched, swept=int(valid.sum()),
                keep_equal=torch.equal(keep_kernel, keep),
                dets_equal=all(torch.equal(g, r) for g, r in zip(dets, ref)))
