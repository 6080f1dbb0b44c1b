"""Training CLI (port of ``train/cli.py``): the JAX CLI's flags, with the same
names and defaults, except ``--device``, which selects the device and
defaults to ``cuda``; there is no fallback to the CPU.

Run: ``python -m yolo_scratch_tpu_torch.train.cli --data synthetic --scale n
--epochs 2 --ema --save-dir runs/t`` (on the card), or add ``--device cpu``.
The YOLOX recipe: ``--model yolox --scale s --mosaic 1.0 --mixup 1.0
--final-epochs 15``.

Data parallel (``parallel/``), one process a rank:

* ``--mesh N`` spawns N ranks on this host, rank r on ``cuda:(r % cards)``
  (or the CPU with ``--device cpu``). Each loads the same global batch of
  ``--batch`` images and trains its contiguous rows. The collectives go
  over NCCL when every rank has a card of its own, else over gloo (ranks
  sharing a card, or the CPU); the first line printed says which.
* ``--multihost --coordinator host:port --nproc N --pid i`` (or no
  coordinator under torchrun) joins a group of N processes; each reads its
  own slice of the data, ``--batch`` images a step.
* ``--bn-mode sync`` (default): BN and the loss over the global batch, the
  one-process step on it. ``--bn-mode local``: the DDP step (BN over each
  rank's rows, gradients averaged); without a mesh it warns and trains
  as sync.

Only rank 0 prints and writes; ``main`` returns after every rank has
joined and raises if any rank failed.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch.distributed as dist

from yolo_scratch_tpu_torch.data.coco import CocoDataset
from yolo_scratch_tpu_torch.data.crater import CraterDataset
from yolo_scratch_tpu_torch.data.synthetic import SyntheticDataset
from yolo_scratch_tpu_torch.models.builder import CONFIGS
from yolo_scratch_tpu_torch.parallel import distributed as D


def resolve_train_precision(arg):
    """CLI ``--train-precision`` -> ``TrainerConfig.train_matmul_precision``.
    Flag absent (None) -> the TrainerConfig default (``"high"``, which the
    step maps to TF32 off); ``default`` -> None (the backend's own flags)."""
    from yolo_scratch_tpu_torch.train.trainer import TrainerConfig

    if arg is None:
        return TrainerConfig.train_matmul_precision
    return None if arg == "default" else arg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train YOLO (PyTorch/CUDA)")
    p.add_argument("--data", type=str, default="synthetic",
                   help="crater data dir, COCO dir, or 'synthetic'")
    p.add_argument("--dataset", type=str, default="auto",
                   choices=["auto", "crater", "coco", "synthetic"])
    p.add_argument("--cfg", type=str, default=str(CONFIGS / "yolo11_crater.json"))
    p.add_argument("--model", type=str, default="yolo11", choices=["yolo11", "yolox"],
                   help="model family (yolox: --scale n|tiny|s|m|l|x, n = nano)")
    p.add_argument("--scale", type=str, default="s",
                   choices=["n", "s", "m", "l", "x", "nano", "tiny"])
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; no fallback when it is missing")
    p.add_argument("--workers", type=int, default=4,
                   help="loader prefetch depth AND per-batch decode threads")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight-decay", type=float, default=5e-4)
    p.add_argument("--val-split", type=float, default=0.2)
    p.add_argument("--save-dir", type=str, default="runs/train")
    p.add_argument("--pretrained", type=str, default=None,
                   help="warm-start weights: a checkpoint dir of the port or of the JAX "
                        "package, or a reference .pt (partial load, strict=False)")
    p.add_argument("--resume", action="store_true", default=True)
    p.add_argument("--no-resume", dest="resume", action="store_false")
    p.add_argument("--max-val-batches", type=int, default=None)
    p.add_argument("--val-conf", type=float, default=0.25)
    p.add_argument("--max-gt", type=int, default=100, help="static per-image GT capacity")
    p.add_argument("--ema", action="store_true", help="track EMA weights")
    p.add_argument("--mesh", type=int, default=0,
                   help="data-parallel size: ranks spawned on this host (0 = one device)")
    p.add_argument("--multiscale", action="store_true",
                   help="multi-scale training over bucketed sizes {0.75, 0.875, 1, 1.125}*imgsz")
    p.add_argument("--bf16", action="store_true",
                   help="mixed-precision training (bf16 autocast, f32 master weights)")
    p.add_argument("--train-precision", type=str, default=None,
                   choices=["default", "high", "highest"],
                   help="train-step precision: unset or 'high' or 'highest' = TF32 off "
                        "for matmuls and convolutions; 'default' = the backend's flags")
    p.add_argument("--remat", action="store_true",
                   help="gradient checkpointing (activation recompute)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="accumulate gradients over k microbatches per step "
                        "(--batch must be divisible by k)")
    p.add_argument("--bn-mode", type=str, default="sync", choices=["sync", "local"],
                   help="BatchNorm under --mesh: global-batch sync-BN or DDP per-replica")
    p.add_argument("--augment", action="store_true",
                   help="device-side augmentation (hflip + color jitter)")
    p.add_argument("--mosaic", type=float, default=0.0,
                   help="mosaic probability (implies --augment)")
    p.add_argument("--mixup", type=float, default=0.0,
                   help="mixup probability, applied after mosaic (YOLOX recipe; implies "
                        "--augment)")
    p.add_argument("--multihost", action="store_true",
                   help="multi-process training: join a torch.distributed group "
                        "(--coordinator/--nproc/--pid, or torchrun's environment), "
                        "each process on its own slice of the data")
    p.add_argument("--coordinator", type=str, default=None,
                   help="rendezvous host:port (or a tcp:// or file:// URL)")
    p.add_argument("--nproc", type=int, default=None)
    p.add_argument("--pid", type=int, default=None)
    p.add_argument("--final-epochs", type=int, default=0,
                   help="last-N-epochs no-aug phase (YOLOX recipe: mosaic off + L1 loss "
                        "on; the paper uses 15)")
    p.add_argument("--patience", type=int, default=0,
                   help="early stop after N epochs of val fitness (mAP50, -val-loss "
                        "fallback) below its running best; 0 = off")
    p.add_argument("--seed", type=int, default=42)
    return p


def make_datasets(args):
    """``args.data`` / ``args.dataset`` / ``args.imgsz`` -> (dataset, ch, nc):
    the synthetic set, a crater tree (``altitude*/longitude*/truth/
    detections.csv``) or a COCO directory (``annotations/instances*.json``
    or a top-level ``*.json``, images under ``images/`` or beside it)."""
    kind = args.dataset
    if kind == "auto":
        if args.data == "synthetic":
            kind = "synthetic"
        elif list(Path(args.data).glob("altitude*")):
            kind = "crater"
        else:
            kind = "coco"
    if kind == "synthetic":
        return SyntheticDataset(n=64, img_size=args.imgsz, channels=1, num_classes=5), 1, 5
    if kind == "crater":
        return CraterDataset(args.data, img_size=args.imgsz), 1, 5
    root = Path(args.data)
    anns = sorted(root.glob("annotations/instances*.json")) or sorted(root.glob("*.json"))
    if not anns:
        raise FileNotFoundError(f"no COCO annotations under {root}")
    img_dir = root / "images" if (root / "images").is_dir() else root
    sub = [d for d in img_dir.iterdir() if d.is_dir()]
    ds = CocoDataset(str(anns[0]), str(sub[0] if sub else img_dir), img_size=args.imgsz)
    return ds, 3, len(ds.class_names) or 80


def split_indices(n: int, seed: int, val_split: float):
    """(train, val) indices of a dataset of ``n``: the seeded split (the
    reference's torch.randperm(seed=42), with a numpy PRNG)."""
    idx = np.random.RandomState(seed).permutation(n)
    n_val = int(n * val_split)
    return idx[: n - n_val], idx[n - n_val:]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)

    if args.grad_accum < 1 or args.batch % args.grad_accum:
        raise SystemExit(f"--batch {args.batch} must be a positive multiple of "
                         f"--grad-accum {args.grad_accum}")
    if args.multihost:
        D.initialize(args.coordinator, args.nproc, args.pid)
        try:
            rank = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
            mesh = D.make_global_mesh(D.rank_device(rank, args.device), process_local=True)
            D.barrier(mesh)  # every process joined before the heavy work
            if mesh.is_writer:
                print(f"multihost: {mesh.size} processes over {D.mesh_transport(mesh)}, "
                      f"devices {' '.join(map(str, mesh.devices))}")
            return _train(args, mesh)
        finally:
            dist.destroy_process_group()
    if args.mesh > 1:
        if args.batch % (args.mesh * args.grad_accum):
            raise SystemExit(f"--batch {args.batch} must be a multiple of --mesh {args.mesh} "
                             f"x --grad-accum {args.grad_accum}")
        devices = D.device_map(args.mesh, args.device)
        print(f"mesh: {args.mesh} ranks over {D.transport(devices)}, devices "
              f"{' '.join(map(str, devices))}")
        with tempfile.TemporaryDirectory() as rdv:
            ranks = D.spawn_ranks(_mesh_rank, args.mesh, (argv, f"file://{rdv}/rendezvous"))
        return {**ranks[0]["fit"], "ranks": ranks}
    return _train(args, None)


def _mesh_rank(rank: int, argv, init_method: str) -> dict:
    """One rank of ``--mesh``: join the group, train, and return the fit's
    result with this process's kernel #1/#2 launch counts."""
    from yolo_scratch_tpu_torch.ops import nms_kernels

    args = build_parser().parse_args(argv)
    D.initialize(init_method, args.mesh, rank)
    mesh = D.make_global_mesh(D.rank_device(rank, args.device))
    D.barrier(mesh)
    fit = _train(args, mesh)
    return {"rank": rank, "fit": fit, "launches": dict(nms_kernels.launches)}


def _train(args, mesh):
    """Datasets, loaders, model and Trainer of ``args``; on a mesh this
    process is one rank (rank 0 alone prints)."""
    from yolo_scratch_tpu_torch.data.augment import AugmentConfig
    from yolo_scratch_tpu_torch.data.loader import Loader
    from yolo_scratch_tpu_torch.models.builder import build_yolo11
    from yolo_scratch_tpu_torch.models.yolox import build_yolox, scale_name
    from yolo_scratch_tpu_torch.train.trainer import Trainer, TrainerConfig
    from yolo_scratch_tpu_torch.utils.device import resolve_device

    say = print if mesh is None or mesh.is_writer else (lambda *a, **k: None)
    dev = resolve_device(args.device) if mesh is None else mesh.device
    ds, ch, nc = make_datasets(args)
    train_idx, val_idx = split_indices(len(ds), args.seed, args.val_split)
    if mesh is not None and mesh.process_local:
        # this process's slice, trimmed so every process steps the same
        # number of batches (each step is a collective)
        k_t, k_v = len(train_idx) // mesh.size, len(val_idx) // mesh.size
        if k_t == 0:
            raise ValueError(f"{len(train_idx)} train samples < {mesh.size} processes")
        train_idx = train_idx[D.process_slice(len(train_idx))][:k_t]
        val_idx = val_idx[D.process_slice(len(val_idx))][:k_v]
    say(f"Train samples: {len(train_idx)}, Val samples: {len(val_idx)}")

    ms_sizes = None
    if args.multiscale:
        # bucketed static shapes; each bucket divisible by 32 (P5 stride)
        ms_sizes = sorted({max(32, int(args.imgsz * f) // 32 * 32)
                           for f in (0.75, 0.875, 1.0, 1.125)})
        say(f"multi-scale buckets: {ms_sizes}")
    train_loader = Loader(ds, args.batch, max_gt=args.max_gt, shuffle=True, seed=args.seed,
                          indices=train_idx, prefetch=args.workers, workers=args.workers,
                          multiscale_sizes=ms_sizes)
    val_loader = (Loader(ds, args.batch, max_gt=args.max_gt, indices=val_idx,
                         prefetch=args.workers, workers=args.workers)
                  if len(val_idx) else None)

    if args.model == "yolox":
        yx = scale_name(args.scale)
        model = build_yolox(yx, nc=nc, ch=ch, seed=args.seed, device=dev)
        say(f"Building YOLOX-{yx} nc={nc} ch={ch} strides={model.strides} on {dev}")
    else:
        model = build_yolo11(args.cfg, ch=ch, nc=nc, scale=args.scale, seed=args.seed,
                             device=dev)
        say(f"Building {Path(args.cfg).name} scale={args.scale} nc={nc} ch={ch} "
            f"strides={model.strides} on {dev}")

    aug_cfg = None
    if args.augment or args.mosaic > 0 or args.mixup > 0:
        aug_cfg = AugmentConfig(mosaic_p=args.mosaic, mixup_p=args.mixup)

    cfg = TrainerConfig(
        epochs=args.epochs,
        lr=args.lr,
        weight_decay=args.weight_decay,
        val_conf=args.val_conf,
        max_val_batches=args.max_val_batches,
        save_dir=args.save_dir,
        use_ema=args.ema,
        eval_with_ema=args.ema,
        augment=aug_cfg,
        mixed_precision=args.bf16,
        remat=args.remat,
        grad_accum=args.grad_accum,
        train_matmul_precision=resolve_train_precision(args.train_precision),
        bn_mode=args.bn_mode,
        pretrained=args.pretrained,
        final_epochs=args.final_epochs,
        patience=args.patience,
    )
    try:
        trainer = Trainer(model, train_loader, val_loader, cfg, mesh=mesh, seed=args.seed,
                          model_kind=args.model)
        total = sum(p.numel() for p in model.parameters())
        say(f"Total parameters: {total:,} ({total / 1e6:.2f}M)")
        return trainer.fit(resume=args.resume)
    finally:
        train_loader.close()
        if val_loader is not None:
            val_loader.close()


def cli(argv=None):
    """Console-script entry: run main() and discard its return value."""
    main(argv)


if __name__ == "__main__":
    cli()
