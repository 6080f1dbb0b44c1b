#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and hold its hand-written
kernels against their plain PyTorch versions.

    python3 chip_smoke.py        # from the root of a checkout; needs one CUDA card

Phases (any failure raises and exits non-zero):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: nvcc builds the NMS and bottleneck libraries from
   ``yolo_scratch_tpu_torch/csrc``, one nvcc per source, started together
   with g++'s build of the host library (phase 16(a));
3. kernels: each NMS wrapper against its plain version on seeded boxes
   (exactly equal keep masks), with its device time per call (the IoU mask
   and reduce kernels summed, and each on its own), the plain version's
   time and its bound at the main path's shape, and at N=2048; and #1 at
   B=32/N=512 with no box valid, the main path's data at conf 0.25;
4. slice: YOLO11n at 640x640 (crater row ch=1/nc=5, COCO row ch=3/nc=80),
   seeded init, through ``Predictor.predict_batch`` at B=32. The launch
   counters are zeroed just before each path and read just after. Checks:
   (32, 300, 7) finite output; at conf 0 the Predictor's detections equal
   the same feats put through the plain sweep; ``postprocess`` at B=1
   (kernel #2) equals its plain version; the card's f32 forward equals the
   CPU's on two images; img/s per row;
5. bottleneck (kernel #3), its counter zeroed before each path and read
   after: (a) the probe's path, ``probe_fused_bottleneck.run_cases`` at its
   six shapes, bf16, B=32, plus f32 cases at C=128 and C=512; (b) the
   folded-Bottleneck contract: one Predictor-shaped forward of the folded
   bf16 YOLO11n (crater row, 640, B=32) with a hook on each of its 11
   ``Bottleneck``s, whose inputs go through ``fused_bottleneck`` on
   ``bottleneck_weights(module)`` and are held against the module's own
   output within 0.03 of max|ref|. Every case of (a) and (b) is held against
   ``bottleneck_plain`` by ``probe_fused_bottleneck.Case.check``: rtol 0.05
   (bf16) or 1e-5 (f32), atol the same times min(1, max|plain|), everywhere
   and on the border rows and columns, and the check must reject both zeros
   and x itself (a skipped branch). Then times: the
   kernel (profiler and CUDA events), the folded module on cuDNN (the
   library yardstick, f32 without TF32) and the plain version at each shape,
   beside the bound (f32: 3xTF32's, and the CUDA cores' beside it); the f32
   rows go into kernel #3's entry of the kernels line under ``f32``;
6. eval: the crater YOLO11n (seeded init, random BN statistics, zeroed
   class-bias priors, as ``tests/test_torch_infer.py`` builds it) in f32
   with TF32 off, through the eval step at 640, B=32, where kernel #1 sweeps
   the top 2048 candidates of each image. (a) ``val.main`` on the synthetic
   set, 2 batches, ``--per-class --coco-summary --torch-ckpt``, kernel #1's
   counter zeroed just before and read just after; the JSON must hold the
   JAX CLI's keys, all finite. (b) one batch: the step's detections equal
   the same maps put through ``nms_sweep_batched_plain`` exactly, and its
   marks (plain and per-class) equal ``batched_tp_marks`` run on the CPU
   on the same detections exactly. (c) the card's loss triplet equals the
   CPU's on two images, rtol 1e-4. (d) the step's img/s at B=32, its
   phases (H2D, forward, loss, select+NMS, marks) and its device busy share;
7. train: the crater YOLO11n (seeded init) at 640, f32 with TF32 off.
   (a) one train step on the card against the same step on the CPU, same
   weights, same B=2 batch (``compare_train_steps``): loss rtol 1e-4, each
   gradient within 1e-3 of max|g_cpu| (cuDNN's wgrad sums in another
   order), BN running variances rtol 1e-4 and means within 1e-5, the step
   counter, and parameters within the Adam direction's difference times the
   LR applied. (b) ``train.cli.main`` with ``--data synthetic --scale n
   --imgsz 640 --batch 16 --epochs 2 --ema``, kernel #1's counter zeroed
   just before and read just after: it must equal the val batches times
   the epochs run; then ``--epochs 3`` resumes at epoch 2 (the step counter
   2 x the train batches before, 3 x after); then ``val.main --ckpt --which
   last --ema``; every loss finite; one val batch's detections through the
   trained EMA weights equal the plain sweep's, at the trainer's conf 0.25
   and at conf 0 (every box valid). (c) the train step's phases (H2D,
   forward, loss, backward, clip+AdamW+EMA; medians of 5 between CUDA
   events), train img/s over back-to-back steps at B=16, and the device
   busy share (``torch.profiler``);
8. YOLOX-s at 640: device augmentation card vs CPU, the Predictor, val,
   one train step card vs CPU, ``train.cli.main`` with the YOLOX recipe and
   one epoch on a crater tree written with cv2;
9. deploy, on phase 6's crater YOLO11n: (a) ``int8_conv2d`` at each of
   YOLO11n's 34 distinct conv shapes at B=32, 640, bit-exact against its
   float64 plain version on the card and against the CPU's int32, its
   device ms beside cuDNN's bf16 conv; (b) the int8 Predictor (calibrated
   on 2 batches) at B=32: detections equal the plain sweep's, maps card vs
   CPU on the same quant buffers within ``INT8_CARD_CPU_TOL``, the share of
   the bf16 Predictor's detections it matches, img/s and busy share; (c)
   the bf16 and int8 Predictors exported, saved, loaded and run at B=32:
   output equal to the live Predictor's, kernel #1 launched through the
   ``yst`` op; (d) ``serve.main`` on 127.0.0.1:0 at ``--batch 8``, 64 PNG
   requests of varied sizes from 16 clients, every response equal to
   ``predict_paths``, a poisoned request failing alone, live and over a
   bf16 artifact; (e) ``infer.main --int8-calib 1`` on those PNGs, host
   prep through the port's native tier (phase 16).
   Kernel #1's counter is zeroed before each path and read after;
10. multi-GPU, on the crater YOLO11n at 640, f32 with TF32 off: (a) two
   ranks on the one card over gloo, the sync step at global B=4 against
   the one-process card step and the local step against the same two
   ranks on the CPU, each in deterministic mode; (b) a one-rank NCCL
   group's step equal to the plain step bit for bit; a val batch through
   the mesh eval step on every rank against the plain sweep; (c)
   ``train.cli.main --mesh 2`` (two epochs, a resumed third, a
   ``--bn-mode local`` epoch, ``val.main`` on rank 0's checkpoint); (d)
   ``Predictor.shard_over`` over two replicas at B=32 against unsharded
   Predictors at B=16; (e) (c) over NCCL and (d) across cards where there
   are two or more, else one line saying why not;
11. slice G: (a) the deploy CLIs on a checkpoint: a fresh one-epoch
   ``train.cli`` run (crater YOLO11n, 640, B=16, ``--ema``), then
   ``infer.main --ckpt DIR --which last`` at B=32, conf 0, IoU 0.45 over
   32 cv2-written PNGs, equal to ``infer.main --weights`` on the same raw
   ``state_dict`` exactly; the checkpoint's Predictor against the plain
   sweep; ``export.main --ckpt --conf 0 --check``, its artifact equal to
   the live Predictor; one ``serve.main --ckpt --conf 0`` request equal to
   ``predict_paths``. Conf 0, as a one-epoch model scores every anchor
   below 0.25: every compared image must hold a detection. (b) ``blocked_topk=32`` on phase 6's weights (every
   anchor above 0.25) at B=32: the card's selected indices equal the
   CPU's, kernel #1's detections the plain sweep's, and the number of
   images whose selection differs from the exact one. (c) the tiled sweep
   (``nms_impl="tiled"``, PyTorch ops) on phase 3's seeded boxes at B=32,
   N=512 and 2048: keep masks equal to kernel #1's and to the CPU tiled
   sweep's, its device ms beside kernel #1's; kernels #1 and #2 past the
   register reduce's 4096 boxes (``LONG_SWEEPS``: N=8400 at B=32 and at
   B=128, two chunks of scratch; 21,504 at B=32; 33,600 at B=1), each
   equal to the tiled sweep (and at N=8400, B=32 to the plain one), with
   its device ms beside the tiled sweep's, its bound and its scratch, and
   at N=8400 the pairwise sweep on one image; the Predictor at ``--topk
   8400``, conf 0, B=32 (crater), equal to the plain sweep, and
   ``export.main --topk 8400``'s artifact equal to it, each launching
   kernel #1 once. (d) ``dga_nms_device`` card
   against CPU: the dGA matrix within 1e-6, keep sets exact. (e) the legacy
   model at width_mult 1.15, 640, f32 with TF32 off, deterministic: the
   forward, ``legacy_yolo_loss`` plus the crater losses (the angular
   coverage on a disk-masked map, so that some bins and not all fall under
   its threshold), the backward, card against CPU on 2 images within phase
   7's limits, and the ms of each at B=16. (f) ``model_info`` of YOLO11n and YOLOX-s: parameters equal to the
   CPU's, GFLOPs. Kernel #1's counter is zeroed before each main path of
   (a) and (b) and read after;
12. slice H: (a) the crater YOLO11n at 640, B=16: one step of a ``flat_opt``
   state against one of the per-leaf state from the same weights on the
   same batch, deterministic, TF32 off, within phase 7(a)'s limits; each
   form's step phases, and the flat update with its gradients gathered by
   a multi-tensor copy against gradients bound to the flat buffer. (b)
   ``save_epoch``'s stall, synchronous against background, and the
   background write's ms, for the YOLO11n and YOLOX-s trees; ``train.cli``
   for 2 epochs (background writes; whole files, no ``.tmp``) and its
   resume to epoch 3; a ``flat_opt`` state resumed from that ``last``,
   trained one epoch and saved in the background, and ``val --ckpt --ema``
   of its checkpoint equal to the same state re-saved per-leaf. (c)
   ``overfit_check`` for 150 epochs, YOLO11n f32, YOLO11n bf16 and
   YOLOX-nano: mAP50 at least 0.85 / 0.85 / 0.70, and one val batch of each
   trained model through the eval step equal to the plain sweep on the same
   candidates, with a detection. (d) ``train.cli --imgsz 320 --ema`` for 90
   epochs, then ``eval_quant`` on its ``last``: the bf16 mAP50 above 0 on
   the 12 val images and on 384 held-out synthetic images, int8 within 0.05
   of it on the 384 (the spread over 4 disjoint sets of 96); one val
   batch of each Predictor (B=8, K=512, class-aware) equal to the plain
   sweep, with a detection. Kernel #1's counter
   is zeroed before each main path and read after.
13. slice I, the measurement entry points (``yolo_scratch_tpu_torch/bench/``
   and ``entry.py``), each bench's JSON line printed as it ends, kernel #1's
   counter zeroed just before each bench and read just after: (a)
   ``entry()``'s f32 forward + decode at 640 on the card against the CPU,
   boxes and scores each within 1e-4 of max|ref|; (b) the headline
   (``python -m yolo_scratch_tpu_torch.bench``) at its defaults, B=128, both
   rows, nscan 8, 2 windows of its 3: kernel #1's launches equal the batches
   it swept; (c) one B=128 batch of its program at conf 0 per row equal to
   the same maps through the plain sweep, exactly; (d) ``BENCH_INT8=1`` on
   the crater row (nscan 2, one window); (e) ``latency``, ``scale`` (YOLOX-s,
   YOLO11s), ``breakdown`` (5 calls a window), ``export`` (nscan 2),
   ``int8_scales --scales m`` (B=32, nscan 1), ``e2e`` (64 files), one
   ``serving`` cell (16 clients, 5 ms, 5 s; no failed request), ``eval`` (512
   images of a COCO-shaped model whose scores pass 0.001, its ground truth
   near its detections: the device's TP marks accumulated as the host
   accumulates give the host matcher's mAP50-95 exactly, above 0, and
   ``metrics_from_marks`` gives it too unless a TP and an FP share a score,
   which the two accumulations order differently); ``ingest`` runs in 16(d);
14. slice J, the JAX repo's last tools, kernel #1's counter zeroed just
   before each path and read just after: (a) ``gen_crater_synth`` and
   ``gen_coco_synth`` (nc=80) write 32 images each at 640, which
   ``data/crater.py`` and ``data/coco.py`` read back; ``train.cli`` on the
   COCO tree at 320, B=16, 2 epochs, plain and with mosaic + mixup: kernel
   #1's launches equal the val batches times the epochs; (b)
   ``quant_sqnr`` at 640, B=4, on the card and with ``--cpu``: the same
   blocks, each SQNR within 1.5 dB and their mean difference within 0.1
   dB (a 1e-6 jitter of the weights moves the CPU's by up to 0.9 dB); (c) ``profile_forward`` at B=128, 640,
   plain and ``--full``: kernel #1 launched once a call (warm-up and
   profiled), ``parse_trace``'s kernel total within 1% of
   ``profile_forward``'s and its trace holding one sweep a profiled call;
   one ``--full`` batch at conf 0 equal to the plain sweep, with
   detections; (d) ``profile_train`` at B=64, 640, bf16, ``--scan 5``, then
   ``train_roofline`` (device kernels, shares summing to 100% within 0.1,
   a positive whole-step span) and ``parse_trace`` on its trace; (e)
   ``ab_report`` on (a)'s two runs.
15. slice K, a JAX run directory on the card: the committed fixture
   ``tests/fixtures/jax_ckpt/`` (the JAX package's ``save_epoch`` of a
   narrow crater YOLO11 after two train steps, EMA on: per-leaf orbax,
   ``flat_opt`` orbax and the npz fallback; this machine has no JAX to
   write one). (a) g++ builds the port's zstd decoder, which links no
   libzstd; (b) every leaf of every form read by the port's own code
   (OCDBT, zarr v2, zstd) equals its sha256, dtype and shape in
   ``digests.json``; (c) ``load_deploy_model(ckpt=<fixture>)`` through
   ``Predictor.predict_batch`` at 640, B=32, conf 0, kernel #1's counter
   zeroed just before and read just after: the detections equal the same
   feats through the plain sweep, and the card's f32 forward equals the
   CPU's; (d) ``Trainer.fit(resume=True)`` on a copy of the per-leaf run
   directory, one epoch at 640, B=16 on synthetic data: the resumed
   weights, EMA, moments, count and step equal the port tree read in (b),
   training starts at the fixture's epoch + 1, and kernel #1 launches in
   its validation; (e) the reader's ms on each form and the decoder's MB/s
   on this host (host code).
16. slice L, the port's own host tier (``csrc/yst_host.cpp`` with its
   inflate, PNG and JPEG decoders; no codec library): (a) the library's
   first build (phase 2), its ``ldd`` (no libpng, libjpeg or zlib), and the
   package's load, which must succeed (no silent cv2 tier); (b) the
   decoder against ``cv2.imdecode`` byte for byte on PNGs (gray, RGB) and
   baseline/progressive JPEGs written by cv2 and PIL, at full size and at
   ``IMREAD_REDUCED_*_2/4/8`` (scale_num 4, 2, 1); every committed fixture
   of ``tests/fixtures/host_codecs`` (arithmetic-coded JPEGs, progressive
   ones cut short, PNGs with gAMA/sRGB/cHRM/iCCP/sBIT), each cut, channels
   1 and 3 and scale_num 8/5/4/2/1, equal to the libjpeg-turbo/libpng
   decode's sha256 in its ``digests.json``; the host decode ms of an
   arithmetic-coded 1024x768 JPEG against its Huffman source (full size,
   5/8) and of a block-smoothed cut progressive one; (c) ``predict_paths``
   at 640, B=32, conf 0 on both rows for 64 PNGs, 64 JPEGs, the JPEGs with
   ``fast_jpeg``, and 64 paths cycling the four arithmetic-coded fixtures
   with and without ``fast_jpeg``, kernel #1's counter zeroed just before
   each and read just after (one launch a batch); the first batch's
   detections equal the plain sweep on the same feats and predict_paths'
   own results; the native batch within 2/255 of the cv2 tier's (PNG,
   full-size JPEG), and an arithmetic fixture's batch equal to its Huffman
   source's; (d)
   ``bench.ingest`` (16 files) with its native rows, and phase 13's
   ``bench.e2e`` line (64 files) on the native tier, beside the card's name
   and power limit and the host's CPU.

The second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA GPU it prints no result
and exits 1.
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import cv2
import numpy as np
import torch
import torch.nn.functional as F

from yolo_scratch_tpu_torch import entry as ENTRY
from yolo_scratch_tpu_torch import probe_fused_bottleneck as P
from yolo_scratch_tpu_torch.bench import breakdown as BREAK
from yolo_scratch_tpu_torch.bench import common as BC
from yolo_scratch_tpu_torch.bench import e2e as E2E
from yolo_scratch_tpu_torch.bench import eval as EVB
from yolo_scratch_tpu_torch.bench import export as BEXP
from yolo_scratch_tpu_torch.bench import headline as HL
from yolo_scratch_tpu_torch.bench import ingest as ING
from yolo_scratch_tpu_torch.bench import int8_scales as I8S
from yolo_scratch_tpu_torch.bench import latency as LAT
from yolo_scratch_tpu_torch.bench import scale as SCALE
from yolo_scratch_tpu_torch.bench import serving as SERVE_B
from yolo_scratch_tpu_torch.infer import (
    Predictor,
    PredictorConfig,
    load_deploy_model,
    pack_detections,
)
from yolo_scratch_tpu_torch.data.augment import (
    AugmentConfig,
    apply_augment,
    augment_batch,
    batch_generator,
    draw_augment,
)
from yolo_scratch_tpu_torch.data.loader import Loader
from yolo_scratch_tpu_torch.data.synthetic import SyntheticDataset
from yolo_scratch_tpu_torch.losses.simota import YOLOXLossConfig
from yolo_scratch_tpu_torch.losses.v8_loss import DetectionLossConfig
from yolo_scratch_tpu_torch.models.builder import CONFIGS, build_yolo11
from yolo_scratch_tpu_torch.models.yolox import build_yolox, yolox_eval_decode
from yolo_scratch_tpu_torch.nn.fuse import bottleneck_weights
from yolo_scratch_tpu_torch.nn.modules import Bottleneck, detect_decode
from yolo_scratch_tpu_torch.ops import conv_kernels as CK
from yolo_scratch_tpu_torch.ops import nms_kernels as K
from yolo_scratch_tpu_torch.ops.decode import (
    _finish,
    _prefilter_batched,
    postprocess,
    postprocess_from_feats,
    select_candidates,
)
from yolo_scratch_tpu_torch.ops.matching import DEFAULT_THRESHOLDS, batched_tp_marks
from yolo_scratch_tpu_torch.parallel import distributed as D
from yolo_scratch_tpu_torch.parallel.distributed import mesh_transport
from yolo_scratch_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch
from yolo_scratch_tpu_torch.train.checkpoints import CheckpointManager
from yolo_scratch_tpu_torch.train.optim import cosine_epoch_schedule, make_optimizer
from yolo_scratch_tpu_torch.train.state import create_train_state
from yolo_scratch_tpu_torch.train.steps import (
    batch_to_device,
    build_train_step_custom,
    make_eval_step,
    precision_scope,
    v8_loss_adapter,
    yolox_loss_adapter,
)
from yolo_scratch_tpu_torch.utils.build import BUILD_DIR
from yolo_scratch_tpu_torch.utils.cuda_timing import (
    call_ms,
    device_ms,
    device_profile,
    ranges_ms,
    time_ms,
)

# H100 SXM data-sheet peaks (NVIDIA, dense, at 700 W): HBM bytes/s and
# f32 (non-tensor-core) FLOP/s. The NMS sweep is f32 compare/divide work.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# f32 operations per IoU test in the sweep: 4 min/max + 2 sub + 2 clamp for
# the overlap, 1 mul, 3 add/sub for the union, 1 div, 1 compare
OPS_PER_IOU = 14
IOU = 0.45
BATCH, IMGSZ = 32, 640  # the Predictor's defaults: the main path's shape
HEADLINE_B = 128  # the headline bench's batch (bench.py's)
# the kernels one NMS wrapper call launches: the IoU mask, then the reduce
NMS_SYMBOLS = ("nms_iou_mask_kernel", "nms_reduce_kernel")

KERNELS = {
    "nms_sweep_batched": dict(
        source="yolo_scratch_tpu_torch/csrc/nms_sweep.cu",
        replaces="yolo_scratch_tpu/ops/pallas_nms.py:102",
        symbol=NMS_SYMBOLS, plain=K.nms_sweep_batched_plain),
    "nms_sweep": dict(
        source="yolo_scratch_tpu_torch/csrc/nms_sweep.cu",
        replaces="yolo_scratch_tpu/ops/pallas_nms.py:27",
        symbol=NMS_SYMBOLS, plain=K.nms_sweep_plain),
    "fused_bottleneck": dict(
        source="yolo_scratch_tpu_torch/csrc/fused_bottleneck.cu",
        replaces="yolo_scratch_tpu/ops/pallas_conv.py:81",
        symbol="fused_bottleneck_kernel", plain=CK.bottleneck_plain),
}
# kernel #3's row in the table: the probe's 80x80x128 bf16 shape at B=32,
# with the f32 kernel's rows (3xTF32) under its "f32" key
BNECK_ROW = "p3_s_128"
BNECK_F32 = [("f32_p3_128", 80, 128, 128), ("f32_p5_512", 20, 512, 512)]
ROWS = [("crater", "yolo11_crater.json", 1, 5), ("coco", "yolo11_coco.json", 3, 80)]


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_identity() -> str:
    """``name, power.limit`` as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def seeded_boxes(seed: int, shape, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Detection-like candidates on a 640 canvas: boxes (..., 4) xyxy f32,
    valid (...) bool (~90% valid)."""
    rng = np.random.RandomState(seed)
    c = rng.uniform(0, 640, (*shape, 2))
    wh = rng.uniform(4, 160, (*shape, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    valid = rng.rand(*shape) > 0.1
    return torch.from_numpy(boxes).to(device), torch.from_numpy(valid).to(device)


def bound(keep: torch.Tensor, n: int) -> tuple[float, str]:
    """Least time for the sweep on these inputs: bytes (boxes + valid in,
    keep out, each once) over HBM rate vs the IoU tests this data needs
    (every kept pivot i tests the n-1-i boxes after it) over f32 peak."""
    keep2 = keep.reshape(-1, n)
    nbytes = keep2.numel() * (16 + 1 + 1)
    pos = torch.arange(n, device=keep.device)
    ious = int(((n - 1 - pos) * keep2).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ious * OPS_PER_IOU / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(dev) -> dict:
    """Each kernel vs its plain version; timed at the main path's shape
    (B=32/N=512 and B=1/N=512) and at N=2048, on seeded boxes ~90% valid,
    and at B=32/N=512 with none valid, as the main path's seeded model
    gives at conf 0.25; and #1 at the headline bench's B=128/N=512, ~90%
    and none valid."""
    results = {}
    cases = [("nms_sweep_batched", (32, 512)), ("nms_sweep_batched", (32, 2048)),
             ("nms_sweep", (512,)), ("nms_sweep", (2048,)), ("nms_sweep_batched", (32, 512)),
             ("nms_sweep_batched", (HEADLINE_B, 512)), ("nms_sweep_batched", (HEADLINE_B, 512))]
    for i, (name, shape) in enumerate(cases):
        spec = KERNELS[name]
        wrapper = getattr(K, name)
        boxes, valid = seeded_boxes(100 + i, shape, dev)
        none_valid = i in (4, 6)
        if none_valid:
            valid = torch.zeros_like(valid)
        got = wrapper(boxes, valid, IOU)
        ref = spec["plain"](boxes, valid, IOU)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"{name} {shape}: kernel keep mask differs from the plain "
                                 f"version in {int((got != ref).sum())} places")
        err = float((got.float() - ref.float()).abs().max())
        ms, split = call_ms(lambda: wrapper(boxes, valid, IOU), spec["symbol"])
        wall_ms = time_ms(lambda: wrapper(boxes, valid, IOU), reps=50)
        plain_ms = time_ms(lambda: spec["plain"](boxes, valid, IOU), reps=1, windows=3)
        bound_ms, bound_by = bound(got, shape[-1])
        log(f"kernel {name} shape={shape}{' none valid' if none_valid else ''}: exact "
            f"(max_abs_err {err}), kept {int(got.sum())}, "
            f"{ms:.4f} ms on the card per call (mask {split[NMS_SYMBOLS[0]]:.4f} + reduce "
            f"{split[NMS_SYMBOLS[1]]:.4f}), {wall_ms:.4f} ms per wrapper call, "
            f"{plain_ms:.2f} ms plain, bound {bound_ms:.6f} ms "
            f"({bound_by}); no single PyTorch call computes greedy NMS, so no library "
            f"yardstick")
        if shape in ((BATCH, 512), (512,)) and not none_valid:  # the Predictor's shapes
            results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    return results


def check_packed(packed: torch.Tensor, B: int, max_det: int) -> None:
    if tuple(packed.shape) != (B, max_det, 7):
        raise AssertionError(f"packed shape {tuple(packed.shape)}")
    if not torch.isfinite(packed).all():
        raise AssertionError("non-finite detections")


def plain_packed(pred: Predictor, feats) -> torch.Tensor:
    """The Predictor's postprocess with the plain sweep in place of kernel #1."""
    cfg, m = pred.cfg, pred.model
    boxes, scores, labels, valid, _ = select_candidates(
        feats, m.nc, m.strides, m.reg_max, cfg.conf_threshold, cfg.pre_nms_topk,
        cfg.blocked_topk)
    nms_boxes = K._class_offset(boxes, labels) if cfg.class_aware_nms else boxes
    keep = K._cap(K.nms_sweep_batched_plain(nms_boxes, valid, cfg.iou_threshold), cfg.max_det)
    return pack_detections(*_finish(boxes, scores, labels, keep, cfg.max_det, cfg.img_size))


def forward_check(name: str, model, x: np.ndarray, dev) -> None:
    """The card's f32 forward (TF32 off) against the CPU's on the same
    weights and images: raw Detect maps within ``1e-4 * max|ref|``, the f32
    tolerance of tests/test_torch_model.py (sums run in other orders on the
    two devices). Also reports how far the bf16 deploy forward lies from
    the CPU's f32 maps."""
    f32 = PredictorConfig(img_size=IMGSZ, batch_size=len(x), bf16=False)
    ref = Predictor(model, f32, device="cpu").forward_feats(x)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = Predictor(model, f32, device=dev).forward_feats(x)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    bf16 = Predictor(model, PredictorConfig(img_size=IMGSZ, batch_size=len(x)),
                     device=dev).forward_feats(x)
    errs, bf16_errs = [], []
    for g, b, r in zip(got, bf16, ref):
        scale = float(r.abs().max())
        errs.append(float((g.cpu() - r).abs().max()) / scale)
        bf16_errs.append(float((b.float().cpu() - r).abs().max()) / scale)
        if tuple(g.shape) != tuple(r.shape) or errs[-1] > 1e-4:
            raise AssertionError(f"{name}: card f32 maps {tuple(g.shape)} differ from the "
                                 f"CPU's {tuple(r.shape)} by {errs[-1]:.3g} of max|ref|")
    log(f"{name}: card f32 forward equals the CPU's to {max(errs):.3g} of max|ref| "
        f"(limit 1e-4) on {len(x)} images; bf16 deploy forward within "
        f"{max(bf16_errs):.3g} of max|ref|")


def slice_phase(dev, ident: str) -> dict:
    B, S = BATCH, IMGSZ
    batches = {ch: [np.random.RandomState(10 * ch + i).randint(0, 256, (B, S, S, ch),
                                                               dtype=np.uint8)
                    for i in range(3)] for ch in (1, 3)}
    models = {name: load_deploy_model(CONFIGS / cfg, scale="n", ch=ch, nc=nc, seed=0,
                                      device=dev) for name, cfg, ch, nc in ROWS}
    cfg = PredictorConfig(img_size=S, batch_size=B)
    predictors = {name: Predictor(models[name], cfg, device=dev) for name, *_ in ROWS}

    # main path: Predictor.predict_batch on both rows, counts zeroed just before
    K.reset_launches()
    for name, _, ch, _ in ROWS:
        for x in batches[ch]:
            packed = predictors[name].predict_batch(x)
            check_packed(packed, B, 300)
    torch.cuda.synchronize()
    main_launches = dict(K.launches)
    log(f"main path (predict_batch, 2 rows x 3 batches of {B}): launches {main_launches}")
    if main_launches["nms_sweep_batched"] == 0:
        raise AssertionError("the main path never launched the batched NMS kernel")

    # conf 0: the sweep does real work; kernel path == plain path on the same feats
    for name, _, ch, _ in ROWS:
        pred0 = Predictor(models[name], PredictorConfig(img_size=S, batch_size=B,
                                                        conf_threshold=0.0), device=dev)
        with torch.inference_mode():
            feats = pred0.forward_feats(batches[ch][0])
            got, ref = pred0.postprocess_feats(feats), plain_packed(pred0, feats)
        check_packed(got, B, 300)
        if not torch.equal(got, ref):
            raise AssertionError(f"{name}: conf-0 detections differ from the plain sweep")
        log(f"{name}: conf=0 detections equal the plain sweep's "
            f"({int(got[..., 6].sum())} kept over {B} images)")

    # B=1 path: postprocess(detect_decode(feats)) takes kernel #2
    pred = predictors["crater"]
    with torch.inference_mode():
        feats1 = pred.forward_feats(batches[1][0][:1])
        decoded = detect_decode(feats1, pred.model.nc, pred.model.strides)
        K.reset_launches()
        got = postprocess(decoded, S, conf_threshold=0.0, pre_nms_topk=512, nms_impl="kernel")
        torch.cuda.synchronize()
        b1_launches = dict(K.launches)
        boxes, scores, labels, valid = _prefilter_batched(decoded, 0.0, 512)
        keep = K._cap(K.nms_sweep_plain(boxes[0], valid[0], IOU)[None], 300)
        ref = _finish(boxes, scores, labels, keep, 300, S)
    log(f"B=1 postprocess path: launches {b1_launches}")
    if b1_launches["nms_sweep"] == 0:
        raise AssertionError("postprocess at B=1 never launched the single-image kernel")
    if not all(torch.equal(g, r) for g, r in zip(got, ref)):
        raise AssertionError("B=1 postprocess differs from the plain sweep")

    for name, _, ch, _ in ROWS:
        forward_check(name, models[name], batches[ch][1][:2], dev)

    # throughput: host uint8 batch in -> packed detections on the device
    rates = {}
    for name, _, ch, _ in ROWS:
        p, xs = predictors[name], batches[ch]
        p.predict_batch(xs[0])
        torch.cuda.synchronize()
        n = 10
        t0 = time.perf_counter()
        for i in range(n):
            p.predict_batch(xs[i % len(xs)])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rates[name] = B * n / dt
        log(f"{name} row: {rates[name]:.1f} img/s at B={B}, {S}x{S}, "
            f"{dt / n * 1e3:.2f} ms/batch (bf16, BN folded, conf 0.25) on {ident}")
    return dict(main=main_launches, b1=b1_launches, rates=rates)


def yolo11n_bottlenecks(dev) -> list:
    """One Predictor-shaped forward of the folded bf16 YOLO11n (crater row,
    640, B=32), with a hook capturing (module, input, output) of each
    ``Bottleneck``."""
    model = load_deploy_model(CONFIGS / "yolo11_crater.json", scale="n", ch=1, nc=5, seed=0,
                              device=dev)
    pred = Predictor(model, PredictorConfig(img_size=IMGSZ, batch_size=BATCH), device=dev)
    seen = []
    hooks = [m.register_forward_hook(lambda mod, inp, out: seen.append((mod, inp[0], out)))
             for m in pred.model.modules() if isinstance(m, Bottleneck)]
    try:
        x = np.random.RandomState(7).randint(0, 256, (BATCH, IMGSZ, IMGSZ, 1), dtype=np.uint8)
        pred.forward_feats(x)
    finally:
        for h in hooks:
            h.remove()
    return seen


def bottleneck_phase(dev, ident: str) -> dict:
    """Kernel #3 on the probe's path and on YOLO11n's bottlenecks."""
    # (a) + (c): the probe's path, bf16 at the Predictor's batch, and f32
    CK.reset_launches()
    cases = P.run_cases(BATCH, torch.bfloat16, dev)
    f32_cases = P.run_cases(BATCH, torch.float32, dev, shapes=BNECK_F32, seed=1)
    torch.cuda.synchronize()
    probe_launches = CK.launches["fused_bottleneck"]
    log(f"bottleneck probe path (6 bf16 + 2 f32 shapes, B={BATCH}): launches {probe_launches}")
    if probe_launches == 0:
        raise AssertionError("the probe path never launched the bottleneck kernel")
    for case in cases + f32_cases:
        case.check()
        x = case.inputs[0]
        log(f"bottleneck {case.name} {tuple(x.shape)} {x.dtype}: max|d| {case.err:.4g} "
            f"(border {case.border_err():.4g}; rtol {P.tolerance(x.dtype):.3g}, atol "
            f"{case.atol:.3g})")

    # (b): the folded-Bottleneck contract at YOLO11n's widths
    CK.reset_launches()
    seen = yolo11n_bottlenecks(dev)
    contract = []  # (case, the module's own output, NHWC)
    with torch.inference_mode():
        for mod, xin, out in seen:
            # a C2f bottleneck's input is a channel slice: NHWC needs a copy
            x = xin.permute(0, 2, 3, 1).contiguous()
            w = bottleneck_weights(mod)
            case = P.Case(f"yolo11n_{x.shape[-1]}@{x.shape[1]}", (x, *w),
                          CK.fused_bottleneck(x, *w), CK.bottleneck_plain(x, *w))
            contract.append((case, out.permute(0, 2, 3, 1)))
    torch.cuda.synchronize()
    contract_launches = CK.launches["fused_bottleneck"]
    log(f"YOLO11n contract (folded crater n, 640, B={BATCH}): {len(seen)} bottlenecks, "
        f"launches {contract_launches}")
    if contract_launches == 0 or len(seen) != 11:
        raise AssertionError(f"the contract launched the kernel {contract_launches} times "
                             f"over {len(seen)} bottlenecks; want 11")
    for case, module_out in contract:
        case.check()
        ref = module_out.float()
        rel = P.max_abs(case.got, ref) / float(ref.abs().max())
        x = case.inputs[0]
        log(f"bottleneck {case.name}: max|plain| {float(case.ref.float().abs().max()):.4g}, "
            f"max|plain - x| {P.max_abs(case.ref, x):.4g}; max|d| {case.err:.4g} vs plain "
            f"(border {case.border_err():.4g}; rtol 0.05, atol {case.atol:.3g}), {rel:.4g} of "
            f"max|ref| vs the folded module (limit 0.03)")
        if rel > 0.03:
            raise AssertionError(f"{case.name}: kernel differs from the folded module by "
                                 f"{rel:.3g} of max|ref|")

    # times, after the counts were read
    row, f32_rows = None, []
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for case in cases + f32_cases:
        t = P.time_case(case)
        core = (f", CUDA cores' bound {t['cuda_core_bound_ms']:.4f} ms"
                if "cuda_core_bound_ms" in t else "")
        log(f"bottleneck {case.name} B={BATCH} {case.got.dtype}: kernel {t['ms']:.4f} ms "
            f"({t['event_ms']:.4f} ms by CUDA events, a call with its weight prep), "
            f"cuDNN folded module {t['library_ms']:.4f} ms, plain {t['plain_ms']:.3f} ms, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}{core}), {t['share']:.3f} of "
            f"bound, on {ident}")
        if case.name == BNECK_ROW:
            row = dict(max_abs_err=case.err, **{k: t[k] for k in keys})
        if case.got.dtype == torch.float32:
            f32_rows.append(dict(shape=case.name, max_abs_err=case.err,
                                 **{k: t[k] for k in keys + ("event_ms", "cuda_core_bound_ms")}))
    row["f32"] = f32_rows  # the f32 kernel (3xTF32) beside the bf16 row
    shapes = {}
    for case, _ in contract:
        shapes.setdefault(case.name, case)
    for name, case in shapes.items():
        t = P.time_case(case)
        log(f"bottleneck {name} B={BATCH} bf16: kernel {t['ms']:.4f} ms, cuDNN folded module "
            f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
            f"{t['share']:.3f} of bound")
    return dict(row=row, launches=probe_launches + contract_launches)


# the eval path (phase 6): the step's candidate cap and batch, and the keys
# the JAX package's val CLI prints for --per-class --coco-summary at nc=5
EVAL_TOPK, EVAL_BATCHES = 2048, 2
EVAL_KEYS = (["loss", "precision", "recall", "mAP50", "mAP50-95"]
             + [f"class/{c}/{k}" for c in range(5)
                for k in ("AP50", "AP50-95", "precision", "recall")]
             + [f"coco/{k}" for k in ("AP", "AP50", "AP75", "AR@1", "AR@10", "AR@100")]
             + [f"coco/{k}_{band}" for band in ("small", "medium", "large")
                for k in ("AP", "AR@100")]
             + [f"coco/{k}" for k in ("AP_strict", "AP50_strict", "AP75_strict",
                                      "classes_evaluated")])
LOSS_KEYS = ("loss", "box_loss", "cls_loss", "dfl_loss")


def eval_model(cfg: str = "yolo11_crater.json", ch: int = 1, nc: int = 5):
    """The crater YOLO11n as tests/test_torch_infer.py builds it (or another
    config's): seeded init, random BN statistics, class-bias priors zeroed
    (the prior alone puts every score near 1.6e-4, below any gate)."""
    model = build_yolo11(CONFIGS / cfg, ch=ch, nc=nc, scale="n", seed=7)
    rng = np.random.RandomState(7)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                for t, v in ((m.weight, rng.uniform(0.3, 0.8, n)), (m.bias, rng.normal(0, 0.2, n)),
                             (m.running_mean, rng.normal(0, 0.1, n)),
                             (m.running_var, rng.uniform(0.5, 1.5, n))):
                    t.copy_(torch.from_numpy(v.astype(np.float32)))
        for cls in model.model[-1].cv3:
            cls[2].bias.zero_()
    return model.eval()


def eval_phase_times(step, batch, reps: int = 5) -> dict:
    """Median ms of each phase of one eval step, run in sequence between
    CUDA events (so a phase includes the device's waits for the host)."""
    names = ["h2d", "forward", "loss", "select_nms", "marks"]
    samples = {n: [] for n in names}
    m = step.model
    for _ in range(reps + 1):  # the first pass warms up
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        ev[0].record()
        b = batch_to_device(batch, step.device)
        ev[1].record()
        feats = step.forward(b)
        ev[2].record()
        with precision_scope("highest"), torch.inference_mode():
            step.loss_fn(feats, b)
            ev[3].record()
            boxes, _, labels, valid, _ = postprocess_from_feats(
                feats, nc=m.nc, strides=m.strides, reg_max=m.reg_max, img_size=IMGSZ,
                pre_nms_topk=EVAL_TOPK, with_cand_count=True, nms_impl="kernel")
            ev[4].record()
            batched_tp_marks(boxes, valid, b["gt_bboxes"], b["gt_mask"], DEFAULT_THRESHOLDS)
            batched_tp_marks(boxes, valid, b["gt_bboxes"], b["gt_mask"], DEFAULT_THRESHOLDS,
                             pred_labels=labels, gt_labels=b["gt_labels"])
            ev[5].record()
        torch.cuda.synchronize()
        for i, n in enumerate(names):
            samples[n].append(ev[i].elapsed_time(ev[i + 1]))
    return {n: statistics.median(v[1:]) for n, v in samples.items()}


def eval_phase(dev, ident: str) -> dict:
    """The eval path: val.main, then one batch held against the plain sweep
    and the CPU, then times."""
    from yolo_scratch_tpu_torch import val

    B = BATCH
    weights = BUILD_DIR / "eval_smoke_weights.pt"
    weights.parent.mkdir(parents=True, exist_ok=True)
    torch.save(eval_model().state_dict(), weights)

    # (a) the entry point a user calls, counts zeroed just before
    K.reset_launches()
    t0 = time.perf_counter()
    out = val.main(["--data", "synthetic", "--imgsz", str(IMGSZ), "--batch", str(B),
                    "--max-batches", str(EVAL_BATCHES), "--per-class", "--coco-summary",
                    "--torch-ckpt", str(weights)])
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    launches = K.launches["nms_sweep_batched"]
    log(f"eval path (val.main, {EVAL_BATCHES} batches of {B} at {IMGSZ}, --per-class "
        f"--coco-summary): launches {dict(K.launches)}, {val_s:.1f} s")
    if launches == 0:
        raise AssertionError("val.main never launched the batched NMS kernel")
    if list(out) != EVAL_KEYS:
        raise AssertionError(f"val.main printed keys {list(out)}, want the JAX CLI's")
    bad = {k: v for k, v in out.items() if not np.isfinite(v)}
    if bad:
        raise AssertionError(f"val.main printed non-finite values {bad}")
    log(f"eval metrics: loss {out['loss']:.4f}, mAP50 {out['mAP50']:.4g}, mAP50-95 "
        f"{out['mAP50-95']:.4g}, coco/AP {out['coco/AP']:.4g} (random weights)")

    # (b) one batch: the step's detections vs the plain sweep, marks vs the CPU
    batch = next(iter(Loader(SyntheticDataset(n=64, img_size=IMGSZ), B, max_gt=100,
                             prefetch=0)))
    model = eval_model().to(dev)
    step = make_eval_step(model, match_thresholds=DEFAULT_THRESHOLDS, per_class=True)
    b = batch_to_device(batch, dev)
    feats = step.forward(b)
    K.reset_launches()
    metrics, dets, marks, marks_cls = step.from_feats(feats, b)
    torch.cuda.synchronize()
    if K.launches["nms_sweep_batched"] != 1:
        raise AssertionError(f"one eval step launched kernel #1 {K.launches} times")
    with torch.inference_mode():
        boxes, scores, labels, valid, conf_ok = select_candidates(
            feats, model.nc, model.strides, model.reg_max, 0.25, EVAL_TOPK)
        swept = K.nms_sweep_batched_plain(boxes, valid, IOU)
        ref = _finish(boxes, scores, labels, K._cap(swept, 300), 300, IMGSZ)
    if not all(torch.equal(g, r) for g, r in zip(dets, ref)):
        raise AssertionError("eval-step detections differ from the plain sweep's")
    cand = conf_ok.sum(-1)
    # kernel #1 on the eval path's own candidates (after the count was read)
    ms, split = call_ms(lambda: K.nms_sweep_batched(boxes, valid, IOU), NMS_SYMBOLS)
    bound_ms, bound_by = bound(swept, boxes.shape[1])
    log(f"eval step, one batch: detections equal the plain sweep's exactly; above-conf "
        f"candidates per image {int(cand.min())}-{int(cand.max())}, {int(valid.sum())} swept "
        f"(N={boxes.shape[1]}), {int((cand > EVAL_TOPK).sum())} of {B} images over the cap "
        f"(prefilter_saturated {float(metrics['prefilter_saturated']):.3f}), "
        f"{int(swept.sum())} survive the sweep, {int(dets[3].sum())} kept (max_det 300); "
        f"kernel #1 on these candidates {ms:.4f} ms per call (mask "
        f"{split[NMS_SYMBOLS[0]]:.4f} + reduce {split[NMS_SYMBOLS[1]]:.4f}), bound "
        f"{bound_ms:.6f} ms ({bound_by})")
    pb, _, pl, pv = (t.cpu() for t in dets)
    gt = {k: torch.from_numpy(batch[k]) for k in ("gt_bboxes", "gt_mask", "gt_labels")}
    cpu_marks = batched_tp_marks(pb, pv, gt["gt_bboxes"], gt["gt_mask"])
    cpu_marks_cls = batched_tp_marks(pb, pv, gt["gt_bboxes"], gt["gt_mask"], pred_labels=pl,
                                     gt_labels=gt["gt_labels"])
    if not (torch.equal(marks.cpu(), cpu_marks) and torch.equal(marks_cls.cpu(), cpu_marks_cls)):
        raise AssertionError("eval-step marks differ from the CPU's on the same detections")
    log(f"eval step marks equal the CPU's exactly ({int(cpu_marks.sum())} TP marks, "
        f"{int(cpu_marks_cls.sum())} class-restricted)")

    # (c) the loss triplet, card vs CPU, on two images, TF32 off
    two = {k: v[:2] for k, v in batch.items()}
    got = step(two)[0]
    ref = make_eval_step(eval_model())(two)[0]
    rel = {k: abs(float(got[k]) - float(ref[k])) / abs(float(ref[k])) for k in LOSS_KEYS}
    log(f"eval loss on 2 images, card vs CPU (TF32 off): "
        + ", ".join(f"{k} {float(got[k]):.6f} / {float(ref[k]):.6f}" for k in LOSS_KEYS)
        + f"; max rel {max(rel.values()):.3g} (limit 1e-4)")
    if max(rel.values()) > 1e-4:
        raise AssertionError(f"card loss differs from the CPU's: {rel}")

    # (d) times
    step(batch)
    torch.cuda.synchronize()
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        step(batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n * 1e3
    phases = eval_phase_times(step, batch)
    dev_ms = device_ms(lambda: step(batch), reps=3)
    log(f"eval step at B={B}, {IMGSZ}x{IMGSZ} (f32, TF32 off, N={EVAL_TOPK}): "
        f"{B / wall * 1e3:.1f} img/s, {wall:.2f} ms/batch wall, {dev_ms:.2f} ms device "
        f"(busy {dev_ms / wall:.3f}); phases ms "
        + ", ".join(f"{k} {v:.2f}" for k, v in phases.items()) + f" on {ident}")
    return dict(launches=launches)


# the train path (phase 7): the crater YOLO11n at 640, the JAX CLI's batch
TRAIN_BATCH, TRAIN_EPOCHS = 16, 2
TRAIN_KEYS = ("loss", "box_loss", "cls_loss", "dfl_loss")


def _train_setup(model, loss_fn=None, flat_opt=False, **step_kwargs):
    """A train state with EMA (``flat_opt``: on one (N,) master vector) and
    the f32 train step (TF32 off) of ``model`` (the v8 loss unless
    ``loss_fn``; ``step_kwargs``, such as a mesh, to
    ``build_train_step_custom``), with the schedule of a 10-epoch run of one
    step an epoch."""
    state = create_train_state(model, make_optimizer(cosine_epoch_schedule(1e-3, 10, 1)),
                               use_ema=True, flat_opt=flat_opt)
    if loss_fn is None:
        loss_fn = v8_loss_adapter(DetectionLossConfig(nc=model.nc, strides=model.strides))
    step = build_train_step_custom(model, loss_fn, matmul_precision="highest", **step_kwargs)
    return state, step


def step_record(model, state, metrics, lr) -> dict:
    """One train step's outcome on the host: metrics, gradients, state dict,
    Adam moments, counts and the LR applied."""
    names = [n for n, _ in model.named_parameters()]
    return dict(
        metrics={k: float(v) for k, v in metrics.items()}, lr=lr,
        grads={n: p.grad.detach().cpu() for n, p in model.named_parameters()},
        sd={k: v.detach().cpu() for k, v in model.state_dict().items()},
        mu=dict(zip(names, (t.cpu() for t in state.per_param(state.opt_state.mu)))),
        nu=dict(zip(names, (t.cpu() for t in state.per_param(state.opt_state.nu)))),
        counts=(state.step, state.opt_state.count))


def run_train_step(model, batch, where, loss_fn=None) -> dict:
    """One f32 step (TF32 off) of a copy of ``model`` on ``where``."""
    m = copy.deepcopy(model).to(where)
    state, step = _train_setup(m, loss_fn)
    lr = state.tx.lr(state.opt_state.count)
    state, metrics = step(state, batch)
    return step_record(m, state, metrics, lr)


def check_step_pair(got: dict, ref: dict, what: str, grad_tol: float = 1e-3,
                    keys=TRAIN_KEYS) -> dict:
    """Raises unless ``got`` (a :func:`step_record`) agrees with ``ref``:
    the loss ``keys`` to rtol 1e-4 and ``num_fg``, where the loss reports
    it, exactly; each gradient tensor within ``grad_tol * max|g_ref|`` (at
    least 1e-4 of the largest over all tensors: a gradient that is 0 in
    exact arithmetic holds rounding noise only); BN running variances rtol
    1e-4, running means within 1e-5; the step counters and optimizer counts
    1 on both; the parameters within ``lr * |u_got - u_ref| + 1e-6``, ``u``
    being the Adam direction each side's moments give (the LR of the step
    and the update rule applied alike). Returns the worst relative
    differences."""
    out = {}
    rel = {k: abs(got["metrics"][k] - ref["metrics"][k]) / abs(ref["metrics"][k])
           for k in keys}
    out["loss"] = max(rel.values())
    if out["loss"] > 1e-4:
        raise AssertionError(f"{what}: train loss differs: {rel}")
    if got["metrics"].get("num_fg") != ref["metrics"].get("num_fg"):
        raise AssertionError(f"{what}: num_fg {got['metrics']['num_fg']} vs "
                             f"{ref['metrics']['num_fg']}")
    if got["counts"] != (1, 1) or ref["counts"] != (1, 1) or got["lr"] != ref["lr"]:
        raise AssertionError(f"{what}: counts {got['counts']} / {ref['counts']}, lr "
                             f"{got['lr']} / {ref['lr']}")
    floor = 1e-4 * max(float(g.abs().max()) for g in ref["grads"].values())
    out["grad"] = 0.0
    for n, g in ref["grads"].items():
        err = float((got["grads"][n] - g).abs().max()) / max(float(g.abs().max()), floor)
        out["grad"] = max(out["grad"], err)
        if err > grad_tol:
            raise AssertionError(f"{what}: gradient {n}: {err:.3g} of max|g_ref| > {grad_tol}")
    out["running_var"] = out["running_mean"] = 0.0
    for k, r in ref["sd"].items():
        if k.endswith("running_var"):
            err = float(((got["sd"][k] - r).abs() / r.abs()).max())
            lim = 1e-4
        elif k.endswith("running_mean"):
            err, lim = float((got["sd"][k] - r).abs().max()), 1e-5
        else:
            continue
        key = k.rsplit(".", 1)[1]
        out[key] = max(out[key], err)
        if err > lim:
            raise AssertionError(f"{what}: BN statistic {k}: {err:.3g} > {lim}")
    c, lr = ref["counts"][1], ref["lr"]

    def direction(mu, nu):
        return (mu / (1 - 0.9 ** c)) / ((nu / (1 - 0.999 ** c)).sqrt() + 1e-8)

    out["param"] = 0.0
    for n in ref["grads"]:
        bound = lr * (direction(got["mu"][n], got["nu"][n])
                      - direction(ref["mu"][n], ref["nu"][n])).abs() + 1e-6
        err = (got["sd"][n] - ref["sd"][n]).abs()
        out["param"] = max(out["param"], float(err.max()))
        if not bool((err <= bound).all()):
            raise AssertionError(f"{what}: parameter {n} moved otherwise")
    return out


def compare_train_steps(model, batch, dev, grad_tol: float = 1e-3, loss_fn=None,
                        keys=TRAIN_KEYS) -> dict:
    """One train step of ``model`` on ``dev`` against the same step on the
    CPU, from the same weights on the same batch, f32 with TF32 off, with
    ``loss_fn`` (default: the v8 loss), held by :func:`check_step_pair`
    (the CPU's step the reference; cuDNN's wgrad sums in another order).
    Returns the worst relative differences."""
    ref = run_train_step(model, batch, "cpu", loss_fn)
    got = run_train_step(model, batch, dev, loss_fn)
    return check_step_pair(got, ref, f"{dev} vs CPU", grad_tol, keys)


def train_phase_times(step, state, batch, reps: int = 5, augment=None) -> dict:
    """Median ms of each phase of the trainer's own step (with ``augment``,
    its device augmentation too), timed between CUDA events recorded at the
    phase ends that ``TrainStep.on_phase`` reports (a phase includes the
    device's waits for the host)."""
    samples = {}
    for _ in range(reps + 1):  # the first pass warms up
        marks = []

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))

        step.on_phase = mark
        try:
            mark("start")
            step(state, batch, augment=augment)
        finally:
            step.on_phase = None
        torch.cuda.synchronize()
        one = {}
        for (_, a), (name, b) in zip(marks, marks[1:]):  # microbatches add up
            one[name] = one.get(name, 0.0) + a.elapsed_time(b)
        for name, ms in one.items():
            samples.setdefault(name, []).append(ms)
    return {n: statistics.median(v[1:]) for n, v in samples.items()}


def trained_detections_check(save_dir: str, batch, dev) -> str:
    """The EMA weights of ``save_dir``'s last checkpoint through the eval
    step: kernel #1 launches once a call, and its detections equal the same
    maps through the plain sweep, at conf 0.25 and at conf 0."""
    model = build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n", device=dev)
    state = create_train_state(model, make_optimizer(), use_ema=True)
    CheckpointManager(save_dir).try_resume(state, name="last")
    notes = []
    for conf in (0.25, 0.0):
        step = make_eval_step(model, conf_threshold=conf, use_ema=True)
        b = batch_to_device(batch, dev)
        feats = step.forward(b, state)
        K.reset_launches()
        _, dets = step.from_feats(feats, b)
        torch.cuda.synchronize()
        if K.launches["nms_sweep_batched"] != 1:
            raise AssertionError(f"one eval step launched kernel #1 {K.launches} times")
        with torch.inference_mode():
            boxes, scores, labels, valid, _ = select_candidates(
                feats, model.nc, model.strides, model.reg_max, conf, EVAL_TOPK)
            keep = K._cap(K.nms_sweep_batched_plain(boxes, valid, IOU), 300)
            ref = _finish(boxes, scores, labels, keep, 300, IMGSZ)
        if not all(torch.equal(g, r) for g, r in zip(dets, ref)):
            raise AssertionError(f"trained detections at conf {conf} differ from the plain "
                                 "sweep's")
        notes.append(f"conf {conf}: {int(valid.sum())} swept, {int(dets[3].sum())} kept")
    return "; ".join(notes)


def train_phase(dev, ident: str) -> dict:
    """The train path: card vs CPU on one step, the CLI with resume and
    validation through kernel #1, val.main on what it wrote, then times."""
    from yolo_scratch_tpu_torch import val
    from yolo_scratch_tpu_torch.train import cli as train_cli

    B = TRAIN_BATCH
    t_phase = time.perf_counter()
    data = SyntheticDataset(n=64, img_size=IMGSZ)
    batch = next(iter(Loader(data, B, max_gt=100, prefetch=0)))

    # (a) one step, card vs CPU, B=2, TF32 off
    model = build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n", seed=0)
    errs = compare_train_steps(model, {k: v[:2] for k, v in batch.items()}, dev)
    log("train step on 2 images, card vs CPU (TF32 off): " + ", ".join(
        f"{k} {v:.3g}" for k, v in errs.items()) + " (limits: loss rtol 1e-4, grad 1e-3 of "
        "max|g_cpu|, running_var rtol 1e-4, running_mean 1e-5, param within lr x the Adam "
        "directions' difference)")

    # (b) the entry point a user calls, kernel #1's count zeroed just before
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as save_dir:
        flags = ["--data", "synthetic", "--scale", "n", "--imgsz", str(IMGSZ), "--batch", str(B),
                 "--ema", "--save-dir", save_dir]
        K.reset_launches()
        t0 = time.perf_counter()
        first = train_cli.main(flags + ["--epochs", str(TRAIN_EPOCHS)])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = K.launches["nms_sweep_batched"]
        n_val = int(len(data) * 0.2)
        val_batches = -(-n_val // B)
        train_batches = -(-(len(data) - n_val) // B)
        log(f"train path (train.cli.main, {TRAIN_EPOCHS} epochs of {train_batches} batches "
            f"of {B} at {IMGSZ}, --ema): launches {dict(K.launches)}, {fit_s:.1f} s")
        if launches != val_batches * TRAIN_EPOCHS:
            raise AssertionError(f"fit launched kernel #1 {launches} times; want {val_batches} "
                                 f"val batches x {TRAIN_EPOCHS} epochs")
        mgr = CheckpointManager(save_dir)
        step_before = mgr.load_raw("last")["step"]
        second = train_cli.main(flags + ["--epochs", str(TRAIN_EPOCHS + 1)])
        launches = K.launches["nms_sweep_batched"]
        if launches != val_batches * (TRAIN_EPOCHS + 1):
            raise AssertionError(f"fit and its resume launched kernel #1 {launches} times; "
                                 f"want {val_batches} x {TRAIN_EPOCHS + 1}")
        step_after = mgr.load_raw("last")["step"]
        resumed = [h["epoch"] for h in second["history"]]
        if (step_before, step_after, resumed) != (TRAIN_EPOCHS * train_batches,
                                                  (TRAIN_EPOCHS + 1) * train_batches,
                                                  [TRAIN_EPOCHS]):
            raise AssertionError(f"resume: steps {step_before} -> {step_after}, epochs run "
                                 f"{resumed}")
        history = first["history"] + second["history"]
        losses = [h[part][k] for h in history for part in ("train", "val") for k in TRAIN_KEYS]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"non-finite losses {losses}")
        for h in history:
            log(f"  epoch {h['epoch']}: train loss {h['train']['loss']:.4f}, "
                f"{h['train']['imgs_per_sec']:.1f} img/s over the epoch; val loss "
                f"{h['val']['loss']:.4f}, mAP50 {h['val']['mAP50']:.4g}")
        log(f"resume: step counter {step_before} -> {step_after}, epochs run {resumed}")
        out = val.main(["--ckpt", save_dir, "--which", "last", "--ema", "--imgsz", str(IMGSZ),
                        "--batch", str(B)])
        if not all(np.isfinite(v) for v in out.values()):
            raise AssertionError(f"val.main --ckpt printed non-finite values {out}")
        log(f"val.main --ckpt --which last --ema: loss {out['loss']:.4f}, mAP50 "
            f"{out['mAP50']:.4g}")
        log("trained EMA detections equal the plain sweep's: "
            + trained_detections_check(save_dir, batch, dev))
    fit_launches = launches

    # (c) times at B=16
    model = build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n", seed=0,
                         device=dev)
    state, step = _train_setup(model)
    phases = train_phase_times(step, state, batch)
    step(state, batch)
    torch.cuda.synchronize()
    n = 10
    t0 = time.perf_counter()
    for _ in range(n):
        step(state, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n * 1e3
    tr = device_profile(lambda: step(state, batch), reps=3)
    log(f"train step at B={B}, {IMGSZ}x{IMGSZ} (f32, TF32 off, EMA): {B / wall * 1e3:.1f} "
        f"img/s, {wall:.2f} ms/step wall, {tr['ms']:.2f} ms device (busy "
        f"{tr['ms'] / wall:.3f}), {tr['ops']} device ops a step; phases ms "
        + ", ".join(f"{k} {v:.2f}" for k, v in phases.items()) + f" on {ident}")
    log("train step, top device activities (ms a step, count): " + "; ".join(
        f"{name} {ms:.2f} x{n}" for name, ms, n in tr["top"]))
    log(f"train phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=fit_launches)


# the YOLOX phase (8): YOLOX-s, the published COCO width, at 640
YOLOX_SCALE, AUG_BATCH, YOLOX_EPOCHS = "s", 16, 3
YOLOX_LOSS_KEYS = ("loss", "iou_loss", "obj_loss", "cls_loss")
YOLOX_AUG = AugmentConfig(hflip_p=0.5, mosaic_p=1.0, mixup_p=1.0)


def augment_card_vs_cpu(batch, draws, cfg: AugmentConfig, dev) -> float:
    """``apply_augment`` of the same draws on the card and on the CPU.
    Raises unless boxes, labels and masks (mosaic, mixup's union, the flips)
    are equal, the images (mosaic's gather and the flips exact, mixup's
    blend and the colour ops rounded) within 1e-5, and every valid box lies
    in [0, 1] with a width and height above ``min_box_size``. Returns the
    image's max |card - CPU|."""
    cpu = apply_augment({k: torch.as_tensor(v) for k, v in batch.items()}, draws.to("cpu"), cfg)
    card = apply_augment(batch_to_device(batch, dev), draws.to(dev), cfg)
    for k in ("gt_bboxes", "gt_labels", "gt_mask"):
        if not torch.equal(card[k].cpu(), cpu[k]):
            raise AssertionError(f"augmented {k} differ between the card and the CPU")
    err = float((card["img"].cpu() - cpu["img"]).abs().max())
    if err > 1e-5:
        raise AssertionError(f"augmented images differ by {err:.3g} (limit 1e-5)")
    bb, m = cpu["gt_bboxes"], cpu["gt_mask"]
    v = bb[m]
    if not bool(m.any()) or float(v.min()) < 0 or float(v.max()) > 1 or not bool(
            (((v[:, 2] - v[:, 0]) > cfg.min_box_size)
             & ((v[:, 3] - v[:, 1]) > cfg.min_box_size)).all()):
        raise AssertionError("an augmented box lies outside [0, 1] or under min_box_size")
    return err


def augment_phase(dev, ident: str) -> dict:
    """8(a): ``augment_batch``'s pipeline on the card against the CPU, same
    draws, at 640 and B=16 on ch=3 and ch=1, and its device time."""
    t_phase = time.perf_counter()
    out = {}
    for ch in (3, 1):
        batch = next(iter(Loader(SyntheticDataset(n=AUG_BATCH, img_size=IMGSZ, channels=ch),
                                 AUG_BATCH, max_gt=100, prefetch=0)))
        draws = draw_augment(batch_generator(43, 0, ch), AUG_BATCH, ch, YOLOX_AUG)
        err = augment_card_vs_cpu(batch, draws, YOLOX_AUG, dev)
        b = batch_to_device(batch, dev)
        gen = torch.Generator(device=dev).manual_seed(ch)
        prof = device_profile(lambda: augment_batch(b, gen, YOLOX_AUG), reps=5)
        wall = time_ms(lambda: augment_batch(b, gen, YOLOX_AUG), reps=5, windows=3)
        out[ch] = prof["ms"]
        log(f"augment (mosaic 1.0, mixup 1.0, hflip 0.5, {'HSV' if ch == 3 else 'gray'}) at "
            f"B={AUG_BATCH}, {IMGSZ}x{IMGSZ}x{ch}: card equals the CPU on the same draws "
            f"(boxes, labels, masks exact; images max|d| {err:.3g}, limit 1e-5), "
            f"{int(draws.mosaic.apply.sum())} mosaics, {int(draws.mixup.apply.sum())} mixups; "
            f"{prof['ms']:.3f} ms device in {prof['ops']} ops, {wall:.3f} ms wall per batch "
            f"(draws included) on {ident}")
    log(f"augment phase: {time.perf_counter() - t_phase:.1f} s")
    return out


def plain_yolox_packed(pred: Predictor, feats) -> torch.Tensor:
    """The YOLOX Predictor's postprocess with the plain sweep in place of
    kernel #1."""
    cfg, m = pred.cfg, pred.model
    decoded = yolox_eval_decode([f.float() for f in feats], m.nc, m.strides)
    boxes, scores, labels, valid = _prefilter_batched(decoded, cfg.conf_threshold,
                                                      cfg.pre_nms_topk)
    keep = K._cap(K.nms_sweep_batched_plain(boxes, valid, cfg.iou_threshold), cfg.max_det)
    return pack_detections(*_finish(boxes, scores, labels, keep, cfg.max_det, cfg.img_size))


def yolox_predictor_phase(dev, ident: str) -> dict:
    """8(b): the YOLOX-s Predictor (ch=3, nc=80, seeded init) at 640, B=32."""
    B, S = BATCH, IMGSZ
    t_phase = time.perf_counter()
    xs = [np.random.RandomState(300 + i).randint(0, 256, (B, S, S, 3), dtype=np.uint8)
          for i in range(3)]
    model = load_deploy_model(scale=YOLOX_SCALE, seed=0, device=dev, model_kind="yolox")
    pred = Predictor(model, PredictorConfig(img_size=S, batch_size=B), device=dev)
    K.reset_launches()
    for x in xs:
        check_packed(pred.predict_batch(x), B, 300)
    torch.cuda.synchronize()
    main = dict(K.launches)
    log(f"YOLOX-{YOLOX_SCALE} predict_batch (3 batches of {B}): launches {main}")
    if main["nms_sweep_batched"] == 0:
        raise AssertionError("the YOLOX Predictor never launched the batched NMS kernel")

    pred0 = Predictor(model, PredictorConfig(img_size=S, batch_size=B, conf_threshold=0.0),
                      device=dev)
    with torch.inference_mode():
        feats = pred0.forward_feats(xs[0])
        got, ref = pred0.postprocess_feats(feats), plain_yolox_packed(pred0, feats)
        check_packed(got, B, 300)
        if not torch.equal(got, ref):
            raise AssertionError("YOLOX conf-0 detections differ from the plain sweep")
        log(f"YOLOX conf=0 detections equal the plain sweep's ({int(got[..., 6].sum())} kept "
            f"over {B} images)")
        decoded = yolox_eval_decode([f.float() for f in pred.forward_feats(xs[1][:1])],
                                    model.nc, model.strides)
        K.reset_launches()
        got1 = postprocess(decoded, S, conf_threshold=0.0, pre_nms_topk=512, nms_impl="kernel")
        torch.cuda.synchronize()
        b1 = dict(K.launches)
        boxes, scores, labels, valid = _prefilter_batched(decoded, 0.0, 512)
        keep = K._cap(K.nms_sweep_plain(boxes[0], valid[0], IOU)[None], 300)
        ref1 = _finish(boxes, scores, labels, keep, 300, S)
    if b1["nms_sweep"] != 1 or not all(torch.equal(g, r) for g, r in zip(got1, ref1)):
        raise AssertionError(f"YOLOX B=1 postprocess: launches {b1}, or it differs from the "
                             "plain sweep")
    log(f"YOLOX B=1 postprocess path: launches {b1}, equal to the plain sweep")
    forward_check(f"YOLOX-{YOLOX_SCALE} (ch=3, nc=80)", model, xs[1][:2], dev)

    pred.predict_batch(xs[0])
    torch.cuda.synchronize()
    n = 10
    t0 = time.perf_counter()
    for i in range(n):
        pred.predict_batch(xs[i % len(xs)])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n * 1e3
    prof = device_profile(lambda: pred.predict_batch(xs[0]), reps=5)
    log(f"YOLOX-{YOLOX_SCALE} Predictor: {B / wall * 1e3:.1f} img/s at B={B}, {S}x{S}, "
        f"{wall:.2f} ms/batch wall, {prof['ms']:.2f} ms device in {prof['ops']} ops (busy "
        f"{prof['ms'] / wall:.3f}; bf16, BN folded, f32 decode, conf 0.25) on {ident}")
    log(f"YOLOX Predictor phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(main=main, b1=b1)


def yolox_eval_weights(path):
    """YOLOX-s on the synthetic set's shape (ch=1, nc=5), seeded init, with
    the obj and cls prediction biases at +2: every anchor scores about
    0.88^2 = 0.78 and passes 0.25, so kernel #1 sweeps 2048 valid boxes an
    image."""
    model = build_yolox(YOLOX_SCALE, nc=5, ch=1, seed=7)
    with torch.no_grad():
        for i in range(model.head.levels):
            for kind in ("cls", "obj"):
                getattr(model.head, f"{kind}_pred_{i}").bias.fill_(2.0)
    torch.save(model.state_dict(), path)
    return model


def yolox_eval_phase(dev, ident: str) -> dict:
    """8(c): ``val.main --model yolox`` at 640, B=32, then one batch held
    against the plain sweep and the CPU's marks, then times."""
    from yolo_scratch_tpu_torch import val

    B = BATCH
    t_phase = time.perf_counter()
    weights = BUILD_DIR / "yolox_eval_weights.pt"
    weights.parent.mkdir(parents=True, exist_ok=True)
    model = yolox_eval_weights(weights)
    K.reset_launches()
    t0 = time.perf_counter()
    out = val.main(["--data", "synthetic", "--model", "yolox", "--scale", YOLOX_SCALE,
                    "--imgsz", str(IMGSZ), "--batch", str(B), "--max-batches", str(EVAL_BATCHES),
                    "--torch-ckpt", str(weights)])
    torch.cuda.synchronize()
    launches = K.launches["nms_sweep_batched"]
    log(f"YOLOX eval path (val.main --model yolox, {EVAL_BATCHES} batches of {B}): launches "
        f"{dict(K.launches)}, {time.perf_counter() - t0:.1f} s; " + json.dumps(out))
    if launches != EVAL_BATCHES or not all(np.isfinite(v) for v in out.values()):
        raise AssertionError(f"val.main --model yolox: launches {launches}, metrics {out}")

    batch = next(iter(Loader(SyntheticDataset(n=64, img_size=IMGSZ), B, max_gt=100,
                             prefetch=0)))
    model = model.to(dev).eval()
    step = make_eval_step(
        model, loss_fn=yolox_loss_adapter(YOLOXLossConfig(nc=5, strides=model.strides)),
        decode_fn=lambda f: yolox_eval_decode(f, 5, model.strides),
        match_thresholds=DEFAULT_THRESHOLDS, per_class=True)
    b = batch_to_device(batch, dev)
    feats = step.forward(b)
    K.reset_launches()
    metrics, dets, marks, marks_cls = step.from_feats(feats, b)
    torch.cuda.synchronize()
    if K.launches["nms_sweep_batched"] != 1:
        raise AssertionError(f"one YOLOX eval step launched kernel #1 {K.launches} times")
    with torch.inference_mode():
        decoded = yolox_eval_decode(feats, 5, model.strides)
        boxes, scores, labels, valid = _prefilter_batched(decoded, 0.25, EVAL_TOPK)
        swept = K.nms_sweep_batched_plain(boxes, valid, IOU)
        ref = _finish(boxes, scores, labels, K._cap(swept, 300), 300, IMGSZ)
    if not all(torch.equal(g, r) for g, r in zip(dets, ref)):
        raise AssertionError("YOLOX eval-step detections differ from the plain sweep's")
    pb, _, pl, pv = (t.cpu() for t in dets)
    gt = {k: torch.from_numpy(batch[k]) for k in ("gt_bboxes", "gt_mask", "gt_labels")}
    if not (torch.equal(marks.cpu(), batched_tp_marks(pb, pv, gt["gt_bboxes"], gt["gt_mask"]))
            and torch.equal(marks_cls.cpu(), batched_tp_marks(
                pb, pv, gt["gt_bboxes"], gt["gt_mask"], pred_labels=pl,
                gt_labels=gt["gt_labels"]))):
        raise AssertionError("YOLOX eval-step marks differ from the CPU's")
    ms, split = call_ms(lambda: K.nms_sweep_batched(boxes, valid, IOU), NMS_SYMBOLS)
    bound_ms, bound_by = bound(swept, boxes.shape[1])
    log(f"YOLOX eval step, one batch: detections equal the plain sweep's and marks the CPU's "
        f"exactly; {int(valid.sum())} swept (N={boxes.shape[1]}), {int(swept.sum())} survive, "
        f"{int(dets[3].sum())} kept, num_fg {float(metrics['num_fg']):.1f}; kernel #1 on these "
        f"candidates {ms:.4f} ms (mask {split[NMS_SYMBOLS[0]]:.4f} + reduce "
        f"{split[NMS_SYMBOLS[1]]:.4f}), bound {bound_ms:.6f} ms ({bound_by})")

    step(batch)
    torch.cuda.synchronize()
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        step(batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n * 1e3
    prof = device_profile(lambda: step(batch), reps=3)
    log(f"YOLOX eval step at B={B}, {IMGSZ}x{IMGSZ} (f32, TF32 off, N={EVAL_TOPK}): "
        f"{B / wall * 1e3:.1f} img/s, {wall:.2f} ms/batch wall, {prof['ms']:.2f} ms device in "
        f"{prof['ops']} ops (busy {prof['ms'] / wall:.3f}) on {ident}")
    log(f"YOLOX eval phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches)


def write_crater_tree(root, n_images: int = 10, seed: int = 0) -> None:
    """A small crater tree in the reference layout
    (``altitude*/longitude*/truth/detections.csv``, images beside ``truth``),
    grayscale PNGs written with cv2."""
    import csv

    import cv2

    rng = np.random.RandomState(seed)
    for alt in ("altitude10", "altitude20"):
        site = root / alt / "longitude5"
        (site / "truth").mkdir(parents=True)
        rows = []
        for i in range(n_images // 2):
            h, w = int(rng.randint(400, 700)), int(rng.randint(400, 700))
            img = (rng.rand(h, w) * 80 + 100).astype(np.uint8)
            for _ in range(int(rng.randint(2, 6))):
                a, b = rng.uniform(10, 50), rng.uniform(8, 40)
                cx, cy = rng.uniform(60, w - 60), rng.uniform(60, h - 60)
                cv2.ellipse(img, (int(cx), int(cy)), (int(a), int(b)), 0, 0, 360, 40, -1)
                rows.append({"inputImage": f"img{i}.png", "ellipseCenterX(px)": cx,
                             "ellipseCenterY(px)": cy, "ellipseSemimajor(px)": a,
                             "ellipseSemiminor(px)": b,
                             "crater_classification": int(rng.randint(0, 5))})
            cv2.imwrite(str(site / f"img{i}.png"), img)
        with open(site / "truth" / "detections.csv", "w", newline="") as fh:
            wtr = csv.DictWriter(fh, fieldnames=list(rows[0]))
            wtr.writeheader()
            wtr.writerows(rows)


def yolox_train_phase(dev, ident: str) -> dict:
    """8(d): one YOLOX step card vs CPU, then ``train.cli.main`` with the
    YOLOX recipe, then the step's phases with augmentation; 8(e): one epoch
    on a crater tree the script writes (cv2 decodes it)."""
    from yolo_scratch_tpu_torch.data import native
    from yolo_scratch_tpu_torch.train import cli as train_cli

    B = TRAIN_BATCH
    t_phase = time.perf_counter()
    data = SyntheticDataset(n=64, img_size=IMGSZ)
    batch = next(iter(Loader(data, B, max_gt=100, prefetch=0)))
    loss_fn = yolox_loss_adapter(YOLOXLossConfig(nc=5))
    model = build_yolox(YOLOX_SCALE, nc=5, ch=1, seed=0)
    errs = compare_train_steps(model, {k: v[:2] for k, v in batch.items()}, dev,
                               loss_fn=loss_fn, keys=YOLOX_LOSS_KEYS)
    log("YOLOX train step on 2 images, card vs CPU (TF32 off): " + ", ".join(
        f"{k} {v:.3g}" for k, v in errs.items()) + " (limits: loss rtol 1e-4, num_fg equal, "
        "grad 1e-3 of max|g_cpu|, running_var rtol 1e-4, running_mean 1e-5)")

    launches = 0
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as save_dir:
        K.reset_launches()
        t0 = time.perf_counter()
        out = train_cli.main(["--data", "synthetic", "--model", "yolox", "--scale", YOLOX_SCALE,
                              "--imgsz", str(IMGSZ), "--batch", str(B), "--epochs",
                              str(YOLOX_EPOCHS), "--final-epochs", "1", "--mosaic", "1.0",
                              "--mixup", "1.0", "--ema", "--save-dir", save_dir])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        n_val = int(len(data) * 0.2)
        val_batches = -(-n_val // B)
        launches += K.launches["nms_sweep_batched"]
        log(f"YOLOX train path (train.cli.main --model yolox --mosaic 1.0 --mixup 1.0 "
            f"--final-epochs 1, {YOLOX_EPOCHS} epochs at B={B}): launches {dict(K.launches)}, "
            f"{fit_s:.1f} s")
        if K.launches["nms_sweep_batched"] != val_batches * YOLOX_EPOCHS:
            raise AssertionError(f"fit launched kernel #1 {K.launches} times; want "
                                 f"{val_batches} x {YOLOX_EPOCHS}")
        hist = out["history"]
        l1 = [h["train"]["l1_loss"] for h in hist]
        if l1[:-1] != [0.0] * (YOLOX_EPOCHS - 1) or not l1[-1] > 0:
            raise AssertionError(f"l1_loss by epoch {l1}: want 0 before the final phase, > 0 in it")
        for h in hist:
            if not all(np.isfinite(v) for part in ("train", "val") for v in h[part].values()):
                raise AssertionError(f"non-finite metrics in epoch {h['epoch']}: {h}")
            log(f"  epoch {h['epoch']}: train loss {h['train']['loss']:.4f} (l1 "
                f"{h['train']['l1_loss']:.4f}, num_fg {h['train']['num_fg']:.1f}), "
                f"{h['train']['imgs_per_sec']:.1f} img/s over the epoch; val loss "
                f"{h['val']['loss']:.4f}, mAP50 {h['val']['mAP50']:.4g}")

    # the step with the recipe's augmentation, at B=16
    model = build_yolox(YOLOX_SCALE, nc=5, ch=1, seed=0, device=dev)
    state, step = _train_setup(model, loss_fn)
    gen = torch.Generator(device=dev).manual_seed(0)
    aug = lambda b: augment_batch(b, gen, YOLOX_AUG)  # noqa: E731
    phases = train_phase_times(step, state, batch, augment=aug)
    step(state, batch, augment=aug)
    torch.cuda.synchronize()
    n = 10
    t0 = time.perf_counter()
    for _ in range(n):
        step(state, batch, augment=aug)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n * 1e3
    tr = device_profile(lambda: step(state, batch, augment=aug), reps=3)
    log(f"YOLOX train step at B={B}, {IMGSZ}x{IMGSZ} (f32, TF32 off, EMA, mosaic+mixup+hflip+"
        f"gray on the card): {B / wall * 1e3:.1f} img/s, {wall:.2f} ms/step wall, "
        f"{tr['ms']:.2f} ms device (busy {tr['ms'] / wall:.3f}), {tr['ops']} device ops a step; "
        "phases ms " + ", ".join(f"{k} {v:.2f}" for k, v in phases.items()) + f" on {ident}")
    log("YOLOX train step, top device activities (ms a step, count): " + "; ".join(
        f"{name} {ms:.2f} x{c}" for name, ms, c in tr["top"]))

    # (e) the crater reader on the card's machine, through the native decoders
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as root:
        from pathlib import Path

        write_crater_tree(Path(root) / "data")
        K.reset_launches()
        t0 = time.perf_counter()
        out = train_cli.main(["--data", str(Path(root) / "data"), "--model", "yolox", "--scale",
                              YOLOX_SCALE, "--imgsz", str(IMGSZ), "--batch", "4", "--epochs", "1",
                              "--mosaic", "1.0", "--save-dir", str(Path(root) / "run")])
        torch.cuda.synchronize()
        h = out["history"][0]
        if K.launches["nms_sweep_batched"] != 1 or not np.isfinite(h["train"]["loss"]):
            raise AssertionError(f"crater epoch: launches {K.launches}, history {h}")
        launches += 1
        log(f"crater tree (10 PNGs written with cv2; native decoder available: "
            f"{native.available()}): one YOLOX epoch, train loss {h['train']['loss']:.4f}, "
            f"val loss {h['val']['loss']:.4f}, launches {dict(K.launches)}, "
            f"{time.perf_counter() - t0:.1f} s")
    log(f"YOLOX train phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, augment_ms=phases.get("augment"))


# the deploy phase (9): int8, torch.export artifacts, the serving daemon and
# the infer CLI, on phase 6's crater YOLO11n (every anchor above 0.25)
SERVE_BATCH, SERVE_REQUESTS, SERVE_CLIENTS = 8, 64, 16
# the int8 Predictor, card against CPU on the same quant buffers (f32, TF32
# off): every int8 conv is exact on both; the float ops between them differ
# by ulps, which flip a few inputs to the neighbouring quantisation step.
# A flip moves a map by one step's share, far below the int8-vs-float error
# the JAX tests bound at 0.05 of max|ref|; that bound holds here too.
INT8_CARD_CPU_TOL = 0.05


def conv_shapes(model, x, dev) -> list:
    """(block, its input shape) of each distinct ``ConvBNAct`` conv shape in
    one forward of ``model`` (quantized, on ``dev``) on ``x``."""
    from yolo_scratch_tpu_torch.nn.quant import conv_blocks

    seen = {}

    def hook(mod, inp, out):
        c = mod.conv
        key = (tuple(inp[0].shape), c.out_channels, c.kernel_size[0], c.stride[0],
               c.padding[0], c.dilation[0], c.groups)
        seen.setdefault(key, mod)

    hooks = [m.register_forward_hook(hook) for _, m in conv_blocks(model)]
    try:
        with torch.inference_mode():
            model(torch.as_tensor(x, dtype=torch.float32, device=dev))
    finally:
        for h in hooks:
            h.remove()
    return [(mod, key[0]) for key, mod in seen.items()]


def int8_conv_phase(model_q, x, dev, ident: str) -> None:
    """9(a): ``int8_conv2d`` at every distinct YOLO11n conv shape, B=32, 640:
    the card's int32 output bit-exact against the float64 plain version on
    the card and against the CPU's int32 output; its device ms beside
    cuDNN's bf16 conv on the same shape (numbers, not a claim)."""
    from yolo_scratch_tpu_torch.ops.int8_conv import int8_conv2d, int8_conv2d_plain

    gen = torch.Generator().manual_seed(9)
    fns, rows = {}, []
    for i, (mod, shape) in enumerate(conv_shapes(model_q, x, dev)):
        c = mod.conv
        args = (c.stride[0], c.padding[0], c.dilation[0], c.groups)
        xq = torch.randint(-127, 128, shape, dtype=torch.int8, generator=gen)
        xq_d = xq.to(dev).contiguous(memory_format=torch.channels_last)
        got = int8_conv2d(xq_d, mod.w_q, *args)
        plain = int8_conv2d_plain(xq_d, mod.w_q, *args)
        cpu = int8_conv2d(xq, mod.w_q.cpu(), *args)
        if not (torch.equal(got, plain) and torch.equal(got.cpu(), cpu)):
            raise AssertionError(f"int8_conv2d {shape} -> {c.out_channels}, k={c.kernel_size[0]} "
                                 f"args {args}: card differs from the float64 plain version or "
                                 "from the CPU")
        xb = xq_d.to(torch.bfloat16)
        wb = mod.w_q.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        name = f"{shape[1]}x{shape[2]}->{c.out_channels} k{c.kernel_size[0]}s{args[0]}g{args[3]}"
        fns[f"int8 {name}"] = lambda xq_d=xq_d, w=mod.w_q, a=args: int8_conv2d(xq_d, w, *a)
        fns[f"cudnn {name}"] = lambda xb=xb, wb=wb, a=args: F.conv2d(xb, wb, None, *a)
        rows.append(name)
    ms = ranges_ms(fns, reps=3)
    log(f"int8 conv (a): {len(rows)} distinct YOLO11n conv shapes at B={x.shape[0]}, {x.shape[1]}: "
        "card int32 == float64 plain == CPU int32, bit for bit, on every one")
    log("int8 conv device ms (ops/int8_conv.py, im2col + cuBLASLt s8 GEMM / depthwise sum) "
        "vs cuDNN bf16 conv, same shape, B=32: " + "; ".join(
            f"{r} {ms['int8 ' + r]:.4f} / {ms['cudnn ' + r]:.4f}" for r in rows)
        + f" on {ident}")
    tot_i8 = sum(ms["int8 " + r] for r in rows)
    tot_bf = sum(ms["cudnn " + r] for r in rows)
    log(f"int8 conv, the {len(rows)} shapes summed: {tot_i8:.3f} ms int8 vs {tot_bf:.3f} ms "
        f"cuDNN bf16 on {ident}")


def detections_matched(a: torch.Tensor, b: torch.Tensor, iou: float = 0.5) -> float:
    """Share of ``a``'s valid detections (packed (B, max_det, 7)) that one
    of ``b``'s, of the same label, overlaps at IoU >= ``iou``."""
    from yolo_scratch_tpu_torch.ops.boxes import pairwise_iou

    hit = total = 0
    for ra, rb in zip(a.float().cpu(), b.float().cpu()):
        va, vb = ra[ra[:, 6] > 0.5], rb[rb[:, 6] > 0.5]
        total += len(va)
        if len(va) and len(vb):
            m = (pairwise_iou(va[:, :4], vb[:, :4]) >= iou) & (va[:, None, 5] == vb[None, :, 5])
            hit += int(m.any(1).sum())
    return hit / max(total, 1)


def int8_predictor_phase(model, dev, ident: str):
    """9(b): the int8 Predictor at B=32, 640, calibrated on 2 batches."""
    from yolo_scratch_tpu_torch.nn.quant import count_quantized, quantize_for_deploy

    B, S = BATCH, IMGSZ
    xs = [np.random.RandomState(900 + i).randint(0, 256, (B, S, S, 1), dtype=np.uint8)
          for i in range(3)]
    t0 = time.perf_counter()
    model_q = quantize_for_deploy(model.to(dev), [xs[0] / 255.0, xs[1] / 255.0])
    torch.cuda.synchronize()
    log(f"int8: quantized {count_quantized(model_q)} conv blocks, calibrated on 2 batches "
        f"of {B} in {time.perf_counter() - t0:.1f} s")
    int8_conv_phase(model_q, xs[2] / 255.0, dev, ident)
    pred = Predictor(model_q, PredictorConfig(img_size=S, batch_size=B), device=dev)
    K.reset_launches()
    for x in xs:
        check_packed(pred.predict_batch(x), B, 300)
    torch.cuda.synchronize()
    launches = K.launches["nms_sweep_batched"]
    log(f"int8 Predictor main path (predict_batch, 3 batches of {B}): launches {dict(K.launches)}")
    if launches != len(xs):
        raise AssertionError(f"the int8 Predictor launched kernel #1 {launches} times")
    with torch.inference_mode():
        feats = pred.forward_feats(xs[2])
        got, ref = pred.postprocess_feats(feats), plain_packed(pred, feats)
    if not torch.equal(got, ref):
        raise AssertionError("int8 Predictor detections differ from the plain sweep's")
    log(f"int8 Predictor: detections equal the plain sweep's on the same candidates "
        f"({int(got[..., 6].sum())} kept over {B} images)")

    # card against CPU on the same quant buffers, f32 (TF32 off), two images
    f32 = PredictorConfig(img_size=S, batch_size=2, bf16=False)
    with precision_scope("highest"):
        card = Predictor(model_q, f32, device=dev)
        maps_card, det_card = card.forward_feats(xs[2][:2]), card.predict_batch(xs[2][:2])
    cpu = Predictor(model_q.cpu(), f32, device="cpu")
    maps_cpu, det_cpu = cpu.forward_feats(xs[2][:2]), cpu.predict_batch(xs[2][:2])
    errs = [float((g.cpu() - r).abs().max() / r.abs().max()) for g, r in zip(maps_card, maps_cpu)]
    share = detections_matched(det_cpu, det_card)
    log(f"int8 Predictor, card vs CPU on the same quant buffers (f32, TF32 off, 2 images): maps "
        f"within {max(errs):.3g} of max|ref| (limit {INT8_CARD_CPU_TOL}); {share:.4f} of the "
        f"CPU's detections matched at IoU >= 0.5")
    if max(errs) > INT8_CARD_CPU_TOL:
        raise AssertionError(f"int8 maps card vs CPU: {errs}")

    bf16 = Predictor(model, PredictorConfig(img_size=S, batch_size=B), device=dev)
    agree = detections_matched(bf16.predict_batch(xs[2]), got)
    log(f"int8 vs bf16 Predictor on one batch of {B}: {agree:.4f} of the bf16 detections "
        f"matched by an int8 detection of the same label at IoU >= 0.5")
    pred.predict_batch(xs[0])
    torch.cuda.synchronize()
    n = 10
    t0 = time.perf_counter()
    for i in range(n):
        pred.predict_batch(xs[i % len(xs)])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n * 1e3
    prof = device_profile(lambda: pred.predict_batch(xs[0]), reps=3)
    log(f"int8 Predictor: {B / wall * 1e3:.1f} img/s at B={B}, {S}x{S}, {wall:.2f} ms/batch "
        f"wall, {prof['ms']:.2f} ms device in {prof['ops']} ops (busy {prof['ms'] / wall:.3f}) "
        f"on {ident}")
    log("int8 Predictor, top device activities (ms a batch, count): " + "; ".join(
        f"{name} {ms:.2f} x{c}" for name, ms, c in prof["top"]))
    return pred, bf16, xs, launches


def export_phase(preds: dict, x, tmp) -> int:
    """9(c): each Predictor exported at B=32, saved, loaded and run: its
    packed output equals the live Predictor's, and the artifact's run
    launches kernel #1 (the yst op)."""
    from yolo_scratch_tpu_torch import export as E

    launches = 0
    for name, pred in preds.items():
        path = str(tmp / f"{name}.pt2")
        t0 = time.perf_counter()
        ep = E.export_predictor(pred)
        t1 = time.perf_counter()
        nbytes = E.save_artifact(ep, path)
        t2 = time.perf_counter()
        art = E.ArtifactPredictor(E.load_artifact(path))
        t3 = time.perf_counter()
        live = pred.predict_batch(x)
        K.reset_launches()
        out = art.predict_batch(x)
        torch.cuda.synchronize()
        n = K.launches["nms_sweep_batched"]
        launches += n
        if art.device.type != pred.device.type or n != 1 or not torch.equal(out, live):
            raise AssertionError(f"{name} artifact: device {art.device}, kernel #1 launches {n}, "
                                 f"equal to the live Predictor: {torch.equal(out, live)}")
        log(f"export (c) {name}: {nbytes / 1e6:.2f} MB, export {t1 - t0:.1f} s, save "
            f"{t2 - t1:.1f} s, load {t3 - t2:.1f} s; the artifact's packed output equals the "
            f"live Predictor's at B={x.shape[0]}, kernel #1 launched {n} time(s) on its run")
    return launches


def write_request_images(root, n: int, seed: int = 0) -> list:
    """``n`` grayscale PNGs of varied sizes (smooth noise, so they compress
    fast), written with cv2."""
    import cv2

    rng = np.random.RandomState(seed)
    paths = []
    for i in range(n):
        h, w = int(rng.randint(240, 900)), int(rng.randint(240, 900))
        low = (rng.rand(h // 16 + 1, w // 16 + 1) * 255).astype(np.uint8)
        p = str(root / f"req{i:03d}.png")
        cv2.imwrite(p, cv2.resize(low, (w, h), interpolation=cv2.INTER_LINEAR))
        paths.append(p)
    return paths


def drive_daemon(argv: list, ref_pred, paths: list, ident: str, label: str) -> int:
    """``serve.main(argv)`` on 127.0.0.1:0; ``SERVE_REQUESTS`` POSTs from
    ``SERVE_CLIENTS`` threads, each response equal to ``ref_pred``'s
    ``predict_paths`` on the same file; one poisoned request fails alone.
    Returns kernel #1's launches over the daemon's run."""
    import urllib.error
    import urllib.request

    from yolo_scratch_tpu_torch import serve

    ref = {r["path"]: {k: r[k] for k in ("boxes", "scores", "labels")}
           for r in ref_pred.predict_paths(paths)}
    ready = []
    K.reset_launches()
    th = threading.Thread(target=serve.main, args=(argv,), kwargs={"ready": ready.append},
                          daemon=True)
    th.start()
    for _ in range(1200):
        if ready or not th.is_alive():
            break
        time.sleep(0.1)
    if not ready:
        raise AssertionError(f"serve.main {argv} did not start")
    httpd = ready[0]
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    bodies = {p: open(p, "rb").read() for p in paths}
    got, codes = {}, []

    def post(body):
        req = urllib.request.Request(f"{url}/v1/detect", data=body, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, None

    def client(k):
        for p in paths[k::SERVE_CLIENTS]:
            got[p] = post(bodies[p])
        if k == 0:
            codes.append(post(b"not an image")[0])

    try:
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(k,)) for k in range(SERVE_CLIENTS)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=300)
        wall = time.perf_counter() - t0
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            health = json.loads(r.read())
    finally:
        httpd.shutdown()
        th.join(timeout=60)
    torch.cuda.synchronize()
    launches = K.launches["nms_sweep_batched"]
    bad = [p for p in paths if got.get(p) != (200, ref[p])]
    if bad or codes != [500] or th.is_alive() or launches == 0:
        code, first = got.get(bad[0], (None, None)) if bad else (None, None)
        diff = (None if first is None or len(first["scores"]) != len(ref[bad[0]]["scores"])
                else float(np.abs(np.subtract(first["scores"], ref[bad[0]]["scores"])).max()))
        raise AssertionError(f"daemon {label}: {len(bad)} responses differ from predict_paths "
                             f"({bad[:3]}; the first: code {code}, max |d score| {diff}), "
                             f"poisoned request code {codes}, worker alive {th.is_alive()}, "
                             f"kernel #1 launches {launches}")
    (stats,) = health["stats"].values()
    log(f"daemon (d) {label}: {len(paths)} requests from {SERVE_CLIENTS} clients in {wall:.2f} s "
        f"({len(paths) / wall:.1f} req/s), every response equal to predict_paths, the poisoned "
        f"request alone failed (500); kernel #1 launches {launches}; /healthz batches "
        f"{stats['batches']}, batch_fill {stats.get('batch_fill')}, p50 "
        f"{stats['latency_ms']['p50']} ms, p99 {stats['latency_ms']['p99']} ms on {ident}")
    return launches


def deploy_phase(dev, ident: str) -> dict:
    """9: int8 (a, b), export (c), the daemon live and over an artifact (d),
    the infer CLI (e), on phase 6's crater YOLO11n."""
    from pathlib import Path

    from yolo_scratch_tpu_torch import export as E
    from yolo_scratch_tpu_torch import infer
    from yolo_scratch_tpu_torch.data import native

    t_phase = time.perf_counter()
    model = eval_model()
    pred_q, pred_bf16, xs, launches = int8_predictor_phase(model, dev, ident)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as td:
        tmp = Path(td)
        launches += export_phase({"bf16": pred_bf16, "int8": pred_q}, xs[1], tmp)
        del pred_q, pred_bf16
        weights = str(tmp / "w.pt")
        torch.save(model.state_dict(), weights)
        (tmp / "req").mkdir()
        paths = write_request_images(tmp / "req", SERVE_REQUESTS)
        common = ["--imgsz", str(IMGSZ), "--batch", str(SERVE_BATCH), "--port", "0"]
        live = Predictor(load_deploy_model(weights=weights, device=dev),
                         PredictorConfig(img_size=IMGSZ, batch_size=SERVE_BATCH), device=dev)
        art_path = str(tmp / "serve.pt2")
        E.main(["--weights", weights, "--imgsz", str(IMGSZ), "--batch", str(SERVE_BATCH),
                "--out", art_path])
        art = E.ArtifactPredictor(E.load_artifact(art_path), host_prep=E.load_host_prep(art_path))
        # cuDNN's benchmark keeps its plans per thread, so the daemon's worker
        # and this thread could time their way to different bf16 plans (other
        # roundings); by heuristics both take the same plan
        torch.backends.cudnn.benchmark = False
        try:
            launches += drive_daemon(common + ["--weights", weights], live, paths, ident,
                                     f"live bf16, B={SERVE_BATCH}")
            launches += drive_daemon(common + ["--artifact", art_path], art, paths, ident,
                                     f"bf16 artifact, B={SERVE_BATCH}")
        finally:
            torch.backends.cudnn.benchmark = True

        K.reset_launches()
        t0 = time.perf_counter()
        results = infer.main(["--images", str(tmp / "req"), "--weights", weights,
                              "--imgsz", str(IMGSZ), "--batch", str(BATCH), "--int8-calib", "1"])
        torch.cuda.synchronize()
        n = K.launches["nms_sweep_batched"]
        if len(results) != SERVE_REQUESTS or n != -(-SERVE_REQUESTS // BATCH):
            raise AssertionError(f"infer CLI: {len(results)} results, kernel #1 launches {n}")
        launches += n
        log(f"infer CLI (e) --int8-calib 1 on {SERVE_REQUESTS} PNGs (host prep: the "
            f"{'native' if native.available() else 'cv2'} tier): "
            f"{sum(len(r['scores']) for r in results)} detections, kernel #1 launches {n}, "
            f"{time.perf_counter() - t0:.1f} s")
    log(f"deploy phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches)


# the multi-GPU phase (10): the crater YOLO11n at 640, f32 with TF32 off
MESH_RANKS, MESH_BATCH = 2, 4
STEP_RECORDS = ("sync", "local_card", "local_cpu")


def _mesh_step(model, batch, mesh, bn_mode: str) -> dict:
    """This rank's mesh step of a copy of ``model`` on ``mesh.device``, on
    its rows of the global ``batch``; the :func:`step_record`."""
    m = copy.deepcopy(model).to(mesh.device)
    state, step = _train_setup(m, mesh=mesh, bn_mode=bn_mode)
    lr = state.tx.lr(state.opt_state.count)
    state, metrics = step(state, shard_batch(batch, mesh))
    return step_record(m, state, metrics, lr)


def _records_equal(a: dict, b: dict) -> bool:
    return (a["metrics"] == b["metrics"] and a["counts"] == b["counts"]
            and all(torch.equal(a[part][k], b[part][k])
                    for part in ("grads", "sd", "mu", "nu") for k in a[part]))


@contextlib.contextmanager
def deterministic_mode():
    """cuDNN's benchmark off and its deterministic algorithms on (torch's
    too, warning where it has none): the algorithm behind each convolution
    is then chosen by cuDNN's heuristics, not by timing, as the training
    CLI's steps (benchmark off) choose theirs, and the step repeats bit for
    bit. Phase 10's step checks run in it: with two ranks timing
    algorithms on one card at once, benchmark mode picks them by noisy
    timings, and the gradients the checks compare change from run to run."""
    flags = torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = False, True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = flags


def _one_rank_nccl_step(model, batch, dev) -> dict:
    """(b) The sync step over a one-rank NCCL group against the plain step,
    both run twice in :func:`deterministic_mode`: the plain step must
    repeat itself bit for bit, and the NCCL step equal it."""
    import torch.distributed as dist

    group = dist.new_group(ranks=[0], backend="nccl")  # collective: every rank calls it
    if dist.get_rank() != 0:
        return {}
    with deterministic_mode():
        plain = [run_train_step(model, batch, dev) for _ in range(2)]
        one = Mesh((dev,), rank=0, group=group)
        nccl = [_mesh_step(model, batch, one, "sync") for _ in range(2)]
    return dict(plain_repeats=_records_equal(*plain), nccl_repeats=_records_equal(*nccl),
                nccl_equals_plain=_records_equal(nccl[0], plain[0]),
                transport=mesh_transport(one))


def _mesh_val_check(model, batch, mesh) -> dict:
    """This rank's rows of a val batch through the mesh eval step: kernel #1
    launches once, and the detections equal the same candidates through
    ``nms_sweep_batched_plain``, exactly."""
    step = make_eval_step(model, match_thresholds=DEFAULT_THRESHOLDS, mesh=mesh)
    b = batch_to_device(shard_batch(batch, mesh), mesh.device)
    feats = step.forward(b)
    K.reset_launches()
    metrics, dets, _ = step.from_feats(feats, b)
    torch.cuda.synchronize()
    launches = K.launches["nms_sweep_batched"]
    with torch.inference_mode():
        boxes, scores, labels, valid, _ = select_candidates(
            feats, model.nc, model.strides, model.reg_max, 0.25, EVAL_TOPK)
        keep = K.nms_sweep_batched_plain(boxes, valid, IOU)
        ref = _finish(boxes, scores, labels, K._cap(keep, 300), 300, IMGSZ)
    return dict(launches=launches, equal=all(torch.equal(g, r) for g, r in zip(dets, ref)),
                swept=int(valid.sum()), kept=int(dets[3].sum()), loss=float(metrics["loss"]))


def mesh_rank(rank: int, n: int, init_method: str, spec_path: str, out_dir: str) -> dict:
    """Rank ``rank`` of ``n`` on cuda:0 over gloo (phase 10 (a), (b) and the
    validation check): writes its step records (taken in
    :func:`deterministic_mode`) to ``out_dir`` and returns the checks'
    outcomes and its train step's phases."""
    import os

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # deterministic_mode's cuBLAS
    torch.backends.cudnn.benchmark = True
    spec = torch.load(spec_path, weights_only=False)
    dev = torch.device("cuda", 0)
    D.initialize(init_method, n, rank)
    mesh = D.make_global_mesh(dev)
    D.barrier(mesh)
    model = build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n")
    model.load_state_dict(spec["weights"])
    cpu_mesh = Mesh((torch.device("cpu"),) * n, rank=rank, group=mesh.group)
    with deterministic_mode():
        records = {"sync": _mesh_step(model, spec["batch"], mesh, "sync"),
                   "local_card": _mesh_step(model, spec["batch"], mesh, "local"),
                   "local_cpu": _mesh_step(model, spec["batch"], cpu_mesh, "local")}
    torch.save(records, f"{out_dir}/rank{rank}.pt")
    out = dict(rank=rank, transport=mesh_transport(mesh), nccl=_one_rank_nccl_step(
        model.to(dev), spec["batch"], dev))
    evm = build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n")
    evm.load_state_dict(spec["eval_weights"])
    out["val"] = _mesh_val_check(evm.to(dev).eval(), spec["val_batch"], mesh)
    # the step's phases at the CLI's global batch, all-reduce included
    m = copy.deepcopy(model).to(dev)
    state, step = _train_setup(m, mesh=mesh, bn_mode="sync")
    out["phases"] = train_phase_times(step, state, shard_batch(spec["phase_batch"], mesh))
    return out


def _histories(result: dict) -> list:
    """Each rank's per-epoch losses (timings dropped) from ``train.cli.main``."""
    return [[{part: {k: v for k, v in h[part].items()
                     if k not in ("imgs_per_sec", "epoch_time_s")}
              for part in ("train", "val")} for h in r["fit"]["history"]]
            for r in result["ranks"]]


def mesh_cli_run(flags: list, n: int) -> tuple:
    """``train.cli.main(flags)`` with ``--mesh n``: (its result, its first
    printed line, kernel #1's launches summed over the ranks). Raises unless
    every rank's losses are finite and equal."""
    import contextlib
    import io
    from yolo_scratch_tpu_torch.train import cli as train_cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = train_cli.main(flags + ["--mesh", str(n)])
    printed = buf.getvalue().splitlines()
    for line in printed:
        log("  | " + line)
    hist = _histories(out)
    if any(h != hist[0] for h in hist):
        raise AssertionError(f"the ranks' losses differ: {hist}")
    losses = [v for h in hist[0] for part in h.values() for k, v in part.items()
              if k in TRAIN_KEYS]
    if not losses or not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite losses {losses}")
    return out, printed[0], sum(r["launches"]["nms_sweep_batched"] for r in out["ranks"])


def mesh_train_path(dev, n: int, transport: str) -> dict:
    """(c): ``train.cli.main --mesh n`` at 640/B=16 for 2 epochs, a resumed
    third, ``val.main`` on rank 0's checkpoint, then one ``--bn-mode local``
    epoch. Returns kernel #1's launches summed over ranks and runs, and the
    train img/s of rank 0's epochs."""
    from yolo_scratch_tpu_torch import val

    B = TRAIN_BATCH // n * n  # --batch must divide by the ranks
    data = SyntheticDataset(n=64, img_size=IMGSZ)
    n_val = int(len(data) * 0.2)
    val_batches = -(-n_val // B)
    train_batches = -(-(len(data) - n_val) // B)
    launches, rates = 0, []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as save_dir, \
            tempfile.TemporaryDirectory(dir=BUILD_DIR) as local_dir:
        flags = ["--data", "synthetic", "--scale", "n", "--imgsz", str(IMGSZ), "--batch",
                 str(B), "--ema"]
        t0 = time.perf_counter()
        first, line, got = mesh_cli_run(flags + ["--save-dir", save_dir, "--epochs",
                                                 str(TRAIN_EPOCHS)], n)
        want_line = f"mesh: {n} ranks over {transport}, devices "
        if not line.startswith(want_line):
            raise AssertionError(f"first line {line!r}; want it to start {want_line!r}")
        if got != val_batches * TRAIN_EPOCHS * n:
            raise AssertionError(f"fit launched kernel #1 {got} times over its ranks; want "
                                 f"{val_batches} val batches x {TRAIN_EPOCHS} epochs x {n}")
        launches += got
        mgr = CheckpointManager(save_dir)
        step_before = mgr.load_raw("last")["step"]
        second, _, got = mesh_cli_run(flags + ["--save-dir", save_dir, "--epochs",
                                               str(TRAIN_EPOCHS + 1)], n)
        launches += got
        resumed = [h["epoch"] for h in second["history"]]
        step_after = mgr.load_raw("last")["step"]
        if (got, step_before, step_after, resumed) != (
                val_batches * n, TRAIN_EPOCHS * train_batches,
                (TRAIN_EPOCHS + 1) * train_batches, [TRAIN_EPOCHS]):
            raise AssertionError(f"resume: launches {got}, steps {step_before} -> "
                                 f"{step_after}, epochs run {resumed}")
        for h in first["history"] + second["history"]:
            rates.append(h["train"]["imgs_per_sec"])
            log(f"  epoch {h['epoch']}: train loss {h['train']['loss']:.4f}, "
                f"{h['train']['imgs_per_sec']:.1f} img/s over the epoch (all ranks); val "
                f"loss {h['val']['loss']:.4f}, mAP50 {h['val']['mAP50']:.4g}")
        out = val.main(["--ckpt", save_dir, "--which", "last", "--ema", "--imgsz", str(IMGSZ),
                        "--batch", str(B)])
        if not all(np.isfinite(v) for v in out.values()):
            raise AssertionError(f"val.main --ckpt printed non-finite values {out}")
        log(f"rank 0's checkpoint through val.main --ckpt --which last --ema: loss "
            f"{out['loss']:.4f}, mAP50 {out['mAP50']:.4g}; resume: step counter "
            f"{step_before} -> {step_after}, epochs run {resumed}")
        batch = next(iter(Loader(data, B, max_gt=100, prefetch=0)))
        log("trained EMA detections (rank 0's checkpoint) equal the plain sweep's: "
            + trained_detections_check(save_dir, batch, dev))
        _, _, got = mesh_cli_run(flags + ["--save-dir", local_dir, "--epochs", "1",
                                          "--bn-mode", "local"], n)
        if got != val_batches * n:
            raise AssertionError(f"--bn-mode local launched kernel #1 {got} times")
        launches += got
        log(f"train path over --mesh {n} ({transport}): 2 epochs, a resumed third and one "
            f"--bn-mode local epoch in {time.perf_counter() - t0:.1f} s; kernel #1 launches "
            f"summed over ranks {launches}")
    return dict(launches=launches, rates=rates)


def mesh_predictor_path(model, dev_mesh: Mesh, ident: str) -> dict:
    """(d): ``Predictor.shard_over(dev_mesh)`` at B=32 against unsharded
    Predictors on each shard's rows (exactly), at conf 0 against the plain
    sweep (exactly), and img/s beside the unsharded Predictor's."""
    B, S, n = BATCH, IMGSZ, dev_mesh.size
    xs = [np.random.RandomState(70 + i).randint(0, 256, (B, S, S, 1), dtype=np.uint8)
          for i in range(3)]
    cfg = PredictorConfig(img_size=S, batch_size=B)
    sharded = Predictor(model, cfg, device=dev_mesh.devices[0]).shard_over(dev_mesh)
    K.reset_launches()
    packed = sharded.predict_batch(xs[0])
    torch.cuda.synchronize()
    launches = K.launches["nms_sweep_batched"]
    check_packed(packed, B, 300)
    if launches != n:
        raise AssertionError(f"shard_over over {n} replicas launched kernel #1 {launches} times")
    b = B // n
    for i, dev in enumerate(dev_mesh.devices):
        single = Predictor(model, PredictorConfig(img_size=S, batch_size=b), device=dev)
        ref = single.predict_batch(xs[0][i * b:(i + 1) * b]).to(packed.device)
        if not torch.equal(packed[i * b:(i + 1) * b], ref):
            raise AssertionError(f"shard {i}'s detections differ from an unsharded "
                                 f"Predictor at B={b} on the same rows")
    conf0 = Predictor(model, PredictorConfig(img_size=S, batch_size=B, conf_threshold=0.0),
                      device=dev_mesh.devices[0]).shard_over(dev_mesh)
    with torch.inference_mode():
        got = conf0.predict_batch(xs[1])
        ref = torch.cat([plain_packed(r, r.forward_feats(xs[1][i * b:(i + 1) * b])).to(
            got.device) for i, r in enumerate(conf0.replicas)])
    if not torch.equal(got, ref):
        raise AssertionError("conf-0 sharded detections differ from the plain sweep's")
    rates = {}
    unsharded = Predictor(model, cfg, device=dev_mesh.devices[0])
    for name, p in (("sharded", sharded), ("unsharded", unsharded)):
        p.predict_batch(xs[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(10):
            p.predict_batch(xs[i % 3])
        torch.cuda.synchronize()
        rates[name] = B * 10 / (time.perf_counter() - t0)
    log(f"shard_over over {n} replicas ({', '.join(map(str, dev_mesh.devices))}), B={B}: "
        f"each shard equals an unsharded Predictor at B={b} on its rows, exactly; conf 0: "
        f"equal to the plain sweep ({int(got[..., 6].sum())} kept); kernel #1 {launches} "
        f"launches a batch; {rates['sharded']:.1f} img/s sharded, {rates['unsharded']:.1f} "
        f"unsharded (bf16, conf 0.25) on {ident}")
    return dict(launches=launches, rates=rates)


def multigpu_phase(dev, ident: str) -> dict:
    """Phase 10: (a) 2 ranks on the one card over gloo, sync step against
    the one-process card step and local step against the CPU's; (b) a
    one-rank NCCL group, bit for bit; a val batch through the mesh eval step
    on every rank against the plain sweep; (c) the training CLI over the
    mesh; (d) ``shard_over``; (e) the same across cards where there are 2
    or more."""
    t_phase = time.perf_counter()
    n = MESH_RANKS
    data = SyntheticDataset(n=64, img_size=IMGSZ)
    model = build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n", seed=0)
    spec = dict(weights=model.state_dict(), eval_weights=eval_model().state_dict(),
                batch=next(iter(Loader(data, MESH_BATCH, max_gt=100, prefetch=0))),
                val_batch=next(iter(Loader(data, 8, max_gt=100, prefetch=0))),
                phase_batch=next(iter(Loader(data, TRAIN_BATCH, max_gt=100, prefetch=0))))
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as d:
        torch.save(spec, f"{d}/spec.pt")
        t0 = time.perf_counter()
        ranks = D.spawn_ranks(mesh_rank, n, (n, f"file://{d}/rendezvous", f"{d}/spec.pt", d),
                              timeout=600)
        spawn_s = time.perf_counter() - t0
        records = [torch.load(f"{d}/rank{r}.pt", weights_only=False) for r in range(n)]
    # (a)
    if any(r["transport"] != "gloo" for r in ranks):
        raise AssertionError(f"two ranks on one card must go over gloo: {ranks}")
    if not all(_records_equal(records[0][k], records[r][k]) for r in range(1, n)
               for k in STEP_RECORDS):
        raise AssertionError("the ranks' states differ after a mesh step")
    with deterministic_mode():
        ref = run_train_step(model, spec["batch"], dev)
    errs = check_step_pair(records[0]["sync"], ref, f"{n}-rank sync vs one process")
    log(f"(a) {n} ranks on {dev} over gloo, sync step at global B={MESH_BATCH} vs the "
        f"one-process card step (both in deterministic mode): " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    errs = check_step_pair(records[0]["local_card"], records[0]["local_cpu"],
                           f"{n}-rank local card vs CPU")
    log(f"(a) local (DDP) step, card (deterministic mode) vs the same {n}-rank step on the "
        f"CPU: "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + " (limits: loss rtol 1e-4, "
        "grad 1e-3 of max|g|, running_var rtol 1e-4, running_mean 1e-5, param within lr x "
        "the Adam directions' difference); every rank's state equal")
    # (b)
    nccl = ranks[0]["nccl"]
    if nccl["transport"] != "nccl" or not all(
            nccl[k] for k in ("plain_repeats", "nccl_repeats", "nccl_equals_plain")):
        raise AssertionError(f"one-rank NCCL step: {nccl}")
    log("(b) one-rank NCCL group: its sync step equals the plain card step bit for bit "
        "(both repeat bit for bit in deterministic mode)")
    # the validation batch through the mesh eval step on every rank
    for r in ranks:
        v = r["val"]
        if v["launches"] != 1 or not v["equal"]:
            raise AssertionError(f"rank {r['rank']}'s validation: {v}")
    if len({r["val"]["loss"] for r in ranks}) != 1:
        raise AssertionError("the ranks' eval losses differ")
    log(f"val batch of 8 through the mesh eval step: kernel #1 once on every rank, detections "
        f"equal the plain sweep's exactly (" + "; ".join(
            f"rank {r['rank']}: {r['val']['swept']} swept, {r['val']['kept']} kept"
            for r in ranks) + f"), eval loss {ranks[0]['val']['loss']:.4f} on every rank")
    ph = ranks[0]["phases"]
    log(f"mesh train step at global B={TRAIN_BATCH} ({TRAIN_BATCH // n} a rank, {n} ranks on "
        f"one card over gloo), rank 0's phases ms " + ", ".join(
            f"{k} {v:.2f}" for k, v in ph.items()) + f"; all-reduce {ph['all_reduce']:.2f} ms a "
        f"step on {ident}; the ranks' start-up and checks {spawn_s:.1f} s")
    # (c), (d)
    tr = mesh_train_path(dev, n, "gloo")
    launches = tr["launches"]
    pr = mesh_predictor_path(eval_model(), Mesh((dev,) * n), ident)
    launches += pr["launches"]
    launches += across_cards(dev, ident)
    log(f"multi-GPU phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, rates=tr["rates"], allreduce_ms=ph["all_reduce"])


# slice G (phase 11): deploy from checkpoints, blocked top-k, the tiled and
# dGA NMS, the legacy model with the crater losses, model_info
BLOCKED_KB = 32
LEGACY_BATCH, LEGACY_CPU_IMAGES = 16, 2
LEGACY_WIDTH = 1.15
DGA_TOL = 1e-6
TILED_LONG_N = 8400  # every anchor of a 640 image
# kernels #1 and #2 past the register reduce's 4096 boxes, (wrapper, B, N,
# against the plain sweep too): every anchor of a 640 image at the
# Predictor's B and at the headline's (its mask scratch past the cap: two
# chunks), of a 1024 image, and of a 1280 image at B=1. The tiled sweep,
# exact wherever the plain one is, holds the cases whose plain sweep would
# take 3-12 s apiece here (test_torch_kernels_gpu.py holds those to it)
LONG_SWEEPS = (("nms_sweep_batched", BATCH, TILED_LONG_N, True),
               ("nms_sweep_batched", HEADLINE_B, TILED_LONG_N, False),
               ("nms_sweep_batched", BATCH, 21504, False), ("nms_sweep", 1, 33600, False))


def ckpt_deploy_path(dev, ident: str, tmp) -> int:
    """11(a): the infer, export and serve CLIs on a checkpoint ``train.cli``
    wrote. Returns kernel #1's launches over the main paths."""
    from yolo_scratch_tpu_torch import export as E
    from yolo_scratch_tpu_torch import infer
    from yolo_scratch_tpu_torch.train import cli as train_cli

    run = str(tmp / "run")
    t0 = time.perf_counter()
    train_cli.main(["--data", "synthetic", "--scale", "n", "--imgsz", str(IMGSZ), "--batch",
                    str(TRAIN_BATCH), "--epochs", "1", "--ema", "--save-dir", run])
    tree = CheckpointManager(run).load_raw("last")
    weights = str(tmp / "raw.pt")
    torch.save(tree["model"], weights)
    (tmp / "png").mkdir()
    paths = write_request_images(tmp / "png", BATCH, seed=11)
    log(f"11(a) a one-epoch train.cli run at {IMGSZ}, B={TRAIN_BATCH}, --ema: "
        f"{time.perf_counter() - t0:.1f} s")

    # conf 0: a one-epoch model scores every anchor below 0.25, and the
    # comparisons below must hold detections
    cli = ["--images", str(tmp / "png"), "--imgsz", str(IMGSZ), "--batch", str(BATCH),
           "--conf", "0", "--iou", str(IOU)]
    K.reset_launches()
    got = infer.main(cli + ["--ckpt", run, "--which", "last"])
    torch.cuda.synchronize()
    launches = K.launches["nms_sweep_batched"]
    ref = infer.main(cli + ["--weights", weights])
    if launches != 1 or got != ref or not all(r["scores"] for r in got):
        raise AssertionError(f"infer --ckpt: kernel #1 launches {launches}, results equal to "
                             f"--weights on the raw state_dict: {got == ref}, images without "
                             f"a detection: {sum(not r['scores'] for r in got)}")
    model = infer.load_deploy_model(ckpt=run, which="last", device=dev)
    cfg = PredictorConfig(img_size=IMGSZ, batch_size=BATCH, conf_threshold=0.0)
    pred = Predictor(model, cfg, device=dev)
    imgs, _ = pred._prepare(paths)
    with torch.inference_mode():
        feats = pred.forward_feats(imgs)
        a, b = pred.postprocess_feats(feats), plain_packed(pred, feats)
    if not torch.equal(a, b):
        raise AssertionError("the checkpoint's Predictor at conf 0: kernel #1's detections "
                             "differ from the plain sweep's")
    log(f"11(a) infer.main --ckpt --which last (B={BATCH}, conf 0, IoU {IOU}, {len(paths)} "
        f"cv2 PNGs): {sum(len(r['scores']) for r in got)} detections, at least one an image, "
        f"equal to infer.main --weights on the raw state_dict; kernel #1 launches {launches}; "
        f"the checkpoint's Predictor equals the plain sweep ({int(a[..., 6].sum())} kept)")

    art_path = str(tmp / "ckpt.pt2")
    E.main(["--ckpt", run, "--which", "last", "--imgsz", str(IMGSZ), "--batch", str(BATCH),
            "--conf", "0", "--out", art_path, "--check"])
    art = E.ArtifactPredictor(E.load_artifact(art_path))
    live = Predictor(model, cfg, device=dev)
    x = np.random.RandomState(11).randint(0, 256, (BATCH, IMGSZ, IMGSZ, 1), dtype=np.uint8)
    want = live.predict_batch(x)
    K.reset_launches()
    out = art.predict_batch(x)
    torch.cuda.synchronize()
    n = K.launches["nms_sweep_batched"]
    kept = want[..., 6].sum(-1)
    if n != 1 or not torch.equal(out, want) or not bool((kept > 0).all()):
        raise AssertionError(f"export --ckpt: kernel #1 launches {n}, artifact equal to live: "
                             f"{torch.equal(out, want)}, images without a detection: "
                             f"{int((kept == 0).sum())}")
    launches += n
    log(f"11(a) export.main --ckpt --conf 0 --check: the artifact's packed output equals the "
        f"live Predictor's at B={BATCH} ({int(kept.sum())} kept, at least one an image); "
        f"kernel #1 launches {n}")

    served = Predictor(model, PredictorConfig(img_size=IMGSZ, batch_size=SERVE_BATCH,
                                              conf_threshold=0.0), device=dev)
    (one,) = served.predict_paths(paths[:1])
    if not one["scores"]:
        raise AssertionError("serve --ckpt: predict_paths holds no detection to compare")
    torch.backends.cudnn.benchmark = False  # one bf16 plan in both threads (phase 9)
    try:
        launches += drive_daemon(["--ckpt", run, "--which", "last", "--imgsz", str(IMGSZ),
                                  "--batch", str(SERVE_BATCH), "--conf", "0", "--port", "0"],
                                 served, paths[:1], ident,
                                 f"serve.main --ckpt --conf 0, one request "
                                 f"({len(one['scores'])} detections)")
    finally:
        torch.backends.cudnn.benchmark = True
    return launches


def blocked_topk_path(dev, ident: str) -> int:
    """11(b): ``blocked_topk`` on phase 6's weights at B=32. Returns kernel
    #1's launches on the main path."""
    from yolo_scratch_tpu_torch.ops.decode import topk_scores

    model = eval_model()
    x = np.random.RandomState(12).randint(0, 256, (BATCH, IMGSZ, IMGSZ, 1), dtype=np.uint8)
    cfg = PredictorConfig(img_size=IMGSZ, batch_size=BATCH, blocked_topk=BLOCKED_KB)
    pred = Predictor(model, cfg, device=dev)
    K.reset_launches()
    packed = pred.predict_batch(x)
    torch.cuda.synchronize()
    launches = K.launches["nms_sweep_batched"]
    check_packed(packed, BATCH, cfg.max_det)
    with torch.inference_mode():
        feats = pred.forward_feats(x)
        got, ref = pred.postprocess_feats(feats), plain_packed(pred, feats)
        m = pred.model
        no = m.nc + 4 * m.reg_max
        logits = torch.cat([f.reshape(BATCH, -1, no)[..., 4 * m.reg_max:] for f in feats],
                           1).amax(-1)
        ok = torch.sigmoid(logits.float()) > cfg.conf_threshold
        masked = logits.masked_fill(~ok, float("-inf"))
        v_card, i_card = topk_scores(masked, cfg.pre_nms_topk, blocked=BLOCKED_KB)
        v_cpu, i_cpu = topk_scores(masked.cpu(), cfg.pre_nms_topk, blocked=BLOCKED_KB)
        _, i_exact = topk_scores(masked, cfg.pre_nms_topk)
    if launches != 1 or not torch.equal(got, ref) or not torch.equal(packed, got):
        raise AssertionError(f"blocked top-k: kernel #1 launches {launches}, detections equal "
                             f"to the plain sweep's: {torch.equal(got, ref)}")
    if not (torch.equal(i_card.cpu(), i_cpu) and torch.equal(v_card.cpu(), v_cpu)):
        raise AssertionError("blocked top-k: the card's selection differs from the CPU's")
    differ = int((i_card.sort(-1).values != i_exact.sort(-1).values).any(-1).sum())
    log(f"11(b) blocked top-k (kb={BLOCKED_KB}, K={cfg.pre_nms_topk}, phase 6's weights, every "
        f"anchor above 0.25, B={BATCH}, bf16): selected indices equal the CPU's; kernel #1's "
        f"detections equal the plain sweep's ({int(got[..., 6].sum())} kept); launches "
        f"{launches}; {differ} of {BATCH} images select another set than the exact top-k")
    return launches


def wall_ms(fn, reps: int) -> float:
    """Mean host wall time of ``reps`` calls of ``fn``, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def tiled_path(dev, ident: str) -> dict:
    """11(c), first half: the tiled sweep on phase 3's seeded boxes at B=32
    and N=512 and 2048, against kernel #1 and the CPU, device and wall ms
    of each route."""
    from yolo_scratch_tpu_torch.ops.nms import batched_nms_tiled

    rows = {}
    for i, n in enumerate((512, 2048)):
        boxes, valid = seeded_boxes(100 + i, (BATCH, n), dev)  # phase 3's seeds
        # rows are score-sorted: descending distinct scores keep the order
        scores = torch.linspace(1.0, 0.0, n, device=dev).expand(BATCH, n).contiguous()

        def tiled():
            return batched_nms_tiled(boxes, scores, valid, iou_threshold=IOU, max_det=n)

        keep = tiled()
        kern = K.nms_sweep_batched(boxes, valid, IOU)
        cpu = batched_nms_tiled(boxes.cpu(), scores.cpu(), valid.cpu(), iou_threshold=IOU,
                                max_det=n)
        if not (torch.equal(keep, kern) and torch.equal(keep.cpu(), cpu)):
            raise AssertionError(f"tiled sweep at B={BATCH}, N={n}: equal to kernel #1: "
                                 f"{torch.equal(keep, kern)}, to the CPU's: "
                                 f"{torch.equal(keep.cpu(), cpu)}")
        rows[n] = dict(kept=int(keep.sum()), tiled_ms=device_ms(tiled, reps=5),
                       tiled_wall_ms=wall_ms(tiled, 5),
                       kernel_ms=call_ms(lambda: K.nms_sweep_batched(boxes, valid, IOU),
                                         NMS_SYMBOLS)[0])
    short = "; ".join(f"B={BATCH}, N={n}: {r['kept']} kept, tiled {r['tiled_ms']:.4f} ms device "
                      f"({r['tiled_wall_ms']:.2f} ms wall) vs kernel #1 {r['kernel_ms']:.4f} ms"
                      for n, r in rows.items())
    log(f"11(c) tiled sweep (nms_impl='tiled', PyTorch ops) on phase 3's seeded boxes: keep "
        f"masks equal kernel #1's and the CPU tiled sweep's; {short} on {ident}")
    return rows


def long_sweep(dev, name: str, B: int, n: int, with_plain: bool, seed: int) -> dict:
    """One case of :data:`LONG_SWEEPS`: the kernel against the tiled sweep
    and, ``with_plain``, the plain sweep on seeded boxes (B, n), exact; the
    kernel's device ms (mask and reduce summed, or every chunk's kernels),
    the tiled sweep's, the plain sweep's wall ms (one call), the bound, the
    mask scratch."""
    from yolo_scratch_tpu_torch.ops.nms import batched_nms_tiled

    boxes, valid = seeded_boxes(seed, (B, n), dev)
    scores = torch.linspace(1.0, 0.0, n, device=dev).expand(B, n).contiguous()
    args = (boxes, valid) if name == "nms_sweep_batched" else (boxes[0], valid[0])

    def kernel():
        return getattr(K, name)(*args, IOU)

    def tiled():
        return batched_nms_tiled(boxes, scores, valid, iou_threshold=IOU, max_det=n)

    keep, tk = kernel().reshape(B, n), tiled()
    plain, plain_ms = tk, None
    if with_plain:
        t0 = time.perf_counter()
        plain = K.nms_sweep_batched_plain(boxes, valid, IOU)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    if not (torch.equal(keep, tk) and torch.equal(tk, plain)):
        raise AssertionError(f"{name} at B={B}, N={n}: equal to the tiled sweep: "
                             f"{torch.equal(keep, tk)}, the tiled sweep to the plain one: "
                             f"{torch.equal(tk, plain)}")
    stride = K._mask_stride(n)
    chunk = K._chunk_images(B, n, stride)
    chunks = -(-B // chunk)
    if chunks == 1:
        ms, split = call_ms(kernel, NMS_SYMBOLS, reps=10)
    else:  # each chunk launches its own mask and reduce: the call's device time
        ms, split = device_ms(kernel, reps=5), None
    bound_ms, bound_by = bound(keep, n)
    return dict(name=name, B=B, n=n, kept=int(keep.sum()), ms=ms, split=split,
                tiled_ms=device_ms(tiled, reps=1), plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, scratch_bytes=chunk * n * stride * 8, chunks=chunks,
                pairs=B * n * (n - 1) // 2, chain=-(-n // 64))


def long_sweep_path(dev, ident: str) -> dict:
    """11(c), second half: kernels #1 and #2 past the register reduce's 4096
    boxes (:data:`LONG_SWEEPS`), against the tiled sweep and where the case
    says so the plain one, and at N=8400 on one image the pairwise sweep."""
    from yolo_scratch_tpu_torch.ops.nms import nms

    rows = [long_sweep(dev, *case, seed=110 + i) for i, case in enumerate(LONG_SWEEPS)]
    boxes, valid = seeded_boxes(110, (BATCH, TILED_LONG_N), dev)  # LONG_SWEEPS[0]'s
    scores = torch.linspace(1.0, 0.0, TILED_LONG_N, device=dev)

    def pairwise():
        return nms(boxes[0], scores, iou_threshold=IOU, max_det=TILED_LONG_N, valid=valid[0],
                   presorted=True)

    t0 = time.perf_counter()
    pw = pairwise()
    torch.cuda.synchronize()
    pairwise_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(pw, K.nms_sweep(boxes[0], valid[0], IOU)):
        raise AssertionError(f"pairwise sweep at N={TILED_LONG_N}: differs from kernel #2")
    for r in rows:
        split = (f" (mask {r['split'][NMS_SYMBOLS[0]]:.4f} + reduce "
                 f"{r['split'][NMS_SYMBOLS[1]]:.4f})" if r["split"] else "")
        plain = (f"the plain and tiled sweeps; plain {r['plain_ms']:.1f} ms wall" if r["plain_ms"]
                 else "the tiled sweep")
        log(f"11(c) {r['name']} B={r['B']}, N={r['n']}: {r['kept']} kept, equal to {plain}; "
            f"kernel {r['ms']:.4f} ms device{split}, tiled {r['tiled_ms']:.4f} ms device; bound "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']}; {r['pairs']:,} pairs, a reduce chain of "
            f"{r['chain']} blocks); mask scratch {r['scratch_bytes'] / 1e6:.1f} MB in "
            f"{r['chunks']} chunk(s) under the {K._SCRATCH_CAP_BYTES / 2**30:.0f} GiB cap")
    log(f"11(c) pairwise sweep at N={TILED_LONG_N} (image 0): equal to kernel #2, "
        f"{pairwise_ms:.2f} ms wall on {ident}")
    return dict(rows=rows, pairwise_wall_ms=pairwise_ms)


def long_topk_path(dev, ident: str, tmp) -> int:
    """11(c): ``--topk 8400`` at conf 0 (every anchor of a 640 image a
    candidate), B=32, crater: the Predictor's detections equal the plain
    sweep's with kernel #1 launched once a batch; ``export.main --topk
    8400`` writes an artifact that launches it too and equals the live
    Predictor. Returns kernel #1's launches."""
    from yolo_scratch_tpu_torch import export as E

    cfg = PredictorConfig(img_size=IMGSZ, batch_size=BATCH, conf_threshold=0.0,
                          pre_nms_topk=TILED_LONG_N)
    pred = Predictor(load_deploy_model(device=dev), cfg, device=dev)
    x = np.random.RandomState(14).randint(0, 256, (BATCH, IMGSZ, IMGSZ, 1), dtype=np.uint8)
    K.reset_launches()
    live = pred.predict_batch(x)
    torch.cuda.synchronize()
    launches = K.launches["nms_sweep_batched"]
    check_packed(live, BATCH, cfg.max_det)
    with torch.inference_mode():
        feats = pred.forward_feats(x)
        got, ref = pred.postprocess_feats(feats), plain_packed(pred, feats)
    if launches != 1 or not torch.equal(got, ref) or not torch.equal(live, got):
        raise AssertionError(f"Predictor at --topk {TILED_LONG_N}: kernel #1 launches "
                             f"{launches}, detections equal to the plain sweep's: "
                             f"{torch.equal(got, ref)}")
    batch_ms = wall_ms(lambda: pred.predict_batch(x), 5)
    path = str(tmp / "topk8400.pt2")
    E.main(["--imgsz", str(IMGSZ), "--batch", str(BATCH), "--conf", "0", "--topk",
            str(TILED_LONG_N), "--out", path])
    art = E.ArtifactPredictor(E.load_artifact(path))
    K.reset_launches()
    out = art.predict_batch(x)
    torch.cuda.synchronize()
    n = K.launches["nms_sweep_batched"]
    if n != 1 or not torch.equal(out, live):
        raise AssertionError(f"export --topk {TILED_LONG_N}: kernel #1 launches {n}, artifact "
                             f"equal to the live Predictor: {torch.equal(out, live)}")
    log(f"11(c) Predictor at --topk {TILED_LONG_N}, conf 0, B={BATCH}, {IMGSZ}, crater: "
        f"{int(live[..., 6].sum())} kept, equal to the plain sweep's; kernel #1 launches "
        f"{launches}; {batch_ms:.2f} ms a batch wall; export.main --topk {TILED_LONG_N}: "
        f"the artifact equals the live Predictor, kernel #1 launches {n} on {ident}")
    return launches + n


def dga_path(dev) -> None:
    """11(d): ``pairwise_dga`` and ``dga_nms_device``, card against CPU."""
    from yolo_scratch_tpu_torch.ops.dga_nms import dga_nms_device, pairwise_dga

    rng = np.random.RandomState(13)
    n = 300
    c = rng.rand(n, 2).astype(np.float32) * 0.8 + 0.1
    wh = rng.rand(n, 2).astype(np.float32) * 0.15 + 0.03
    boxes = np.clip(np.concatenate([c - wh / 2, c + wh / 2], -1), 0, 1)
    boxes[n // 2:] = boxes[: n - n // 2] + rng.uniform(0, 0.003, (n - n // 2, 4)).astype(
        np.float32)  # near-duplicates
    scores = rng.rand(n).astype(np.float32)
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    err = float((pairwise_dga(b.to(dev)).cpu() - pairwise_dga(b)).abs().max())
    keep_card = dga_nms_device(b.to(dev), s.to(dev), max_det=10)
    keep_cpu = dga_nms_device(b, s, max_det=10)
    if err > DGA_TOL or not torch.equal(keep_card.cpu(), keep_cpu):
        raise AssertionError(f"dGA NMS card vs CPU: matrix {err:.3g} (limit {DGA_TOL}), keep "
                             f"sets equal: {torch.equal(keep_card.cpu(), keep_cpu)}")
    log(f"11(d) dGA NMS, N={n} (half near-duplicates), card vs CPU: dGA matrix within "
        f"{err:.3g} (limit {DGA_TOL}), keep sets equal ({int(keep_cpu.sum())} kept, max_det 10)")


def legacy_losses(model, batch) -> tuple:
    """The legacy model's forward, ``legacy_yolo_loss`` (centre-weighted
    CIoU, objectness, classification) and the three mask losses on its P2
    objectness map read as a crater mask against a disk under each image's
    first ground truth: (total, the parts by name, the times' marks)."""
    from yolo_scratch_tpu_torch.losses.crater_aux import (
        angular_coverage_loss,
        ellipse_consistency_loss,
        rim_weighted_mask_loss,
    )
    from yolo_scratch_tpu_torch.losses.legacy_loss import build_legacy_targets, legacy_yolo_loss

    preds = model(batch["img"])
    fwd = None
    if batch["img"].is_cuda:  # the forward's end, for the times at B=16
        fwd = torch.cuda.Event(enable_timing=True)
        fwd.record()
    targets = build_legacy_targets(batch["gt_labels"], batch["gt_bboxes"], batch["gt_mask"],
                                   [tuple(p["bbox"].shape[1:3]) for p in preds])
    parts = legacy_yolo_loss(preds, targets)
    logits = preds[0]["objectness"][..., 0]  # (B, S/4, S/4)
    H, W = logits.shape[1:]
    gt = batch["gt_bboxes"][:, 0]
    cx, cy = (gt[:, 0] + gt[:, 2]) / 2, (gt[:, 1] + gt[:, 3]) / 2
    w, h = gt[:, 2] - gt[:, 0], gt[:, 3] - gt[:, 1]
    ys = (torch.arange(H, device=logits.device) + 0.5)[None, :, None] / H
    xs = (torch.arange(W, device=logits.device) + 0.5)[None, None, :] / W
    disk = (((xs - cx[:, None, None]) / (w[:, None, None] / 2)) ** 2
            + ((ys - cy[:, None, None]) / (h[:, None, None] / 2)) ** 2 < 1).float()
    prob = torch.sigmoid(logits)
    parts["rim_mask"] = rim_weighted_mask_loss(logits, disk)
    # the probabilities inside the disk only: bins that reach past it fall
    # under min_activation, so the count depends on the binning
    parts["angular"] = angular_coverage_loss(disk * prob, torch.stack([cx, cy], -1),
                                             valid=batch["gt_mask"][:, 0])
    parts["ellipse"] = ellipse_consistency_loss(prob, torch.stack([cx, cy, w, h], -1))
    total = parts["total_loss"] + parts["rim_mask"] + parts["angular"] + parts["ellipse"]
    return total, parts, fwd


def legacy_step(model, batch, where) -> dict:
    """Forward, losses and backward of a copy of ``model`` on ``where``:
    the losses and the gradients on the host."""
    m = copy.deepcopy(model).to(where).train()
    b = {k: v.to(where) for k, v in batch.items()}
    total, parts, _ = legacy_losses(m, b)
    total.backward()
    return dict(losses={k: float(v.detach()) for k, v in parts.items()}
                | {"total": float(total.detach())},
                grads={n: p.grad.detach().cpu() for n, p in m.named_parameters()})


def legacy_path(dev, ident: str) -> None:
    """11(e): the legacy model at width_mult 1.15, 640, f32, TF32 off,
    deterministic: card against CPU on 2 images, then the ms of the forward,
    the losses and the backward at B=16."""
    from yolo_scratch_tpu_torch.models.legacy import build_legacy

    model = build_legacy(num_classes=5, width_mult=LEGACY_WIDTH, ch=1, seed=0)
    batch = batch_to_device(next(iter(Loader(SyntheticDataset(n=LEGACY_BATCH, img_size=IMGSZ),
                                             LEGACY_BATCH, max_gt=8, prefetch=0))), "cpu")
    small = {k: v[:LEGACY_CPU_IMAGES] for k, v in batch.items()}
    with deterministic_mode(), precision_scope("highest"):
        got, ref = legacy_step(model, small, dev), legacy_step(model, small, "cpu")
        if not 0.0 < ref["losses"]["angular"] < 1.0:
            raise AssertionError(f"angular coverage on the CPU reads {ref['losses']['angular']}: "
                                 "all or no bins under-activated, so no binning is compared")
        rel = {k: abs(got["losses"][k] - v) / max(abs(v), 1e-12) for k, v in ref["losses"].items()
               if v != 0.0 or got["losses"][k] != 0.0}
        floor = 1e-4 * max(float(g.abs().max()) for g in ref["grads"].values())
        g_err = max(float((got["grads"][n] - g).abs().max()) / max(float(g.abs().max()), floor)
                    for n, g in ref["grads"].items())
        if max(rel.values()) > 1e-4 or g_err > 1e-3:
            raise AssertionError(f"legacy model card vs CPU: losses {rel}, gradients {g_err:.3g} "
                                 "of max|g| (limits 1e-4, 1e-3)")
        m = copy.deepcopy(model).to(dev).train()
        b = {k: v.to(dev) for k, v in batch.items()}
        times = {"forward": [], "loss": [], "backward": []}
        for _ in range(4):  # the first warms up
            m.zero_grad(set_to_none=True)
            t0, t2 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t3 = torch.cuda.Event(enable_timing=True)
            t0.record()
            total, parts, t1 = legacy_losses(m, b)
            t2.record()
            total.backward()
            t3.record()
            torch.cuda.synchronize()
            for k, (a, z) in zip(times, ((t0, t1), (t1, t2), (t2, t3))):
                times[k].append(a.elapsed_time(z))
    ms = {k: statistics.median(v[1:]) for k, v in times.items()}
    n_params = sum(p.numel() for p in m.parameters())
    log(f"11(e) legacy model (width_mult {LEGACY_WIDTH}, {n_params:,} parameters) at {IMGSZ}, "
        f"f32, TF32 off, deterministic: card vs CPU on {LEGACY_CPU_IMAGES} images, losses "
        f"within {max(rel.values()):.3g} relative (limit 1e-4: "
        + ", ".join(f"{k} {ref['losses'][k]:.4f}" for k in ref["losses"])
        + f"), gradients within {g_err:.3g} of max|g| (limit 1e-3); at B={LEGACY_BATCH}: "
        f"forward {ms['forward']:.2f} ms, loss {ms['loss']:.2f} ms, backward "
        f"{ms['backward']:.2f} ms on {ident}")


def model_info_path(dev, ident: str) -> None:
    """11(f): ``model_info`` on the card against the CPU."""
    from yolo_scratch_tpu_torch.utils.model_info import model_info

    for name, build in (("YOLO11n crater", lambda: build_yolo11(
            CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n")),
                        ("YOLOX-s COCO", lambda: build_yolox("s", nc=80, ch=3))):
        cpu = model_info(build(), img_size=IMGSZ)
        card = model_info(build().to(dev), img_size=IMGSZ)
        if card["params"] != cpu["params"] or card["gflops"] != cpu["gflops"]:
            raise AssertionError(f"model_info {name}: card {card} vs CPU {cpu}")
        log(f"11(f) model_info {name} at {IMGSZ}: {card['params']:,} parameters (the CPU's), "
            f"{card['gflops']:.3f} GFLOPs (FlopCounterMode, card and CPU alike)")


def slice_g_phase(dev, ident: str) -> dict:
    """11: the modules and faults of slice G on the card."""
    from pathlib import Path

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as td:
        launches = ckpt_deploy_path(dev, ident, Path(td))
        launches += long_topk_path(dev, ident, Path(td))
    launches += blocked_topk_path(dev, ident)
    rows = tiled_path(dev, ident)
    long_rows = long_sweep_path(dev, ident)
    dga_path(dev)
    legacy_path(dev, ident)
    model_info_path(dev, ident)
    log(f"slice G phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, tiled=rows, long=long_rows)


# slice H (phase 12): the flat update vector, background checkpoint writes,
# and the two accuracy tools on the card
OVERFIT_RUNS = (("yolo11", False), ("yolo11", True), ("yolox", False))
# the JAX package's overfit record (STATUS.md: mAP50 0.9375 for f32 and bf16,
# val loss 7.23 / 7.44) is what scripts/overfit_check.py reaches at 150
# epochs on the CPU (0.9375, val loss 7.45 / 7.40); at 60 it reaches 0.7425
# and 0.4687 there, still climbing
OVERFIT_EPOCHS = 150
OVERFIT_MIN = {"yolo11": 0.85, "yolox": 0.70}  # mAP50; the JAX records: 0.9375 / 0.811
QUANT_IMGSZ, QUANT_EPOCHS, QUANT_DELTA = 320, 90, 0.05
# the int8 gate reads held-out synthetic images: on eval_quant's 12 val
# images one box is ~0.03 mAP50, and int8 - bf16 read -0.0101 to +0.0463
# there over six 90-100 epoch runs, -0.0113 and -0.0065 on these 384
# (H100): (seed, disjoint sets, images a set)
HELD_OUT = (1, 4, 96)


def flat_opt_path(dev, ident: str, batch) -> None:
    """12(a): the crater YOLO11n at 640, B=16: one step of the flat state
    against one of the per-leaf state from the same weights on the same
    batch (deterministic, TF32 off) within phase 7's limits, then each form's
    step phases, and the flat update with its gradients gathered by one
    multi-tensor copy against gradients bound to the flat buffer."""
    model = build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n", seed=0,
                         device=dev)
    forms = {"per-leaf": False, "flat": True}
    runs, phases = {}, {}
    with deterministic_mode():
        for form, flat in forms.items():
            m = copy.deepcopy(model)
            state, step = _train_setup(m, flat_opt=flat)
            lr = state.tx.lr(state.opt_state.count)
            state, metrics = step(state, batch)
            runs[form] = step_record(m, state, metrics, lr)
    errs = check_step_pair(runs["flat"], runs["per-leaf"], "flat vs per-leaf")
    log(f"12(a) flat update vector vs per-leaf, one step at B={len(batch['img'])}, {IMGSZ} "
        "(deterministic, TF32 off): " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + " (phase 7's limits)")
    for form, flat in forms.items():
        m = copy.deepcopy(model)
        state, step = _train_setup(m, flat_opt=flat)
        phases[form] = train_phase_times(step, state, batch)
        log(f"12(a) {form} step phases ms at B={len(batch['img'])}: "
            + ", ".join(f"{k} {v:.2f}" for k, v in phases[form].items()) + f" on {ident}")
    grads = [p.grad for p in m.parameters()]
    spare = torch.zeros_like(state.flat)
    # single calls between CUDA events (host time included)
    copy_ms = time_ms(lambda: state.apply_gradients(grads), reps=1, windows=10)
    bound_ms = time_ms(lambda: state.apply_gradients(state._grads), reps=1, windows=10)
    zero_ms = time_ms(spare.zero_, reps=1, windows=10)
    log(f"12(a) flat clip+AdamW+EMA over {state.flat.numel():,} elements (parameters 256-byte "
        f"aligned): gradients gathered by one multi-tensor copy {copy_ms:.3f} ms a call; "
        f"bound to the flat buffer (no gather) {bound_ms:.3f} ms plus a zero_ {zero_ms:.3f} ms "
        f"a step; per-leaf phase "
        f"{phases['per-leaf']['clip_adamw_ema']:.2f} ms, flat phase "
        f"{phases['flat']['clip_adamw_ema']:.2f} ms on {ident}")


def save_stall(state, root, name: str) -> str:
    """``save_epoch``'s stall of the loop, synchronous against background,
    and the background write's own ms (``wait`` right after), medians of 3
    saves that each write ``last`` and ``best``; the tree's MB."""
    import os
    from pathlib import Path

    ms = {}
    for background in (False, True):
        d = Path(root) / f"{name}-{background}"
        mgr = CheckpointManager(str(d), async_save=background)
        stall, write = [], []
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mgr.save_epoch(state, i, {}, {"loss": 1.0 / (i + 1)}, float("inf"), 0.0)
            t1 = time.perf_counter()
            mgr.wait()
            stall.append((t1 - t0) * 1e3)
            write.append((time.perf_counter() - t1) * 1e3)
        ms[background] = statistics.median(stall), statistics.median(write)
    mb = os.path.getsize(Path(root) / f"{name}-True" / "last.pt") / 1e6
    return (f"{name} ({mb:.1f} MB a file): synchronous {ms[False][0]:.1f} ms; background "
            f"stall {ms[True][0]:.1f} ms, its write {ms[True][1]:.1f} ms")


def ckpt_path(dev, ident: str, root) -> int:
    """12(b): ``save_epoch``'s stalls for the YOLO11n and YOLOX-s trees;
    ``train.cli`` for 2 epochs (background writes) and its resume to epoch
    3; a ``flat_opt`` state resumed from that ``last``, trained one epoch
    and saved in the background; ``val --ckpt`` of its checkpoint equal to
    that of the same state saved per-leaf. Returns kernel #1's launches."""
    from yolo_scratch_tpu_torch import val
    from yolo_scratch_tpu_torch.train import cli as train_cli

    for name, model in (("YOLO11n", build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5,
                                                 scale="n", device=dev)),
                        ("YOLOX-s", build_yolox("s", nc=80, ch=3, device=dev))):
        state = create_train_state(model, make_optimizer(), use_ema=True)
        log(f"12(b) save_epoch, {save_stall(state, root, name)} on {ident}")
    B, seed = TRAIN_BATCH, 42
    cli_dir, flat_dir, leaf_dir = (str(root / d) for d in ("cli", "flat", "leaf"))
    cli_args = ["--data", "synthetic", "--scale", "n", "--imgsz", str(IMGSZ), "--batch",
                str(B), "--ema", "--save-dir", cli_dir, "--seed", str(seed)]
    ds = SyntheticDataset(n=64, img_size=IMGSZ)  # the CLI's synthetic set
    train_idx, val_idx = train_cli.split_indices(len(ds), seed, 0.2)
    K.reset_launches()
    first = train_cli.main(cli_args + ["--epochs", "2"])
    left = sorted(p.name for p in root.joinpath("cli").iterdir())
    if not {"last.pt", "last.meta.json"} <= set(left) or any(n.endswith(".tmp") for n in left):
        raise AssertionError(f"train.cli left {left}")
    second = train_cli.main(cli_args + ["--epochs", "3"])
    resumed = [h["epoch"] for h in second["history"]]
    train_batches, val_batches = -(-len(train_idx) // B), -(-len(val_idx) // B)
    steps = CheckpointManager(cli_dir).load_raw("last")["step"]
    if resumed != [2] or steps != 3 * train_batches:
        raise AssertionError(f"train.cli resume: epochs {resumed}, {steps} steps")

    # a flat_opt state resumed from the CLI's last, one epoch, saved in the background
    model = build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n", device=dev)
    state = create_train_state(model, make_optimizer(), use_ema=True, flat_opt=True)
    state, start, _, _ = CheckpointManager(cli_dir).try_resume(state)
    step = build_train_step_custom(model, v8_loss_adapter(
        DetectionLossConfig(nc=model.nc, strides=model.strides)))
    loader = Loader(ds, B, max_gt=100, shuffle=True, seed=seed, indices=train_idx)
    try:
        for batch in loader:
            state, _ = step(state, batch)
    finally:
        loader.close()
    mgr = CheckpointManager(flat_dir)
    mgr.save_epoch(state, start, {}, {}, float("inf"), 0.0)
    mgr.wait()
    # the same state saved per-leaf: resumed across forms, written synchronously
    model = build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n", device=dev)
    leaf = create_train_state(model, make_optimizer(), use_ema=True)
    leaf, _, _, _ = CheckpointManager(flat_dir).try_resume(leaf)
    CheckpointManager(leaf_dir, async_save=False).save_epoch(leaf, start, {}, {},
                                                             float("inf"), 0.0)
    a, b = CheckpointManager(flat_dir).load_raw("last"), CheckpointManager(leaf_dir).load_raw(
        "last")
    if a["step"] != (3 + 1) * train_batches:
        raise AssertionError(f"the flat state's checkpoint holds step {a['step']}")
    for key in ("model", "ema"):
        if not all(torch.equal(a[key][k], b[key][k]) for k in a[key]):
            raise AssertionError(f"per-leaf re-save differs from the flat checkpoint in {key}")
    evals = [val.main(["--ckpt", d, "--which", "last", "--ema", "--imgsz", str(IMGSZ),
                       "--batch", str(B)]) for d in (flat_dir, leaf_dir)]
    if evals[0] != evals[1] or not all(np.isfinite(v) for v in evals[0].values()):
        raise AssertionError(f"val --ckpt flat {evals[0]} vs per-leaf {evals[1]}")
    launches = K.launches["nms_sweep_batched"]
    want = val_batches * 3 + 2 * -(-len(ds) // B)  # val.main scores the whole set
    if launches != want:
        raise AssertionError(f"12(b) launched kernel #1 {launches} times; want {want}: "
                             f"{val_batches} x 3 epochs + 2 val.main runs")
    log(f"12(b) train.cli, 2 epochs at {IMGSZ}, B={B}, background writes: "
        + ", ".join(f"epoch {h['epoch']} {h['train']['epoch_time_s']:.2f} s" for h in
                    first["history"])
        + f"; resumed for epochs {resumed} to step {steps}; a flat_opt state resumed from its "
        f"last, one epoch to step {a['step']}, saved in the background: val --ckpt --ema "
        f"equal to its per-leaf re-save (loss {evals[0]['loss']:.4f}, mAP50 "
        f"{evals[0]['mAP50']:.4g}); kernel #1 launches {launches}")
    return launches


def eval_step_plain_check(step, state, batch) -> str:
    """One val batch of a trained model through the eval ``step`` (kernel
    #1) against the same candidates through the plain sweep: the
    detections equal, and at least one."""
    b = batch_to_device(batch, step.device)
    feats = step.forward(b, state)
    dets = step.from_feats(feats, b)[1]
    with precision_scope(step.precision), torch.inference_mode():
        if step.decode_fn is None:
            m = step.model
            boxes, scores, labels, valid, _ = select_candidates(
                feats, m.nc, m.strides, m.reg_max, step.conf_threshold, step.pre_nms_topk)
        else:
            boxes, scores, labels, valid = _prefilter_batched(
                step.decode_fn(feats), step.conf_threshold, step.pre_nms_topk)
        keep = K._cap(K.nms_sweep_batched_plain(boxes, valid, step.iou_threshold), step.max_det)
        ref = _finish(boxes, scores, labels, keep, step.max_det, b["img"].shape[1])
    kept = int(dets[3].sum())
    if not all(torch.equal(g, r) for g, r in zip(dets, ref)) or kept == 0:
        raise AssertionError(f"kernel #1's detections ({kept}) differ from the plain sweep's "
                             "or are none")
    return f"{int(valid.sum())} swept (N={boxes.shape[1]}), {kept} kept"


def predictor_plain_check(pred: Predictor, imgs) -> str:
    """One batch through ``pred`` (kernel #1) against the same candidates
    through the plain sweep: the detections equal, and at least one."""
    with torch.inference_mode():
        feats = pred.forward_feats(imgs)
        got, ref = pred.postprocess_feats(feats), plain_packed(pred, feats)
    kept = int(got[..., 6].sum())
    if not torch.equal(got, ref) or kept == 0:
        raise AssertionError(f"kernel #1's detections ({kept}) differ from the plain sweep's "
                             "or are none")
    return f"{kept} kept over {len(imgs)} images"


def overfit_path(ident: str) -> int:
    """12(c): ``overfit_check`` on the card for each of :data:`OVERFIT_RUNS`,
    every epoch validating through kernel #1, then one val batch of the
    trained model held against the plain sweep. Returns the launches."""
    from yolo_scratch_tpu_torch import overfit_check

    launches = 0
    for kind, bf16 in OVERFIT_RUNS:
        K.reset_launches()
        t0 = time.perf_counter()
        final, trainer = overfit_check.run(OVERFIT_EPOCHS, bf16=bf16, model_kind=kind)
        seconds = time.perf_counter() - t0
        n = K.launches["nms_sweep_batched"]
        if n != 2 * OVERFIT_EPOCHS:
            raise AssertionError(f"overfit {kind} launched kernel #1 {n} times; want 2 val "
                                 f"batches x {OVERFIT_EPOCHS} epochs")
        launches += n
        plain = eval_step_plain_check(trainer._eval_step, trainer.state,
                                      next(iter(trainer.val_loader)))
        log(f"12(c) overfit_check {kind}{' --bf16' if bf16 else ''}, {OVERFIT_EPOCHS} epochs: "
            f"mAP50 {final['mAP50']:.4f} P {final['precision']:.4f} R {final['recall']:.4f} "
            f"(limit {OVERFIT_MIN[kind]}) in {seconds:.1f} s on {ident}; one val batch: "
            f"detections equal the plain sweep's, {plain}")
        if final["mAP50"] < OVERFIT_MIN[kind]:
            raise AssertionError(f"overfit {kind} bf16={bf16}: mAP50 {final['mAP50']:.4f} < "
                                 f"{OVERFIT_MIN[kind]}")
    return launches


def quant_path(ident: str, root) -> int:
    """12(d): ``train.cli`` at :data:`QUANT_IMGSZ` with EMA, then
    ``eval_quant`` on its ``last``: bf16 must detect, and int8 stay within
    :data:`QUANT_DELTA` mAP50 of it on the :data:`HELD_OUT` images pooled
    (the 12 val images' delta is reported); one val batch of each variant
    held against the plain sweep. Returns kernel #1's launches."""
    from yolo_scratch_tpu_torch import eval_quant
    from yolo_scratch_tpu_torch.train import cli as train_cli

    d = str(root / "quant")
    K.reset_launches()
    t0 = time.perf_counter()
    fit = train_cli.main(["--data", "synthetic", "--scale", "n", "--imgsz", str(QUANT_IMGSZ),
                          "--batch", str(TRAIN_BATCH), "--epochs", str(QUANT_EPOCHS), "--ema",
                          "--save-dir", d])
    train_s = time.perf_counter() - t0
    args = eval_quant.build_parser().parse_args(["--data", "synthetic", "--ckpt", d, "--which",
                                                 "last", "--imgsz", str(QUANT_IMGSZ)])
    out, variants = eval_quant.evaluate(args)
    # held-out images of the same generator (the CLI's set is seed 0's first 64),
    # scored pooled and in disjoint sets for the spread
    seed, sets, per = HELD_OUT
    held = SyntheticDataset(n=sets * per, img_size=QUANT_IMGSZ, seed=seed)
    t0 = time.perf_counter()
    pooled = {name: eval_quant.score(pred, held, np.arange(sets * per), args.batch, args.conf)
              for name, pred in variants.items()}
    parts = {name: [eval_quant.score(pred, held, np.arange(i * per, (i + 1) * per), args.batch,
                                     args.conf)["mAP50"] for i in range(sets)]
             for name, pred in variants.items()}
    held_s = time.perf_counter() - t0
    launches = K.launches["nms_sweep_batched"]
    ds, _, _ = train_cli.make_datasets(args)
    _, val_idx = train_cli.split_indices(len(ds), args.seed, args.val_split)
    # the val batches of each epoch, then of each variant; the held-out images
    # pooled and in sets, a variant
    want = (QUANT_EPOCHS * -(-len(val_idx) // TRAIN_BATCH) + 2 * -(-len(val_idx) // args.batch)
            + 2 * (-(-sets * per // args.batch) + sets * -(-per // args.batch)))
    if launches != want:
        raise AssertionError(f"12(d) launched kernel #1 {launches} times; want {want}")
    last = fit["history"][-1]["val"]
    log(f"12(d) train.cli {QUANT_EPOCHS} epochs at {QUANT_IMGSZ}, B={TRAIN_BATCH}, --ema in "
        f"{train_s:.1f} s (val mAP50 {last['mAP50']:.4f}); eval_quant on its last: bf16 "
        f"mAP50 {out['bf16']['mAP50']:.4f} / mAP50-95 {out['bf16']['mAP50-95']:.4f}, int8 "
        f"{out['int8']['mAP50']:.4f} / {out['int8']['mAP50-95']:.4f}, delta mAP50 "
        f"{out['delta_mAP50']:+.4f}, mAP50-95 {out['delta_mAP50_95']:+.4f} on {ident}")
    deltas = [q - b for q, b in zip(parts["int8"], parts["bf16"])]
    pooled_delta = pooled["int8"]["mAP50"] - pooled["bf16"]["mAP50"]
    log(f"12(d) the same two Predictors on {sets * per} held-out synthetic images (seed "
        f"{seed}; {held_s:.1f} s): bf16 mAP50 {pooled['bf16']['mAP50']:.4f} / mAP50-95 "
        f"{pooled['bf16']['mAP50-95']:.4f}, int8 {pooled['int8']['mAP50']:.4f} / "
        f"{pooled['int8']['mAP50-95']:.4f}, delta mAP50 {pooled_delta:+.4f}, mAP50-95 "
        f"{pooled['int8']['mAP50-95'] - pooled['bf16']['mAP50-95']:+.4f}; in {sets} disjoint "
        f"sets of {per}, bf16 / int8 mAP50 " + "; ".join(
            f"{b:.4f} / {q:.4f} ({q - b:+.4f})" for b, q in zip(parts["bf16"], parts["int8"]))
        + f"; delta spread {min(deltas):+.4f} .. {max(deltas):+.4f}")
    imgs = next(iter(Loader(ds, args.batch, indices=val_idx[: args.batch], prefetch=0)))["img"]
    for name, pred in variants.items():
        log(f"12(d) {name} Predictor, one val batch (B={args.batch}, K={pred.cfg.pre_nms_topk}, "
            f"class-aware): detections equal the plain sweep's, "
            f"{predictor_plain_check(pred, imgs)}")
    if out["bf16"]["mAP50"] <= 0.0 or pooled["bf16"]["mAP50"] <= 0.0:
        raise AssertionError("eval_quant: bf16 mAP50 is 0, so nothing was compared")
    if abs(pooled_delta) > QUANT_DELTA:
        raise AssertionError(f"int8 - bf16 mAP50 {pooled_delta:+.4f} on {sets * per} held-out "
                             f"images, beyond {QUANT_DELTA}")
    return launches


@contextlib.contextmanager
def cudnn_benchmark_off():
    """cuDNN's heuristics instead of its timed search (PyTorch's default, as
    a user's run of the tools has it): the search would time every conv
    shape of the small overfit and 320 px models anew, in each dtype."""
    flag = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = flag


def slice_h_phase(dev, ident: str) -> dict:
    """12: the modules of slice H on the card."""
    from pathlib import Path

    t_phase = time.perf_counter()
    batch = next(iter(Loader(SyntheticDataset(n=64, img_size=IMGSZ), TRAIN_BATCH, max_gt=100,
                             prefetch=0)))
    flat_opt_path(dev, ident, batch)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as td:
        launches = ckpt_path(dev, ident, Path(td))
        with cudnn_benchmark_off():
            launches += overfit_path(ident)
            launches += quant_path(ident, Path(td))
    log(f"slice H phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches)


# slice I (phase 13): the measurement entry points
HEADLINE_WINDOWS = 2  # of bench.py's 3, for the script's time limit


@contextlib.contextmanager
def bench_env(**knobs):
    """``bench.py``'s BENCH_* knobs set to ``knobs`` and the others unset,
    restored after."""
    names = ("BENCH_BATCH", "BENCH_TOPK", "BENCH_NSCAN", "BENCH_INT8", "BENCH_COCO")
    saved = {k: os.environ.pop(k, None) for k in names}
    os.environ.update({f"BENCH_{k}": str(v) for k, v in knobs.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def entry_check(dev) -> None:
    """13(a): ``entry()``'s forward + decode (f32, TF32 off) on the card
    against the CPU on one seeded 640 image: boxes and scores each within
    1e-4 of their max|ref| (the f32 map tolerance of phase 4)."""
    fn, (example,) = ENTRY.entry(dev)
    if tuple(example.shape) != (1, IMGSZ, IMGSZ, 1) or example.device.type != "cuda":
        raise AssertionError(f"entry()'s example: {tuple(example.shape)} on {example.device}")
    x = torch.from_numpy(np.random.RandomState(13).rand(1, IMGSZ, IMGSZ, 1).astype(np.float32))
    got = fn(x.to(dev)).cpu()
    ref = ENTRY.entry("cpu")[0](x)
    if tuple(got.shape) != (1, 8400, 9):
        raise AssertionError(f"entry forward: {tuple(got.shape)}, want (1, 8400, 9)")
    errs = [float((got[..., p] - ref[..., p]).abs().max() / ref[..., p].abs().max())
            for p in (slice(0, 4), slice(4, None))]
    if max(errs) > 1e-4:
        raise AssertionError(f"entry() card vs CPU: boxes {errs[0]:.3g}, scores {errs[1]:.3g} "
                             "of max|ref| (limit 1e-4)")
    log(f"13(a) entry forward: {tuple(got.shape)} on the card, equal to the CPU's to "
        f"{errs[0]:.3g} (boxes) / {errs[1]:.3g} (scores) of max|ref| (limit 1e-4)")


def headline_plain_check(dev) -> None:
    """13(c): one B=128 batch of the headline program per row at conf 0
    (all 512 candidates of every image valid) against the same maps through
    ``nms_sweep_batched_plain``, exactly."""
    for name, _, ch, nc in ROWS:
        model = BC.deploy_model(ch, nc, "n", IMGSZ, device=dev)
        pred, _ = HL.deploy_program(model, HEADLINE_B, 512, dev, conf=0.0, img=IMGSZ)
        x = BC.uint8_batches((HEADLINE_B, IMGSZ, IMGSZ, ch), dev, seed=13)
        with torch.inference_mode():
            feats = pred.forward_feats(x)
            got, ref = pred.postprocess_feats(feats), plain_packed(pred, feats)
        check_packed(got, HEADLINE_B, 300)
        if not torch.equal(got, ref):
            raise AssertionError(f"{name}: B={HEADLINE_B} conf-0 detections differ from the "
                                 "plain sweep")
        log(f"13(c) {name}: the headline program at B={HEADLINE_B}, conf 0, equals the plain "
            f"sweep ({int(got[..., 6].sum())} kept of {HEADLINE_B} x 512 valid candidates)")


def slice_i_phase(dev, ident: str) -> dict:
    """13: the measurement entry points on the card. Returns kernel #1's
    launches over the benches' runs."""
    t_phase = time.perf_counter()
    entry_check(dev)
    launches = 0

    def run(label: str, fn, *args, **kw) -> dict:
        nonlocal launches
        t0 = time.perf_counter()
        K.reset_launches()
        out = fn(*args, **kw)  # prints the bench's JSON line
        torch.cuda.synchronize()
        n = K.launches["nms_sweep_batched"]
        launches += n
        if out["device"]["platform"] != "gpu" or out["device"]["count"] < 1:
            raise AssertionError(f"{label}: its line names {out['device']}, not the card")
        log(f"13 {label}: {time.perf_counter() - t0:.1f} s, kernel #1 launched {n} times")
        out["_launches"] = n
        return out

    with bench_env():
        hl = run("(b) headline", HL.main, [], windows=HEADLINE_WINDOWS)
    for row in (hl, hl["coco_shaped"]):
        if row["nms_launches"] != row["batches_swept"] or row["value"] <= 0:
            raise AssertionError(f"{row['metric']}: kernel #1 launched {row['nms_launches']} "
                                 f"times for {row['batches_swept']} batches")
    if hl["_launches"] != hl["batches_swept"] + hl["coco_shaped"]["batches_swept"]:
        raise AssertionError(f"headline: kernel #1's counter read {hl['_launches']}")
    log(f"13(b) headline on {ident}: crater {hl['value']} img/s (median {hl['median']:.2f}, "
        f"windows {[round(w, 2) for w in hl['windows']]}), COCO {hl['coco_shaped']['value']} "
        f"(median {hl['coco_shaped']['median']:.2f}); valid detections per image "
        f"{hl['valid_per_image']} / {hl['coco_shaped']['valid_per_image']} (seeded weights: "
        "the sweep ran on empty sets)")
    headline_plain_check(dev)
    with bench_env(INT8=1, COCO=0, NSCAN=2):
        q = run("(d) headline BENCH_INT8=1", HL.main, [], windows=1)
    if not q["metric"].endswith("_int8") or q["nms_launches"] != q["batches_swept"]:
        raise AssertionError(f"BENCH_INT8=1: {q['metric']}, {q['nms_launches']} launches")
    lat = run("(e) latency", LAT.main, [])
    for kind in ("yolox", "yolo11"):
        run(f"(e) scale {kind} s", SCALE.main, ["--model", kind, "--scale", "s"])
    run("(e) breakdown", BREAK.main, ["--iters", "5"])
    ex = run("(e) export", BEXP.main, ["--nscan", "2"])
    if min(ex["nms_launches"].values()) == 0:
        raise AssertionError(f"export: kernel #1 launches {ex['nms_launches']}")
    run("(e) int8_scales", I8S.main, ["--scales", "m", "--batch", "32", "--nscan", "1"])
    e2e = run("(e) e2e", E2E.main, ["--n", "64", "--batch", "32"])
    sv = run("(e) serving", SERVE_B.main, ["--clients", "16", "--wait-ms", "5", "--duration", "5"])
    cell = sv["rows"][0]
    if cell["errors"] or not cell["completed"]:
        raise AssertionError(f"serving: {cell['errors']} failed of {cell['attempted']}")
    model = eval_model("yolo11_coco.json", 3, 80).to(dev)
    batches = EVB.batches_near_detections(model, range(4), 64, IMGSZ, 80, 24)
    ev = run("(e) eval", lambda: BC.emit(EVB.run(model, images=512, batch=64, imgsz=IMGSZ,
                                                  nc=80, per_class_host=False,
                                                  batches=batches)))
    agree, ties = ev["agreement_mAP50_95"], ev["tp_fp_score_ties"]
    if agree["marks_host_ap"] != agree["host"] or not agree["host"] > 0:
        raise AssertionError(f"eval: the device's marks give mAP50-95 {agree['marks_host_ap']} "
                             f"against the host matcher's {agree['host']}")
    if agree["device"] != agree["host"] and not ties:
        raise AssertionError(f"eval: device mAP50-95 {agree['device']} against host "
                             f"{agree['host']} with no TP and FP on one score")
    log(f"13(e) on {ident}: latency {lat['device_latency_ms']} ms (p50 "
        f"{lat['launch_p50_ms']}, p99 {lat['launch_p99_ms']}); export ratio {ex['ratio']}; "
        f"e2e host tier {e2e['host_tier']}; serving {cell['achieved_img_s']} img/s; eval "
        f"mAP50-95: the device's marks {agree['marks_host_ap']} = host {agree['host']}, "
        f"metrics_from_marks {agree['device']} ({ties} detections share a score with one of "
        f"the other kind), {ev['detections_per_image']:.1f} detections an image")
    log(f"slice I phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches, e2e=e2e)


# slice J (phase 14): the JAX repo's last tools
SLICE_J_IMAGES = 32  # each generated tree, at 640
SLICE_J_TRAIN = ("--scale", "n", "--imgsz", "320", "--batch", "16", "--epochs", "2",
                 "--workers", "0")
# per block, the card against the CPU: one probe batch's SQNR moves by up to
# 0.9 dB in the attention blocks when the f32 weights move by 1e-6 of
# themselves (the jitter control of 14(b), PR 14's chip run)
SQNR_CARD_CPU_DB = 1.5
PROFILE_ITERS = 5  # profile_forward's and profile_train's defaults


def generator_path(root) -> tuple:
    """14(a): a crater and a COCO tree (nc=80) written by the generators and
    read back by the port's readers; two 2-epoch ``train.cli`` runs on the
    COCO tree at 320, B=16 (plain, then with mosaic and mixup), validating
    through kernel #1, its counter zeroed just before each run and read
    just after. Returns (the two runs' directories, kernel #1's launches)."""
    from argparse import Namespace

    from yolo_scratch_tpu_torch import gen_coco_synth, gen_crater_synth
    from yolo_scratch_tpu_torch.train import cli as train_cli

    crater, coco = root / "crater", root / "coco"
    t0 = time.perf_counter()
    n = gen_crater_synth.generate(str(crater), SLICE_J_IMAGES, IMGSZ, seed=0)
    line = gen_coco_synth.generate(str(coco), SLICE_J_IMAGES, IMGSZ, nc=80, seed=0)
    for tree, want in ((crater, (1, 5)), (coco, (3, 80))):
        ds, ch, nc = train_cli.make_datasets(Namespace(data=str(tree), dataset="auto",
                                                       imgsz=IMGSZ))
        img, boxes, labels = ds[len(ds) - 1]
        if ((ch, nc) != want or len(ds) != SLICE_J_IMAGES or img.shape != (IMGSZ, IMGSZ, ch)
                or not len(boxes) or not np.isfinite(img).all()):
            raise AssertionError(f"{tree.name} tree read back as {len(ds)} images, ch/nc "
                                 f"{(ch, nc)}, {img.shape}, {len(boxes)} boxes")
    log(f"14(a) generators: {n} crater images and {line['images']} COCO images "
        f"({line['annotations']} boxes, nc=80) at {IMGSZ}, read back by data/crater.py and "
        f"data/coco.py, {time.perf_counter() - t0:.1f} s")
    n_val = int(SLICE_J_IMAGES * 0.2)
    val_batches, epochs = -(-n_val // 16), 2
    runs, launches = [], 0
    for name, extra in (("noaug", []), ("recipe", ["--mosaic", "1.0", "--mixup", "1.0"])):
        save = str(root / name)
        K.reset_launches()
        t0 = time.perf_counter()
        out = train_cli.main(["--data", str(coco), *SLICE_J_TRAIN, *extra, "--save-dir", save])
        torch.cuda.synchronize()
        n = K.launches["nms_sweep_batched"]
        hist = out["history"]
        if n != val_batches * epochs or len(hist) != epochs or not all(
                np.isfinite(h["train"]["loss"]) and np.isfinite(h["val"]["mAP50"]) for h in hist):
            raise AssertionError(f"train.cli on the COCO tree ({name}): kernel #1 launched {n} "
                                 f"times for {val_batches * epochs} val batches; {hist}")
        launches += n
        runs.append(save)
        log(f"14(a) train.cli {name} on the generated COCO tree (nc=80, 320, B=16, {epochs} "
            f"epochs): {time.perf_counter() - t0:.1f} s, kernel #1 launched {n} times, val "
            f"mAP50 {hist[-1]['val']['mAP50']:.4f}")
    return runs, launches


def sqnr_path(ident: str) -> None:
    """14(b): ``quant_sqnr`` at 640, B=4, two calibration batches, on the
    card (int8 blocks through ``yst::int8_conv2d``) and with ``--cpu``: the
    same blocks, each SQNR within ``SQNR_CARD_CPU_DB``, the mean difference
    within 0.1 dB. Beside it, the spread of the CPU's SQNR when the weights
    move by 1e-6 of themselves: f32 rounding alone moves the statistic that
    far in the attention blocks (one probe batch, the noise of every block
    before carried through the softmax)."""
    from yolo_scratch_tpu_torch import quant_sqnr
    from yolo_scratch_tpu_torch.infer import load_deploy_model

    flags = ["--imgsz", str(IMGSZ), "--batch", "4", "--calib-batches", "2", "--worst", "1000"]
    t0 = time.perf_counter()
    card = quant_sqnr.main(flags)
    t_card = time.perf_counter() - t0
    cpu = quant_sqnr.main(flags + ["--cpu"])
    if card["device"]["platform"] != "gpu" or cpu["device"]["platform"] != "cpu":
        raise AssertionError(f"quant_sqnr ran on {card['device']} and {cpu['device']}")
    got = {r["block"]: r["sqnr_db"] for r in card["worst"]}
    ref = {r["block"]: r["sqnr_db"] for r in cpu["worst"]}
    if card["blocks"] != cpu["blocks"] or got.keys() != ref.keys() or len(got) != card["blocks"]:
        raise AssertionError(f"quant_sqnr: {card['blocks']} blocks on the card, {cpu['blocks']} "
                             "on the CPU")
    diff = {k: abs(got[k] - ref[k]) for k in ref}
    worst, mean = max(diff, key=diff.get), float(np.mean(list(diff.values())))
    if diff[worst] > SQNR_CARD_CPU_DB or mean > 0.1:
        raise AssertionError(f"quant_sqnr {worst}: {got[worst]} dB on the card, {ref[worst]} on "
                             f"the CPU (limit {SQNR_CARD_CPU_DB}); mean difference {mean:.3f} "
                             "(limit 0.1)")
    data = Loader(SyntheticDataset(n=64, img_size=IMGSZ), 4, prefetch=0)
    it = iter(data)
    calib, probe = [next(it)["img"] for _ in range(2)], next(it)["img"]
    data.close()
    torch.manual_seed(14)
    model = load_deploy_model(device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1 + 1e-6 * torch.randn_like(p))
    jit = {r["block"]: r["sqnr_db"] for r in quant_sqnr.sqnr_rows(model, calib, probe)}
    jit_diff = {k: abs(jit[k] - ref[k]) for k in ref}
    jit_worst = max(jit_diff, key=jit_diff.get)
    log(f"14(b) quant_sqnr on {ident}: {card['blocks']} blocks, min {card['sqnr_min_db']} dB, "
        f"median {card['sqnr_median_db']} (CPU {cpu['sqnr_min_db']} / {cpu['sqnr_median_db']}); "
        f"card vs CPU at most {diff[worst]:.1f} dB ({worst}; limit {SQNR_CARD_CPU_DB}), mean "
        f"{mean:.3f}; the CPU with its weights jittered by 1e-6 moves at most "
        f"{jit_diff[jit_worst]:.1f} dB ({jit_worst}), mean "
        f"{float(np.mean(list(jit_diff.values()))):.3f}; {t_card:.1f} s on the card")


def forward_profile_path(dev, ident: str, root) -> int:
    """14(c): ``profile_forward`` at B=128, 640, plain and ``--full``;
    ``parse_trace`` on each trace; one ``--full`` batch at conf 0 against the
    plain sweep. Returns kernel #1's launches."""
    from yolo_scratch_tpu_torch import parse_trace as PT
    from yolo_scratch_tpu_torch import profile_forward as PF

    launches = 0
    for full in (False, True):
        tag = "full" if full else "forward"
        K.reset_launches()
        t0 = time.perf_counter()
        res = PF.main(["--top", "12"] + (["--full"] if full else []), out_dir=root / tag)
        n = K.launches["nms_sweep_batched"]
        launches += n
        want = (2 + PROFILE_ITERS) if full else 0
        if n != want or res["nms_launches"] != (PROFILE_ITERS if full else 0):
            raise AssertionError(f"profile_forward {tag}: kernel #1 launched {n} times, "
                                 f"{res['nms_launches']} in the trace; want {want}")
        parsed = PT.main(["--dir", str(root / tag), "--top", "12"])
        rel = abs(parsed["total_ms"] - res["total_ms"]) / res["total_ms"]
        trace = PT.load(parsed["trace"])
        sweeps = sum("nms_iou_mask_kernel" in e["name"] for e in PT.complete_events(trace, "kernel"))
        if parsed["source"] != "device kernels" or rel > 0.01 or sweeps != res["nms_launches"]:
            raise AssertionError(f"parse_trace {tag}: {parsed['source']}, total "
                                 f"{parsed['total_ms']:.4f} ms against profile_forward's "
                                 f"{res['total_ms']:.4f} ({rel:.2%}; limit 1%), {sweeps} sweeps")
        log(f"14(c) profile_forward {tag} on {ident}: B={res['batch']}, {res['events']} kernel "
            f"events, {res['ms_per_iter']:.3f} ms of kernels a call, top "
            f"{res['top'][0][0][:60]} {res['top'][0][1]:.3f} ms; parse_trace "
            f"{parsed['ms_per_iter']:.3f} ms ({rel:.3%} apart), copies "
            f"{parsed['copy_ms_per_iter']:.3f} ms; kernel #1 launched {n} times "
            f"({sweeps} in the trace); {time.perf_counter() - t0:.1f} s")
    pred, x, fn = PF.build(HEADLINE_B, IMGSZ, True, dev, conf=0.0)
    K.reset_launches()
    with torch.inference_mode():
        got = pack_detections(*fn())
        torch.cuda.synchronize()
        launches += K.launches["nms_sweep_batched"]
        feats = [f.float() for f in pred.model(x.to(torch.bfloat16))]
        ref = plain_packed(pred, feats)
    check_packed(got, HEADLINE_B, 300)
    kept = int(got[..., 6].sum())
    if not torch.equal(got, ref) or kept == 0:
        raise AssertionError(f"profile_forward --full at conf 0: detections differ from the "
                             f"plain sweep ({kept} kept)")
    log(f"14(c) profile_forward --full at conf 0, B={HEADLINE_B}: equal to the plain sweep "
        f"({kept} kept of {HEADLINE_B} x 512 candidates)")
    return launches


def train_profile_path(ident: str, root) -> None:
    """14(d): ``profile_train`` at its defaults (B=64, 640, bf16) with
    ``--scan 5``, then ``train_roofline`` and ``parse_trace`` on its trace:
    the stage shares sum to 100% within 0.1 and the whole-step span is
    positive."""
    from yolo_scratch_tpu_torch import parse_trace as PT
    from yolo_scratch_tpu_torch import profile_train as PTR
    from yolo_scratch_tpu_torch import train_roofline as TR

    t0 = time.perf_counter()
    res = PTR.main(["--scan", "5"], out_dir=root / "train")
    t_run = time.perf_counter() - t0
    roof = TR.main(["--dir", str(root / "train")])
    parsed = PT.main(["--dir", str(root / "train"), "--top", "10"])
    share = sum(roof["shares_pct"].values())
    if not np.isfinite(res["loss"]) or abs(share - 100.0) > 0.1 or roof["step_ms_per_iter"] <= 0 \
            or roof["source"] != "device kernels":
        raise AssertionError(f"profile_train / train_roofline: loss {res['loss']}, shares sum "
                             f"{share:.3f}%, step {roof['step_ms_per_iter']} ms, "
                             f"{roof['source']}")
    log(f"14(d) profile_train on {ident}: B=64, 640, bf16: first loss {res['loss']:.4f}, "
        f"{res['step_ms']:.1f} ms a step ({res['imgs_per_sec']:.1f} img/s), back to back x5 "
        f"{res['scan_step_ms']:.1f} ms ({res['scan_imgs_per_sec']:.1f} img/s), {t_run:.1f} s; "
        f"train_roofline: whole step {roof['step_ms_per_iter']:.2f} ms on the card, stages "
        + ", ".join(f"{k} {v:.2f} ms ({roof['shares_pct'][k]:.1f}%)"
                    for k, v in roof["stages_ms_per_iter"].items())
        + f" (sum {share:.2f}%); parse_trace: {parsed['ms_per_iter']:.2f} ms of kernels a step "
        f"in {parsed['events'] // PROFILE_ITERS} kernels")


def slice_j_phase(dev, ident: str) -> dict:
    """14: the JAX repo's last tools on the card. Returns kernel #1's
    launches over the phase's runs."""
    from yolo_scratch_tpu_torch import ab_report

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        root = Path(tmp)
        runs, launches = generator_path(root)
        sqnr_path(ident)
        launches += forward_profile_path(dev, ident, root)
        train_profile_path(ident, root)
        summary = ab_report.main(["--a", runs[0], "--b", runs[1], "--every", "1",
                                  "--out", str(root / "AB_RECIPE.json")])
        if json.loads((root / "AB_RECIPE.json").read_text()) != summary or \
                summary["baseline"]["epochs"] != 2:
            raise AssertionError(f"ab_report: {summary}")
        log(f"14(e) ab_report on the two COCO runs: delta best mAP50 "
            f"{summary['delta_best_mAP50']}")
    log(f"slice J phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches)


# slice K (phase 15): the JAX package's checkpoints, read by the port's own
# code (OCDBT, zarr v2, zstd), deployed and resumed on the card. The card's
# machine has no JAX to write one, so the fixture is committed.
FIXTURE = Path(__file__).resolve().parent / "tests" / "fixtures" / "jax_ckpt"
FIXTURE_CFG = FIXTURE / "yolo11_crater_tiny.yaml"  # JSON text; its one scale is "t"
FIXTURE_FORMS = ("leaf", "flat", "npz")


def leaf_sha256(tree, path=()) -> dict:
    """{"a/b/c": {"dtype", "shape", "sha256"} | None | {}} of a nested dict,
    as ``tests/fixtures/jax_ckpt/digests.json`` holds them."""
    out = {}
    if isinstance(tree, dict) and tree:
        for k, v in tree.items():
            out.update(leaf_sha256(v, path + (k,)))
    elif tree is None or isinstance(tree, dict):
        out["/".join(map(str, path))] = tree
    else:
        a = np.ascontiguousarray(tree)
        out["/".join(map(str, path))] = {"dtype": a.dtype.str, "shape": list(a.shape),
                                         "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
    return out


def read_fixture(form: str) -> dict:
    from yolo_scratch_tpu_torch.train.jax_checkpoints import read_jax_npz, read_orbax

    d = FIXTURE / form
    return read_jax_npz(d / "last.npz") if form == "npz" else read_orbax(d / "last")


def decoder_build_path() -> None:
    """15(a): the package's first load of the zstd decoder, which g++ builds
    from its source here, linking nothing but the C++ runtime."""
    from yolo_scratch_tpu_torch.utils import zstd

    if zstd._lib is not None:
        raise AssertionError("the zstd decoder was loaded before phase 15")
    zstd.LIBRARY.unlink(missing_ok=True)  # a build left by an earlier run
    t0 = time.perf_counter()
    zstd.load()
    build_s = time.perf_counter() - t0
    needed = subprocess.run(["ldd", str(zstd.LIBRARY)], capture_output=True, text=True,
                            check=True).stdout
    if "zstd" in needed:
        raise AssertionError(f"the zstd decoder links libzstd:\n{needed}")
    log(f"15(a) zstd decoder: g++ built and loaded {zstd.SOURCE.name} in {build_s:.2f} s "
        f"(needs {', '.join(sorted(n.split()[0] for n in needed.splitlines() if '=>' in n))})")


def fixture_digest_path() -> None:
    """15(b): every leaf of every fixture form, read on this host, against
    the sha256, dtype and shape that orbax restored where it was written."""
    want = json.loads((FIXTURE / "digests.json").read_text())
    for form in FIXTURE_FORMS:
        got = leaf_sha256(read_fixture(form))
        if got != want[form]:
            bad = sorted(k for k in want[form] if got.get(k) != want[form][k])
            raise AssertionError(f"fixture {form}: {len(bad)} leaves differ from digests.json, "
                                 f"e.g. {bad[:3]}; missing/extra {sorted(set(got) ^ set(want[form]))[:3]}")
        arrays = sum(1 for v in got.values() if isinstance(v, dict) and v)
        log(f"15(b) fixture {form}: all {arrays} arrays equal their digests")


def fixture_serve_path(dev, ident: str) -> int:
    """15(c): ``load_deploy_model(ckpt=<fixture>)`` served by
    ``Predictor.predict_batch`` at 640, B=32, kernel #1's counter zeroed just
    before and read just after; at conf 0 the detections equal the same feats
    through the plain sweep; the card's f32 forward equals the CPU's.
    Returns kernel #1's launches."""
    model = load_deploy_model(FIXTURE_CFG, scale="t", ckpt=FIXTURE / "leaf", which="last",
                              device=dev)
    if (model.in_ch, model.nc) != (1, 5):
        raise AssertionError(f"fixture model read as ch={model.in_ch}, nc={model.nc}")
    pred = Predictor(model, PredictorConfig(img_size=IMGSZ, batch_size=BATCH,
                                            conf_threshold=0.0), device=dev)
    xs = [np.random.RandomState(150 + i).randint(0, 256, (BATCH, IMGSZ, IMGSZ, 1),
                                                 dtype=np.uint8) for i in range(2)]
    K.reset_launches()
    for x in xs:
        check_packed(pred.predict_batch(x), BATCH, 300)
    torch.cuda.synchronize()
    n = K.launches["nms_sweep_batched"]
    if n != len(xs):
        raise AssertionError(f"the fixture's Predictor launched kernel #1 {n} times for "
                             f"{len(xs)} batches")
    with torch.inference_mode():
        feats = pred.forward_feats(xs[0])
        got, ref = pred.postprocess_feats(feats), plain_packed(pred, feats)
    kept = int(got[..., 6].sum())
    if not torch.equal(got, ref) or kept == 0:
        raise AssertionError(f"fixture: conf-0 detections differ from the plain sweep "
                             f"({kept} kept)")
    forward_check("15(c) fixture (JAX checkpoint)", model, xs[1][:2], dev)
    log(f"15(c) fixture served at {IMGSZ}, B={BATCH}, conf 0 on {ident}: kernel #1 launched "
        f"{n} times, detections equal the plain sweep's ({kept} kept)")
    return n


def fixture_resume_path(dev, tmp: Path) -> int:
    """15(d): ``Trainer.fit(resume=True)`` on a copy of the fixture's
    per-leaf run directory, one epoch at 640 on synthetic data: the state
    right after the resume equals the port tree read from the fixture
    (weights, EMA, moments, count, step) and training starts at the
    fixture's epoch + 1. Returns kernel #1's launches (its validation)."""
    import shutil

    from yolo_scratch_tpu_torch.train.jax_checkpoints import port_tree_from_jax
    from yolo_scratch_tpu_torch.train.trainer import Trainer, TrainerConfig

    run = tmp / "resume"
    shutil.copytree(FIXTURE / "leaf", run)
    epoch = json.loads((run / "last.meta.json").read_text())["epoch"]
    want = port_tree_from_jax(read_fixture("leaf"))
    ds = SyntheticDataset(n=32, img_size=IMGSZ)
    train = Loader(ds, 16, shuffle=True, prefetch=0)
    val = Loader(ds, 16, prefetch=0, indices=list(range(16)))
    model = build_yolo11(FIXTURE_CFG, ch=1, nc=5, scale="t").to(dev)
    trainer = Trainer(model, train, val, TrainerConfig(epochs=epoch + 2, save_dir=str(run),
                                                       use_ema=True, eval_with_ema=True))
    if not trainer.resume() or trainer.start_epoch != epoch + 1:
        raise AssertionError(f"resume of the fixture started at epoch {trainer.start_epoch}")
    st = trainer.state
    names = [n for n, _ in model.named_parameters()]
    sd = model.state_dict()
    checks = [torch.equal(sd[k].cpu(), v) for k, v in want["model"].items()]
    for n, m, v in zip(names, st.per_param(st.opt_state.mu), st.per_param(st.opt_state.nu)):
        checks += [torch.equal(m.cpu(), want["opt_state"]["mu"][n]),
                   torch.equal(v.cpu(), want["opt_state"]["nu"][n]),
                   torch.equal(st.ema[n].cpu(), want["ema"][n])]
    if not all(checks) or (st.step, st.opt_state.count) != (want["step"],
                                                             want["opt_state"]["count"]):
        raise AssertionError(f"resumed fixture state differs: {checks.count(False)} tensors, "
                             f"step {st.step} / {want['step']}")
    K.reset_launches()
    t0 = time.perf_counter()
    out = trainer.fit(resume=True)
    torch.cuda.synchronize()
    n = K.launches["nms_sweep_batched"]
    hist = out["history"]
    if [h["epoch"] for h in hist] != [epoch + 1] or n != len(val) or not all(
            np.isfinite(h["train"]["loss"]) for h in hist):
        raise AssertionError(f"fit(resume=True) on the fixture: {hist}, kernel #1 launched "
                             f"{n} times for {len(val)} val batches")
    train.close()
    val.close()
    log(f"15(d) fixture resumed at epoch {epoch + 1} (step {want['step']}, count "
        f"{want['opt_state']['count']}: weights, EMA and moments equal the fixture's), one "
        f"epoch at {IMGSZ}, B=16 in {time.perf_counter() - t0:.1f} s, loss "
        f"{hist[0]['train']['loss']:.4f}, kernel #1 launched {n} times in its validation")
    return n


def reader_timing_path(ident: str) -> None:
    """15(e): the reader's seconds on the fixture on this host (best of 5),
    and the decoder's MB/s over the fixture's zstd chunks (decoded bytes
    over decode seconds, best of 5). Host code: the card takes no part."""
    from yolo_scratch_tpu_torch.utils import zstd
    from yolo_scratch_tpu_torch.utils.ocdbt import OcdbtStore

    def best(fn, reps=5):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return min(times)

    secs = {form: best(lambda f=form: read_fixture(f)) for form in FIXTURE_FORMS}
    with OcdbtStore(FIXTURE / "leaf" / "last") as store:
        frames = [v for v in (store.get(k) for k in store.list()) if v[:4] == b"\x28\xb5\x2f\xfd"]
    out_bytes = sum(len(zstd.decompress(f)) for f in frames)
    dec_s = best(lambda: [zstd.decompress(f) for f in frames])
    log(f"15(e) reader on the fixture, this host ({ident} beside it; host code): "
        + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in secs.items())
        + f"; zstd decoder {out_bytes / dec_s / 1e6:.1f} MB/s over the fixture's "
        f"{len(frames)} frames ({out_bytes / 1e6:.2f} MB out, "
        f"{sum(map(len, frames)) / 1e6:.2f} MB in)")


def slice_k_phase(dev, ident: str) -> dict:
    """15: a JAX run directory (the committed fixture) read, served and
    resumed on the card. Returns kernel #1's launches."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        decoder_build_path()
        fixture_digest_path()
        launches = fixture_serve_path(dev, ident)
        launches += fixture_resume_path(dev, Path(tmp))
        reader_timing_path(ident)
    log(f"slice K phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launches)


# the host tier (phase 16): the port's own PNG/JPEG decoders under predict_paths
HOST_SRC = (1024, 768)  # files larger than the canvas: fast_jpeg decodes them at 5/8
HOST_FILES = 64  # two B=32 batches an arm
# the native tier's batch against the cv2 tier's: both resize with cv2's
# half-pixel geometry but round differently (tests/test_native_loader.py)
CV2_TIER_ATOL = 2 / 255


HOST_BUILD_S: list = []  # the host library's first build in this process


def build_host_library() -> None:
    """The package's first load of the host library, which g++ builds from
    the port's sources (a build left by an earlier run is removed first)."""
    import shutil

    from yolo_scratch_tpu_torch.data import native

    native.LIBRARY.unlink(missing_ok=True)
    shutil.rmtree(native.OBJ_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    native.load()
    HOST_BUILD_S.append(time.perf_counter() - t0)


def host_build_path() -> None:
    """16(a): the host library's first build (phase 2 starts it beside the
    nvcc builds; one g++ a source, then the link), its ``ldd``, and the
    package's own load, which must succeed: no silent cv2 tier."""
    from yolo_scratch_tpu_torch.data import native

    if not HOST_BUILD_S:
        build_host_library()
    needed = subprocess.run(["ldd", str(native.LIBRARY)], capture_output=True, text=True,
                            check=True).stdout
    if any(lib in needed for lib in ("png", "jpeg", "libz.")):
        raise AssertionError(f"the host library links a codec library:\n{needed}")
    if not native.available():
        raise AssertionError(f"the native host tier does not load: {native._load_error}")
    log(f"16(a) host library: g++ built {len(native.SOURCES)} sources and linked them in "
        f"{HOST_BUILD_S[0]:.2f} s at first load "
        f"(needs {', '.join(sorted(n.split()[0] for n in needed.splitlines() if '=>' in n))}); "
        f"native tier on")


def host_files(root: Path, n: int) -> dict:
    """``n`` crater-like images at ``HOST_SRC``: gray PNGs (cv2) and RGB
    JPEGs (PIL, 4:2:0, quality 90), {"png": [...], "jpeg": [...]}. Gray
    PNGs, because cv2 turns colour PNGs to gray with its own weights where
    libpng (both native tiers) mixes in linear light; a JPEG's gray is its
    Y plane in every tier."""
    from PIL import Image

    w, h = HOST_SRC
    rng = np.random.RandomState(16)
    y, x = np.mgrid[0:h, 0:w]
    img = 110 + 50 * np.sin(x / 9.0) * np.cos(y / 11.0)
    for cx, cy, r in rng.uniform(0.1, 0.9, (12, 3)) * [w, h, 60]:
        img -= 60 * np.exp(-((x - cx) ** 2 + (y - cy) ** 2) / (2 * r * r + 1))
    base = np.clip(img, 6, 249).astype(np.int16)
    out = {"png": [], "jpeg": []}
    for i in range(n):  # each file the scene shifted, with its own noise
        g = (np.roll(base, (37 * i, 53 * i), (0, 1))
             + rng.randint(-6, 7, base.shape)).astype(np.uint8)
        rgb = np.stack([g, (g >> 1) + (g >> 2) + 40, 255 - g], -1)
        out["png"].append(str(root / f"h{i:03d}.png"))
        cv2.imwrite(out["png"][-1], g)
        out["jpeg"].append(str(root / f"h{i:03d}.jpg"))
        Image.fromarray(rgb).save(out["jpeg"][-1], "JPEG", quality=90)
    return out


def decoder_vs_cv2_path(root: Path) -> None:
    """16(b): the port's decoder against ``cv2.imdecode`` (OpenCV's own
    libpng and libjpeg-turbo) on files cv2 and PIL write here: PNGs exactly
    (gray and RGB), baseline and progressive JPEGs exactly at full size and
    at ``IMREAD_REDUCED_*_2/4/8`` (scale_num 4, 2, 1)."""
    from PIL import Image

    from yolo_scratch_tpu_torch.data import native

    rng = np.random.RandomState(161)
    y, x = np.mgrid[0:479, 0:641]
    base = np.sin(x / 13.0) * 60 + np.cos(y / 9.0) * 50 + 128
    rgb = np.clip(np.stack([base + rng.randn(479, 641) * 15 + 20 * k for k in range(3)], -1),
                  0, 255).astype(np.uint8)
    files = {}
    for name, img in (("gray", rgb[..., 0]), ("rgb", rgb)):
        files[f"png_{name}_cv2"] = cv2.imencode(".png", img if img.ndim == 2 else img[..., ::-1])[1]
        b = io.BytesIO()
        Image.fromarray(img).save(b, "PNG")
        files[f"png_{name}_pil"] = b.getvalue()
    for prog in (False, True):
        for sub in (0, 2):
            b = io.BytesIO()
            Image.fromarray(rgb).save(b, "JPEG", quality=88, subsampling=sub, progressive=prog)
            files[f"jpeg_pil_{'444' if sub == 0 else '420'}{'_prog' if prog else ''}"] = b.getvalue()
        files[f"jpeg_cv2{'_prog' if prog else ''}"] = cv2.imencode(
            ".jpg", rgb[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 92, cv2.IMWRITE_JPEG_PROGRESSIVE,
                                     int(prog)])[1]
        b = io.BytesIO()
        Image.fromarray(rgb[..., 1]).save(b, "JPEG", quality=80, progressive=prog)
        files[f"jpeg_gray{'_prog' if prog else ''}"] = b.getvalue()
    reduced = {8: (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE),
               4: (cv2.IMREAD_REDUCED_COLOR_2, cv2.IMREAD_REDUCED_GRAYSCALE_2),
               2: (cv2.IMREAD_REDUCED_COLOR_4, cv2.IMREAD_REDUCED_GRAYSCALE_4),
               1: (cv2.IMREAD_REDUCED_COLOR_8, cv2.IMREAD_REDUCED_GRAYSCALE_8)}
    compared = 0
    for name, data in files.items():
        data = bytes(data)
        gray_src = "gray" in name
        for num, (flag_rgb, flag_gray) in reduced.items():
            if name.startswith("png") and num != 8:
                continue
            for ch in (1, 3):
                if name.startswith("png") and (ch == 1) != gray_src:
                    continue  # cv2 converts PNG colour with its own weights
                want = cv2.imdecode(np.frombuffer(data, np.uint8),
                                    flag_gray if ch == 1 else flag_rgb)
                want = want[..., None] if ch == 1 else want[..., ::-1]
                got = native.decode_bytes(data, ch, num)
                if got.shape != want.shape or not np.array_equal(got, want):
                    d = (np.abs(got.astype(int) - want.astype(int)).max()
                         if got.shape == want.shape else f"shape {got.shape} vs {want.shape}")
                    raise AssertionError(f"16(b) {name} ch{ch} {num}/8: the port's decode "
                                         f"differs from cv2.imdecode ({d})")
                compared += 1
    log(f"16(b) decoder: {compared} decodes of {len(files)} cv2/PIL files (PNG gray/RGB, "
        f"JPEG baseline/progressive 4:4:4/4:2:0/gray, full size and cv2's reduced 1/2, 1/4, "
        f"1/8) equal cv2.imdecode byte for byte (cv2 {cv2.__version__})")


CODEC_FIXTURES = Path(__file__).resolve().parent / "tests" / "fixtures" / "host_codecs"


def fixture_bytes(name: str, cut) -> bytes:
    data = (CODEC_FIXTURES / name).read_bytes()
    return data if cut is None else data[: int(len(data) * cut)]


def host_decode_ms(data: bytes, ch: int, num: int, reps: int) -> float:
    """Median ms of one ``native.decode_bytes`` call (host code, one thread)."""
    from yolo_scratch_tpu_torch.data import native

    native.decode_bytes(data, ch, num)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        native.decode_bytes(data, ch, num)
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def codec_fixture_path(ident: str) -> None:
    """16(b), continued: every committed codec fixture (and each listed cut
    of it) at channels 1 and 3 and each scale_num in ``digests.json`` equals
    the sha256 and shape of libjpeg-turbo/libpng's decode there, or fails
    where they fail; then the host decode times of an arithmetic-coded
    1024x768 JPEG against its Huffman source and of a smoothed cut."""
    from yolo_scratch_tpu_torch.data import native

    digests = json.loads((CODEC_FIXTURES / "digests.json").read_text())
    for name, info in digests["files"].items():
        data = (CODEC_FIXTURES / name).read_bytes()
        if hashlib.sha256(data).hexdigest() != info["sha256"]:
            raise AssertionError(f"16(b) fixture {name} is not the committed file")
    checked = 0
    for key, want in digests["decodes"].items():
        name, cut, ch, num = key.split("|")
        data = fixture_bytes(name, float(cut) if cut else None)
        try:
            got = native.decode_bytes(data, int(ch), int(num))
        except IOError:
            got = None
        if want is None or got is None:
            if (want is None) != (got is None):
                raise AssertionError(f"16(b) {key}: the port's status differs from the "
                                     f"reference's (reference fails: {want is None})")
        elif (list(got.shape) != want["shape"]
              or hashlib.sha256(got.tobytes()).hexdigest() != want["sha256"]):
            raise AssertionError(f"16(b) {key}: the port's decode is not the reference's "
                                 f"({list(got.shape)} vs {want['shape']})")
        checked += 1
    arith, huff = fixture_bytes("crater_arith_0.jpg", None), fixture_bytes("crater_huffman_0.jpg",
                                                                            None)
    rows = []
    for num in (8, 5):
        ms_a, ms_h = host_decode_ms(arith, 3, num, 15), host_decode_ms(huff, 3, num, 15)
        rows.append(f"{num}/8: arithmetic {ms_a:.2f} ms ({1e3 / ms_a:.1f} img/s), Huffman "
                    f"{ms_h:.2f} ms ({1e3 / ms_h:.1f} img/s), x{ms_a / ms_h:.2f}")
    cut = fixture_bytes("crater_prog_0.jpg", 0.35)
    whole = fixture_bytes("crater_prog_0.jpg", None)
    ms_cut, ms_whole = host_decode_ms(cut, 3, 8, 15), host_decode_ms(whole, 3, 8, 15)
    log(f"16(b) codec fixtures: {checked} decodes of {len(digests['files'])} fixtures equal "
        f"libjpeg-turbo 2.1.5 / libpng 1.6.39's (digests.json); host decode of a 1024x768 "
        f"4:2:0 JPEG to RGB on {host_cpu()}, one thread, beside {ident}: " + "; ".join(rows)
        + f"; progressive cut to 35% (block-smoothed) {ms_cut:.2f} ms, whole {ms_whole:.2f} ms")


def host_predict_path(dev, ident: str, files: dict) -> int:
    """16(c): ``predict_paths`` at 640, B=32 on both rows through the native
    tier, for PNG, JPEG and JPEG with ``fast_jpeg``. Kernel #1's counter is
    zeroed just before each arm and read just after: one launch a batch.
    The first batch's conf-0 detections equal the plain sweep on the same
    feats, and predict_paths' own results for it equal those unmapped; the
    prepared batch lies within ``CV2_TIER_ATOL`` of the cv2 tier's (PNG,
    and JPEG decoded at full size). Returns kernel #1's launches."""
    from yolo_scratch_tpu_torch.host import detections, prepare_images_cv2

    launches = 0
    summary = []
    for row, cfg_name, ch, nc in ROWS:
        model = eval_model(cfg_name, ch, nc).to(dev)
        for fmt, fast in (("png", False), ("jpeg", False), ("jpeg", True), ("arith", False),
                          ("arith", True)):
            paths = files[fmt]
            pred = Predictor(model, PredictorConfig(img_size=IMGSZ, batch_size=BATCH,
                                                    conf_threshold=0.0, fast_jpeg=fast),
                             device=dev)
            with cudnn_benchmark_off():
                list(pred.predict_paths(paths[:BATCH]))  # warm-up
                torch.cuda.synchronize()
                K.reset_launches()
                t0 = time.perf_counter()
                out = list(pred.predict_paths(paths))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                n = K.launches["nms_sweep_batched"]
                batches = -(-len(paths) // BATCH)
                if n != batches or len(out) != len(paths):
                    raise AssertionError(f"16(c) {row} {fmt} fast_jpeg={fast}: kernel #1 "
                                         f"launched {n} times for {batches} batches")
                launches += n
                imgs, meta = pred._prepare(paths[:BATCH])
                if imgs.dtype != np.uint8:
                    raise AssertionError(f"16(c): the native tier gave {imgs.dtype}, not uint8")
                with torch.inference_mode():
                    feats = pred.forward_feats(imgs)
                    got, ref = pred.postprocess_feats(feats), plain_packed(pred, feats)
            kept = int(got[..., 6].sum())
            if not torch.equal(got, ref) or kept == 0:
                raise AssertionError(f"16(c) {row} {fmt}: conf-0 detections differ from the "
                                     f"plain sweep ({kept} kept)")
            packed = ref.cpu().numpy()
            for j in range(BATCH):
                want = detections(packed[j], meta[j], IMGSZ)
                have = out[j]
                if have["labels"] != want["labels"] or not np.allclose(
                        have["boxes"], want["boxes"], rtol=0, atol=1e-3) or not np.allclose(
                        have["scores"], want["scores"], rtol=0, atol=1e-6):
                    raise AssertionError(f"16(c) {row} {fmt}: predict_paths' image {j} differs "
                                         f"from the plain sweep's detections")
            note = ""
            if fmt == "arith":  # the Huffman source's batch, byte for byte
                twin, twin_meta = pred._prepare([str(CODEC_FIXTURES / "crater_huffman_0.jpg")])
                if not (np.array_equal(twin, imgs[:1]) and np.array_equal(twin_meta, meta[:1])):
                    raise AssertionError(f"16(c) {row} arith fast_jpeg={fast}: the batch differs "
                                         "from its Huffman source's")
                note = ", = its Huffman source's batch"
            elif not fast:  # fast_jpeg resizes from a smaller decode than cv2's
                cv_imgs, cv_meta = prepare_images_cv2(paths[:BATCH], pred.cfg, ch)
                diff = float(np.abs(imgs.astype(np.float32) / 255 - cv_imgs).max())
                if diff > CV2_TIER_ATOL + 1e-6 or not np.allclose(meta, cv_meta):
                    raise AssertionError(f"16(c) {row} {fmt}: the native batch lies "
                                         f"{diff * 255:.1f}/255 from the cv2 tier's")
                note = f", |native - cv2| {diff * 255:.0f}/255"
            summary.append(f"{row} {fmt}{' fast_jpeg' if fast else ''} "
                           f"{len(paths) / wall:.1f} img/s ({kept} kept{note})")
    log(f"16(c) predict_paths at {IMGSZ}, B={BATCH}, conf 0, {HOST_FILES} paths of "
        f"{HOST_SRC[0]}x{HOST_SRC[1]} an arm (arith: the four fixtures in turn), native tier, "
        f"on {ident}: "
        + "; ".join(summary) + f"; kernel #1 launched {launches} times, once a batch")
    return launches


def host_cpu() -> str:
    """The host's CPU as ``lscpu`` (else ``/proc/cpuinfo``) names it: its
    model name, else (a sandbox may report it as "unknown") its vendor,
    family and model numbers."""
    import platform

    try:
        info = subprocess.run(["lscpu"], capture_output=True, text=True).stdout
    except OSError:
        info = ""
    cpuinfo = Path("/proc/cpuinfo")
    info += cpuinfo.read_text() if cpuinfo.exists() else ""
    fields = {}
    for line in info.splitlines():
        key, _, value = line.partition(":")
        if value.strip():
            fields.setdefault(key.strip().lower(), value.strip())
    if fields.get("model name", "unknown") != "unknown":
        return fields["model name"]
    parts = [f"{k} {fields[k]}" for k in ("vendor id", "cpu family", "model", "architecture")
             if k in fields]
    return ", ".join(parts) or platform.machine()


def host_bench_path(ident: str, e2e: dict) -> None:
    """16(d): ``bench.ingest`` (16 files of 1024^2) with its native rows,
    and phase 13's ``bench.e2e`` line (64 files), which must have run on
    the native tier."""
    ing = ING.cli(["16", "1024"])
    if "native" not in ing["tiers"] or "smooth_jpeg_uint8_fastscale_img_per_s" not in ing:
        raise AssertionError(f"16(d) ingest ran without its native rows: {ing['tiers']}")
    if e2e["host_tier"] != "native" or not e2e["nms_launches"]:
        raise AssertionError(f"16(d): phase 13's e2e ran on the {e2e['host_tier']} tier")
    keys = [k for k in ing if k.endswith("_img_per_s")]
    log(f"16(d) on {ident}, host {host_cpu()} ({os.cpu_count()} cores): ingest img/s "
        + ", ".join(f"{k[:-len('_img_per_s')]} {ing[k]}" for k in keys)
        + "; phase 13's e2e img/s (native tier) "
        + ", ".join(f"{r['fmt']}{' fast_jpeg' if r['fast_jpeg'] else ''} {r['img_per_s']}"
                    for r in e2e["rows"]))


def host_phase(dev, ident: str, e2e: dict) -> dict:
    """16: the port's own host tier on the card's machine; ``e2e`` is phase
    13's e2e line. Returns kernel #1's launches."""
    t_phase = time.perf_counter()
    marks = []

    def mark(label: str) -> None:
        marks.append(f"{label} {time.perf_counter() - t_phase:.1f}")

    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        host_build_path()
        decoder_vs_cv2_path(Path(tmp))
        codec_fixture_path(ident)
        mark("(a)+(b)")
        files = host_files(Path(tmp), HOST_FILES)
        files["arith"] = [str(CODEC_FIXTURES / f"crater_arith_{i % 4}.jpg")
                          for i in range(HOST_FILES)]
        mark("files")
        launches = host_predict_path(dev, ident, files)
        mark("(c)")
    host_bench_path(ident, e2e)
    mark("(d)")
    log(f"host phase: {time.perf_counter() - t_phase:.1f} s (cumulative s: {', '.join(marks)})")
    return dict(launches=launches)


def across_cards(dev, ident: str) -> int:
    """Phase 10(e) on a machine with 2 or more cards: (c) over NCCL with one
    card a rank, (d) over every card, and the GPU test of a kernel launched
    on a card that is not the current one. Returns kernel #1's launches."""
    cards = torch.cuda.device_count()
    if cards < 2:
        log(f"(e) not run: this machine has {cards} CUDA card; the CLI over NCCL with one "
            "card a rank, shard_over across cards and test_kernel_runs_on_a_card_that_is_"
            "not_current need 2 or more")
        return 0
    launches = mesh_train_path(dev, cards, "nccl")["launches"]
    launches += mesh_predictor_path(eval_model(), make_mesh(cards), ident)["launches"]
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-p", "no:cacheprovider",
         "tests/test_torch_kernels_gpu.py", "-k", "not_current"],
        capture_output=True, text=True, timeout=300)
    log("(e) test_kernel_runs_on_a_card_that_is_not_current: "
        + proc.stdout.strip().splitlines()[-1])
    if proc.returncode != 0 or "1 passed" not in proc.stdout:
        raise AssertionError(f"test_kernel_runs_on_a_card_that_is_not_current:\n"
                             f"{proc.stdout[-3000:]}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    torch.backends.cudnn.benchmark = True
    dev = torch.device("cuda")
    ident = gpu_identity()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(ident)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:  # one nvcc per source, g++ beside, started together
        for built in [pool.submit(K.load_kernels), pool.submit(CK.load_kernels),
                      pool.submit(build_host_library)]:
            built.result()
    log(f"build: NMS and bottleneck kernels and the host library built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    timed = kernel_phase(dev)
    sl = slice_phase(dev, ident)
    bn = bottleneck_phase(dev, ident)
    timed["fused_bottleneck"] = bn["row"]
    ev = eval_phase(dev, ident)
    tr = train_phase(dev, ident)
    augment_phase(dev, ident)
    yp = yolox_predictor_phase(dev, ident)
    ye = yolox_eval_phase(dev, ident)
    yt = yolox_train_phase(dev, ident)
    dp = deploy_phase(dev, ident)
    mg = multigpu_phase(dev, ident)
    sg = slice_g_phase(dev, ident)
    sh = slice_h_phase(dev, ident)
    si = slice_i_phase(dev, ident)
    sj = slice_j_phase(dev, ident)
    sk = slice_k_phase(dev, ident)
    hp = host_phase(dev, ident, si["e2e"])

    # kernel #1 runs on the Predictor's, the eval step's and the trainer's
    # validation paths of both families, on phase 9's int8 Predictor,
    # artifacts, daemons and infer CLI, and on phase 10's mesh validation
    # (every rank's, summed) and shard_over replicas, and on phase 11's
    # checkpoint deploy (infer, export, serve), --topk 8400 (Predictor and
    # artifact) and blocked top-k paths, and on
    # phase 12's trainer, val, overfit and eval_quant runs, and on phase 13's
    # benches, and on phase 14's trainer runs and profile_forward --full, and
    # on phase 15's Predictor and resumed trainer over the JAX checkpoint, and
    # on phase 16's predict_paths through the native host tier; #2 on the B=1
    # postprocess of both families
    launches = {"nms_sweep_batched": (sl["main"]["nms_sweep_batched"] + ev["launches"]
                                      + tr["launches"] + yp["main"]["nms_sweep_batched"]
                                      + ye["launches"] + yt["launches"] + dp["launches"]
                                      + mg["launches"] + sg["launches"] + sh["launches"]
                                      + si["launches"] + sj["launches"]
                                      + sk["launches"] + hp["launches"]),
                "nms_sweep": sl["b1"]["nms_sweep"] + yp["b1"]["nms_sweep"],
                "fused_bottleneck": bn["launches"]}
    table = [dict(name=name, route="cuda", source=spec["source"], replaces=spec["replaces"],
                  launches=launches[name], **timed[name])
             for name, spec in KERNELS.items()]
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
