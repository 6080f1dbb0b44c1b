"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

* NMS sweeps (kernels #1, #2): exact. Keep masks are booleans and the
  kernels round every f32 operation as the plain sweep does; the IoU mask
  kernel's words equal ``nms_iou_mask_plain``'s bit for bit. At any N:
  past 4096 boxes (the register reduce's reach) the reduce keeps its words
  in shared memory, past 23,104 the mask's tiles run over two grid
  dimensions, and a call whose scratch passes the cap sweeps in chunks.
* Fused bottleneck (kernel #3), at any C (widths off the multiples of 16
  run padded with zero channels): bf16 at rtol = atol = 0.05, the border rows
  and columns also on their own (h is rounded to bf16 once; a sum in another
  order can round it to the neighbouring value). f32 (3xTF32 on the tensor
  cores) at rtol = atol = 1e-5, the JAX tests' tolerance, at every C up to
  512, and at its tiles' edges. The folded module: f32 at 2e-4 (TF32 off), bf16 within
  0.03 of max|ref| (cuDNN rounds the conv output to bf16 before its bias and
  SiLU; the kernel does not).
* The YOLOX Predictor (kernel #1 at B > 1, #2 at B = 1): its detections
  equal the same maps through the f32 decode and the plain sweep, exactly.
  Device augmentation: the card against the CPU on the same draws, boxes,
  labels and masks exact, images within 1e-5 (``chip_smoke.py`` 8(a)).
* The int8 conv route (``ops/int8_conv.py``, not a hand kernel): int32
  exact against its float64 plain version and the CPU's route. The NMS
  custom ops called directly, and a CUDA ``torch.export`` artifact (bf16
  and int8), launch kernel #1 and equal the plain sweep / the live
  Predictor exactly.
* The mesh eval step (``parallel/``): two gloo ranks sharing cuda:0 each
  sweep their rows of one validation batch with kernel #1, keep masks and
  detections equal to the plain sweep's, exactly.
* Slice G: kernel #1 on the blocked-top-k and checkpoint deploy paths
  equals the plain sweep, exactly; the tiled sweep (PyTorch ops) on the
  card equals kernel #1 and the CPU, exactly, also at N = 8400.
* Slice H: a ``flat_opt`` train step on the card (its parameters views of
  one 256-byte-aligned buffer) against the per-leaf step, at
  ``chip_smoke.py`` phase 7(a)'s tolerances; ``overfit_check`` validates
  every epoch through kernel #1.
* Slice I: the headline bench's program at B=128 (kernel #1's largest
  batch on a shipped path) equals the plain sweep at conf 0, exactly.
* Slice J: ``profile_forward --full`` launches kernel #1 once per call,
  profiled or not, and its output at conf 0 equals the same maps through
  the plain sweep, exactly.

Every test here needs a CUDA GPU (a CUDA kernel has no CPU mode) and skips
without one. This file imports no JAX, so it also runs on a machine
without it:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q
"""

import numpy as np
import pytest
import torch

from yolo_scratch_tpu_torch.nn.fuse import bottleneck_weights, fuse_conv_bn
from yolo_scratch_tpu_torch.nn.modules import Bottleneck
from yolo_scratch_tpu_torch.ops import conv_kernels as CK
from yolo_scratch_tpu_torch.ops import nms_kernels as K
from yolo_scratch_tpu_torch.probe_fused_bottleneck import tolerance
from yolo_scratch_tpu_torch.utils.cuda_timing import call_ms

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(seed, shape, device, spread=640.0):
    rng = np.random.RandomState(seed)
    c = rng.uniform(0, spread, (*shape, 2))
    wh = rng.uniform(4, 160, (*shape, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    return (torch.from_numpy(boxes).to(device),
            torch.from_numpy(rng.rand(*shape) > 0.1).to(device))


@pytest.mark.parametrize("B,N", [(32, 512), (4, 2048), (3, 77), (2, 4000), (2, 1), (3, 64),
                                 (2, 65),
                                 # past the register reduce's 4096 boxes: one word
                                 # past, every anchor of a 640 and a 1024 image
                                 (32, 4097), (32, 8400), (2, 21504)])
def test_kernel_batched_matches_plain(cuda, B, N):
    boxes, valid = _inputs(B + N, (B, N), cuda)
    before = K.launches["nms_sweep_batched"]
    got = K.nms_sweep_batched(boxes, valid, 0.45)
    torch.cuda.synchronize()
    assert K.launches["nms_sweep_batched"] == before + 1
    assert torch.equal(got, K.nms_sweep_batched_plain(boxes, valid, 0.45))


def test_kernel_chunked_call_matches_unchunked_plain(cuda, monkeypatch):
    """B=128 at N=8400 holds 1.14 GB of mask scratch, past the 1 GiB cap:
    one call sweeps two chunks of 64 images, one launch counted. Then a cap
    of two images' scratch at B=5 (chunks 2, 2, 1) and of less than one
    image (chunks of 1)."""
    boxes, valid = _inputs(3, (128, 8400), cuda)
    assert K._chunk_images(128, 8400, K._mask_stride(8400)) == 64
    before = K.launches["nms_sweep_batched"]
    got = K.nms_sweep_batched(boxes, valid, 0.45)
    torch.cuda.synchronize()
    assert K.launches["nms_sweep_batched"] == before + 1
    assert torch.equal(got, K.nms_sweep_batched_plain(boxes, valid, 0.45))
    boxes, valid = _inputs(4, (5, 4500), cuda)
    ref = K.nms_sweep_batched_plain(boxes, valid, 0.45)
    image_bytes = 4500 * K._mask_stride(4500) * 8
    for cap, chunk in ((2 * image_bytes, 2), (image_bytes - 1, 1)):
        monkeypatch.setattr(K, "_SCRATCH_CAP_BYTES", cap)
        assert K._chunk_images(5, 4500, K._mask_stride(4500)) == chunk
        assert torch.equal(K.nms_sweep_batched(boxes, valid, 0.45), ref)


@pytest.mark.parametrize("N", [512, 2048, 77, 1, 64, 65, 4097, 8400, 33600])
def test_kernel_single_matches_plain(cuda, N):
    boxes, valid = _inputs(N, (N,), cuda)
    before = K.launches["nms_sweep"]
    got = K.nms_sweep(boxes, valid, 0.45)
    torch.cuda.synchronize()
    assert K.launches["nms_sweep"] == before + 1
    assert torch.equal(got, K.nms_sweep_plain(boxes, valid, 0.45))


def test_kernel_threshold_ties_match_plain(cuda):
    """Identical boxes (IoU = 1 - tiny) and boxes whose IoU with the first
    sits a hair below each threshold (h/10 minus the 1e-6 eps): the strict
    '>' and the f32 rounding must agree bit for bit."""
    boxes = torch.tensor([[0, 0, 10, 10], [0, 0, 10, 10], [0, 0, 10, 4.5], [0, 0, 10, 5.0],
                          [0, 0, 10, 7.0], [100, 100, 110, 110], [100.5, 100, 110.5, 110]],
                         dtype=torch.float32, device=cuda)[None].contiguous()
    valid = torch.ones(boxes.shape[:2], dtype=torch.bool, device=cuda)
    for thr in (0.45, 0.5, 0.7):
        got = K.nms_sweep_batched(boxes, valid, thr)
        assert torch.equal(got, K.nms_sweep_batched_plain(boxes, valid, thr))


@pytest.mark.parametrize("with_valid", [False, True], ids=["all", "valid"])
@pytest.mark.parametrize("B,N,thr,spread", [
    (2, 1, 0.45, 640.0), (3, 77, 0.45, 640.0), (2, 64, 0.45, 100.0), (2, 65, 0.0, 100.0),
    (4, 512, 0.45, 640.0), (2, 300, -0.1, 640.0), (1, 4000, 0.45, 640.0), (2, 200, 0.45, 40.0),
    (2, 4160, 0.45, 640.0), (1, 8400, -0.1, 640.0)])
def test_kernel_iou_mask_matches_plain(cuda, B, N, thr, spread, with_valid):
    """Phase 1 alone: the mask kernel's words, bit 63 included, equal the
    plain version's, with every box valid and with ~10% invalid (their rows
    and columns left 0); the lower triangle stays as the private wrapper's
    zeros. thr 0 and -0.1 hold the divide's skip to thr >= 0."""
    boxes, valid = _inputs(B * N + 1, (B, N), cuda, spread)
    valid = valid if with_valid else None
    got = K._iou_mask(boxes, thr, valid)
    torch.cuda.synchronize()
    assert torch.equal(got, K.nms_iou_mask_plain(boxes, thr, valid))


def test_kernel_negative_threshold_matches_plain(cuda):
    boxes, valid = _inputs(5, (3, 300), cuda)
    assert torch.equal(K.nms_sweep_batched(boxes, valid, -0.1),
                       K.nms_sweep_batched_plain(boxes, valid, -0.1))


@pytest.mark.parametrize("share", [0.0, 0.02, 0.5])
def test_kernel_sparse_valid_matches_plain(cuda, share):
    """Mostly invalid candidates, as at conf 0.25: whole 64-pivot blocks
    with no pivot to keep."""
    boxes, _ = _inputs(9, (4, 700), cuda, 200.0)
    valid = torch.rand((4, 700), generator=torch.Generator().manual_seed(1)) < share
    valid = valid.to(cuda)
    assert torch.equal(K.nms_sweep_batched(boxes, valid, 0.45),
                       K.nms_sweep_batched_plain(boxes, valid, 0.45))


def test_kernel_runs_on_a_card_that_is_not_current(cuda):
    """Tensors on cuda:1 while cuda:0 is current: the wrappers launch on
    the tensors' card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs")
    dev = torch.device("cuda", 1)
    boxes, valid = _inputs(11, (2, 300), dev)
    assert torch.cuda.current_device() == 0
    assert torch.equal(K.nms_sweep_batched(boxes, valid, 0.45),
                       K.nms_sweep_batched_plain(boxes, valid, 0.45))
    assert torch.equal(K.nms_sweep(boxes[0], valid[0], 0.45),
                       K.nms_sweep_plain(boxes[0], valid[0], 0.45))
    assert torch.equal(K._iou_mask(boxes, 0.45), K.nms_iou_mask_plain(boxes, 0.45))


def test_kernel_wrapper_rejects_bad_input(cuda):
    valid = torch.ones((2, 8), dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        K._launch("nms_sweep_batched", torch.zeros((2, 8, 4), device=cuda, dtype=torch.float64),
                  valid, 0.45)
    with pytest.raises(ValueError):
        K._launch("nms_sweep_batched", torch.zeros((2, 16, 4), device=cuda)[:, ::2], valid, 0.45)
    with pytest.raises(ValueError):
        K._launch("nms_sweep_batched", torch.zeros((2, 8, 4)), valid.cpu(), 0.45)


# ----------------------------------------------------------- fused bottleneck

def _bneck_inputs(seed, B, H, W, C, Ch, dtype, device):
    rng = np.random.RandomState(seed)
    arrs = [(rng.randn(B, H, W, C) * 0.5, dtype),
            (rng.randn(3, 3, C, Ch) / np.sqrt(9 * C), dtype), (rng.randn(Ch) * 0.1, torch.float32),
            (rng.randn(3, 3, Ch, C) / np.sqrt(9 * Ch), dtype), (rng.randn(C) * 0.1, torch.float32)]
    return [torch.from_numpy(a.astype(np.float32)).to(device, dt) for a, dt in arrs]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("B,H,W,C,Ch", [
    (2, 12, 12, 16, 16), (1, 8, 24, 32, 32), (2, 20, 20, 64, 64), (2, 12, 12, 128, 64),
    (3, 16, 16, 128, 128), (1, 7, 9, 32, 48), (1, 20, 20, 512, 512), (2, 40, 40, 256, 256),
    # the wgmma path's edges: M not a multiple of 64 with a ragged last tile;
    # N = 48 and N = 16 (C = 16: one k16 step per tap); four weight stages
    # per tap (K = 256) on a ragged tile
    (2, 13, 29, 64, 64), (1, 10, 11, 16, 48), (2, 9, 14, 48, 16), (1, 13, 17, 256, 256),
    # widths off the multiples of 16, padded with zero channels
    (2, 12, 12, 8, 24), (1, 9, 14, 24, 8), (2, 10, 10, 40, 20)])
def test_bottleneck_kernel_matches_plain(cuda, dtype, B, H, W, C, Ch):
    inputs = _bneck_inputs(B * H + C, B, H, W, C, Ch, dtype, cuda)
    before = CK.launches["fused_bottleneck"]
    got = CK.fused_bottleneck(*inputs)
    torch.cuda.synchronize()
    assert CK.launches["fused_bottleneck"] == before + 1
    assert got.dtype == dtype and got.shape == inputs[0].shape
    ref = CK.bottleneck_plain(*inputs)
    tol = tolerance(dtype)
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)
    # conv2's zero pad of h: the first and last rows and columns on their own
    for ends in ((slice(None), [0, -1]), (slice(None), slice(None), [0, -1])):
        torch.testing.assert_close(got[ends].float(), ref[ends].float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,H,W,C,Ch", [
    # conv1's M ((TH+2)(TW+2) = 91 on the 5 x 11 tile the plan takes here)
    # not a multiple of 64, on ragged last tiles
    (32, 19, 21, 128, 128),
    # Ch != C: conv1 and conv2 take their columns in different numbers of
    # 2*NB passes
    (32, 11, 13, 128, 64), (32, 9, 10, 64, 256),
    # C = 512: the probe's 3 x 4 tile, the largest that fits (ragged rows),
    # and 1 x 1 tiles at B = 1
    (32, 20, 20, 512, 512), (1, 7, 10, 512, 512),
    # 16 K' stages (S = 2) at NB = 8: 32 divides neither width
    (8, 9, 9, 48, 144)])
def test_bottleneck_f32_kernel_tile_edges(cuda, B, H, W, C, Ch):
    """The f32 kernel (3xTF32) at its design's edges, at the f32 tolerance
    (rtol = atol = 1e-5), everywhere and on the border rows and columns."""
    inputs = _bneck_inputs(B * W + Ch, B, H, W, C, Ch, torch.float32, cuda)
    got = CK.fused_bottleneck(*inputs)
    torch.cuda.synchronize()
    ref = CK.bottleneck_plain(*inputs)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    for ends in ((slice(None), [0, -1]), (slice(None), slice(None), [0, -1])):
        torch.testing.assert_close(got[ends], ref[ends], rtol=1e-5, atol=1e-5)


def test_bottleneck_f32_call_launches_the_3xtf32_kernel(cuda):
    """An f32 call launches the tensor-core kernel by name, once a call."""
    inputs = _bneck_inputs(3, 2, 16, 16, 128, 128, torch.float32, cuda)
    ms, split = call_ms(lambda: CK.fused_bottleneck(*inputs), ("fused_bottleneck_kernel_3xtf32",),
                        reps=10)
    assert ms > 0 and list(split) == ["fused_bottleneck_kernel_3xtf32"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_bottleneck_kernel_matches_folded_module(cuda, dtype):
    torch.manual_seed(0)
    m = Bottleneck(64, 64, shortcut=True, k=(3, 3), e=1.0)
    for bn in (m.cv1.bn, m.cv2.bn):  # non-trivial statistics, so folding matters
        bn.running_mean.uniform_(-0.1, 0.1)
        bn.running_var.uniform_(0.5, 1.5)
        bn.weight.data.uniform_(0.5, 1.5)
        bn.bias.data.uniform_(-0.1, 0.1)
    m = fuse_conv_bn(m.eval()).to(cuda, dtype).to(memory_format=torch.channels_last)
    x = torch.rand(4, 64, 24, 40, device=cuda, dtype=dtype).to(memory_format=torch.channels_last)
    with torch.inference_mode(), CK.full_f32():
        ref = m(x).permute(0, 2, 3, 1).float()
        got = CK.fused_bottleneck(x.permute(0, 2, 3, 1), *bottleneck_weights(m)).float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4)
    else:
        assert float((got - ref).abs().max()) <= 0.03 * float(ref.abs().max())


def test_bottleneck_wrapper_rejects_bad_input(cuda):
    x, w1, b1, w2, b2 = _bneck_inputs(0, 1, 8, 8, 32, 32, torch.bfloat16, cuda)
    with pytest.raises(TypeError):
        CK._launch(x.half(), w1.half(), b1, w2.half(), b2)
    with pytest.raises(TypeError):
        CK._launch(x, w1.float(), b1, w2, b2)
    with pytest.raises(TypeError):
        CK._launch(x, w1, b1.bfloat16(), w2, b2)
    with pytest.raises(ValueError, match="contiguous"):
        CK._launch(x.transpose(1, 2), w1, b1, w2, b2)
    for dtype in (torch.bfloat16, torch.float32):  # a 5x5 x tile is 410 KB (bf16)
        with pytest.raises(ValueError, match="shared memory"):
            CK._launch(*_bneck_inputs(0, 1, 4, 4, 8192, 16, dtype, cuda))
    with pytest.raises(ValueError):
        CK._launch(x, w1, b1.cpu(), w2, b2)


def test_eval_step_runs_kernel_1_and_matches_plain_and_cpu_marks(cuda):
    """The eval step (``train/steps.py``) at B=2, 64 px on the card: it
    launches kernel #1 once; its detections equal the same maps put through
    the plain sweep, exactly; its marks (plain and per-class) equal
    ``batched_tp_marks`` run on the CPU on the same detections, exactly."""
    from yolo_scratch_tpu_torch.data.loader import Loader
    from yolo_scratch_tpu_torch.data.synthetic import SyntheticDataset
    from yolo_scratch_tpu_torch.models.builder import CONFIGS, build_yolo11
    from yolo_scratch_tpu_torch.ops.decode import _finish, select_candidates
    from yolo_scratch_tpu_torch.ops.matching import DEFAULT_THRESHOLDS, batched_tp_marks
    from yolo_scratch_tpu_torch.train.steps import batch_to_device, make_eval_step

    model = build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, seed=7)
    with torch.no_grad():
        for cls in model.model[-1].cv3:  # zeroed class priors: scores near 0.5
            cls[2].bias.zero_()
    model = model.to(cuda).eval()
    step = make_eval_step(model, match_thresholds=DEFAULT_THRESHOLDS, per_class=True)
    batch = next(iter(Loader(SyntheticDataset(n=2, img_size=64), 2, max_gt=8, prefetch=0)))
    b = batch_to_device(batch, cuda)
    feats = step.forward(b)
    before = K.launches["nms_sweep_batched"]
    out = step.from_feats(feats, b)
    torch.cuda.synchronize()
    assert K.launches["nms_sweep_batched"] == before + 1
    with torch.inference_mode():
        boxes, scores, labels, valid, _ = select_candidates(
            feats, model.nc, model.strides, model.reg_max, 0.25, 2048)
        keep = K._cap(K.nms_sweep_batched_plain(boxes, valid, 0.45), 300)
        ref = _finish(boxes, scores, labels, keep, 300, 64)
    assert valid.any()
    for g, r in zip(out[1], ref):
        assert torch.equal(g, r)
    pb, _, pl, pv = (t.cpu() for t in out[1])
    gb, gm, gl = (torch.from_numpy(batch[k]) for k in ("gt_bboxes", "gt_mask", "gt_labels"))
    assert torch.equal(out[2].cpu(), batched_tp_marks(pb, pv, gb, gm))
    assert torch.equal(out[3].cpu(), batched_tp_marks(pb, pv, gb, gm, pred_labels=pl,
                                                      gt_labels=gl))


def test_train_step_on_the_card_matches_cpu(cuda):
    """One train step of the crater YOLO11n at 64 px, B=4, f32 with TF32 off,
    on the card against the CPU from the same weights and batch, at
    ``chip_smoke.py`` phase 7(a)'s tolerances (``compare_train_steps``: loss
    rtol 1e-4, each gradient within 1e-3 of max|g_cpu|, BN running variances
    rtol 1e-4 and means within 1e-5, the parameters within the LR times the
    Adam directions' difference). B=4, not phase 7(a)'s 2: at 64 px the P5
    blocks' BN sees 2x2 values an image, and at B=2 its 8 values a channel
    put the two devices' gradients about 1e-3 of max|g| apart (8.3e-4 in one
    run on an H100, above 1e-3 in another); at B=4 4.0e-4."""
    from chip_smoke import compare_train_steps
    from yolo_scratch_tpu_torch.data.loader import Loader
    from yolo_scratch_tpu_torch.data.synthetic import SyntheticDataset
    from yolo_scratch_tpu_torch.models.builder import CONFIGS, build_yolo11

    model = build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n", seed=0)
    batch = next(iter(Loader(SyntheticDataset(n=4, img_size=64), 4, max_gt=8, prefetch=0)))
    errs = compare_train_steps(model, batch, cuda)
    assert errs["loss"] <= 1e-4 and errs["grad"] <= 1e-3


def test_bf16_train_step_on_the_card_computes_in_bf16(cuda):
    """One ``compute_dtype=bf16`` step on the card (``--bf16``): every
    convolution's output is bf16 and the loss receives f32 maps (forward
    hooks, exact); the loss lies within rtol 0.15 of the f32 step's on the
    same weights and batch (the JAX package's own bf16 bound,
    ``tests/test_mixed_precision.py``); the weights, both moments, the EMA
    and the BN statistics stay f32 and finite."""
    import copy

    from yolo_scratch_tpu_torch.data.loader import Loader
    from yolo_scratch_tpu_torch.data.synthetic import SyntheticDataset
    from yolo_scratch_tpu_torch.losses.v8_loss import DetectionLossConfig
    from yolo_scratch_tpu_torch.models.builder import CONFIGS, build_yolo11
    from yolo_scratch_tpu_torch.train.optim import make_optimizer
    from yolo_scratch_tpu_torch.train.state import create_train_state
    from yolo_scratch_tpu_torch.train.steps import build_train_step_custom, v8_loss_adapter

    model = build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n", seed=0,
                         device=cuda)
    batch = next(iter(Loader(SyntheticDataset(n=4, img_size=64), 4, max_gt=8, prefetch=0)))
    losses = {}
    for dtype in (None, torch.bfloat16):
        m = copy.deepcopy(model)
        state = create_train_state(m, make_optimizer(), use_ema=True)
        conv_out, loss_in = set(), set()
        hooks = [c.register_forward_hook(lambda _m, _i, out: conv_out.add(out.dtype))
                 for c in m.modules() if isinstance(c, torch.nn.Conv2d)]
        adapter = v8_loss_adapter(DetectionLossConfig(nc=5, strides=m.strides))

        def loss_fn(feats, b, adapter=adapter, loss_in=loss_in):
            loss_in.update(f.dtype for f in feats)
            return adapter(feats, b)

        step = build_train_step_custom(m, loss_fn, compute_dtype=dtype,
                                       matmul_precision="highest")
        state, metrics = step(state, batch)
        for h in hooks:
            h.remove()
        want = torch.float32 if dtype is None else dtype
        assert conv_out == {want} and loss_in == {torch.float32}
        losses[dtype] = float(metrics["loss"])
        tensors = [*m.state_dict().values(), *state.opt_state.mu, *state.opt_state.nu,
                   *state.ema.values()]
        for t in tensors:
            if t.is_floating_point():
                assert t.dtype == torch.float32 and bool(torch.isfinite(t).all())
    np.testing.assert_allclose(losses[torch.bfloat16], losses[None], rtol=0.15)


@pytest.mark.parametrize("B", [4, 1])
def test_yolox_predictor_matches_plain_sweep(cuda, B):
    """YOLOX-nano (priors at 0.5) at 64 px, conf 0: the Predictor's packed
    detections equal ``postprocess`` of its own maps through the plain
    sweep; it launches kernel #1 at B > 1 and kernel #2 at B = 1."""
    from chip_smoke import plain_yolox_packed
    from yolo_scratch_tpu_torch.infer import Predictor, PredictorConfig
    from yolo_scratch_tpu_torch.models.yolox import build_yolox

    model = build_yolox("nano", nc=5, ch=3, seed=1)
    with torch.no_grad():
        for i in range(3):
            for k in ("cls", "obj"):
                getattr(model.head, f"{k}_pred_{i}").bias.zero_()
    pred = Predictor(model, PredictorConfig(img_size=64, batch_size=B, conf_threshold=0.0),
                     device=cuda)
    x = np.random.RandomState(B).randint(0, 256, (B, 64, 64, 3), dtype=np.uint8)
    with torch.inference_mode():
        feats = pred.forward_feats(x)
        before = dict(K.launches)
        got = pred.postprocess_feats(feats)
        torch.cuda.synchronize()
        name = "nms_sweep_batched" if B > 1 else "nms_sweep"
        assert K.launches[name] == before[name] + 1
        assert torch.equal(got, plain_yolox_packed(pred, feats))
    assert int(got[..., 6].sum()) > 0


@pytest.mark.parametrize("ch", [3, 1])
def test_augment_on_the_card_matches_cpu(cuda, ch):
    from chip_smoke import YOLOX_AUG, augment_card_vs_cpu
    from yolo_scratch_tpu_torch.data.augment import batch_generator, draw_augment
    from yolo_scratch_tpu_torch.data.loader import Loader
    from yolo_scratch_tpu_torch.data.synthetic import SyntheticDataset

    # 96 px: the crop offsets' quotients by H and W are inexact (CUDA's
    # division by a Python scalar is a reciprocal multiply; 64 would hide it)
    batch = next(iter(Loader(SyntheticDataset(n=8, img_size=96, channels=ch), 8, max_gt=8,
                             prefetch=0)))
    draws = draw_augment(batch_generator(0, 1, ch), 8, ch, YOLOX_AUG)
    assert augment_card_vs_cpu(batch, draws, YOLOX_AUG, cuda) <= 1e-5


def test_yolox_train_step_on_the_card_matches_cpu(cuda):
    """One YOLOX-nano step at 64 px, B=4, f32 with TF32 off, card against
    CPU at ``chip_smoke.py`` 8(d)'s tolerances (``compare_train_steps``)."""
    from chip_smoke import YOLOX_LOSS_KEYS, compare_train_steps
    from yolo_scratch_tpu_torch.data.loader import Loader
    from yolo_scratch_tpu_torch.data.synthetic import SyntheticDataset
    from yolo_scratch_tpu_torch.losses.simota import YOLOXLossConfig
    from yolo_scratch_tpu_torch.models.yolox import build_yolox
    from yolo_scratch_tpu_torch.train.steps import yolox_loss_adapter

    batch = next(iter(Loader(SyntheticDataset(n=4, img_size=64), 4, max_gt=8, prefetch=0)))
    errs = compare_train_steps(build_yolox("nano", nc=5, ch=1), batch, cuda,
                               loss_fn=yolox_loss_adapter(YOLOXLossConfig(nc=5)),
                               keys=YOLOX_LOSS_KEYS)
    assert errs["loss"] <= 1e-4 and errs["grad"] <= 1e-3


# (c1, c2, k, stride, pad, groups, H, B): YOLO11n's stem (K = 9), a dense 3x3,
# a strided 3x3, a pointwise conv with N not a multiple of 8, the PSA pe
# depthwise conv, and a B=1 case with fewer than 17 GEMM rows
INT8_SHAPES = [(1, 16, 3, 2, 1, 1, 64, 4), (32, 32, 3, 1, 1, 1, 40, 4), (64, 64, 3, 2, 1, 1, 41, 2),
               (96, 20, 1, 1, 0, 1, 20, 2), (128, 128, 3, 1, 1, 128, 20, 2),
               (16, 8, 3, 1, 1, 1, 3, 1)]


@pytest.mark.parametrize("shape", INT8_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_int8_conv2d_on_the_card_matches_plain(cuda, shape):
    """The int8 route (im2col + cuBLASLt's s8 GEMM, or the depthwise sum) on
    the card: int32 exact against the float64 plain version and against the
    CPU's route, channels-last input as the Predictor gives it."""
    from yolo_scratch_tpu_torch.ops.int8_conv import int8_conv2d, int8_conv2d_plain

    c1, c2, k, s, p, g, H, B = shape
    gen = torch.Generator().manual_seed(sum(shape))
    xq = torch.randint(-127, 128, (B, c1, H, H), dtype=torch.int8, generator=gen)
    w = torch.randint(-127, 128, (c2, c1 // g, k, k), dtype=torch.int8, generator=gen)
    x_d = xq.to(cuda).contiguous(memory_format=torch.channels_last)
    got = int8_conv2d(x_d, w.to(cuda), s, p, 1, g)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    assert torch.equal(got, int8_conv2d_plain(x_d, w.to(cuda), s, p, 1, g))
    assert torch.equal(got.cpu(), int8_conv2d(xq, w, s, p, 1, g))


@pytest.mark.parametrize("B,N", [(32, 512), (3, 77)])
def test_nms_custom_ops_match_plain(cuda, B, N):
    """``yst::nms_sweep_batched`` / ``yst::nms_sweep`` called as ops launch
    the kernels (the counters move) and equal the plain sweeps."""
    boxes, valid = _inputs(B * N, (B, N), cuda)
    before = dict(K.launches)
    got = torch.ops.yst.nms_sweep_batched(boxes, valid, K._f32(0.45))
    one = torch.ops.yst.nms_sweep(boxes[0].contiguous(), valid[0].contiguous(), K._f32(0.45))
    torch.cuda.synchronize()
    assert K.launches["nms_sweep_batched"] == before["nms_sweep_batched"] + 1
    assert K.launches["nms_sweep"] == before["nms_sweep"] + 1
    assert torch.equal(got, K.nms_sweep_batched_plain(boxes, valid, 0.45))
    assert torch.equal(one, K.nms_sweep_plain(boxes[0], valid[0], 0.45))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_exported_artifact_launches_kernel_1(cuda, tmp_path, int8):
    """A CUDA artifact of the Predictor (YOLO11n, 96 px, B=2; bf16 and int8)
    keeps its device, launches kernel #1 once a batch through the yst op and
    equals the live Predictor's packed output."""
    from chip_smoke import eval_model
    from yolo_scratch_tpu_torch import export as E
    from yolo_scratch_tpu_torch.infer import Predictor, PredictorConfig
    from yolo_scratch_tpu_torch.nn.quant import quantize_for_deploy

    x = np.random.RandomState(0).randint(0, 256, (2, 96, 96, 1), dtype=np.uint8)
    model = eval_model().to(cuda)
    if int8:
        model = quantize_for_deploy(model, [x / 255.0])
    pred = Predictor(model, PredictorConfig(img_size=96, batch_size=2), device=cuda)
    path = str(tmp_path / "m.pt2")
    E.save_artifact(E.export_predictor(pred), path)
    art = E.ArtifactPredictor(E.load_artifact(path))
    assert art.device.type == "cuda"
    live = pred.predict_batch(x)
    before = K.launches["nms_sweep_batched"]
    got = art.predict_batch(x)
    torch.cuda.synchronize()
    assert K.launches["nms_sweep_batched"] == before + 1
    assert torch.equal(got, live) and int(got[..., 6].sum()) > 0


def test_predictor_and_artifact_past_4096_candidates_sweep_kernel_1(cuda, tmp_path):
    """``--topk 8400`` at 448 px (4,116 anchors, every one a candidate at
    conf 0), B=2: the live Predictor's detections equal the plain sweep's,
    and an artifact exported at that topk launches kernel #1 once a batch
    and equals the live Predictor."""
    from chip_smoke import eval_model, plain_packed
    from yolo_scratch_tpu_torch import export as E
    from yolo_scratch_tpu_torch.infer import Predictor, PredictorConfig

    cfg = PredictorConfig(img_size=448, batch_size=2, conf_threshold=0.0, pre_nms_topk=8400)
    pred = Predictor(eval_model().to(cuda), cfg, device=cuda)
    x = np.random.RandomState(8).randint(0, 256, (2, 448, 448, 1), dtype=np.uint8)
    with torch.inference_mode():
        feats = pred.forward_feats(x)
        before = K.launches["nms_sweep_batched"]
        live = pred.postprocess_feats(feats)
        torch.cuda.synchronize()
        assert K.launches["nms_sweep_batched"] == before + 1
        assert torch.equal(live, plain_packed(pred, feats)) and int(live[..., 6].sum()) > 0
    path = str(tmp_path / "m.pt2")
    E.save_artifact(E.export_predictor(pred), path)
    art = E.ArtifactPredictor(E.load_artifact(path))
    before = K.launches["nms_sweep_batched"]
    got = art.predict_batch(x)
    torch.cuda.synchronize()
    assert K.launches["nms_sweep_batched"] == before + 1
    assert torch.equal(got, pred.predict_batch(x))


def test_mesh_validation_sweeps_kernel_1_on_every_rank(cuda, tmp_path):
    """Two gloo ranks on cuda:0 (the transport rule for ranks that share a
    card) each put their rows of one validation batch through the mesh eval
    step: kernel #1 launches once on every rank, its keep masks equal the
    plain sweep's and so do the step's detections, exactly."""
    import torch_parallel_ranks as R  # beside this file (a ``tests`` package may shadow it)
    from yolo_scratch_tpu_torch.parallel.distributed import spawn_ranks

    out = spawn_ranks(R.card_val_rank, 2, (2, f"file://{tmp_path}/rendezvous"), timeout=300)
    for r in out:
        assert r["transport"] == "gloo" and r["launched"] == 1 and r["swept"] > 0, r
        assert r["keep_equal"] and r["dets_equal"], r


def test_blocked_topk_predictor_sweeps_kernel_1_as_plain(cuda):
    """Slice G's ``blocked_topk`` (kb=8) on the crater YOLO11n with every
    anchor above 0.25 (``chip_smoke.eval_model``), 96 px, B=4: kernel #1
    launches once a batch, its detections equal the plain sweep's, and the
    card's blocked selection equals the CPU's on the same maps."""
    from chip_smoke import eval_model, plain_packed
    from yolo_scratch_tpu_torch.infer import Predictor, PredictorConfig
    from yolo_scratch_tpu_torch.ops.decode import select_candidates

    pred = Predictor(eval_model(), PredictorConfig(img_size=96, batch_size=4, blocked_topk=8),
                     device=cuda)
    x = np.random.RandomState(5).randint(0, 256, (4, 96, 96, 1), dtype=np.uint8)
    with torch.inference_mode():
        feats = pred.forward_feats(x)
        before = K.launches["nms_sweep_batched"]
        got = pred.postprocess_feats(feats)
        torch.cuda.synchronize()
        assert K.launches["nms_sweep_batched"] == before + 1
        assert torch.equal(got, plain_packed(pred, feats)) and int(got[..., 6].sum()) > 0
        m, cfg = pred.model, pred.cfg
        args = (m.nc, m.strides, m.reg_max, cfg.conf_threshold, cfg.pre_nms_topk, 8)
        card = select_candidates(feats, *args)
        cpu = select_candidates([f.cpu() for f in feats], *args)
    for a, b in zip(card[2:4], cpu[2:4]):  # labels and valid: the selection
        assert torch.equal(a.cpu(), b)


def test_checkpoint_deploy_sweeps_kernel_1_as_plain(cuda, tmp_path):
    """A ``train/checkpoints.py`` checkpoint served through
    ``load_deploy_model(ckpt=...)`` on the card: kernel #1 launches and its
    detections equal the plain sweep's at conf 0."""
    from chip_smoke import eval_model, plain_packed
    from yolo_scratch_tpu_torch.infer import Predictor, PredictorConfig, load_deploy_model
    from yolo_scratch_tpu_torch.train.checkpoints import CheckpointManager
    from yolo_scratch_tpu_torch.train.optim import make_optimizer
    from yolo_scratch_tpu_torch.train.state import create_train_state

    state = create_train_state(eval_model(), make_optimizer(), use_ema=True)
    CheckpointManager(str(tmp_path)).save_epoch(state, 0, {}, {"mAP50": 0.5}, float("inf"), 0.0)
    model = load_deploy_model(ckpt=tmp_path, which="last", device=cuda)
    pred = Predictor(model, PredictorConfig(img_size=96, batch_size=4, conf_threshold=0.0),
                     device=cuda)
    x = np.random.RandomState(6).randint(0, 256, (4, 96, 96, 1), dtype=np.uint8)
    with torch.inference_mode():
        feats = pred.forward_feats(x)
        before = K.launches["nms_sweep_batched"]
        got = pred.postprocess_feats(feats)
        torch.cuda.synchronize()
        assert K.launches["nms_sweep_batched"] == before + 1
        assert torch.equal(got, plain_packed(pred, feats)) and int(got[..., 6].sum()) > 0


@pytest.mark.parametrize("B,N", [(32, 512), (4, 2048), (3, 77)])
def test_tiled_sweep_on_the_card_equals_kernel_1(cuda, B, N):
    """``ops/nms.py::batched_nms_tiled`` (PyTorch ops) on the card against
    kernel #1 and against itself on the CPU, on score-sorted rows."""
    from yolo_scratch_tpu_torch.ops.nms import batched_nms_tiled

    boxes, valid = _inputs(B + N, (B, N), cuda)
    scores = torch.linspace(1.0, 0.0, N, device=cuda).expand(B, N).contiguous()
    got = batched_nms_tiled(boxes, scores, valid, iou_threshold=0.45, max_det=N)
    assert torch.equal(got, K.nms_sweep_batched(boxes, valid, 0.45))
    assert torch.equal(got.cpu(), batched_nms_tiled(boxes.cpu(), scores.cpu(), valid.cpu(),
                                                    iou_threshold=0.45, max_det=N))


def test_tiled_sweep_on_the_card_past_kernel_1s_limit(cuda):
    """At N = 8400 (every anchor of a 640 image), past the 4096 boxes
    kernel #1 once refused: the tiled sweep on the card, kernel #1 and the
    plain sweep keep the same boxes."""
    from yolo_scratch_tpu_torch.ops.nms import batched_nms_tiled

    B, N = 2, 8400
    boxes, valid = _inputs(N, (B, N), cuda)
    scores = torch.linspace(1.0, 0.0, N, device=cuda).expand(B, N).contiguous()
    got = batched_nms_tiled(boxes, scores, valid, iou_threshold=0.45, max_det=N)
    assert torch.equal(got, K.nms_sweep_batched_plain(boxes, valid, 0.45))
    assert torch.equal(got, K.nms_sweep_batched(boxes, valid, 0.45))


def test_flat_opt_step_on_the_card_equals_per_leaf(cuda):
    """One step of the crater YOLO11n at 64 px, B=4, f32 with TF32 off, in
    ``chip_smoke.deterministic_mode``: the ``flat_opt`` state against the
    per-leaf state from the same weights on the same batch, held by
    ``check_step_pair`` (phase 7(a)'s limits). Parameters at 4-byte offsets
    of one buffer faulted there ("misaligned address")."""
    import copy

    from chip_smoke import _train_setup, check_step_pair, deterministic_mode, step_record
    from yolo_scratch_tpu_torch.data.loader import Loader
    from yolo_scratch_tpu_torch.data.synthetic import SyntheticDataset
    from yolo_scratch_tpu_torch.models.builder import CONFIGS, build_yolo11

    model = build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n", seed=0,
                         device=cuda)
    batch = next(iter(Loader(SyntheticDataset(n=4, img_size=64), 4, max_gt=8, prefetch=0)))
    runs = {}
    with deterministic_mode():
        for flat in (False, True):
            m = copy.deepcopy(model)
            state, step = _train_setup(m, flat_opt=flat)
            lr = state.tx.lr(state.opt_state.count)
            state, metrics = step(state, batch)
            runs[flat] = step_record(m, state, metrics, lr)
    errs = check_step_pair(runs[True], runs[False], "flat vs per-leaf")
    assert errs["loss"] <= 1e-4 and errs["grad"] <= 1e-3


def test_overfit_check_validates_through_kernel_1(cuda):
    """Two epochs of ``overfit_check`` on the card: two val batches an
    epoch, each one launch of kernel #1, and the JAX script's JSON keys."""
    from yolo_scratch_tpu_torch import overfit_check

    K.reset_launches()
    final = overfit_check.main(2)
    assert K.launches["nms_sweep_batched"] == 4
    assert {"mAP50", "precision", "recall", "loss"} <= set(final)


@pytest.mark.parametrize("ch,nc", [(1, 5), (3, 80)], ids=["crater", "coco"])
def test_headline_program_at_b128_sweeps_kernel_1_as_plain(cuda, ch, nc):
    """Slice I: the headline bench's program (``bench/headline.py``) at its
    B=128, 640, at conf 0 (all 512 candidates of every image valid): one
    scan of one batch launches kernel #1 once, and the program's
    postprocess of a batch's maps equals the same maps through the plain
    sweep, exactly."""
    from chip_smoke import plain_packed
    from yolo_scratch_tpu_torch.bench import common as BC
    from yolo_scratch_tpu_torch.bench.headline import deploy_program

    model = BC.deploy_model(ch, nc, "n", 640, device=cuda)
    pred, program = deploy_program(model, 128, 512, cuda, conf=0.0, img=640)
    xs = BC.uint8_batches((1, 128, 640, 640, ch), cuda, seed=ch)
    before = K.launches["nms_sweep_batched"]
    (out,) = program(xs)
    torch.cuda.synchronize()
    assert K.launches["nms_sweep_batched"] == before + 1
    assert tuple(out[0].shape) == (128, 300, 4)
    with torch.inference_mode():
        feats = pred.forward_feats(xs[0])
        got = pred.postprocess_feats(feats)
        assert torch.equal(got, plain_packed(pred, feats))
    assert int(got[..., 6].sum(1).min()) > 0


def test_profile_forward_full_sweeps_kernel_1_once_a_call(cuda, tmp_path):
    """Slice J: ``profile_forward --full`` at B=4, 640, conf 0: two warm-up
    calls and three profiled ones launch kernel #1 five times, three of
    them in the trace; one call's detections equal the same maps through
    the plain sweep, exactly, with detections kept."""
    from chip_smoke import plain_packed
    from yolo_scratch_tpu_torch import profile_forward as PF
    from yolo_scratch_tpu_torch.infer import pack_detections

    before = K.launches["nms_sweep_batched"]
    res = PF.main(["--batch", "4", "--full", "--iters", "3", "--top", "5"], conf=0.0,
                  out_dir=tmp_path)
    assert K.launches["nms_sweep_batched"] == before + 5 and res["nms_launches"] == 3
    assert res["events"] > 0 and res["total_ms"] > 0 and res["device"]["platform"] == "gpu"
    pred, x, fn = PF.build(4, 640, True, cuda, conf=0.0)
    with torch.inference_mode():
        got = pack_detections(*fn())
        feats = [f.float() for f in pred.model(x.to(torch.bfloat16))]
        assert torch.equal(got, plain_packed(pred, feats))
    assert int(got[..., 6].sum(1).min()) > 0
