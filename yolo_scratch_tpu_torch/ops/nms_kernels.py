"""Greedy-NMS sweep: hand-written CUDA kernels, their plain versions, and
the NMS entry points built on them (port of ``ops/pallas_nms.py``).

==========================================  ====================================
``yolo_scratch_tpu/ops/pallas_nms.py``      here
==========================================  ====================================
``nms_sweep_pallas_batched`` (kernel #1)    :func:`nms_sweep_batched`
``nms_sweep_pallas`` (kernel #2)            :func:`nms_sweep`
``nms_pallas_batched``                      :func:`nms_kernel_batched`
``nms_pallas``                              :func:`nms_kernel`
``_class_offset``                           :func:`_class_offset`
==========================================  ====================================

The kernels live in ``csrc/nms_sweep.cu`` (built with nvcc for sm_90a at
first use, loaded with ctypes). Each sweep runs in two phases: an IoU
bitmask over all pairs, one 64-bit word per (row, 64 columns), then a
serial reduce over 64-pivot blocks. They take any N, as the Pallas sweep
does: the mask's scratch grows as N^2/8 bytes an image, so a call sweeps
its batch in chunks of images whose scratch stays under
``_SCRATCH_CAP_BYTES`` (one image at least). Each sweep is a ``torch.library``
custom op (``yst::nms_sweep_batched``, ``yst::nms_sweep``), so an exported
program reaches the kernels too: on a CUDA tensor the op launches both
kernels, on a CPU tensor it runs the plain PyTorch version of the same
sweep; any other device raises. ``launches`` counts the op calls that
launched the kernels, eager or exported. :func:`nms_iou_mask_plain` and
:func:`nms_reduce_plain` are the two phases in plain PyTorch, in the
kernels' word layout.

While a profiler records, each sweep adds the pairs it tests, N(N-1)/2 an
image, to the counter ``nms.pairs_swept`` (``utils/profiling.py``), and
:func:`pairs_needed` gives the tests greedy NMS needs of them.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from yolo_scratch_tpu_torch.utils import profiling
from yolo_scratch_tpu_torch.utils.build import PKG, build_cuda_library

_SOURCE = PKG / "csrc" / "nms_sweep.cu"

#: kernel launches per wrapper, for showing that a run went through them
launches = {"nms_sweep_batched": 0, "nms_sweep": 0}

_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def load_kernels() -> ctypes.CDLL:
    """Build (at first use) and load the NMS kernel library."""
    global _lib
    if _lib is None:
        # -fmad=false: no a*b+c is contracted into an FMA, so the IoU rounds
        # every operation as the plain sweep and XLA do (exact keep masks)
        lib = ctypes.CDLL(str(build_cuda_library("yst_nms", [_SOURCE], ["-fmad=false"])))
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.yst_nms_sweep_batched.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, f32, ptr]
        lib.yst_nms_sweep_single.argtypes = [ptr, ptr, ptr, ptr, i32, f32, ptr]
        lib.yst_nms_iou_mask.argtypes = [ptr, ptr, ptr, i32, i32, f32, ptr]
        lib.yst_nms_mask_stride.argtypes = [i32]
        for fn in (lib.yst_nms_sweep_batched, lib.yst_nms_sweep_single, lib.yst_nms_iou_mask,
                   lib.yst_nms_mask_stride):
            fn.restype = i32
        _lib = lib
    return _lib


def _f32(x: float) -> float:
    """Round a threshold to f32 once, so every comparison (torch's, the
    kernel's, XLA's weak-typed one) sees the same value."""
    return float(np.float32(x))


# ---------------------------------------------------------------- plain sweep

def nms_sweep_batched_plain(boxes: torch.Tensor, valid: torch.Tensor,
                            iou_threshold: float) -> torch.Tensor:
    """Plain PyTorch version of kernel #1: boxes (B, N, 4) f32 xyxy, rows
    score-descending; valid (B, N) bool -> keep (B, N) bool. Same f32
    operation order as the kernel and as ``_nms_kernel_batched``."""
    thr = _f32(iou_threshold)
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    n = boxes.shape[1]
    idx = torch.arange(n, device=boxes.device)
    supp = torch.zeros_like(valid)
    for i in range(n):
        kept = valid[:, i:i + 1] & ~supp[:, i:i + 1]  # (B, 1)
        w = (torch.minimum(x2, x2[:, i:i + 1]) - torch.maximum(x1, x1[:, i:i + 1])).clamp(min=0)
        h = (torch.minimum(y2, y2[:, i:i + 1]) - torch.maximum(y1, y1[:, i:i + 1])).clamp(min=0)
        inter = w * h
        iou = inter / (area + area[:, i:i + 1] - inter + 1e-6)
        supp = supp | (kept & (iou > thr) & (idx > i))
    return valid & ~supp


def nms_sweep_plain(boxes: torch.Tensor, valid: torch.Tensor,
                    iou_threshold: float) -> torch.Tensor:
    """Plain PyTorch version of kernel #2: boxes (N, 4), valid (N,) -> (N,)."""
    return nms_sweep_batched_plain(boxes[None], valid[None], iou_threshold)[0]


# ------------------------------------------- the kernels' two phases, plain

def nms_iou_mask_plain(boxes: torch.Tensor, iou_threshold: float,
                       valid: torch.Tensor | None = None) -> torch.Tensor:
    """Phase 1 in plain PyTorch: boxes (B, N, 4) -> words (B, N, W) int64,
    W = ceil(N / 64). Bit k of ``words[b, i, w]`` is set iff j = 64 w + k
    lies in i < j < N, boxes i and j are both valid (``valid`` (B, N) bool,
    default all) and pivot i's IoU with j exceeds the threshold, in the
    sweep's f32 operation order. Bit 63 is int64's sign bit; the words are
    packed by OR, never by a sum."""
    thr = _f32(iou_threshold)
    B, n = boxes.shape[:2]
    W = -(-n // 64)
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    # [b, i, j]: pivot i (column vectors) against candidate j (row vectors)
    w = (torch.minimum(x2[:, None], x2[..., None]) - torch.maximum(x1[:, None], x1[..., None]))
    h = (torch.minimum(y2[:, None], y2[..., None]) - torch.maximum(y1[:, None], y1[..., None]))
    inter = w.clamp(min=0) * h.clamp(min=0)
    iou = inter / (area[:, None] + area[..., None] - inter + 1e-6)
    idx = torch.arange(n, device=boxes.device)
    bits = (iou > thr) & (idx[None, :] > idx[:, None])
    if valid is not None:
        bits &= valid[:, :, None] & valid[:, None, :]
    bits = torch.nn.functional.pad(bits, (0, 64 * W - n)).reshape(B, n, W, 64).to(torch.int64)
    words = torch.zeros((B, n, W), dtype=torch.int64, device=boxes.device)
    for k in range(64):
        words |= bits[..., k] << k
    return words


def nms_reduce_plain(words: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Phase 2 in plain PyTorch: words (B, N, W) from phase 1, valid (B, N)
    bool -> keep (B, N) bool. Rows in order; pivot i is kept iff valid and
    its bit of ``remv`` is clear, and a kept pivot ORs its words into
    ``remv``. Like the kernel it reads a row's words from its own 64-pivot
    block on (the words before it are the unwritten lower triangle)."""
    B, n, W = words.shape
    remv = torch.zeros((B, W), dtype=torch.int64, device=words.device)
    keep = torch.zeros((B, n), dtype=torch.bool, device=words.device)
    for i in range(n):
        t, k = divmod(i, 64)
        kept = valid[:, i] & (((remv[:, t] >> k) & 1) == 0)
        keep[:, i] = kept
        remv[:, t:] |= torch.where(kept[:, None], words[:, i, t:], 0)
    return keep


def pairs_needed(keep: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """IoU tests greedy NMS needs: each kept pivot against every valid box
    after it. ``keep`` (the sweep's, before any ``max_det`` cap), ``valid``
    (B, N) bool in sweep order -> 0-d int64 on their device."""
    seen = valid.cumsum(-1)  # valid boxes up to i; those after i are the total less it
    return ((seen[..., -1:] - seen) * keep).sum()


def _count_swept(images: int, n: int) -> None:
    """The pairs i < j a sweep of ``images`` images of ``n`` boxes tests."""
    profiling.count("nms.pairs_swept", images * n * (n - 1) // 2)


# ------------------------------------------------------------------- kernels

#: bytes of IoU-mask scratch one sweep call holds at most (unless one
#: image alone needs more): B=128 at N=8400 (1.14 GB) sweeps in two chunks
_SCRATCH_CAP_BYTES = 1 << 30


def _check(boxes: torch.Tensor, valid: torch.Tensor) -> None:
    if boxes.device.type != "cuda" or valid.device != boxes.device:
        raise ValueError(f"kernel needs CUDA tensors on one device, got "
                         f"{boxes.device} and {valid.device}")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"kernel needs f32 boxes and bool valid, got {boxes.dtype}, {valid.dtype}")
    if boxes.shape[-1] != 4 or tuple(valid.shape) != tuple(boxes.shape[:-1]):
        raise ValueError(f"shapes {tuple(boxes.shape)} / {tuple(valid.shape)}: "
                         "want (..., N, 4) and (..., N)")
    if not (boxes.is_contiguous() and valid.is_contiguous()) or boxes.data_ptr() % 16:
        raise ValueError("kernel needs contiguous inputs and 16-byte aligned boxes")


@functools.cache
def _mask_stride(n: int) -> int:
    return load_kernels().yst_nms_mask_stride(n)


def _chunk_images(batch: int, n: int, stride: int) -> int:
    """Images one chunk of a sweep call takes: the fewest chunks whose mask
    scratch, ``n * stride`` words an image, stays within
    ``_SCRATCH_CAP_BYTES`` (one image at least), split evenly."""
    fit = max(1, _SCRATCH_CAP_BYTES // (n * stride * 8))
    chunks = -(-batch // fit)
    return -(-batch // chunks)


def _mask_words(images: int, n: int, device: torch.device) -> torch.Tensor:
    """Phase 1's scratch for ``images`` images, (images, N, stride) int64
    with W = ceil(N/64) <= stride (up to N = 4096 the reduce's lanes, so
    that its loads take constant offsets), left uninitialised: the mask
    kernel writes the upper triangle of the first W words, the only words
    the reduce reads."""
    return torch.empty((images, n, _mask_stride(n)), dtype=torch.int64, device=device)


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _launch(name: str, boxes: torch.Tensor, valid: torch.Tensor, thr: float) -> torch.Tensor:
    _check(boxes, valid)
    keep = torch.empty(valid.shape, dtype=torch.bool, device=boxes.device)
    n = boxes.shape[-2]
    batch = boxes.shape[0] if name == "nms_sweep_batched" else 1
    chunk = _chunk_images(batch, n, _mask_stride(n))
    mask = _mask_words(chunk, n, boxes.device)
    lib = load_kernels()
    ptrs = (boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), mask.data_ptr())
    with torch.cuda.device(boxes.device):  # the runtime launches on the current device
        if name == "nms_sweep_batched":
            err = lib.yst_nms_sweep_batched(*ptrs, batch, n, chunk, thr, _stream())
        else:
            err = lib.yst_nms_sweep_single(*ptrs, n, thr, _stream())
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    launches[name] += 1
    _count_swept(batch, n)  # every chunk's images, a mask over all pairs each
    return keep


def _iou_mask(boxes: torch.Tensor, iou_threshold: float,
              valid: torch.Tensor | None = None) -> torch.Tensor:
    """Phase 1 alone on the card (for tests): boxes (B, N, 4) CUDA f32,
    valid (B, N) bool or None (all) -> the mask kernel's words (B, N, W)
    int64, zero where it writes nothing (the lower triangle), so they
    compare whole with :func:`nms_iou_mask_plain`. A view of the padded
    scratch."""
    _check(boxes, torch.ones(boxes.shape[:-1], dtype=torch.bool, device=boxes.device)
           if valid is None else valid)
    mask = _mask_words(*boxes.shape[:2], boxes.device).zero_()
    with torch.cuda.device(boxes.device):
        err = load_kernels().yst_nms_iou_mask(
            boxes.data_ptr(), None if valid is None else valid.data_ptr(), mask.data_ptr(),
            boxes.shape[0], boxes.shape[1], _f32(iou_threshold), _stream())
    if err:
        raise RuntimeError(f"nms_iou_mask kernel launch failed: cudaError {err}")
    return mask[..., :-(-boxes.shape[-2] // 64)]


# The two sweeps as torch.library custom ops: the eager path and a
# torch.export program (export.py) run the same op, whose CUDA kernel
# launches the hand-written kernels and whose CPU kernel runs the plain
# version. A device with neither (meta, say) raises in the wrapper; under
# export the op's fake implementation gives the output's shape.

@torch.library.custom_op("yst::nms_sweep_batched", mutates_args=(), device_types="cuda")
def _sweep_batched_op(boxes: torch.Tensor, valid: torch.Tensor,
                      iou_threshold: float) -> torch.Tensor:
    return _launch("nms_sweep_batched", boxes, valid, iou_threshold)


@torch.library.custom_op("yst::nms_sweep", mutates_args=(), device_types="cuda")
def _sweep_op(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    return _launch("nms_sweep", boxes, valid, iou_threshold)


def _sweep_batched_cpu(boxes, valid, iou_threshold):
    _count_swept(*valid.shape)
    return nms_sweep_batched_plain(boxes, valid, iou_threshold)


def _sweep_cpu(boxes, valid, iou_threshold):
    _count_swept(1, valid.shape[0])
    return nms_sweep_plain(boxes, valid, iou_threshold)


for _op, _plain in ((_sweep_batched_op, _sweep_batched_cpu), (_sweep_op, _sweep_cpu)):
    _op.register_kernel("cpu")(_plain)
    _op.register_fake(lambda boxes, valid, iou_threshold: torch.empty_like(valid))
del _op, _plain

_OPS = {"nms_sweep_batched": _sweep_batched_op, "nms_sweep": _sweep_op}


def _dispatch(name, boxes, valid, iou_threshold):
    boxes = boxes.to(torch.float32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    if valid.numel() == 0:
        return valid.clone()
    if boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {boxes.device}")
    return _OPS[name](boxes, valid, _f32(iou_threshold))


def nms_sweep_batched(boxes_sorted: torch.Tensor, valid_sorted: torch.Tensor,
                      iou_threshold: float = 0.45) -> torch.Tensor:
    """Batched greedy suppression, kernel #1 (the IoU mask over the whole
    card, then a reduce of one block per image), at any N: boxes (B, N, 4)
    xyxy with each row score-descending, valid (B, N) -> keep (B, N) bool.
    ``launches`` counts calls, however many chunks a call sweeps."""
    return _dispatch("nms_sweep_batched", boxes_sorted, valid_sorted, iou_threshold)


def nms_sweep(boxes_sorted: torch.Tensor, valid_sorted: torch.Tensor,
              iou_threshold: float = 0.45) -> torch.Tensor:
    """Single-image greedy suppression, kernel #2 (kernel #1's two phases
    at B = 1): boxes (N, 4) score-descending, valid (N,) -> keep (N,) bool."""
    return _dispatch("nms_sweep", boxes_sorted, valid_sorted, iou_threshold)


# ------------------------------------------------------------- entry points

def _class_offset(boxes: torch.Tensor, class_ids: torch.Tensor) -> torch.Tensor:
    """Shift each class into a disjoint coordinate range. As in the JAX
    package, ``span`` is the max over the WHOLE tensor (all images), not
    per image as in ``ops/nms.py``."""
    span = boxes.abs().max() + 1.0
    return boxes + (class_ids.to(boxes.dtype) * span * 2.0)[..., None]


def _cap(keep: torch.Tensor, max_det: int) -> torch.Tensor:
    """Keep only the first ``max_det`` survivors along the last axis."""
    rank = torch.cumsum(keep.to(torch.int32), dim=-1) - 1
    return keep & (rank < max_det)


def nms_kernel_batched(
    boxes: torch.Tensor,  # (B, N, 4)
    scores: torch.Tensor,  # (B, N)
    valid: torch.Tensor,  # (B, N)
    iou_threshold: float = 0.45,
    max_det: int = 300,
    class_ids: torch.Tensor | None = None,
    class_aware: bool = False,
    presorted: bool = False,
) -> torch.Tensor:
    """Batched greedy NMS on kernel #1 -> keep (B, N) bool.

    ``presorted``: rows are already score-descending (the top-k prefilter's
    output is), so the sort and its gathers are skipped."""
    if class_aware and class_ids is not None:
        boxes = _class_offset(boxes, class_ids)
    if presorted:
        return _cap(nms_sweep_batched(boxes, valid, iou_threshold), max_det)
    order = torch.argsort(-scores, dim=1, stable=True)
    boxes_s = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    valid_s = torch.gather(valid, 1, order)
    keep_s = _cap(nms_sweep_batched(boxes_s, valid_s, iou_threshold), max_det)
    return torch.zeros_like(keep_s).scatter_(1, order, keep_s)


def nms_kernel(
    boxes: torch.Tensor,  # (N, 4)
    scores: torch.Tensor,  # (N,)
    iou_threshold: float = 0.45,
    max_det: int = 300,
    valid: torch.Tensor | None = None,
    class_ids: torch.Tensor | None = None,
    class_aware: bool = False,
) -> torch.Tensor:
    """Single-image greedy NMS on kernel #2 -> keep (N,) bool."""
    n = boxes.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=boxes.device)
    if class_aware and class_ids is not None:
        boxes = _class_offset(boxes, class_ids)
    order = torch.argsort(-scores, stable=True)
    keep_s = _cap(nms_sweep(boxes[order], valid[order], iou_threshold), max_det)
    return torch.zeros_like(keep_s).scatter_(0, order, keep_s)
