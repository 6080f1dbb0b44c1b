"""Fused residual bottleneck: a hand-written CUDA kernel and its plain
version (port of ``ops/pallas_conv.py``).

==========================================  ====================================
``yolo_scratch_tpu/ops/pallas_conv.py``     here
==========================================  ====================================
``fused_bottleneck`` (kernel #3)            :func:`fused_bottleneck`
``bottleneck_xla``                          :func:`bottleneck_plain`
==========================================  ====================================

``nn/fuse.py::bottleneck_weights`` reads a folded ``Bottleneck`` as this
kernel's weights. The kernel reads them in the order :func:`weights_ohwi`
gives, which the wrapper makes once per call; the f32 kernel (3xTF32 on
the tensor cores) reads each reordered on into wgmma's core matrices
(:func:`weights_core_matrices`) and split into two tf32 tensors,
:func:`tf32_split`'s hi and lo.

The kernel lives in ``csrc/fused_bottleneck.cu`` (built with nvcc for sm_90a
at first use, loaded with ctypes). :func:`fused_bottleneck` runs the kernel
on a CUDA tensor and the plain PyTorch version on a CPU tensor; any other
device raises. ``launches`` counts kernel launches.

Layouts are the JAX package's: x and y NHWC, weights HWIO, f32 biases.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from yolo_scratch_tpu_torch.utils.build import PKG, build_cuda_library

_SOURCE = PKG / "csrc" / "fused_bottleneck.cu"
_SYMBOL = {torch.bfloat16: "yst_fused_bottleneck_bf16", torch.float32: "yst_fused_bottleneck_f32"}

#: kernel launches, for showing that a run went through the kernel
launches = {"fused_bottleneck": 0}

_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    launches["fused_bottleneck"] = 0


def load_kernels() -> ctypes.CDLL:
    """Build ``csrc/fused_bottleneck.cu`` into ``build/libyst_conv.so`` at
    first use and load it. nvcc may contract multiply-adds here: the kernel
    is held to a tolerance, and its sums are the tensor cores'."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_cuda_library("yst_conv", [_SOURCE])))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for dtype, sym in _SYMBOL.items():
            fn = getattr(lib, sym)
            # x, w1 (hi, lo in f32), b1, w2 (hi, lo in f32), b2, y
            fn.argtypes = [ptr] * (6 if dtype == torch.bfloat16 else 8) + [i32] * 5 + [ptr]
            fn.restype = i32
        _lib = lib
    return _lib


@contextlib.contextmanager
def full_f32():
    """cuDNN convolutions in full f32 (no TF32) inside the block."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _check_shapes(x, w1, b1, w2, b2) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    C, Ch = x.shape[-1], w1.shape[-1]
    if (tuple(w1.shape) != (3, 3, C, Ch) or tuple(w2.shape) != (3, 3, Ch, C)
            or tuple(b1.shape) != (Ch,) or tuple(b2.shape) != (C,)):
        raise ValueError(f"want w1 (3, 3, {C}, Ch), b1 (Ch,), w2 (3, 3, Ch, {C}), b2 ({C},); "
                         f"got {tuple(w1.shape)}, {tuple(b1.shape)}, {tuple(w2.shape)}, "
                         f"{tuple(b2.shape)}")


# ------------------------------------------------------------- plain version

def bottleneck_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                     b2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel #3, with ``bottleneck_xla``'s rounding
    points: weights cast to x's type, both convs summed in f32 (f32 upcasts
    into ``F.conv2d``, TF32 off), h rounded to x's type once after SiLU, the
    residual added in f32 and the result cast once."""
    _check_shapes(x, w1, b1, w2, b2)
    dt = x.dtype

    def conv(a, w):  # NHWC in, HWIO -> f32 NHWC out
        return F.conv2d(a.float().permute(0, 3, 1, 2), w.to(dt).float().permute(3, 2, 0, 1),
                        padding=1).permute(0, 2, 3, 1)

    with full_f32():
        h = F.silu(conv(x, w1) + b1.float()).to(dt)
        y = F.silu(conv(h, w2) + b2.float())
    return (x.float() + y).to(dt)


# -------------------------------------------------------------------- kernel

def weights_ohwi(w: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, K, N) -> OHWI (N, 3, 3, K), contiguous: the layout the
    kernel reads. Column n's nine taps of K inputs are then one contiguous
    run, which the kernel stages in shared memory K-major for wgmma."""
    return w.permute(3, 0, 1, 2).contiguous()


def weights_core_matrices(w_ohwi: torch.Tensor) -> torch.Tensor:
    """OHWI (N, 3, 3, K) -> (N / 8, 9K / 4, 8, 4), contiguous: wgmma's
    K-major core matrices (8 columns x 4 values, 128 bytes of f32) in order,
    the layout the f32 kernel reads. Any 8 columns' run of K' is then one
    contiguous run, as the kernel stages it in shared memory."""
    N = w_ohwi.shape[0]
    return w_ohwi.reshape(N // 8, 8, -1, 4).permute(0, 2, 1, 3).contiguous()


def _tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """f32 ``v`` rounded to tf32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds: add half of the 13
    dropped bits' unit to the magnitude, then clear them."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 ``w`` as tf32 values hi + lo: hi = tf32(w), lo = tf32(w - hi),
    each with its 13 low mantissa bits zero. hi + lo is w within 2^-22 |w|
    (for normal w), the operands of the f32 kernel's 3xTF32 products."""
    if w.dtype != torch.float32:
        raise TypeError(f"tf32_split takes f32, got {w.dtype}")
    hi = _tf32_rna(w)
    return hi, _tf32_rna(w - hi)


# cudaErrorInvalidValue: what the launch returns when no tile of these
# channel counts fits in one block's shared memory
_NO_TILE = 1


def _pad_channels(x, w1, b1, w2, b2):
    """The inputs with C and Ch padded with zeros up to multiples of 16,
    the widths the kernel's wgmma steps take. A zero channel of x meets
    zero weights and a zero channel of h is silu(0 + 0) = 0, so each adds
    exact zeros: the first C channels of the output are the unpadded
    bottleneck's."""
    pc, ph = -x.shape[-1] % 16, -w1.shape[-1] % 16
    return (F.pad(x, (0, pc)), F.pad(w1, (0, ph, 0, pc)), F.pad(b1, (0, ph)),
            F.pad(w2, (0, pc, 0, ph)), F.pad(b2, (0, pc)))


def _launch(x, w1, b1, w2, b2) -> torch.Tensor:
    tensors = (x, w1, b1, w2, b2)
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"kernel needs all inputs on {x.device}")
    if x.dtype not in _SYMBOL or w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise TypeError(f"kernel takes bf16 or f32 x with weights of its type, got "
                        f"{x.dtype}, {w1.dtype}, {w2.dtype}")
    if b1.dtype != torch.float32 or b2.dtype != torch.float32:
        raise TypeError(f"kernel takes f32 biases, got {b1.dtype}, {b2.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel needs contiguous inputs (x NHWC, weights HWIO)")
    B, H, W, C = x.shape
    Ch = w1.shape[-1]
    if C % 16 or Ch % 16:
        return _launch(*_pad_channels(x, w1, b1, w2, b2))[..., :C].contiguous()
    if x.data_ptr() % 16 or w1.data_ptr() % 32 or w2.data_ptr() % 32:
        raise ValueError("kernel needs x 16-byte and the weights 32-byte aligned")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    w1, w2 = weights_ohwi(w1), weights_ohwi(w2)
    if x.dtype == torch.float32:
        (w1h, w1l), (w2h, w2l) = (tf32_split(weights_core_matrices(w)) for w in (w1, w2))
        ptrs = (x, w1h, w1l, b1, w2h, w2l, b2, y)
    else:
        ptrs = (x, w1, b1, w2, b2, y)
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        err = getattr(load_kernels(), _SYMBOL[x.dtype])(
            *(t.data_ptr() for t in ptrs), B, H, W, C, Ch, stream)
    if err == _NO_TILE:
        raise ValueError(f"C={C}, Ch={Ch} ({x.dtype}): no tile fits within one block's "
                         "shared memory")
    if err:
        raise RuntimeError(f"fused_bottleneck kernel launch failed: cudaError {err}")
    launches["fused_bottleneck"] += 1
    return y


def fused_bottleneck(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                     b2: torch.Tensor) -> torch.Tensor:
    """y = x + silu(conv2(silu(conv1(x) + b1)) + b2); convs 3x3 SAME stride 1,
    kernel #3. x (B, H, W, C) bf16/f32, w1 (3, 3, C, Ch), w2 (3, 3, Ch, C) in
    x's type, b1 (Ch,), b2 (C,) f32 folded-BN biases -> (B, H, W, C). Any C
    and Ch, as the Pallas kernel: widths that are not multiples of 16 run
    padded with zero channels (:func:`_pad_channels`)."""
    _check_shapes(x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return bottleneck_plain(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bottleneck: no kernel for device {x.device}")
    return _launch(x, w1, b1, w2, b2)
