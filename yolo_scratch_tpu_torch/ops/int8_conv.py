"""The int8 convolution of the int8 deploy path: s8 x s8 -> s32, exactly.

The JAX package leaves this conv to XLA (``lax.conv_general_dilated`` on
int8 operands with ``preferred_element_type=int32``, which the TPU runs on
its MXU); here it goes to PyTorch ops and cuBLASLt, not to a hand kernel.
``F.conv2d`` takes no int8 on CUDA and ``F.unfold`` none anywhere, so the
patches are gathered with strided slices (exact for any dtype) and:

* ``groups == 1``: one ``torch._int_mm`` (cuBLASLt's s8 x s8 -> s32
  tensor-core GEMM on the card) of the (B*Ho*Wo, k*k*C) patch matrix with
  the (k*k*C, O) weights. ``_int_mm`` wants K and N multiples of 8 and more
  than 16 rows on CUDA; zero padding adds zero products, so it is exact;
* depthwise (``groups == C == O``, the PSA ``pe`` conv): an int32 multiply
  and sum over the k*k taps.

:func:`int8_conv2d_plain` is the same function as ``F.conv2d`` in float64 on
the int8 values: exact, since every partial sum is an integer below
127^2 * K < 2^53. Tests and ``chip_smoke.py`` hold the route to it; no
deploy path calls it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def int8_conv2d_plain(xq: torch.Tensor, w_q: torch.Tensor, stride: int = 1, padding: int = 0,
                      dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` in float64 on int8 NCHW ``xq`` and OIHW ``w_q`` -> int32."""
    return F.conv2d(xq.double(), w_q.double(), None, stride, padding, dilation,
                    groups).to(torch.int32)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K) int8 transposed -> (M, N) int32, padded to what
    ``torch._int_mm`` takes: K, N multiples of 8, M > 16. ``w`` goes in
    transposed (column-major), the "TN" layout of cuBLASLt's int8 GEMM."""
    M, K = a.shape
    N = w.shape[0]
    Kp, Np, Mp = _round_up(K, 8), _round_up(N, 8), max(M, 17)
    if Kp != K or Mp != M:
        a = F.pad(a, (0, Kp - K, 0, Mp - M))
    if Kp != K or Np != N:
        w = F.pad(w, (0, Kp - K, 0, Np - N))
    y = torch._int_mm(a.contiguous(), w.contiguous().t())
    return y[:M, :N]


def _out_hw(H: int, W: int, k: int, s: int, p: int, d: int):
    return (H + 2 * p - d * (k - 1) - 1) // s + 1, (W + 2 * p - d * (k - 1) - 1) // s + 1


@torch.library.custom_op("yst::int8_conv2d", mutates_args=())
def _int8_conv2d_op(xq: torch.Tensor, w_q: torch.Tensor, stride: int, padding: int,
                    dilation: int, groups: int) -> torch.Tensor:
    B, C, H, W = xq.shape
    O, cg, k, _ = w_q.shape
    s, p, d = stride, padding, dilation
    Ho, Wo = _out_hw(H, W, k, s, p, d)
    x = xq.permute(0, 2, 3, 1)  # NHWC: a patch row is contiguous channels
    if p:
        x = F.pad(x, (0, 0, p, p, p, p))
    taps = [x[:, i * d: i * d + s * (Ho - 1) + 1: s, j * d: j * d + s * (Wo - 1) + 1: s]
            for i in range(k) for j in range(k)]
    if groups == 1:
        # patch columns ordered (tap, channel); the weights to match
        a = taps[0].reshape(-1, C) if k == 1 else torch.stack(taps, 3).reshape(-1, k * k * C)
        y = _int_mm(a, w_q.permute(0, 2, 3, 1).reshape(O, k * k * C))
        return y.reshape(B, Ho, Wo, O).permute(0, 3, 1, 2)
    t = torch.stack(taps, 3).to(torch.int32)  # depthwise: (B, Ho, Wo, k*k, C)
    y = (t * w_q.reshape(O, k * k).t().to(torch.int32)).sum(3, dtype=torch.int32)
    return y.permute(0, 3, 1, 2)


@_int8_conv2d_op.register_fake
def _(xq, w_q, stride, padding, dilation, groups):
    B, _, H, W = xq.shape
    O, _, k, _ = w_q.shape
    Ho, Wo = _out_hw(H, W, k, stride, padding, dilation)
    return xq.new_empty((B, Ho, Wo, O), dtype=torch.int32).permute(0, 3, 1, 2)


def int8_conv2d(xq: torch.Tensor, w_q: torch.Tensor, stride: int = 1, padding: int = 0,
                dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """Exact int8 convolution: ``xq`` (B, C, H, W) int8, ``w_q`` (O, C/g, k,
    k) int8 -> (B, O, Ho, Wo) int32 (a channels-last view). Square kernels,
    one stride, padding and dilation for both axes (``ConvBNAct``'s). The
    op ``yst::int8_conv2d`` holds the route, so an exported program carries
    one node per conv."""
    if xq.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8_conv2d takes int8 operands, got {xq.dtype} and {w_q.dtype}")
    C, (O, cg) = xq.shape[1], w_q.shape[:2]
    if not ((groups == 1 and cg == C) or (groups == C == O and cg == 1)):
        raise ValueError(f"int8_conv2d: groups={groups} with C={C}, O={O}: only dense and "
                         "depthwise convolutions are supported")
    return _int8_conv2d_op(xq, w_q, stride, padding, dilation, groups)
