"""A/B the hand-written fused bottleneck kernel against the library yardstick
on the card (port of ``scripts/probe_fused_bottleneck.py``).

    python -m yolo_scratch_tpu_torch.probe_fused_bottleneck [--batch 128] [--dtype bf16|f32]
        [--device cuda]

For each (H, C, Ch) bottleneck shape (W = H) of the s/m/l-scale models it
makes the probe's seeded inputs, runs kernel #3
(``ops/conv_kernels.fused_bottleneck``) once and holds it against its plain
version, then reports:

* the kernel's device ms (``torch.profiler``), and the call's ms by CUDA
  events over back-to-back calls (the wrapper's weight reorder and split
  and its host time included);
* the yardstick's device ms: the port's folded ``Bottleneck`` module in the
  same type, ``channels_last``, on cuDNN (f32 without TF32), as the
  Predictor runs it;
* the bound: the larger of the operations over the card's dense peak on the
  kernel's route and the bytes (x in, y out, both weights, each once) over
  its memory rate, and the kernel's share of it; for f32 also the bound on
  the CUDA cores (FFMA), which the route beats;
* max|d| against the plain version.

Needs a CUDA GPU (``--device cpu`` runs the check on the CPU, no times).
"""

from __future__ import annotations

import argparse
import json
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from yolo_scratch_tpu_torch.nn.fuse import fuse_conv_bn
from yolo_scratch_tpu_torch.nn.modules import Bottleneck
from yolo_scratch_tpu_torch.ops import conv_kernels as CK
from yolo_scratch_tpu_torch.utils.cuda_timing import call_ms, device_ms, time_ms
from yolo_scratch_tpu_torch.utils.device import resolve_device

# H100 SXM data-sheet peaks (NVIDIA, dense, at 700 W) on each type's route:
# bf16 tensor cores; TF32 tensor cores for f32, whose kernel takes three
# TF32 products for each f32 one (3xTF32); f32 FFMA on the CUDA cores, the
# f32 bound without tensor cores; HBM bytes/s.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12}
PRODUCTS = {torch.bfloat16: 1, torch.float32: 3}
CUDA_CORE_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

# (name, H, C, Ch), W == H: the probe's shapes (scripts/probe_fused_bottleneck.py)
SHAPES = [
    ("p3_s_64", 80, 64, 64),
    ("p3_s_128", 80, 128, 128),
    ("p4_s_128", 40, 128, 128),
    ("p5_s_256", 20, 256, 256),
    ("p4_m_256", 40, 256, 256),
    ("p5_l_512", 20, 512, 512),  # widest bottleneck in the scales table
]
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
REPS = 20  # calls per timed window (the plain version: a quarter)


def probe_inputs(rng: np.random.RandomState, B: int, H: int, C: int, Ch: int,
                 dtype: torch.dtype, device) -> Tuple[torch.Tensor, ...]:
    """The probe's inputs, drawn in its order and at its scales; weights in
    ``dtype``, biases f32."""
    x = rng.randn(B, H, H, C) * 0.5
    w1 = rng.randn(3, 3, C, Ch) * (1 / np.sqrt(9 * C))
    b1 = rng.randn(Ch) * 0.1
    w2 = rng.randn(3, 3, Ch, C) * (1 / np.sqrt(9 * Ch))
    b2 = rng.randn(C) * 0.1
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device, dt)
                 for a, dt in ((x, dtype), (w1, dtype), (b1, torch.float32),
                               (w2, dtype), (b2, torch.float32)))


def folded_module(w1, b1, w2, b2) -> Bottleneck:
    """The port's folded ``Bottleneck(C, C, shortcut=True, e=Ch/C)`` carrying
    these weights, in the weights' type, ``channels_last`` on the card."""
    C, Ch = w1.shape[2], w1.shape[3]
    m = fuse_conv_bn(Bottleneck(C, C, shortcut=True, k=(3, 3), e=Ch / C)).eval()
    with torch.no_grad():
        for cv, w, b in ((m.cv1, w1, b1), (m.cv2, w2, b2)):
            cv.conv.weight.copy_(w.permute(3, 2, 0, 1))
            cv.conv.bias.copy_(b)
    m = m.to(w1.device, w1.dtype)
    return m.to(memory_format=torch.channels_last) if w1.is_cuda else m


def flops(B: int, H: int, W: int, C: int, Ch: int) -> int:
    """Both convs' multiply-adds x 2."""
    return 2 * B * H * W * 9 * (C * Ch + Ch * C)


def bound_ms(B: int, H: int, W: int, C: int, Ch: int, dtype: torch.dtype) -> Tuple[float, str]:
    """Least time for one call on the card on the kernel's route: operations
    (:func:`flops`, times the tensor-core products each takes) over the
    route's dense peak vs bytes (x read once, y written once, both weights
    once; the biases are f32) over the HBM rate."""
    esize = torch.empty((), dtype=dtype).element_size()
    nbytes = 2 * B * H * W * C * esize + 2 * 9 * C * Ch * esize + 4 * (C + Ch)
    t_ops = PRODUCTS[dtype] * flops(B, H, W, C, Ch) / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def cuda_core_bound_ms(B: int, H: int, W: int, C: int, Ch: int) -> float:
    """The f32 operations' least time on the CUDA cores (FFMA, no tensor
    cores), the bound of the f32 kernel this one replaced."""
    return flops(B, H, W, C, Ch) / CUDA_CORE_F32_FLOPS * 1e3


def tolerance(dtype: torch.dtype) -> float:
    """rtol = atol of the kernel against its plain version, the JAX tests':
    bf16 0.05 (h is rounded to bf16 once; a sum in another order can round
    it to the neighbouring value), f32 1e-5 (the same sums in other orders)."""
    return 0.05 if dtype == torch.bfloat16 else 1e-5


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


@dataclass
class Case:
    """One shape: its inputs, the kernel's output and the plain version's."""

    name: str
    inputs: Tuple[torch.Tensor, ...]
    got: torch.Tensor
    ref: torch.Tensor

    @property
    def err(self) -> float:
        return max_abs(self.got, self.ref)

    def border_err(self) -> float:
        """max|d| on the first and last rows and columns alone."""
        g, r, ends = self.got, self.ref, [0, -1]
        return max(max_abs(g[:, ends], r[:, ends]), max_abs(g[:, :, ends], r[:, :, ends]))

    @property
    def atol(self) -> float:
        """:func:`tolerance`, times max|plain| where that is below 1: an
        absolute 0.05 would hold nothing on a map whose values are all
        smaller, as deep in a seeded YOLO11n."""
        return tolerance(self.got.dtype) * min(1.0, float(self.ref.float().abs().max()))

    def passes(self, got: torch.Tensor) -> bool:
        """``got`` within rtol = :func:`tolerance` and :attr:`atol` of the
        plain version, everywhere and on the border rows and columns."""
        rtol, g, r, ends = tolerance(self.got.dtype), got.float(), self.ref.float(), [0, -1]
        return all(torch.allclose(g[sel], r[sel], rtol=rtol, atol=self.atol)
                   for sel in ((...,), (slice(None), ends), (slice(None), slice(None), ends)))

    def check(self) -> None:
        """Raise unless the kernel passes, or if the check would also pass
        zeros or x itself (a kernel that skipped the residual branch)."""
        if not self.passes(self.got):
            raise AssertionError(f"{self.name}: kernel differs from the plain version by "
                                 f"{self.err:.3g} (border {self.border_err():.3g}; rtol "
                                 f"{tolerance(self.got.dtype):.3g}, atol {self.atol:.3g})")
        x = self.inputs[0]
        if self.passes(x) or self.passes(torch.zeros_like(x)):
            raise AssertionError(f"{self.name}: the check would pass zeros or x itself "
                                 f"(atol {self.atol:.3g}): it holds nothing here")


def run_cases(batch: int, dtype: torch.dtype, device, shapes=SHAPES, seed: int = 0) -> List[Case]:
    """The probe's path: one kernel call per shape, and its plain version."""
    rng = np.random.RandomState(seed)
    cases = []
    for name, H, C, Ch in shapes:
        inputs = probe_inputs(rng, batch, H, C, Ch, dtype, device)
        got = CK.fused_bottleneck(*inputs)
        cases.append(Case(name, inputs, got, CK.bottleneck_plain(*inputs)))
    return cases


def time_case(case: Case) -> dict:
    """Kernel (profiler and CUDA events), yardstick and plain device ms,
    bound and share for one case; for f32 also the CUDA-core bound."""
    x, w1, b1, w2, b2 = case.inputs
    B, H, W, C = x.shape
    Ch = w1.shape[-1]
    module = folded_module(w1, b1, w2, b2)
    xc = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC tensor: channels_last

    def call():
        return CK.fused_bottleneck(*case.inputs)

    with torch.inference_mode(), CK.full_f32():  # an f32 yardstick without TF32
        ms = call_ms(call, ("fused_bottleneck_kernel",), REPS)[0]
        event = time_ms(call, REPS)
        library = device_ms(lambda: module(xc), REPS)
        plain = device_ms(lambda: CK.bottleneck_plain(*case.inputs), REPS // 4)
    bms, by = bound_ms(B, H, W, C, Ch, x.dtype)
    out = dict(ms=ms, event_ms=event, library_ms=library, plain_ms=plain, bound_ms=bms,
               bound_by=by, share=bms / ms)
    if x.dtype == torch.float32:
        out["cuda_core_bound_ms"] = cuda_core_bound_ms(B, H, W, C, Ch)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    ap.add_argument("--device", default=None, help="default cuda; cpu checks without times")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = True  # the yardstick at cuDNN's fastest algorithm
        print(f"device: {torch.cuda.get_device_name(0)}  batch={args.batch}  dtype={args.dtype}",
              flush=True)
    print(f"{'shape':10s} {'kernel ms':>10s} {'event ms':>9s} {'cuDNN ms':>9s} {'plain ms':>9s} "
          f"{'bound ms':>9s} {'by':>10s} {'of bound':>8s} {'max|d|':>9s}", flush=True)
    rows = []
    for case in run_cases(args.batch, dtype, dev):
        row = dict(shape=case.name, max_abs_err=case.err)
        if dev.type == "cuda":
            row.update(time_case(case))
            core = (f"  (CUDA cores' bound {row['cuda_core_bound_ms']:.4f} ms)"
                    if "cuda_core_bound_ms" in row else "")
            print(f"{case.name:10s} {row['ms']:10.4f} {row['event_ms']:9.4f} "
                  f"{row['library_ms']:9.4f} {row['plain_ms']:9.3f} {row['bound_ms']:9.4f} "
                  f"{row['bound_by']:>10s} {row['share']:8.3f} {case.err:9.2e}{core}", flush=True)
        else:
            print(f"{case.name:10s} {'-':>10s} {'-':>9s} {'-':>9s} {'-':>9s} {'-':>9s} "
                  f"{'-':>10s} {'-':>8s} {case.err:9.2e}", flush=True)
        rows.append(row)
    print(json.dumps({"probe": rows, "batch": args.batch, "dtype": args.dtype}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
