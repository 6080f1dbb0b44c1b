"""Stage breakdown of the deploy path (port of ``scripts/bench_breakdown.py``).

    python -m yolo_scratch_tpu_torch.bench.breakdown [--batch 128] [--imgsz 640] [--iters 20]

Times each piece of the crater YOLO11n's deploy path on the device, on a
seeded f32 batch cast to bf16 there:

  forward           the BN-folded bf16 forward (raw maps, summed to a scalar)
  forward+decode    + the DFL decode of every anchor in f32 (summed)
  full              + the common postprocess: conf 0.25, top-512, kernel #1
  postprocess       decode output -> detections alone (precomputed decode)

Each is ``--iters`` calls back to back a window, best of 3 windows (every
window under ``windows_ms``), after 2 windows of warm-up: CUDA events
around the window on the card, the host clock up to a fetch on the CPU. ``flops_per_batch`` counts the forward's
multiply-adds from its conv shapes and its attention's two matmuls (2 FLOPs
each; the JAX script read XLA's cost analysis), and
``h100_bf16_peak_pct`` sets it against NVIDIA's 989 TFLOP/s dense bf16
peak of an H100 SXM at 700 W (the card's limit is under ``device``).

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from yolo_scratch_tpu_torch.bench import common as C
from yolo_scratch_tpu_torch.infer import Predictor
from yolo_scratch_tpu_torch.nn.modules import Attention
from yolo_scratch_tpu_torch.ops.decode import postprocess
from yolo_scratch_tpu_torch.utils.device import resolve_device

# NVIDIA's data-sheet bf16 dense peak of one H100 SXM at its full 700 W
H100_BF16_PEAK_FLOPS = 989e12


def forward_flops(model: torch.nn.Module, x: torch.Tensor) -> int:
    """FLOPs of one ``model(x)``: 2 per multiply-add of every conv and of
    each attention block's q·k and v·attn products."""
    total = 0

    def conv(m, _, out):
        nonlocal total
        kh, kw = m.kernel_size
        total += 2 * out.numel() * (m.in_channels // m.groups) * kh * kw

    def attn(m, inp, _):
        nonlocal total
        B, C_, H, W = inp[0].shape
        n = H * W
        total += 2 * B * m.num_heads * n * n * (m.key_dim + m.head_dim)

    hooks = [m.register_forward_hook(conv) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    hooks += [m.register_forward_hook(attn) for m in model.modules() if isinstance(m, Attention)]
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return total


def stage_ms(fn, iters: int, dev: torch.device, windows: int = 3,
             warmup: int = 2) -> list:
    """ms a call of ``fn`` in each timed window of ``iters`` calls."""
    out = []
    for w in range(warmup + windows):
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            C.sync(dev)
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                last = fn()
            C.fetch(last, dev)
            ms = (time.perf_counter() - t0) * 1e3
        if w >= warmup:
            out.append(ms / iters)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Deploy-path stage breakdown "
                                             "(scripts/bench_breakdown.py)")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", type=str, default=None, help="default: cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    img, B = args.imgsz, args.batch

    pred = Predictor(C.deploy_model(1, 5, "n", img, device=dev), C.deploy_config(img, B),
                     device=dev)
    m = pred.model
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((B, img, img, 1), generator=gen, device=dev)

    def post(decoded):
        return postprocess(decoded, img_size=img, conf_threshold=0.25, iou_threshold=0.45,
                           max_det=300, pre_nms_topk=512, nms_impl="kernel")

    def decode(feats):
        return m.decode([f.float() for f in feats])

    with torch.inference_mode():
        decoded = decode(pred._forward(x))
    stages = {
        "forward_ms": lambda: sum(f.float().sum() for f in pred._forward(x)),
        "forward_decode_ms": lambda: decode(pred._forward(x)).sum(),
        "full_ms": lambda: post(decode(pred._forward(x))),
        "postprocess_ms": lambda: post(decoded),
    }
    res, windows = {}, {}
    with C.kernel1_launches() as k1, torch.inference_mode():
        for key, fn in stages.items():
            windows[key] = stage_ms(fn, args.iters, dev)
            res[key] = min(windows[key])
    res["decode_ms_est"] = res["forward_decode_ms"] - res["forward_ms"]
    res.update(batch=B, imgsz=img, full_imgs_per_sec=B / (res["full_ms"] / 1e3),
               forward_imgs_per_sec=B / (res["forward_ms"] / 1e3))
    flops = forward_flops(m, x.to(pred.dtype))
    res["flops_per_batch"] = flops
    res["h100_bf16_peak_pct"] = 100.0 * flops / (res["forward_ms"] / 1e3) / H100_BF16_PEAK_FLOPS
    res = {k: (round(v, 3) if isinstance(v, float) else v) for k, v in res.items()}
    res.update(median_ms={k: statistics.median(v) for k, v in windows.items()},
               windows_ms=windows, nms_launches=k1["launches"],
               valid_per_image=float(post(decoded)[3].sum()) / B,
               device=C.device_block(dev))
    return C.emit(res)


if __name__ == "__main__":
    main()
