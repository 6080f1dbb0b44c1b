"""Entry points (port of ``__graft_entry__.py``).

``entry(device=None)`` -> ``(fn, example_args)``: ``fn(x)`` is the
single-device forward plus decode of the seeded YOLO11n (crater config,
ch=1, nc=5), NHWC images -> (B, A, 4+nc) xywh pixel boxes and sigmoid
scores, in f32 with TF32 off (so the card and the CPU agree);
``example_args`` is one zero image of 640x640x1 on the device.

``dryrun_multichip(n)`` is ``parallel/dryrun.py``'s: one sync-BN
data-parallel train step over n CPU ranks.

    python -m yolo_scratch_tpu_torch.entry [--device cpu]   # entry forward: (1, 8400, 9)
"""

from __future__ import annotations

import argparse

import torch

from yolo_scratch_tpu_torch.models.builder import CONFIGS, YOLOModel, build_yolo11
from yolo_scratch_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: F401
from yolo_scratch_tpu_torch.train.steps import precision_scope
from yolo_scratch_tpu_torch.utils.device import resolve_device


def _build(ch: int = 1, nc: int = 5, scale: str = "n", device=None) -> YOLOModel:
    """The seeded YOLO11 of ``entry`` (seed 0), in eval mode on ``device``."""
    return build_yolo11(CONFIGS / "yolo11_crater.json", ch=ch, nc=nc, scale=scale, seed=0,
                        device=resolve_device(device)).eval()


def entry(device=None):
    """(forward + decode on the seeded YOLO11n, (a 1x640x640x1 zero image,))."""
    model = _build(device=device)
    dev = next(model.parameters()).device

    def forward(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), precision_scope("highest"):
            return model.decode(model(x))

    return forward, (torch.zeros((1, 640, 640, 1), dtype=torch.float32, device=dev),)


def main(argv=None) -> torch.Size:
    p = argparse.ArgumentParser(description="entry(): forward + decode of the seeded YOLO11n")
    p.add_argument("--device", type=str, default=None, help="default: cuda")
    args = p.parse_args(argv)
    fn, example = entry(args.device)
    out = fn(*example)
    print("entry forward:", tuple(out.shape))
    return out.shape


if __name__ == "__main__":
    main()
