"""End-to-end learning check: overfit a detector on a tiny synthetic set
(port of ``scripts/overfit_check.py``, with its recipe and its JSON line).

Proves the whole training stack learns (loss, assignment, gradients,
decode, NMS kernel #1 in every epoch's validation, mAP) by driving mAP50
high on 16 images the model memorises:

    python -m yolo_scratch_tpu_torch.overfit_check [epochs] [--bf16]       # YOLO11n + TAL
    python -m yolo_scratch_tpu_torch.overfit_check [epochs] --model yolox  # YOLOX-nano +
                                                                           # SimOTA, L1 end phase

Runs on ``cuda`` unless ``--device cpu``. Prints a final JSON line with the
reached metrics.
"""

from __future__ import annotations

import json
import sys

from yolo_scratch_tpu_torch.data.loader import Loader
from yolo_scratch_tpu_torch.data.synthetic import SyntheticDataset
from yolo_scratch_tpu_torch.models.builder import CONFIGS, build_yolo11
from yolo_scratch_tpu_torch.models.yolox import build_yolox
from yolo_scratch_tpu_torch.train.trainer import Trainer, TrainerConfig
from yolo_scratch_tpu_torch.utils.device import resolve_device


def make_run(epochs: int = 60, bf16: bool = False, model_kind: str = "yolo11",
             device: str | None = None):
    """(model, train_loader, val_loader, config) of the JAX script's recipe,
    the model on ``device``."""
    dev = resolve_device(device)
    channels = 1 if model_kind == "yolo11" else 3
    ds = SyntheticDataset(n=16, img_size=128, channels=channels, num_classes=5,
                          max_objects=3, seed=7)
    train_loader = Loader(ds, batch_size=8, max_gt=8, shuffle=True, prefetch=0)
    val_loader = Loader(ds, batch_size=8, max_gt=8, prefetch=0)
    if model_kind == "yolox":
        model = build_yolox("nano", nc=5, ch=channels, device=dev)
        # the paper recipe's end phase: the last ~25% of epochs aug-off + L1 on
        final_epochs = max(epochs // 4, 1)
    else:
        model = build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n",
                             device=dev)
        final_epochs = 0
    cfg = TrainerConfig(epochs=epochs, lr=2e-3, warmup_epochs=3, val_conf=0.25,
                        pre_nms_topk=256, max_det=50, mixed_precision=bf16,
                        final_epochs=final_epochs)
    return model, train_loader, val_loader, cfg


def run(epochs: int = 60, bf16: bool = False, model_kind: str = "yolo11",
        device: str | None = None):
    """Train the recipe and print the JSON line: (the last epoch's val
    metrics, the trainer)."""
    model, train_loader, val_loader, cfg = make_run(epochs, bf16, model_kind, device)
    trainer = Trainer(model, train_loader, val_loader, cfg, model_kind=model_kind)
    result = trainer.fit(resume=False)

    final = result["history"][-1]["val"]
    print(json.dumps({
        "model": model_kind,
        "final_mAP50": final.get("mAP50", 0.0),
        "final_precision": final.get("precision", 0.0),
        "final_recall": final.get("recall", 0.0),
        "final_loss": final.get("loss", float("nan")),
        "epochs": epochs,
        "bf16": bf16,
    }))
    return final, trainer


def main(epochs: int = 60, bf16: bool = False, model_kind: str = "yolo11",
         device: str | None = None) -> dict:
    return run(epochs, bf16, model_kind, device)[0]


def cli(argv=None) -> dict:
    """``[epochs] [--bf16] [--model yolox] [--device cpu]``, as the JAX
    script reads its arguments."""
    argv = sys.argv[1:] if argv is None else list(argv)
    device = argv[argv.index("--device") + 1] if "--device" in argv else None
    pos = [a for i, a in enumerate(argv)
           if not a.startswith("--") and (i == 0 or argv[i - 1] not in ("--device", "--model"))]
    kind = "yolox" if "--model" in argv and "yolox" in argv else "yolo11"
    return main(int(pos[0]) if pos else 60, bf16="--bf16" in argv, model_kind=kind,
                device=device)


if __name__ == "__main__":
    cli()
