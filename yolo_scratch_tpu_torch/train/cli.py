"""Dataset selection shared by the port's CLIs (port of
``train/cli.py::make_datasets``; the training CLI itself is ROADMAP C6)."""

from __future__ import annotations

from pathlib import Path

from yolo_scratch_tpu_torch.data.synthetic import SyntheticDataset


def make_datasets(args):
    """``args.data`` / ``args.dataset`` / ``args.imgsz`` -> (dataset, ch, nc).

    Only the synthetic dataset is ported. The crater and COCO decoders need
    cv2 or the native host library, which the GPU machine lacks: they wait
    for ROADMAP C7b and raise here."""
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
    raise NotImplementedError(f"dataset {kind!r} ({args.data}): only 'synthetic' is ported; "
                              "the crater and COCO datasets wait for ROADMAP C7b")
