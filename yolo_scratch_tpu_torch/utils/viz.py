"""Prediction visualization: annotated images for the infer CLI's
``--save-viz DIR`` (a copy of the JAX package's ``utils/viz.py``, which
imports no JAX).

Each input image is re-read at its original resolution and its detections
are drawn as class-coloured boxes with ``name score`` tags. Host-side and
PIL-only: drawing runs on the original images after the device results
were fetched, and touches nothing on the compute path.
"""

from __future__ import annotations

import colorsys
from pathlib import Path
from typing import Dict, List, Optional, Sequence


def class_color(label: int, n_hint: int = 20) -> tuple:
    """Deterministic, well-separated RGB color for a class id.

    Golden-ratio hue stepping: consecutive ids land far apart on the hue
    wheel regardless of how many classes exist (``n_hint`` only seeds the
    spacing for tiny id ranges).
    """
    h = (label * 0.61803398875) % 1.0
    r, g, b = colorsys.hsv_to_rgb(h, 0.75, 0.95)
    return int(r * 255), int(g * 255), int(b * 255)


def draw_detections(
    image,
    boxes: Sequence[Sequence[float]],
    scores: Sequence[float],
    labels: Sequence[int],
    class_names: Optional[Sequence[str]] = None,
    line_width: Optional[int] = None,
):
    """Draw xyxy pixel-space detections; returns the annotated image.

    Drawn in place only when the input is already an RGB PIL image;
    paths and non-RGB images are opened/converted to a NEW RGB image
    (gray crater tiles render as grayscale-in-RGB so colored boxes stay
    visible) and the caller's original object is left unmodified.
    """
    from PIL import Image, ImageDraw

    if not hasattr(image, "size"):
        image = Image.open(image)
    if image.mode != "RGB":
        image = image.convert("RGB")
    draw = ImageDraw.Draw(image)
    W, H = image.size
    lw = line_width or max(1, round(min(W, H) / 320))

    for box, score, label in zip(boxes, scores, labels):
        label = int(label)
        color = class_color(label)
        x1, y1, x2, y2 = [float(v) for v in box]
        draw.rectangle([x1, y1, x2, y2], outline=color, width=lw)
        name = (
            class_names[label]
            if class_names is not None and 0 <= label < len(class_names)
            else str(label)
        )
        tag = f"{name} {float(score):.2f}"
        # text background: measure with the default bitmap font
        tb = draw.textbbox((0, 0), tag)
        tw, th = tb[2] - tb[0], tb[3] - tb[1]
        ty = y1 - th - 2 * lw if y1 - th - 2 * lw >= 0 else y1
        draw.rectangle([x1, ty, x1 + tw + 2 * lw, ty + th + 2 * lw], fill=color)
        draw.text((x1 + lw, ty + lw), tag, fill=(0, 0, 0))
    return image


def save_annotated(
    results: List[Dict],
    out_dir: str,
    class_names: Optional[Sequence[str]] = None,
    min_score: float = 0.0,
) -> List[str]:
    """Render one annotated PNG per Predictor result dict into ``out_dir``.

    ``results`` rows are the infer CLI's output format:
    ``{"path", "boxes" (xyxy px), "scores", "labels"}``. Name collisions
    across input subdirectories are disambiguated with a numeric suffix.
    Returns the written paths.
    """
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written: List[str] = []
    used = set()
    for r in results:
        keep = [i for i, s in enumerate(r["scores"]) if s >= min_score]
        img = draw_detections(
            r["path"],
            [r["boxes"][i] for i in keep],
            [r["scores"][i] for i in keep],
            [r["labels"][i] for i in keep],
            class_names=class_names,
        )
        stem = Path(r["path"]).stem
        name, k = f"{stem}.png", 1
        while name in used:
            name, k = f"{stem}_{k}.png", k + 1
        used.add(name)
        dest = out / name
        img.save(dest)
        written.append(str(dest))
    return written


def load_class_names(path: Optional[str]) -> Optional[List[str]]:
    """Class-name list from a file: one name per line, or a JSON array /
    COCO-style ``{"categories": [{"id", "name"}, ...]}`` (ids map to the
    contiguous train-time label space in sorted-id order, matching
    data/coco.py)."""
    if not path:
        return None
    import json

    text = Path(path).read_text()
    try:
        obj = json.loads(text)
    except json.JSONDecodeError:
        return [ln.strip() for ln in text.splitlines() if ln.strip()]
    if isinstance(obj, list):
        return [str(x) for x in obj]
    if isinstance(obj, dict) and "categories" in obj:
        cats = sorted(obj["categories"], key=lambda c: c["id"])
        return [str(c["name"]) for c in cats]
    raise ValueError(f"unrecognized class-names format: {path}")
