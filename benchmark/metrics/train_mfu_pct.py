"""The whole step's share of the card's f32 peak: 3 times the forward's
FLOPs an image (forward, and backward's two products), for every image of
the traced window, over its wall time, against 67 TFLOP/s (the step runs
f32 with TF32 off, so no tensor-core peak applies)."""

from benchmark import roofline


def read(rec):
    if not rec.get("flops_per_image") or not rec["window_s"]:
        return None
    rate = 3 * rec["flops_per_image"] * rec["images"] / rec["window_s"]
    return 100.0 * rate / roofline.F32_PEAK_FLOPS
