"""The whole batch's share of the card's bf16 peak: the forward's FLOPs
(``roofline.forward_flops`` on the plain reference) for every image of the
traced window, over the window's wall time, against 989 TFLOP/s."""

from benchmark import roofline


def read(rec):
    if not rec.get("flops_per_image") or not rec["window_s"]:
        return None
    rate = rec["flops_per_image"] * rec["images"] / rec["window_s"]
    return 100.0 * rate / roofline.BF16_PEAK_FLOPS
