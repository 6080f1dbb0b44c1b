"""Kernel #1's share of its roofline: the least time greedy NMS could take
on these inputs (``roofline.nms_least_seconds``: the IoU tests of each kept
pivot against the valid boxes after it, counted from the plain reference's
keep sets of the checked batches, at 14 f32 operations a test against 67
TFLOP/s; or the boxes read and the keep flags written once against 3.35
TB/s, whichever is longer) over the device time of the mask and reduce
kernels per batch. Nothing where no such kernel ran."""

from benchmark import roofline

KERNELS = ("nms_iou_mask_kernel", "nms_reduce_kernel")


def read(rec):
    secs, launches = rec["trace"].kernel_s(KERNELS)
    if not launches or not rec["batches"] or "nms_tests_per_image" not in rec:
        return None
    B = rec["images"] / rec["batches"]
    least, _ = roofline.nms_least_seconds(round(rec["nms_tests_per_image"] * B),
                                          round(rec["nms_boxes_per_image"] * B))
    return 100.0 * least / (secs / rec["batches"])
