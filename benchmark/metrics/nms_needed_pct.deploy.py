"""Kernel #1's needed share of its work: 100 x the program's counter
``nms.pairs_needed`` (each kept pivot of the sweep, before the ``max_det``
cap, against every valid box after it) over ``nms.pairs_swept`` (the pairs
the launched sweeps test, N(N-1)/2 an image), both summed over every batch
of the traced window and read once after it
(``yolo_scratch_tpu_torch/utils/profiling.py::counters``). Nothing where the
program keeps no such counters or swept nothing."""


def read(rec):
    try:
        from yolo_scratch_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    if not c.get("nms.pairs_swept"):
        return None
    return 100.0 * c.get("nms.pairs_needed", 0) / c["nms.pairs_swept"]
