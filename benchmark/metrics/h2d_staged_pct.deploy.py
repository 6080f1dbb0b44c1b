"""H2D + normalize: the share of the traced window's batches that reached
the card through the program's pinned ring, 100 x the counter ``h2d.staged``
(``yolo_scratch_tpu_torch/infer.py::PinnedRing``, one a staged batch) over
the window's batch count, read once after the window
(``yolo_scratch_tpu_torch/utils/profiling.py::counters``). 100 where every
host batch took the pinned copy on the side stream; nothing where the
program keeps no such counter (it copies from pageable memory)."""


def read(rec):
    try:
        from yolo_scratch_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    staged = counters().get("h2d.staged")
    if not staged or not rec["batches"]:
        return None
    return 100.0 * staged / rec["batches"]
