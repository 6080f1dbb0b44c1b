"""H2D + normalize: the share of the traced window's staged batches whose
pinned slot still held a running copy, so that the host waited for it:
100 x the counter ``h2d.slot_waits`` over ``h2d.staged``
(``yolo_scratch_tpu_torch/infer.py::PinnedRing``), read once after the
window (``yolo_scratch_tpu_torch/utils/profiling.py::counters``). 0 where
the ring has a slot more than the batches in flight; nothing where the
program staged nothing."""


def read(rec):
    try:
        from yolo_scratch_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    c = counters()
    if not c.get("h2d.staged"):
        return None
    return 100.0 * c.get("h2d.slot_waits", 0) / c["h2d.staged"]
