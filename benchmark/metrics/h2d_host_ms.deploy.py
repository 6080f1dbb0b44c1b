"""H2D + normalize, the host's side: ms a batch that the host spends inside
the program's ``yst.h2d`` span, from the span's host intervals in the traced
window. The span holds the host copy of the uint8 batch into one of
``infer.py::PinnedRing``'s pinned slots (after a wait for that slot's
previous copy, where it still runs) and the enqueue of its non-blocking copy
on the ring's side stream. Nothing where the program records no such
span."""


def read(rec):
    iv = rec["trace"].spans("yst.h2d")
    if not iv or not rec["batches"]:
        return None
    return sum(b - a for a, b in iv) / 1e3 / rec["batches"]
