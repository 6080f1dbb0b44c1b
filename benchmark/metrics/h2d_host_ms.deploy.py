"""H2D + normalize, the host's side: ms a batch that the host spends inside
the program's ``yst.h2d`` span (``Predictor._forward``'s pageable copy of
the uint8 batch to the card), from the span's host intervals in the traced
window. The copy blocks the host for as long as it waits behind the card's
queue and moves the bytes. Nothing where the program records no such span."""


def read(rec):
    iv = rec["trace"].spans("yst.h2d")
    if not iv or not rec["batches"]:
        return None
    return sum(b - a for a, b in iv) / 1e3 / rec["batches"]
