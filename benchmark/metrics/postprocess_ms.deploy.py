"""Decode + NMS + pack: device ms per batch of the kernels launched inside
the ``bench.postprocess`` span around ``Predictor.postprocess_feats``
(select, decode, kernel #1 and the packing)."""


def read(rec):
    secs = rec["trace"].kernels_under("bench.postprocess")
    return 1e3 * secs / rec["batches"] if secs > 0 and rec["batches"] else None
