"""Forward: device ms per batch of the kernels launched inside the
benchmark's ``bench.forward`` span around ``Predictor.forward_feats`` (the
normalize, the BN-folded bf16 convs on cuDNN, attention, concat and
upsample)."""


def read(rec):
    secs = rec["trace"].kernels_under("bench.forward")
    return 1e3 * secs / rec["batches"] if secs > 0 and rec["batches"] else None
