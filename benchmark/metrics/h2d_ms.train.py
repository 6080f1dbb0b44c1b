"""Train step phase ``h2d``: device ms a step between the CUDA events
recorded at ``TrainStep.on_phase``'s marks (the previous mark, or the
step's start, to ``\"h2d\"``), averaged over the traced window's steps."""


def read(rec):
    return (rec.get("phase_ms") or {}).get("h2d")
