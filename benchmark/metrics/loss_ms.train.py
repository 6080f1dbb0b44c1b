"""Train step phase ``loss``: device ms a step between the CUDA events
recorded at ``TrainStep.on_phase``'s marks (the previous mark, or the
step's start, to ``\"loss\"``), averaged over the traced window's steps."""


def read(rec):
    return (rec.get("phase_ms") or {}).get("loss")
