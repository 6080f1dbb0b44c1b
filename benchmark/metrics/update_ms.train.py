"""Train step phase ``clip_adamw_ema``: device ms a step from the
``"backward"`` mark to the ``"clip_adamw_ema"`` mark of
``TrainStep.on_phase`` (clip, AdamW and the EMA in ``train/state.py``),
averaged over the traced window's steps."""


def read(rec):
    return (rec.get("phase_ms") or {}).get("clip_adamw_ema")
