"""Host dispatch: the mean host time of one call into the Predictor (both
halves of ``predict_batch``), by the host clock around each call, with no
sync, over the traced window. Long where a pageable copy blocks the host
behind the card's queue; short where the host only enqueues."""


def read(rec):
    calls = rec.get("call_s") or []
    return 1e3 * sum(calls) / len(calls) if calls else None
