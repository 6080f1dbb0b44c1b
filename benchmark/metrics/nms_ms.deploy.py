"""Device ms a batch of the kernels launched inside the program's ``yst.nms``
span: kernel #1 (or #2 at B = 1), the class offset and the ``max_det`` cap,
in ``ops/decode.py``. Kernels are attributed by their launch (correlation id
to runtime call), over the traced window; splits ``postprocess_ms.deploy``
with ``select_ms.deploy`` and ``pack_ms.deploy``. Nothing where the program
records no such span."""

SPAN = "yst.nms"


def read(rec):
    secs = rec["trace"].kernels_under(SPAN)
    return 1e3 * secs / rec["batches"] if secs > 0 and rec["batches"] else None
