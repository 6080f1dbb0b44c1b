"""Device ms a batch of the kernels launched inside the program's ``yst.pack``
span: the gather of the kept rows, their normalisation (``ops/decode.py.
Kernels are attributed by their launch (correlation id to runtime call),
over the traced window; :_finish``) and ``pack_detections`` (two intervals a
batch, summed):splits ``postprocess_ms.deploy`` with ``select_ms.deploy``
and ``nms_ms.deploy``. Nothing where the program records no such span."""

SPAN = "yst.pack"


def read(rec):
    secs = rec["trace"].kernels_under(SPAN)
    return 1e3 * secs / rec["batches"] if secs > 0 and rec["batches"] else None
