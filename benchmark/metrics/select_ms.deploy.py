"""Device ms a batch of the kernels launched inside the program's
``yst.select`` span: candidate selection and decode (YOLO11's
select-then-decode in ``ops/decode.py``; YOLOX's ``yolox_eval_decode`` and
the top-k prefilter). Kernels are attributed by their launch (correlation id
to runtime call), over the traced window; splits ``postprocess_ms.deploy``
with ``nms_ms.deploy`` and ``pack_ms.deploy``. Nothing where the program
records no such span."""

SPAN = "yst.select"


def read(rec):
    secs = rec["trace"].kernels_under(SPAN)
    return 1e3 * secs / rec["batches"] if secs > 0 and rec["batches"] else None
