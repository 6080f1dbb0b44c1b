"""Device ms a batch of the kernels launched inside the program's ``yst.model``
span: the network itself, ``self.model(xx)`` in ``Predictor._forward``.
Kernels are attributed by their launch (correlation id to runtime call),
over the traced window; splits ``forward_ms.deploy`` with
``normalize_ms.deploy``. Nothing where the program records no such span."""

SPAN = "yst.model"


def read(rec):
    secs = rec["trace"].kernels_under(SPAN)
    return 1e3 * secs / rec["batches"] if secs > 0 and rec["batches"] else None
