"""Device ms a step of the kernels launched inside the program's span
``yst.train.forward`` (``TrainStep._phase``): the train-mode forward,
``TrainStep.forward``. Kernels are attributed by their launch time, whatever
thread launched them. Steps are counted by the program's own
``yst.train.h2d`` intervals. Unlike ``forward_ms.train``, which reads CUDA
events at the phase's ends and so counts the time the stream waits for the
host, this counts kernel time alone. Nothing where the program records no
such span."""

SPAN = "yst.train.forward"


def read(rec):
    tr = rec["trace"]
    steps = len(tr.spans("yst.train.h2d"))
    secs = tr.kernels_under(SPAN)
    return 1e3 * secs / steps if secs > 0 and steps else None
