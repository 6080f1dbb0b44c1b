"""H2D + normalize: device time of the host-to-device copies a batch makes
(the uint8 batch's copy from its pinned slot of the program's ring, on the
ring's side stream), ms per batch of the traced window, from the profiler's
copy events."""


def read(rec):
    secs = rec["trace"].copies_s("HtoD")
    return 1e3 * secs / rec["batches"] if secs > 0 and rec["batches"] else None
