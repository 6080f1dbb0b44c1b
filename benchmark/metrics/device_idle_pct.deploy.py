"""Device idle share of the traced window: the part of it in which no
kernel, copy or memset ran on the card."""


def read(rec):
    tr = rec["trace"]
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s) if tr.window_s > 0 else None
