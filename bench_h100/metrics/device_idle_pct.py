"""The share of the traced window in which no operation ran on the device."""


def read(r):
    if r.dev is None:
        return None
    return 100.0 * (1.0 - r.dev["busy_s"] / r.dev["window_s"])
