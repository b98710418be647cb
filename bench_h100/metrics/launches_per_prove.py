"""Kernel events on the card per job in the traced window."""


def read(r):
    if r.dev is None:
        return None
    return r.dev["kernels"] / r.dev["jobs"]
