"""Seconds per proof: the whole measured window over the jobs it completed."""


def read(r):
    return r.window_s / len(r.latencies)
