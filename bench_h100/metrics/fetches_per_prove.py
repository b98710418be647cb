"""Blocking device-to-host reads per prove: the program's count of
`stark/fetch` spans over its count of `stark/prove` spans, read when the
metric is read.  Both count the same jobs, every one since the reset before
the window."""


def read(r):
    from multistark_tpu_torch import profiling

    counts = profiling.span_counts()
    if not counts.get("stark/fetch") or not counts.get("stark/prove"):
        return None
    return counts["stark/fetch"] / counts["stark/prove"]
