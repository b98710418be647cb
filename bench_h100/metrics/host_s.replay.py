"""Host seconds per job in the program's `stark/replay` span (the device
transcript's host replay, from the global fetch to the query phase), over
the window's jobs."""


def read(r):
    if "stark/replay" not in r.span_s:
        return None
    return r.span_s["stark/replay"] / len(r.latencies)
