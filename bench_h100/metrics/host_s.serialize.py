"""Host seconds per job in the program's `stark/to_bytes` span
(Proof.to_bytes), over the window's jobs."""


def read(r):
    if "stark/to_bytes" not in r.span_s:
        return None
    return r.span_s["stark/to_bytes"] / len(r.latencies)
