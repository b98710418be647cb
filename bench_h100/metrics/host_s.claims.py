"""Host seconds per job in the program's `stark/claims` span (the claims'
absorb into the transcript, the β γ draws and the claims accumulator), over
the window's jobs."""


def read(r):
    if "stark/claims" not in r.span_s:
        return None
    return r.span_s["stark/claims"] / len(r.latencies)
