"""Host seconds per job in the program's `stark/fetch` spans (each blocking
device-to-host read: the wait for the device queue, the copy and its
unpacking), over the window's jobs."""


def read(r):
    if "stark/fetch" not in r.span_s:
        return None
    return r.span_s["stark/fetch"] / len(r.latencies)
