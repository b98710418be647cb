"""Host seconds per job in the program's `stark/witness` span
(SystemWitness.from_stage_1: the time the host takes to queue the witness,
no synchronise), over the window's jobs."""


def read(r):
    if "stark/witness" not in r.span_s:
        return None
    return r.span_s["stark/witness"] / len(r.latencies)
