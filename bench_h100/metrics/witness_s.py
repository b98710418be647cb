"""Host seconds per job of SystemWitness.from_stage_1, ending in a
synchronise, over the short witness stretch that follows the window (the
window's own jobs run with no synchronise inside)."""


def read(r):
    if not r.witness_s:
        return None
    return sum(r.witness_s) / len(r.witness_s)
