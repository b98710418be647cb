"""Device milliseconds per job of the operations launched inside
`stark/quotient` (the quotient sweeps, their iDFTs and the quotient commit)."""


def read(r):
    if r.dev is None or not r.dev["stage_s"].get("quotient"):
        return None
    return 1e3 * r.dev["stage_s"]["quotient"] / r.dev["jobs"]
