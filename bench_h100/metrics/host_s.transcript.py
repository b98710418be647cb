"""Host seconds per job outside the prover's five stage spans: `stark/prove`
less `stark/stage1_commit`, `stark/lookup_construction`,
`stark/stage2_commit`, `stark/quotient` and `stark/fri_open` (the
transcript between the stages), over the window's jobs, which run as
they do in an untraced run."""

STAGES = ("stark/stage1_commit", "stark/lookup_construction", "stark/stage2_commit", "stark/quotient",
          "stark/fri_open")


def read(r):
    if "stark/prove" not in r.span_s:
        return None
    return (r.span_s["stark/prove"] - sum(r.span_s.get(s, 0.0) for s in STAGES)) / len(r.latencies)
