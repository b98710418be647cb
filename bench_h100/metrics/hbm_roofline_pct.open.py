"""The opening's share of its HBM roofline: the least seconds its bytes
take at the card's published bandwidth (bh_costs) over the device seconds
of the operations launched inside `stark/fri_open` (claimed evaluations,
reduced openings, FRI rounds, queries)."""

import bh_costs


def read(r):
    if r.dev is None or not r.dev["stage_s"].get("open"):
        return None
    least = bh_costs.least_seconds(r.least_bytes["open"]) * r.dev["jobs"]
    return 100.0 * least / r.dev["stage_s"]["open"]
