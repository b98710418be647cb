"""The stage-1 and stage-2 commits' share of their HBM roofline: the least
seconds their bytes take at the card's published bandwidth (bh_costs) over
the device seconds of the operations launched inside `stark/stage1_commit`
and `stark/stage2_commit`."""

import bh_costs


def read(r):
    if r.dev is None or not r.dev["stage_s"].get("commit"):
        return None
    least = bh_costs.least_seconds(r.least_bytes["commit"]) * r.dev["jobs"]
    return 100.0 * least / r.dev["stage_s"]["commit"]
