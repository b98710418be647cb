"""Reduce a profiler trace (Chrome trace JSON from torch.profiler) of a
stretch of whole jobs to the device readings the per-layer metrics take.

Each job runs inside a `bench/job` range.  The traced window runs from the
first job's start to the last job's end.  An operation on the device
(kernel, copy or fill) belongs to the stage whose `stark/*` range on the
host was open when the host launched it: the launch is the runtime or
driver call with the operation's correlation id.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

JOB = "bench/job"
# the provers' stage ranges (the program's `stark/*` spans), by stage
STAGES = {
    "stark/stage1_commit": "commit",
    "stark/stage2_commit": "commit",
    "stark/lookup_construction": "lookup",
    "stark/quotient": "quotient",
    "stark/fri_open": "open",
}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[Tuple[float, float]], start: float, end: float) -> List[Tuple[float, float]]:
    """The stretches of [start, end) that no interval covers."""
    out, t = [], start
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(s, e) for s, e in out if e > s]


class _Ranges:
    """Host ranges of one kind, for the innermost one that holds a time."""

    def __init__(self, ranges: Sequence[Tuple[float, float, str]]):
        self.ranges = sorted(ranges)
        self.starts = [r[0] for r in self.ranges]

    def at(self, t: float) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t)
        best = None
        for s, e, name in reversed(self.ranges[max(0, i - 256):i]):
            if s <= t < e and (best is None or s > best[0]):
                best = (s, name)
        return best[1] if best else None


def short_name(function: str) -> str:
    """A device function's name without its arguments and templates."""
    m = re.search(r"([A-Za-z_]\w*)\s*(<.*>)?\s*\(", function.replace("(anonymous namespace)", ""))
    return m.group(1) if m else function[:64]


def reduce(events: List[dict]) -> dict:
    """The readings of one traced stretch (times in seconds):
    jobs, window_s, busy_s (the union of device operations in the window),
    kernels (kernel events in the window), stage_s {stage: device seconds
    of the operations launched inside it}, unmatched (operations whose
    launch is not in the trace), device_ops and idle_gaps (the top ten by
    seconds: operations by label, idle stretches by the innermost host
    range open at their middle), kernel_names (count by function name)."""
    jobs = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name") == JOB)
    if not jobs:
        raise RuntimeError(f"the trace holds no {JOB} range")
    w0, w1 = jobs[0][0], jobs[-1][1]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and w0 <= e["ts"] < w1]
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    stages = _Ranges([r for r in host if r[2] in STAGES])
    spans = _Ranges([r for r in host if r[2].startswith(("stark/", "bench/"))])

    intervals = [(e["ts"], min(e["ts"] + e["dur"], w1)) for e in dev]
    stage_s: Dict[str, float] = defaultdict(float)
    by_label: Dict[str, float] = defaultdict(float)
    names: Dict[str, int] = defaultdict(int)
    unmatched = 0
    for e in dev:
        by_label[short_name(e["name"])] += e["dur"] / 1e6
        if e["cat"] == "kernel":
            names[e["name"]] += 1
        t = launches.get(e.get("args", {}).get("correlation"))
        if t is None:
            unmatched += 1
            continue
        stage = stages.at(t)
        if stage is not None:
            stage_s[STAGES[stage]] += e["dur"] / 1e6
    idle: Dict[str, float] = defaultdict(float)
    for s, e in gaps(intervals, w0, w1):
        idle[spans.at((s + e) / 2) or "outside every span"] += (e - s) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {
        "jobs": len(jobs),
        "window_s": (w1 - w0) / 1e6,
        "busy_s": union_length(intervals) / 1e6,
        "kernels": sum(1 for e in dev if e["cat"] == "kernel"),
        "stage_s": dict(stage_s),
        "unmatched": unmatched,
        "device_ops": top(by_label),
        "idle_gaps": top(idle),
        "kernel_names": dict(names),
    }
