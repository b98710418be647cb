"""Stage spans (the counterpart of multistark_tpu/profiling.py): the
`stark/*` spans that wrap every stage of the provers.

Spans nest, and each name accumulates its wall time and its count.  An edge
of a span takes one host-clock reading, the stack push or pop, the name's
time and count, and a `torch.profiler.record_function` of its name, which
puts the span on a profiler's timeline (the only exporter of single spans);
the entry also looks MULTISTARK_TEXRAY up in the environment.
With MULTISTARK_TEXRAY set, every span exit also streams one `[texray]` line
(filtered by comma-separated name prefixes; empty means "stark/"; a prefix
that matches nothing streams none), and only then does a span read the
host memory: the RSS change across it and the rise of the process's peak
RSS inside it (VmRSS and VmHWM of /proc/self/status, one pread on a
descriptor kept open per process; the JAX module reads RSS from
/proc/self/statm; where the status has no VmHWM the peak is getrusage's
ru_maxrss).  Those reads cost a prove milliseconds on a loaded host
(scripts/span_overhead.py), so `span_memory()` holds readings only for the
spans that closed while MULTISTARK_TEXRAY was set.

A span reads the host clock only: it neither synchronises the device nor
reads a device value.  On the card a stage's span is therefore the time the
host took to queue that stage's work, plus any fetch the stage makes itself;
`spans.py` gives the syncing per-stage breakdown.

Where the provers open them (the JAX package's names and places):

  stark/prove                the whole prove: `prover.prove_host_transcript`;
                             the device transcript's `dt_prover._prove_dt`
                             (device phase, global fetch, replay, queries)
  stark/stage1_commit        the stage-1 commit (`pcs.commit`, `pcs.commit_device`)
  stark/lookup_construction  `lookup.stage_2_traces_device`
  stark/stage2_commit        the stage-2 commit (`pcs.commit_device`; the host
                             transcript also fetches the cap and accumulators)
  stark/quotient             `prover._quotient_chunk_coeffs` per circuit and
                             the quotient commit
  stark/fri_open             `pcs.TwoAdicFriPcs.open`; on the device transcript
                             from the claimed evaluations to the end of the
                             replay's query phase
  stark/fri_open/eval        `pcs._claimed_evaluations` (host transcript: and
                             observing the values; device transcript: and the
                             opening points from the device ζ)
  stark/fri_open/ro          `pcs._reduced_openings`
  stark/fri_open/fold        `pcs._commit_phase` (host transcript),
                             `pcs._commit_phase_device_core` (device transcript)
  stark/fri_open/queries     `pcs._query_phase`

and the port's own five, each a leaf or outside `stark/prove`, so that the
ten above keep the JAX nesting:

  stark/witness              `system.SystemWitness.from_stage_1`: the host
                             time to queue the witness (no sync); one a job
  stark/claims               the claims' absorb, the β γ draws and the claims
                             accumulator (`dt_prover._device_phase`,
                             `prover.prove_host_transcript`); one a prove
  stark/fetch                each blocking device-to-host read,
                             `utils.fetch` and `merkle.MerkleMmcs.fetch`: the
                             wait for the device queue, the copy and its
                             unpacking; two a device-transcript prove (the
                             global fetch and the queries' gather)
  stark/replay               the device transcript's host replay, from the
                             global fetch to the query phase
                             (`dt_prover._fetch_and_replay`); one a
                             device-transcript prove, none on the host one
  stark/to_bytes             `prover.Proof.to_bytes`; one a job
"""

from __future__ import annotations

import contextlib
import os
import resource
import time
from typing import Dict, List, Optional, Tuple

import torch

_STACK: List[str] = []
_TIMES: Dict[str, float] = {}
_COUNTS: Dict[str, int] = {}
_MEM: Dict[str, Dict[str, float]] = {}

_STATUS = [-1, 0]  # a descriptor of /proc/self/status, the process that opened it


def _status() -> bytes:
    """The current /proc/self/status: a pread from offset 0 on a descriptor
    opened at first use (an open costs more than the read; a forked child
    closes its copy and opens its own)."""
    fd, pid = _STATUS
    if pid != os.getpid():
        if fd >= 0:
            os.close(fd)
        _STATUS[:] = [os.open("/proc/self/status", os.O_RDONLY), os.getpid()]
    return os.pread(_STATUS[0], 1 << 13, 0)


def _kib(status: bytes, key: bytes) -> Optional[int]:
    at = status.find(key)
    return int(status[at + len(key):].split()[0]) if at >= 0 else None


def _memory_mib() -> Tuple[float, float]:
    """(RSS, peak RSS) in MiB."""
    try:
        status = _status()
    except OSError:
        return 0.0, 0.0
    hwm = _kib(status, b"VmHWM:")
    if hwm is None:
        hwm = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return (_kib(status, b"VmRSS:") or 0) / 1024.0, hwm / 1024.0


def _enabled_prefixes():
    v = os.environ.get("MULTISTARK_TEXRAY")
    if v is None:
        return None
    return [p for p in (v.split(",") if v else ["stark/"]) if p] or ["stark/"]


@contextlib.contextmanager
def span(name: str):
    prefixes = _enabled_prefixes()
    _STACK.append(name)
    ann = torch.profiler.record_function(name)
    ann.__enter__()
    mem0 = None if prefixes is None else _memory_mib()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        ann.__exit__(None, None, None)
        _STACK.pop()
        _TIMES[name] = _TIMES.get(name, 0.0) + dt
        _COUNTS[name] = _COUNTS.get(name, 0) + 1
        if mem0 is not None:  # under MULTISTARK_TEXRAY only: the memory reading and the line
            (rss0, hwm0), (rss1, hwm1) = mem0, _memory_mib()
            m = _MEM.setdefault(name, {"rss_delta_mib": 0.0, "hwm_rise_mib": 0.0, "rss_mib": 0.0})
            m["rss_delta_mib"] += rss1 - rss0
            # a new process peak set inside the span: its transient allocations
            m["hwm_rise_mib"] += max(0.0, hwm1 - hwm0)
            m["rss_mib"] = rss1
            if any(name.startswith(p) for p in prefixes):
                indent = "  " * len(_STACK)
                print(
                    f"[texray] {indent}{name}: {dt * 1e3:.1f}ms ── "
                    f"RAM Δ {rss1 - rss0:+.0f}MiB peakΔ +{max(0.0, hwm1 - hwm0):.0f}MiB",
                    flush=True,
                )


def span_times() -> Dict[str, float]:
    """Accumulated seconds per span name, in the order the names first closed."""
    return dict(_TIMES)


def span_counts() -> Dict[str, int]:
    """How many times each span name closed."""
    return dict(_COUNTS)


def span_memory() -> Dict[str, Dict[str, float]]:
    """Accumulated host-memory movement per span name: rss_delta_mib (the RSS
    change across the span, summed over its calls), hwm_rise_mib (the rise
    of the process's peak RSS inside the span: its transient allocations),
    rss_mib (the RSS at its last exit).  Only spans that opened and closed
    while MULTISTARK_TEXRAY was set have a reading: without it a span reads
    no memory."""
    return {k: dict(v) for k, v in _MEM.items()}


def reset_spans() -> None:
    _TIMES.clear()
    _COUNTS.clear()
    _MEM.clear()
