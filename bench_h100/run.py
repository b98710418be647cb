"""The benchmark of multistark_tpu_torch on one NVIDIA H100: one run of one
cell.

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (BENCHMARK.json `workloads`) names a
configuration (bench_h100/configs/<config>.json, whose `family` names the
circuits' file bench_h100/configs/family_<family>.py: the plain
reference's circuits, the input generator and the program's circuits) and
a traffic mix (bench_h100/traffic/<traffic>.json: its parameters).  Each
metric is read by bench_h100/metrics/<metric>.py.  Adding a cell, a
configuration or a metric adds files and BENCHMARK.json entries.

A run: set-up (the program's system, a pool of seeded inputs on the
device, one cold job per input), then proof jobs back to back for
--seconds, closed loop, one prover.  A job takes the next input of the
pool, makes its own device copy of the traces, runs
SystemWitness.from_stage_1 and prover.prove_multiple_claims, and ends in
Proof.to_bytes() and a synchronise.  With --trace 1 two short stretches
follow the window: jobs that time the witness to a synchronise, and whole
jobs under torch.profiler for the device readings.  Then the program's
state is freed and the plain reference (bench_h100/plainref, a verifier in
NumPy that computes its own verifying key) judges every distinct proof the
timed jobs wrote.
The last line of standard output is the result; the numbers compared are
the last lines of standard error.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import hashlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "multistark_tpu")  # whole top-level module names
PROFILED_JOBS = 3
WITNESS_JOBS = 4


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Cell:
    """A cell of BENCHMARK.json: its workload entry, configuration, traffic,
    circuits' family and the metrics a run of it reports."""

    def __init__(self, workload: dict, cfg: dict, traffic: dict, metrics: list):
        self.workload, self.name, self.cfg, self.traffic, self.metrics = workload, workload["name"], cfg, traffic, metrics
        self.family = load_module(os.path.join(HERE, "configs", f"family_{cfg['family']}.py"), f"family_{cfg['family']}")

    @staticmethod
    def load(manifest: dict, name: str, trace: bool) -> "Cell":
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
        workload = cells[name]
        conf = {c["name"]: c for c in manifest["configs"]}[workload["config"]]
        with open(os.path.join(ROOT, conf["file"])) as f:
            cfg = json.load(f)
        with open(os.path.join(HERE, "traffic", f"{workload['traffic']}.json")) as f:
            traffic = json.load(f)
        kinds = manifest["per_layer"] if trace else manifest["end_to_end"]
        return Cell(workload, cfg, traffic, [m for m in kinds if name in m.get("workloads", [name])])


class Run:
    """What one run measured; the metric readers take their numbers from it."""

    def __init__(self):
        self.setup_s = 0.0
        self.window_s = 0.0
        self.latencies = []  # seconds of each job in the window
        self.witness_s = []  # with --trace 1: seconds of from_stage_1 in each job of the witness stretch
        self.span_s = {}  # the program's stark/* span seconds over the window's jobs
        self.peak_window_bytes = 0
        self.dev = None  # with --trace 1: bh_trace.reduce of the profiled stretch
        self.least_bytes = {}  # with --trace 1: bh_costs.stage_bytes of one job


def fri_parameters(cfg: dict) -> dict:
    return {k: cfg[k] for k in ("log_blowup", "cap_height", "log_final_poly_len", "max_log_arity", "num_queries",
                                "commit_proof_of_work_bits", "query_proof_of_work_bits")}


def make_pool(cell: Cell, seed: int):
    """The traffic's pool of inputs from the seed: (traces, claims) host
    NumPy arrays, the same shapes for every seed."""
    import numpy as np

    pool = []
    for k in range(cell.traffic["pool"]):
        rng = np.random.default_rng(np.random.SeedSequence([seed % 2 ** 64, k]))
        pool.append(cell.family.make_input(cell.cfg, cell.traffic, rng))
    return pool


class Program:
    """The system under test: the port's config and system for the cell, the
    pool on the device, and one proof job."""

    def __init__(self, cell: Cell, host_pool, device="cuda"):
        import torch

        import multistark_tpu_torch as mt
        from multistark_tpu_torch import prover
        from multistark_tpu_torch.config import CommitmentParameters, FriParameters
        from multistark_tpu_torch.configs import GoldilocksBlake3Config
        from multistark_tpu_torch.system import System, SystemWitness

        fri = fri_parameters(cell.cfg)
        self.torch, self.SystemWitness = torch, SystemWitness
        self.device = torch.device(device)
        config = GoldilocksBlake3Config(CommitmentParameters(fri.pop("log_blowup"), fri.pop("cap_height")),
                                        FriParameters(**fri), device=device)
        self.system, self.key = System.new(config, cell.family.program_inputs(cell.cfg))
        self.prove = prover.prove_multiple_claims
        self.pool = [mt.witness_from_numpy(t, c, device) for t, c in host_pool]

    def job(self, k: int, witness_times=None) -> bytes:
        """One proof job on pool input k; with `witness_times`, the witness
        is timed to a synchronise and its seconds appended there."""
        traces, claims = self.pool[k]
        traces = [t.clone() for t in traces]
        t0 = time.perf_counter()
        witness = self.SystemWitness.from_stage_1(traces, self.system, self.key)
        if witness_times is not None:
            self.sync()
            witness_times.append(time.perf_counter() - t0)
        data = self.prove(self.system, self.key, witness, claims).to_bytes()
        self.sync()
        return data

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()


def window(program: Program, run: Run, seconds: float, pool: int, proofs: dict):
    """Jobs back to back, closed loop, until `seconds` have passed."""
    run.latencies = []
    i = 0
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        data = program.job(i % pool)
        t1 = time.perf_counter()
        run.latencies.append(t1 - t0)
        keep(proofs, i % pool, data)
        i += 1
        if t1 - t_start >= seconds:
            break
    run.window_s = t1 - t_start


def keep(proofs: dict, k: int, data: bytes) -> None:
    """Group the proofs by input and digest, keeping one copy of each group."""
    proofs.setdefault((k, hashlib.sha256(data).hexdigest()), [data, 0])[1] += 1


def profiled_stretch(program: Program, pool: int, proofs: dict) -> dict:
    """PROFILED_JOBS whole jobs under torch.profiler, each in a `bench/job`
    range, reduced by bh_trace; the port's kernel launches in the trace are
    held against its own launch counters."""
    import bh_trace
    import torch
    from torch.profiler import ProfilerActivity, profile

    from multistark_tpu_torch import kernels

    before = kernels.launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.02)  # a session that closes right after its last kernels can lose their records
        for i in range(PROFILED_JOBS):
            with torch.profiler.record_function(bh_trace.JOB):
                keep(proofs, i % pool, program.job(i % pool))
        time.sleep(0.02)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    dev = bh_trace.reduce(events)
    launched = {k.name: (k.launches - before[k.name]) * k.per_launch for k in kernels.KERNELS}
    seen = {k.name: sum(n for fn, n in dev["kernel_names"].items() if any(f in fn for f in k.functions))
            for k in kernels.KERNELS}
    lost = {name: (launched[name], seen[name]) for name in launched if seen[name] < launched[name]}
    if lost:
        raise RuntimeError(f"the trace lost kernel records (launched, traced): {lost}")
    if dev["unmatched"]:
        raise RuntimeError(f"{dev['unmatched']} device operations in the trace have no launch record")
    return dev


def reference_system(cell: Cell):
    """The plain reference's system: its compiled circuits and the verifying
    key it commits itself from the circuits' tables."""
    from plainref.pcs import FriParameters
    from plainref.system import GoldilocksBlake3, System

    return System(GoldilocksBlake3(FriParameters(**fri_parameters(cell.cfg))), cell.family.reference_inputs(cell.cfg))


def judge(ref, host_pool, proofs: dict) -> dict:
    """The plain reference's verdict on every distinct proof, each read and
    verified against its input's claims.  A proof the reader or the
    verifier cannot take is rejected."""
    from plainref.serialization import proof_from_bytes
    from plainref.verifier import verify_multiple_claims

    rejected, reasons = 0, []
    for (k, digest), (data, count) in sorted(proofs.items()):
        try:
            verify_multiple_claims(ref, host_pool[k][1], proof_from_bytes(data, ref.config.extension_params.degree))
        except Exception as e:  # any failure to verify is a rejection, reported with its cause
            rejected += 1
            reasons.append(f"input {k}, proof {digest[:12]} ({count} jobs): {type(e).__name__} "
                           f"{getattr(e, 'kind', '')} {getattr(e, 'detail', e)}")
    return {"distinct": len(proofs), "rejected": rejected, "reasons": reasons}


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda"):
    """One run of the cell on `device`: (the result's metrics, its device
    entry, the reference's verdict, the Run, the proofs by input and
    digest).  Set-up counts from T0."""
    import torch

    import bh_costs
    from multistark_tpu_torch import profiling

    cuda = device == "cuda"
    torch.set_num_threads(1)  # one host thread: the pool's idle threads spin on a shared host's cores
    run = Run()
    marks = [("imports", time.perf_counter())]
    host_pool = make_pool(cell, seed)
    marks.append(("inputs", time.perf_counter()))
    program = Program(cell, host_pool, device)
    marks.append(("system and upload", time.perf_counter()))
    proofs: dict = {}
    for k in range(len(host_pool)):  # every shape of the window: the programs build or load here
        program.job(k)
    marks.append(("cold jobs", time.perf_counter()))
    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    profiling.reset_spans()
    gc.collect()  # every window starts from the same collector state
    run.setup_s = time.perf_counter() - T0

    window(program, run, seconds, len(host_pool), proofs)
    run.peak_window_bytes = torch.cuda.max_memory_allocated() if cuda else 0
    run.span_s = profiling.span_times()
    if trace:
        for i in range(WITNESS_JOBS):
            keep(proofs, i % len(host_pool), program.job(i % len(host_pool), run.witness_s))
        run.dev = profiled_stretch(program, len(host_pool), proofs)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.workload["chips"],
           "memory_peak_bytes": int(max(peak_setup, torch.cuda.max_memory_allocated())) if cuda else 0}
    del program
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = reference_system(cell)
    verdict = judge(ref, host_pool, proofs)
    t_ref = time.perf_counter() - t_ref
    edges = [("start", T0)] + marks
    print("set-up by phase, s: " + ", ".join(f"{name} {t - edges[i][1]:.2f}" for i, (name, t) in enumerate(marks))
          + f"; the reference's key and verdicts after the window: {t_ref:.2f} s", file=sys.stderr)
    if trace:
        run.least_bytes = bh_costs.stage_bytes(ref, [t.shape[0] for t in host_pool[0][0]])
        dev["busy_s"] = run.dev["busy_s"]
        dev["window_s"] = run.dev["window_s"]
    metrics = {}
    for m in cell.metrics:
        value = load_module(os.path.join(HERE, "metrics", f"{m['name']}.py"), f"metric_{m['name']}").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics, dev, verdict, run, proofs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [p for p in (HERE, ROOT) if p not in sys.path]

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    cell = Cell.load(manifest, args.workload, bool(args.trace))

    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, {torch.cuda.device_count()} device(s)", file=sys.stderr)
        return 2

    metrics, device, verdict, run, proofs = measure(cell, args.seed, args.seconds, bool(args.trace))
    device["card"] = power_limit()
    checks = {"rejected_proofs": {"value": verdict["rejected"], "limit": 0},
              "distinct_proofs_judged": {"value": verdict["distinct"], "limit": 1}}
    correct = verdict["rejected"] <= 0 and verdict["distinct"] >= 1
    bad = forbidden_modules()
    if bad:
        print(f"no result: modules loaded in this process: {bad}", file=sys.stderr)
        return 3
    result = {"correct": correct, "attempted": len(run.latencies), "failed": 0, "metrics": metrics,
              "device": device}
    if args.trace:
        result["breakdown"] = {"device_ops": run.dev["device_ops"], "idle_gaps": run.dev["idle_gaps"]}
    result["checks"] = checks
    for reason in verdict["reasons"]:
        print(f"rejected: {reason}", file=sys.stderr)
    print("job ms, in order: " + " ".join(str(round(1e3 * t)) for t in run.latencies), file=sys.stderr)
    n = len(run.latencies)
    print("per job, s: " + ", ".join(f"{k} {v / n:.5f}" for k, v in run.span_s.items() if k.count("/") == 1)
          + (f", witness {sum(run.witness_s) / len(run.witness_s):.5f}" if run.witness_s else "")
          + f", job {run.window_s / n:.5f}", file=sys.stderr)
    print(f"jobs {len(run.latencies)} in {run.window_s:.3f} s; proofs by input and digest: "
          f"{[(k, d[:12], c) for (k, d), (_, c) in sorted(proofs.items())]}", file=sys.stderr)
    print(f"check rejected_proofs {verdict['rejected']} (limit: at most 0)", file=sys.stderr)
    print(f"check distinct_proofs_judged {verdict['distinct']} (limit: at least 1)", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
