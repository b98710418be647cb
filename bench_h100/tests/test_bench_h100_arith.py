"""The metric arithmetic on synthetic data: the window rate, the 90th
percentile, the union of busy intervals and the idle gaps, the attribution
of device operations to the stage spans that launched them, the bytes
reckoning, and the whole-name test for forbidden modules."""

import os
import statistics
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import bh_costs
import bh_trace
import run as harness


def reader(name):
    return harness.load_module(os.path.join(BENCH, "metrics", f"{name}.py"), f"metric_{name}").read


def test_window_rate_and_tail():
    r = harness.Run()
    r.latencies = [0.1] * 90 + [0.5] * 10 + [0.2] * 20
    r.window_s = 17.0
    assert reader("prove_s")(r) == pytest.approx(17.0 / 120)
    assert reader("prove_p90_s")(r) == statistics.quantiles(r.latencies, n=10)[-1]
    r.latencies = r.latencies[:99]
    assert reader("prove_p90_s")(r) is None  # fewer than 100 jobs: no tail


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 9)]
    assert bh_trace.union_length(iv) == 5
    assert bh_trace.gaps(iv, 0, 10) == [(3, 5), (6, 8), (9, 10)]
    assert bh_trace.union_length([]) == 0


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "args": args}


def synthetic_trace():
    ev = [_x("bench/job", "user_annotation", 0, 1000), _x("bench/job", "user_annotation", 1000, 1000)]
    for j in (0, 1000):
        ev += [_x("stark/prove", "user_annotation", j + 10, 900),
               _x("stark/stage1_commit", "user_annotation", j + 20, 100),
               _x("stark/quotient", "user_annotation", j + 200, 100),
               _x("stark/fri_open", "user_annotation", j + 400, 400)]
        launches = [(j + 30, 1), (j + 250, 2), (j + 500, 3), (j + 850, 4)]  # the last outside every stage
        for t, c in launches:
            ev.append(_x("cudaLaunchKernel", "cuda_runtime", t, 5, correlation=j + c))
        ev += [_x("lde_tile_kernel(int)", "kernel", j + 40, 50, correlation=j + 1),
               _x("expr_sweep_ab(long)", "kernel", j + 260, 30, correlation=j + 2),
               _x("Memcpy DtoH", "gpu_memcpy", j + 520, 100, correlation=j + 3),
               _x("fri_fold_level_kernel<2>(long)", "kernel", j + 860, 20, correlation=j + 4)]
    return ev


def test_attribution_and_busy():
    dev = bh_trace.reduce(synthetic_trace())
    assert dev["jobs"] == 2 and dev["window_s"] == pytest.approx(2000e-6)
    assert dev["busy_s"] == pytest.approx(2 * 200e-6)
    assert dev["kernels"] == 6 and dev["unmatched"] == 0
    assert dev["stage_s"] == pytest.approx({"commit": 100e-6, "quotient": 60e-6, "open": 200e-6})
    assert dict(dev["device_ops"])["lde_tile_kernel"] == pytest.approx(100e-6)
    idle = dict(dev["idle_gaps"])
    assert sum(idle.values()) == pytest.approx(2000e-6 - 400e-6)
    assert idle["stark/fri_open"] > 0 and idle["bench/job"] > 0
    r = harness.Run()
    r.dev = dev
    assert reader("device_idle_pct")(r) == pytest.approx(80.0)
    assert reader("launches_per_prove")(r) == 3
    assert reader("device_ms.quotient")(r) == pytest.approx(0.03)
    r.least_bytes = {"commit": 50e-6 * bh_costs.HBM_BYTES_PER_S, "open": 1e-6 * bh_costs.HBM_BYTES_PER_S}
    assert reader("hbm_roofline_pct.commit")(r) == pytest.approx(100.0)
    assert reader("hbm_roofline_pct.open")(r) == pytest.approx(1.0)


def test_unmatched_launches_are_counted():
    ev = [e for e in synthetic_trace() if e["cat"] != "cuda_runtime"]
    dev = bh_trace.reduce(ev)
    assert dev["unmatched"] == 8 and dev["stage_s"] == {}


def test_transcript_is_prove_less_its_stages():
    r = harness.Run()
    r.latencies = [1, 1]
    r.span_s = {"stark/prove": 1.0, "stark/stage1_commit": 0.1, "stark/lookup_construction": 0.05,
                "stark/stage2_commit": 0.1, "stark/quotient": 0.15, "stark/fri_open": 0.4,
                "stark/fri_open/queries": 0.3}
    assert reader("host_s.transcript")(r) == pytest.approx(0.1)
    r.witness_s = [0.2, 0.4]
    assert reader("witness_s")(r) == pytest.approx(0.3)


class _C:
    def __init__(self, w, s2, q, pre=None):
        self.main_width, self.stage2_width, self.quotient_degree, self.preprocessed_dims = w, s2, q, pre


class _Pcs:
    log_blowup = 2

    class fri:
        cap_height = 0
        log_final_poly_len = 0
        max_log_arity = 1

    def fri_schedule(self, heights, log_max_ro):
        out, ls = [], log_max_ro
        while ls > self.log_blowup:
            out.append(1)
            ls -= 1
        return out


def test_bytes_reckoning_by_hand():
    class Cfg:
        pcs = _Pcs()

        class extension_params:
            degree = 2

    class Sys:
        config = Cfg()
        circuits = [_C(14, 26, 2), _C(1, 2, 1, (256, 1))]

    got = bh_costs.stage_bytes(Sys(), [1 << 10, 256])
    s1, s2 = (14 * 1024 + 256) * 8, (26 * 1024 + 2 * 256) * 8
    tree = 32 * (2 * 4096 - 1)
    assert got["commit"] == (s1 + s2) * 5 + 2 * tree
    q, pre = (2 * 2 * 1024 + 2 * 256) * 8, 256 * 8
    fri = sum((1 << ls) * 2 * 8 + 32 * (2 * (1 << (ls - 1)) - 1) for ls in range(12, 2, -1))
    assert got["open"] == 4 * (s1 + s2 + q + pre) + fri


def test_forbidden_modules_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "multistark_tpu_torch_fake.sub", object())
    monkeypatch.setitem(sys.modules, "jaxlib_fake", object())
    assert not {"multistark_tpu_torch_fake", "jaxlib_fake"} & set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "multistark_tpu.prover", object())
    assert "multistark_tpu" in harness.forbidden_modules()
