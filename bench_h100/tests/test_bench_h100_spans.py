"""The readers of the program's own spans on synthetic data: the host
seconds per job of `stark/witness`, `stark/claims`, `stark/replay`,
`stark/fetch` and `stark/to_bytes` over the window's jobs, and the fetches
per prove from the program's span counts; each gives no reading where the
program has no such span."""

import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import run as harness
from multistark_tpu_torch import profiling

SPAN_READERS = {
    "host_s.witness": "stark/witness",
    "host_s.claims": "stark/claims",
    "host_s.replay": "stark/replay",
    "host_s.fetch": "stark/fetch",
    "host_s.serialize": "stark/to_bytes",
}


def reader(name):
    return harness.load_module(os.path.join(BENCH, "metrics", f"{name}.py"), f"metric_{name}").read


def window_run(span_s):
    r = harness.Run()
    r.latencies = [0.5, 0.7, 0.6, 0.4]
    r.span_s = dict(span_s)
    return r


@pytest.mark.parametrize("metric", list(SPAN_READERS))
def test_span_seconds_per_job(metric):
    span = SPAN_READERS[metric]
    others = {s: 9.0 for s in SPAN_READERS.values() if s != span}
    r = window_run({"stark/prove": 2.0, span: 0.3, **others})
    assert reader(metric)(r) == pytest.approx(0.3 / 4)
    assert reader(metric)(window_run({"stark/prove": 2.0, **others})) is None


def test_fetches_per_prove(monkeypatch):
    read = reader("fetches_per_prove")
    r = window_run({})  # read from the program's counts, not the window's seconds
    monkeypatch.setattr(profiling, "span_counts", lambda: {"stark/prove": 13, "stark/fetch": 26, "stark/claims": 13})
    assert read(r) == 2
    monkeypatch.setattr(profiling, "span_counts", lambda: {"stark/prove": 13, "stark/claims": 13})
    assert read(r) is None
    monkeypatch.setattr(profiling, "span_counts", lambda: {})
    assert read(r) is None


def test_fetches_per_prove_reads_the_spans_of_a_prove():
    """The reader on the program's own counters after real spans."""
    profiling.reset_spans()
    for _ in range(3):
        with profiling.span("stark/prove"):
            for _ in range(2):
                with profiling.span("stark/fetch"):
                    pass
    try:
        assert reader("fetches_per_prove")(window_run({})) == 2
    finally:
        profiling.reset_spans()
