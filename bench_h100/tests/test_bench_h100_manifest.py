"""BENCHMARK.json against the benchmark's contract: names, units and
characters, every cell's configuration, traffic and metric readers on disk,
the layers, and what a full check costs."""

import json
import os
import re

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_names_and_units():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["bench_h100"] and all(PATH.match(p) for p in m["paths"])
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in m[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for metric in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    for text in [w["why"] for w in m["workloads"]] + [c["source"] for c in m["configs"]] + \
            [p["layer"] for p in m["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_every_piece_is_on_disk():
    m = manifest()
    configs = {c["name"]: c for c in m["configs"]}
    for c in m["configs"]:
        assert c["file"].startswith("bench_h100/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"]
        assert os.path.exists(os.path.join(BENCH, "configs", f"family_{cfg['family']}.py"))
    for w in m["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert os.path.exists(os.path.join(BENCH, "traffic", f"{w['traffic']}.json"))
        for kind in ("end_to_end", "per_layer"):
            assert any(w["name"] in x.get("workloads", [w["name"]]) for x in m[kind] if x["name"] != "setup_s")
    for metric in m["end_to_end"] + m["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics", f"{metric['name']}.py")), metric["name"]
        for w in metric.get("workloads", []):
            assert w in {x["name"] for x in m["workloads"]}
    assert len({(w["config"], w["traffic"]) for w in m["workloads"]}) == len(m["workloads"])


def test_bounds_sources_and_layers():
    m = manifest()
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for x in m["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25 and x["source"] in ("host_clock", "device_trace")
    for x in m["per_layer"]:
        assert x["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert x["moves"] in e2e
        cells = x.get("workloads", [w["name"] for w in m["workloads"]])
        for cell in cells:  # the metric it moves is reported in each of its cells
            assert cell in e2e[x["moves"]].get("workloads", [cell])
        if x["name"].endswith("_roofline") or "roofline" in x["name"]:
            assert x["unit"] == "%"


def test_a_full_check_fits_with_24_cells():
    rs = manifest()["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
