"""Every cell, configuration and metric of BENCHMARK.json is found by name
under igs_bench/, and every name and unit keeps to the allowed
characters."""

import json
import re

import pytest

from igs_bench import run as bench_run

BENCH = json.loads((bench_run.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files_found(cell):
    traffic = bench_run.load_json(bench_run.HERE / "workloads"
                                  / f"{cell['name']}.json")
    assert traffic["config"] == cell["config"]
    assert traffic["why"] == cell["why"]
    cfg = bench_run.load_json(bench_run.HERE / "configs"
                              / f"{cell['config']}.json")
    assert (bench_run.HERE / "drivers" / f"{cfg['driver']}.py").is_file()
    assert set(traffic["limits"]) <= set(
        __import__("igs_bench.compare", fromlist=["NUMBERS"]).NUMBERS)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    cfg = json.loads((bench_run.ROOT / config["file"]).read_text())
    assert cfg["name"] == config["name"]
    assert cfg["source"] == config["source"]
    assert cfg["reduced"] == config["reduced"]
    for key in config["reduced"]:
        assert NAME.match(key) and key in cfg


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader_found(metric):
    mod = bench_run.load_metric(metric["name"])
    assert callable(mod.read)
    assert mod.read({}) is None  # nothing to read: no number
    if metric in BENCH["per_layer"]:
        assert mod.MOVES == metric["moves"]
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}


def test_names_and_units():
    names = [m["name"] for m in METRICS] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [c["name"] for c in BENCH["configs"]] + \
        [w["traffic"] for w in BENCH["workloads"]] + \
        [w["config"] for w in BENCH["workloads"]]
    for n in names:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_what_it_must():
    for w in BENCH["workloads"]:
        e2e = bench_run.cell_metrics(BENCH, w["name"], trace=False)
        layer = bench_run.cell_metrics(BENCH, w["name"], trace=True)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert layer
