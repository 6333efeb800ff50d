"""The benchmark's files: every cell, configuration, traffic mix and
per-layer metric resolves by name, BENCHMARK.json keeps to its contract's
names, units and sizes, and a new cell and metric need new files alone."""
import json
import re
import shutil
import statistics

import pytest

from portbench import harness

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
CELL_FILES = sorted(p.name[:-5] for p in (harness.HERE / "workloads")
                    .glob("*.json"))
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    loaded = harness.load_cell(cell)
    assert loaded["config"] == entry["config"]
    assert loaded["traffic"] == entry["traffic"]
    assert harness.window_path(loaded["traffic_file"]["path"]).run
    assert harness.end_to_end_of(BENCH, cell)
    assert harness.per_layer_of(BENCH, cell)
    assert "setup_s" in {m["name"] for m in harness.end_to_end_of(BENCH,
                                                                  cell)}


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_config_file_is_the_entry(config):
    data = harness.load_json(harness.ROOT / config["file"])
    assert config["file"] == f"portbench/configs/{config['name']}.json"
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=[m["name"] for m in BENCH["per_layer"]])
def test_metric_file_matches_entry(metric):
    module = harness.load_metric(metric["name"])
    assert (module.LAYER, module.SOURCE, module.MOVES, module.UNIT) == (
        metric["layer"], metric["source"], metric["moves"], metric["unit"])
    assert callable(module.read)


def test_every_metric_file_is_well_formed():
    """Each metric file names a layer, a source, the end-to-end metric it moves and a
    unit, and reads."""
    for path in (harness.HERE / "metrics").glob("*.py"):
        module = harness.load_metric(path.name[:-3])
        assert NAME.match(path.name[:-3]) and UNIT.match(module.UNIT)
        assert module.SOURCE in ("device_trace", "program_span",
                                 "program_counter", "host_clock")
        assert module.MOVES in {m["name"] for m in BENCH["end_to_end"]}
        assert callable(module.read)


def test_every_file_is_in_use():
    """No cell, configuration, traffic or metric file that no cell of
    BENCHMARK.json reads: a file nothing runs would drift from the port
    unseen."""
    assert CELL_FILES == sorted(CELLS)
    here = harness.HERE
    assert sorted(p.name[:-5] for p in (here / "configs").glob("*.json")) \
        == sorted(c["name"] for c in BENCH["configs"])
    assert sorted(p.name[:-5] for p in (here / "traffic").glob("*.json")) \
        == sorted({w["traffic"] for w in BENCH["workloads"]})
    assert sorted(p.name[:-3] for p in (here / "metrics").glob("*.py")) \
        == sorted(m["name"] for m in BENCH["per_layer"])
    samples = {harness.load_cell(c)["traffic_file"]["sample"]
               for c in CELLS} | {"toy"}
    assert sorted(p.name[:-4] for p in (here / "samples").glob("*.csv")) \
        == sorted(samples)


def test_names_units_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in METRICS] + CELLS \
        + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in BENCH["workloads"] + BENCH["configs"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m["workloads"]) <= set(CELLS)
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert len(json.dumps(BENCH)) < 64 * 1024
    # 2 + 14 runs a cell for 24 cells, each run_seconds + 60 s, 180 s of
    # compiles a cell and 1,200 s spare fit into 43,200 s.
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_limits_sit_between_readings():
    """Each limit is above its lower reading and below its upper one, as
    the cell file records them."""
    for cell in CELL_FILES:
        data = harness.load_cell(cell)
        for name, limit in data["limits"].items():
            lower, upper = data["readings"][name]
            assert lower < limit < upper, (cell, name)


def test_new_cell_and_metric_by_files_alone(tmp_path):
    base = tmp_path / "portbench"
    shutil.copytree(harness.HERE, base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (base / "workloads" / "rgcn_block.dummy.json").write_text(json.dumps(
        {"config": "rgcn_block", "traffic": "dummy", "limits": {},
         "readings": {}}))
    (base / "traffic" / "dummy.json").write_text(json.dumps(
        {"path": "train", "sample": "toy", "n_entities": 16,
         "n_relations": 9, "n_train": 43, "prefetch_threads": 1,
         "negative_mode": "binomial", "sampler": "uniform"}))
    (base / "metrics" / "dummy_ms.train.py").write_text(
        'LAYER = "host batch"\nSOURCE = "program_span"\n'
        'MOVES = "train_triples_per_s"\nUNIT = "ms"\n\n\n'
        'def read(r):\n    return statistics.median([1.0, 2.0, 3.0])\n'
        '\n\nimport statistics\n')
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "rgcn_block.dummy",
                               "config": "rgcn_block", "traffic": "dummy",
                               "chips": 1, "why": "a dummy"})
    bench["per_layer"].append({"name": "dummy_ms.train", "unit": "ms",
                               "better": "lower", "source": "program_span",
                               "layer": "host batch",
                               "moves": "train_triples_per_s",
                               "workloads": ["rgcn_block.dummy"]})
    bench["end_to_end"][0]["workloads"].append("rgcn_block.dummy")
    cell = harness.load_cell("rgcn_block.dummy", base)
    assert cell["traffic_file"]["sample"] == "toy"
    assert [m["name"] for m in harness.per_layer_of(bench,
                                                    "rgcn_block.dummy")] \
        == ["dummy_ms.train"]
    assert harness.load_metric("dummy_ms.train", base).read(None) == \
        statistics.median([1.0, 2.0, 3.0])
