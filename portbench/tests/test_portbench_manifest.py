"""The manifest and the files the harness finds by name."""

import os
import re

import pytest

import tiny  # noqa: F401  (puts the benchmark on sys.path)
import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in MAN["end_to_end"]}
CELLS = [w["name"] for w in MAN["workloads"]]


def _reports(metric, cell):
    return cell in metric.get("workloads", [cell])


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["portbench"]
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert 1 <= MAN["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    w = harness.cell(MAN, cell)
    cfg = harness.config(w["config"])
    mix = harness.traffic(w["traffic"], cfg["family"])
    drv = harness.driver(mix, cfg)
    for fn in ("inputs", "setup", "window", "end_to_end", "record",
               "outputs", "check", "control"):
        assert callable(getattr(drv, fn))
    limits = harness.load_json(os.path.join(harness.HERE, "limits",
                                            f"{cell}.json"))
    assert limits and all(v >= 0 for v in limits.values())
    assert w["chips"] == 1


@pytest.mark.parametrize("cfg", MAN["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
    body = harness.config(cfg["name"])
    assert body["name"] == cfg["name"]
    assert body["reduced"] == cfg["reduced"] == []
    assert body["precision"] == "float32"
    assert os.path.exists(os.path.join(harness.HERE, body["reference"]))
    assert any(w["config"] == cfg["name"] for w in MAN["workloads"])


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader_and_moves(metric):
    assert callable(harness.metric_reader(metric["name"]).read)
    moves = E2E[metric["moves"]]
    for cell in metric.get("workloads", CELLS):
        assert cell in CELLS
        assert _reports(moves, cell), (metric["name"], cell)


def test_names_and_units():
    named = (MAN["configs"] + MAN["workloads"] + MAN["end_to_end"]
             + MAN["per_layer"])
    for x in named:
        assert NAME.match(x["name"]), x["name"]
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in MAN[kind]]
        assert len(names) == len(set(names))


def test_bounds():
    assert E2E["setup_s"]["bound"] == 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] == "host_clock"


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    e2e = [m for m in MAN["end_to_end"] if _reports(m, cell)]
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert [m for m in MAN["per_layer"] if _reports(m, cell)]


def test_layers_named_alike():
    layers = {m["name"]: m["layer"] for m in MAN["per_layer"]}
    assert layers["device_idle.round"] == layers["device_idle.serve.dense"] \
        == layers["device_idle.serve.patchwise"]
    assert all(len(v) <= 200 and "\n" not in v for v in layers.values())
