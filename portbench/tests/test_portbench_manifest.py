"""BENCHMARK.json against the benchmark's contract, and every name it
gives found as a file."""

import json
import os

import pytest

from portbench.harness import manifest

ROOT = manifest.ROOT
MAN = manifest.load(ROOT)
CELLS = [w["name"] for w in MAN["workloads"]]
KEYS = {"config": {"name", "source", "file", "reduced", "why"},
        "cell": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert MAN["paths"] == ["portbench"]
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits in its 43200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_names_units_and_entries():
    names = []
    for c in MAN["configs"]:
        assert set(c) == KEYS["config"] and _line(c["why"])
        assert _line(c["source"]) and c["file"].startswith("portbench/")
        names.append(("config", c["name"]))
    for w in MAN["workloads"]:
        assert set(w) == KEYS["cell"] and _line(w["why"])
        assert w["chips"] in (1, 4)
        names.append(("cell", w["name"]))
    for section in ("end_to_end", "per_layer"):
        for m in MAN[section]:
            assert set(m) - {"workloads"} == KEYS[section], m["name"]
            assert manifest.UNIT_RE.match(m["unit"]), m["unit"]
            assert m["better"] in ("lower", "higher")
            names.append(("metric", m["name"]))
    for _, n in names:
        assert manifest.NAME_RE.match(n), n
    assert len(set(names)) == len(names)
    assert len({c["source"] for c in MAN["configs"]}) == len(MAN["configs"])
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(
        1, len(CELLS) // 4)


def test_bounds():
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in MAN["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_found_by_name(cell):
    w = manifest.cell(MAN, cell)
    cfg = manifest.config(ROOT, MAN, w["config"])
    entry = manifest.config_entry(MAN, w["config"])
    assert cfg["name"] == w["config"] and cfg["reduced"] == entry["reduced"]
    for k in ("n", "max_level", "alpha", "dnum", "level", "scale_bits"):
        assert isinstance(cfg[k], int), k
    assert cfg["dnum"] == -(-cfg["max_level"] // cfg["alpha"])
    mix = manifest.mix(ROOT, w["traffic"])
    assert os.path.exists(os.path.join(ROOT, "portbench", "drivers",
                                       mix["op"] + ".py"))
    e2e = manifest.metrics_of(MAN, "end_to_end", cell)
    layer = manifest.metrics_of(MAN, "per_layer", cell)
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert layer
    for section, ms in (("end_to_end", e2e), ("per_layer", layer)):
        for m in ms:
            assert os.path.exists(os.path.join(
                ROOT, manifest.reader_file(section, m["name"])))
    for m in layer:
        assert m["moves"] in [x["name"] for x in e2e]


def test_qualified_name_reads_with_its_base_reader():
    assert manifest.reader_file("end_to_end", "requests_per_s.host_paced") \
        == "portbench/endtoend/requests_per_s.py"
    assert manifest.reader_file("per_layer", "glue_ms_per_req.host_paced") \
        == "portbench/metrics/glue_ms_per_req.py"
    assert manifest.reader_file("per_layer", "keygen_s") \
        == "portbench/metrics/keygen_s.py"


def test_each_cell_reports_one_rate():
    for cell in CELLS:
        e2e = [m["name"] for m in manifest.metrics_of(MAN, "end_to_end",
                                                      cell)]
        assert sum(n.split(".")[0] == "requests_per_s" for n in e2e) == 1


def test_metric_workloads_name_cells():
    for section in ("end_to_end", "per_layer"):
        for m in MAN[section]:
            assert set(m.get("workloads", [])) <= set(CELLS)


def test_configs_parse():
    for c in MAN["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            json.load(f)
