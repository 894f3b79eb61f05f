"""``BENCHMARK.json`` against the benchmark's contract, and every cell
against the files it is found by."""
import json
import re
from pathlib import Path

import pytest

from perfbench import compare, harness

ROOT = Path(__file__).resolve().parents[2]

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert (ROOT / "perfbench" / "run.py").is_file()


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51 and isinstance(rs, int)
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_bounds():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] \
        + BENCH["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert [m["name"] for m in BENCH["end_to_end"]] == ["step_ms", "setup_s"]
    for m in BENCH["per_layer"]:
        assert m["moves"] == "step_ms"
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        assert set(m["workloads"]) <= set(CELLS)
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(e["why"]) <= 200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = harness.Cell.load(cell)
    assert c.spec["chips"] == 1
    conf = next(x for x in BENCH["configs"] if x["name"] == c.spec["config"])
    assert conf["file"] == f"perfbench/configs/{c.spec['config']}.json"
    assert conf["reduced"] == []
    assert c.limits and set(c.limits) <= set(compare.NAMES)
    assert all(v > 0 for v in c.limits.values())
    assert c.traffic["kind"] == "train"
    assert c.traffic["batch"] % c.traffic["accum_steps"] == 0
    for m in c.per_layer:
        reader = harness.metric_reader(m["name"])
        assert reader.MOVES == m["moves"] and callable(reader.read)
    assert {m["name"] for m in c.end_to_end} == {"step_ms", "setup_s"}


def test_every_config_and_metric_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = {p.stem for p in (ROOT / "perfbench" / "metrics").glob("*.py")}
    assert {m["name"] for m in BENCH["per_layer"]} == files
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
