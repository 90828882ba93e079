"""BENCHMARK.json against the benchmark's contract, the files it names,
and the result line's schema."""

import json
import re
import subprocess
import sys

import pytest

from portbench import harness

import helpers

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = helpers.bench()


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        assert m["moves"] in {
            e["name"] for e in BENCH["end_to_end"]}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", helpers.CELLS)
def test_every_name_resolves_to_its_files(cell):
    spec = harness.cell_spec(BENCH, cell)
    assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s"}
    assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]
    root = harness.ROOT
    driver = spec["traffic"]["driver"]
    assert (root / "portbench" / "drivers" / f"{driver}.py").exists()
    for m in spec["per_layer"]:
        assert callable(harness.reader(m["name"]))
        assert cell in m["workloads"]
    assert set(spec["limits"]) <= {"emit_gap", "frames_gap", "counts_wrong",
                                   "nodes_wrong", "selection_wrong",
                                   "lm_shortfall", "lm_stuck_share",
                                   "latents_missing"}


def test_discovery_by_name():
    """A cell's pieces are found by the names BENCHMARK.json gives: a cell
    added with an existing configuration and mix needs only its entry and
    its limits file."""
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(dict(BENCH["workloads"][0],
                                   name="ref_walk.crowd_root_copy"))
    with pytest.raises(FileNotFoundError, match="ref_walk.crowd_root_copy"):
        harness.cell_spec(bench, "ref_walk.crowd_root_copy")
    spec = harness.cell_spec(BENCH, "ref_walk.random_segments")
    names = {m["name"] for m in spec["per_layer"]}
    assert "walk_lm_ms.crowd" not in names and "walk_mfu.segments" in names


def test_result_line_schema():
    res = helpers.run_tiny("ref_walk.random_segments", 3000000029,
                           traced=True)
    assert isinstance(res["correct"], bool)
    assert isinstance(res["attempted"], int) and res["failed"] == 0
    for name, m in res["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert {"busy_s", "window_s", "memory_peak_bytes"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in res["breakdown"].values())
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())
    json.dumps(res)
    res = helpers.run_tiny("ref_walk.random_segments", 3000000029)
    assert set(res["metrics"]) == {"frames_per_s.segments", "setup_s"}


def test_run_refuses_without_a_card(tmp_path):
    if helpers.torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, str(helpers.ROOT / "portbench" / "run.py"),
         "--workload", "ref_walk.crowd_root", "--seed", "1", "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
