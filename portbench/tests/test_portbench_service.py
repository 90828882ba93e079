"""The service cell `ref_actions.service_requests`: its entries and files
by name, its readers on a recorded request trace (the warm-up and the
traced requests left out), its operation counts against hand-worked
values, a small run through the harness on the CPU that loads no JAX, and
on the card a run of a few seconds through `run.py`."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import harness, model_actions
from portbench.counts import request
from portbench.reference import judge_requests

import helpers

CELL = "ref_actions.service_requests"
BENCH = helpers.bench()
SMALL = dict(n_joints=4, n_dim=19, n_basis_spatial=8, k_s=5, k_t=2,
             n_components=3, n_canonical_frames=40)
FAST = dict(walk_cm=[120.0, 240.0], action_walk_cm=[60.0, 120.0],
            traced_walks=1)
SIZES = dict(n_random_samples=8, lm_iterations=2)
METRICS = ("request_lm_host_ms.service", "request_plan_host_ms.service",
           "request_ik_host_ms.service", "service_edge_ms.service",
           "host_syncs_per_step.service", "device_idle.service",
           "launches_per_kframe.service", "request_mfu.service")


def test_entries_and_names():
    spec = harness.cell_spec(BENCH, CELL)
    assert spec["cell"]["chips"] == 1 and spec["cell"]["config"] == \
        "ref_actions"
    config = [c for c in BENCH["configs"] if c["name"] == "ref_actions"][0]
    assert config["reduced"] == [] and len(config["source"]) <= 200
    assert spec["config"]["source"] == config["source"]
    # the widths are ref_walk's
    walk = harness.load_json(harness.ROOT / "portbench/configs/ref_walk.json")
    for key in ("n_joints", "n_dim", "n_basis_spatial", "n_basis_time", "k_s",
                "k_t", "n_components", "n_canonical_frames",
                "quat_eigen_scale"):
        assert spec["config"][key] == walk[key], key
    # the cell reports the accepted frame rate under its bound, the crowd's
    assert [m["name"] for m in spec["end_to_end"]] == [
        "frames_per_s.crowd", "setup_s"]
    rate = [m for m in BENCH["end_to_end"]
            if m["name"] == "frames_per_s.crowd"][0]
    assert rate["bound"] == 0.25 and rate["workloads"][-1] == CELL
    assert tuple(m["name"] for m in spec["per_layer"]) == METRICS
    for m in spec["per_layer"]:
        assert m["workloads"] == [CELL]
        assert m["moves"] == "frames_per_s.crowd"
        assert callable(harness.reader(m["name"]))
    assert set(spec["limits"]) == set(judge_requests.NUMBERS)
    assert spec["traffic"]["driver"] == "service"
    assert (harness.ROOT / "portbench/drivers/service.py").exists()


def test_configuration_builds_the_action_graph():
    cfg = harness.cell_spec(BENCH, CELL)["config"]
    gd = model_actions.graph_dict(cfg, 2 ** 31 + 5)
    assert sorted(gd["subgraphs"]) == ["carryRight", "pickRight",
                                       "placeRight", "walk"]
    assert gd["transitions"]["walk_endRightStance"] == [
        "pickRight_reach", "carryRight_locomotion", "placeRight_reach"]
    assert gd["transitions"]["pickRight_reach"] == ["carryRight_locomotion"]
    assert gd["transitions"]["carryRight_locomotion"] == ["placeRight_reach"]
    pick = gd["subgraphs"]["pickRight"]["nodes"]["reach"]["mm"]
    assert pick["keyframes"]["start_contact"] == 126 // 2
    assert pick["n_dim_spatial"] == 79 and pick["n_basis_spatial"] == 16
    assert model_actions.bvh(cfg).count("JOINT") + 1 == 19


def _snapshot(requests):
    """requests: [(profiled, [(stage, host ns, counts)], root ns)] in the
    order they ran; each root 1 s after the last."""
    spans, roots = [], []
    for i, (profiled, stages, root_ns) in enumerate(requests):
        rid, start = 100 * (i + 1), 1_000_000_000 * (i + 1)
        t = start + 10
        for j, (name, ns, counts) in enumerate(stages):
            spans.append([rid + j + 1, name, t, t + ns, rid, rid, counts])
            t += ns + 10
        spans.append([rid, "serve.request", start, start + root_ns, None,
                      rid, None])
        roots.append(dict(id=rid, name="serve.request", start_ns=start,
                          end_ns=start + root_ns, profiled=profiled,
                          armed=profiled, method="POST",
                          path="/run_morphablegraphs"))
    return {"clock": "time.time_ns", "capacity": 64, "dropped": 0,
            "fields": ["id", "name", "start_ns", "end_ns", "parent", "root",
                       "counts"],
            "spans": spans, "roots": roots, "counters": {}, "syncs": []}


MS = 1_000_000


def _request(profiled, steps, lm, plan, edge, ik=None, syncs=None):
    """A request of len(lm) steps: its `generate` (counting the steps),
    a plan and an LM span a step, an IK span (ms, targets) where given,
    and `edge` ms of the root outside `generate`."""
    stages = [("generate", 1000 * MS, {"request.steps": steps})]
    for p, m in zip(plan, lm):
        stages += [("request.plan", p * MS, None),
                   ("request.lm", m * MS,
                    None if syncs is None else {"cuda.syncs": syncs})]
    if ik is not None:
        stages.append(("request.ik", ik[0] * MS,
                       {"request.ik.constraints": ik[1]}))
    return profiled, stages, 1000 * MS + edge * MS


# two warm-up requests, three of the window (one without keyframes), two
# traced
SNAP = _snapshot([
    _request(False, 2, [800, 800], [9, 9], 900, ik=(500, 1)),
    _request(False, 2, [800, 800], [9, 9], 900),
    _request(False, 2, [100, 120], [1, 1], 10),
    _request(False, 2, [130, 90], [3, 4], 30, ik=(20, 2)),
    _request(False, 2, [150, 140], [2, 2], 40, ik=(40, 1)),
    _request(True, 4, [4000], [1], 200, syncs=7),
    _request(True, 6, [4000], [1], 200, syncs=5)])
SHAPES = {"service": {"warm": 2},
          "request": dict(frames=10, n=1, lm_iters=0, ik_iters=1, k=1,
                          l_dim=1, n_comp=1, nb=1, d=7, joints=1, t=2,
                          g1=2)}
RECORD = {"program": SNAP, "walks": 2, "shapes": SHAPES,
          "wall_per_walk_s": 0.5, "frames": 4000.0, "window": [900, 1900],
          "kernels": [["k", 1000, 100, 11, 0], ["k", 1200, 300, 12, 0]],
          "launches": {}, "ranges": []}


@pytest.mark.parametrize("metric,value", [
    # the median of the window's six steps: 90, 100, 120, 130, 140, 150
    ("request_lm_host_ms.service", 125.0),
    ("request_plan_host_ms.service", 2.0),  # of 1, 1, 2, 2, 3, 4
    ("request_ik_host_ms.service", 25.0),  # of 20 / 2 and 40 / 1 targets
    ("service_edge_ms.service", 15.0),  # of 10 / 2, 30 / 2, 40 / 2
    ("host_syncs_per_step.service", (7 + 5) / (4 + 6)),
    ("device_idle.service", 100.0 * (1 - 400 / 1000)),
    ("launches_per_kframe.service", 2 / 4.0),
    # 2 steps and 1 IK target a request of the window
    ("request_mfu.service", 100.0 * 6495 / (0.5 * 67e12))])
def test_reader_on_a_recorded_request_trace(metric, value):
    assert harness.reader(metric)(dict(RECORD)) == pytest.approx(value,
                                                                 rel=1e-9)


def test_readers_find_nothing_to_read():
    empty = {"program": None, "walks": 2, "shapes": SHAPES,
             "window": [0, 1], "kernels": [], "launches": {}, "ranges": [],
             "frames": 0.0}
    for metric in METRICS:
        assert harness.reader(metric)(dict(empty)) is None, metric
    # only warm-up requests and traced ones: no window request to read
    warm_only = dict(RECORD, program=_snapshot([
        _request(False, 1, [1], [1], 1, ik=(1, 1)),
        _request(False, 1, [1], [1], 1),
        _request(True, 1, [1], [1], 1, syncs=1)]))
    for metric in ("request_lm_host_ms.service",
                   "request_plan_host_ms.service",
                   "request_ik_host_ms.service", "service_edge_ms.service",
                   "request_mfu.service"):
        assert harness.reader(metric)(dict(warm_only)) is None, metric
    # a program whose requests count no step: nothing to read per step
    uncounted = dict(RECORD, program=_snapshot([
        _request(False, 0, [1], [1], 1), _request(False, 0, [1], [1], 1),
        _request(False, 0, [1], [1], 1), _request(True, 0, [1], [1], 1,
                                                  syncs=1)]))
    for metric in ("service_edge_ms.service", "host_syncs_per_step.service",
                   "request_mfu.service"):
        assert harness.reader(metric)(dict(uncounted)) is None, metric


def test_request_counts_against_hand_worked_values():
    # a path step of one candidate, one latent, one basis, 7 channels, one
    # joint, a table of 2 rows: an evaluation is 2*7 (coefficients) +
    # 2*18*7 (18 rows) + 18*60 (FK) + 16*2*8 (searches) = 1602; the step 3
    # (the draw) + 1602 (scoring) + 1602 (the refined error) + 254 (the
    # clip: 14 + 2*(30 + 56) + 40 + 2*2*7) + 16 (the arc) = 3477; a
    # keyframe step's evaluation 14 + 14 + 60 = 88, its step 3 + 88 + 88 +
    # 254 = 433; the conversion 10*8*7 + 2*14 = 588; one IK target of one
    # iteration 4*60 + 2*3*9 + 27 // 3 + 121*2*7 = 1997
    shape = dict(SHAPES["request"], steps=2, ik=1)
    assert request.flops(**shape) == 3477 + 433 + 588 + 1997
    # an LM iteration of the path step: 2*1602 (jacobian) + 36 + 36
    # (JtJ, Jtr) + 0 + 2 (the solve) + 1602 (the probe) + 2*6 (mixture)
    one = request.flops(**dict(shape, lm_iters=1))
    assert one - request.flops(**shape) == 4892 + (
        2 * 88 + 2 + 2 + 0 + 2 + 88 + 12)


def test_small_run_is_correct_and_loads_no_jax(tmp_path):
    """The cell at a small size through the harness on the CPU, traced:
    correct, every program reader non-null, and no JAX loaded."""
    code = f"""
import json, sys
sys.path.insert(0, {str(helpers.ROOT)!r})
import torch
torch.set_num_threads(2)
from portbench import harness
bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
spec = harness.cell_spec(bench, {CELL!r})
spec["config"] = dict(spec["config"], **{SMALL!r})
spec["traffic"] = dict(spec["traffic"], **{FAST!r})
from portbench.reference import requests as rq


def smaller(driver):  # the service's sizes on the driver and its context
    driver.ctx.configure({SIZES!r})
    driver.settings = rq.Settings(**{SIZES!r})


res = harness.run({CELL!r}, 3000000008, 0.5, True, "cpu", bench, spec,
                  driver_hook=smaller)
loaded = sorted({{n.split('.')[0] for n in sys.modules}})
print(json.dumps(dict(correct=res["correct"], metrics=res["metrics"],
                      checks=res["checks"], loaded=loaded)))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert "morphablegraphs_tpu_torch" in res["loaded"]
    assert not set(res["loaded"]) & set(harness.FORBIDDEN)
    # on the CPU the device trace holds no kernel: those readers are None
    assert set(res["metrics"]) >= {"request_lm_host_ms.service",
                                   "request_plan_host_ms.service",
                                   "service_edge_ms.service",
                                   "host_syncs_per_step.service",
                                   "request_mfu.service"}


@pytest.mark.cuda
def test_cell_runs_on_the_card_and_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         "4000000007", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=helpers.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["metrics"]["frames_per_s.crowd"]["value"] > 0
