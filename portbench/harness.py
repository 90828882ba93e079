"""One run of one cell: set-up, warm-up, the measured window, the traced
walks, the comparison that decides `correct`, and the result line.

Everything a cell needs is found by name: its configuration
(`configs/<config>.json`), its traffic (`traffic/<traffic>.json`, whose
`driver` names a module of `drivers/`), the limits of its comparison
(`limits/<cell>.json`) and its per-layer metrics (`metrics/<metric>.py`,
each a `read(record)`; a metric split by cell, `<stem>.<part>`, reads
`metrics/<stem>.py` unless it has a file of its own)."""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import pathlib
import sys
import time

import torch

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "morphablegraphs_tpu")
JUDGED_AMONG = 4


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(bench: dict, name: str) -> dict:
    """The cell, its configuration, traffic, limits and metrics by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; the benchmark has "
                         f"{sorted(cells)}")
    cell = cells[name]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    reports = [m for m in bench["end_to_end"]
               if name in m.get("workloads", [name])]
    moved = {m["name"] for m in reports}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in moved
                                  else [])]
    limits = HERE / "limits" / f"{name}.json"
    if not limits.exists():
        raise FileNotFoundError(f"no limits file for workload {name}: "
                                f"{limits}")
    return {"cell": cell,
            "config": load_json(ROOT / config["file"]),
            "traffic": load_json(HERE / "traffic" /
                                 f"{cell['traffic']}.json"),
            "limits": load_json(limits),
            "end_to_end": reports, "per_layer": per_layer}


def reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _trace(driver, spec, first_walk: int, device) -> dict:
    """The traced walks under torch.profiler -> their record."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from . import trace
    n = spec["traffic"]["traced_walks"]
    b1_inputs = []
    capture = getattr(driver, "selection_inputs", None)
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            record_function(trace.WINDOW), \
            (capture(b1_inputs) if capture else contextlib.nullcontext()):
        frames = 0
        for i in range(n):
            frames = frames + driver.walk(first_walk + i, keep=False)
        _sync(device)
    rec = trace.record(prof)
    rec.update(walks=n, frames=float(frames))
    if b1_inputs:
        from .counts import b1
        g8 = driver.shapes()["b1_table_rows"]
        rec["b1"] = [[a.shape[0], a.shape[1], a.shape[2], g8, c.shape[1],
                      b1.rows_read(mop, a, t, c)]
                     for mop, a, t, c in b1_inputs]
    return rec


def run(cell: str, seed: int, seconds: float, traced: bool, device="cuda",
        bench: dict | None = None, spec: dict | None = None,
        driver_hook=None, t_start: float | None = None) -> dict:
    """One run -> {correct, attempted, failed, metrics, device, checks,
    notes, (breakdown)}.  driver_hook(driver), where given, runs after
    set-up (the tests break the program through it); t_start, the
    perf_counter reading set-up counts from (default: now)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    spec = spec or cell_spec(bench, cell)
    tr = spec["traffic"]
    module = importlib.import_module(f"portbench.drivers.{tr['driver']}")
    t_driver = time.perf_counter()
    driver = module.Driver(spec["config"], tr, seed, device)
    t_warm = time.perf_counter()
    if driver_hook is not None:
        driver_hook(driver)
    # the judged walk, drawn from the seed before the window among its
    # first walks; its rows alone are kept, and the window runs until it
    # has been walked
    pick = int(torch.randint(JUDGED_AMONG, (1,),
                             generator=torch.Generator().manual_seed(
                                 seed % 2 ** 63)))
    try:
        for i in range(tr["warm_walks"]):  # every shape the window uses
            driver.walk(-1 - i, keep=False)
        _sync(device)
        setup_s = time.perf_counter() - t_start
        setup_parts = dict(before_driver=t_driver - t_start,
                           driver=t_warm - t_driver,
                           warm_walks=t_start + setup_s - t_warm)
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)

        frames, walks, ends = 0, 0, []
        t0 = time.perf_counter()
        while True:
            frames = frames + driver.walk(walks, keep=walks == pick)
            walks += 1
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds and walks > pick:
                break
        _sync(device)
        window_s = time.perf_counter() - t0
        frames = float(frames)
        peak = (torch.cuda.max_memory_allocated(device)
                if torch.device(device).type == "cuda" else 0)

        rec = _trace(driver, spec, walks, device) if traced else None
        kept, driver.kept = driver.kept, None
        found = forbidden_modules()
        t_judge = time.perf_counter()
        numbers = driver.judge(kept, device)
        judge_s = time.perf_counter() - t_judge
    finally:
        driver.close()
    limits = spec["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values()) and not found
    result = {"correct": correct, "attempted": walks, "failed": 0}
    if traced:
        from . import trace
        rec["wall_per_walk_s"] = window_s / walks
        rec["shapes"] = driver.shapes()
        metrics = {}
        for m in spec["per_layer"]:
            value = reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        lo, hi = rec["window"]
        busy = trace.busy_ns(rec) / 1e9
        result["metrics"] = metrics
        result["device"] = dict(busy_s=busy, window_s=(hi - lo) / 1e9)
        result["breakdown"] = trace.breakdown(rec)
        placed = trace.placement(rec)
    else:
        values = dict(driver.end_to_end(frames, window_s), setup_s=setup_s)
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in spec["end_to_end"]}
        result["device"] = {}
    result["device"].update(memory_peak_bytes=peak)
    if traced:
        numbers = dict(numbers, kernels_by_range=placed)
    result["notes"] = dict(numbers, walks=walks, window_s=window_s,
                           walk_ends_s=[round(t, 4) for t in ends],
                           frames=frames, judged_walk=pick,
                           setup_s=setup_s, setup_parts_s=setup_parts,
                           judge_s=judge_s,
                           forbidden_modules=found)
    result["checks"] = checks
    return result
