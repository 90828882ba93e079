"""Small cells for the CPU tests: each cell of BENCHMARK.json with fewer
characters, steps and walks, run through the harness on the CPU."""

from __future__ import annotations

import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

CELLS = ("ref_walk.crowd_root", "ref_walk.random_segments")
TINY = {"ref_walk.crowd_root": dict(characters=4, steps=5, judged=4,
                                    traced_walks=1),
        "ref_walk.random_segments": dict(characters=8, steps=8, judged=8,
                                         traced_walks=1)}


def bench() -> dict:
    return harness.load_json(ROOT / "BENCHMARK.json")


def tiny_spec(cell: str) -> dict:
    spec = harness.cell_spec(bench(), cell)
    spec["traffic"] = dict(spec["traffic"], **TINY[cell])
    return spec


def run_tiny(cell: str, seed: int, hook=None, traced: bool = False,
             traffic=None):
    """One run of a small cell on the CPU; traffic overrides its small
    traffic numbers."""
    torch.set_num_threads(2)
    spec = tiny_spec(cell)
    spec["traffic"] = dict(spec["traffic"], **(traffic or {}))
    return harness.run(cell, seed, 0.05, traced, "cpu", bench(), spec,
                       driver_hook=hook)


def readings(cell: str, seed: int, device, traffic=None, control=False):
    """The numbers compared for one walk of a cell: of the program, or
    with control=True of the reference put in its place in TF32, the
    precision below the configuration's float32 with TF32 off: float32
    with every matrix product's operands rounded to TF32
    (`ops.tf32_round`), and TF32 allowed to cuBLAS.  traffic overrides the
    cell's traffic numbers."""
    import importlib
    spec = harness.cell_spec(bench(), cell)
    tr = dict(spec["traffic"], **(traffic or {}))
    module = importlib.import_module(f"portbench.drivers.{tr['driver']}")
    driver = module.Driver(spec["config"], tr, seed, device)
    try:
        if not control:
            driver.walk(0, keep=True)
            return driver.judge(driver.kept, device)
        draws = driver.draws(0)
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            from portbench.reference import ops
            frames, n_frames, ids, latents = driver.reference_walk(
                draws, torch.float32, device, ops.tf32_round)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
        idx = driver.judged_rows()
        from portbench import generate
        kept = (frames[idx], n_frames[idx], ids[idx],
                None if latents is None else latents[idx],
                generate.rows(draws, idx))
        return driver.judge(kept, device)
    finally:
        driver.close()
