"""The entry points over every visible card, held against one process
(parallel/group.py, `cli serve --nproc N`, `cli train --nproc N`).  They
need two cards or more and skip otherwise.  This file imports no JAX, so
it runs on a GPU machine without it:

    python -m pytest --noconftest -o addopts="" -s tests/test_torch_cards.py

N is every visible card: NCCL, a card per rank.  The inputs are the
reference-scale walk graph and N_CLIPS seeded clips of its leftStance
primitive.  Each check prints its numbers on a line of its own:

- the draws: a `torch.Generator` seeded alike gives the serving crowd's
  draws (8 characters, 128 candidates, 12 steps) bit for bit on every
  card, so every rank of a batch draws what one process draws;
- the service: `cli serve ZIP --nproc N` and `--nproc 1` side by side,
  each answering the serving cell's 8 trajectory requests REPS + 1 times
  (the first warms); the N-rank answers within 1e-5 of one rank's after
  the BVH round trip; the wall seconds of each call and the ranks' line
  of the last batch (seconds, launches); a stop ends the N ranks with
  exit code 0;
- training: `cli train CLIPS --nproc N` and `--nproc 1`, each writing
  one model file; the models within 1e-5 of each other relative to each
  field's scale (every field but the covariances' eigh factors, which
  follow from the covariances), and the wall seconds of both.
"""

import json
import subprocess
import time

import numpy as np
import pytest
import torch

from test_torch_launch import (CLI, PROC_TIMEOUT, ROOT, _assert_same_answer,
                               _graph_zip, _model_arrays, _Server,
                               _traj_request)

pytestmark = pytest.mark.cuda

MODEL_ATOL = 1e-5  # relative to each field's scale
N_CLIPS = 20
REPS = 3  # timed batches after the one that warms
# the serving batch's 8 trajectory requests (the batch endpoint's crowd)
TRAJECTORIES = [(20, 100), (-20, 100), (0, 120), (40, 90), (-40, 90),
                (10, 140), (-10, 60), (30, 150)]


@pytest.fixture(scope="module")
def cards():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs two CUDA devices or more")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"\n{n} cards: {smi}", flush=True)
    return n


@pytest.fixture(scope="module")
def inputs(cards, tmp_path_factory):
    """The reference-scale walk graph's zip and N_CLIPS BVH clips of its
    leftStance primitive (seeded draws on their own time warps, unit
    joint quaternions) -> (zip path, clip folder)."""
    from morphablegraphs_tpu_torch.models import primitive as prim_mod
    from morphablegraphs_tpu_torch.models import skeleton as sk
    from morphablegraphs_tpu_torch.utils import synthetic
    tmp = tmp_path_factory.mktemp("cards")
    gd = synthetic.make_reference_scale_graph_dict()
    zip_path = _graph_zip(str(tmp / "walk.zip"), gd, synthetic.REF_BVH)
    skel = sk.load_bvh(synthetic.REF_BVH)[0]
    prim = prim_mod.load_primitive_json(
        gd["subgraphs"]["walk"]["nodes"]["leftStance"]["mm"], device="cuda:0")
    lat = prim_mod.sample_latent(
        torch.Generator(device="cuda:0").manual_seed(17), prim, N_CLIPS)
    clips = tmp / "clips"
    clips.mkdir()
    for i in range(N_CLIPS):
        f, n, _ = prim_mod.back_project(prim, lat[i], 2 * 192, use_time=True)
        f = f[: int(n)].cpu().numpy().astype(np.float64)
        q = f[:, 3:].reshape(len(f), -1, 4)
        f[:, 3:] = (q / np.linalg.norm(q, axis=-1, keepdims=True)).reshape(
            len(f), -1)
        sk.write_bvh(skel, f, str(clips / f"clip{i:03d}.bvh"))
    return zip_path, str(clips)


def test_draws_identical_on_every_card(cards):
    from morphablegraphs_tpu_torch.models.graph import (build_graph_from_dict,
                                                        stack_graph)
    from morphablegraphs_tpu_torch.synthesis import walk as walk_mod
    from morphablegraphs_tpu_torch.utils import synthetic
    graph = build_graph_from_dict(synthetic.make_reference_scale_graph_dict())
    draws = []
    for i in range(cards):
        dev = torch.device("cuda", i)
        gen = torch.Generator(device=dev).manual_seed(0)
        draw = walk_mod.torch_sampler(gen, stack_graph(graph, device=dev),
                                      len(TRAJECTORIES), 128)
        draws.append([[x.cpu() for x in vars(draw(t)).values()]
                      for t in range(12)])
    for i, d in enumerate(draws[1:], 1):
        for t, (a, b) in enumerate(zip(draws[0], d)):
            assert all(torch.equal(x, y) for x, y in zip(a, b)), (i, t)
    print(f"draws: the serving crowd's draws from one seed are identical "
          f"on {cards} cards", flush=True)


def test_service_over_every_card_equals_one_rank(cards, inputs):
    zip_path, _ = inputs
    body = {"requests": [_traj_request(x, z) for x, z in TRAJECTORIES]}
    servers = {n: _Server(zip_path, nproc=n, device="cuda")
               for n in (cards, 1)}
    walls, answers, codes = {}, {}, {}
    try:
        for n, s in servers.items():
            t0 = time.monotonic()
            s.wait_up()
            walls[n] = [round(time.monotonic() - t0, 3)]
        for n, s in servers.items():
            for _ in range(REPS + 1):
                t0 = time.perf_counter()
                answers[n] = s.call("/run_morphablegraphs_batch", body)
                walls[n].append(round(time.perf_counter() - t0, 4))
                assert answers[n][0] == 200, answers[n][1][:300]
        s, ranks_lines = servers[cards], []
        while len(ranks_lines) < REPS + 1:  # the ranks' line of each batch
            line = s._next()
            if line.startswith(f"batch of {len(TRAJECTORIES)} over {cards} "
                               "ranks"):
                ranks_lines.append(line.strip())
        ranks_line = ranks_lines[-1]
        layout = next(x.strip() for x in s.seen if " ranks over " in x)
    finally:
        for n, s in servers.items():
            t0 = time.perf_counter()
            codes[n] = (s.stop(), round(time.perf_counter() - t0, 3))
    print(f"service: `cli serve --nproc {cards}` ({layout}) waited for "
          f"{walls[cards][0]} s, `--nproc 1` {walls[1][0]} s more (started "
          f"together); the batch of {len(TRAJECTORIES)} (the first warms) "
          f"{walls[cards][1:]} s over {cards} ranks, {walls[1][1:]} s on "
          f"one; {ranks_line}; (exit code, seconds) of the stops {codes}",
          flush=True)
    assert "nccl" in layout
    _assert_same_answer(answers[cards], answers[1])
    assert codes[cards][0] == 0 and codes[1][0] in (0, -15)


def test_training_over_every_card_equals_one_rank(cards, inputs, tmp_path):
    _, clips = inputs
    walls, models = {}, {}
    for n in (cards, 1):
        out = tmp_path / f"train{n}"
        out.mkdir()
        t0 = time.perf_counter()
        run = subprocess.run(
            CLI + ["train", clips, "walk_leftStance", "--output",
                   str(out / "walk_mm.json"), "--nproc", str(n)],
            cwd=ROOT, capture_output=True, text=True, timeout=PROC_TIMEOUT)
        walls[n] = round(time.perf_counter() - t0, 3)
        assert run.returncode == 0, (run.stdout + run.stderr)[-2000:]
        assert sorted(p.name for p in out.iterdir()) == [
            "walk_mm.json", "walk_sample.bvh"]
        with open(out / "walk_mm.json") as f:
            models[n] = _model_arrays(json.load(f))
    assert models[cards].keys() == models[1].keys()
    gaps = {k: float(np.abs(a - models[1][k]).max(initial=0.0)
                     / max(1.0, np.abs(models[1][k]).max(initial=0.0)))
            for k, a in models[cards].items() if k != "gmm.eigen"}
    worst = max(gaps.values())
    print(f"train: `cli train --nproc {cards}` on {N_CLIPS} clips "
          f"{walls[cards]} s, `--nproc 1` {walls[1]} s (each a fresh "
          f"process); the models within {worst:.2e} (tol {MODEL_ATOL}, "
          f"relative to each field's scale; "
          f"{sum(v == 0.0 for v in gaps.values())} of {len(gaps)} fields "
          "equal)", flush=True)
    assert worst <= MODEL_ATOL, {k: v for k, v in gaps.items() if v > 0}
