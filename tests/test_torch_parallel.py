"""The port's crowds and DTW over a torch.distributed process group, on the
CPU: four gloo processes (a FileStore under tmp_path, no socket to set
up) run `constrained_crowd_sharded` on C = 8 and on C = 6 (which pads to
8), `crowd_walk_sharded` and `find_optimal_dtw` (the pair grids split
over the ranks), and each is held against the same call in one process:
frames within 1e-5, node ids, frame counts, errors and warp paths
identical.  Every rank must hold the whole gathered crowd.  The random
walk's draws are the JAX package's, so the group's crowd is also held
against JAX's crowd_walk_sharded on its 8 virtual devices, at the random
walk tests' bounds (tests/test_torch_random_walk.py).

The spawned ranks import this module: its top level imports torch and
the port only (JAX is imported inside the tests)."""

import datetime
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

torch.set_num_threads(1)

from morphablegraphs_tpu_torch.construct import dtw as dtwt  # noqa: E402
from morphablegraphs_tpu_torch.ops import spline_path as spt  # noqa: E402
from morphablegraphs_tpu_torch.parallel import crowd as pct  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import constrained_walk as cwt  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import walk as wt  # noqa: E402
from morphablegraphs_tpu_torch.utils import profiling  # noqa: E402

WORLD = 4
N_STEPS = 3
MAX_FRAMES = 64
FRAMES_ATOL = 1e-5  # a rank's rows against the same rows of one process
JAX_FRAMES_ATOL = 1e-3  # tests/test_torch_random_walk.py's bound
CROWD_CFG = dict(max_step_frames=MAX_FRAMES, lm_iters=1)
DTW_LENGTHS = (18, 23, 20, 27, 21, 25)


def _paths(n: int, seed: int) -> spt.PathSpline:
    """n random 4-point walking paths of 60 cm segments."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pts, x, z, h = [[0.0, 0.0, 0.0]], 0.0, 0.0, rng.uniform(-0.6, 0.6)
        for _ in range(3):
            h += rng.uniform(-0.4, 0.4)
            x, z = x + 60.0 * np.sin(h), z + 60.0 * np.cos(h)
            pts.append([x, 0.0, z])
        out.append(spt.build(np.asarray(pts, np.float32),
                             unconstrained_dims=(1,), device="cpu"))
    return spt.stack_paths(out)


def _clouds() -> dict:
    rng = np.random.default_rng(3)
    base = rng.standard_normal((30, 4, 3)).astype(np.float32) * 10.0
    return {f"clip{i}": base[:n] + rng.standard_normal((n, 4, 3)).astype(
        np.float32) for i, n in enumerate(DTW_LENGTHS)}


def _run_all(inputs: dict, group=None) -> dict:
    """Every case of the module through the port's entry points."""
    st, skel = inputs["stacked"], inputs["skel"]
    out = {}
    for c in (8, 6):
        draws = inputs[f"crowd_draws_{c}"]
        out[f"crowd_{c}"] = pct.constrained_crowd_sharded(
            ["cpu"], skel, st, inputs[f"paths_{c}"],
            torch.full((c,), inputs["start"]), N_STEPS, draws.__getitem__,
            cfg=cwt.WalkConfig(**CROWD_CFG), group=group)
    out["random"] = pct.crowd_walk_sharded(
        ["cpu"], st, inputs["start"], 8, inputs["random_draws"].__getitem__,
        n_steps=N_STEPS, max_step_frames=MAX_FRAMES, group=group)
    out["dtw"] = dtwt.find_optimal_dtw(inputs["clouds"], device="cpu",
                                       group=group)
    out["dtw_mean"] = dtwt.find_optimal_dtw(inputs["clouds"], "clip2",
                                            device="cpu", group=group)
    return out


def _rank_main(rank: int, tmp: str):
    torch.set_num_threads(1)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    # a rank that dies fails the others' collectives in seconds, not in
    # gloo's default half hour
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), WORLD),
        rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=120))
    try:
        inputs = torch.load(os.path.join(tmp, "inputs.pt"),
                            weights_only=False)
        profiling.reset()
        out = _run_all(inputs, dist.group.WORLD)
        # the crowds' output gathers, one span a call
        out["gather_spans"] = sum(s[1] == "crowd.gather" for s in
                                  profiling.snapshot()["spans"])
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the inputs, the one-process outputs, each rank's outputs)."""
    import jax

    import torch_parity as tp
    tmp = str(tmp_path_factory.mktemp("group"))
    _, st_j, skel, st = tp.model("toy")
    start = st_j.node_id(("walk", "beginLeftStance"))
    k, ldim = st.gmm_weights.shape[-1], st.gmm_means.shape[-1]
    keys = jax.random.split(jax.random.PRNGKey(7), 8)
    random_draws = tp.port_random_draws(tp.jax_random_walk_draws(
        keys, N_STEPS, k, ldim, st.n_nodes))
    inputs = dict(stacked=st, skel=skel, start=start, clouds=_clouds(),
                  random_draws=[random_draws(t) for t in range(N_STEPS)])
    for c in (8, 6):
        gen = torch.Generator().manual_seed(c)
        draw = wt.torch_sampler(gen, st, c, 128)
        inputs[f"crowd_draws_{c}"] = [draw(t) for t in range(N_STEPS)]
        inputs[f"paths_{c}"] = _paths(c, seed=c)
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    mp.start_processes(_rank_main, args=(tmp,), nprocs=WORLD, join=True,
                       start_method="spawn")
    ranks = [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return inputs, _run_all(inputs), ranks


def _assert_crowd(one, group):
    """Frames (the first output) within FRAMES_ATOL, the rest identical."""
    assert len(one) == len(group)
    torch.testing.assert_close(group[0], one[0], rtol=0.0, atol=FRAMES_ATOL)
    for i, (a, b) in enumerate(zip(one[1:], group[1:]), 1):
        assert a.dtype == b.dtype and torch.equal(a, b), f"output {i}"


@pytest.mark.parametrize("c", [8, 6])
def test_constrained_crowd_over_four_ranks_matches_one_process(runs, c):
    """C = 8 splits 2/2/2/2; C = 6 pads to 8 by repeating the first
    character and slices the padding off: segments within 1e-5, frame
    counts, node ids and errors identical, on every rank."""
    _, one, ranks = runs
    segs, n_frames, ids, errs = one[f"crowd_{c}"]
    assert segs.shape[0] == c and bool(torch.isfinite(segs).all())
    for r in ranks:
        _assert_crowd(one[f"crowd_{c}"], r[f"crowd_{c}"])


def test_random_crowd_over_four_ranks_matches_one_process_and_jax(runs):
    """The random-walk crowd split 2/2/2/2 equals the one-process crowd,
    and both equal JAX's crowd_walk_sharded over its 8 virtual devices on
    the same keys (node ids and frame counts exactly, valid frames within
    the random walk tests' bound)."""
    import jax

    from morphablegraphs_tpu import parallel as pj
    inputs, one, ranks = runs
    for r in ranks:
        _assert_crowd(one["random"], r["random"])
    import torch_parity as tp
    _, st_j, _, _ = tp.model("toy")
    buf, nv, ids, _ = pj.crowd_walk_sharded(
        pj.make_mesh(8), st_j, jax.random.PRNGKey(7), inputs["start"],
        n_chars=8, n_steps=N_STEPS, max_step_frames=MAX_FRAMES)
    b_t, nv_t, ids_t, _ = ranks[0]["random"]
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids))
    np.testing.assert_array_equal(nv_t.numpy(), np.asarray(nv))
    buf = np.asarray(buf)
    for c, n in enumerate(np.asarray(nv)):
        np.testing.assert_allclose(b_t[c, :n].numpy(), buf[c, :n],
                                   atol=JAX_FRAMES_ATOL)


def test_crowd_gathers_are_spanned_on_every_rank(runs):
    """Each rank records one `crowd.gather` span per sharded crowd call
    (two constrained crowds and one random one)."""
    _, _, ranks = runs
    assert [r["gather_spans"] for r in ranks] == [3] * WORLD


@pytest.mark.parametrize("case", ["dtw", "dtw_mean"])
def test_dtw_over_four_ranks_matches_one_process(runs, case):
    """36 pairs (every reference tried) and 6 pairs (one reference), split
    over four ranks (6 pairs: padded to 8): the same warping paths on every
    rank as in one process."""
    _, one, ranks = runs
    assert set(one[case]) == set(_clouds())
    for r in ranks:
        assert r[case] == one[case]
