"""The port's cached device constants (`ops.consts.constant`,
`models.skeleton.device_tables`) and the CPU side of the walk.lm graphs
(`ops.cuda_graphs`): the helpers that read a cached constant give the
values a fresh tensor gave, each constant is one tensor per (device,
dtype), and on the CPU the LM stage always runs eagerly.  No JAX; the card
side is `test_torch_lm_graph.py`."""

import dataclasses
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu_torch.constraints import compiled  # noqa: E402
from morphablegraphs_tpu_torch.models import graph as graph_mod  # noqa: E402
from morphablegraphs_tpu_torch.models import skeleton as sk  # noqa: E402
from morphablegraphs_tpu_torch.ops import align, consts, cuda_graphs  # noqa: E402
from morphablegraphs_tpu_torch.ops import spline_path  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import constrained_walk as cw  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import walk  # noqa: E402
from morphablegraphs_tpu_torch.utils import profiling, synthetic  # noqa: E402

CPU = torch.device("cpu")


def _fresh_constant(values, dtype, device):
    """What the helpers made at every call before the cache."""
    return torch.tensor(values, dtype=dtype, device=device)


@pytest.fixture
def uncached(monkeypatch):
    """Within: every helper builds its constants anew at each call."""
    def bypass():
        tables = sk.device_tables.__wrapped__
        for mod in (align, spline_path, compiled, cw):
            monkeypatch.setattr(mod, "constant", _fresh_constant)
        for mod in (sk, compiled):
            monkeypatch.setattr(mod, "device_tables", tables)
    return bypass


def _skeleton():
    return sk.load_bvh(synthetic.TEST_BVH)[0]


def _quats(gen, shape, dtype):
    return torch.randn(shape + (4,), generator=gen, dtype=dtype)


def _path():
    pts = np.array([[0.0, 0, 0], [40.0, 0, 30.0], [90.0, 0, 40.0],
                    [140.0, 0, 20.0]], np.float32)
    return spline_path.build(pts, unconstrained_dims=(1,), granularity=64,
                             device="cpu")


def _call(name, dtype):
    """The helper `name` on seeded inputs of `dtype` -> its outputs."""
    gen = torch.Generator().manual_seed(5)
    skel = _skeleton()
    if name == "heading_angle":
        return (align.heading_angle(_quats(gen, (6,), dtype)),)
    if name == "node_aligning_2d_transform":
        d = skel.n_frame_params
        prev = torch.randn((6, d), generator=gen, dtype=dtype)
        new = torch.randn((6, d), generator=gen, dtype=dtype)
        return align.node_aligning_2d_transform(prev, new)
    if name == "compiled._forward":
        q = _quats(gen, (6,), dtype)
        return (compiled._dir_residual(_dir_fields(q), q),
                compiled._forward(q))
    if name in ("fk_root", "fk_global"):
        frames = torch.randn((3, 5, skel.n_frame_params), generator=gen,
                             dtype=dtype)
        return getattr(sk, name)(skel, frames)
    if name == "closest_points_advancing":
        sp = spline_path.map_leaves(
            spline_path.stack_paths([_path(), _path()]),
            lambda t: t.to(dtype) if t.is_floating_point() else t)
        pts = torch.rand((2, 16, 3), generator=gen, dtype=dtype) * 100.0
        return spline_path.closest_points_advancing(
            sp, pts, torch.tensor([0.0, 25.0], dtype=dtype))
    raise KeyError(name)


def _dir_fields(q):
    """The fields `_dir_residual` reads, for rows like q [..., 4]."""
    lead = q.shape[:-1]
    return types.SimpleNamespace(
        dir_active=torch.ones(lead, dtype=q.dtype),
        dir_weight=torch.full(lead, 0.8, dtype=q.dtype),
        dir_target=torch.nn.functional.normalize(
            torch.ones(lead + (2,), dtype=q.dtype), dim=-1))


HELPERS = ("heading_angle", "node_aligning_2d_transform",
           "compiled._forward", "fk_root", "fk_global",
           "closest_points_advancing")
# the path splines evaluate in float32 alone (their Catmull-Rom basis is a
# float32 table)
CASES = [(name, dtype) for name in HELPERS
         for dtype in (torch.float32, torch.float64)
         if dtype == torch.float32 or name != "closest_points_advancing"]


@pytest.mark.parametrize("name,dtype", CASES)
def test_cached_constants_give_the_values_of_fresh_ones(name, dtype,
                                                         uncached):
    cached = _call(name, dtype)
    uncached()
    fresh = _call(name, dtype)
    assert len(cached) == len(fresh)
    for a, b in zip(cached, fresh):
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_each_constant_is_one_tensor_per_device_and_dtype(dtype):
    one = consts.constant(align.REF_VECTOR, dtype, CPU)
    assert consts.constant(align.REF_VECTOR, dtype, CPU) is one
    assert one.dtype == dtype and one.tolist() == list(align.REF_VECTOR)
    other = torch.float64 if dtype == torch.float32 else torch.float32
    assert consts.constant(align.REF_VECTOR, other, CPU) is not one
    skel = _skeleton()
    tables = sk.device_tables(skel, dtype, CPU)
    assert sk.device_tables(skel, dtype, CPU) is tables
    assert tables["offset0"].dtype == dtype
    np.testing.assert_array_equal(tables["offsets"].numpy(),
                                  skel.offsets.astype(np.float64))
    # the helpers add no constant after their first call
    names = [n for n, d in CASES if d == dtype]
    for name in names:
        _call(name, dtype)
    made = consts.constant.cache_info().currsize
    tables_made = sk.device_tables.cache_info().currsize
    for name in names:
        _call(name, dtype)
    assert consts.constant.cache_info().currsize == made
    assert sk.device_tables.cache_info().currsize == tables_made


def _crowd(n_chars=4, n_steps=2, lm_frozen=True):
    g = graph_mod.stack_graph(graph_mod.build_graph_from_dict(
        synthetic.make_graph_dict()), device="cpu")
    skel = _skeleton()
    paths = spline_path.stack_paths([_path() for _ in range(n_chars)])
    gen = torch.Generator().manual_seed(3)
    sampler = walk.torch_sampler(gen, g, n_chars, 128)
    draws = [sampler(t) for t in range(n_steps)]
    start = torch.full((n_chars,), g.node_id(("walk", "beginLeftStance")))
    cfg = cw.WalkConfig(max_step_frames=64, lm_iters=2, lm_threshold=0.0,
                        lm_frozen=lm_frozen)
    return skel, g, paths, start, draws, cfg


@pytest.mark.parametrize("lm_frozen", [True, False])
def test_the_lm_stage_runs_eagerly_on_the_cpu(lm_frozen):
    """On the CPU walk.lm never captures a graph: every step's stage runs
    eagerly and counts walk.lm.eager, the closed frozen form and the exact
    LM alike."""
    skel, g, paths, start, draws, cfg = _crowd(lm_frozen=lm_frozen)
    assert cw._lm_graph_key(skel, g, start, cfg, True) is None
    before = profiling.counters()
    _, _, _, errors = cw.constrained_walk_full_crowd(
        skel, g, paths, start, len(draws), draws=lambda t: draws[t], cfg=cfg)
    after = profiling.counters()

    def added(name):
        return after.get(name, 0) - before.get(name, 0)

    assert added("walk.lm.eager") == len(draws)
    assert added("walk.lm.graph_captures") == 0
    assert added("walk.lm.graph_replays") == 0
    assert bool(torch.isfinite(errors).all())


def test_stage_inputs_flatten_and_rebuild():
    """`cuda_graphs` sees a step's inputs (node, a StepConstraints with its
    trajectory spline, s, err) as their tensors in a fixed order and a
    layout that changes with any tensor's shape, strides or dtype and with
    every other leaf."""
    skel = _skeleton()
    sc = cw.step_constraints(cw.default_step_scs(skel, 1), 0, 3, CPU)
    sc = sc.replace(traj=spline_path.stack_paths([_path()] * 3))
    inputs = (torch.zeros(3, dtype=torch.long), sc, torch.zeros((3, 7)),
              torch.zeros(3))
    leaves = []
    layout = cuda_graphs._flatten(inputs, leaves)
    hash(layout)
    n_sc = sum(1 for f in dataclasses.fields(sc)
               if isinstance(getattr(sc, f.name), torch.Tensor))
    n_splines = 2 * len(dataclasses.fields(spline_path.PathSpline))
    assert len(leaves) == 3 + n_sc + n_splines
    copies = [cuda_graphs._buffer(t)[0] for t in leaves]
    rebuilt = cuda_graphs._rebuild(inputs, iter(copies))
    again = []
    assert cuda_graphs._flatten(rebuilt, again) == layout
    assert all(a is b for a, b in zip(again, copies))
    assert isinstance(rebuilt[1], compiled.StepConstraints)
    assert isinstance(rebuilt[1].traj, spline_path.PathSpline)
    for changed in ((inputs[0], sc, torch.zeros((3, 8)), inputs[3]),
                    (inputs[0], sc, torch.zeros((7, 3)).t(), inputs[3]),
                    (inputs[0], sc, inputs[2].double(), inputs[3]),
                    (inputs[0], sc.replace(traj=None), inputs[2],
                     inputs[3])):
        assert cuda_graphs._flatten(changed, []) != layout


def test_stage_buffers_keep_broadcast_dims():
    """A graph's input buffer has the input's shape and strides, a dim
    along which the input is a broadcast stays one (one copy of it is
    filled), and a copy into it gives the input's values."""
    row = torch.arange(12.0).reshape(3, 4)
    for t in (row, row.t(), row[None].expand(5, 3, 4), row[:, None, :2]
              .expand(3, 6, 2)):
        view, base, index = cuda_graphs._buffer(t)
        assert view.shape == t.shape and view.stride() == t.stride()
        assert base.numel() <= t.numel()
        base.copy_(t if index is None else t[index])
        assert torch.equal(view, t)
