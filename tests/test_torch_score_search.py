"""The search order of the selection kernels B1/B3 (csrc/score_loco.cu) is
exact: validity folded into the distance as NaN, a start at the first row
whose running maximum of valid arcs reaches the floor (a binary search), and
a second pass that stops at its first hit give the same bits as the twin's
two full masked passes (`kernels._table_search`), sample by sample and in
the summed error.  The kernel's precondition, arcs that never decrease over
the valid rows of `pack_path_table`, is checked on the tables the walks and
the serving path build."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu_torch.ops import kernels, spline_path  # noqa: E402

N_CAND = 128


def kernel_order_search(d2, t_arc, t_valid, min_arc):
    """The kernel's search on the twin's distances d2 [C, G8, N] -> what
    `kernels._table_search` returns."""
    c, g8, _ = d2.shape
    nan = torch.tensor(float("nan"))
    inf = torch.tensor(float("inf"))
    ok = (t_valid > 0) & (t_arc == t_arc)  # [C, G8, 1]
    d2n = torch.where(ok, d2, nan)
    # running maximum of the valid arcs, NaN before the first valid row
    key = torch.where(ok, t_arc, nan)[..., 0].clone()  # [C, G8]
    for r in range(1, g8):
        key[:, r] = torch.fmax(key[:, r - 1], key[:, r])
    lo_arc = min_arc - 1e-6  # [C, N]
    lo = torch.zeros(lo_arc.shape, dtype=torch.long)
    hi = torch.full(lo_arc.shape, g8, dtype=torch.long)
    while bool((lo < hi).any()):  # the kernel's binary search, per candidate
        active = lo < hi
        mid = (lo + hi) // 2
        right = torch.gather(key, 1, mid.clamp(max=g8 - 1)) >= lo_arc
        hi = torch.where(active & right, mid, hi)
        lo = torch.where(active & ~right, mid + 1, lo)
    from_start = torch.arange(g8)[None, :, None] >= lo[:, None, :]
    # pass 1: fminf over the rows from the start (NaN rows never win)
    dmin2 = torch.where(from_start & ~torch.isnan(d2n), d2n, inf).amin(1)
    # pass 2: the first row from the start within 1e-6 of the minimum
    hits = from_start & (d2n <= dmin2[:, None, :] + 1e-6)
    first = hits.int().argmax(1)
    arc_sel = torch.where(hits.any(1), torch.gather(key, 1, first), inf)
    return dmin2, arc_sel, (from_start & ok).to(d2.dtype)


def _path(rng, granularity):
    """A bench-style 4-point walking path (60 cm segments)."""
    pts = [[0.0, 0.0, 0.0]]
    x, z, h = 0.0, 0.0, rng.uniform(-0.6, 0.6)
    for _ in range(3):
        h += rng.uniform(-0.4, 0.4)
        x, z = x + 60 * np.sin(h), z + 60 * np.cos(h)
        pts.append([x, 0.0, z])
    return spline_path.build(np.asarray(pts, np.float32),
                             unconstrained_dims=(1,),
                             granularity=granularity)


def _case(granularity: int, kind: str, seed: int = 0):
    """Three characters' selection inputs with the twin's frames made
    directly: no previous step, a zero start pose, so the 16 trajectory
    rows are the sample positions themselves: points that advance along
    each path from its floor, with 3 cm of noise."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    c = 3
    sp = spline_path.stack_paths([_path(rng, granularity) for _ in range(c)])
    full = sp.table_arc[:, -1]
    travelled = torch.tensor(rng.uniform(0.0, 60.0, c), dtype=torch.float32)
    table = kernels.pack_path_table(sp, torch.zeros(3))
    if kind == "repeated_arcs":
        # a run of one repeated point under rising arcs (exact distance
        # ties: the first hit must have the smallest arc), and a run of
        # one repeated arc under distinct points (equal floors)
        g = table.shape[1]
        a, b = g // 3, g // 3 + 12
        table[:, a:b, :3] = table[:, a:a + 1, :3]
        table[:, b + 20: b + 40, 3] = table[:, b + 20: b + 21, 3]
    if kind == "past_end":
        travelled[0] = full[0] + 5.0  # the first sample has no row left
        travelled[1] = full[1] - 2.0
    lo, hi = float("-inf"), float("inf")
    if kind == "range_gate":
        lo, hi = 30.0, 120.0
    zeros = torch.zeros(c)
    cfg = kernels.pack_selection_cfg(
        sp, zeros, torch.zeros((c, 3)), zeros, torch.zeros((c, 3)), zeros,
        torch.zeros((c, 3)), torch.tensor([[0.0, 1.0]] * c), travelled,
        kf_weight=1.0, dir_weight=0.8, traj_active=1.0, traj_weight=1.0,
        range_lo=lo, range_hi=hi, root_offset=torch.zeros(3))
    step = 2.0 + 4.0 * torch.rand((c, N_CAND, 1), generator=gen)
    arcs = (travelled[:, None, None] + 3.0 * torch.rand(
        (c, N_CAND, 1), generator=gen) + step * torch.arange(16.0))
    if kind == "past_end":
        arcs[1] = full[1] + step[1] * torch.arange(16.0)
    u = spline_path.u_at_arc_length(sp, arcs.reshape(c, -1))
    pos = spline_path.point_at_u(sp, u).reshape(c, N_CAND, 16, 3)
    pos = pos + 3.0 * torch.randn(pos.shape, generator=gen)
    frames = torch.randn((c, kernels.N_EVAL * kernels.CH, N_CAND),
                         generator=gen)
    for s in range(16):
        frames[:, (2 + s) * kernels.CH: (2 + s) * kernels.CH + 3] = \
            pos[:, :, s].transpose(1, 2)
    return frames, table, cfg


def _run(monkeypatch, search, frames, table, cfg):
    """The twin's body with `search` as its table search -> (errors, each
    sample's search results)."""
    seen = []

    def recording(*args):
        seen.append(search(*args))
        return seen[-1]

    monkeypatch.setattr(kernels, "_table_search", recording)
    err = kernels._loco_score_body(frames, table, cfg)[0]
    return err, seen


@pytest.mark.parametrize("granularity", [256, 1000])
@pytest.mark.parametrize("kind", ["advancing", "past_end", "range_gate",
                                  "repeated_arcs"])
def test_kernel_search_order_is_exact(monkeypatch, granularity, kind):
    """The kernel's search order gives torch.equal distances, arcs, searched
    rows and summed errors as the twin's two full passes, on tables of 264
    and 1008 rows; each case reaches what it is named for."""
    frames, table, cfg = _case(granularity, kind)
    assert table.shape[1] == kernels._round_up(granularity + 1, 8)
    full_passes = kernels._table_search
    err_t, twin = _run(monkeypatch, full_passes, frames, table, cfg)
    err_k, kern = _run(monkeypatch, kernel_order_search, frames, table, cfg)
    assert len(twin) == len(kern) == 16
    for (dt, at, vt), (dk, ak, vk) in zip(twin, kern):
        assert torch.equal(dt, dk) and torch.equal(vt > 0, vk > 0)
        # the arc counts where a row was searched (else the end snaps)
        used = vt.amax(1) > 0
        assert torch.equal(at[used], ak[used])
    assert torch.equal(err_t, err_k) and bool(torch.isfinite(err_k).all())
    searched = torch.stack([v.sum(1) for _, _, v in twin])  # [16, C, N]
    if kind == "past_end":  # no row at or above the floor, then the end
        assert bool((searched[0, 0] == 0).all())
        assert bool((searched[1:, 0] > 0).all())
    if kind == "range_gate":
        arcs = torch.stack([a for _, a, _ in twin])
        assert bool((arcs < 30.0).any()) and bool((arcs > 120.0).any())
    if kind == "repeated_arcs":  # some sample ties on several rows
        ties = max(int(((_row_d2(frames, table, cfg, s) <= dt[:, None] + 1e-6)
                        & (vt > 0)).sum(1).max())
                   for s, (dt, _, vt) in enumerate(twin))
        assert ties > 1


def _row_d2(frames, table, cfg, s):
    """The twin's distances [C, G8, N] of trajectory sample s."""
    row = frames[:, (2 + s) * kernels.CH: (2 + s) * kernels.CH + 3]
    p = row * cfg[:, 22:25, None]
    pts = table[:, :, 0:3]
    cross = torch.bmm(pts, p)
    return (torch.sum(pts * pts, dim=2, keepdim=True) - 2.0 * cross
            + (p * p).sum(1)[:, None, :])


@pytest.mark.parametrize("granularity", [256, 1000])
def test_path_tables_meet_the_kernel_precondition(granularity):
    """pack_path_table's valid rows come first and their arcs never
    decrease (a cumsum of segment lengths), on the bench paths and on
    serving paths of up to MAX_PATH_POINTS control points."""
    rng = np.random.default_rng(granularity)
    paths = [_path(rng, granularity) for _ in range(4)]
    for n_pts in (2, 5, spline_path.MAX_PATH_POINTS):
        pts = np.cumsum(rng.normal(0.0, 25.0, (n_pts, 3)), axis=0)
        paths.append(spline_path.build(pts.astype(np.float32),
                                       unconstrained_dims=(1,),
                                       granularity=granularity))
    table = kernels.pack_path_table(spline_path.stack_paths(paths),
                                    torch.tensor([1.0, 90.0, -2.0]))
    valid = table[:, :, 4] > 0
    g1 = granularity + 1
    assert bool(valid[:, :g1].all()) and not bool(valid[:, g1:].any())
    arcs = table[:, :g1, 3]
    assert bool((arcs[:, 1:] >= arcs[:, :-1]).all())
    assert bool(torch.isfinite(arcs).all())


def test_selection_lanes_fill_the_card():
    """The wrapper's layout: one lane a candidate where the crowd alone
    fills 132 SMs with 8 warps each, more lanes for smaller batches (32 at
    the serving batch of 8 x 128), never more than a warp."""
    assert kernels.selection_lanes(1024, 128, 132) == 1
    assert kernels.selection_lanes(256, 128, 132) == 2
    assert kernels.selection_lanes(128, 128, 132) == 4
    assert kernels.selection_lanes(64, 128, 132) == 8
    assert kernels.selection_lanes(32, 128, 132) == 16
    assert kernels.selection_lanes(16, 128, 132) == 32
    assert kernels.selection_lanes(8, 128, 132) == 32
    assert kernels.selection_lanes(1, 128, 132) == 32
    for c in (1, 3, 8, 40, 1024):
        lanes = kernels.selection_lanes(c, 128, 132)
        assert lanes in (1, 2, 4, 8, 16, 32)
        assert lanes == 32 or c * 128 * lanes >= 32 * 8 * 132
