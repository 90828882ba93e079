"""The frame-emit stage of the PyTorch port (`kernels.emit_frames`): its
plain twin against the JAX package's back_project_node + align functions,
the walk's step end through it, and the kernel's 4-weight span loop
emulated in numpy against `bspline.basis_matrix`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu.ops import align as alj  # noqa: E402
from morphablegraphs_tpu.synthesis import walk as wj  # noqa: E402
from morphablegraphs_tpu_torch.ops import bspline as bst  # noqa: E402
from morphablegraphs_tpu_torch.ops import kernels  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import walk as wt  # noqa: E402

import torch_parity as tp  # noqa: E402
from torch_parity import release_jax_executables  # noqa: E402,F401

MAX_FRAMES = 64


@pytest.fixture(scope="module")
def toy():
    skel_j, st_j, skel_t, st_t = tp.model("toy")
    rng = np.random.default_rng(4)
    c = 6
    nodes = rng.integers(0, st_j.n_nodes, c).astype(np.int32)
    lat = (rng.standard_normal((c, st_j.gmm_means.shape[-1])) * 0.7).astype(
        np.float32)
    prev = np.stack([tp.prev_frame(st_j.n_dim, 10.0 * i, 25.0 - 4.0 * i,
                                   seed=i) for i in range(c)])
    # face the previous frames' roots in different directions
    yaw = rng.uniform(-2.5, 2.5, c)
    prev[:, 3:7] = np.stack([np.cos(yaw / 2), 0 * yaw, np.sin(yaw / 2),
                             0 * yaw], axis=1)
    return dict(st_j=st_j, st_t=st_t, nodes=nodes, lat=lat, prev=prev)


def _jax_emit(st_j, nodes, lat, prev, has_prev, window):
    """The JAX walk's step end, per character: back_project_node, the 2D
    aligning transform, transform_frames, smooth_transition, the last
    valid row."""
    def one(node, s, pl):
        frames, n, _ = wj.back_project_node(st_j, node, s, MAX_FRAMES,
                                            use_time=True)
        if has_prev:
            q_y, delta = alj.node_aligning_2d_transform(pl, frames[0])
            frames = alj.smooth_transition(
                pl, alj.transform_frames(frames, q_y, delta), window)
        return frames, n, frames[jnp.maximum(n - 1, 0)]
    return jax.vmap(one)(jnp.asarray(nodes), jnp.asarray(lat),
                         jnp.asarray(prev))


@pytest.mark.parametrize("has_prev,window", [(False, 20), (True, 20),
                                             (True, 5), (True, 0)])
def test_emit_frames_ref_matches_jax(toy, has_prev, window):
    """`emit_frames_ref` (what a CPU tensor gets from `emit_frames`) on the
    port's time function against the JAX composition: frame counts exactly,
    frames and the carried last frame to 1e-4 (fp32 back-projection of
    ~100-cm root channels and a rotation by the same heading difference)."""
    st_t = toy["st_t"]
    f_j, n_j, last_j = _jax_emit(toy["st_j"], toy["nodes"], toy["lat"],
                                 toy["prev"], has_prev, window)
    node = torch.as_tensor(toy["nodes"]).long()
    s = torch.as_tensor(toy["lat"])
    t_fn, n_frames = wt.warped_time(st_t, node, s[:, st_t.k_s_max:],
                                    MAX_FRAMES)
    before = kernels.launch_counts()["emit_frames"]
    frames, last = kernels.emit_frames(
        s[:, : st_t.k_s_max], st_t.eigen_s, st_t.mean_s, st_t.knots_s, node,
        t_fn, n_frames, torch.as_tensor(toy["prev"]) if has_prev else None,
        has_prev, window)
    assert kernels.launch_counts()["emit_frames"] == before
    np.testing.assert_array_equal(n_frames.numpy(), np.asarray(n_j))
    np.testing.assert_allclose(frames.numpy(), np.asarray(f_j), atol=1e-4)
    np.testing.assert_allclose(last.numpy(), np.asarray(last_j), atol=1e-4)


def test_emit_frames_without_previous_clip_is_back_project_node(toy):
    """Without a previous clip the stage is the plain back-projection:
    `back_project_node` (which takes it) equals `crowd_back_project_ref` on
    the warped basis bit for bit, and new_last is row n_frames - 1."""
    st_t = toy["st_t"]
    node = torch.as_tensor(toy["nodes"]).long()
    s = torch.as_tensor(toy["lat"])
    frames, n_frames = wt.back_project_node(st_t, node, s, MAX_FRAMES)
    basis, n_b = wt.warped_basis(st_t, node, s[:, st_t.k_s_max:], MAX_FRAMES)
    ref = kernels.crowd_back_project_ref(s[:, : st_t.k_s_max], st_t.eigen_s,
                                         st_t.mean_s, basis, mix_id=node)
    assert torch.equal(frames, ref) and torch.equal(n_frames, n_b)
    t_fn, _ = wt.warped_time(st_t, node, s[:, st_t.k_s_max:], MAX_FRAMES)
    _, last = kernels.emit_frames_ref(
        s[:, : st_t.k_s_max], st_t.eigen_s, st_t.mean_s, st_t.knots_s, node,
        t_fn, n_frames, None, False, 20)
    rows = torch.arange(len(node))
    assert torch.equal(last, ref[rows, (n_frames - 1).long()])


def test_emit_frames_refuses_bad_input(toy):
    """Shape and device guards: a previous frame exactly when has_prev, frame
    widths of a translation and quaternions only, no kernel for a device
    that is neither the CPU nor CUDA."""
    st_t = toy["st_t"]
    node = torch.as_tensor(toy["nodes"]).long()
    s = torch.as_tensor(toy["lat"])
    t_fn, n_frames = wt.warped_time(st_t, node, s[:, st_t.k_s_max:],
                                    MAX_FRAMES)
    args = (s[:, : st_t.k_s_max], st_t.eigen_s, st_t.mean_s, st_t.knots_s,
            node, t_fn, n_frames)
    with pytest.raises(ValueError, match="exactly when has_prev"):
        kernels.emit_frames(*args, None, True, 20)
    with pytest.raises(ValueError, match="exactly when has_prev"):
        kernels.emit_frames(*args, torch.as_tensor(toy["prev"]), False, 20)
    n_basis = st_t.knots_s.shape[1] - 4
    with pytest.raises(ValueError, match="3 \\+ 4 J"):
        kernels.emit_frames(args[0], st_t.eigen_s[:, : n_basis * 10],
                            st_t.mean_s[:, : n_basis * 10], *args[3:],
                            None, False, 20)
    with pytest.raises(kernels.KernelError, match="no kernel for device"):
        kernels.emit_frames(*(a.to("meta") for a in args), None, False, 20)


# ---------------------------------------------------------------------------
# The kernel's span loop, emulated
# ---------------------------------------------------------------------------

def _span_weights(kn, t):
    """The emit kernel's `bspline_weights` in numpy float32, in its order of
    operations: the query clamped into the knots, the one span that holds it
    (the last non-empty span closed), then three Cox-de Boor levels over the
    functions sp - deg .. sp only, without the products that are exact
    zeros there, 0/0 := 0, every product and sum rounded on its own.
    kn [n_knots], t scalar -> (w [4], sp)."""
    f = np.float32
    n_knots = len(kn)
    tmax = kn[-1]
    tc = min(max(f(t), kn[0]), tmax)
    sp = -1
    for s in range(n_knots - 1):
        left, right = kn[s], kn[s + 1]
        hit = (tc >= left and tc <= right and left < right) \
            if right >= tmax else (tc >= left and tc < right)
        if hit:
            sp = s
    if sp < 0:
        return np.zeros(4, f), sp
    a = [f(0), f(0), f(0), f(1), f(0)]
    for deg in (1, 2, 3):
        nw = [f(0)] * 4
        # functions sp-deg .. sp are non-zero at this level: the lowest
        # takes only its right neighbour, the highest only itself
        for idx in range(3 - deg, 4):
            i = sp - 3 + idx
            if i >= 0 and i + deg + 1 < n_knots:
                t1 = t2 = f(0)
                if idx > 3 - deg:
                    d1 = f(kn[i + deg] - kn[i])
                    if d1 > 0:
                        t1 = f(f(f(tc - kn[i]) / d1) * a[idx])
                if idx < 3:
                    d2 = f(kn[i + deg + 1] - kn[i + 1])
                    if d2 > 0:
                        t2 = f(f(f(kn[i + deg + 1] - tc) / d2) * a[idx + 1])
                nw[idx] = f(t1 + t2)
        a[:4] = nw
    return np.asarray(a[:4], f), sp


def _dense_from_spans(kn, ts, n_basis):
    out = np.zeros((len(ts), n_basis), np.float32)
    for r, t in enumerate(ts):
        w, sp = _span_weights(kn, t)
        for i in range(4):
            b = sp - 3 + i
            if sp >= 0 and 0 <= b < n_basis:
                out[r, b] = w[i]
    return out


@pytest.mark.parametrize("kind", ["clamped", "padded", "short", "open"])
def test_span_loop_emulation_equals_basis_matrix(kind):
    """The 4 weights the kernel computes for a frame are `basis_matrix`'s
    row, bit for bit (the same float32 operations on the span's entries;
    every other entry of the row is an exact 0): on a clamped knot vector,
    on one padded with repeats of its end knot (a node with fewer
    coefficients than the graph's widest), on a 5-coefficient vector, and
    on an unclamped vector whose first spans hold functions that do not
    exist; queries inside, on knots, at both ends and outside."""
    rng = np.random.default_rng(7)
    if kind == "clamped":
        kn = bst.clamped_knots(16, 130).astype(np.float32)
    elif kind == "padded":
        base = bst.clamped_knots(12, 90).astype(np.float32)
        kn = np.concatenate([base, np.full(4, base[-1], np.float32)])
    elif kind == "short":
        kn = bst.clamped_knots(5, 9).astype(np.float32)
    else:
        kn = np.arange(12, dtype=np.float32) * 1.5
    n_basis = len(kn) - 4
    ts = np.concatenate([
        rng.uniform(kn[0] - 3.0, kn[-1] + 3.0, 200), kn, kn + 1e-4,
        kn - 1e-4, [kn[0], kn[-1], 0.0]]).astype(np.float32)
    ref = bst.basis_matrix(torch.as_tensor(kn), torch.as_tensor(ts)).numpy()
    out = _dense_from_spans(kn, ts, n_basis)
    np.testing.assert_array_equal(out, ref)
    if kind != "open":  # a clamped vector's rows sum to 1
        np.testing.assert_allclose(out.sum(1), 1.0, atol=1e-6)
