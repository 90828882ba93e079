"""Kernel-vs-twin and GPU-vs-CPU checks of the PyTorch port that need a CUDA
device.  They skip without one.  This file imports no JAX, so it also runs
on a GPU machine without JAX:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu_torch.models import graph as graph_mod  # noqa: E402
from morphablegraphs_tpu_torch.models import skeleton as sk  # noqa: E402
from morphablegraphs_tpu_torch.ops import kernels, spline_path  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import constrained_walk as cw  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import walk  # noqa: E402
from morphablegraphs_tpu_torch.utils import synthetic  # noqa: E402


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _path(rng, granularity, device):
    pts = [[0.0, 0.0, 0.0]]
    x, z, h = 0.0, 0.0, rng.uniform(-0.6, 0.6)
    for _ in range(3):
        h += rng.uniform(-0.4, 0.4)
        x, z = x + 60 * np.sin(h), z + 60 * np.cos(h)
        pts.append([x, 0.0, z])
    return spline_path.build(np.asarray(pts, np.float32),
                             unconstrained_dims=(1,),
                             granularity=granularity, device=device)


@pytest.mark.cuda
def test_chol_solve_kernel_matches_twin(cuda):
    """B2 against its twin at the main path's [1024, 28, 28] (atol 2e-4,
    rtol 2e-3 as the JAX package's crowd-solve test); zero systems give 0
    and the launch is counted."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    j = torch.randn((1024, 40, 28), generator=gen, device=cuda)
    a = torch.bmm(j.transpose(1, 2), j) + 0.1 * torch.eye(28, device=cuda)
    g = torch.randn((1024, 28), generator=gen, device=cuda)
    a[:2] = 0.0
    g[:2] = 0.0
    before = kernels.launch_counts()["chol_solve"]
    x = kernels.chol_solve(a, g)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["chol_solve"] == before + 1
    torch.testing.assert_close(x, kernels.chol_solve_unrolled(a, g),
                               rtol=2e-3, atol=2e-4)
    assert bool((x[:2] == 0).all())


@pytest.mark.cuda
def test_walk_gpu_matches_cpu(cuda):
    """A small reference-scale crowd walk without the LM on the GPU path
    (B1 ranks the candidates) and on the CPU path (its twin), with the same
    draws: node ids and frame counts equal, frames within 1e-2."""
    graph = graph_mod.build_graph_from_dict(
        synthetic.make_reference_scale_graph_dict())
    skel, _ = sk.load_bvh(synthetic.REF_BVH)
    st = graph_mod.stack_graph(graph)
    rng = np.random.default_rng(1)
    paths = [_path(rng, 256, "cpu") for _ in range(4)]
    gen = torch.Generator().manual_seed(2)
    draws = [walk.torch_sampler(gen, st, 4, 128)(t) for t in range(3)]
    cfg = cw.WalkConfig(max_step_frames=160, lm_iters=0)
    start = st.node_id(("walk", "beginLeftStance"))
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        res = cw.constrained_walk_full_crowd(
            skel, st.to(dev), spline_path.stack_paths([p.to(dev)
                                                       for p in paths]),
            torch.full((4,), start, device=dev), 3,
            draws=lambda t, dev=dev: walk.StepDraws(
                draws[t].comp_gumbel.to(dev), draws[t].normal.to(dev),
                draws[t].trans_gumbel.to(dev)),
            cfg=cfg)
        outs[dev.type] = [r.cpu() for r in res]
    (sg, ng, ig, _), (sc, nc, ic, _) = outs["cuda"], outs["cpu"]
    assert torch.equal(ig, ic) and torch.equal(ng, nc)
    torch.testing.assert_close(sg, sc, rtol=0, atol=1e-2)


def _ee_inputs(device, n_chars=256, seed=4):
    """Kernel B3's inputs on the reference-scale model: random nodes,
    candidates from each node's GMM, random paths and previous frames, and
    a RightHand keyframe at (20, 110, 80) on canonical frame 129."""
    from morphablegraphs_tpu_torch.ops import align
    graph = graph_mod.build_graph_from_dict(
        synthetic.make_reference_scale_graph_dict())
    skel, _ = sk.load_bvh(synthetic.REF_BVH)
    st = graph_mod.stack_graph(graph, device=device)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    paths = spline_path.stack_paths([_path(rng, 256, device)
                                     for _ in range(n_chars)])
    node = torch.randint(0, st.n_nodes, (n_chars,), generator=gen,
                         device=device)
    u = torch.rand((n_chars, 128, st.gmm_weights.shape[-1]), generator=gen,
                   device=device)
    samples = walk.sample_node_latents(
        st, node, -torch.log(-torch.log(u.clamp(min=1e-30))),
        torch.randn((n_chars, 128, st.gmm_means.shape[-1]), generator=gen,
                    device=device))
    travelled = torch.rand(n_chars, generator=gen, device=device) * 60.0
    goal_pos, goal_dir = spline_path.point_and_dir_at_arc_length(
        paths, travelled + st.avg_step_length[node])
    n_can = st.n_canonical[node].float()
    prev = torch.zeros((n_chars, st.n_dim), device=device)
    prev[:, 3::4] = 1.0
    prev[:, 2] = travelled
    off = torch.as_tensor(skel.offsets[0], device=device)
    idx, chain = kernels.pack_ee_chain(skel, "RightHand")
    ones = torch.ones((n_chars, 3), device=device)
    mop = kernels.selection_operator(
        st.eigen_s[node], st.mean_s[node], st.knots_s[node], st.n_basis_max,
        st.n_dim, n_can - 1.0, n_can - 1.0, n_can,
        ee_frame=torch.full_like(n_can, 129.0), ee_chain_idx=idx)
    cfg = kernels.pack_selection_cfg(
        paths, align.heading_angle(prev[:, 3:7]), prev[:, :3],
        torch.zeros(n_chars, device=device), torch.zeros_like(ones),
        torch.ones(n_chars, device=device), goal_pos, goal_dir, travelled,
        kf_weight=1.0, dir_weight=0.8, traj_active=1.0, traj_weight=1.0,
        range_lo=-1e30, range_hi=1e30, root_offset=off, ee_active=1.0,
        ee_weight=1.0, ee_target=torch.tensor([20.0, 110.0, 80.0],
                                              device=device) * ones,
        ee_mask=ones)
    return (mop.contiguous(), samples[:, :, : st.k_s_max].contiguous(),
            kernels.pack_path_table(paths, off).contiguous(),
            cfg.contiguous(), torch.as_tensor(chain, device=device))


@pytest.mark.cuda
def test_ee_score_kernel_matches_twin(cuda):
    """B3 against its twin on the RightHand chain, and on the same chain with
    its third joint fixed at a 90-degree rest rotation: errors within B1's
    bound 0.1 + 5e-3 |x| (the kernel rounds the expanded distance form in
    another order), argmin agreement on at least 99% of the characters, and
    the launch is counted."""
    mop, alphas, table, cfg, chain = _ee_inputs(cuda)
    fixed = chain.clone()
    half = np.deg2rad(90.0) / 2
    fixed[2, 3:7] = torch.tensor([np.cos(half), 0.0, 0.0, np.sin(half)])
    fixed[2, 7] = 0.0
    for ch in (chain, fixed):
        before = kernels.launch_counts()["score_locomotion_candidates_ee"]
        out = kernels.score_locomotion_candidates(mop, alphas, table, cfg,
                                                  chain=ch)
        torch.cuda.synchronize()
        assert kernels.launch_counts()[
            "score_locomotion_candidates_ee"] == before + 1
        ref = kernels.score_locomotion_candidates_ref(mop, alphas, table,
                                                      cfg, chain=ch)
        assert bool(torch.isfinite(out).all())
        assert bool(((out - ref).abs() <= 0.1 + 5e-3 * ref.abs()).all())
        agree = (out.argmin(1) == ref.argmin(1)).float().mean()
        assert float(agree) >= 0.99


@pytest.mark.cuda
def test_score_kernel_layouts_agree(cuda):
    """B1 and B3 give the same bits at every lanes-per-candidate layout
    (1 to 32 lanes a candidate) as at the layout the wrapper picks."""
    mop, alphas, table, cfg, chain = _ee_inputs(cuda, n_chars=16)
    base = mop[:, : kernels.N_EVAL * kernels.CH].contiguous()
    for m, ch in ((base, None), (mop, chain)):
        ref = kernels.score_locomotion_candidates(m, alphas, table, cfg,
                                                  chain=ch)
        for lanes in (1, 2, 4, 8, 16, 32):
            out = kernels._launch_selection(m, alphas, table, cfg, ch, lanes)
            assert torch.equal(out, ref), lanes


@pytest.mark.cuda
def test_score_kernel_long_latents(cuda):
    """More than the 32 latent coefficients a thread keeps in registers:
    15 zero operator columns inserted before the mean column leave every
    fmaf chain, and so every B1/B3 score, with the bits of the K = 25
    inputs."""
    mop, alphas, table, cfg, chain = _ee_inputs(cuda, n_chars=16)
    gen = torch.Generator(device=cuda).manual_seed(9)
    extra = torch.randn(alphas.shape[:2] + (15,), generator=gen,
                        device=cuda)
    long_alphas = torch.cat([alphas, extra], dim=2).contiguous()
    zeros = torch.zeros(mop.shape[:2] + (15,), device=cuda)
    long_mop = torch.cat([mop[..., :-1], zeros, mop[..., -1:]],
                         dim=2).contiguous()
    rows = kernels.N_EVAL * kernels.CH
    for m, lm, ch in ((mop[:, :rows].contiguous(),
                       long_mop[:, :rows].contiguous(), None),
                      (mop, long_mop, chain)):
        out = kernels.score_locomotion_candidates(m, alphas, table, cfg,
                                                  chain=ch)
        long_out = kernels.score_locomotion_candidates(
            lm, long_alphas, table, cfg, chain=ch)
        assert torch.equal(long_out, out)


@pytest.mark.cuda
def test_lm_delta_kernel_matches_twin(cuda):
    """B4 against its twin at the main path's [1024, 49, 28] with lambda over
    1e-3..10 and radii over 0.1..4 (atol 2e-4, rtol 2e-3, the crowd-solve
    bounds); zero characters give 0 and the launch is counted."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    j = torch.randn((1024, 49, 28), generator=gen, device=cuda)
    r = torch.randn((1024, 49), generator=gen, device=cuda)
    lam = 10.0 ** (torch.rand(1024, generator=gen, device=cuda) * 4 - 3)
    rad = 0.1 + 3.9 * torch.rand(1024, generator=gen, device=cuda)
    j[:3] = 0.0
    r[:3] = 0.0
    before = kernels.launch_counts()["lm_delta"]
    d = kernels.lm_delta(j, r, lam, rad)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["lm_delta"] == before + 1
    torch.testing.assert_close(d, kernels.lm_delta_ref(j, r, lam, rad),
                               rtol=2e-3, atol=2e-4)
    assert bool((d[:3] == 0).all())


def _ref_stacked(device):
    graph = graph_mod.build_graph_from_dict(
        synthetic.make_reference_scale_graph_dict())
    return graph_mod.stack_graph(graph, device=device)


@pytest.mark.cuda
def test_back_project_kernel_matches_twin(cuda):
    """B6 against its twin at the walk's shapes on the reference-scale model
    (256 characters over all nodes, T = 160, time-warped bases from GMM
    draws) and at the TPU signature (one shared operand set): within
    1e-3 + 1e-5 |x| (fp32 sums of 25 and 16 products of ~100-cm values in
    other orders); the launch is counted."""
    st = _ref_stacked(cuda)
    gen = torch.Generator(device=cuda).manual_seed(7)
    node = torch.arange(256, device=cuda) % st.n_nodes
    draws = walk.torch_sampler(gen, st, 256, 1)(0)
    s = walk.sample_node_latent(st, node, draws.comp_gumbel[:, 0],
                                draws.normal[:, 0])
    basis, _ = walk.warped_basis(st, node, s[:, st.k_s_max:], 160)
    alpha = s[:, : st.k_s_max].contiguous()
    cases = [(alpha, st.eigen_s, st.mean_s, basis, node),
             (alpha, st.eigen_s[1], st.mean_s[1], basis[0], None)]
    for a, e, m, b, mix in cases:
        before = kernels.launch_counts()["crowd_back_project"]
        out = kernels.crowd_back_project(a, e, m, b, mix_id=mix)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["crowd_back_project"] == before + 1
        ref = kernels.crowd_back_project_ref(a, e, m, b, mix_id=mix)
        assert out.shape == (256, 160, st.n_dim)
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
def test_gmm_kernel_matches_twin(cuda):
    """B5 against its twins on the reference-scale model's node mixtures
    (512 rows over all nodes, K = 5, D = 28, draws scaled 1.5x past the
    mixtures): log p and -log p within 1e-3 + 1e-4 |x| (the JAX package's
    Pallas-vs-XLA bound), the gradient within 1e-3 + 1e-4 |g|; each call
    counts one launch."""
    st = _ref_stacked(cuda)
    gen = torch.Generator(device=cuda).manual_seed(8)
    node = torch.arange(512, device=cuda) % st.n_nodes
    draws = walk.torch_sampler(gen, st, 512, 1)(0)
    x = walk.sample_node_latent(st, node, draws.comp_gumbel[:, 0],
                                1.5 * draws.normal[:, 0])
    args = (x, st.gmm_weights, st.gmm_means, st.gmm_prec_chol)
    before = kernels.launch_counts()["gmm_scores"]
    lp = kernels.gmm_scores(*args, mix_id=node)
    nll, grad = kernels.gmm_nll_and_grad(*args, node)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["gmm_scores"] == before + 2
    torch.testing.assert_close(lp, kernels.gmm_scores_ref(*args, mix_id=node),
                               rtol=1e-4, atol=1e-3)
    nll_t, grad_t = kernels.gmm_nll_and_grad_ref(*args, node)
    torch.testing.assert_close(nll, nll_t, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(grad, grad_t, rtol=1e-4, atol=1e-3)


def _rand_mixtures(gen, device, m, k, d):
    """m random mixtures of k components in d dims with well-conditioned
    precision factors (identity plus noise of norm ~0.3)."""
    w = torch.softmax(torch.randn((m, k), generator=gen, device=device), -1)
    mu = torch.randn((m, k, d), generator=gen, device=device)
    p = torch.eye(d, device=device) + 0.3 / d ** 0.5 * torch.randn(
        (m, k, d, d), generator=gen, device=device)
    return w, mu, p


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 8, 1023])
@pytest.mark.parametrize("k", [1, 5, 9])
@pytest.mark.parametrize("d", [3, 28, 64])
def test_gmm_kernel_shapes(cuda, d, k, c):
    """B5 against its twins with rows spread over 3 mixtures, at the
    compile-time width (D = 28) and the generic one (one and two columns a
    lane): log p, -log p and the gradient within 1e-3 + 1e-4 |x|, the value
    with and without the gradient pass equal bits; a row whose mix_id is
    out of range gives NaN and leaves the other rows alone."""
    gen = torch.Generator(device=cuda).manual_seed(100 * d + 10 * k + c % 7)
    w, mu, p = _rand_mixtures(gen, cuda, 3, k, d)
    mix = torch.randint(0, 3, (c,), generator=gen, device=cuda)
    x = mu[mix, 0] + 1.5 * torch.randn((c, d), generator=gen, device=cuda)
    lp = kernels.gmm_scores(x, w, mu, p, mix_id=mix)
    nll, grad = kernels.gmm_nll_and_grad(x, w, mu, p, mix)
    torch.cuda.synchronize()
    assert torch.equal(lp, -nll)
    nll_t, grad_t = kernels.gmm_nll_and_grad_ref(x, w, mu, p, mix)
    torch.testing.assert_close(lp, kernels.gmm_scores_ref(x, w, mu, p, mix),
                               rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(nll, nll_t, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(grad, grad_t, rtol=1e-4, atol=1e-3)
    bad = mix.clone()
    bad[c // 2] = 3 if c % 2 else -1
    nll_b, grad_b = kernels.gmm_nll_and_grad(x, w, mu, p, bad)
    torch.cuda.synchronize()
    ok = torch.arange(c, device=cuda) != c // 2
    assert bool(torch.isnan(nll_b[~ok]).all() and torch.isnan(
        grad_b[~ok]).all())
    assert torch.equal(nll_b[ok], nll[ok]) and torch.equal(grad_b[ok],
                                                           grad[ok])


@pytest.mark.cuda
def test_gmm_kernel_late_dominant_component(cuda):
    """The online logsumexp when a late component dominates by more than 80
    in log: rows placed on the last component's mean, far from the others;
    same bounds, also from tables 4 bytes off 16-byte alignment (the D = 28
    instance's 16-byte copies do not apply; the generic instance runs)."""
    gen = torch.Generator(device=cuda).manual_seed(17)
    w, mu, p = _rand_mixtures(gen, cuda, 2, 5, 28)
    mu[:, :4] += 6.0  # |y|^2 / 2 of the first four components >> 80
    mix = torch.arange(64, device=cuda) % 2
    x = mu[mix, 4] + 0.1 * torch.randn((64, 28), generator=gen, device=cuda)
    nll_t, grad_t = kernels.gmm_nll_and_grad_ref(x, w, mu, p, mix)
    off = torch.empty(p.numel() + 1, device=cuda)[1:].view_as(p).copy_(p)
    assert off.is_contiguous() and off.data_ptr() % 16 == 4
    for prec in (p, off):
        nll, grad = kernels.gmm_nll_and_grad(x, w, mu, prec, mix)
        torch.testing.assert_close(nll, nll_t, rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(grad, grad_t, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 8, 1023])
@pytest.mark.parametrize("k", [5, 28, 32, 40])
def test_chol_solve_kernel_shapes(cuda, k, c):
    """B2 against its twin at the register widths (28, 32), a padded width
    (5) and the shared-memory routine (40), from an aligned batch and from
    a view 4 bytes off 16-byte alignment (the scalar row load): atol 2e-4,
    rtol 2e-3; the last system is zero and solves to exactly 0."""
    gen = torch.Generator(device=cuda).manual_seed(10 * k + c % 7)
    j = torch.randn((c, k + 12, k), generator=gen, device=cuda)
    a = torch.bmm(j.transpose(1, 2), j) + 0.1 * torch.eye(k, device=cuda)
    g = torch.randn((c, k), generator=gen, device=cuda)
    a[-1] = 0.0
    g[-1] = 0.0
    off = torch.empty(a.numel() + 1, device=cuda)[1:].view_as(a).copy_(a)
    assert off.is_contiguous() and off.data_ptr() % 16 == 4
    x_t = kernels.chol_solve_unrolled(a, g)
    for mat in (a, off):
        x = kernels.chol_solve(mat, g)
        torch.cuda.synchronize()
        torch.testing.assert_close(x, x_t, rtol=2e-3, atol=2e-4)
        assert bool((x[-1] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 28, 32, 40])
def test_lm_delta_kernel_widths(cuda, k):
    """B4 on both of its solves (the register routine for k <= 32, the
    shared-memory one beyond) against its twin: atol 2e-4, rtol 2e-3."""
    gen = torch.Generator(device=cuda).manual_seed(k)
    j = torch.randn((200, k + 21, k), generator=gen, device=cuda)
    r = torch.randn((200, k + 21), generator=gen, device=cuda)
    lam = 10.0 ** (torch.rand(200, generator=gen, device=cuda) * 4 - 3)
    rad = 0.1 + 3.9 * torch.rand(200, generator=gen, device=cuda)
    j[:2] = 0.0
    r[:2] = 0.0
    d = kernels.lm_delta(j, r, lam, rad)
    torch.cuda.synchronize()
    torch.testing.assert_close(d, kernels.lm_delta_ref(j, r, lam, rad),
                               rtol=2e-3, atol=2e-4)
    assert bool((d[:2] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("c,k,nb,nd,t", [(37, 6, 5, 11, 33),
                                         (300, 24, 16, 79, 64),
                                         (5, 3, 16, 10, 7),
                                         (1, 25, 16, 79, 160),
                                         (700, 7, 9, 23, 50)])
def test_back_project_kernel_shapes(cuda, c, k, nb, nd, t):
    """B6 beyond the walk's shape: other coefficient counts than 16 (the
    shared-memory path), even latent widths (a padded chunk stride), frame
    widths that do not fill their last quad, crowds smaller and larger than
    a block's group; a node id outside the table gives NaN rows."""
    gen = torch.Generator(device=cuda).manual_seed(c + k)
    e = torch.randn((3, nb * nd, k), generator=gen, device=cuda)
    m = torch.randn((3, nb * nd), generator=gen, device=cuda)
    a = torch.randn((c, k), generator=gen, device=cuda)
    b = torch.randn((c, t, nb), generator=gen, device=cuda)
    mix = torch.randint(0, 3, (c,), generator=gen, device=cuda)
    out = kernels.crowd_back_project(a, e, m, b, mix_id=mix)
    ref = kernels.crowd_back_project_ref(a, e, m, b, mix_id=mix)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    bad = mix.clone()
    bad[0] = 3
    out = kernels.crowd_back_project(a, e, m, b, mix_id=bad)
    torch.cuda.synchronize()
    assert bool(torch.isnan(out[0]).all())
    torch.testing.assert_close(out[1:], ref[1:], rtol=1e-4, atol=1e-4)


def _emit_inputs(st, device, c, t_max, seed, has_prev):
    gen = torch.Generator(device=device).manual_seed(seed)

    def draw():
        node = torch.randint(0, st.n_nodes, (c,), generator=gen,
                             device=device)
        d = walk.torch_sampler(gen, st, c, 1)(0)
        return node, walk.sample_node_latent(st, node, d.comp_gumbel[:, 0],
                                             d.normal[:, 0])
    node, s = draw()
    k = st.k_s_max
    t_fn, n_frames = walk.warped_time(st, node, s[:, k:], t_max)
    prev = None
    if has_prev:
        node_p, s_p = draw()
        t_p, n_p = walk.warped_time(st, node_p, s_p[:, k:], t_max)
        prev = kernels.emit_frames_ref(
            s_p[:, :k].contiguous(), st.eigen_s, st.mean_s, st.knots_s,
            node_p, t_p, n_p, None, False, 0)[1].contiguous()
    return (s[:, :k].contiguous(), st.eigen_s, st.mean_s, st.knots_s, node,
            t_fn, n_frames, prev, has_prev)


@pytest.mark.cuda
@pytest.mark.parametrize("c,t_max", [(1024, 160), (8, 64), (3, 160),
                                     (530, 37)])
@pytest.mark.parametrize("has_prev,window", [(False, 20), (True, 20),
                                             (True, 0), (True, 200)])
def test_emit_kernel_matches_twin(cuda, has_prev, window, c, t_max):
    """The frame-emit kernel against its twin on the reference-scale model:
    frames and the carried last frame within 1e-3 + 1e-5 |x| (B6's bound),
    leaving out the joints whose quaternion lies within 1e-4 of the equator
    of the previous frame's in some frame of the twin (either hemisphere
    sign is the same rotation); crowds of one block's group and less, a
    smoothing window of 0 and one past the clip; the launch is counted."""
    st = _ref_stacked(cuda)
    args = _emit_inputs(st, cuda, c, t_max, 3 * c + t_max, has_prev)
    before = kernels.launch_counts()["emit_frames"]
    f_k, l_k = kernels.emit_frames(*args, window)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["emit_frames"] == before + 1
    f_t, l_t = kernels.emit_frames_ref(*args, window)
    keep = torch.ones((c, st.n_dim), dtype=torch.bool, device=cuda)
    if has_prev:
        aligned = kernels.emit_frames_ref(*args, 0)[0]
        dots = (aligned[:, :, 3:].reshape(c, t_max, -1, 4)
                * args[7][:, None, 3:].reshape(c, 1, -1, 4)).sum(-1)
        near = (dots.abs() < 1e-4).any(1)
        assert float(near.float().mean()) < 0.01
        keep[:, 3:] = (~near).repeat_interleave(4, dim=1)
    for out, ref in ((f_k, f_t), (l_k[:, None], l_t[:, None])):
        err = (out - ref).abs() * keep[:, None]
        assert bool((err <= 1e-3 + 1e-5 * ref.abs()).all()), float(err.max())


@pytest.mark.cuda
def test_constrained_walk_emits_through_the_kernel(cuda):
    """A constrained crowd on the card launches the emit kernel once a step
    and kernel B6 never; the canonical timeline launches B6."""
    st = _ref_stacked(cuda)
    start = torch.zeros(16, dtype=torch.long, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    kernels.reset_launch_counts()
    walk.random_walk_segments(st, start, 3, walk.torch_sampler(gen, st, 16, 1),
                              max_step_frames=64)
    counts = kernels.launch_counts()
    assert counts["emit_frames"] == 3 and counts["crowd_back_project"] == 0
    kernels.reset_launch_counts()
    walk.random_walk_segments(st, start, 3, walk.torch_sampler(gen, st, 16, 1),
                              max_step_frames=64, use_time=False)
    counts = kernels.launch_counts()
    assert counts["emit_frames"] == 0 and counts["crowd_back_project"] == 3
