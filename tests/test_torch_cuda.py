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
@pytest.mark.parametrize("n_chars", [8, 256])
def test_score_kernel_matches_twin(cuda, n_chars):
    """B1 (the locomotion rows alone, no chain) against its twin at a
    serving batch and a crowd: errors within 0.1 + 5e-3 |x|, argmin
    agreement on at least 99% of the characters, the launch counted."""
    mop, alphas, table, cfg, _ = _ee_inputs(cuda, n_chars=n_chars)
    mop = mop[:, : kernels.N_EVAL * kernels.CH].contiguous()
    before = kernels.launch_counts()["score_locomotion_candidates"]
    out = kernels.score_locomotion_candidates(mop, alphas, table, cfg)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["score_locomotion_candidates"] == \
        before + 1
    ref = kernels.score_locomotion_candidates_ref(mop, alphas, table, cfg)
    assert bool(torch.isfinite(out).all())
    assert bool(((out - ref).abs() <= 0.1 + 5e-3 * ref.abs()).all())
    assert float((out.argmin(1) == ref.argmin(1)).float().mean()) >= 0.99


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
                                     (530, 37), (1, 160)])
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
def test_emit_kernel_node_outside_the_table(cuda):
    """A node id outside the table (past its end, or -1) gives its
    character NaN rows and leaves every other character's rows as they
    were."""
    st = _ref_stacked(cuda)
    args = list(_emit_inputs(st, cuda, 64, 160, 22, True))
    good = kernels.emit_frames(*args, 20)
    args[4] = args[4].clone()
    args[4][5], args[4][17] = st.n_nodes, -1
    bad = kernels.emit_frames(*args, 20)
    torch.cuda.synchronize()
    rows = torch.ones(64, dtype=torch.bool, device=cuda)
    rows[[5, 17]] = False
    for b, g in zip(bad, good):
        assert bool(torch.isnan(b[~rows]).all())
        assert torch.equal(b[rows], g[rows])


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


# ---------------------------------------------------------------------------
# The entry points on the card against the port on the CPU
# ---------------------------------------------------------------------------
# Each case runs one entry point on the card (the kernels) and on the CPU
# (their plain twins) from the same seed, inputs and draws, on a model of
# `utils/synthetic.py` at the smallest size at which the path still runs
# its kernels.  Node keys, frame counts and events agree exactly.  An LM's
# accept test can fall either way on a knife edge, so errors agree within
# ERR_ATOL + ERR_RTOL |err| and frames within FRAMES_ATOL, joint
# quaternions up to sign: the seam smoothing picks a hemisphere by the
# sign of a dot that the synthetic models' unnormalised quaternions can put
# within rounding of 0.  Whole requests run one LM iteration: at more, a
# last-bit difference of a start moves the synthetic models' LM further
# than these bounds.  The planner's states and the ca request's frames
# agree within FRAMES_ATOL + CHAOS_FACTOR x the CPU's own spread, at most
# CHAOS_CAP: the spread is how far the CPU's result moves when every draw
# is scaled by 1 + each of NUDGES, a change of the last bits like the
# card's, which their one-iteration LMs and seam blends grow past
# FRAMES_ATOL (tests/test_torch_state_planner.py holds the planner against
# JAX so).  Every bound a case holds is printed beside its gap.
ERR_ATOL, ERR_RTOL, FRAMES_ATOL = 0.05, 1e-2, 1e-2
CHAOS_FACTOR, CHAOS_CAP, NUDGES = 3.0, 3e-2, (-1e-6, 1e-6)
# the post-process (keyframe IK, trajectory IK, grounding) is chaotic on
# some frames of the synthetic models (out-of-reach IK targets, contact
# thresholds): it is held on the frames where the CPU's output moves less
# than STABLE_ATOL under relative nudges of 1e-6 of its input's joint
# quaternions, to POST_ATOL, and at least MIN_STABLE of the frames must be
# stable
STABLE_ATOL, POST_ATOL, MIN_STABLE = 1e-3, 1e-2, 0.2
# ranks against one process: a rank walks fewer characters, and a batched
# op may round its last bit otherwise
GROUP_ATOL = 1e-5
WALK_CHARS, WALK_STEPS = 8, 3
EE_JOINT, EE_FRAME, EE_TARGET = "RightHand", 129.0, (20.0, 110.0, 80.0)
GENERAL_QUAT = (0.9659258, 0.0, 0.2588190, 0.0)  # 30 degrees about Y
EE = dict(pallas_ee=EE_JOINT, lm_frozen=True, frozen_ee=EE_JOINT)
B1, B3 = "score_locomotion_candidates", "score_locomotion_candidates_ee"
REQUEST_KERNELS = ("chol_solve", "gmm_scores", "emit_frames")
# the sequential request path: its exact LM runs as the kernel request_lm
# for the sets it covers (`generator.lm_kernel_covers`)
REQUEST_PATH_KERNELS = ("request_lm", "emit_frames")
# name -> (WalkConfig settings, LM iterations, the step sets, teacher
# forcing, the kernels the card's walk launches and those it does not).
# The ee walks start from errors of ~1e4 (the keyframe is far from any pose
# the model makes), where the frozen-ee LM is chaotic: they are held step
# by step, each CPU step from the card walk's state.
GENERAL_KERNELS = (REQUEST_KERNELS,
                   (B1, B3, "lm_delta", "crowd_back_project"))
WALK_CASES = {
    "walk_lm_exact": (dict(lm_frozen=False), 3, "empty", False,
                      ((B1,) + REQUEST_KERNELS,
                       ("lm_delta", "crowd_back_project"))),
    "walk_ee": (EE, 1, "ee", True, ((B3,) + REQUEST_KERNELS,
                                    ("lm_delta", "crowd_back_project"))),
    "walk_ee_fused": (dict(EE, lm_fused_step=True), 1, "ee", True,
                      ((B3, "lm_delta", "gmm_scores", "emit_frames"),
                       ("chol_solve", "crowd_back_project"))),
    "walk_general": (dict(pallas_selection=False, lm_frozen=False), 1,
                     "general", False, GENERAL_KERNELS),
    "walk_families": (dict(pallas_selection=False, lm_frozen=False,
                           use_ca=True, use_ts=True, use_half=True), 1,
                      "families", False, GENERAL_KERNELS),
}
WALK_INPUT = {
    "startPose": {"position": [0, 0, 0], "orientation": [0, 0, 0]},
    "elementaryActions": [{
        "action": "walk",
        "constraints": [{"joint": "Hips", "trajectoryConstraints": [
            {"position": [0.0, None, 0.0]}, {"position": [5.0, None, 40.0]},
            {"position": [15.0, None, 80.0]},
            {"position": [20.0, None, 120.0]}]}],
    }],
}
KEYFRAME_INPUT = {
    "startPose": {"position": [0, 0, 0], "orientation": [0, 0, 0]},
    "elementaryActions": [{
        "action": "walk",
        "constraints": [{"joint": "Hips", "keyframeConstraints": [{
            "position": [10.0, None, 35.0],
            "semanticAnnotation": {"end": True}}]}],
    }],
}
TIMED_INPUT = {
    "elementaryActions": [{
        "action": "walk",
        "constraints": [{"joint": "Hips", "keyframeConstraints": [{
            "position": [10.0, None, 35.0], "time": 0.5,
            "semanticAnnotation": {"end": True}}]}],
    }],
}
CA_INPUT = {
    "elementaryActions": [{
        "action": "walk",
        "constraints": [
            {"joint": "Hips", "trajectoryConstraints": [
                {"position": [0.0, None, 0.0]},
                {"position": [0.0, None, 60.0]}]},
            {"joint": "Head", "trajectoryConstraints": [
                {"position": [20.0, 150.0, 30.0]},
                {"position": [20.0, 150.0, 40.0]}]}],
    }],
}


def _frames_gap(a, b) -> float:
    """The largest difference of frames a, b [T, 3 + 4J], each joint
    quaternion compared up to its sign."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    qa = a[:, 3:].reshape(len(a), -1, 4)
    qb = b[:, 3:].reshape(len(b), -1, 4)
    q = np.minimum(np.abs(qa - qb).max(-1), np.abs(qa + qb).max(-1))
    return max(float(np.abs(a[:, :3] - b[:, :3]).max()), float(q.max()))


def _report(path: str, what: str, gap: float, bound: float):
    """Print a case's gap beside the bound it is held to (pytest -s shows
    it), then hold it."""
    print(f"{path}: {what} {gap:.4e}, bound {bound:.4e}", flush=True)
    assert gap <= bound, (path, what, gap, bound)


def _assert_errors_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= ERR_ATOL + ERR_RTOL * np.abs(want)), \
        (got.tolist(), want.tolist())


def _chaos_bound(gaps_of_nudged) -> float:
    """FRAMES_ATOL + CHAOS_FACTOR x the CPU's spread, at most CHAOS_CAP."""
    return min(FRAMES_ATOL + CHAOS_FACTOR * max(gaps_of_nudged), CHAOS_CAP)


def _assert_requests_match(path, a, b, nudged=None):
    """Two MotionResults of one request, the card's a and the CPU's b:
    node keys, step errors, frames within FRAMES_ATOL, or within the
    chaos bound of the CPU's results from nudged draws when given."""
    assert [s.node_key for s in a.steps] == [s.node_key for s in b.steps]
    _assert_errors_close([s.error for s in a.steps],
                         [s.error for s in b.steps])
    assert np.all(np.isfinite(a.frames)) and len(a.frames) > 0
    bound = FRAMES_ATOL if nudged is None else _chaos_bound(
        [_frames_gap(n.frames, b.frames) for n in nudged])
    _report(path, "frames gap", _frames_gap(a.frames, b.frames), bound)


def _assert_launched(before: dict, must, must_not=()):
    """Since the launch counts `before`, every kernel of `must` ran on the
    card and none of `must_not`."""
    after = kernels.launch_counts()
    added = {k: after[k] - before[k] for k in after}
    assert all(added[k] > 0 for k in must), added
    assert not any(added[k] for k in must_not), added


def _host_sampler(graph, seed, scale=1.0):
    """Draws from a host torch.Generator, the same on every device, times
    scale: a node's mixture, or a transition model's conditioned mixture
    copied to the host; a cluster-tree step's key (n = 0) draws nothing.
    graph's primitives live on the CPU."""
    from morphablegraphs_tpu_torch.models import primitive as prim_mod
    from morphablegraphs_tpu_torch.ops import gmm as gmm_ops
    gen = torch.Generator().manual_seed(seed)

    def sampler(key, n, gmm=None):
        prim = graph.nodes[key].primitive
        if n == 0:
            return np.zeros((0, prim.n_latent), np.float32)
        if gmm is None:
            out = prim_mod.sample_latent(gen, prim, n)
        else:
            out = gmm_ops.sample(gen, gmm_ops.GMM(*(getattr(gmm, f).cpu()
                                                    for f in (
                "weights", "means", "cov_chol", "prec_chol"))), n)
        return out.numpy() * np.float32(scale)
    return sampler


def _toy_graph(graph_dict=None, bvh=synthetic.TEST_BVH):
    """The toy walk graph (4 joints unless graph_dict says otherwise) on
    the CPU, with its skeleton."""
    g = graph_mod.build_graph_from_dict(graph_dict
                                        or synthetic.make_graph_dict())
    g.skeleton = sk.load_bvh(bvh)[0]
    return g


def _config(**kw):
    from morphablegraphs_tpu_torch.utils.config import default_config
    cfg = default_config()
    cfg.update(kw)
    return cfg


def _ref_walk_model():
    skel, _ = sk.load_bvh(synthetic.REF_BVH)
    return skel, _ref_stacked("cpu")


def _walk_step_scs(skel, st, kind: str, n_steps: int):
    """The walk's per-step constraint sets: none; a RightHand position
    keyframe; a RightHand orientation keyframe (no selection kernel ranks
    it); or every constraint family (look-at, joint rotation, relative
    transform, two CA slots, a trajectory set on the hands, the transition
    pose at step 0)."""
    from morphablegraphs_tpu_torch.constraints import compiled
    if kind == "empty":
        return cw.default_step_scs(skel, n_steps)
    sc = compiled.empty_step_constraints(skel, 0)
    if kind == "ee":
        return cw.stack_steps(compiled.set_keyframe_constraint(
            sc, 2, skel, EE_JOINT, EE_FRAME,
            position=np.asarray(EE_TARGET, np.float32)), n_steps)
    if kind == "general":
        return cw.stack_steps(compiled.set_keyframe_constraint(
            sc, 2, skel, EE_JOINT, EE_FRAME,
            quat_wxyz=np.asarray(GENERAL_QUAT, np.float32)), n_steps)
    sc = compiled.set_look_at_constraint(sc, skel, "Head",
                                         (0.0, 170.0, 400.0), 129.0)
    sc = compiled.set_joint_rotation_constraint(
        sc, skel, "Spine1", (0.9914449, 0.1305262, 0.0, 0.0), 65.0)
    sc = compiled.set_relative_transform_constraint(
        sc, skel, "LeftHand", "RightHand", (36.0, 0.0, 0.0), 65.0)
    for slot, (joint, pos) in enumerate((("RightHand", (-20.0, 70.0, 60.0)),
                                         ("LeftHand", (20.0, 70.0, 60.0)))):
        sc = compiled.set_ca_constraint(sc, skel, joint, pos, slot=slot)
    sc = compiled.set_trajectory_set_constraint(
        sc, skel, ["RightHand", "LeftHand"],
        [spline_path.build(np.asarray(((x, 67.0, 0.0), (x, 67.0, 150.0)),
                                      np.float32), granularity=256)
         for x in (-18.0, 18.0)])
    start = st.node_id(("walk", "beginLeftStance"))
    first = st.mean_s[start].reshape(st.n_basis_max, st.n_dim)[0]
    sc = compiled.set_pose_constraint(sc, skel, first.numpy())
    pose = np.zeros(n_steps, np.float32)
    pose[0] = 1.0
    return cw.stack_steps(sc, n_steps).replace(pose_active=pose)


def _walk_steps(skel, st, paths, start, draws, scs, cfg, dev, states=None):
    """The crowd walk step by step on dev -> (each step's input state and
    the last state, each step's StepOutput).  With states (another run's)
    every step starts from that run's state: teacher forcing."""
    from morphablegraphs_tpu_torch.constraints import compiled
    root_only = compiled.step_scs_root_only(scs)
    cw.check_walk_contract(skel, scs, cfg, root_only)
    st = st.to(dev)
    paths = spline_path.stack_paths([p.to(dev) for p in paths])
    table = kernels.pack_path_table(paths, torch.as_tensor(
        skel.offsets[0], device=dev))
    ee = None
    if cfg.pallas_ee is not None:
        idx, chain = kernels.pack_ee_chain(skel, cfg.pallas_ee)
        ee = (idx, torch.as_tensor(chain, device=dev))
    c = paths.table_arc.shape[0]
    state = cw.initial_state(st, torch.full((c,), start, device=dev))
    ins, outs = [], []
    for t, d in enumerate(draws):
        if states is not None:
            state = cw.WalkState(*(x.to(dev) for x in (
                states[t].node_id, states[t].prev_last, states[t].travelled,
                states[t].done)))
        ins.append(state)
        state, out = cw.full_walk_step(
            skel, st, paths, table, state, t,
            cw.step_constraints(scs, t, c, dev),
            walk.StepDraws(*(x.to(dev) for x in (
                d.comp_gumbel, d.normal, d.trans_gumbel))), cfg, root_only,
            ee)
        outs.append(out)
    return ins + [state], outs


def _walk_case(cuda, name):
    settings, lm_iters, kind, forced, (must, must_not) = WALK_CASES[name]
    skel, st = _ref_walk_model()
    rng = np.random.default_rng(3)
    paths = [_path(rng, 256, "cpu") for _ in range(WALK_CHARS)]
    gen = torch.Generator().manual_seed(11)
    sampler = walk.torch_sampler(gen, st, WALK_CHARS, 128)
    draws = [sampler(t) for t in range(WALK_STEPS)]
    start = st.node_id(("walk", "beginLeftStance"))
    cfg = cw.WalkConfig(max_step_frames=160, n_samples=128,
                        lm_iters=lm_iters, lm_threshold=5.0, **settings)
    scs = _walk_step_scs(skel, st, kind, WALK_STEPS)
    before = kernels.launch_counts()
    card = _walk_steps(skel, st, paths, start, draws, scs, cfg, cuda)
    _assert_launched(before, must, must_not)
    cpu = _walk_steps(skel, st, paths, start, draws, scs, cfg, "cpu",
                      states=card[0] if forced else None)
    (ins_g, outs_g), (ins_c, outs_c) = card, cpu
    for a, b in zip(ins_g[1:], ins_c[1:]):  # the nodes each step went to
        assert torch.equal(a.node_id.cpu(), b.node_id.cpu())
    for a, b in zip(outs_g, outs_c):
        assert torch.equal(a.node_id.cpu(), b.node_id.cpu())
        assert torch.equal(a.n_frames.cpu(), b.n_frames.cpu())
        assert bool(torch.isfinite(a.frames).all())
        _assert_errors_close(a.error.cpu().numpy(), b.error.cpu().numpy())


def _random_case(cuda, name):
    """The concatenating random walk, or the constrained walk of the
    boundary rows, 8 characters x 4 steps of 160 frames."""
    skel, st = _ref_walk_model()
    n_chars, n_steps = 8, 4
    start = st.node_id(("walk", "beginLeftStance"))
    gen = torch.Generator().manual_seed(12)
    n = 1 if name == "random_walk" else 64
    sampler = walk.torch_sampler(gen, st, n_chars, n)
    draws = [sampler(t) for t in range(n_steps)]
    rng = np.random.default_rng(4)
    paths = [_path(rng, 256, "cpu") for _ in range(n_chars)]

    def run(dev):
        ids = torch.full((n_chars,), start, device=dev)

        def on(t):
            return walk.StepDraws(*(x.to(dev) for x in (
                draws[t].comp_gumbel, draws[t].normal,
                draws[t].trans_gumbel)))
        if name == "random_walk":
            buf, nv, w_ids, _ = walk.random_walk(st.to(dev), ids, n_steps,
                                                 on, max_step_frames=160)
            return buf[:, None].cpu(), nv[:, None].cpu(), w_ids.cpu()
        seg, nf, s_ids, _ = cw.constrained_walk(
            st.to(dev), spline_path.stack_paths([p.to(dev) for p in paths]),
            ids, n_steps, on, max_step_frames=160)
        return seg.cpu(), nf.cpu(), s_ids.cpu()

    (fg, ng, ig), (fc, nc, ic) = run(cuda), run("cpu")
    assert torch.equal(ig, ic) and torch.equal(ng, nc)
    valid = torch.arange(fg.shape[2])[None, None] < nc[..., None]
    _report(name, "frames gap",
            float(((fg - fc).abs() * valid[..., None]).max()), FRAMES_ATOL)


def _unit_quats(frames):
    out = np.array(frames, np.float32)
    q = out[:, 3:].reshape(len(out), -1, 4)
    out[:, 3:] = (q / np.linalg.norm(q, axis=-1, keepdims=True)).reshape(
        len(out), -1)
    return out


def _request_case(cuda, name, monkeypatch):
    """A request under the options of the request path's later passes (the
    global time and spatial optimizations, the extra CA pass, the "ik" CA
    mode, grounding) on the toy graph with feet, up to the post-process
    (stubbed: it hands back its input); then the post-process on both
    devices from the card's input with unit joint quaternions, held on
    the CPU's stable frames."""
    from morphablegraphs_tpu_torch.synthesis import postprocess
    from morphablegraphs_tpu_torch.synthesis.motion_generator import \
        MotionGenerator
    graph = _toy_graph(synthetic.make_graph_dict(n_joints=11),
                       synthetic.WALK_BVH)
    if name == "request_timed":
        mg_input, cfg = TIMED_INPUT, _config(
            n_random_samples=20, lm_iterations=1, debug_max_step=2,
            global_spatial_optimization_mode="all",
            activate_motion_grounding=True)
        cfg["global_spatial_optimization_settings"] = dict(
            cfg["global_spatial_optimization_settings"],
            start_error_threshold=0.0, position_weight=1.0,
            orientation_weight=1.0)
        cfg["motion_grounding_settings"] = dict(
            cfg["motion_grounding_settings"],
            generate_foot_plant_constraints=False)
    else:
        mg_input, cfg = CA_INPUT, _config(
            n_random_samples=10, lm_iterations=1,
            collision_avoidance_constraints_mode="ik",
            optimize_collision_avoidance_constraints_extra=True,
            activate_motion_grounding=True)
    post = postprocess.post_process_motion
    calls = []

    def stub(*a, **kw):
        calls.append((a, kw))
        return a[1]

    def generate(dev, scale=1.0):
        return MotionGenerator(graph, dict(cfg), device=dev,
                               sampler=_host_sampler(graph, 7, scale)
                               ).generate_motion(mg_input)

    with monkeypatch.context() as m:
        m.setattr(postprocess, "post_process_motion", stub)
        b = generate("cpu")
        before = kernels.launch_counts()
        a = generate(cuda)
        # every set of the ca request has collision avoidance or a
        # trajectory set: its LMs run the eager stage (B2, B5)
        _assert_launched(before, REQUEST_KERNELS if name == "request_ca"
                         else REQUEST_PATH_KERNELS)
        _assert_requests_match(name, a, b, None if name == "request_timed"
                               else [generate("cpu", 1 + e)
                                     for e in NUDGES])
    args, kw = calls[1]  # the card's
    base = _unit_quats(args[1])

    def run(frames, dev):
        return np.asarray(post(args[0], frames, *args[2:],
                               **dict(kw, device=dev)))

    out_g, out_c = run(base, cuda), run(base, "cpu")
    spread = np.zeros(len(base))
    for eps in (-1e-6, 1e-6):
        nudged = base.copy()
        nudged[:, 3:] *= np.float32(1 + eps)
        spread = np.maximum(spread, np.abs(run(nudged, "cpu")
                                           - out_c).max(1))
    stable = spread < STABLE_ATOL
    assert np.all(np.isfinite(out_g))
    share = float(stable.mean())
    print(f"{name}: post-process stable share {share:.3f}, at least "
          f"{MIN_STABLE}", flush=True)
    assert share >= MIN_STABLE
    _report(name, "post-process gap on the stable frames",
            float(np.abs(out_g - out_c)[stable].max()), POST_ATOL)
    assert float(np.abs(out_g - base).max()) > 1e-2  # the passes ran


def _cluster_case(cuda, monkeypatch, tmp_path):
    """Cluster-tree search: trees of 500 latents on every node but
    leftStance, loaded onto each device; every constrained step of a node
    with a tree ranks the tree's rows on its device, and the two requests
    agree (each step's least pool error too)."""
    from morphablegraphs_tpu_torch.construct import space_partitioning as spt
    from morphablegraphs_tpu_torch.synthesis import generator
    from morphablegraphs_tpu_torch.synthesis.motion_generator import \
        MotionGenerator
    no_tree = ("walk", "leftStance")
    graphs = {str(d): _toy_graph() for d in ("cpu", cuda)}
    for i, (key, node) in enumerate(graphs["cpu"].nodes.items()):
        if key == no_tree:
            continue
        prefix = str(tmp_path / "_".join(key))
        spt.build_cluster_tree_for_primitive(
            torch.Generator().manual_seed(i), node.primitive, n_samples=500,
            max_level=2).save(prefix)
        for d, g in graphs.items():
            g.nodes[key].cluster_tree = spt.ClusterTree.load(prefix,
                                                             device=d)
    cfg = _config(constrained_sampling_mode="cluster_tree_search",
                  lm_iterations=1, debug_max_step=3)
    score = generator.score_pool
    for mg_input in (WALK_INPUT, KEYFRAME_INPUT):
        pools = {}
        trees = [torch.as_tensor(n.cluster_tree.data)
                 for n in graphs["cpu"].nodes.values()
                 if n.cluster_tree is not None]
        for d, g in graphs.items():
            rows = pools[d] = []

            def spy(skel, prim, sc, pool, *a, **kw):
                errors = score(skel, prim, sc, pool, *a, **kw)
                host = pool.cpu()
                rows.append((pool.shape[0], pool.device.type,
                             any(host.shape == t.shape and torch.equal(host, t)
                                 for t in trees), float(errors.min())))
                return errors
            before = kernels.launch_counts()
            with monkeypatch.context() as m:
                m.setattr(generator, "score_pool", spy)
                res = MotionGenerator(
                    g, dict(cfg), device=d,
                    sampler=_host_sampler(graphs["cpu"], 7)
                ).generate_motion(mg_input)
            pools[d + ".result"] = res
        _assert_launched(before, REQUEST_PATH_KERNELS)
        a, b = pools[str(cuda) + ".result"], pools["cpu.result"]
        _assert_requests_match("cluster_tree", a, b)
        card, cpu = pools[str(cuda)], pools["cpu"]
        assert [(n, tree) for n, _, tree, _ in card] == \
            [(n, tree) for n, _, tree, _ in cpu]
        assert {d for _, d, _, _ in card} == {cuda.type}
        assert any(n == 500 and tree for n, _, tree, _ in card)
        _assert_errors_close([r[3] for r in card], [r[3] for r in cpu])


def _package_case(cuda, tmp_path):
    """A packaged graph: transition models fitted on the card and a pfnn/
    section at the published PFNN widths, written by zip_writer and loaded
    on the card and the CPU; a request drawing from the transition models,
    its frames retargeted to the skeleton at twice its size, and the
    PFNN's crowd step."""
    from morphablegraphs_tpu_torch.models import pfnn, retarget
    from morphablegraphs_tpu_torch.models import transition_model as tm
    from morphablegraphs_tpu_torch.models.zip_writer import write_graph_zip
    from morphablegraphs_tpu_torch.synthesis.motion_generator import \
        MotionGenerator
    gd = synthetic.make_graph_dict()
    skel = sk.load_bvh(synthetic.TEST_BVH)[0]
    fit = graph_mod.build_graph_from_dict(gd, device=cuda)
    tm.fit_transition_models_for_graph(fit, n_pairs=200, n_components=2,
                                       seed=0)
    entries = [{"from": f"{f[0]}_{f[1]}", "to": f"{t[0]}_{t[1]}",
                "model": tm.to_json(m)}
               for f, node in fit.nodes.items()
               for t, m in node.transition_models.items()]
    assert entries
    rng = np.random.default_rng(17)
    x, y, h, p = 342, 311, 512, 4  # PFNN's published widths
    weights = {k: (rng.standard_normal(n) * 0.1).astype(np.float32)
               for k, n in (("W0", p * h * x), ("W1", p * h * h),
                            ("W2", p * y * h), ("b0", p * h), ("b1", p * h),
                            ("b2", p * y))}
    means = {"Xmean": rng.standard_normal(x), "Xstd": rng.uniform(0.5, 2, x),
             "Ymean": rng.standard_normal(y), "Ystd": rng.uniform(0.5, 2, y)}
    means = {k: v.astype(np.float32) for k, v in means.items()}
    walk_d = gd["subgraphs"]["walk"]
    path = write_graph_zip(
        str(tmp_path / "walk.zip"), skel,
        {"walk": {"nodes": {mp: n["mm"] for mp, n in walk_d["nodes"].items()},
                  "info": walk_d["info"]}},
        gd["transitions"], start_node=tuple(gd["startNode"]),
        format_version=4.0, pfnn_data={"weights": weights, "means": means},
        transition_models=entries)
    g_card = graph_mod.load_graph(path, device=cuda)
    g_cpu = graph_mod.load_graph(path, device="cpu")
    assert g_card.nodes.keys() == g_cpu.nodes.keys()
    for key, node in g_card.nodes.items():
        a, b = node.primitive, g_cpu.nodes[key].primitive
        assert a.eigen_s.device.type == cuda.type
        assert torch.equal(a.eigen_s.cpu(), b.eigen_s)
        assert node.transition_models.keys() == \
            g_cpu.nodes[key].transition_models.keys()
    results, conditioned = {}, []
    for dev, g in (("cpu", g_cpu), (cuda, g_card)):
        before = kernels.launch_counts()
        gen = MotionGenerator(g, _config(use_transition_model=True,
                                         lm_iterations=1, debug_max_step=3),
                              device=dev, sampler=_host_sampler(g_cpu, 7))
        transition_gmm = gen._transition_gmm

        def counted(key, transition_gmm=transition_gmm, dev=dev):
            out = transition_gmm(key)
            conditioned.append((str(dev), out is not None))
            return out
        gen._transition_gmm = counted
        results[str(dev)] = gen.generate_motion(WALK_INPUT)
    _assert_launched(before, REQUEST_PATH_KERNELS)
    a, b = results[str(cuda)], results["cpu"]
    _assert_requests_match("package", a, b)
    assert (str(cuda), True) in conditioned
    big = sk.load_bvh(synthetic.TEST_BVH)[0]
    frames = _unit_quats(b.frames)
    r_g = retarget.retarget_frames(g_cpu.skeleton, frames, big, None, 2.0,
                                   device=cuda)
    r_c = retarget.retarget_frames(g_cpu.skeleton, frames, big, None, 2.0,
                                   device="cpu")
    np.testing.assert_allclose(r_g, r_c, rtol=0, atol=1e-4)
    models = [pfnn.load_from_arrays(g.pfnn_data["weights"],
                                    g.pfnn_data["means"], p, h, device=d)
              for d, g in ((cuda, g_card), ("cpu", g_cpu))]
    gen = torch.Generator().manual_seed(43)
    xs, phases = torch.randn((64, x), generator=gen), torch.rand(
        64, generator=gen)
    y_g = pfnn.forward_crowd(models[0], xs.to(cuda), phases.to(cuda)).cpu()
    y_c = pfnn.forward_crowd(models[1], xs, phases)
    assert bool(torch.isfinite(y_g).all())
    assert float((y_g - y_c).abs().max()) <= 1e-4 * float(y_c.abs().max())


def _planner_case(cuda):
    """The streaming planner's action sequences at one LM iteration: a
    control-point walk with an end direction and the end targets forced, a
    direction walk with a gesture overlay and a look-at target, and a walk
    followed by pickRight with a labelled frame constraint carrying an
    event and a hold (the IK snap)."""
    from morphablegraphs_tpu_torch.synthesis import state_planner as spt
    pick = {"pickRight": {
        "node_sequence": [["reach", "standard"]],
        "constraint_slots": {"start_contact": {"node": "reach",
                                               "joint": "Head"}}}}
    gd = synthetic.make_multi_action_graph_dict()
    gd["actionDefinitions"] = pick
    graphs = {"walk": _toy_graph(), "action": _toy_graph(gd)}
    sequences = (
        ("walk", [{"action": "walk", "controlPoints": [[0, 0, 45],
                                                       [10, 0, 100]],
                   "endDirection": [1.0, 0.0, 0.0]}],
         dict(n_samples=10, step_target_threshold=15.0,
              max_steps_per_target=10, force_walk_end_targets=True,
              min_end_distance=1.0, end_target_blend_range=10)),
        ("walk", [{"action": "walk", "direction": [0.0, 0.0, 1.0],
                   "n_steps": 3, "upper_body_gesture": {"name": "walk"},
                   "lookAtTarget": [30.0, 100.0, 80.0]}], dict(n_samples=6)),
        ("action", [
            {"action": "walk", "controlPoints": [[0, 0, 40], [0, 0, 90]]},
            {"action": "pickRight", "frame_constraints": [{
                "node": "reach", "joint": "Head",
                "position": [10.0, np.nan, 40.0],
                "keyframeLabel": "start_contact",
                "keyframeEvents": [{"event": "attach", "parameters": {}}],
                "holdFrame": True}]}], dict(n_samples=6)))
    for k, (which, actions, settings) in enumerate(sequences):
        g = graphs[which]
        def states(dev, scale=1.0):
            p = spt.MGStatePlanner(g, spt.MGStatePlanningSettings(**settings),
                                   config=_config(lm_iterations=1),
                                   device=dev,
                                   sampler=_host_sampler(g, 0, scale))
            p.generate_motion_states_from_action_sequence(actions)
            return list(p.state_queue._queue)

        def labels(entries):
            return [(e.node_key, e.node_type, e.events, e.hold_frames)
                    for e in entries]

        cpu = states("cpu")
        before = kernels.launch_counts()
        card = states(cuda)
        _assert_launched(before, REQUEST_PATH_KERNELS)
        nudged = [states("cpu", 1 + e) for e in NUDGES]
        assert labels(card) == labels(cpu)
        for i, (a, b) in enumerate(zip(card, cpu)):
            assert np.all(np.isfinite(a.state.frames))
            _report("planner", f"sequence {k} state {i} frames gap",
                    _frames_gap(a.state.frames, b.state.frames),
                    _chaos_bound([_frames_gap(n[i].state.frames,
                                              b.state.frames)
                                  for n in nudged]))


def _traj_request(x, z):
    return {"startPose": {"position": [0, 0, 0], "orientation": [0, 0, 0]},
            "elementaryActions": [{"action": "walk", "constraints": [{
                "joint": "Hips", "trajectoryConstraints": [
                    {"position": [0, None, 0]},
                    {"position": [x / 2, None, z / 2]},
                    {"position": [x, None, z]}]}]}]}


def _batch_case(cuda, monkeypatch):
    """The batch endpoint: three trajectory requests as one crowd walk
    (B1 ranks, the exact LM) and a keyframe request on the sequential
    path, the crowd's draws made on the host for both devices; the card's
    answer is its direct call's, and its frames the CPU's."""
    import json

    from morphablegraphs_tpu_torch.serve import rest
    graph = _toy_graph()
    draw = walk.torch_sampler

    def host_draws(gen, g, n_chars, n_samples):
        draws = draw(torch.Generator().manual_seed(0), g, n_chars, n_samples)

        def on_device(t):
            d = draws(t)
            return walk.StepDraws(*(x.to(gen.device) for x in (
                d.comp_gumbel, d.normal, d.trans_gumbel)))
        return on_device

    body = {"requests": [_traj_request(20, 100), _traj_request(-20, 100),
                         _traj_request(0, 120), KEYFRAME_INPUT]}
    cfg = _config(n_random_samples=20, lm_iterations=1, debug_max_step=3)
    frames, answers = {}, {}
    monkeypatch.setattr(walk, "torch_sampler", host_draws)
    for dev in ("cpu", cuda):
        before = kernels.launch_counts()
        ctx = rest.MGContext(graph, dict(cfg), device=dev,
                             sampler=_host_sampler(graph, 7))
        bg = ctx.batched_generator()
        bg.n_steps, bg.lm_iters = 3, 1  # the toy size
        status, _, payload = rest.make_app(ctx)(
            "POST", "/run_morphablegraphs_batch", json.dumps(body).encode())
        assert status == 200
        answers[str(dev)] = json.loads(payload)["results"]
        frames[str(dev)] = bg.generate_batch(body["requests"][:3])
    _assert_launched(before, (B1,) + REQUEST_KERNELS)
    card = answers[str(cuda)]
    assert [r["batched"] for r in card] == [True, True, True, False]
    for r, f in zip(card, frames[str(cuda)]):
        assert r["bvh"] == sk.write_bvh(graph.skeleton, f)
    for a, b in zip(frames[str(cuda)], frames["cpu"]):
        assert np.all(np.isfinite(a))
        _report("batch", "frames gap", _frames_gap(a, b), FRAMES_ATOL)


def _write_clips(folder):
    """12 BVH clips of the toy leftStance primitive (unit quaternions) in
    folder -> folder."""
    from morphablegraphs_tpu_torch.models import primitive as prim_mod
    folder.mkdir()
    prim = prim_mod.load_primitive_json(
        synthetic.make_legacy_model_json(seed=9, n_joints=4), device="cpu")
    skel = sk.load_bvh(synthetic.TEST_BVH)[0]
    lat = prim_mod.sample_latent(torch.Generator().manual_seed(0), prim, 12)
    for i in range(12):
        f, n, _ = prim_mod.back_project(prim, lat[i], 96, use_time=True)
        f = f[: int(n)].numpy().astype(np.float64)
        q = f[:, 3:].reshape(len(f), -1, 4)
        f[:, 3:] = (q / np.linalg.norm(q, axis=-1, keepdims=True)).reshape(
            len(f), -1)
        sk.write_bvh(skel, f, str(folder / f"clip{i:02d}.bvh"))
    return folder


def _train_case(cuda, tmp_path):
    """`cli train` over 12 BVH clips of the toy leftStance primitive (3
    spatial components, a 2-component EM), on the card and on the CPU:
    the fPCA fields within 1e-4 of their scale, the mixture's weights and
    means within 1e-3."""
    import json

    from morphablegraphs_tpu_torch.serve import cli
    clips = _write_clips(tmp_path / "clips")
    cfg = {"max_gmm_components": 2, "npc_temporal": 2, "n_components": 3}
    models = []
    for dev in (cuda, "cpu"):
        out = cli.train_model(str(clips), "walk_leftStance",
                              str(tmp_path / f"{dev}_mm.json"), config=cfg,
                              export_sample=False, device=dev)
        with open(out) as f:
            models.append(json.load(f))
    a, b = models
    for field_a, field_b in ((a["sspm"]["mean"], b["sspm"]["mean"]),
                             (a["sspm"]["eigen"], b["sspm"]["eigen"]),
                             (a["tspm"]["mean"], b["tspm"]["mean"]),
                             (a["tspm"]["eigen"], b["tspm"]["eigen"])):
        field_a, field_b = np.asarray(field_a), np.asarray(field_b)
        assert field_a.shape == field_b.shape
        assert np.all(np.isfinite(field_a))
        assert float(np.abs(field_a - field_b).max()) \
            <= 1e-4 * float(np.abs(field_b).max())
    order_a = np.argsort(np.asarray(a["gmm"]["means"])[:, 0])
    order_b = np.argsort(np.asarray(b["gmm"]["means"])[:, 0])
    for f in ("weights", "means"):
        np.testing.assert_allclose(np.asarray(a["gmm"][f])[order_a],
                                   np.asarray(b["gmm"][f])[order_b],
                                   rtol=0, atol=1e-3)


def _one_card_env(cuda) -> dict:
    """This process's environment for a command that sees the card `cuda`
    alone."""
    import os
    env = dict(os.environ)
    index = cuda.index if cuda.index is not None \
        else torch.cuda.current_device()
    visible = env.get("CUDA_VISIBLE_DEVICES")
    env["CUDA_VISIBLE_DEVICES"] = (visible.split(",")[index] if visible
                                   else str(index))
    return env


def _model_gaps(a: dict, b: dict, prefix="") -> dict:
    """{dotted key: the largest difference over max(1, |b|)} of two model
    JSONs' numeric leaves, every field but the covariances' eigh factors
    (gmm.eigen: a function of gmm.covars, whose vectors may turn inside a
    near-degenerate eigenspace); a field of another shape -> inf."""
    assert a.keys() == b.keys(), (prefix, a.keys(), b.keys())
    out = {}
    for k in a:
        if isinstance(b[k], dict):
            out.update(_model_gaps(a[k], b[k], f"{prefix}{k}."))
            continue
        try:
            xa, xb = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
        except (TypeError, ValueError):
            continue
        if prefix + k != "gmm.eigen":
            out[prefix + k] = (
                float(np.abs(xa - xb).max(initial=0.0)
                      / max(1.0, np.abs(xb).max(initial=0.0)))
                if xa.shape == xb.shape else float("inf"))
    return out


def _ranks_case(cuda, tmp_path):
    """`cli serve --nproc 2` and `cli train --nproc 2`, each in its own
    process that sees this card alone, so that both ranks share it over
    gloo (NCCL refuses two ranks on one card), against one process on the
    card: the batch endpoint's answer on the toy zip (the same status,
    flags and fields, each BVH's frames parsed back within GROUP_ATOL; B1,
    B2, B5 and the emit kernel launched on both ranks; a stop ends both
    ranks with exit code 0), and the model trained on 12 clips (one model
    file and its sample, every array within GROUP_ATOL of its scale)."""
    import json
    import os
    import queue
    import re
    import signal
    import subprocess
    import sys
    import threading
    import urllib.request

    from morphablegraphs_tpu_torch.models.zip_writer import write_graph_zip
    from morphablegraphs_tpu_torch.serve import cli, rest
    timeout = 600  # a command's start, a call, a stop
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    command = [sys.executable, "-m", "morphablegraphs_tpu_torch.serve.cli"]
    layout = re.compile(r"2 ranks over gloo \(ranks share cards\): rank 0 "
                        r"on cuda:0 \(pid \d+\), rank 1 on cuda:0 "
                        r"\(pid \d+\)$")
    gd = synthetic.make_graph_dict()
    walk_d = gd["subgraphs"]["walk"]
    zip_path = write_graph_zip(
        str(tmp_path / "walk.zip"), sk.load_bvh(synthetic.TEST_BVH)[0],
        {"walk": {"nodes": {mp: n["mm"] for mp, n in walk_d["nodes"].items()},
                  "info": walk_d["info"]}},
        gd["transitions"], start_node=tuple(gd["startNode"]))
    clips = _write_clips(tmp_path / "clips")
    trained = tmp_path / "two" / "walk_mm.json"
    trained.parent.mkdir()
    env = _one_card_env(cuda)
    with open(tmp_path / "train.log", "w") as log:
        train = subprocess.Popen(
            command + ["train", str(clips), "walk_leftStance", "--output",
                       str(trained), "--device", "cuda", "--nproc", "2"],
            cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT)
    server = subprocess.Popen(
        command + ["serve", zip_path, "--port", "0", "--device", "cuda",
                   "--nproc", "2"],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines, seen = queue.Queue(), []
    threading.Thread(target=lambda: ([lines.put(x) for x in server.stdout],
                                     lines.put(None)), daemon=True).start()

    def until(part: str) -> str:
        while True:
            line = lines.get(timeout=timeout)
            assert line is not None, "".join(seen)
            seen.append(line)
            if part in line:
                return line.strip()

    trajectories = [_traj_request(20, 100), _traj_request(-20, 100),
                    _traj_request(0, 120), _traj_request(10, 110)]
    body = {"requests": trajectories + [KEYFRAME_INPUT]}
    try:
        # one process meanwhile: the batch and the training on the card
        twin = rest.make_app(rest.MGContext(
            graph_mod.load_graph(zip_path, device=cuda), device=cuda))
        w_status, _, w_payload = twin(
            "POST", "/run_morphablegraphs_batch", json.dumps(body).encode())
        direct = cli.train_model(str(clips), "walk_leftStance",
                                 str(tmp_path / "one_mm.json"), device=cuda)
        assert layout.match(until(" ranks over ")), "".join(seen)
        port = int(until("serving morphablegraphs on :").rsplit(":", 1)[1])
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/run_morphablegraphs_batch",
            data=json.dumps(body).encode(), method="POST")
        local = urllib.request.build_opener(urllib.request.ProxyHandler({}))
        with local.open(req, timeout=timeout) as r:
            status, payload = r.status, r.read()
        # the ranks walk the trajectories; rank 0 alone the keyframe request
        line = until(f"batch of {len(trajectories)} over 2 ranks: ")
        server.send_signal(signal.SIGTERM)
        assert server.wait(timeout=timeout) == 0, "".join(seen)
        assert train.wait(timeout=timeout) == 0, \
            (tmp_path / "train.log").read_text()
    finally:
        for proc in (server, train):
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=timeout)
    assert status == w_status == 200, payload[:300]
    got = json.loads(payload)["results"]
    want = json.loads(w_payload)["results"]
    assert [r["batched"] for r in got] == [True] * len(trajectories) + [
        False]
    assert len(got) == len(want)
    gap = 0.0
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        assert all(a[k] == b[k] for k in a if k != "bvh"), (a, b)
        fa, fb = (sk.bvh_to_quat_frames(*sk.load_bvh(r["bvh"]))
                  for r in (a, b))
        assert fa.shape == fb.shape and len(fa) > 30
        gap = max(gap, float(np.abs(fa - fb).max()))
    _report("ranks_on_one_card", "batch frames gap", gap, GROUP_ATOL)
    launches = json.loads(line.split("launches ", 1)[1])
    assert len(launches) == 2 and all(
        r.get(k, 0) > 0 for r in launches
        for k in (B1,) + REQUEST_KERNELS), line
    log = (tmp_path / "train.log").read_text().splitlines()
    assert layout.match(log[0]) and log[1:] == [str(trained)], log
    assert sorted(os.listdir(trained.parent)) == ["walk_mm.json",
                                                  "walk_sample.bvh"]
    with open(trained) as f, open(direct) as g:
        gaps = _model_gaps(json.load(f), json.load(g))
    assert "tspm.eigen" in gaps
    _report("ranks_on_one_card", "model gap", max(gaps.values()), GROUP_ATOL)


def _pfnn_case(cuda):
    """The PFNN crowd (`synthesis.pfnn_crowd`) at the published widths (X
    342, Y 311, hidden 512, 31 joints), 8 characters x 40 frames on their
    own paths, on the card (the frame step replayed as a CUDA graph from
    its third frame) against the CPU: frames within 1e-3 (the closed
    loop's float32 GEMMs sum in another order), frame counts equal."""
    import json
    import pathlib
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    from morphablegraphs_tpu_torch.models import pfnn
    from morphablegraphs_tpu_torch.synthesis import pfnn_crowd
    from morphablegraphs_tpu_torch.utils import profiling
    from portbench import generate, model_pfnn
    config = json.loads((root / "portbench/configs/pfnn_holden.json")
                        .read_text())
    arrays = model_pfnn.arrays(config, 3000000019)
    pts = generate.paths(5, 8, dict(path_points=6, segment_cm=400.0,
                                    heading0=0.6, turn=0.4))
    gait = torch.zeros(8, 6)
    gait[:5, 1] = 1.0
    gait[5:, 2] = 1.0
    phase = torch.linspace(0.0, 0.9, 8)
    speed = torch.where(gait[:, 2] > 0, 300.0, 150.0)
    skel = pfnn.skeleton_of(model_pfnn.JOINTS)
    out = {}
    for dev in ("cpu", cuda):
        model = pfnn.load_from_arrays(arrays["weights"], arrays["means"],
                                      device=dev)
        paths = spline_path.stack_paths([spline_path.build(
            p, unconstrained_dims=(1,), granularity=256, device=dev)
            for p in pts])
        before = profiling.counters().get("pfnn.graph_replays", 0)
        frames, n = pfnn_crowd.pfnn_crowd_walk(
            model, paths, gait.to(dev), phase.to(dev), 40, speed.to(dev),
            skeleton=skel)
        out[str(dev)] = (frames.cpu(), n.cpu(),
                         profiling.counters().get("pfnn.graph_replays", 0)
                         - before)
    (f_cpu, n_cpu, _), (f_gpu, n_gpu, replays) = out["cpu"], out[str(cuda)]
    assert torch.equal(n_cpu, n_gpu) and replays >= 38
    assert bool(torch.isfinite(f_gpu).all())
    torch.testing.assert_close(f_gpu, f_cpu, rtol=0, atol=1e-3)


ENTRY_POINTS = sorted(WALK_CASES) + [
    "batch", "boundary_rows", "cluster_tree", "package", "pfnn_crowd",
    "planner", "random_walk", "ranks_on_one_card", "request_ca",
    "request_timed", "train"]


@pytest.mark.cuda
@pytest.mark.parametrize("path", ENTRY_POINTS)
def test_entry_point_on_card_matches_cpu(cuda, path, monkeypatch, tmp_path):
    """One entry point on the card against the port on the CPU, from the
    same seed, inputs and draws (the bounds above)."""
    if path in WALK_CASES:
        _walk_case(cuda, path)
    elif path in ("random_walk", "boundary_rows"):
        _random_case(cuda, path)
    elif path.startswith("request_"):
        _request_case(cuda, path, monkeypatch)
    elif path == "cluster_tree":
        _cluster_case(cuda, monkeypatch, tmp_path)
    elif path == "package":
        _package_case(cuda, tmp_path)
    elif path == "planner":
        _planner_case(cuda)
    elif path == "pfnn_crowd":
        _pfnn_case(cuda)
    elif path == "batch":
        _batch_case(cuda, monkeypatch)
    elif path == "ranks_on_one_card":
        _ranks_case(cuda, tmp_path)
    else:
        _train_case(cuda, tmp_path)
