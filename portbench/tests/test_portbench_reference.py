"""The traffic generator and the plain reference against the program's
CPU path (its kernels' plain twins), at a small size on one seed."""

import numpy as np
import pytest
import torch

from portbench import generate, model
from portbench.reference import model as ref_model

import helpers


@pytest.mark.parametrize("cell", helpers.CELLS)
def test_program_agrees_with_reference(cell):
    res = helpers.run_tiny(cell, 3000000019)
    assert res["correct"], res["checks"]
    notes = res["notes"]
    assert notes["nodes_wrong"] == 0
    gap = notes.get("emit_gap", notes.get("frames_gap"))
    assert gap < 1e-3  # float32 clips of root positions up to ~2 m
    if cell.endswith("crowd_root"):
        assert notes["selection_wrong"] == 0
        assert notes["lm_steps"] > 0 and abs(notes["lm_shortfall"]) < 0.05


def test_generator_is_a_function_of_the_seed():
    tr = helpers.tiny_spec("ref_walk.crowd_root")["traffic"]
    a, b = generate.paths(5, 4, tr), generate.paths(5, 4, tr)
    assert np.array_equal(a, b) and a.dtype == np.float32
    assert not np.array_equal(a, generate.paths(6, 4, tr))
    big = 2 ** 31 + 12345
    d1 = generate.walk_draws(big, 0, 2, 3, 4, 5, 28, 4, "cpu")
    d2 = generate.walk_draws(big, 0, 2, 3, 4, 5, 28, 4, "cpu")
    d3 = generate.walk_draws(big, 1, 2, 3, 4, 5, 28, 4, "cpu")
    assert torch.equal(d1[1].normal, d2[1].normal)
    assert not torch.equal(d1[1].normal, d3[1].normal)
    assert d1[0].comp_gumbel.shape == (3, 4, 5)
    assert d1[0].trans_gumbel.shape == (3, 4)


def test_model_matches_the_synthetic_builder_shape():
    cfg = helpers.tiny_spec("ref_walk.crowd_root")["config"]
    gd = model.graph_dict(cfg, 11)
    m = ref_model.build(gd)
    assert m.n_dim == cfg["n_dim"] == 3 + 4 * cfg["n_joints"]
    assert m.k_s == cfg["k_s"] and m.n_basis == cfg["n_basis_spatial"]
    assert m.means.shape[-1] == cfg["k_s"] + cfg["k_t"]
    assert sorted(m.n_canonical.tolist()) == sorted(
        cfg["n_canonical_frames"] + cfg["frames_step"] * i for i in range(4))
    # near-unit quaternions: the mean's exactly, a draw's within a few %
    q = m.mean[..., 3:].reshape(4, cfg["n_basis_spatial"], -1, 4)
    assert float((q.norm(dim=-1) - 1).abs().max()) < 1e-12
    coeffs = m.mean + torch.einsum("nbdk,k->nbd", m.eigen,
                                   m.means[0, 0, : m.k_s])
    norms = coeffs[..., 3:].reshape(4, cfg["n_basis_spatial"], -1, 4).norm(
        dim=-1)
    assert float((norms - 1).abs().max()) < 0.25
    assert model.REF_BVH.count("JOINT") + 1 == cfg["n_joints"]
