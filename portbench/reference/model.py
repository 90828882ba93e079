"""The reference's view of the graph dict: every node's arrays worked out
again from the model JSON (translation maxima baked in, the temporal
eigensplines evaluated at the canonical frames, the mixtures' Cholesky
factors), stacked over the nodes in sorted key order, with the transition
table by type."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import ops

START, STANDARD, END = "start", "standard", "end"


@dataclasses.dataclass
class Model:
    keys: tuple  # (action, state) per node, sorted
    node_type: tuple  # per node
    n_basis: int
    n_dim: int
    k_s: int
    eigen: torch.Tensor  # [N, n_basis, n_dim, k_s]
    mean: torch.Tensor  # [N, n_basis, n_dim]
    knots: torch.Tensor  # [N, n_basis + 4]
    n_canonical: torch.Tensor  # [N] int64
    mean_t: torch.Tensor  # [N, F_max]
    eigen_t: torch.Tensor  # [N, F_max, k_t]
    weights: torch.Tensor  # [N, K]
    means: torch.Tensor  # [N, K, L]
    cov_chol: torch.Tensor  # [N, K, L, L]
    prec_chol: torch.Tensor  # [N, K, L, L]
    step_length: torch.Tensor  # [N]
    edges: dict  # (type) -> bool [N, N]
    # applied to the operands of every matrix product (the control's
    # TF32 rounding), or None
    round_fn: object = None

    def einsum(self, eq: str, *operands) -> torch.Tensor:
        if self.round_fn is not None:
            operands = [self.round_fn(x) for x in operands]
        return torch.einsum(eq, *operands)

    def index(self, state: str) -> int:
        return self.keys.index(("walk", state))


def build(graph_dict: dict, dtype=torch.float64, device="cpu",
          round_fn=None) -> Model:
    nodes, types = {}, {}
    for action, sub in graph_dict["subgraphs"].items():
        info = sub.get("info", {})
        for name, desc in sub["nodes"].items():
            nodes[(action, name)] = desc
            types[(action, name)] = (
                START if name in info.get("start_states", ()) else
                END if name in info.get("end_states", ()) else STANDARD)
    keys = tuple(sorted(nodes))
    f_max = max(int(nodes[k]["mm"]["n_canonical_frames"]) for k in keys)
    arrays = {n: [] for n in ("eigen", "mean", "knots", "n_canonical",
                              "mean_t", "eigen_t", "weights", "means",
                              "cov_chol", "prec_chol", "step_length")}
    for k in keys:
        mm = nodes[k]["mm"]
        nb, d = int(mm["n_basis_spatial"]), int(mm["n_dim_spatial"])
        f = int(mm["n_canonical_frames"])
        eigen = np.asarray(mm["eigen_vectors_spatial"], np.float64).T.copy()
        mean = np.asarray(mm["mean_spatial_vector"], np.float64).copy()
        scale = np.ones(d)
        scale[:3] = np.asarray(mm.get("translation_maxima", [1.0] * 3))
        eigen = eigen.reshape(nb, d, -1) * scale[None, :, None]
        mean = mean.reshape(nb, d) * scale
        b_t = ops.basis_matrix(
            torch.as_tensor(np.asarray(mm["b_spline_knots_time"], np.float64)),
            torch.arange(f, dtype=torch.float64)).numpy()
        mean_t = np.zeros(f_max)
        mean_t[:f] = b_t @ np.asarray(mm["mean_time_vector"], np.float64)
        t_eig = np.asarray(mm["eigen_vectors_time"], np.float64)
        eigen_t = np.zeros((f_max, t_eig.shape[1]))
        eigen_t[:f] = b_t @ t_eig
        covars = np.asarray(mm["gmm_covars"], np.float64)
        chol = np.linalg.cholesky(covars)
        prec = np.stack([np.linalg.inv(c).T for c in chol])
        for name, v in (("eigen", eigen), ("mean", mean),
                        ("knots", np.asarray(mm["b_spline_knots_spatial"],
                                             np.float64)),
                        ("n_canonical", f), ("mean_t", mean_t),
                        ("eigen_t", eigen_t),
                        ("weights", np.asarray(mm["gmm_weights"])),
                        ("means", np.asarray(mm["gmm_means"])),
                        ("cov_chol", chol), ("prec_chol", prec),
                        ("step_length",
                         nodes[k]["stats"]["average_step_length"])):
            arrays[name].append(np.asarray(v))

    def t(name, dt=dtype):
        return torch.as_tensor(np.stack(arrays[name]), dtype=dt, device=device)

    index = {f"{a}_{s}": i for i, (a, s) in enumerate(keys)}
    # an edge within an action takes its target's type, "end" for an end
    # state
    edges = {k: torch.zeros((len(keys),) * 2, dtype=torch.bool)
             for k in (START, STANDARD, END)}
    for src, dsts in graph_dict["transitions"].items():
        for dst in dsts:
            i, j = index[src], index[dst]
            edges[types[keys[j]]][i, j] = True
    eigen = t("eigen")
    return Model(keys=keys, node_type=tuple(types[k] for k in keys),
                 n_basis=eigen.shape[1], n_dim=eigen.shape[2],
                 k_s=eigen.shape[3], eigen=eigen, mean=t("mean"),
                 knots=t("knots"), n_canonical=t("n_canonical", torch.long),
                 mean_t=t("mean_t"), eigen_t=t("eigen_t"),
                 weights=t("weights"), means=t("means"),
                 cov_chol=t("cov_chol"), prec_chol=t("prec_chol"),
                 step_length=t("step_length"),
                 edges={k: v.to(device) for k, v in edges.items()},
                 round_fn=round_fn)
