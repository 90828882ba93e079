"""Phase-functioned neural network runtime (port of
morphablegraphs_tpu.models.pfnn; Holden et al., "Phase-Functioned Neural
Networks for Character Control", SIGGRAPH 2017).

A graph zip may carry PFNN weights (pfnn/weights W0..W2, b0..b2 and
pfnn/means Xmean, Ymean, Xstd, Ystd, float32 binaries).  Each weight has a
leading axis of phase control points (4), Catmull-Rom interpolated at the
character's phase; the network is three layers with ELU between them.
The crowd step evaluates every control point's layer for all characters
with one batched matmul and blends the outputs with each character's
interpolation coefficients (the interpolation is linear in the weights)."""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass
class PFNN:
    w0: torch.Tensor  # [P, H, X]
    b0: torch.Tensor  # [P, H]
    w1: torch.Tensor  # [P, H, H]
    b1: torch.Tensor  # [P, H]
    w2: torch.Tensor  # [P, Y, H]
    b2: torch.Tensor  # [P, Y]
    x_mean: torch.Tensor  # [X]
    x_std: torch.Tensor  # [X]
    y_mean: torch.Tensor  # [Y]
    y_std: torch.Tensor  # [Y]

    @property
    def n_controls(self) -> int:
        return self.w0.shape[0]


def load_from_arrays(weights: Dict[str, np.ndarray],
                     means: Dict[str, np.ndarray], n_controls: int = 4,
                     hidden: int = 512, device=None) -> PFNN:
    """The zip's flat binaries reshaped into phase-indexed tensors on
    `device` (Xstd clamped at 1e-8)."""
    x_dim = np.asarray(means["Xmean"]).shape[0]
    y_dim = np.asarray(means["Ymean"]).shape[0]

    def t(a, *dims):
        a = np.array(a, np.float32)  # a writable copy of the zip's buffer
        return torch.as_tensor(a.reshape(*dims) if dims else a, device=device)

    return PFNN(
        w0=t(weights["W0"], n_controls, hidden, x_dim),
        b0=t(weights["b0"], n_controls, hidden),
        w1=t(weights["W1"], n_controls, hidden, hidden),
        b1=t(weights["b1"], n_controls, hidden),
        w2=t(weights["W2"], n_controls, y_dim, hidden),
        b2=t(weights["b2"], n_controls, y_dim),
        x_mean=t(means["Xmean"]),
        x_std=t(np.maximum(np.asarray(means["Xstd"], np.float32), 1e-8)),
        y_mean=t(means["Ymean"]), y_std=t(means["Ystd"]))


def _catmull_rom_coeffs(n_controls: int, phase: torch.Tensor) -> torch.Tensor:
    """[N, P] weights of the control points in the cubic Catmull-Rom
    interpolation at each phase in [0, 1): control k1 = floor(phase P) and
    its neighbours k1 - 1, k1 + 1, k1 + 2 (mod P)."""
    p = n_controls
    pscaled = phase * p
    k1 = torch.floor(pscaled).to(torch.long) % p
    w = pscaled - torch.floor(pscaled)
    w2, w3 = w * w, w * w * w
    coeffs = torch.stack([-0.5 * w + w2 - 0.5 * w3,  # k1 - 1
                          1.0 - 2.5 * w2 + 1.5 * w3,  # k1
                          0.5 * w + 2.0 * w2 - 1.5 * w3,  # k1 + 1
                          -0.5 * w2 + 0.5 * w3], dim=-1)  # k1 + 2
    idx = (k1[:, None] + torch.arange(-1, 3, device=phase.device)) % p
    return torch.zeros(phase.shape + (p,), dtype=phase.dtype,
                       device=phase.device).scatter_add_(-1, idx, coeffs)


def _layer(c: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           h: torch.Tensor) -> torch.Tensor:
    """sum_p c[n, p] (w[p] @ h[n] + b[p]) for c [N, P], w [P, O, I],
    b [P, O], h [N, I] -> [N, O]: one [N, I] x [I, P O] matmul, then the
    blend over the control points."""
    p, o, i = w.shape
    z = (h @ w.reshape(p * o, i).T).reshape(-1, p, o) + b  # [N, P, O]
    return (c[:, :, None] * z).sum(dim=1)


def forward_crowd(model: PFNN, xs: torch.Tensor,
                  phases: torch.Tensor) -> torch.Tensor:
    """One step for N characters on the model's device: inputs xs [N, X]
    at phases [N] -> outputs [N, Y] (normalized in, ELU layers with the
    phase-interpolated weights, denormalized out)."""
    c = _catmull_rom_coeffs(model.n_controls, phases.to(torch.float32))
    h = (xs - model.x_mean) / model.x_std
    h = F.elu(_layer(c, model.w0, model.b0, h))
    h = F.elu(_layer(c, model.w1, model.b1, h))
    return _layer(c, model.w2, model.b2, h) * model.y_std + model.y_mean


def forward(model: PFNN, x: torch.Tensor, phase) -> torch.Tensor:
    """One character's step: x [X] at a phase -> [Y]."""
    phase = torch.as_tensor(phase, dtype=torch.float32, device=x.device)
    return forward_crowd(model, x[None], phase.reshape(1))[0]


PFNN_WEIGHT_KEYS = ("W0", "W1", "W2", "b0", "b1", "b2")
PFNN_MEAN_KEYS = ("Xmean", "Ymean", "Xstd", "Ystd")


def read_pfnn_arrays(zf) -> "dict | None":
    """{weights, means} float32 arrays from an open graph zip's pfnn/
    section; None without one.  An incomplete section raises ValueError
    naming the missing binaries."""
    names = set(zf.namelist())
    if not any(n.startswith("pfnn/") for n in names):
        return None
    paths = {k: f"pfnn/weights/{k}.bin" for k in PFNN_WEIGHT_KEYS}
    paths.update({k: f"pfnn/means/{k}.bin" for k in PFNN_MEAN_KEYS})
    missing = [p for p in paths.values() if p not in names]
    if missing:
        raise ValueError(
            f"incomplete pfnn/ section in graph zip: missing {missing}")
    return {"weights": {k: np.frombuffer(zf.read(paths[k]), np.float32)
                        for k in PFNN_WEIGHT_KEYS},
            "means": {k: np.frombuffer(zf.read(paths[k]), np.float32)
                      for k in PFNN_MEAN_KEYS}}


def read_pfnn_from_zip(zip_path: str, n_controls: int = 4,
                       hidden: int = 512, device=None):
    """The PFNN of a graph zip on `device` (the CUDA device unless given
    another), or None when it has none."""
    import zipfile

    from ..utils import device as device_mod
    with zipfile.ZipFile(zip_path, "r") as zf:
        data = read_pfnn_arrays(zf)
    if data is None:
        return None
    return load_from_arrays(data["weights"], data["means"], n_controls,
                            hidden, device=device_mod.resolve(
                                device, "read_pfnn_from_zip"))


class PFNNWrapper:
    """A phase-stepping controller with the surface MGStatePlanner drives:
    reset(position, phase, direction) and get_next_frame(target_dir).

    encode_fn(wrapper, target_dir) -> network input [X];
    decode_fn(y, wrapper) -> (quaternion frame, new position, phase
    advance).  The pair fixes the trained network's I/O layout, which the
    weight blobs alone do not define.  The network runs on the model's
    device; the state stays on the host."""

    def __init__(self, model: PFNN, encode_fn, decode_fn):
        self.model = model
        self.encode_fn = encode_fn
        self.decode_fn = decode_fn
        self.position = np.zeros(3)
        self.phase = 0.0
        self.direction = np.array([0.0, 0.0, 1.0])

    def reset(self, position, phase, direction):
        self.position = np.asarray(position, np.float64)
        self.phase = float(phase)
        self.direction = np.asarray(direction, np.float64)

    def get_next_frame(self, target_dir) -> np.ndarray:
        x = self.encode_fn(self, np.asarray(target_dir, np.float64))
        y = forward(self.model, torch.as_tensor(
            np.asarray(x, np.float32), device=self.model.w0.device),
            self.phase).cpu().numpy()
        frame, self.position, dphase = self.decode_fn(y, self)
        self.phase = float((self.phase + dphase) % 1.0)
        return np.asarray(frame, np.float32)
