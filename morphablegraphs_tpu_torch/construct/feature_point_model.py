"""Statistical models over feature points and per-semantic-class GMMs (port
of morphablegraphs_tpu.construct.feature_point_model).

Replaces reference construction/feature_point_model.py:41-225
(`FeaturePointModel{,Builder}`: a GMM over end-effector or root feature
points that scores how reachable a target is) and
construction/motion_primitive/semantic_statistical_model.py
(`SemanticStatisticalModel`: one GMM per semantic class over the latent
space).  The FK, the EM and the scores run on the model's device (CUDA
unless it is given another); sampling draws from a torch.Generator.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.skeleton import Skeleton, fk_positions
from ..ops import gmm as gmm_ops
from ..utils import device as device_mod
from . import gmm_trainer


def _fit(data, max_k: int, device) -> gmm_ops.GMM:
    model = gmm_trainer.train(data, max_k=max_k, device=device)
    return gmm_ops.from_covars(model["gmm_weights"], model["gmm_means"],
                               model["gmm_covars"], device=device)


def _log_prob(gmm: gmm_ops.GMM, x) -> float:
    return float(gmm_ops.log_prob(gmm, torch.as_tensor(
        np.asarray(x, np.float32), device=gmm.means.device)))


class FeaturePointModel:
    """GMM over a joint's positions across training clips; scores how
    reachable a target position is (reference feature_point_model.py)."""

    def __init__(self, skeleton: Skeleton, joint: str, device=None):
        self.skeleton = skeleton
        self.joint = joint
        self.device = device_mod.resolve(device, "FeaturePointModel")
        self.gmm: Optional[gmm_ops.GMM] = None

    def fit(self, motions: List[np.ndarray], keyframe: int = -1,
            max_k: int = 10):
        """The joint's position at the keyframe of every clip (one batched
        FK), then a GMM with BIC selection."""
        frames = np.stack([np.asarray(m, np.float32)[keyframe]
                           for m in motions])
        pos = fk_positions(self.skeleton, torch.as_tensor(
            frames, device=self.device))
        data = pos[:, self.skeleton.index_of(self.joint)].cpu().numpy()
        self.gmm = _fit(data, min(max_k, len(motions) - 1 or 1),
                        self.device)
        return self

    def score_target(self, position) -> float:
        """Log-likelihood of a target point under the model: the
        reachability score."""
        assert self.gmm is not None, "fit first"
        return _log_prob(self.gmm, position)

    def sample(self, generator: torch.Generator, n: int = 1) -> np.ndarray:
        assert self.gmm is not None, "fit first"
        return gmm_ops.sample(generator, self.gmm, n).cpu().numpy()


class SemanticStatisticalModel:
    """Per-semantic-class GMMs over latent parameters (reference
    semantic_statistical_model.py): sample or score given a class."""

    def __init__(self, device=None):
        self.device = device_mod.resolve(device, "SemanticStatisticalModel")
        self.class_gmms: Dict[str, gmm_ops.GMM] = {}

    def fit(self, latent_by_class: Dict[str, np.ndarray], max_k: int = 10):
        for label, data in latent_by_class.items():
            data = np.asarray(data)
            self.class_gmms[label] = _fit(
                data, min(max_k, max(len(data) - 1, 1)), self.device)
        return self

    def sample(self, generator: torch.Generator, label: str,
               n: int = 1) -> np.ndarray:
        return gmm_ops.sample(generator, self.class_gmms[label],
                              n).cpu().numpy()

    def score(self, label: str, s) -> float:
        return _log_prob(self.class_gmms[label], s)

    def classify(self, s) -> str:
        """The most likely semantic class of a latent vector."""
        best, best_ll = None, -np.inf
        for label, g in self.class_gmms.items():
            ll = _log_prob(g, s)
            if ll > best_ll:
                best, best_ll = label, ll
        return best
