"""What every driver shares: the graph dict made from the configuration and
the seed, the characters the reference judges (drawn from the seed), and
the walk loop that keeps their rows of the judged walk."""

from __future__ import annotations

import numpy as np
import torch

from .. import generate, model
from ..reference.walks import Draws


def judged_characters(seed: int, n_chars: int, n_judged: int) -> np.ndarray:
    rng = np.random.default_rng(generate.stream_seed(seed, 2 ** 40))
    return np.sort(rng.choice(n_chars, size=min(n_judged, n_chars),
                              replace=False))


def relabel(ids: torch.Tensor, src: list, dst: list) -> torch.Tensor:
    """Node ids in the labels src -> the same nodes in the labels dst (-1,
    no node, stays)."""
    table = torch.tensor([dst.index(k) for k in src] + [-1],
                         device=ids.device)
    return table[torch.where(ids < 0, len(src), ids)]


def to(draws: list, device) -> list:
    return [Draws(*(getattr(d, f).to(device) for f in
                    ("comp_gumbel", "normal", "trans_gumbel")))
            for d in draws]


class Driver:
    """A driver runs the program's entry on one walk of generated inputs
    (`run_walk(draws, observe)`; observe: the judged walk, whose internals
    a driver may look at), judges the rows it kept (`judge`) and names its
    shapes for the counts (`shapes`)."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.graph_dict = model.graph_dict(config, seed)
        self._judged = torch.as_tensor(judged_characters(
            seed, traffic["characters"], traffic["judged"]), device=device)
        self.kept = None  # the judged walk's rows, once walked

    def judged_rows(self) -> torch.Tensor:
        return self._judged

    def walk(self, index: int, keep: bool = False) -> torch.Tensor:
        """Walk `index` of the run (its own draws); with keep, the judged
        walk, keeps the judged rows of its outputs in `kept` -> its frames
        (a device scalar)."""
        draws = self.draws(index)
        frames, n_frames, ids, latents = self.run_walk(draws, keep)
        if keep:
            idx = self._judged
            self.kept = (frames[idx], n_frames[idx], ids[idx],
                         None if latents is None else latents[idx],
                         generate.rows(draws, idx))
        return n_frames.sum()

    # the name of the driver's frame rate among the end-to-end metrics
    RATE = "frames_per_s"

    def end_to_end(self, frames: float, window_s: float) -> dict:
        """The end-to-end metrics of the window but set-up."""
        return {self.RATE: frames / window_s}

    def close(self):
        pass
