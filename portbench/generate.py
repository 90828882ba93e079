"""The traffic generator: everything a run feeds the program, made from the
run's seed and the numbers of a traffic file.

* `paths`: one walking path per character, as `bench.py` draws them: a
  polyline of `path_points` control points, `segment_cm` apart, from a
  heading uniform in +-`heading0` that turns by up to +-`turn` radians at
  each point (float32 control points, which both sides read);
* `walk_draws`: one walk's noise, [steps] x (Gumbel [C, n, K] for the draws'
  components, standard normals [C, n, L], Gumbel [C, N] for the
  transitions), drawn on the device by a `torch.Generator` seeded from the
  run's seed and the walk's index."""

from __future__ import annotations

import numpy as np
import torch

from .reference.walks import Draws


def stream_seed(seed: int, stream: int) -> int:
    """A generator seed for stream `stream` of a run (any whole seed)."""
    return (int(seed) * 1_000_003 + int(stream)) % (2 ** 63)


def paths(seed: int, n_chars: int, traffic: dict) -> np.ndarray:
    """Control points [C, P, 3] (float32) of every character's path."""
    rng = np.random.default_rng(stream_seed(seed, 0))
    p = traffic["path_points"]
    out = np.zeros((n_chars, p, 3), np.float32)
    for c in range(n_chars):
        x = z = 0.0
        h = rng.uniform(-traffic["heading0"], traffic["heading0"])
        for i in range(1, p):
            h += rng.uniform(-traffic["turn"], traffic["turn"])
            x += traffic["segment_cm"] * np.sin(h)
            z += traffic["segment_cm"] * np.cos(h)
            out[c, i] = (x, 0.0, z)
    return out


def walk_draws(seed: int, walk: int, n_steps: int, n_chars: int,
               n_samples: int, n_components: int, n_latent: int,
               n_nodes: int, device) -> list:
    """One walk's noise: a list of `Draws`, one per step."""
    gen = torch.Generator(device=device).manual_seed(
        stream_seed(seed, 2 ** 20 + walk))
    tiny = torch.finfo(torch.float32).tiny

    def gumbel(shape):
        u = torch.rand(shape, generator=gen, device=device)
        return -torch.log(-torch.log(torch.clamp(u, min=tiny)))

    comp = gumbel((n_steps, n_chars, n_samples, n_components))
    normal = torch.randn((n_steps, n_chars, n_samples, n_latent),
                         generator=gen, device=device)
    trans = gumbel((n_steps, n_chars, n_nodes))
    return [Draws(comp[t], normal[t], trans[t]) for t in range(n_steps)]


def rows(draws: list, idx: torch.Tensor) -> list:
    """The draws of the characters idx."""
    return [Draws(d.comp_gumbel[idx], d.normal[idx], d.trans_gumbel[idx])
            for d in draws]
