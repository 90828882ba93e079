"""Operations and bytes of the frame-emit kernel (`mg_emit_frames`): a
walk step's clips from latents.  Bytes: each input read once (latents,
the node tables of eigenvectors, means and knots, node ids, time
functions, frame counts, the previous clips' last frames) and the clips
and their last frames written once.  Operations: the coefficients
(2 per eigenvector entry of a character's node), 4 basis weights of a
cubic span per frame (~30), the 4-term blend of every channel, and with a
previous clip the alignment (~20 per frame) and the seam blend (2 per
channel of the window's frames)."""

from __future__ import annotations

from . import peaks


def count(c: int, t: int, k: int, m: int, nb: int, d: int, has_prev: bool,
          window: int = 20):
    """(flops, bytes) of one launch: C clips of T frames, K spatial
    latents, M nodes of nb coefficients x d channels."""
    n_bytes = 4 * (c * k + m * nb * d * k + m * nb * d + m * (nb + 4)
                   + 2 * c + c * t + c * t * d + c * d) \
        + (4 * c * d if has_prev else 0)
    flops = c * (2 * nb * d * k + t * (30 + 8 * d))
    if has_prev:
        flops += c * (20 * t + 2 * min(window + 1, t) * d)
    return flops, n_bytes


def bound_ms(c, t, k, m, nb, d, has_prev, window=20) -> float:
    flops, n_bytes = count(c, t, k, m, nb, d, has_prev, window)
    return peaks.bound_ms(n_bytes, flops)
