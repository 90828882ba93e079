"""Operations and bytes of the PFNN's three phase-functioned layers, for
the work and not for an implementation: each layer of N characters,
input width I and output width O evaluates all P control points (cubic
Catmull-Rom weights are non-zero on all four when P = 4) and blends them,
2 P I O + 3 P O operations a character (the products, the biases, the
blend); the ELU between layers is left out.  Bytes: each control point's
weights and biases read once, a layer's input read and output written
once.  At Holden's widths (X 342, Y 311, hidden 512, P 4) that is
8 (342 512 + 512 512 + 512 311) + 3 4 (512 + 512 + 311) = 4,787,860
operations a character and a frame."""

from __future__ import annotations

from . import peaks


def layer(n: int, i: int, o: int, p: int):
    """(flops, bytes) of one layer over N characters."""
    return (n * (2 * p * i * o + 3 * p * o),
            4 * (p * o * i + p * o + n * i + n * o))


def net(n: int, x: int, h: int, y: int, p: int):
    """(flops, bytes) of one frame's network over N characters."""
    parts = [layer(n, x, h, p), layer(n, h, h, p), layer(n, h, y, p)]
    return sum(f for f, _ in parts), sum(b for _, b in parts)


def net_bound_ms(n: int, x: int, h: int, y: int, p: int) -> float:
    """The least time one frame's network could take on an H100."""
    flops, n_bytes = net(n, x, h, y, p)
    return peaks.bound_ms(n_bytes, flops)


def walk_flops(n: int, frames: int, x: int, h: int, y: int, p: int) -> float:
    """The network's operations of one walk of N characters."""
    return float(frames * net(n, x, h, y, p)[0])
