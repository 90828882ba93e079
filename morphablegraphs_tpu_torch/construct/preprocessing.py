"""Motion preprocessing helpers (port of
morphablegraphs_tpu.construct.preprocessing, the part the request path
reads): the contact bit vector's majority-vote smoothing, which grounding's
contact detection applies."""

from __future__ import annotations

import numpy as np


def smooth_bitvector(bv: np.ndarray, window: int = 5) -> np.ndarray:
    """Majority vote over a sliding window: bit i is set when more than
    window / 2 bits of the window centred on it are (np.convolve "same");
    a window of 1 or one longer than the vector returns it unchanged."""
    bv = np.asarray(bv, np.int8)
    if window <= 1 or len(bv) < window:
        return bv
    counts = np.convolve(bv, np.ones(window), mode="same")
    return (counts > window / 2).astype(np.int8)
