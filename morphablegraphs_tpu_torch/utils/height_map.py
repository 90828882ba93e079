"""Terrain height queries from a height map (a copy of
morphablegraphs_tpu.utils.height_map: host numpy, one call per height
query of the grounding's SceneInterface).

Replaces reference utilities/height_map_interface.py:24-66 (image-based
terrain height): a 2D array of heights over an XZ extent with bilinear
interpolation, pluggable into the grounding SceneInterface.
"""

from __future__ import annotations

import numpy as np


class HeightMapInterface:
    def __init__(self, height_map: np.ndarray, origin=(0.0, 0.0),
                 scale: float = 1.0, height_scale: float = 1.0,
                 default_height: float = 0.0):
        """height_map: [H, W] heights; world x maps to columns, z to rows;
        `scale` is world units per texel."""
        self.map = np.asarray(height_map, np.float64)
        self.origin = np.asarray(origin, np.float64)
        self.scale = float(scale)
        self.height_scale = float(height_scale)
        self.default_height = float(default_height)

    def get_height(self, x: float, z: float) -> float:
        u = (x - self.origin[0]) / self.scale
        v = (z - self.origin[1]) / self.scale
        h, w = self.map.shape
        # inclusive far edge: the final texel strip interpolates from the
        # last cell instead of snapping to default_height
        if not (0 <= u <= w - 1 and 0 <= v <= h - 1):
            return self.default_height
        u0, v0 = min(int(u), w - 2), min(int(v), h - 2)
        fu, fv = u - u0, v - v0
        top = self.map[v0, u0] * (1 - fu) + self.map[v0, u0 + 1] * fu
        bot = self.map[v0 + 1, u0] * (1 - fu) + self.map[v0 + 1, u0 + 1] * fu
        return float((top * (1 - fv) + bot * fv) * self.height_scale)

    def __call__(self, x: float, z: float) -> float:
        return self.get_height(x, z)


class ImageHeightMap:
    """Height map backed by a grayscale image with the reference's exact
    coordinate mapping (utilities/height_map_interface.py:24-66): world XZ
    is centered on the image, normalized by (width, depth), scaled by
    `scale`, sampled at the nearest-lower pixel, and heights are
    pixel/255 * height_scale.  Out-of-range queries return 0.
    """

    def __init__(self, pixels: np.ndarray, width: float, depth: float,
                 scale=(1.0, 1.0), height_scale: float = 1.0):
        pixels = np.asarray(pixels)
        if pixels.ndim == 3:               # RGB(A): reference takes channel 0
            pixels = pixels[..., 0]        # (pixel_is_tuple branch)
        self.pixels = pixels.astype(np.float64)
        self.width = float(width)
        self.depth = float(depth)
        self.scale = (float(scale[0]), float(scale[1]))
        self.height_scale = float(height_scale)
        self.x_offset = 0.0
        self.z_offset = 0.0

    @classmethod
    def from_image(cls, image, width: float, depth: float, scale=(1.0, 1.0),
                   height_scale: float = 1.0) -> "ImageHeightMap":
        """image: a PIL image or anything np.asarray can consume."""
        return cls(np.asarray(image), width, depth, scale, height_scale)

    def get_height(self, x: float, z: float) -> float:
        rel_x = ((x - self.x_offset) / self.scale[0] + self.width / 2) / self.width
        rel_z = ((z - self.z_offset) / self.scale[1] + self.depth / 2) / self.depth
        if not (0.0 <= rel_x <= 1.0 and 0.0 <= rel_z <= 1.0):
            return 0.0
        h, w = self.pixels.shape
        ix = min(int(rel_x * w), w - 1)
        iy = min(int(rel_z * h), h - 1)
        return float(self.pixels[iy, ix] / 255.0 * self.height_scale)

    def __call__(self, x: float, z: float) -> float:
        return self.get_height(x, z)
