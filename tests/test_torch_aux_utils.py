"""The port's host utilities against the JAX package's: jsonpath editing,
both height maps on a grid of query points (the same heights exactly:
both are the same float64 numpy)."""

import copy
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu.utils import height_map as hmj  # noqa: E402
from morphablegraphs_tpu.utils import jsonpath as jpj  # noqa: E402
from morphablegraphs_tpu_torch.utils import height_map as hmt  # noqa: E402
from morphablegraphs_tpu_torch.utils import jsonpath as jpt  # noqa: E402

DEMO_INPUT = os.path.join(os.path.dirname(__file__), "..", "examples",
                          "demo_input.json")
PATHS = ("elementaryActions[0].action",
         "elementaryActions[0].constraints[0].trajectoryConstraints[1]"
         ".position",
         "elementaryActions[-1].constraints[0].joint",
         "startPose.position[2]")


def _demo():
    with open(DEMO_INPUT) as f:
        return json.load(f)


@pytest.mark.parametrize("path", PATHS)
def test_jsonpath_matches_jax(path):
    """get, set and delete give JAX's values and leave JAX's documents."""
    data = _demo()
    assert jpt._tokens(path) == jpj._tokens(path)
    assert jpt.get_value(data, path) == jpj.get_value(data, path)
    a, b = copy.deepcopy(data), copy.deepcopy(data)
    assert jpt.set_value(a, path, [1, 2]) == jpj.set_value(b, path, [1, 2])
    assert jpt.delete_value(a, path) == jpj.delete_value(b, path)
    with pytest.raises(KeyError):
        jpt.get_value(data, "startPose.missing")


def _queries():
    g = np.linspace(-45.0, 45.0, 37)
    return [(x, z) for x in g for z in g] + [(0.0, 0.0), (1e3, 0.0)]


@pytest.mark.parametrize("kwargs", [
    {}, dict(origin=(-20.0, -30.0), scale=2.5, height_scale=1.5,
             default_height=-1.0)])
def test_height_map_interface_matches_jax(kwargs):
    grid = np.random.default_rng(0).uniform(0, 10, (12, 17))
    hj, ht = hmj.HeightMapInterface(grid, **kwargs), \
        hmt.HeightMapInterface(grid, **kwargs)
    for x, z in _queries():
        assert ht(x, z) == hj(x, z) == ht.get_height(x, z)


@pytest.mark.parametrize("channels", [None, 3])
def test_image_height_map_matches_jax(channels):
    """Grayscale and RGB (channel 0) pixels, a scaled, offset extent."""
    shape = (9, 13) if channels is None else (9, 13, channels)
    pixels = np.random.default_rng(1).integers(0, 256, shape, np.uint8)
    args = (pixels, 60.0, 40.0, (1.5, 0.75), 3.0)
    hj, ht = hmj.ImageHeightMap(*args), hmt.ImageHeightMap(*args)
    hj.x_offset = ht.x_offset = 4.0
    for x, z in _queries():
        assert ht(x, z) == hj(x, z)
    ft = hmt.ImageHeightMap.from_image(pixels, 60.0, 40.0)
    fj = hmj.ImageHeightMap.from_image(pixels, 60.0, 40.0)
    assert [ft(x, z) for x, z in _queries()] == \
        [fj(x, z) for x, z in _queries()]
