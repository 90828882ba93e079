"""The benchmark's own tests: CPU checks of its generator, reference,
readers, counts and result line, and `cuda`-marked runs of each cell,
which decide inside the test whether a card is there and skip without
one.  On the card: `python -m pytest --noconftest -o addopts="" -p
no:cacheprovider portbench/tests -m cuda` (the cuda marker is registered
here, and again by -o markers on a machine without this conftest)."""

import sys
import pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA device; skips without one")
