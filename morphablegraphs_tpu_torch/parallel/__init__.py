"""Crowd synthesis over devices (port of morphablegraphs_tpu.parallel)."""

from .crowd import constrained_crowd_sharded, crowd_walk_sharded

__all__ = ["constrained_crowd_sharded", "crowd_walk_sharded"]
