"""Crowd synthesis over devices (port of morphablegraphs_tpu.parallel)."""
