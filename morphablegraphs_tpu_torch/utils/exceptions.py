"""Typed exceptions (reference utilities/exceptions.py:31-53)."""

from __future__ import annotations


class SynthesisError(RuntimeError):
    """Raised when motion synthesis fails; carries the partial frames and the
    offending latent samples (reference SynthesisError semantics)."""

    def __init__(self, message: str = "", quat_frames=None, bad_samples=None):
        super().__init__(message or "Error in synthesis")
        self.quat_frames = quat_frames
        self.bad_samples = bad_samples or []


class PathSearchError(RuntimeError):
    """Raised when the closest-point / path search fails; carries the search
    parameters (reference PathSearchError)."""

    def __init__(self, parameters=None):
        super().__init__("Error in path search")
        self.search_parameters = parameters or {}


class ConstraintError(ValueError):
    """Raised for malformed or unsatisfiable constraints; carries the bad
    constraint descriptions (reference ConstraintError)."""

    def __init__(self, message: str = "", bad_constraints=None):
        super().__init__(message or "Error in constraints")
        self.bad_constraints = bad_constraints or []
