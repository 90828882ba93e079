"""Build and load the package's CUDA kernels.

The sources in ../csrc/*.cu have a plain C interface.  At first use each is
compiled by its own nvcc process for sm_90a, all started together, and the
objects are linked into one shared library under
<repo>/build/kernels/<source hash>/, loaded with ctypes; a later process
finds the library by the same hash and skips the build.  Nothing here runs at
import time."""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading

_CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
_BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None


class KernelError(RuntimeError):
    """A kernel could not run: its build or load failed, it returned a
    CUDA error, or its wrapper has no kernel for the tensor's device.
    Not a fault of the request or input that reached the kernel."""


def _sources():
    return sorted(_CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources() + sorted(_CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise KernelError("no CUDA toolkit found (CUDA_HOME unset and no "
                           "nvcc on PATH): cannot build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _declare(lib):
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.mg_score_loco.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, vp]
    lib.mg_score_loco_ee.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, i,
                                     i, vp]
    lib.mg_chol_solve.argtypes = [vp, vp, vp, i, i, vp]
    lib.mg_lm_delta.argtypes = [vp, vp, vp, vp, vp, i, i, i, f, vp]
    lib.mg_back_project.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, i, i,
                                    i, vp]
    lib.mg_emit_frames.argtypes = [vp] * 10 + [i] * 8 + [vp]
    lib.mg_gmm_scores.argtypes = [vp, vp, vp, vp, vp, vp, vp, i, i, i, i, vp]
    lib.mg_request_lm.argtypes = [vp, vp, vp, vp]
    lib.mg_request_lm_check.argtypes = [vp, i]
    for fn in (lib.mg_score_loco, lib.mg_score_loco_ee, lib.mg_chol_solve,
               lib.mg_lm_delta, lib.mg_back_project, lib.mg_emit_frames,
               lib.mg_gmm_scores, lib.mg_request_lm,
               lib.mg_request_lm_check):
        fn.restype = i
    return lib


def _run_all(cmds):
    """Run the commands concurrently; raise with the first failure's
    output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [(proc.communicate()[0], proc.returncode) for proc in procs]
    for cmd, (out, rc) in zip(cmds, outs):
        if rc != 0:
            raise KernelError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")


def load_library():
    """The compiled kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        out_dir = so.parent
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            # build in a private directory, then rename the library: a
            # concurrent or cut build never leaves a half-written library
            # under the final name
            with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
                nvcc = _nvcc()
                objs = [os.path.join(tmp, src.stem + ".o")
                        for src in _sources()]
                _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
                          for src, obj in zip(_sources(), objs)])
                lib = os.path.join(tmp, "libmg_kernels.so")
                _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
                os.replace(lib, so)
        try:
            _lib = _declare(ctypes.CDLL(str(so)))
        except OSError as e:
            raise KernelError(f"cannot load {so}: {e}") from e
        return _lib


def library_path() -> pathlib.Path:
    """Where the library of the current sources is (or will be) built."""
    return _BUILD_ROOT / source_hash() / "libmg_kernels.so"


def check(err: int, what: str):
    """Raise KernelError on a nonzero cudaError_t returned by a C entry
    point."""
    if err != 0:
        raise KernelError(f"{what}: CUDA error {err}")
