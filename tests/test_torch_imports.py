"""The PyTorch port stands without JAX: it imports none of jax, flax, optax,
sklearn or the JAX package, and builds no kernel at import time.  It also
imports without tornado, requests and PIL, which the card's machine lacks:
the REST service runs on the standard library, and PIL is imported only
when an image height map arrives."""

import pathlib
import re
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "morphablegraphs_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in PKG.rglob("*.py") if p.name != "__init__.py")


BLOCKED = ("jax", "flax", "optax", "sklearn", "morphablegraphs_tpu",
           "tornado", "requests", "PIL")


def test_port_imports_without_jax():
    """Every module imports in a fresh interpreter where importing jax,
    flax, optax, sklearn, morphablegraphs_tpu, tornado, requests or PIL
    fails."""
    code = (
        "import sys\n"
        f"for m in {BLOCKED!r}:\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{BLOCKED!r} and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('OK', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")


def test_port_sources_name_no_jax():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|optax|sklearn|morphablegraphs_tpu)\b",
        re.MULTILINE)
    offenders = [str(p) for p in PKG.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert not offenders, offenders


def test_kernel_sources_present_and_unbuilt_at_import():
    from morphablegraphs_tpu_torch.ops import cuda_build
    names = sorted(p.name for p in cuda_build._sources())
    assert names == ["back_project.cu", "chol_solve.cu", "gmm_scores.cu",
                     "lm_delta.cu", "request_lm.cu", "score_loco.cu"]
    assert len(cuda_build.source_hash()) == 16
    for src in cuda_build._sources():
        text = src.read_text()
        # names the TPU kernel it replaces, or says that it replaces none
        assert "pallas_kernels.py" in text or "Replaces no TPU kernel" in text
        assert "cudaGetLastError" in text


def test_group_module_starts_nothing_at_import():
    """parallel/group.py (the counterpart of the JAX package's make_mesh,
    shard_crowd_inputs and replicate_model) imports without JAX and
    starts no thread, no process and no process group until launch is
    called; the package exports it."""
    code = (
        "import sys, threading\n"
        f"for m in {BLOCKED!r}:\n"
        "    sys.modules[m] = None\n"
        "import multiprocessing\n"
        "from morphablegraphs_tpu_torch import parallel\n"
        "from morphablegraphs_tpu_torch.parallel import group\n"
        "import torch.distributed as dist\n"
        "assert parallel.launch is group.launch\n"
        "assert parallel.RankGroup is group.RankGroup\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
        "assert not multiprocessing.active_children()\n"
        "assert not dist.is_initialized()\n"
        "print('OK')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "OK"
