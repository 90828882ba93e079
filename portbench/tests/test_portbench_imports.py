"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference imports nothing of either package."""

import ast
import pathlib
import subprocess
import sys

import helpers

FORBIDDEN = {"jax", "jaxlib", "flax", "morphablegraphs_tpu"}
PROGRAM = "morphablegraphs_tpu_torch"


def test_dry_run_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r); import helpers\n"
        "for cell in helpers.CELLS:\n"
        "    helpers.run_tiny(cell, 3000000031)\n"
        "from portbench import harness\n"
        "print(sorted({n.split('.')[0] for n in sys.modules}))\n"
        % str(pathlib.Path(__file__).parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=helpers.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert PROGRAM in loaded  # the program ran
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_reference_imports_neither_package():
    ref = helpers.ROOT / "portbench" / "reference"
    for path in ref.glob("*.py"):
        found = set(_imports(path)) & (FORBIDDEN | {PROGRAM})
        assert not found, (path.name, found)


def test_benchmark_sources_import_no_jax():
    for path in (helpers.ROOT / "portbench").rglob("*.py"):
        assert not set(_imports(path)) & FORBIDDEN, path
