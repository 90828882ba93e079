"""Run one benchmark cell once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

It builds the cell's model and inputs from the seed on the card, warms the
cell's shapes up (set-up, `setup_s`), runs the program for --seconds, with
--trace 1 traces a few more walks for the per-layer metrics, judges the
outputs against the plain reference, and prints one JSON object as the
last line of standard output; the numbers compared, each beside its limit,
are the last lines of standard error.  It needs a CUDA card and exits
with 2, printing no result, without one."""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up counts from the process's first line

import argparse
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# kernel and compiler caches at fixed paths inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, str(ROOT / "build" / "cache" / sub))
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, str(ROOT))


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
            else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch
    torch.set_num_threads(1)  # one process, few threads: the host is shared
    from portbench import harness
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    spec = harness.cell_spec(bench, args.workload)
    chips = spec["cell"]["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    from morphablegraphs_tpu_torch.ops import cuda_build
    cuda_build.load_library()  # built once per checkout, then cached
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), "cuda:0", bench, spec, t_start=T0)
    found = result["notes"]["forbidden_modules"] \
        or harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    result["device"] = dict(platform="gpu",
                            kind=torch.cuda.get_device_name(0), count=chips,
                            power_limit=_power_limit(), **result["device"])
    checks = result.pop("checks")
    notes = result.pop("notes")
    print("notes " + json.dumps(notes), flush=True)
    line = dict(result, checks=checks)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
