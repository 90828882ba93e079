#!/usr/bin/env python3
"""Hold this checkout's selection kernels B1 and B3 against another
checkout's, bit for bit, and time both in turns on one GPU.

    python3 morphablegraphs_tpu_torch/utils/selection_ab.py OTHER_DIR

OTHER_DIR is another checkout of the repository (an unpacked parent commit,
say).  The inputs are chip_smoke.py's selection inputs at its shapes (B1,
and B3 on the RightHand chain), made once by this checkout.  Each checkout
scores them through its own `kernels.score_locomotion_candidates`, built
from its own sources, in a process of its own, in turns: OTHER, this, this,
OTHER.  Every output must equal the first process's bit for bit.  One line
per case gives the four median CUDA-event times and this checkout's
speedup; the script exits nonzero on a difference.
"""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
REPS, ROUNDS = 20, 5  # launches per timed round; rounds per median


def _make_inputs(path):
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    device = torch.device("cuda:0")
    graph, stacked = cs._ref_model(device)
    cases = []
    for ee in (False, True):
        for label, n_chars, gran in cs.SELECTION_SHAPES:
            inputs = cs._b1_inputs(stacked, graph.skeleton, n_chars, gran,
                                   device, n_chars + gran + int(ee), ee=ee)
            name = (f"{'B3' if ee else 'B1'} {label} C={n_chars} "
                    f"G8={inputs[2].shape[1]}")
            cases.append((name, [t.cpu() for t in inputs[:4]],
                          inputs[4].cpu() if ee else None))
    torch.save(cases, path)


def _run(tree, inputs, out):
    """The checkout at `tree` scores the saved inputs -> [(case, errors,
    median ms)] saved to `out`."""
    tree = pathlib.Path(tree).resolve()
    sys.path.insert(0, str(tree))
    import torch
    from morphablegraphs_tpu_torch.ops import kernels
    if not pathlib.Path(kernels.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {kernels.__file__}, not from {tree}")
    results = []
    for name, args, chain in torch.load(inputs):
        args = [t.cuda() for t in args]
        chain = None if chain is None else chain.cuda()

        def score():
            return kernels.score_locomotion_candidates(*args, chain=chain)
        errors = score()
        times = []
        for _ in range(ROUNDS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                score()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / REPS)
        results.append((name, errors.cpu(), sorted(times)[ROUNDS // 2]))
    torch.save(results, out)


def main(other):
    import torch
    work = ROOT / "build" / "selection_ab"
    work.mkdir(parents=True, exist_ok=True)
    inputs = work / "inputs.pt"
    _make_inputs(inputs)
    runs = []
    for i, tree in enumerate((other, ROOT, ROOT, other)):
        out = work / f"run{i}.pt"
        subprocess.run([sys.executable, __file__, "--run", str(tree),
                        str(inputs), str(out)], check=True)
        runs.append(torch.load(out))
    ok = True
    for cases in zip(*runs):
        name, first = cases[0][0], cases[0][1]
        same = all(torch.equal(errors, first) for _, errors, _ in cases)
        ok = ok and same
        ms = [t for _, _, t in cases]
        print(f"{name}: {'bits equal' if same else 'DIFFERENT'}; ms other/"
              f"this/this/other {' '.join(f'{t:.4f}' for t in ms)} "
              f"(speedup {(ms[0] + ms[3]) / (ms[1] + ms[2]):.2f}x)",
              flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    if sys.argv[1] == "--run":
        _run(*sys.argv[2:5])
    else:
        main(sys.argv[1])
