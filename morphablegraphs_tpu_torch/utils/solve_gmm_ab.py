#!/usr/bin/env python3
"""Time this checkout's kernels B2 (crowd Cholesky solve), B4 (fused LM
step) and B5 (GMM log-likelihood) against another checkout's on one GPU.

    python3 morphablegraphs_tpu_torch/utils/solve_gmm_ab.py OTHER_DIR [--crowds]

OTHER_DIR is another checkout of the repository (an unpacked parent commit,
say).  The inputs are made once from a seed at the crowd's and the serving
batch's shapes ([1024 | 8, 28, 28] systems, [.., 49, 28] jacobians, rows
under 4 mixtures of K 5, D 28).  Each checkout runs them through its own
wrappers, built from its own sources, in a process of its own, in turns:
OTHER, this, this, OTHER.  Every output must lie within its kernel's bound
of this checkout's plain twin (B2, B4: 2e-4 + 2e-3 |x|; B5: 1e-3 +
1e-4 |x|).  One line per case gives the four device times (the kernel's
mean duration in a torch.profiler trace of 50 launches), this checkout's
speedup, and the four CUDA-event times around the wrapper; the script
exits nonzero on a disagreement.  With --crowds each process then runs its
checkout's exact-LM crowds (chip_smoke.py's `lm_exact` and `ee_exact`, 1024
characters x 8 steps) once under torch.profiler through that checkout's own
chip_smoke.py, which prints the run's kernel launches, device busy time,
stage times and the port's kernels (the checkouts may differ in how the
LM's GMM term is evaluated); that takes about 20 minutes on an H100, the
kernels alone about 3.
"""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
REPS = 50
KERNEL_NAME = re.compile(r"\b(chol_solve\w*_kernel|lm_delta_kernel|"
                         r"gmm_scores_kernel)\b")
BOUNDS = {"B2": (2e-4, 2e-3), "B4": (2e-4, 2e-3), "B5": (1e-3, 1e-4)}


def _make_inputs(path):
    import torch
    gen = torch.Generator().manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=gen)

    cases = []
    for c in (1024, 8):
        j = randn(c, 40, 28)
        a = torch.bmm(j.transpose(1, 2), j) + 0.1 * torch.eye(28)
        cases.append((f"B2 chol_solve [{c}, 28, 28]", (a, randn(c, 28))))
        lam = 10.0 ** (torch.rand(c, generator=gen) * 4.0 - 3.0)
        rad = 0.1 + 3.9 * torch.rand(c, generator=gen)
        cases.append((f"B4 lm_delta [{c}, 49, 28]",
                      (randn(c, 49, 28), randn(c, 49), lam, rad)))
        w = torch.softmax(randn(4, 5), -1)
        mu = randn(4, 5, 28)
        prec = torch.eye(28) + 0.06 * randn(4, 5, 28, 28)
        mix = torch.arange(c) % 4
        x = mu[mix, 0] + 1.5 * randn(c, 28)
        cases.append((f"B5 gmm_nll_and_grad [{c}, K 5, D 28]",
                      (x, w, mu, prec, mix)))
        cases.append((f"B5 gmm_scores [{c}, K 5, D 28]",
                      (x, w, mu, prec, mix)))
    torch.save(cases, path)


def _calls(kernels, name):
    """(the wrapper, its twin) for a case name."""
    if name.startswith("B2"):
        return kernels.chol_solve, kernels.chol_solve_unrolled
    if name.startswith("B4"):
        return kernels.lm_delta, kernels.lm_delta_ref
    if "gmm_scores" in name:
        return (lambda *a: kernels.gmm_scores(*a[:4], mix_id=a[4]),
                lambda *a: kernels.gmm_scores_ref(*a[:4], mix_id=a[4]))
    return (lambda *a: _joined(kernels.gmm_nll_and_grad(*a)),
            lambda *a: _joined(kernels.gmm_nll_and_grad_ref(*a)))


def _joined(pair):
    import torch
    return torch.cat([pair[0][:, None], pair[1]], dim=1)


def _run(tree, inputs, out, crowds):
    """The checkout at `tree` runs the saved inputs -> [(case, output,
    device ms, event ms)] saved to `out`; with crowds == "1" it then
    profiles its exact-LM crowds."""
    tree = pathlib.Path(tree).resolve()
    sys.path.insert(0, str(tree))
    import torch
    from torch.profiler import ProfilerActivity, profile
    from morphablegraphs_tpu_torch.ops import kernels
    if not pathlib.Path(kernels.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {kernels.__file__}, not from {tree}")
    cuda = torch.autograd.DeviceType.CUDA
    results = []
    for name, args in torch.load(inputs):
        args = [t.cuda() for t in args]
        fn = _calls(kernels, name)[0]
        result = fn(*args)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn(*args)
            torch.cuda.synchronize()
        mine = [e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == cuda and KERNEL_NAME.search(e.name)]
        if len(mine) != REPS:
            raise RuntimeError(f"{name}: {len(mine)} kernel events for "
                               f"{REPS} launches")
        results.append((name, result.cpu(), sum(mine) / REPS / 1e3,
                        start.elapsed_time(end) / REPS))
    torch.save(results, out)
    if crowds != "1":
        return
    # the exact-LM crowds of this checkout, profiled by its own chip_smoke
    import chip_smoke as cs
    device = torch.device("cuda:0")
    graph, stacked = cs._ref_model(device)
    for name in ("lm_exact", "ee_exact"):
        seconds, *_, crowd = cs.phase_crowd(name, stacked, graph.skeleton,
                                            device, "this card", reps=1)
        cs.phase_profile(name, crowd, seconds)


def main(other, crowds: bool):
    import torch
    sys.path.insert(0, str(ROOT))
    from morphablegraphs_tpu_torch.ops import kernels
    work = ROOT / "build" / "solve_gmm_ab"
    work.mkdir(parents=True, exist_ok=True)
    inputs = work / "inputs.pt"
    _make_inputs(inputs)
    runs = []
    for i, tree in enumerate((other, ROOT, ROOT, other)):
        out = work / f"run{i}.pt"
        print(f"== process {i}: the checkout at {tree}", flush=True)
        subprocess.run([sys.executable, __file__, "--run", str(tree),
                        str(inputs), str(out), str(int(crowds))], check=True)
        runs.append(torch.load(out))
    ok = True
    for (name, args), cases in zip(torch.load(inputs), zip(*runs)):
        twin = _calls(kernels, name)[1](*args)
        atol, rtol = BOUNDS[name[:2]]
        errs = [float((out - twin).abs().max()) for _, out, _, _ in cases]
        good = all(bool(((out - twin).abs() <= atol + rtol * twin.abs()).all())
                   for _, out, _, _ in cases)
        ok = ok and good
        dev = [t for _, _, t, _ in cases]
        evt = [t for _, _, _, t in cases]
        print(f"{name}: {'within' if good else 'OUTSIDE'} {atol}+{rtol}*|x| "
              f"of the twin (max abs err other/this/this/other "
              f"{' '.join(f'{e:.2e}' for e in errs)}); device ms "
              f"{' '.join(f'{t:.4f}' for t in dev)} (speedup "
              f"{(dev[0] + dev[3]) / (dev[1] + dev[2]):.2f}x); events ms "
              f"around the wrapper {' '.join(f'{t:.4f}' for t in evt)}",
              flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    if sys.argv[1] == "--run":
        _run(*sys.argv[2:6])
    else:
        main(sys.argv[1], "--crowds" in sys.argv[2:])
