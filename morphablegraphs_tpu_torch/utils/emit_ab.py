#!/usr/bin/env python3
"""Time this checkout's kernel B6 (crowd back-projection), its frame-emit
stage and kernel B4 (fused LM step) against another checkout's on one GPU.

    python3 morphablegraphs_tpu_torch/utils/emit_ab.py OTHER_DIR [--crowds]

OTHER_DIR is another checkout of the repository (an unpacked parent commit,
say).  The inputs are made once from a seed on the reference-scale model:
latents of 1024 characters over all nodes (and of the serving batch's 8),
the last frames of another draw's clips as the previous step's, and
[1024, 49, 28] jacobians.  Each checkout runs them through its own code,
built from its own sources, in a process of its own, in turns: OTHER, this,
this, OTHER.  The cases:

* B6: `kernels.crowd_back_project` on the checkout's own time-warped basis;
* the emit stage: what the checkout's constrained walk runs between a
  step's chosen latents and its aligned frames.  A checkout that has
  `kernels.emit_frames` runs the time warp and that kernel; an older one
  runs the time warp, the basis passes, B6, the aligning transform, the
  seam smoothing and the gather of the last frame;
* B4: `kernels.lm_delta`.

One line a case gives, for the four processes, the device time of the port's
own kernel (its mean duration in a torch.profiler trace of 30 calls), the
device time of every kernel a call launches and their number, and this
checkout's speedup.  Outputs are held against this checkout's plain twins
(B6 and the stage: 1e-3 + 1e-5 |x|, joints within 1e-4 of the equator of
their previous quaternion left out; B4: 2e-4 + 2e-3 |x|); the script exits
nonzero on a disagreement.  With --crowds each process then runs, through
its checkout's own chip_smoke.py, one root, one lm_exact and one config-5
(random segments) crowd of 1024 characters x 8 steps under torch.profiler:
kernel launches, device busy time, stage times and mean error of a run
(about 6 minutes more on an H100; the kernels alone about 2).
"""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
REPS = 30
KERNEL_NAME = re.compile(r"\b(back_project_kernel|emit_frames_kernel|"
                         r"lm_delta\w*_kernel)\b")
WINDOW = 20


def _make_inputs(path):
    """Latents and previous frames from the reference-scale model's own
    mixtures, B4's systems from a seed (CPU tensors)."""
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from morphablegraphs_tpu_torch.ops import kernels
    from morphablegraphs_tpu_torch.synthesis import walk
    _, stacked = cs._ref_model("cpu")
    cases = []
    for c, t_max in ((1024, 160), (8, 64)):
        node, s = cs._node_draws(stacked, c, "cpu", seed=20)
        node_p, s_p = cs._node_draws(stacked, c, "cpu", seed=21)
        k = stacked.k_s_max
        t_p, n_p = walk.warped_time(stacked, node_p, s_p[:, k:], t_max)
        prev = kernels.emit_frames_ref(
            s_p[:, :k].contiguous(), stacked.eigen_s, stacked.mean_s,
            stacked.knots_s, node_p, t_p, n_p, None, False, 0)[1]
        if c == 1024:
            cases.append((f"B6 crowd_back_project [{c}, T {t_max}]",
                          (node, s, torch.tensor(t_max))))
        cases.append((f"emit stage [{c}, T {t_max}]",
                      (node, s, torch.tensor(t_max), prev)))
    gen = torch.Generator().manual_seed(6)
    c = 1024
    cases.append((f"B4 lm_delta [{c}, 49, 28]", (
        torch.randn((c, 49, 28), generator=gen),
        torch.randn((c, 49), generator=gen),
        10.0 ** (torch.rand(c, generator=gen) * 4.0 - 3.0),
        0.1 + 3.9 * torch.rand(c, generator=gen))))
    torch.save(cases, path)


def _case_fn(name, args, stacked, mods):
    """The call of one case with the checkout's modules -> a function that
    returns one output tensor."""
    import torch
    kernels, walk, align = mods
    k = stacked.k_s_max
    if name.startswith("B4"):
        return lambda: kernels.lm_delta(*args)
    node, s, t_max = args[0], args[1], int(args[2])
    alpha = s[:, :k].contiguous()
    if name.startswith("B6"):
        basis, _ = walk.warped_basis(stacked, node, s[:, k:], t_max)
        return lambda: kernels.crowd_back_project(
            alpha, stacked.eigen_s, stacked.mean_s, basis, mix_id=node)
    prev = args[3]
    if hasattr(kernels, "emit_frames"):
        def stage():
            t_fn, n_frames = walk.warped_time(stacked, node, s[:, k:], t_max)
            frames, last = kernels.emit_frames(
                alpha, stacked.eigen_s, stacked.mean_s, stacked.knots_s,
                node, t_fn, n_frames, prev, True, WINDOW)
            return torch.cat([frames, last[:, None]], dim=1)
        return stage

    def old_stage():  # the walk's step end before the emit kernel
        frames, n_frames = walk.back_project_node(stacked, node, s, t_max)
        q_y, delta = align.node_aligning_2d_transform(prev, frames[:, 0])
        aligned = align.smooth_transition(
            prev, align.transform_frames(frames, q_y, delta), WINDOW)
        last_idx = torch.clamp(n_frames - 1, min=0).long()
        last = aligned[torch.arange(len(node), device=node.device), last_idx]
        return torch.cat([aligned, last[:, None]], dim=1)
    return old_stage


def _run(tree, inputs, out, crowds):
    """The checkout at `tree` runs the saved inputs -> [(case, output, the
    port kernel's device ms, all kernels' device ms a call, launches a
    call)] saved to `out`; with crowds == "1" it then profiles its crowds."""
    tree = pathlib.Path(tree).resolve()
    sys.path.insert(0, str(tree))
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    from morphablegraphs_tpu_torch.ops import align, kernels
    from morphablegraphs_tpu_torch.synthesis import walk
    for mod in (kernels, cs):
        if not pathlib.Path(mod.__file__).resolve().is_relative_to(tree):
            raise RuntimeError(f"imported {mod.__file__}, not from {tree}")
    device = torch.device("cuda:0")
    graph, stacked = cs._ref_model(device)
    cuda = torch.autograd.DeviceType.CUDA
    results = []
    for name, args in torch.load(inputs):
        fn = _case_fn(name, [a.to(device) for a in args], stacked,
                      (kernels, walk, align))
        result = fn()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == cuda]
        mine = [e.time_range.elapsed_us() for e in events
                if KERNEL_NAME.search(e.name)]
        if not mine:
            raise RuntimeError(f"{name}: no kernel of the port in the trace")
        results.append((name, result.cpu(), sum(mine) / len(mine) / 1e3,
                        sum(e.time_range.elapsed_us() for e in events)
                        / REPS / 1e3, len(events) / REPS))
    torch.save(results, out)
    if crowds != "1":
        return
    for name in ("root", "lm_exact"):
        seconds, *_, crowd = cs.phase_crowd(name, stacked, graph.skeleton,
                                            device, "this card", reps=1)
        cs.phase_profile(name, crowd, seconds)
    seconds, *_, crowd = cs.phase_random_crowd("segments", stacked, device,
                                               "this card", reps=1)
    cs.phase_profile("random segments (config 5)", crowd, seconds)


def _twin(name, args, stacked):
    """This checkout's plain twin of a case on the CPU, and the mask of the
    elements held to it."""
    import torch
    import chip_smoke as cs
    from morphablegraphs_tpu_torch.ops import kernels
    from morphablegraphs_tpu_torch.synthesis import walk
    if name.startswith("B4"):
        twin = kernels.lm_delta_ref(*args)
        return twin, torch.ones_like(twin, dtype=torch.bool), (2e-4, 2e-3)
    node, s, t_max = args[0], args[1], int(args[2])
    k = stacked.k_s_max
    alpha = s[:, :k].contiguous()
    t_fn, n_frames = walk.warped_time(stacked, node, s[:, k:], t_max)
    prev = args[3] if len(args) > 3 else None
    ref_args = (alpha, stacked.eigen_s, stacked.mean_s, stacked.knots_s,
                node, t_fn, n_frames, prev, prev is not None, WINDOW)
    frames, last = kernels.emit_frames_ref(*ref_args)
    if prev is None:
        return frames, torch.ones_like(frames, dtype=torch.bool), \
            (cs.B6_ATOL, cs.B6_RTOL)
    skip = cs._near_equator(ref_args, frames)
    keep = torch.cat([torch.ones((len(node), 3), dtype=torch.bool),
                      (~skip).repeat_interleave(4, dim=1)], dim=1)
    twin = torch.cat([frames, last[:, None]], dim=1)
    return twin, keep[:, None].expand_as(twin), (cs.B6_ATOL, cs.B6_RTOL)


def main(other, crowds: bool):
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    work = ROOT / "build" / "emit_ab"
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
    _, stacked = cs._ref_model("cpu")
    ok = True
    for (name, args), cases in zip(torch.load(inputs), zip(*runs)):
        twin, keep, (atol, rtol) = _twin(name, args, stacked)
        errs, good = [], True
        for _, out, *_ in cases:
            err = (out - twin).abs() * keep
            errs.append(float(err.max()))
            good = good and bool((err <= atol + rtol * twin.abs()).all())
        ok = ok and good
        own = [c[2] for c in cases]
        every = [c[3] for c in cases]
        print(f"{name}: {'within' if good else 'OUTSIDE'} {atol}+{rtol}*|x| "
              f"of the twin ({int((~keep).sum())} elements near a hemisphere "
              f"flip left out; max abs err other/this/this/other "
              f"{' '.join(f'{e:.2e}' for e in errs)}); the port kernel's "
              f"device ms {' '.join(f'{t:.4f}' for t in own)} (speedup "
              f"{(own[0] + own[3]) / (own[1] + own[2]):.2f}x); all kernels "
              f"of a call, device ms {' '.join(f'{t:.4f}' for t in every)} "
              f"(speedup {(every[0] + every[3]) / (every[1] + every[2]):.2f}"
              f"x), launches a call "
              f"{' '.join(f'{c[4]:.1f}' for c in cases)}", flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    if sys.argv[1] == "--run":
        _run(*sys.argv[2:6])
    else:
        main(sys.argv[1], "--crowds" in sys.argv[2:])
