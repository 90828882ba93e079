#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (morphablegraphs_tpu_torch) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, one line each (or a few):
  1. the CUDA device, and the card's name and power limit from nvidia-smi;
  2. the kernel build (one nvcc per source, sm_90a) and its seconds, and
     the registers and local memory (spills) cuobjdump reads from the
     library for each instance of every kernel;
  3. kernel B1 (locomotion candidate scoring) against its plain PyTorch twin
     at the crowd shapes (1024 characters x 128 candidates, arc tables of
     264 and 1008 rows) and at the serving batch's (8 x 128, 1008 rows),
     with the kernel's device time (`device_ms`: its own mean duration in a
     torch.profiler trace; shares of bound and the JSON line use it), the
     CUDA-event time around its wrapper (`kernel_ms`, which holds the
     wrapper's host cost) and around the twin, the kernel's bound and its
     share of it (every kernel phase prints both times); then B1's time at
     every lanes-per-candidate layout at those shapes and at batches of 16
     to 256 characters (1008 rows), beside the layout the wrapper picks;
  4. kernel B2 (crowd Cholesky solve) against its twin at [1024, 28, 28]
     and at the serving batch's [8, 28, 28], beside torch.linalg.solve_ex
     on the same systems;
  5. kernel B3 (B1 plus a RightHand end-effector keyframe) against its twin
     at the same three shapes, and on a chain with a fixed, rest-rotated
     joint;
  6. kernel B4 (the fused LM step) against its twin at [1024, 49, 28];
  7. kernel B5 (the GMM log-likelihood and its gradient) against its twins
     at [1024 rows over all nodes, K 5, D 28] and at 8 rows, with and
     without its gradient pass;
  8. kernel B6 (the crowd back-projection) against its twin at [1024
     characters over all nodes, T 160, n_basis 16, n_dim 79, K 25] with
     time-warped bases, and at the TPU kernel's shared-operand signature;
     then the frame-emit kernel of the same source (`kernels.emit_frames`:
     basis weights, back-projection, aligning transform, seam smoothing)
     against its twin at that shape with and without a previous clip, with
     a node id outside the table, and at the serving shape [8, T 64];
     joints whose hemisphere dot lies within EMIT_DOT_EPS of 0 in the twin
     may take either sign and are counted, not compared;
  9. the serving entry point, BatchedGenerator on the reference-scale model,
     answers 8 trajectory requests with the exact LM through
     parallel.constrained_crowd_sharded; B1, B2, B5 and the emit kernel
     must have launched;
 10. small walks on the GPU path against the same walks on the CPU path
     (the kernels' twins) with the same random draws: root-only without
     and with the frozen LM, the ee walk, the exact-LM walk, the ee walk
     with the fused LM step, the general selection walk, the families walk
     (every constraint family and the half step), the random walks
     (concatenating and segment form) and the boundary-row constrained walk;
 11. the benchmark crowds, 1024 characters x 8 steps, 128 candidates, 160
     frames per step, 3 LM iterations, threshold 5.0, as bench.py runs
     them: the root-only headline (frozen LM), `ee` (a RightHand keyframe,
     frozen-ee LM), `ee` with the fused LM step (B4 instead of B2),
     `lm_exact` and `ee_exact` (the exact LM), and `families` (look-at,
     joint rotation, relative transform, the transition pose, two CA slots
     and a trajectory set on the hands, with the half step, through the
     general selection path and the exact LM): frames/s, the mean
     constraint error, and the kernels each run launched; then the random
     crowds at BASELINE config 5's shape (1024 characters x 8 steps of
     random_walk_segments, 160 frames a step), in the concatenating form,
     with the random walk's largest root seam jump beside the numpy
     reference concatenation's (tests/reference_oracle.py), and on the
     canonical timeline (use_time=False), the path that gives kernel B6 a
     basis;
 12. one more root-only, ee, lm_exact, families and config-5 crowd run
     under torch.profiler: device busy and idle share, time per walk stage, the
     top kernels and each of the port's kernels (launched through ctypes,
     so no walk stage's device time counts them); then one request of each
     kind of phases 13 and 14, with its request.* ranges (plan, select, lm,
     emit, convert, ik, and phase 14's time_opt, global_opt, ca_extra,
     ik_trajectory, ground, hand_pose) and its kernel launches;
 13. the sequential request path, MotionGenerator.generate_motion on the
     reference-scale model (run after phase 9): BASELINE config 3's
     request (benchmarks/run_all.py: 50 samples, 5 LM iterations, the 8
     best starts) and the end-keyframe request of
     tests/test_motion_generator.py (30 samples, 8 LM iterations, capped
     at 4 steps; its keyframe goes through the IK post-process), once to
     warm and 3 times timed: wall seconds, p50 step latency, steps,
     average error, objective evaluations and the launches of B2, B5 and
     the emit kernel (B6's source) in each request, each above 0; B2 at
     [1, 28, 28], B5 on 1 and 50 rows of one mixture and the emit kernel
     at C = 1 (the step's and the conversion's frame counts; phase 14's
     shapes too) against their twins; both requests at one LM iteration on the GPU and the CPU path
     with the same samples (after phase 10);
 14. the rest of the request path on the reference-scale model (run after
     phase 13): "timed", phase 13's end-keyframe request with the keyframe
     at 2.5 s (30 samples, 8 LM iterations, 4 steps) under the time
     optimization, the global spatial optimization ("all", start error
     threshold 0, unit position and orientation weights) and the
     stance-table grounding, with a hand-pose overlay on its frames,
     once to warm and 3 times timed; "ca", config 3's request with a
     collision-avoidance trajectory on the Head (50 samples, 5 LM
     iterations, 8 starts, 4 steps) in the "ik" mode (trajectory IK) with
     the extra CA pass and the foot-plant grounding, run once.  Wall
     seconds, p50 step latency, steps, average error, frames, the launches
     of B2, B5 and the emit kernel, each above 0, and B5's launches inside
     the global passes (time and spatial optimization, the extra CA pass),
     above 0 in each; the keyframe's time error before and after the time
     optimization (it must not grow) and the spatial optimization's move
     of the latents (it must move them in at least one request); B5 on a window of 3 stacked
     mixtures and the emit kernel of the rebuild against their twins (with
     phase 13's kernels); both requests at one LM iteration on the GPU and
     the CPU path with the same samples up to the post-process, then the
     post-process from the GPU path's input on both, held on its stable
     frames and by its invariants (after phase 13's); the phase's seconds;
 15. the streaming planner (run after phase 14): MGStatePlanner on the
     reference-scale walk graph plus a pickRight action at its widths, one
     session through start() with this thread popping states until the
     worker ends (a control-point walk of 3 targets with an end direction
     and the end targets forced, a look-at target and an upper-body
     gesture with wrist noise; a 4-step direction walk; pickRight with an
     engine-format RightHand constraint held over a region; a hand
     collision boundary that hits once), once warm and twice timed: wall
     seconds, steps, p50 step, the launches of B2, B5 and the emit kernel
     per session (each above 0) and the shapes each gets; the session
     fails on NaN, a root seam above 5 cm, the snapped hand more than
     2 cm from its target, a limited twist outside its range, or the
     reach state's events and hold frames; the shapes phases 13-14 do
     not hold at exactly that size against their twins (the gesture's
     resampled emit); the session at one LM iteration on the GPU and the
     CPU path with the same draws; the phase's seconds.
 16. the packaged graph (run after phase 15): the reference-scale walk
     graph with a static idle primitive fitted on the card to a seeded
     clip, transition models fitted on the card on every standard edge
     (2000 pairs, 4 components) and a pfnn/ section at the published PFNN
     widths (X 342, Y 311, hidden 512, 4 control points; seeded weights),
     written by the port's zip_writer and loaded by load_graph on the card
     and on the CPU (the load times, the same nodes and tensors); phase
     13's config-3 request with use_transition_model, once warm and twice
     timed: wall seconds, p50 step, steps drawn from a transition model
     (above 0), the launches of B2, B5 and the emit kernel per request
     (each above 0) and the shapes each gets, each shape held against the
     twins; the result through write_bvh -> load_bvh ->
     bvh_to_quat_frames (roots within 1e-3 cm, unit quaternions within
     1e-4 up to sign) and retargeted to REF_BVH at twice its size on the
     card and the CPU; forward_crowd of 1024 characters on the card
     against the CPU and its time, and 100 frames of the planner's PFNN
     locomotion through PFNNWrapper; the request at one LM iteration on
     the card and the CPU with the same draws (phase 13's bounds).
 17. construction and cluster-tree search through the command line (run
     after phase 16): 100 seeded, time-warped BVH clips of the
     reference-scale leftStance primitive trained by `cli train` with the
     default config (a BIC scan over K = 1..40) on the card, each stage's
     seconds (load, spatial alignment, DTW grids, host DP, fPCA, EM/BIC),
     the model's n_basis, k_s, k_t and K, and the same training on the
     CPU held against it (the fPCA fields, the mixture, the DTW's path
     cost; the warp indices that differ counted); `cli cluster-trees` with
     configs/space_partitioning.json (10,000 samples, 4 x 4 levels) for
     every node of the reference-scale walk graph, the trees packed by
     zip_writer and loaded by load_graph on the card (seconds per node,
     the zip's size); `cli run` of phase 13's config-3 request under
     configs/cluster_tree_search_algorithm.config, once warm and twice
     timed: wall seconds, p50 step, each constrained step's pool of
     10,000 tree rows and its ms, the launches of B2, B5 and the emit
     kernel (each above 0) and their shapes, each held against its twin;
     the request at one LM iteration on the card and the CPU with the
     same trees and draws (node keys, chosen tree rows, phase 13's bounds).
 18. the service edge and the process group (run after phase 11): a
     server thread over rest.make_app(MGContext(graph, cuda)) on
     127.0.0.1 answers over HTTP, each call followed by its direct call on
     a second context with the same seed: /run_morphablegraphs with config
     3's request (warm + 2 timed); /run_morphablegraphs_batch with phase
     9's 8 trajectory requests and phase 13's keyframe request (the 8 come
     back batched, the ninth not; warm + 2); /set_configuration to phase
     14's "timed" config and a batch through the rebuilt generator;
     /set_height_map with a plain height grid (the scene's heights checked
     at the texels) and phase 14's timed request (grounding on) over it:
     every answer's frames, parsed back from its BVH, within the BVH
     round trip of the direct call's; the wall seconds of both and their
     difference (the service's own cost); B1, B2, B5 and the emit kernel
     launched per endpoint, each recorded shape held against its twin.
     Then the serving crowd over a world-size-1 NCCL group (a HashStore)
     against the direct call, and over two gloo ranks spawned on the card
     (4 characters each) with a 20-clip DTW of phase 17's clips split
     over them, against the one-process results (frames within 1e-5, node
     ids and warp indices identical); meanwhile `cli serve` of phase 16's
     zip in its own process answers config 3's request, /get_skeleton and
     a bad body (400).  Phase 12's profiles add the batch endpoint's
     direct call.
The checks of phases 3-8 and 13-17 run first (18 after 11), but their
kernel lines are printed after phase 18: a kernel's device time comes from a profiler trace, and a
process that has taken one pays more host time per launch afterwards, so the
traces wait until the host-timed phases (9-11, 13-18) are over.
Then a JSON line of per-kernel results (time, launches, error against the
twin, the bound and the one-call library time where there is one; `ms` is
the device time, `kernel_ms` the events around the wrapper), and as
the last line {"ok": true, "device": {...}}.  Any failed check exits
nonzero; without a CUDA device the script fails before it prints any
result.
"""

import bisect
import json
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

# B1 mirrors the TPU kernel's expanded |t|^2 - 2 t.p + |p|^2 distance, which
# loses ~2e-3 relative accuracy near a minimum: kernel and twin round the
# frame rows and that form in other orders and may pick a neighbouring table
# cell, which moves the advancing search floor.  Errors are ~1-100 (cm and
# degrees); the ranking is what the walk uses, so the argmin must agree.
B1_RTOL, B1_ATOL = 5e-3, 1e-1
B1_ARGMIN_AGREE = 0.99  # share of characters whose argmin must agree
B2_RTOL, B2_ATOL = 2e-3, 2e-4  # as the JAX package's crowd-solve test
# B4's deltas are clipped to radii <= 4; kernel and twin sum JtJ in other
# orders, so B2's bound holds for the solve of the same normal equations
B4_RTOL, B4_ATOL = 2e-3, 2e-4
# B5: the JAX package's bound for its Pallas kernel against XLA (fp32
# Mahalanobis sums of 28 terms in other orders); the gradient's bound is
# relative to each entry too
B5_RTOL, B5_ATOL = 1e-4, 1e-3
# B6: fp32 sums of 25 (eigen) and 16 (basis) products of values up to a few
# hundred cm, taken in other orders by kernel and twin
B6_RTOL, B6_ATOL = 1e-5, 1e-3
# the emit kernel rounds as B6 does and its epilogue adds a rotation and a
# blend of the same values: B6's bound holds.  A joint whose quaternion lies
# within EMIT_DOT_EPS of the previous frame's equator (|dot| of unit
# quaternions) may get the other sign from a last-bit difference; both are
# the same rotation, so such joints are counted and left out
EMIT_DOT_EPS = 1e-4
WALK_FRAMES_ATOL = 1e-2  # GPU vs CPU walk frames, the whole-walk bound
# the H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): HBM bytes
# and fp32 operations outside the tensor cores, for each kernel's bound
PEAK_BYTES_PER_S, PEAK_FP32_PER_S = 3.35e12, 67e12
# a table row of a search: a mul and 2 FMAs (5), 2 adds, a compare, a min
SELECTION_FLOPS_PER_ROW = 9
KERNEL_CHARS = 1024  # characters of the kernel-vs-twin checks
CROWD_CHARS, CROWD_STEPS = 1024, 8  # the benchmark crowds (bench.py)
RANDOM_FRAMES = 160  # BASELINE config 5's frames a step (run_all.py)
EE_JOINT = "RightHand"  # bench.py's ee config: a RightHand keyframe at
EE_TARGET, EE_FRAME = (20.0, 110.0, 80.0), 129.0  # canonical frame 129


def _fail(msg: str):
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        _fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int) -> float:
    """CUDA events around `reps` back-to-back calls: the larger of the
    device's and the host's time per call (a wrapper costs 10-70 us of
    Python, more than some of the kernels run)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


PORT_KERNELS = ("score_loco_kernel", "chol_solve_kernel",
                "chol_solve_smem_kernel", "lm_delta_kernel",
                "lm_delta_smem_kernel", "gmm_scores_kernel",
                "back_project_kernel", "emit_frames_kernel")
_PORT_KERNEL_RE = re.compile(r"(\w+_kernel)(<[^(]*>)?\(")


def _port_kernel(event_name: str):
    """The port's kernel a device event belongs to (with its template
    arguments), or None."""
    m = _PORT_KERNEL_RE.search(event_name)
    if m and m.group(1) in PORT_KERNELS:
        return m.group(0)[:-1]
    return None


def _device_ms(fn, reps: int, ours: bool = True) -> float:
    """Device time per call of `fn` from a torch.profiler trace of `reps`
    calls: the mean duration of the port's own kernel (it must be the only
    one of the port's that fn launches, once a call), or with ours=False
    the sum of every kernel fn launches.  Unlike `_time_ms` it holds no
    host time.  A trace may miss the first launches after it starts (seen
    in the 8th trace of a process: 9 of 20 recorded), so the mean is taken
    over the launches it holds; if it holds none (seen twice in a row in
    a process's first traces), up to three more traces are tried before
    failing."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    fn()
    for _ in range(4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == cuda]
        if ours:
            events = [e for e in events if _port_kernel(e.name)]
            if len({_port_kernel(e.name) for e in events}) > 1 \
                    or len(events) > reps:
                _fail(f"the trace holds {len(events)} launches of the "
                      f"port's kernels for {reps} calls of one")
        if events:
            # ours: the mean launch; else the calls' kernels summed (a
            # yardstick: launches the trace missed make it faster)
            return sum(e.time_range.elapsed_us() for e in events) / (
                len(events) if ours else reps) / 1e3
    _fail(f"the profiler recorded no kernel of {reps} calls")


# Kernel lines wait here for their device times: a process that has taken a
# profiler trace pays more host time per launch afterwards (crowds timed
# after the traces ran 20-40% slower than before them, on an H100's host),
# so every trace is taken after the host-timed phases.
_PENDING = []


def _kernel_line(head: str, fn, reps: int, bound_ms: float, tail,
                 result: dict):
    """Time a kernel wrapper with CUDA events now (`kernel_ms`) and queue
    its line for `_flush_kernel_lines`, which reads its device time
    (`device_ms`) and prints `head device_ms= kernel_ms= share_of_bound=
    tail`.  tail is the rest of the line, or a function of device_ms that
    returns it (for checks and yardsticks that need a trace too).  result
    gets `kernel_ms` now and `ms` (the device time) at the flush."""
    result["kernel_ms"] = _time_ms(fn, reps)
    _PENDING.append((head, fn, reps, bound_ms, tail, result))


def _flush_kernel_lines():
    for head, fn, reps, bound_ms, tail, result in _PENDING:
        ms = result["ms"] = _device_ms(fn, reps)
        print(f"{head} device_ms={ms:.4f} kernel_ms={result['kernel_ms']:.4f} "
              f"share_of_bound={bound_ms / ms:.3f} "
              + (tail(ms) if callable(tail) else tail), flush=True)
    _PENDING.clear()


def rand_path(rng, granularity: int, device):
    """bench.py's random 4-point walking path (60 cm segments)."""
    from morphablegraphs_tpu_torch.ops import spline_path
    pts = [[0.0, 0.0, 0.0]]
    x, z, h = 0.0, 0.0, rng.uniform(-0.6, 0.6)
    for _ in range(3):
        h += rng.uniform(-0.4, 0.4)
        x += 60 * np.sin(h)
        z += 60 * np.cos(h)
        pts.append([x, 0.0, z])
    return spline_path.build(np.asarray(pts, np.float32),
                             unconstrained_dims=(1,),
                             granularity=granularity, device=device)


def _ref_model(device):
    from morphablegraphs_tpu_torch.models import graph as graph_mod
    from morphablegraphs_tpu_torch.models import skeleton as sk
    from morphablegraphs_tpu_torch.utils import synthetic
    graph = graph_mod.build_graph_from_dict(
        synthetic.make_reference_scale_graph_dict())
    graph.skeleton, _ = sk.load_bvh(synthetic.REF_BVH)
    return graph, graph_mod.stack_graph(graph, device=device)


def _b1_inputs(stacked, skel, n_chars, granularity, device, seed,
               ee: bool = False):
    """Selection-kernel inputs at a walk step's shapes: random nodes,
    candidates from each node's GMM, bench paths, mid-path states; with ee,
    B3's inputs for the bench's RightHand keyframe (mop with the ee rows,
    the ee cfg slots) and its chain table as a fifth element."""
    import torch
    from morphablegraphs_tpu_torch.ops import align, kernels, spline_path
    from morphablegraphs_tpu_torch.synthesis import walk
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    paths = spline_path.stack_paths([rand_path(rng, granularity, device)
                                     for _ in range(n_chars)])
    node = torch.randint(0, stacked.n_nodes, (n_chars,), generator=gen,
                         device=device)
    u = torch.rand((n_chars, 128, stacked.gmm_weights.shape[-1]),
                   generator=gen, device=device)
    samples = walk.sample_node_latents(
        stacked, node, -torch.log(-torch.log(u.clamp(min=1e-30))),
        torch.randn((n_chars, 128, stacked.gmm_means.shape[-1]),
                    generator=gen, device=device))
    travelled = torch.rand(n_chars, generator=gen, device=device) * 60.0
    goal_arc = travelled + stacked.avg_step_length[node]
    goal_pos, goal_dir = spline_path.point_and_dir_at_arc_length(paths,
                                                                 goal_arc)
    n_can = stacked.n_canonical[node].float()
    prev = torch.zeros((n_chars, stacked.n_dim), device=device)
    prev[:, 3::4] = 1.0
    prev[:, 0] = travelled * 0.3
    prev[:, 2] = travelled
    has_prev = (torch.arange(n_chars, device=device) % 4 != 0).float()
    root_off = torch.as_tensor(skel.offsets[0], device=device)
    chain_idx = chain = None
    ee_kw = {}
    if ee:
        chain_idx, chain = kernels.pack_ee_chain(skel, EE_JOINT)
        chain = torch.as_tensor(chain, device=device)
        ones = torch.ones((n_chars, 3), device=device)
        ee_kw = dict(ee_active=1.0, ee_weight=1.0,
                     ee_target=torch.tensor(EE_TARGET, device=device) * ones,
                     ee_mask=ones)
    mop = kernels.selection_operator(
        stacked.eigen_s[node], stacked.mean_s[node], stacked.knots_s[node],
        stacked.n_basis_max, stacked.n_dim, n_can - 1.0, n_can - 1.0, n_can,
        ee_frame=torch.full_like(n_can, EE_FRAME),
        ee_chain_idx=chain_idx)
    ident = torch.tensor([1.0, 0, 0, 0], device=device).expand(n_chars, 4)
    cfg = kernels.pack_selection_cfg(
        paths, align.heading_angle(prev[:, 3:7]), prev[:, :3],
        align.heading_angle(ident), torch.zeros((n_chars, 3), device=device),
        has_prev, goal_pos, goal_dir, travelled, kf_weight=1.0,
        dir_weight=0.8, traj_active=1.0, traj_weight=1.0,
        range_lo=float("-inf"), range_hi=float("inf"), root_offset=root_off,
        **ee_kw)
    table = kernels.pack_path_table(paths, root_off)
    alphas = samples[:, :, : stacked.k_s_max].contiguous()
    out = (mop.contiguous(), alphas, table.contiguous(), cfg.contiguous())
    return out + (chain,) if ee else out


def _check_scores(name, out_k, out_t):
    """B1's bound on kernel vs twin errors -> (max abs err, summary)."""
    import torch
    torch.cuda.synchronize()
    err = (out_k - out_t).abs()
    tol = B1_ATOL + B1_RTOL * out_t.abs()
    agree = float((out_k.argmin(1) == out_t.argmin(1)).float().mean())
    summary = (f"max_abs_err={float(err.max()):.3e} "
               f"max_rel_err={float((err / out_t.abs().clamp(min=1e-6)).max()):.3e} "
               f"p99.9_abs_err={float(err.flatten().quantile(0.999)):.3e} "
               f"(tol {B1_ATOL}+{B1_RTOL}*|x|) argmin_agree={agree:.4f}")
    if not bool(torch.isfinite(out_k).all()):
        _fail(f"{name} produced non-finite errors")
    if bool((err > tol).any()) or agree < B1_ARGMIN_AGREE:
        _fail(f"{name} disagrees with its twin: {summary}")
    return float(err.max()), summary


def _bound(nbytes: float, flops: float):
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the fp32 operations over their peak -> (ms, what
    bounds it)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _selection_bound(mop, alphas, table, cfg, chain=None):
    """B1's (or with chain B3's) bound on these inputs: each input read and
    the errors written once; 9 operations for each table row the searches
    must read (valid, at or above the floor, from the twin's masks), 2 per
    coefficient of each frame row the body evaluates (60, and with a chain
    its 3 + 4L ee rows), and ~60 per chain joint -> (ms, what bounds it,
    the share of the table rows the searches read)."""
    c, n, k = alphas.shape
    rows = _rows_read(mop, alphas, table, cfg)
    frame_rows, per_joint, extra = 60, 0, (table,)
    if chain is not None:
        frame_rows += 3 + 4 * chain.shape[0]
        per_joint, extra = 60 * chain.shape[0], (table, chain)
    flops = SELECTION_FLOPS_PER_ROW * rows + c * n * (
        2 * (k + 1) * frame_rows + per_joint)
    ms, by = _bound(_nbytes(mop, alphas, cfg, *extra) + 4 * c * n, flops)
    return ms, by, rows / (c * n * 16 * table.shape[1])


def _rows_read(mop, alphas, table, cfg) -> int:
    """Table rows the 16 searches of every candidate must read on these
    inputs: the valid rows at or above each search's floor, counted from
    the masks of B1's twin."""
    from morphablegraphs_tpu_torch.ops import kernels
    rows, search = [], kernels._table_search

    def counting(*args):
        out = search(*args)
        rows.append(int((out[2] > 0).sum()))
        return out
    kernels._table_search = counting
    try:
        kernels.score_locomotion_candidates_ref(mop, alphas, table, cfg)
    finally:
        kernels._table_search = search
    return sum(rows)


# the shapes of phases 3 and 5: (label, characters, path granularity)
SELECTION_SHAPES = (("crowd", KERNEL_CHARS, 256),
                    ("crowd", KERNEL_CHARS, 1000), ("serving", 8, 1000))
# batches between the two, for the lanes sweep only (1008-row tables)
LANES_BATCHES = (16, 32, 64, 128, 256)
LANES = (1, 2, 4, 8, 16, 32)


def _lanes_sweep(label, args, n_sm):
    """B1 at every lanes-per-candidate layout on these inputs: equal bits
    at each, and times in turns (up and down the widths twice, median)."""
    import torch
    from morphablegraphs_tpu_torch.ops import kernels
    c, n, _ = args[1].shape
    ref = kernels._launch_selection(*args, None, 1)
    times = {w: [] for w in LANES}
    for order in (LANES, LANES[::-1], LANES, LANES[::-1]):
        for w in order:
            if not torch.equal(kernels._launch_selection(*args, None, w),
                               ref):
                _fail(f"B1 with {w} lanes a candidate differs from 1 lane")
            times[w].append(_time_ms(
                lambda w=w: kernels._launch_selection(*args, None, w), 20))
    med = {w: sorted(t)[len(t) // 2] for w, t in times.items()}
    pick = kernels.selection_lanes(c, n, n_sm)
    print(f"B1 {label} C={c} G8={args[2].shape[1]} kernel_ms by lanes per "
          "candidate: " + ", ".join(f"{w}: {t:.4f}" for w, t in med.items())
          + f" (picked {pick}: {med[pick]:.4f}; fastest "
          f"{min(med, key=med.get)})", flush=True)


def phase_selection(stacked, skel, device, ee: bool):
    """B1 (or with ee B3, on the RightHand chain, L = 6) against its twin
    at SELECTION_SHAPES, with its time, the twin's, its bound and its share
    of it; B1 also at every lanes-per-candidate layout there and at
    LANES_BATCHES.  B3 is checked too
    on a synthetic chain whose third joint is fixed with a 90-degree rest
    rotation (the kernel must take the rest quaternion and ignore that
    joint's operator rows).  -> (worst error, {(C, G8): the shape's results
    for the JSON line}); the kernel lines are queued (`_kernel_line`)."""
    import torch
    from morphablegraphs_tpu_torch.ops import kernels
    tag = "B3" if ee else "B1"
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    worst, results = 0.0, {}
    for label, n_chars, gran in SELECTION_SHAPES:
        # the crowd shapes keep the seeds of earlier versions of this script
        seed = gran + int(ee) + (10 if label == "serving" else 0)
        inputs = _b1_inputs(stacked, skel, n_chars, gran, device, seed,
                            ee=ee)
        args = inputs[:4]
        mop, alphas, table, _ = args
        g8 = table.shape[1]
        cases = [(None, None)]
        if ee:
            fixed = inputs[4].clone()
            half = np.deg2rad(90.0) / 2
            fixed[2, 3:7] = torch.tensor([np.cos(half), 0.0, 0.0,
                                          np.sin(half)])
            fixed[2, 7] = 0.0
            cases = [("RightHand", inputs[4]), ("fixed-joint", fixed)]
        for chain_name, ch in cases:
            out_k = kernels.score_locomotion_candidates(*args, chain=ch)
            err, summary = _check_scores(
                f"{tag} ({chain_name})" if ee else tag, out_k,
                kernels.score_locomotion_candidates_ref(*args, chain=ch))
            worst = max(worst, err)
            if chain_name == "fixed-joint":
                print(f"{tag} chain={chain_name} C={n_chars} G8={g8}: "
                      f"{summary}", flush=True)
                continue
            plain_ms = _time_ms(
                lambda: kernels.score_locomotion_candidates_ref(
                    *args, chain=ch), 3)
            bound_ms, by, frac = _selection_bound(*args, chain=ch)
            lanes = kernels.selection_lanes(n_chars, alphas.shape[1], n_sm)
            shape = (f"C={n_chars} N={alphas.shape[1]} K={alphas.shape[2]}"
                     + (f" L={ch.shape[0]} rows={mop.shape[1]}" if ee
                        else "") + f" G8={g8}")
            results[(n_chars, g8)] = dict(plain_ms=plain_ms,
                                          bound_ms=bound_ms, bound_by=by,
                                          library_ms=None)
            _kernel_line(
                f"{tag} score_locomotion_candidates{'(chain)' if ee else ''}"
                f" {label} {shape}: {summary}",
                lambda args=args, ch=ch: kernels.score_locomotion_candidates(
                    *args, chain=ch), 20, bound_ms,
                f"(bound_ms={bound_ms:.4f}, {by}; the searches read "
                f"{frac:.3f} of the table rows) lanes={lanes} "
                f"twin_ms={plain_ms:.4f}", results[(n_chars, g8)])
            if not ee:
                _lanes_sweep(label, args, n_sm)
    if not ee:
        for n_chars in LANES_BATCHES:
            _lanes_sweep("batch", _b1_inputs(stacked, skel, n_chars, 1000,
                                             device, 1000 + n_chars)[:4],
                         n_sm)
    return worst, results


SERVING_CHARS = 8  # the serving batch of phase 9
SERVING_FRAMES = 64  # its frames a step


def phase_b2(device):
    """B2 against its twin at [1024, 28, 28] and at the serving batch
    [8, 28, 28], three zero systems solving to 0; beside it
    torch.linalg.solve_ex, the one PyTorch call for the same solve (events
    around the call, and the device time of the kernels it launches).
    -> the crowd shape's results."""
    import torch
    from morphablegraphs_tpu_torch.ops import kernels
    gen = torch.Generator(device=device).manual_seed(5)
    results = {}
    for c in (KERNEL_CHARS, SERVING_CHARS):
        j = torch.randn((c, 40, 28), generator=gen, device=device)
        a = torch.bmm(j.transpose(1, 2), j) + 0.1 * torch.eye(28,
                                                              device=device)
        g = torch.randn((c, 28), generator=gen, device=device)
        a[-3:] = 0.0  # padded characters: the zero system solves to 0
        g[-3:] = 0.0
        x_k = kernels.chol_solve(a, g)
        x_t = kernels.chol_solve_unrolled(a, g)
        torch.cuda.synchronize()
        err = (x_k - x_t).abs()
        if not bool(torch.isfinite(x_k).all()) or \
                bool((err > B2_ATOL + B2_RTOL * x_t.abs()).any()):
            _fail("B2 disagrees with its twin")
        if float(x_k[-3:].abs().max()) != 0.0:
            _fail("B2: a zero system did not solve to 0")
        plain_ms = _time_ms(lambda: kernels.chol_solve_unrolled(a, g), 5)
        # the one PyTorch call for the same solve (batched LU, no info check)
        library_ms = _time_ms(lambda: torch.linalg.solve_ex(a, g), 50)
        k = a.shape[-1]
        bound_ms, by = _bound(_nbytes(a, g, x_k),
                              c * (k ** 3 / 3 + 2 * k * k))

        def tail(ms, a=a, g=g, bound_ms=bound_ms, by=by, plain_ms=plain_ms,
                 library_ms=library_ms):
            library_device_ms = _device_ms(
                lambda: torch.linalg.solve_ex(a, g), 50, ours=False)
            if ms > library_device_ms:
                _fail("B2 is slower than torch.linalg.solve_ex")
            return (f"(bound_ms={bound_ms:.5f}, {by}) twin_ms={plain_ms:.4f} "
                    f"torch.linalg.solve_ex_ms={library_ms:.4f} (its "
                    f"kernels' device_ms={library_device_ms:.4f})")

        results[c] = dict(max_abs_err=float(err.max()), plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=by,
                          library_ms=library_ms)
        _kernel_line(
            f"B2 chol_solve [{c}, 28, 28]: max_abs_err={float(err.max()):.3e} "
            f"max_rel_err={float((err / x_t.abs().clamp(min=1e-6)).max()):.3e} "
            f"(tol {B2_ATOL}+{B2_RTOL}*|x|)",
            lambda a=a, g=g: kernels.chol_solve(a, g), 50, bound_ms, tail,
            results[c])
    return results[KERNEL_CHARS]


def phase_b4(device):
    """B4 against its twin at [1024, 49, 28]: lambda spread over 1e-3..10,
    radii over 0.1..4, and three zero characters that must give delta = 0.
    Also times the unfused step block (JtJ and Jtr products, damping, the
    solve by kernel B2, the clip), the walk's default route."""
    import torch
    from morphablegraphs_tpu_torch.ops import kernels, lm
    gen = torch.Generator(device=device).manual_seed(6)
    c, n_res, k = KERNEL_CHARS, 49, 28
    j = torch.randn((c, n_res, k), generator=gen, device=device)
    r = torch.randn((c, n_res), generator=gen, device=device)
    lam = 10.0 ** (torch.rand(c, generator=gen, device=device) * 4.0 - 3.0)
    rad = 0.1 + 3.9 * torch.rand(c, generator=gen, device=device)
    j[-3:] = 0.0
    r[-3:] = 0.0
    d_k = kernels.lm_delta(j, r, lam, rad)
    d_t = kernels.lm_delta_ref(j, r, lam, rad)
    torch.cuda.synchronize()
    err = (d_k - d_t).abs()
    plain_ms = _time_ms(lambda: kernels.lm_delta_ref(j, r, lam, rad), 5)
    b2_route_ms = _time_ms(lambda: lm.lm_delta(j, r, lam, rad), 50)
    # JtJ (upper triangle), Jtr, the factor and the two substitutions
    bound_ms, by = _bound(_nbytes(j, r, lam, rad, d_k), c * (
        n_res * k * (k + 1) + 2 * n_res * k + k ** 3 / 3 + 2 * k * k))
    result = dict(max_abs_err=float(err.max()), plain_ms=plain_ms,
                  bound_ms=bound_ms, bound_by=by, library_ms=None)
    _kernel_line(
        f"B4 lm_delta [{c}, {n_res}, {k}]: max_abs_err={float(err.max()):.3e} "
        f"max_rel_err={float((err / d_t.abs().clamp(min=1e-6)).max()):.3e} "
        f"(tol {B4_ATOL}+{B4_RTOL}*|x|)",
        lambda: kernels.lm_delta(j, r, lam, rad), 50, bound_ms,
        f"(bound_ms={bound_ms:.5f}, {by}) twin_ms={plain_ms:.4f} "
        f"step_via_B2_ms={b2_route_ms:.4f}", result)
    if not bool(torch.isfinite(d_k).all()) or \
            bool((err > B4_ATOL + B4_RTOL * d_t.abs()).any()):
        _fail("B4 disagrees with its twin")
    if float(d_k[-3:].abs().max()) != 0.0:
        _fail("B4: a zero character did not give delta = 0")
    return result


def _node_draws(stacked, n_rows, device, seed, scale=1.0):
    """One GMM latent per row, rows spread over every node of the graph:
    (node ids [n_rows], latents [n_rows, L]); the normals scaled by
    `scale` reach past the mixtures."""
    import torch
    from morphablegraphs_tpu_torch.synthesis import walk
    gen = torch.Generator(device=device).manual_seed(seed)
    node = torch.arange(n_rows, device=device) % stacked.n_nodes
    d = walk.torch_sampler(gen, stacked, n_rows, 1)(0)
    return node, walk.sample_node_latent(stacked, node, d.comp_gumbel[:, 0],
                                         scale * d.normal[:, 0])


def phase_b5(stacked, device):
    """B5 against its twins at [1024, K 5, D 28] and at the serving batch's
    8 rows: rows over all nodes, drawn from their node's mixture with the
    normals scaled 1.5x; log p and the gradient of -log p within their
    bounds.  Times the value-and-gradient call the LM's linearization makes
    and the value-only call of its probes.  -> the crowd shape's results."""
    import torch
    from morphablegraphs_tpu_torch.ops import kernels
    results = {}
    for c in (KERNEL_CHARS, SERVING_CHARS):
        node, x = _node_draws(stacked, c, device, seed=9, scale=1.5)
        args = (x, stacked.gmm_weights, stacked.gmm_means,
                stacked.gmm_prec_chol)
        lp_k = kernels.gmm_scores(*args, mix_id=node)
        nll_k, g_k = kernels.gmm_nll_and_grad(*args, node)
        lp_t = kernels.gmm_scores_ref(*args, mix_id=node)
        nll_t, g_t = kernels.gmm_nll_and_grad_ref(*args, node)
        torch.cuda.synchronize()
        errs = {"logp": (lp_k - lp_t).abs(), "nll": (nll_k - nll_t).abs(),
                "grad": (g_k - g_t).abs()}
        refs = {"logp": lp_t, "nll": nll_t, "grad": g_t}
        plain_ms = _time_ms(lambda: kernels.gmm_nll_and_grad_ref(*args, node),
                            5)
        worst = max(float(e.max()) for e in errs.values())
        # per row and component: y = (x - mu) P, |y|^2 and the gradient P y
        k, d = args[2].shape[1:]
        bound_ms, by = _bound(_nbytes(*args, node, nll_k, g_k),
                              c * k * (4 * d * d + 3 * d))

        def tail(ms, args=args, node=node, bound_ms=bound_ms, by=by,
                 plain_ms=plain_ms):
            value_ms = _device_ms(
                lambda: kernels.gmm_scores(*args, mix_id=node), 50)
            return (f"(bound_ms={bound_ms:.5f}, {by}; device_ms without the "
                    f"gradient pass {value_ms:.4f}) twin_ms={plain_ms:.4f}")

        results[c] = dict(max_abs_err=worst, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=by, library_ms=None)
        _kernel_line(
            f"B5 gmm_nll_and_grad [{c}, K={k}, D={d}] over "
            f"{stacked.n_nodes} nodes: "
            + " ".join(f"max_abs_err_{n}={float(e.max()):.3e}"
                       for n, e in errs.items())
            + f" (|log p| up to {float(lp_t.abs().max()):.1f}, |grad| up to "
            f"{float(g_t.abs().max()):.1f}; tol {B5_ATOL}+{B5_RTOL}*|x|)",
            lambda args=args, node=node: kernels.gmm_nll_and_grad(*args, node),
            50, bound_ms, tail, results[c])
        for n, e in errs.items():
            if bool((e > B5_ATOL + B5_RTOL * refs[n].abs()).any()):
                _fail(f"B5 disagrees with its twin ({n})")
        if not all(bool(torch.isfinite(t).all()) for t in (lp_k, nll_k, g_k)):
            _fail("B5 produced non-finite values")
    return results[KERNEL_CHARS]


def phase_b6(stacked, device):
    """B6 against its twin at the walk's shape: 1024 characters spread over
    all nodes, latents drawn from the node GMMs, each character's basis
    warped by its own temporal latents (T = 160); then at the TPU kernel's
    signature (one node's operator and one basis shared by the crowd)."""
    import torch
    from morphablegraphs_tpu_torch.ops import kernels
    from morphablegraphs_tpu_torch.synthesis import walk
    node, s = _node_draws(stacked, KERNEL_CHARS, device, seed=10)
    basis, _ = walk.warped_basis(stacked, node, s[:, stacked.k_s_max:],
                                 RANDOM_FRAMES)
    alpha = s[:, : stacked.k_s_max].contiguous()
    cases = {"gathered": (alpha, stacked.eigen_s, stacked.mean_s, basis,
                          node),
             "shared": (alpha, stacked.eigen_s[1], stacked.mean_s[1],
                        basis[0].contiguous(), None)}
    worst, times = 0.0, {}
    for label, (a, e, m, b, mix) in cases.items():
        out_k = kernels.crowd_back_project(a, e, m, b, mix_id=mix)
        out_t = kernels.crowd_back_project_ref(a, e, m, b, mix_id=mix)
        torch.cuda.synchronize()
        err = (out_k - out_t).abs()
        plain_ms = _time_ms(lambda: kernels.crowd_back_project_ref(
            a, e, m, b, mix_id=mix), 5)
        t, nb = b.shape[-2:]
        nd = out_k.shape[-1]
        bound_ms, by = _bound(
            _nbytes(a, e, m, b, out_k, *(() if mix is None else (mix,))),
            KERNEL_CHARS * (2 * nb * nd * a.shape[1] + 2 * t * nb * nd))
        times[label] = dict(plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=by, library_ms=None)
        _kernel_line(
            f"B6 crowd_back_project ({label}) [{KERNEL_CHARS}, T="
            f"{b.shape[-2]}, n_basis={b.shape[-1]}, n_dim="
            f"{out_k.shape[-1]}, K={a.shape[1]}]: max_abs_err="
            f"{float(err.max()):.3e} (|x| up to "
            f"{float(out_t.abs().max()):.1f}; tol {B6_ATOL}+{B6_RTOL}*|x|)",
            lambda a=a, e=e, m=m, b=b, mix=mix: kernels.crowd_back_project(
                a, e, m, b, mix_id=mix), 50, bound_ms,
            lambda ms, n=out_k.numel(), bound_ms=bound_ms, by=by,
            plain_ms=plain_ms: (
                f"(bound_ms={bound_ms:.5f}, {by}) twin_ms={plain_ms:.4f} "
                f"({n * 4 / ms / 1e6:.0f} GB/s of output)"), times[label])
        if not bool(torch.isfinite(out_k).all()) or \
                bool((err > B6_ATOL + B6_RTOL * out_t.abs()).any()):
            _fail(f"B6 ({label}) disagrees with its twin")
        worst = max(worst, float(err.max()))
    times["gathered"]["max_abs_err"] = worst
    return times["gathered"], phase_emit(stacked, device)


def _emit_case(stacked, device, n_chars, n_frames_max, seed, has_prev):
    """Inputs of `kernels.emit_frames` as a walk step makes them: latents
    over all nodes, their time functions, and as the previous clip's last
    frame the last valid row of another draw's clip."""
    import torch
    from morphablegraphs_tpu_torch.ops import kernels
    from morphablegraphs_tpu_torch.synthesis import walk
    node, s = _node_draws(stacked, n_chars, device, seed=seed)
    k = stacked.k_s_max
    t_fn, n_frames = walk.warped_time(stacked, node, s[:, k:], n_frames_max)
    prev = None
    if has_prev:
        node_p, s_p = _node_draws(stacked, n_chars, device, seed=seed + 1)
        t_p, n_p = walk.warped_time(stacked, node_p, s_p[:, k:], n_frames_max)
        prev = kernels.emit_frames_ref(
            s_p[:, :k].contiguous(), stacked.eigen_s, stacked.mean_s,
            stacked.knots_s, node_p, t_p, n_p, None, False, 0)[1].contiguous()
    return (s[:, :k].contiguous(), stacked.eigen_s, stacked.mean_s,
            stacked.knots_s, node, t_fn, n_frames, prev, has_prev, 20)


def _near_equator(args, frames_t):
    """[C, J] mask of the joints whose hemisphere dot against prev_last lies
    within EMIT_DOT_EPS of 0 in some frame of the twin's aligned clip (the
    twin run with window 0: transformed, not smoothed)."""
    import torch
    from morphablegraphs_tpu_torch.ops import kernels
    prev = args[7]
    c, t, d = frames_t.shape
    if prev is None:
        return torch.zeros((c, (d - 3) // 4), dtype=torch.bool,
                           device=frames_t.device)
    aligned = kernels.emit_frames_ref(*args[:9], 0)[0]
    dots = (aligned[:, :, 3:].reshape(c, t, -1, 4)
            * prev[:, None, 3:].reshape(c, 1, -1, 4)).sum(-1)
    return (dots.abs() < EMIT_DOT_EPS).any(1)


def phase_emit(stacked, device):
    """The frame-emit kernel against its twin at the crowd's shape (1024
    characters over all nodes, T 160) with and without a previous clip, at
    the serving shape (8 characters, T 64), and with one node id outside
    the table (NaN rows for that character, the others untouched).  Frames
    and the carried last frame within B6's bound, joints near the equator
    of their previous quaternion left out and counted.  -> the crowd
    shape's results with a previous clip (the walk's steps after the
    first)."""
    import torch
    from morphablegraphs_tpu_torch.ops import kernels
    results = {}
    for label, n_chars, t_max, has_prev in (
            ("crowd", KERNEL_CHARS, RANDOM_FRAMES, True),
            ("crowd", KERNEL_CHARS, RANDOM_FRAMES, False),
            ("serving", SERVING_CHARS, SERVING_FRAMES, True)):
        args = _emit_case(stacked, device, n_chars, t_max, 20, has_prev)
        f_k, l_k = kernels.emit_frames(*args)
        f_t, l_t = kernels.emit_frames_ref(*args)
        torch.cuda.synchronize()
        skip = _near_equator(args, f_t)  # [C, J]
        keep = torch.cat([torch.ones((n_chars, 3), dtype=torch.bool,
                                     device=device),
                          (~skip).repeat_interleave(4, dim=1)], dim=1)
        err = (f_k - f_t).abs() * keep[:, None]
        err_last = (l_k - l_t).abs() * keep
        worst = max(float(err.max()), float(err_last.max()))
        ok = bool(torch.isfinite(f_k).all()) \
            and bool(torch.isfinite(l_k).all()) \
            and not bool((err > B6_ATOL + B6_RTOL * f_t.abs()).any()) \
            and not bool((err_last > B6_ATOL + B6_RTOL * l_t.abs()).any())
        plain_ms = _time_ms(lambda: kernels.emit_frames_ref(*args), 5)
        nd, k = f_k.shape[-1], args[0].shape[1]
        nb = stacked.n_basis_max
        # the coefficients, 4 taps a frame value, ~10 operations a value for
        # the transform, the sign and the blend
        bound_ms, by = _bound(
            _nbytes(*(a for a in args[:8] if a is not None), f_k, l_k),
            n_chars * (2 * nb * nd * k + (8 + 10 * has_prev) * t_max * nd))
        key = (label, has_prev)
        results[key] = dict(max_abs_err=worst, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=by, library_ms=None)
        _kernel_line(
            f"B6 emit_frames {label} [{n_chars}, T={t_max}, n_basis={nb}, "
            f"n_dim={nd}, K={k}] has_prev={has_prev}: max_abs_err="
            f"{worst:.3e} (|x| up to {float(f_t.abs().max()):.1f}; tol "
            f"{B6_ATOL}+{B6_RTOL}*|x|), {int(skip.sum())} of {skip.numel()} "
            f"joints within {EMIT_DOT_EPS} of the equator left out",
            lambda args=args: kernels.emit_frames(*args), 50, bound_ms,
            lambda ms, n=f_k.numel(), bound_ms=bound_ms, by=by,
            plain_ms=plain_ms: (
                f"(bound_ms={bound_ms:.5f}, {by}) twin_ms={plain_ms:.4f} "
                f"({n * 4 / ms / 1e6:.0f} GB/s of output)"), results[key])
        if not ok:
            _fail(f"emit_frames ({label}, has_prev={has_prev}) disagrees "
                  "with its twin")
    # a node id outside the table: NaN rows, the neighbours as before
    args = list(_emit_case(stacked, device, 64, RANDOM_FRAMES, 22, True))
    good = kernels.emit_frames(*args)
    args[4] = args[4].clone()
    args[4][5] = stacked.n_nodes
    args[4][17] = -1
    bad = kernels.emit_frames(*args)
    torch.cuda.synchronize()
    rows = torch.ones(64, dtype=torch.bool, device=device)
    rows[[5, 17]] = False
    if not all(bool(torch.isnan(b[~rows]).all())
               and torch.equal(b[rows], g[rows]) for b, g in zip(bad, good)):
        _fail("emit_frames: a node id outside the table must give NaN rows "
              "and leave the other characters alone")
    print("B6 emit_frames: node ids outside the table give NaN rows, the "
          "other characters' rows are unchanged", flush=True)
    return results[("crowd", True)]


# The sequential request path (phase 13): MotionGenerator.generate_motion
# on the reference-scale model.  BASELINE config 3's request
# (benchmarks/run_all.py: 50 samples, 5 LM iterations, the 8 best starts)
# and the end-keyframe request of tests/test_motion_generator.py (30
# samples, 8 LM iterations), capped at REQUEST_KF_MAX_STEP + 1 steps: its
# keyframe holds on every step, so uncapped it walks the planner's 101.
REQUEST_CONFIG3 = {
    "startPose": {"position": [0, 0, 0], "orientation": [0, 0, 0]},
    "elementaryActions": [{
        "action": "walk",
        "constraints": [{"joint": "Hips", "trajectoryConstraints": [
            {"position": [0.0, None, 0.0]}, {"position": [8.0, None, 60.0]},
            {"position": [15.0, None, 120.0]}]}],
    }],
}
REQUEST_KEYFRAME = {
    "startPose": {"position": [0, 0, 0], "orientation": [0, 0, 0]},
    "elementaryActions": [{
        "action": "walk",
        "constraints": [{"joint": "Hips", "keyframeConstraints": [{
            "position": [10.0, None, 35.0],
            "semanticAnnotation": {"end": True}}]}],
    }],
}
REQUEST_KF_MAX_STEP = 3
REQUEST_REPS = 3
# GPU vs CPU request at one LM iteration (at 5, the 8-start LM at this
# scale is chaotic: one step's error has moved 12.7 -> 4.7 between the
# two paths): node keys and frame counts exactly, step
# errors within 0.05 + 1e-2 |err| (phase 10's LM bound), frames within
# WALK_FRAMES_ATOL
REQUEST_KERNELS = ("chol_solve", "gmm_scores", "emit_frames")


def _requests():
    """name -> (request, config, seed)."""
    from morphablegraphs_tpu_torch.utils.config import default_config
    cfg3 = default_config()
    cfg3.update(n_random_samples=50, lm_iterations=5, n_lm_starts=8)
    cfg_kf = default_config()
    cfg_kf.update(n_random_samples=30, lm_iterations=8,
                  debug_max_step=REQUEST_KF_MAX_STEP)
    return {"config3": (REQUEST_CONFIG3, cfg3, 0),
            "keyframe": (REQUEST_KEYFRAME, cfg_kf, 1)}


def phase_request(graph, device):
    """Both requests through MotionGenerator(graph, device=cuda), once to
    warm and REQUEST_REPS times timed: wall seconds, p50 step latency,
    steps, average error, objective evaluations and the launches of B2, B5
    and the emit kernel (B6's source) in each request, each above 0.
    -> {name: (generator, request, median wall seconds, launches of the
    last timed request)}."""
    import torch
    from morphablegraphs_tpu_torch.ops import kernels
    from morphablegraphs_tpu_torch.synthesis.motion_generator import \
        MotionGenerator
    out = {}
    for name, (mg_input, cfg, seed) in _requests().items():
        gen = MotionGenerator(graph, cfg, seed=seed, device=device)
        gen.generate_motion(mg_input)  # warm-up
        walls, runs = [], []
        for _ in range(REQUEST_REPS):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            res = gen.generate_motion(mg_input)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            counts = kernels.launch_counts()
            runs.append((res, counts))
            if not np.all(np.isfinite(res.frames)) or res.stats[
                    "n_steps"] < 2 or len(res.frames) <= 30:
                _fail(f"request {name}: frames not finite or too short")
            if any(counts[k] <= 0 for k in REQUEST_KERNELS):
                _fail(f"request {name} did not launch B2, B5 and the emit "
                      f"kernel (B6's source): {counts}")
        st = [r.stats for r, _ in runs]
        print(f"request {name}: MotionGenerator.generate_motion on "
              f"{device}, {len(walls)} timed requests: wall s "
              f"{[round(w, 4) for w in walls]} (median "
              f"{float(np.median(walls)):.4f}), p50 step latency s "
              f"{[round(x['p50_step_latency'], 4) for x in st]}, steps "
              f"{[x['n_steps'] for x in st]}, average_error "
              f"{[round(x['average_error'], 3) for x in st]}, frames "
              f"{[len(r.frames) for r, _ in runs]}, objective_evaluations "
              f"{[x['objective_evaluations'] for x in st]}; launches per "
              f"request of B2/B5/B6 (emit_frames) "
              f"{[tuple(c[k] for k in REQUEST_KERNELS) for _, c in runs]}, "
              f"of the other port kernels "
              f"{sum(v for _, c in runs for k, v in c.items() if k not in REQUEST_KERNELS)}",
              flush=True)
        out[name] = (gen, mg_input, float(np.median(walls)), runs[-1][1])
    return out


def phase_request_kernels(graph, device):
    """B2, B5 and the emit kernel at the shapes a request launches them,
    against their twins: B2 at [1, 28, 28] (the single-start LM's solve),
    B5 on 1 and 50 rows of one node's mixture (value and gradient, as the
    LM's naturalness term takes them) and on 3 rows over 3 stacked
    mixtures (mix_id = arange(3): a global pass's window of steps, phase
    14), the emit kernel at C = 1 with a previous clip over the step's
    padded frames (the step epilogue), without one over the conversion's
    padded time-warped frames and without one over the canonical padded
    frames with no seam window (the rebuild after a global pass, phase
    14).  -> {kernel name: results}."""
    import torch
    from morphablegraphs_tpu_torch.models import primitive as prim_mod
    from morphablegraphs_tpu_torch.ops import kernels, timewarp
    from morphablegraphs_tpu_torch.synthesis.motion_generator import \
        _pad_frames
    res = {}
    gen = torch.Generator(device=device).manual_seed(31)
    j = torch.randn((1, 40, 28), generator=gen, device=device)
    a = torch.bmm(j.transpose(1, 2), j) + 0.1 * torch.eye(28, device=device)
    g = torch.randn((1, 28), generator=gen, device=device)
    x_k, x_t = kernels.chol_solve(a, g), kernels.chol_solve_unrolled(a, g)
    torch.cuda.synchronize()
    err = (x_k - x_t).abs()
    if bool((err > B2_ATOL + B2_RTOL * x_t.abs()).any()):
        _fail("B2 at [1, 28, 28] disagrees with its twin")
    bound_ms, by = _bound(_nbytes(a, g, x_k), 28 ** 3 / 3 + 2 * 28 * 28)
    res["chol_solve"] = dict(
        shape="[1, 28, 28]", max_abs_err=float(err.max()),
        plain_ms=_time_ms(lambda: kernels.chol_solve_unrolled(a, g), 5),
        bound_ms=bound_ms, bound_by=by,
        library_ms=_time_ms(lambda: torch.linalg.solve_ex(a, g), 50))
    _kernel_line(f"request B2 chol_solve [1, 28, 28]: max_abs_err="
                 f"{float(err.max()):.3e} (tol {B2_ATOL}+{B2_RTOL}*|x|)",
                 lambda: kernels.chol_solve(a, g), 50, bound_ms,
                 f"(bound_ms={bound_ms:.6f}, {by}) twin_ms="
                 f"{res['chol_solve']['plain_ms']:.4f} torch.linalg."
                 f"solve_ex_ms={res['chol_solve']['library_ms']:.4f}",
                 res["chol_solve"])

    prim = graph.nodes[("walk", "leftStance")].primitive.to(device)
    gm = prim.gmm
    window = [graph.nodes[k].primitive.to(device)
              for k in sorted(graph.nodes)[:3]]
    b5_cases = []
    for rows in (1, 50):
        b5_cases.append((str(rows), f"{rows} rows of one mixture", (
            1.5 * prim_mod.sample_latent(gen, prim, rows), gm.weights[None],
            gm.means[None], gm.prec_chol[None],
            torch.zeros(rows, dtype=torch.long, device=device))))
    b5_cases.append(("window", "3 rows over 3 stacked mixtures (a global "
                     "pass's window)", (
                         1.5 * torch.cat([prim_mod.sample_latent(gen, p, 1)
                                          for p in window]),
                         torch.stack([p.gmm.weights for p in window]),
                         torch.stack([p.gmm.means for p in window]),
                         torch.stack([p.gmm.prec_chol for p in window]),
                         torch.arange(3, device=device))))
    for label, what, args in b5_cases:
        rows = args[0].shape[0]
        nll_k, g_k = kernels.gmm_nll_and_grad(*args)
        nll_t, g_t = kernels.gmm_nll_and_grad_ref(*args)
        torch.cuda.synchronize()
        worst = max(float((nll_k - nll_t).abs().max()),
                    float((g_k - g_t).abs().max()))
        if bool(((nll_k - nll_t).abs() > B5_ATOL + B5_RTOL
                 * nll_t.abs()).any()) or bool(
                ((g_k - g_t).abs() > B5_ATOL + B5_RTOL * g_t.abs()).any()):
            _fail(f"B5 on {what} disagrees with its twin")
        k, d = gm.means.shape
        bound_ms, by = _bound(_nbytes(*args, nll_k, g_k),
                              rows * k * (4 * d * d + 3 * d))
        r = res[f"gmm_scores_{label}"] = dict(
            shape=f"[{rows}, K={k}, D={d}] over {args[1].shape[0]} "
            f"mixture(s)", max_abs_err=worst,
            plain_ms=_time_ms(lambda args=args:
                              kernels.gmm_nll_and_grad_ref(*args), 5),
            bound_ms=bound_ms, bound_by=by, library_ms=None)
        _kernel_line(f"request B5 gmm_nll_and_grad [{rows}, K={k}, D={d}] "
                     f"on {what}: max_abs_err={worst:.3e} (tol "
                     f"{B5_ATOL}+{B5_RTOL}*|x|)",
                     lambda args=args: kernels.gmm_nll_and_grad(*args), 50,
                     bound_ms, f"(bound_ms={bound_ms:.6f}, {by}) twin_ms="
                     f"{r['plain_ms']:.4f}", r)

    s = prim_mod.sample_latent(gen, prim, 1)[0]
    f = prim.n_canonical_frames
    step_t, step_n = timewarp.linear_time_function(f, _pad_frames(f),
                                                   device=device)
    conv_t, conv_n = prim_mod.time_function(
        prim, s[prim.n_spatial:], _pad_frames(2 * f))
    rb_t, _ = timewarp.linear_time_function(f, _pad_frames(f),
                                            device=device)
    rb_n = torch.tensor(rb_t.shape[0], dtype=torch.int32, device=device)
    prev = prim_mod.evaluate_at(prim, s, step_t[-1:].clone())
    for label, t_fn, n_fr, has_prev, win in (
            ("step", step_t, step_n, True, 20),
            ("convert", conv_t, conv_n, False, 20),
            ("rebuild", rb_t, rb_n, False, 0)):
        args = (s[None, : prim.n_spatial], prim.eigen_s[None],
                prim.mean_s[None], prim.knots_s[None],
                torch.zeros(1, dtype=torch.long, device=device), t_fn[None],
                n_fr.reshape(1), prev if has_prev else None, has_prev, win)
        f_k, l_k = kernels.emit_frames(*args)
        f_t, l_t = kernels.emit_frames_ref(*args)
        torch.cuda.synchronize()
        skip = _near_equator(args, f_t)
        keep = torch.cat([torch.ones((1, 3), dtype=torch.bool,
                                     device=device),
                          (~skip).repeat_interleave(4, dim=1)], dim=1)
        err = (f_k - f_t).abs() * keep[:, None]
        if not bool(torch.isfinite(f_k).all()) or bool(
                (err > B6_ATOL + B6_RTOL * f_t.abs()).any()):
            _fail(f"emit_frames at the request's {label} shape disagrees "
                  "with its twin")
        t_max, nd, kk = t_fn.shape[-1], f_k.shape[-1], prim.n_spatial
        bound_ms, by = _bound(
            _nbytes(*(x for x in args[:8] if x is not None), f_k, l_k),
            2 * prim.n_basis * nd * kk + (8 + 10 * has_prev) * t_max * nd)
        r = res[f"emit_frames_{label}"] = dict(
            shape=f"[1, T={t_max}, n_basis={prim.n_basis}, n_dim={nd}, "
            f"K={kk}] has_prev={has_prev} window={win}",
            max_abs_err=float(err.max()),
            plain_ms=_time_ms(lambda args=args:
                              kernels.emit_frames_ref(*args), 5),
            bound_ms=bound_ms, bound_by=by, library_ms=None)
        _kernel_line(f"request B6 emit_frames ({label}) {r['shape']}: "
                     f"max_abs_err={float(err.max()):.3e} (tol "
                     f"{B6_ATOL}+{B6_RTOL}*|x|)",
                     lambda args=args: kernels.emit_frames(*args), 50,
                     bound_ms, f"(bound_ms={bound_ms:.6f}, {by}) twin_ms="
                     f"{r['plain_ms']:.4f}", r)
    return res


def _quat_frames_diff(a, b):
    """(max abs difference of frames a, b [T, 3 + 4J] with each joint
    quaternion compared up to its sign, the number of joint quaternions
    that differ in sign).  The seam smoothing picks a quaternion's sign by
    the sign of its dot with the previous clip's last frame; the synthetic
    model's unnormalized quaternions put some of those dots near 0, where
    the last bit of an upstream difference picks the other, equal,
    rotation."""
    t = a.shape[0]
    qa, qb = a[:, 3:].reshape(t, -1, 4), b[:, 3:].reshape(t, -1, 4)
    same, other = np.abs(qa - qb).max(-1), np.abs(qa + qb).max(-1)
    worst = max(float(np.abs(a[:, :3] - b[:, :3]).max()),
                float(np.minimum(same, other).max()))
    return worst, int((other < same).sum())


def _host_sampler(graph, seed):
    """The draw table: GMM draws from a host torch.Generator, the same on
    every device; a transition model's conditioned mixture (on any device)
    is copied to the host and drawn from the same generator.  `graph`'s
    primitives live on the CPU."""
    import torch
    from morphablegraphs_tpu_torch.models import primitive as prim_mod
    from morphablegraphs_tpu_torch.ops import gmm as gmm_ops
    gen = torch.Generator().manual_seed(seed)

    def sampler(key, n, gmm=None):
        if n == 0:  # a cluster-tree step's key: nothing is drawn
            return np.zeros((0, graph.nodes[key].primitive.n_latent),
                            np.float32)
        if gmm is None:
            return prim_mod.sample_latent(gen, graph.nodes[key].primitive,
                                          n).numpy()
        host = gmm_ops.GMM(*(getattr(gmm, f).cpu() for f in (
            "weights", "means", "cov_chol", "prec_chol")))
        return gmm_ops.sample(gen, host, n).numpy()
    return sampler


def phase_request_reference(graph):
    """Both requests at one LM iteration on the GPU path (kernels) and on
    the CPU path (twins), drawing the same host-made samples: node keys
    and frame counts equal, step errors and frames (after the keyframe
    IK) within the bounds of phase 10."""
    from morphablegraphs_tpu_torch.synthesis.motion_generator import \
        MotionGenerator

    for name, (mg_input, cfg, _) in _requests().items():
        cfg = dict(cfg, lm_iterations=1)
        runs = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            runs[dev] = (MotionGenerator(graph, cfg, device=dev,
                                         sampler=_host_sampler(graph, 7))
                         .generate_motion(mg_input),
                         time.perf_counter() - t0)
        (a, t_gpu), (b, t_cpu) = runs["cuda"], runs["cpu"]
        keys_ok = [s.node_key for s in a.steps] == [s.node_key
                                                    for s in b.steps]
        err_a = np.array([s.error for s in a.steps])
        err_b = np.array([s.error for s in b.steps])
        same_len = keys_ok and a.frames.shape == b.frames.shape
        frame_err, flips = (_quat_frames_diff(a.frames, b.frames)
                            if same_len else (float("inf"), -1))
        print(f"request reference {name} (1 LM iteration): GPU {t_gpu:.3f} "
              f"s vs CPU {t_cpu:.3f} s, {len(a.steps)} steps, node keys "
              f"equal={keys_ok}, max |err| diff "
              f"{float(np.abs(err_a - err_b).max()) if keys_ok else -1:.3e} "
              f"(errors {np.round(err_a, 3).tolist()}), frames "
              f"{a.frames.shape} max abs diff {frame_err:.3e} (tol "
              f"{WALK_FRAMES_ATOL}; {flips} joint quaternions of the "
              f"{a.frames.shape[0] * ((a.frames.shape[1] - 3) // 4)} came "
              "out with the other sign, the same rotation)", flush=True)
        if not same_len or np.any(np.abs(err_a - err_b)
                                  > 0.05 + 1e-2 * np.abs(err_b)) \
                or frame_err > WALK_FRAMES_ATOL:
            _fail(f"request {name}: the GPU path disagrees with the CPU "
                  "path")


# The rest of the sequential request path (phase 14): the options ROADMAP
# item 13 finished, two requests on the reference-scale model.  "timed":
# phase 13's end-keyframe request with a keyframe time, under the time
# optimization, the global spatial optimization ("all", every window
# optimized) and grounding by the stance table; "ca": config 3's
# trajectory with a collision-avoidance trajectory on the Head, in the
# "ik" mode with the extra pass and the foot-plant grounding.
REQUEST_TIMED = {
    "startPose": {"position": [0, 0, 0], "orientation": [0, 0, 0]},
    "elementaryActions": [{
        "action": "walk",
        "constraints": [{"joint": "Hips", "keyframeConstraints": [{
            "position": [10.0, None, 35.0], "time": 2.5,
            "semanticAnnotation": {"end": True}}]}],
    }],
}
REQUEST_CA = {
    "startPose": {"position": [0, 0, 0], "orientation": [0, 0, 0]},
    "elementaryActions": [{
        "action": "walk",
        "constraints": [
            {"joint": "Hips", "trajectoryConstraints": [
                {"position": [0.0, None, 0.0]},
                {"position": [8.0, None, 60.0]},
                {"position": [15.0, None, 120.0]}]},
            {"joint": "Head", "trajectoryConstraints": [
                {"position": [20.0, 150.0, 30.0]},
                {"position": [20.0, 150.0, 90.0]}]}],
    }],
}
# timed runs: "timed" once to warm and REQUEST_REPS times, "ca" once (its
# passes' host time is of the same kind; phase 12 profiles both)
OPTIONS_REPS = {"timed": REQUEST_REPS, "ca": 1}
# the global passes whose B5 launches phase 14 counts: (module, function)
GLOBAL_PASSES = (("global_opt", "optimize_time_over_steps"),
                 ("global_opt", "optimize_spatial_over_steps"),
                 ("motion_generator",
                  "MotionGenerator._maybe_optimize_ca_extra"))
# The post-process check (phase 14's reference): the GPU path's output
# within POST_ATOL of the CPU path's on the frames where the CPU path's is
# stable (moves less than STABLE_ATOL under relative nudges of -1e-6 and
# 1e-6 of the input), at least MIN_STABLE of them.  The IK targets of the
# synthetic model's frames are out of reach (its joint quaternions are
# not unit, norms 0.09-8.7, so the FK puts the feet ~1e4 cm from the
# ground) and no output frame is stable, so the check runs on the
# captured input with unit joint quaternions: there the CPU path's
# grounding solves bring 0.84-0.90 of the feet within 1 cm of their
# targets, and 0.91 ("timed") and 0.28 ("ca": the Head's trajectory is
# out of the IK's reach with the root held) of the frames are stable.
STABLE_ATOL, POST_ATOL, MIN_STABLE = 1e-3, 1e-2, 0.2


def _options_requests():
    """name -> (request, config, seed) of phase 14.  The spatial
    optimization runs at unit position and orientation weights, as the
    CPU tests hold it against JAX: at the default 1000, whether its LM
    accepts any of its 8 steps on this model is a near-tie decided by
    rounding, in either package (ROADMAP, known differences)."""
    from morphablegraphs_tpu_torch.utils.config import default_config
    timed = default_config()
    timed.update(n_random_samples=30, lm_iterations=8,
                 debug_max_step=REQUEST_KF_MAX_STEP,
                 global_spatial_optimization_mode="all",
                 activate_motion_grounding=True)
    timed["global_spatial_optimization_settings"] = dict(
        timed["global_spatial_optimization_settings"],
        start_error_threshold=0.0, position_weight=1.0,
        orientation_weight=1.0)
    timed["motion_grounding_settings"] = dict(
        timed["motion_grounding_settings"],
        generate_foot_plant_constraints=False)
    ca = default_config()
    ca.update(n_random_samples=50, lm_iterations=5, n_lm_starts=8,
              debug_max_step=REQUEST_KF_MAX_STEP,
              collision_avoidance_constraints_mode="ik",
              optimize_collision_avoidance_constraints_extra=True,
              activate_motion_grounding=True)
    ca["motion_grounding_settings"] = dict(
        ca["motion_grounding_settings"], generate_foot_plant_constraints=True)
    return {"timed": (REQUEST_TIMED, timed, 1), "ca": (REQUEST_CA, ca, 0)}


class _Spy:
    """Wrap module.attr (a function, or Class.method) while the context is
    open: every call records (args, kwargs, result, the kernel launches
    it made); with stub, the wrapper returns stub(*args, **kwargs)
    instead of calling the function."""

    def __init__(self, module, attr, stub=None):
        self.owner = module
        *path, self.name = attr.split(".")
        for p in path:
            self.owner = getattr(self.owner, p)
        self.stub = stub
        self.calls = []

    def __enter__(self):
        from morphablegraphs_tpu_torch.ops import kernels
        self.orig = getattr(self.owner, self.name)
        fn = self.stub or self.orig

        def wrapper(*a, **kw):
            before = kernels.launch_counts()
            out = fn(*a, **kw)
            after = kernels.launch_counts()
            self.calls.append((a, kw, out, {k: after[k] - before[k]
                                            for k in after}))
            return out
        setattr(self.owner, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)


def _keyframe_times(prims, params, constrained, frame_time, start_frames):
    """The output time in seconds of each time constraint's keyframe
    (global_opt.optimize_time_over_steps' model) for latents params."""
    import torch
    from morphablegraphs_tpu_torch.ops import timewarp
    t_cans = [timewarp.canonical_time_function(
        p.mean_t_d, p.eigen_t_d, torch.as_tensor(
            s[p.n_spatial:], device=p.mean_t_d.device)).cpu().numpy()
        for p, s in zip(prims, params)]
    out = []
    for i, kf, _ in constrained:
        prior = sum(float(t[-2]) + 2.0 for t in t_cans[:i])
        out.append((start_frames + prior + float(t_cans[i][int(kf)]))
                   * frame_time)
    return out


def _hand_poses(graph):
    """A pick pose on the right hand for the timed request's overlay
    (hand_pose.HandPoseGenerator, as a graph's hand_pose_info loads it)."""
    from morphablegraphs_tpu_torch.synthesis.hand_pose import \
        HandPoseGenerator
    gen = HandPoseGenerator(graph.skeleton)
    gen.add_pose("pick", {"RightHand": np.array([0.7071, 0.0, 0.7071, 0.0],
                                                np.float32)})
    return gen, [{"keyframe": 30, "event": "attach",
                  "parameters": {"joint": "RightHand"}},
                 {"keyframe": 90, "event": "detach",
                  "parameters": {"joint": "RightHand"}}]


def phase_options(graph, device):
    """Phase 14: both requests through MotionGenerator(graph, device=cuda),
    OPTIONS_REPS times each ("timed" after a warm-up): wall seconds, p50
    step latency, steps, average error, frames and the launches of B2, B5
    and the emit kernel in each, each above 0; the timed request's keyframe
    time error before and after the time optimization (it must not grow),
    the spatial optimization's largest move of a latent (above 0 in at
    least one timed request: each draws anew, and its LM may reject every
    step of one) and its hand-pose overlay; B5's launches inside each global pass
    (spies around the global optimizations and the extra CA pass), above 0
    in every pass that ran.  -> {name: (run function, median wall seconds,
    launches of the last timed request, B5 launches per global pass)}."""
    import torch
    from morphablegraphs_tpu_torch.ops import kernels
    from morphablegraphs_tpu_torch.synthesis import global_opt
    from morphablegraphs_tpu_torch.synthesis import motion_generator as mg
    modules = {"global_opt": global_opt, "motion_generator": mg}
    hands, events = _hand_poses(graph)
    out = {}
    for name, (mg_input, cfg, seed) in _options_requests().items():
        gen = mg.MotionGenerator(graph, cfg, seed=seed, device=device)

        def run(_=None, gen=gen, mg_input=mg_input, name=name):
            res = gen.generate_motion(mg_input)
            if name == "timed":
                res.frames = hands.generate_hand_poses(res.frames, events)
            return res
        if OPTIONS_REPS[name] > 1:
            run()  # warm-up
        walls, runs, moves = [], [], []
        spies = [_Spy(modules[m], f) for m, f in GLOBAL_PASSES]
        for _ in range(OPTIONS_REPS[name]):
            for spy in spies:
                spy.calls.clear()
                spy.__enter__()
            try:
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                res = run()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            finally:
                for spy in spies:
                    spy.__exit__()
            counts = kernels.launch_counts()
            b5 = {spy.name: sum(c[3]["gmm_scores"] for c in spy.calls)
                  for spy in spies}
            runs.append((res, counts, b5))
            if not np.all(np.isfinite(res.frames)) or res.stats[
                    "n_steps"] < 2 or len(res.frames) <= 30:
                _fail(f"request {name}: frames not finite or too short")
            if any(counts[k] <= 0 for k in REQUEST_KERNELS):
                _fail(f"request {name} did not launch B2, B5 and the emit "
                      f"kernel (B6's source): {counts}")
            want = ({"optimize_time_over_steps", "optimize_spatial_over_steps"}
                    if name == "timed" else {"_maybe_optimize_ca_extra"})
            if any(b5[w] <= 0 for w in want):
                _fail(f"request {name}: B5 launches in the global passes "
                      f"{b5}, expected > 0 in each of {sorted(want)}")
            if name == "timed":
                a, kw, new, _ = spies[0].calls[0]
                times = [_keyframe_times(a[0], p, a[2], a[3],
                                         kw["start_frames"])
                         for p in (a[1], new)]
                desired = [c[2] for c in a[2]]
                err = [sum(abs(t - d) for t, d in zip(ts, desired))
                       for ts in times]
                a, _, (new, _), _ = spies[1].calls[0]
                moved = max(float(np.abs(n - o).max())
                            for n, o in zip(new, a[3]))
                print(f"request {name}: keyframe output times before / "
                      f"after the time optimization "
                      f"{[round(t, 3) for t in times[0]]} / "
                      f"{[round(t, 3) for t in times[1]]} s against "
                      f"{desired} s desired (summed error {err[0]:.4f} / "
                      f"{err[1]:.4f} s); the spatial optimization moved a "
                      f"latent by up to {moved:.4f}", flush=True)
                moves.append(moved)
                if err[1] > err[0]:
                    _fail("the time optimization made the keyframe times "
                          "worse")
        if moves and not max(moves) > 0.0:
            # each request draws anew; its LM may reject every step of one
            _fail("the spatial optimization accepted no step in any timed "
                  "request")
        st = [r.stats for r, _, _ in runs]
        print(f"request {name}: MotionGenerator.generate_motion on "
              f"{device}, {len(walls)} timed requests: wall s "
              f"{[round(w, 4) for w in walls]} (median "
              f"{float(np.median(walls)):.4f}), p50 step latency s "
              f"{[round(x['p50_step_latency'], 4) for x in st]}, steps "
              f"{[x['n_steps'] for x in st]}, average_error "
              f"{[round(x['average_error'], 3) for x in st]}, frames "
              f"{[len(r.frames) for r, _, _ in runs]}; launches per "
              f"request of B2/B5/B6 (emit_frames) "
              f"{[tuple(c[k] for k in REQUEST_KERNELS) for _, c, _ in runs]}"
              f"; B5 launches inside the global passes {runs[-1][2]}",
              flush=True)
        out[name] = (run, float(np.median(walls)), runs[-1][1],
                     runs[-1][2])
    return out


def _unit_quats(frames):
    """frames [T, 3 + 4J] with every joint quaternion scaled to unit
    length."""
    out = frames.copy()
    q = out[:, 3:].reshape(len(out), -1, 4)
    out[:, 3:] = (q / np.linalg.norm(q, axis=-1, keepdims=True)).reshape(
        len(out), -1)
    return out


def _post_process_invariants(skel, frames_in, frames_out, ground_calls):
    """The largest break of the post-process's invariants: the root's X, Z
    and rotation unchanged, its height shifted by one constant (the
    grounding's, 0 without it), and inside ground_motion every channel off
    the legs unchanged."""
    from morphablegraphs_tpu_torch.synthesis import grounding
    keep = [0, 2, 3, 4, 5, 6]
    shift = frames_out[:, 1] - frames_in[:, 1]
    worst = max(float(np.abs(frames_out[:, keep] - frames_in[:, keep]).max()),
                float(np.ptp(shift)) if ground_calls
                else float(np.abs(shift).max()))
    legs = grounding._leg_joint_mask(skel,
                                     grounding._foot_nodes(skel, "both"))
    kept = np.ones(frames_in.shape[1], bool)
    kept[1] = False
    for j in np.flatnonzero(legs):
        kept[3 + 4 * j: 7 + 4 * j] = False
    for a, _, g_out, _ in ground_calls:
        worst = max(worst, float(np.abs(g_out[:, kept]
                                        - a[1][:, kept]).max()))
    return worst


def phase_options_reference(graph):
    """Both phase-14 requests at one LM iteration on the GPU path and the
    CPU path, drawing the same host-made samples, up to the post-process
    (stubbed: it hands back its input): node keys and frame counts equal,
    step errors within phase 13's bound and the frames within
    WALK_FRAMES_ATOL up to quaternion signs.  Then the post-process
    (keyframe IK, trajectory IK, grounding) on the GPU and the CPU from the
    GPU path's captured input with unit joint quaternions: the GPU's
    output within POST_ATOL of the CPU's on the frames the CPU path holds
    stable (see STABLE_ATOL), and the invariants of
    `_post_process_invariants` exactly on both."""
    from morphablegraphs_tpu_torch.synthesis import grounding, postprocess
    from morphablegraphs_tpu_torch.synthesis.motion_generator import \
        MotionGenerator

    def post(frames, args, kw, dev):
        with _Spy(grounding, "ground_motion") as spy:
            out = postprocess.post_process_motion(
                args[0], frames, *args[2:], **dict(kw, device=dev))
        return out, spy.calls

    for name, (mg_input, cfg, _) in _options_requests().items():
        cfg = dict(cfg, lm_iterations=1)
        runs = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            with _Spy(postprocess, "post_process_motion",
                      stub=lambda *a, **kw: a[1]) as spy:
                res = MotionGenerator(graph, cfg, device=dev,
                                      sampler=_host_sampler(graph, 7)
                                      ).generate_motion(mg_input)
            runs[dev] = (res, spy.calls[-1], time.perf_counter() - t0)
        (a, call, t_gpu), (b, _, t_cpu) = runs["cuda"], runs["cpu"]
        keys_ok = [s.node_key for s in a.steps] == [s.node_key
                                                    for s in b.steps]
        err_a = np.array([s.error for s in a.steps])
        err_b = np.array([s.error for s in b.steps])
        same_len = keys_ok and a.frames.shape == b.frames.shape
        pre_err, flips = (_quat_frames_diff(a.frames, b.frames)
                          if same_len else (float("inf"), -1))
        args, kw = call[0], call[1]
        base = _unit_quats(args[1])
        t0 = time.perf_counter()
        out_g, ground_g = post(base, args, kw, "cuda")
        t_post = time.perf_counter() - t0
        out_c, ground_c = post(base, args, kw, "cpu")
        spread = np.zeros(len(base))
        for eps in (-1e-6, 1e-6):
            nudged = base.copy()
            nudged[:, 3:] *= np.float32(1 + eps)
            spread = np.maximum(spread, np.abs(
                post(nudged, args, kw, "cpu")[0] - out_c).max(1))
        stable = spread < STABLE_ATOL
        post_err = float(np.abs(out_g - out_c)[stable].max()) \
            if stable.any() else float("inf")
        skel = graph.skeleton
        broken = max(_post_process_invariants(skel, base, out_g, ground_g),
                     _post_process_invariants(skel, base, out_c, ground_c))
        print(f"request reference {name} (1 LM iteration, post-process "
              f"stubbed): GPU {t_gpu:.3f} s vs CPU {t_cpu:.3f} s, "
              f"{len(a.steps)} steps, node keys equal={keys_ok}, max |err| "
              f"diff "
              f"{float(np.abs(err_a - err_b).max()) if keys_ok else -1:.3e} "
              f"(errors {np.round(err_a, 3).tolist()}), frames "
              f"{a.frames.shape} max abs diff {pre_err:.3e} (tol "
              f"{WALK_FRAMES_ATOL}; {flips} joint quaternions with the "
              f"other sign); the post-process from the GPU path's input "
              f"with unit quaternions ({t_post:.3f} s on the GPU): "
              f"{int(stable.sum())} of {len(base)} frames stable on the "
              f"CPU (share {float(stable.mean()):.3f}, at least "
              f"{MIN_STABLE}), GPU vs CPU on them {post_err:.3e} (tol "
              f"{POST_ATOL}; all frames {float(np.abs(out_g - out_c).max()):.3e}), "
              f"invariants broken by {broken:.3e} (tol 1e-3)", flush=True)
        if not same_len or np.any(np.abs(err_a - err_b)
                                  > 0.05 + 1e-2 * np.abs(err_b)) \
                or pre_err > WALK_FRAMES_ATOL:
            _fail(f"request {name}: the GPU path disagrees with the CPU "
                  "path")
        if not np.all(np.isfinite(out_g)) or stable.mean() < MIN_STABLE \
                or post_err > POST_ATOL or broken > 1e-3 \
                or float(np.abs(out_g - base).max()) <= 1e-2:
            _fail(f"request {name}: the post-process on the GPU fails its "
                  "check")


# The streaming planner (phase 15): MGStatePlanner on the reference-scale
# walk graph plus a pickRight action at the same widths, one session
# through start(), the main thread popping states until the worker ends.
# The session: a control-point walk of 3 targets with an end direction
# (the end targets forced), a look-at target behind the walk (the head's
# twist clamps at the limit table's 80 degrees) and an upper-body gesture
# resampled by velocityFactor with wrist noise (a CCD edit); a 4-step
# direction walk; pickRight with an engine-format RightHand constraint on
# start_contact held over a region to end_contact (the IK snap); a hand
# collision boundary that hits once (a CCD edit).  The default settings
# run a 10-iteration LM on every constrained step (B2 and B5) and emit
# every step through the emit kernel.
PLANNER_SETTINGS = dict(force_walk_end_targets=True, min_end_distance=1.0,
                        end_target_blend_range=20,
                        enable_gesture_parameters=True,
                        min_target_distance=40.0, max_steps_per_target=3)
PLANNER_REPS = 2  # timed sessions, after one that warms
PLANNER_SEED = 5  # the draw table's torch.Generator (on the host)
PLANNER_CONTACT = ("start_contact", "end_contact")  # reach labels
PLANNER_CONTACT_FRAMES = (65, 75)
# The IK snap needs a hand it can move onto the target.  The synthetic
# walk primitives' joint quaternions are far from unit length (norms
# 0.09-8.7: their spatial eigenvectors are N(0, 0.3) on every row), which
# scales the FK's bones: the reach's hand moves hundreds of cm between
# two frames, and from 3 cm off the IK diverges to thousands.  So the
# reach primitive's mean quaternions are made unit and its eigenvectors
# scaled by PLANNER_QUAT_EIGEN_SCALE on the quaternion rows (norms within
# a few percent of 1, as a trained model's).  The step's LM moves the
# hand with its target, so the target is iterated toward where the
# session's hand goes: PLANNER_PROBES sessions with the same draws, each
# aiming at the hand's position at end_contact before the snap in the one
# before, plus PLANNER_TARGET_OFFSET cm.  The miss is measured in the
# frame the snap solves in (see _check_session).
PLANNER_QUAT_EIGEN_SCALE = 0.05
PLANNER_TARGET_OFFSET = np.array([3.0, 2.0, -3.0])
PLANNER_PROBES = 2
PLANNER_TARGET_MISS = 2.0  # cm: the snapped hand at end_contact
PLANNER_TWIST_TOL = 1e-3  # rad: a clamped twist past its bound
PLANNER_SEAM = 5.0  # cm: root jump between consecutive states
# GPU vs CPU session at one LM iteration: node keys, frame counts, events
# and hold frames exactly, frames within PLANNER_FRAMES_ATOL (joint
# quaternions up to sign): in a CPU rehearsal a 1e-6 relative nudge of the
# draws moved the session's frames by up to 9.4e-3 (the one-iteration LM
# and 16 states aligned each onto the one before).  The seam smoothing
# picks each joint's hemisphere by the sign of its dot with the previous
# state's last frame,
# and the blend of the whole window follows the first frame's pick: on
# the synthetic model's random quaternions a cosine within rounding of 0
# picks the other side on one path (in a CPU rehearsal a 1e-6 relative
# nudge of the draws moved one such window by 1.9).  Joints whose cosine
# lies within PLANNER_SEAM_COS_EPS of 0 on either path are left out of
# their state's seam window and counted, as the emit kernel's checks
# leave out joints within EMIT_DOT_EPS.
PLANNER_SEAM_COS_EPS = 1e-3
PLANNER_FRAMES_ATOL = 3e-2


def _planner_graph():
    """The reference-scale walk graph plus pickRight: one `reach`
    primitive at the walk's widths with the contact labels, its
    transitions, and the action definition's node sequence and
    constraint slot."""
    from morphablegraphs_tpu_torch.models import graph as graph_mod
    from morphablegraphs_tpu_torch.models import skeleton as sk
    from morphablegraphs_tpu_torch.utils import synthetic
    gd = synthetic.make_reference_scale_graph_dict()
    mm = synthetic.make_legacy_model_json(seed=100, **synthetic.REF_SCALE)
    mm["name"] = "pickRight_reach"
    # joint quaternions within a few percent of unit length (see
    # PLANNER_QUAT_EIGEN_SCALE): the mean's unit, the eigenvectors' scaled
    # down; the root translation rows keep their scale
    eigen = np.asarray(mm["eigen_vectors_spatial"])
    n_dim = mm["n_dim_spatial"]
    eigen = eigen.reshape(len(eigen), -1, n_dim)
    eigen[..., 3:] *= PLANNER_QUAT_EIGEN_SCALE
    mm["eigen_vectors_spatial"] = eigen.reshape(len(eigen), -1).tolist()
    mean = np.asarray(mm["mean_spatial_vector"]).reshape(-1, n_dim)
    q = mean[:, 3:].reshape(len(mean), -1, 4)
    mean[:, 3:] = (q / np.linalg.norm(q, axis=-1, keepdims=True)).reshape(
        len(mean), -1)
    mm["mean_spatial_vector"] = mean.reshape(-1).tolist()
    mm["keyframes"].update(zip(PLANNER_CONTACT, PLANNER_CONTACT_FRAMES))
    gd["subgraphs"]["pickRight"] = {
        "name": "pickRight",
        "info": {"start_states": ["reach"], "end_states": ["reach"]},
        "nodes": {"reach": {"name": "pickRight_reach", "mm": mm}}}
    gd["transitions"]["walk_endRightStance"] = ["pickRight_reach"]
    gd["transitions"]["pickRight_reach"] = ["walk_beginLeftStance"]
    gd["actionDefinitions"] = {"pickRight": {
        "node_sequence": [["reach", "standard"]],
        "constraint_slots": {PLANNER_CONTACT[0]: {"node": "reach",
                                                  "joint": "RightHand"}}}}
    graph = graph_mod.build_graph_from_dict(gd)
    graph.skeleton, _ = sk.load_bvh(synthetic.REF_BVH)
    return graph


def _planner_actions(target):
    """The session's action descs; target: the RightHand's world target."""
    return [
        {"action": "walk",
         "controlPoints": [[0.0, 0, 40.0], [10.0, 0, 70.0],
                           [20.0, 0, 100.0]],
         "endDirection": [1.0, 0.0, 0.0],
         "lookAtTarget": [-20.0, 160.0, -400.0],
         "upperBodyGesture": {"name": "walk", "primitive": "rightStance",
                              "velocityFactor": 1.5, "noiseFactor": 0.5}},
        {"action": "walk", "direction": [0.3, 0.0, 1.0], "nSteps": 4},
        {"action": "pickRight", "frameConstraints": [{
            "keyframe": PLANNER_CONTACT[0],
            "position": {"x": -float(target[0]), "y": float(target[1]),
                         "z": float(target[2])},
            "constrainPositionInRegion": True,
            "endKeyframe": PLANNER_CONTACT[1], "hold": True,
            "keyframeEvents": [{"event": "attach",
                                "parameters": {"joint": "RightHand"}}]}]}]


class _HandBoundary:
    """A hand collision boundary that reports one hit (the first check,
    at a third of the clip, pushed along -z) and none after."""

    joint_name = "RightHand"

    def __init__(self):
        self.hits = 0

    def check_trajectory(self, points, dt):
        if self.hits:
            return None, None, None
        self.hits += 1
        i = len(points) // 3
        return i, np.asarray(points[i]), np.array([0.0, 0.0, 1.0])


def _planner(graph, device, lm_iterations=10):
    from morphablegraphs_tpu_torch.synthesis import state_planner as sp
    from morphablegraphs_tpu_torch.utils.config import default_config
    cfg = default_config()
    cfg["lm_iterations"] = lm_iterations
    return sp.MGStatePlanner(
        graph, sp.MGStatePlanningSettings(**PLANNER_SETTINGS), config=cfg,
        device=device, sampler=_host_sampler(graph, PLANNER_SEED),
        hand_collision_boundary=_HandBoundary())


def _hand_at(skel, frames, pose_buffer, frame_idx):
    """The RightHand's world position at frames[frame_idx] of a step's
    primitive-local frames under the step's aligning transform onto the
    pose buffer (the frame the IK snap solves in)."""
    import torch
    from morphablegraphs_tpu_torch.models.skeleton import fk_positions
    from morphablegraphs_tpu_torch.ops import align, quat
    f = torch.as_tensor(np.asarray(frames, np.float32))
    q_y, delta = align.node_aligning_2d_transform(
        torch.as_tensor(np.asarray(pose_buffer[-1], np.float32)), f[0])
    hand = fk_positions(skel, f[frame_idx])[skel.index_of("RightHand")]
    return (quat.rotate_vec(q_y, hand) + delta).numpy()


def _instrument(planner):
    """Record on the planner: `steps` (each generate_step's seconds),
    `looked_at` (the ids of the entries whose step had a look-at target),
    `snaps` ((frames, pose buffer, snapped frames) of each IK snap) and
    `ties` (per built state's id, the joints whose seam hemisphere pick
    is within PLANNER_SEAM_COS_EPS of a tie) and `end_dir_corrections`
    (the end-target heading corrections force_walk_end_targets made)."""
    import torch
    from morphablegraphs_tpu_torch.ops import align
    generate_step = planner.generate_step
    snap = planner._snap_keyframe_constraints
    build_state = planner.state_queue.build_state
    planner.steps, planner.looked_at, planner.snaps, planner.ties = \
        [], set(), [], {}

    def timed_step(*a, **kw):
        t0 = time.perf_counter()
        out = generate_step(*a, **kw)
        planner.steps.append(time.perf_counter() - t0)
        if kw.get("body_orientation_targets") is not None:
            planner.looked_at.add(id(out))
        return out

    def recorded_snap(frames, pose_buffer, resolved_kf):
        out = snap(frames, pose_buffer, resolved_kf)
        planner.snaps.append((frames, pose_buffer, out))
        return out

    def recorded_build(frames, pose_buffer, ignore_rotation=False):
        state = build_state(frames, pose_buffer, ignore_rotation)
        if pose_buffer:
            prev = torch.as_tensor(np.asarray(pose_buffer[-1], np.float32))
            first = torch.as_tensor(np.asarray(frames[:1], np.float32))
            q_y, delta = align.node_aligning_2d_transform(prev, first[0])
            a = align.transform_frames(first, q_y, delta)[0, 3:].reshape(
                -1, 4)
            b = prev[3:].reshape(-1, 4)
            cos = (a * b).sum(-1) / (torch.linalg.vector_norm(a, dim=-1)
                                     * torch.linalg.vector_norm(b, dim=-1))
            planner.ties[id(state)] = (cos.abs()
                                       < PLANNER_SEAM_COS_EPS).numpy()
        return state
    end_dir = planner.state_queue.correct_last_state_end_dir

    def counted_end_dir(*a, **kw):
        planner.end_dir_corrections += 1
        return end_dir(*a, **kw)
    planner.end_dir_corrections = 0
    planner.generate_step = timed_step
    planner._snap_keyframe_constraints = recorded_snap
    planner.state_queue.build_state = recorded_build
    planner.state_queue.correct_last_state_end_dir = counted_end_dir
    return planner


def _stream(planner, actions):
    """Run the actions through start(), popping states on this thread
    (the newest one left queued while the worker runs) until the worker
    ends -> (entries, wall seconds); the planner holds `_instrument`'s
    records."""
    _instrument(planner)
    entries = []
    t0 = time.perf_counter()
    worker = planner.start(actions)
    while worker.is_alive() or len(planner.state_queue):
        e = planner.state_queue.pop(keep=1 if worker.is_alive() else 0)
        if e is None:
            time.sleep(0.002)
        else:
            entries.append(e)
    planner.stop()
    wall = time.perf_counter() - t0
    if worker.is_alive():
        _fail("the planner's worker did not end")
    return entries, wall


def _probe_target(graph, device, lm_iterations):
    """The RightHand's target: PLANNER_PROBES sessions with the draw
    table, each aiming at where the one before put the hand at
    end_contact before its snap, plus PLANNER_TARGET_OFFSET (the step's
    LM moves the hand with its target, so the target is iterated toward
    a place the session's hand goes).  -> the target, the probes' hand
    misses before their snaps."""
    target, misses = np.array([0.0, 100.0, 0.0]), []
    for _ in range(PLANNER_PROBES):
        p = _instrument(_planner(graph, device, lm_iterations))
        p.generate_motion_states_from_action_sequence(
            _planner_actions(target))
        if len(p.snaps) != 1:
            _fail(f"a probe session snapped {len(p.snaps)} steps, not 1")
        frames, buf, _ = p.snaps[0]
        hand = _hand_at(graph.skeleton, frames, buf,
                        PLANNER_CONTACT_FRAMES[1])
        misses.append(round(float(np.linalg.norm(hand - target)), 2))
        target = hand + PLANNER_TARGET_OFFSET
    return target, misses


def _twists(skel, frames, table):
    """Twist angles [T, J] of frames about the limit table's axes."""
    axes = table[0]
    q = frames[:, 3:].reshape(len(frames), -1, 4).astype(np.float64)
    q = np.where(q[..., :1] < 0, -q, q)
    return 2 * np.arctan2((q[..., 1:] * axes).sum(-1), q[..., 0])


def _check_session(graph, planner, entries, target, label):
    """The session's checks (each fails the script): finite frames, root
    seams, the snapped hand, the clamped twists, the reach state's events
    and hold frames; planner holds `_instrument`'s records.  -> a summary
    line."""
    from morphablegraphs_tpu_torch.models import skeleton_models
    skel = graph.skeleton
    keys = [e.node_key for e in entries]
    if ("pickRight", "reach") not in keys or len(entries) < 8:
        _fail(f"planner {label}: states {keys}")
    if not all(np.all(np.isfinite(e.state.frames)) for e in entries):
        _fail(f"planner {label}: a state holds NaN or inf")
    seams = [float(np.linalg.norm(b.state.frames[0][:3]
                                  - a.state.frames[-1][:3]))
             for a, b in zip(entries, entries[1:])]
    if max(seams) > PLANNER_SEAM:
        _fail(f"planner {label}: a root seam jumps {max(seams):.3f} cm "
              f"(> {PLANNER_SEAM})")
    reach = entries[keys.index(("pickRight", "reach"))]
    kf, end = PLANNER_CONTACT_FRAMES
    if list(reach.events) != [kf] or reach.hold_frames != tuple(
            range(kf, end + 1)):
        _fail(f"planner {label}: the reach state's events {reach.events} "
              f"and hold frames {reach.hold_frames}")
    # the snapped hand in the frame the snap solves in: the step's aligning
    # transform applied to its primitive-local frames (the queue applies
    # it to the root, which agrees with it for unit quaternions only)
    if len(planner.snaps) != 1:
        _fail(f"planner {label}: {len(planner.snaps)} IK snaps, not 1")
    frames, buf, snapped = planner.snaps[0]
    miss = float(np.linalg.norm(_hand_at(skel, snapped, buf, end)
                                - target))
    pre = float(np.linalg.norm(_hand_at(skel, frames, buf, end) - target))
    if miss > PLANNER_TARGET_MISS:
        _fail(f"planner {label}: the snapped RightHand misses its target "
              f"by {miss:.3f} cm (> {PLANNER_TARGET_MISS}; {pre:.3f} before "
              "the snap)")
    # the look-at window (the last look_at_window frames) of the states
    # with a look-at target: every limited joint's twist inside its range
    table = skeleton_models.build_limit_table(skel)
    _, mins, maxs, mask = table
    on = mask > 0
    window = planner.settings.look_at_window
    worst, at_bound = 0.0, 0
    looked = [e for e in entries if id(e) in planner.looked_at]
    if not looked:
        _fail(f"planner {label}: no state carries the look-at edit")
    for e in looked:
        t = _twists(skel, e.state.frames[-window:], table)[:, on]
        worst = max(worst, float(np.max(np.maximum(mins[on] - t,
                                                   t - maxs[on]))))
        at_bound += int((np.minimum(np.abs(t - mins[on]),
                                    np.abs(t - maxs[on])) < 1e-4).sum())
    if worst > PLANNER_TWIST_TOL or at_bound == 0:
        _fail(f"planner {label}: a clamped twist lies {worst:.2e} rad "
              f"outside its range, {at_bound} twists at a bound")
    return (f"{len(entries)} states, "
            f"{sum(len(e.state.frames) for e in entries)} frames, largest "
            f"root seam {max(seams):.2e} cm, end targets forced "
            f"{planner.end_dir_corrections} time(s), RightHand miss "
            f"{miss:.4f} cm "
            f"after the snap ({pre:.2f} before), limited twists past a "
            f"bound by at most {worst:.1e} rad ({at_bound} at a bound in "
            f"the look-at windows of {len(looked)} states)")


def phase_planner(graph, device, smi: str):
    """Phase 15: the target's probes, a warm session (which also records
    the shapes each kernel gets), then PLANNER_REPS timed sessions, each
    through start() with the main thread popping states: states, frames,
    steps, wall seconds, p50 step, the launches of B2, B5 and the emit
    kernel per session (each above 0) and the session's checks.  ->
    (launches of the last timed session, {kernel: {shape: launches}},
    phase seconds)."""
    import torch
    from morphablegraphs_tpu_torch.ops import kernels
    t_phase = time.perf_counter()
    target, misses = _probe_target(graph, device, 10)
    shapes = {k: {} for k in REQUEST_KERNELS}
    runs = []
    for rep in range(PLANNER_REPS + 1):
        planner = _planner(graph, device)
        saved = _record_shapes(shapes) if rep == 0 else {}
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        try:
            entries, wall = _stream(planner, _planner_actions(target))
        finally:
            _restore_kernels(saved)
        counts = kernels.launch_counts()
        if any(counts[k] <= 0 for k in REQUEST_KERNELS):
            _fail(f"the planner session did not launch B2, B5 and the emit "
                  f"kernel: {counts}")
        summary = _check_session(graph, planner, entries, target,
                                 "warm" if rep == 0 else f"timed {rep}")
        runs.append((wall, planner.steps, counts, summary))
    steps = [s for _, st, _, _ in runs[1:] for s in st]
    launches = [tuple(c[k] for k in REQUEST_KERNELS) for _, _, c, _ in runs]
    others = [sum(v for k, v in c.items() if k not in REQUEST_KERNELS)
              for _, _, c, _ in runs]
    print(f"planner: MGStatePlanner.start() on {device} ({smi}), one warm "
          f"and {PLANNER_REPS} timed sessions: wall s "
          f"{[round(w, 3) for w, _, _, _ in runs]} (warm first), steps per "
          f"session {[len(st) for _, st, _, _ in runs]}, p50 step "
          f"{float(np.median(steps)):.4f} s, launches per session of "
          f"B2/B5/emit {launches}, of the other port kernels {others}; "
          f"{runs[-1][3]}; RightHand target {np.round(target, 2).tolist()} "
          f"(the probes' hands {misses} cm from their targets before the "
          "snap)", flush=True)
    print("planner: kernel shapes in the warm session (launches of each) "
          + str({k: {str(s): n for s, n in v.items()}
                 for k, v in shapes.items()}), flush=True)
    return runs[-1][2], shapes, time.perf_counter() - t_phase


_KERNEL_OF = {"chol_solve": "chol_solve", "gmm_nll": "gmm_scores",
              "emit_frames": "emit_frames",
              "score_locomotion_candidates": "score_locomotion_candidates"}
# the shape key of each wrapper's call: B2 [C, n, n]; B5 (rows, mixtures);
# the emit kernel (C, frames, has_prev, seam window); B1 (C, candidates,
# table rows)
_SHAPE_OF = {"score_locomotion_candidates": lambda mop, alphas, table, cfg:
             (alphas.shape[0], alphas.shape[1], table.shape[1]),
             "chol_solve": lambda a, g: tuple(a.shape),
             "gmm_nll": lambda x, w, *r: (x.shape[0], w.shape[0]),
             "emit_frames": lambda *a: (a[0].shape[0], a[5].shape[-1],
                                        bool(a[8]), int(a[9]))}


def _record_shapes(shapes):
    """Wrap the wrappers of the kernels named in `shapes` (of B1, B2,
    B5 and the emit kernel) so that each call counts its shape in
    shapes[kernel name] -> the wrappers' originals, for _restore_kernels."""
    from morphablegraphs_tpu_torch.ops import kernels
    saved = {}
    for name, key_of in _SHAPE_OF.items():
        if _KERNEL_OF[name] not in shapes:
            continue
        orig = saved[name] = getattr(kernels, name)
        seen = shapes[_KERNEL_OF[name]]

        def wrapper(*a, orig=orig, key_of=key_of, seen=seen, **kw):
            key = key_of(*a)
            seen[key] = seen.get(key, 0) + 1
            return orig(*a, **kw)
        setattr(kernels, name, wrapper)
    return saved


def _restore_kernels(saved):
    from morphablegraphs_tpu_torch.ops import kernels
    for name, orig in saved.items():
        setattr(kernels, name, orig)


def _hold_shapes(prim, device, shapes, held, label: str, seed: int):
    """B2, B5 and the emit kernel against their twins (phase 4's, 7's and
    8's tolerances) at each recorded shape not in `held`, on inputs drawn
    from `prim`'s mixture (its eigen basis for the emit kernel): B2 on
    random SPD systems of that batch, B5 on the rows over that many copies
    of the mixture, the emit kernel at that batch, frame count, previous
    clip and seam window.  Each result queues its kernel line.  ->
    {kernel name: [results]}."""
    import torch
    from morphablegraphs_tpu_torch.models import primitive as prim_mod
    from morphablegraphs_tpu_torch.ops import kernels
    gen = torch.Generator(device=device).manual_seed(seed)
    gm = prim.gmm
    out = {k: [] for k in held}
    for shape in sorted(s for s in shapes["chol_solve"]
                        if s not in held["chol_solve"]):
        c, n, _ = shape
        j = torch.randn((c, 40, n), generator=gen, device=device)
        a = torch.bmm(j.transpose(1, 2), j) + 0.1 * torch.eye(
            n, device=device)
        g = torch.randn((c, n), generator=gen, device=device)
        x_k, x_t = kernels.chol_solve(a, g), kernels.chol_solve_unrolled(a, g)
        err = (x_k - x_t).abs()
        if bool((err > B2_ATOL + B2_RTOL * x_t.abs()).any()):
            _fail(f"B2 at the {label}'s {list(shape)} disagrees with its twin")
        bound_ms, by = _bound(_nbytes(a, g, x_k), c * (n ** 3 / 3 + 2 * n * n))
        r = dict(shape=str(list(shape)), max_abs_err=float(err.max()),
                 plain_ms=_time_ms(lambda: kernels.chol_solve_unrolled(a, g),
                                   5),
                 bound_ms=bound_ms, bound_by=by,
                 library_ms=_time_ms(lambda: torch.linalg.solve_ex(a, g), 50))
        out["chol_solve"].append(r)
        _kernel_line(f"{label} B2 chol_solve {r['shape']}: max_abs_err="
                     f"{r['max_abs_err']:.3e}",
                     lambda a=a, g=g: kernels.chol_solve(a, g), 50, bound_ms,
                     f"(bound_ms={bound_ms:.6f}, {by})", r)
    for rows, n_mix in sorted(s for s in shapes["gmm_scores"]
                              if s not in held["gmm_scores"]):
        args = (1.5 * prim_mod.sample_latent(gen, prim, rows),
                gm.weights[None].expand(n_mix, -1).contiguous(),
                gm.means[None].expand(n_mix, -1, -1).contiguous(),
                gm.prec_chol[None].expand(n_mix, -1, -1, -1).contiguous(),
                torch.arange(rows, device=device) % n_mix)
        nll_k, g_k = kernels.gmm_nll_and_grad(*args)
        nll_t, g_t = kernels.gmm_nll_and_grad_ref(*args)
        worst = max(float((nll_k - nll_t).abs().max()),
                    float((g_k - g_t).abs().max()))
        if bool(((nll_k - nll_t).abs() > B5_ATOL + B5_RTOL
                 * nll_t.abs()).any()) or bool(
                ((g_k - g_t).abs() > B5_ATOL + B5_RTOL * g_t.abs()).any()):
            _fail(f"B5 on the {label}'s {rows} rows disagrees with its twin")
        k, d = gm.means.shape
        bound_ms, by = _bound(_nbytes(*args, nll_k, g_k),
                              rows * k * (4 * d * d + 3 * d))
        r = dict(shape=f"[{rows}, K={k}, D={d}] over {n_mix} mixture(s)",
                 max_abs_err=worst,
                 plain_ms=_time_ms(lambda args=args:
                                   kernels.gmm_nll_and_grad_ref(*args), 5),
                 bound_ms=bound_ms, bound_by=by, library_ms=None)
        out["gmm_scores"].append(r)
        _kernel_line(f"{label} B5 gmm_nll_and_grad {r['shape']}: "
                     f"max_abs_err={worst:.3e}",
                     lambda args=args: kernels.gmm_nll_and_grad(*args), 50,
                     bound_ms, f"(bound_ms={bound_ms:.6f}, {by})", r)
    s = prim_mod.sample_latent(gen, prim, 1)[0]
    n_can = prim.n_canonical_frames
    for c, t_max, has_prev, win in sorted(
            s_ for s_ in shapes["emit_frames"]
            if s_ not in held["emit_frames"]):
        t_fn = torch.linspace(0.0, n_can - 1.0, t_max, device=device)
        prev = (prim_mod.evaluate_at(prim, s, t_fn[-1:].clone())
                if has_prev else None)
        args = (s[None, : prim.n_spatial].expand(c, -1), prim.eigen_s[None],
                prim.mean_s[None], prim.knots_s[None],
                torch.zeros(c, dtype=torch.long, device=device),
                t_fn[None].expand(c, -1),
                torch.full((c,), t_max, dtype=torch.int32, device=device),
                None if prev is None else prev.expand(c, -1), has_prev, win)
        f_k, l_k = kernels.emit_frames(*args)
        f_t, l_t = kernels.emit_frames_ref(*args)
        skip = _near_equator(args, f_t)
        keep = torch.cat([torch.ones((c, 3), dtype=torch.bool,
                                     device=device),
                          (~skip).repeat_interleave(4, dim=1)], dim=1)
        err = (f_k - f_t).abs() * keep[:, None]
        if not bool(torch.isfinite(f_k).all()) or bool(
                (err > B6_ATOL + B6_RTOL * f_t.abs()).any()):
            _fail(f"emit_frames at the {label}'s [{c}, {t_max}] "
                  f"has_prev={has_prev} disagrees with its twin")
        nd, kk = f_k.shape[-1], prim.n_spatial
        bound_ms, by = _bound(
            _nbytes(*(x for x in args[:8] if x is not None), f_k, l_k),
            c * (2 * prim.n_basis * nd * kk
                 + (8 + 10 * has_prev) * t_max * nd))
        r = dict(shape=f"[{c}, T={t_max}, n_basis={prim.n_basis}, "
                 f"n_dim={nd}, K={kk}] has_prev={has_prev} window={win}",
                 max_abs_err=float(err.max()),
                 plain_ms=_time_ms(lambda args=args:
                                   kernels.emit_frames_ref(*args), 5),
                 bound_ms=bound_ms, bound_by=by, library_ms=None)
        out["emit_frames"].append(r)
        _kernel_line(f"{label} B6 emit_frames {r['shape']}: max_abs_err="
                     f"{r['max_abs_err']:.3e} (tol {B6_ATOL}+{B6_RTOL}*|x|)",
                     lambda args=args: kernels.emit_frames(*args), 50,
                     bound_ms, f"(bound_ms={bound_ms:.6f}, {by}) twin_ms="
                     f"{r['plain_ms']:.4f}", r)
    torch.cuda.synchronize()
    return out


def phase_planner_kernels(graph, device, shapes):
    """The planner's kernel shapes that phases 13-14 do not hold at
    exactly that size, against their twins (B5's and the emit kernel's
    tolerances): B2 other than [1, 28, 28], B5 on other row counts of one
    mixture, the emit kernel at C = 1 at other frame counts or options.
    -> {kernel name: [results]}."""
    from morphablegraphs_tpu_torch.synthesis.motion_generator import \
        _pad_frames
    f = graph.nodes[("walk", "leftStance")].primitive.n_canonical_frames
    held = {"chol_solve": {(1, 28, 28)},
            "gmm_scores": {(1, 1), (50, 1), (3, 3)},
            "emit_frames": {(1, _pad_frames(f), True, 20),
                            (1, _pad_frames(2 * f), False, 20),
                            (1, _pad_frames(f), False, 0)}}
    prim = graph.nodes[("pickRight", "reach")].primitive.to(device)
    out = _hold_shapes(prim, device, shapes, held, "planner", seed=37)
    print(f"planner: kernels held against their twins at the planner's new "
          f"shapes: { {k: [r['shape'] for r in v] for k, v in out.items()} }"
          f"; the others phases 13-14 hold at exactly that size", flush=True)
    if not out["emit_frames"]:
        _fail("the planner's gesture resampling gave the emit kernel no "
              "frame count of its own")
    return out


def phase_planner_reference(graph):
    """The session at one LM iteration on the GPU path (kernels) and on the
    CPU path (twins), each through start(), with the same draw table and a
    target probed at one iteration: node keys, frame counts, events and
    hold frames equal, frames within PLANNER_FRAMES_ATOL (joint
    quaternions up to sign; seam windows of near-tied joints left out, see
    PLANNER_SEAM_COS_EPS).  -> the phase's seconds."""
    t0 = time.perf_counter()
    target, _ = _probe_target(graph, "cuda", 1)
    runs, times = {}, {}
    for dev in ("cuda", "cpu"):
        t1 = time.perf_counter()
        p = _planner(graph, dev, lm_iterations=1)
        entries, _ = _stream(p, _planner_actions(target))
        runs[dev] = (p, entries)
        times[dev] = time.perf_counter() - t1
    (p_a, a), (p_b, b) = runs["cuda"], runs["cpu"]
    same = ([(e.node_key, len(e.state.frames), e.events, e.hold_frames)
             for e in a] == [(e.node_key, len(e.state.frames), e.events,
                              e.hold_frames) for e in b])
    worst, flips, left_out = (float("inf") if not same else 0.0), 0, 0
    window = p_a.settings.blend_window
    for x, y in zip(a, b) if same else ():
        fx, fy = x.state.frames.copy(), y.state.frames.copy()
        ties = np.zeros((fx.shape[1] - 3) // 4, bool)
        for p, e in ((p_a, x), (p_b, y)):
            ties |= p.ties.get(id(e.state), ties)
        for j in np.flatnonzero(ties):
            fx[: window + 1, 3 + 4 * j: 7 + 4 * j] = 0.0
            fy[: window + 1, 3 + 4 * j: 7 + 4 * j] = 0.0
        left_out += int(ties.sum())
        d, f = _quat_frames_diff(fx, fy)
        worst, flips = max(worst, d), flips + f
    print(f"planner reference (1 LM iteration): GPU {times['cuda']:.2f} s "
          f"vs CPU {times['cpu']:.2f} s, {len(a)} states, node keys, frame "
          f"counts, events and hold frames equal={same}, frames max abs "
          f"diff {worst:.3e} (tol {PLANNER_FRAMES_ATOL}; {flips} joint "
          f"quaternions with the other sign, {left_out} near-tied seam "
          "windows left out)", flush=True)
    summary = _check_session(graph, p_a, a, target, "reference")
    print(f"planner reference: {summary}", flush=True)
    if not same or worst > PLANNER_FRAMES_ATOL:
        _fail("the planner's GPU session disagrees with its CPU session")
    return time.perf_counter() - t0

def _traj_request(end_x, end_z):
    return {
        "startPose": {"position": [0, 0, 0], "orientation": [0, 0, 0]},
        "elementaryActions": [{
            "action": "walk",
            "constraints": [{"joint": "Hips", "trajectoryConstraints": [
                {"position": [0, None, 0]},
                {"position": [end_x / 2, None, end_z / 2]},
                {"position": [end_x, None, end_z]}]}],
        }],
    }


def phase_serve(graph, device):
    import torch
    from morphablegraphs_tpu_torch import parallel
    from morphablegraphs_tpu_torch.ops import kernels
    from morphablegraphs_tpu_torch.serve.batch import BatchedGenerator
    bg = BatchedGenerator(graph, device=device)
    sharded, through = parallel.constrained_crowd_sharded, []

    def counting(devices, *args, **kw):
        through.append([str(d) for d in devices])
        return sharded(devices, *args, **kw)

    parallel.constrained_crowd_sharded = counting
    reqs = _serving_requests()
    batchable, _, parsed = bg.split_batchable(reqs)
    if batchable != list(range(len(reqs))):
        _fail(f"serving: requests not batchable: {batchable}")
    if bg.walk_config().lm_frozen:
        _fail("serving must run the exact LM, as the JAX package's")
    bg.generate_batch(reqs, parsed_list=parsed)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    outs = bg.generate_batch(reqs, parsed_list=parsed)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = kernels.launch_counts()
    parallel.constrained_crowd_sharded = sharded
    if through != [[str(device)]] * 2:
        _fail("serving did not go through parallel.constrained_crowd_sharded "
              f"on {device}: {through}")
    n_frames = [o.shape[0] for o in outs]
    finite = all(np.all(np.isfinite(o)) for o in outs)
    print(f"serve: BatchedGenerator (exact LM, through parallel/ on "
          f"{through[0]}) answered {len(outs)} requests "
          f"in {dt:.3f} s, frames per request {n_frames}, all finite="
          f"{finite}, launches {counts}", flush=True)
    if not finite or min(n_frames) <= 30:
        _fail("serving output is not finite or too short")
    if any(counts[k] <= 0 for k in ("score_locomotion_candidates",
                                    "chol_solve", "gmm_scores",
                                    "emit_frames")):
        _fail("serving did not launch B1, B2, B5 and the emit kernel (B6)")
    return counts


# the walks of phases 10-11: WalkConfig flags, and whether the constraint
# sets carry bench.py's RightHand keyframe (the ee config)
WALKS = {
    "root": (dict(lm_frozen=True), False),  # bench.py's headline
    "ee": (dict(pallas_ee=EE_JOINT, lm_frozen=True, frozen_ee=EE_JOINT),
           True),
    "ee_fused": (dict(pallas_ee=EE_JOINT, lm_frozen=True,
                      frozen_ee=EE_JOINT, lm_fused_step=True), True),
    "lm_exact": (dict(lm_frozen=False), False),
    "ee_exact": (dict(pallas_ee=EE_JOINT, lm_frozen=False), True),
    # every constraint family (`_families_scs`) and the half step: no
    # selection kernel scores them, so the exact evaluator ranks
    "families": (dict(pallas_selection=False, lm_frozen=False, use_ca=True,
                      use_ts=True, use_half=True), False),
}
CROWDS = tuple(WALKS)  # the walks of phase 11
# phase 10 only: the general selection path (the exact evaluator ranks the
# candidates), with an orientation keyframe on the hand, which the selection
# kernels would refuse
WALKS["general"] = (dict(pallas_selection=False, lm_frozen=False), False)
GENERAL_QUAT = (0.9659258, 0.0, 0.2588190, 0.0)  # 30 degrees about Y
# kernels each walk must launch (> 0) and must not launch (== 0): every
# walk emits its frames through the emit kernel (B6's source) and takes its
# LM's GMM term from B5 (the closed frozen LM directly, the exact LM
# through `kernels.gmm_nll`)
WALK_KERNELS = {
    "root": (("score_locomotion_candidates", "chol_solve", "gmm_scores",
              "emit_frames"), ("lm_delta", "crowd_back_project")),
    "ee": (("score_locomotion_candidates_ee", "chol_solve", "gmm_scores",
            "emit_frames"), ("lm_delta", "crowd_back_project")),
    "ee_fused": (("score_locomotion_candidates_ee", "lm_delta", "gmm_scores",
                  "emit_frames"), ("chol_solve", "crowd_back_project")),
    "lm_exact": (("score_locomotion_candidates", "chol_solve", "gmm_scores",
                  "emit_frames"), ("lm_delta", "crowd_back_project")),
    "ee_exact": (("score_locomotion_candidates_ee", "chol_solve",
                  "gmm_scores", "emit_frames"),
                 ("lm_delta", "crowd_back_project")),
    "families": (("chol_solve", "gmm_scores", "emit_frames"),
                 ("score_locomotion_candidates",
                  "score_locomotion_candidates_ee", "lm_delta",
                  "crowd_back_project")),
}


def _walk_cfg(name: str, lm_iters: int = 3):
    from morphablegraphs_tpu_torch.synthesis import constrained_walk as cw
    return cw.WalkConfig(max_step_frames=160, n_samples=128,
                         lm_iters=lm_iters, lm_threshold=5.0,
                         **WALKS[name][0])


# the families walk's user slots on the reference-scale skeleton, each one the
# reference's action builder emits (look-at, pose, CA) or its input format
# carries (joint rotation, relative transform, trajectory set):
FAM_LOOK_AT = (0.0, 170.0, 400.0)  # Head gazes at a point ahead, frame 129
FAM_JR = ("Spine1", (0.9914449, 0.1305262, 0.0, 0.0), 65.0)  # 15 deg about x
# LeftHand 36 cm along RightHand's x axis (the rest pose's hand spacing)
FAM_RT = ("LeftHand", "RightHand", (36.0, 0.0, 0.0), 65.0)
FAM_CA = (("RightHand", (-20.0, 70.0, 60.0)), ("LeftHand", (20.0, 70.0, 60.0)))
# the hands follow straight 150 cm splines at hand height beside the root
FAM_TS = (("RightHand", ((-18.0, 67.0, 0.0), (-18.0, 67.0, 150.0))),
          ("LeftHand", ((18.0, 67.0, 0.0), (18.0, 67.0, 150.0))))


def _families_scs(skel, stacked, n_steps: int):
    """The families walk's per-step sets: the FAM_* slots on every step,
    and at step 0 the transition pose, every node at the FK of the start
    node's mean first frame (a clamped spline's first coefficient row)."""
    from morphablegraphs_tpu_torch.constraints import compiled
    from morphablegraphs_tpu_torch.ops import spline_path
    from morphablegraphs_tpu_torch.synthesis import constrained_walk as cw
    sc = compiled.empty_step_constraints(skel, 0)
    sc = compiled.set_look_at_constraint(sc, skel, "Head", FAM_LOOK_AT, 129.0)
    sc = compiled.set_joint_rotation_constraint(sc, skel, FAM_JR[0], FAM_JR[1],
                                                FAM_JR[2])
    sc = compiled.set_relative_transform_constraint(sc, skel, *FAM_RT)
    for slot, (joint, pos) in enumerate(FAM_CA):
        sc = compiled.set_ca_constraint(sc, skel, joint, pos, slot=slot)
    sc = compiled.set_trajectory_set_constraint(
        sc, skel, [j for j, _ in FAM_TS],
        [spline_path.build(np.asarray(pts, np.float32), granularity=256)
         for _, pts in FAM_TS])
    start = stacked.node_id(("walk", "beginLeftStance"))
    first = stacked.mean_s[start].reshape(stacked.n_basis_max,
                                          stacked.n_dim)[0]
    sc = compiled.set_pose_constraint(sc, skel, first.cpu().numpy())
    scs = cw.stack_steps(sc, n_steps)
    pose = np.zeros(n_steps, np.float32)
    pose[0] = 1.0
    return scs.replace(pose_active=pose)


def _step_scs(skel, name: str, n_steps: int, stacked=None):
    """bench.py's per-step constraint sets: empty, or with ee a RightHand
    keyframe at EE_TARGET on canonical frame 129 in user slot 2; for the
    general walk a RightHand orientation keyframe there; for the families
    walk `_families_scs`."""
    from morphablegraphs_tpu_torch.constraints import compiled
    from morphablegraphs_tpu_torch.synthesis import constrained_walk as cw
    if name == "families":
        return _families_scs(skel, stacked, n_steps)
    if name == "general":  # an orientation keyframe: no kernel ranks it
        base = compiled.set_keyframe_constraint(
            compiled.empty_step_constraints(skel, 0), 2, skel, EE_JOINT,
            EE_FRAME, quat_wxyz=np.asarray(GENERAL_QUAT, np.float32))
        return cw.stack_steps(base, n_steps)
    if not WALKS[name][1]:
        return cw.default_step_scs(skel, n_steps)
    base = compiled.set_keyframe_constraint(
        compiled.empty_step_constraints(skel, 0), 2, skel, EE_JOINT,
        EE_FRAME, position=np.asarray(EE_TARGET, np.float32))
    return cw.stack_steps(base, n_steps)


def _stepwise(skel, stacked, paths, start, n_steps, draws, scs, cfg, dev,
              states=None):
    """The crowd walk step by step on `dev`: -> (each step's input state,
    each step's StepOutput, the final state).  With `states` (another run's
    input states) every step starts from that run's state instead of this
    run's own: teacher forcing, so one step's difference does not carry."""
    import torch
    from morphablegraphs_tpu_torch.constraints import compiled
    from morphablegraphs_tpu_torch.ops import kernels
    from morphablegraphs_tpu_torch.synthesis import constrained_walk as cw
    from morphablegraphs_tpu_torch.synthesis import walk
    root_only = compiled.step_scs_root_only(scs)
    cw.check_walk_contract(skel, scs, cfg, root_only)
    table = kernels.pack_path_table(paths, torch.as_tensor(
        skel.offsets[0], device=dev))
    ee = None
    if cfg.pallas_ee is not None:
        idx, const = kernels.pack_ee_chain(skel, cfg.pallas_ee)
        ee = (idx, torch.as_tensor(const, device=dev))
    c = paths.table_arc.shape[0]
    state = cw.initial_state(stacked, torch.full((c,), start, device=dev))
    ins, outs = [], []
    for t in range(n_steps):
        if states is not None:
            state = cw.WalkState(*(x.to(dev) for x in (
                states[t].node_id, states[t].prev_last, states[t].travelled,
                states[t].done)))
        ins.append(state)
        d = draws[t]
        state, out = cw.full_walk_step(
            skel, stacked, paths, table, state, t,
            cw.step_constraints(scs, t, c, dev),
            walk.StepDraws(d.comp_gumbel.to(dev), d.normal.to(dev),
                         d.trans_gumbel.to(dev)), cfg, root_only, ee)
        outs.append(out)
    return ins, outs, state


def phase_reference(stacked_gpu, skel):
    """The same small walks on the GPU path (kernels) and the CPU path
    (twins), with the same draws.  Without the LM, node ids, frame counts
    and frames must agree (frames within 1e-2, the whole-walk bound).  With
    an LM, whose accept test can fall either way on a knife edge, node ids
    and frame counts must agree and the constraint errors within
    0.05 + 1e-2 |err|.  The root-only walks (frozen and exact LM) are held
    to that over the whole walk.  The ee walks start from errors of ~1e4
    (the keyframe is far from any pose the model makes), where the
    frozen-ee LM is chaotic: on the CPU, a 1e-6 relative change of the
    candidates moves the step-0 error by up to 18% after 3 iterations and
    by 0.26% after one.  So the ee walks are held to the same bounds with
    one LM iteration, step by step, each CPU step starting from the GPU
    walk's state (teacher forcing); the 3-iteration ee walk is printed.
    The families walk (every constraint family and the half step, general
    selection, the exact LM at one iteration) is held over the whole walk,
    without teacher forcing."""
    import torch
    from morphablegraphs_tpu_torch.ops import spline_path
    from morphablegraphs_tpu_torch.synthesis import constrained_walk as cw
    from morphablegraphs_tpu_torch.synthesis import walk
    n_chars, n_steps = 8, 3
    rng = np.random.default_rng(3)
    paths = [rand_path(rng, 256, "cpu") for _ in range(n_chars)]
    gen = torch.Generator().manual_seed(11)
    cpu_draws = walk.torch_sampler(gen, stacked_gpu, n_chars, 128)
    draws = [cpu_draws(t) for t in range(n_steps)]
    start = stacked_gpu.node_id(("walk", "beginLeftStance"))
    for name, lm_iters, held in (("root", 0, True), ("root", 3, True),
                                 ("lm_exact", 3, True), ("ee", 1, True),
                                 ("ee_fused", 1, True), ("ee", 3, False),
                                 ("general", 1, True), ("families", 1, True)):
        cfg = _walk_cfg(name, lm_iters)
        scs = _step_scs(skel, name, n_steps, stacked_gpu)
        forced = WALKS[name][1] and held
        runs = {}
        for dev in ("cuda", "cpu"):
            runs[dev] = _stepwise(
                skel, stacked_gpu.to(dev), spline_path.stack_paths(
                    [p.to(dev) for p in paths]), start, n_steps, draws, scs,
                cfg, dev)
        if forced:
            runs["forced"] = _stepwise(
                skel, stacked_gpu.to("cpu"), spline_path.stack_paths(paths),
                start, n_steps, draws, scs, cfg, "cpu",
                states=runs["cuda"][0])

        def arrays(run):
            ins, outs, last = run
            ids = np.stack([o.node_id.cpu().numpy() for o in outs], 1)
            nxt = np.stack([s.node_id.cpu().numpy() for s in ins[1:]]
                           + [last.node_id.cpu().numpy()], 1)
            return (np.stack([o.frames.cpu().numpy() for o in outs], 1),
                    np.stack([o.n_frames.cpu().numpy() for o in outs], 1),
                    ids, nxt,
                    np.stack([o.error.cpu().numpy() for o in outs], 1))

        sg, ng, ig, xg, eg = arrays(runs["cuda"])
        for label in ("cpu", "forced") if forced else ("cpu",):
            sc, nc, ic, xc, ec = arrays(runs[label])
            frame_err = np.abs(sg - sc).max(axis=(2, 3))  # [C, S]
            err_diff = np.abs(eg - ec)
            how = ("teacher-forced steps" if label == "forced"
                   else "whole walk")
            print(f"reference {name} lm_iters={lm_iters}, {how}: GPU vs CPU "
                  f"({n_chars} chars x {n_steps} steps): node ids equal="
                  f"{np.array_equal(ig, ic) and np.array_equal(xg, xc)}, "
                  f"max frame diff per step="
                  f"{frame_err.max(axis=0).tolist()}, max error diff="
                  f"{float(err_diff.max()):.3e} (errors up to "
                  f"{float(np.abs(ec).max()):.1f})", flush=True)
            if (forced and label == "cpu") or not held:
                continue  # chaotic: printed, held step by step
            if not (np.array_equal(ig, ic) and np.array_equal(xg, xc)
                    and np.array_equal(ng, nc)):
                _fail(f"the GPU {name} walk took other nodes than the CPU "
                      "walk")
            if lm_iters == 0 and float(frame_err.max()) > WALK_FRAMES_ATOL:
                _fail("the GPU walk's frames disagree with the CPU walk's")
            if bool((err_diff > 0.05 + 1e-2 * np.abs(ec)).any()):
                _fail(f"the GPU {name} walk's errors disagree with the CPU "
                      "walk's")


def phase_crowd(name, stacked, skel, device, card: str, reps: int = 3,
                n_steps: int = CROWD_STEPS):
    """One benchmark crowd of bench.py (1024 characters): a warm-up run of
    one step, then `reps` timed runs on fresh draws.  Returns (median
    seconds, median frames/s, mean errors, launches, run)."""
    import torch
    from morphablegraphs_tpu_torch.ops import kernels, spline_path
    from morphablegraphs_tpu_torch.synthesis import constrained_walk as cw
    from morphablegraphs_tpu_torch.synthesis import walk
    n_chars = CROWD_CHARS
    rng = np.random.default_rng(0)
    paths = spline_path.stack_paths([rand_path(rng, 256, device)
                                     for _ in range(n_chars)])
    start = torch.full((n_chars,), stacked.node_id(("walk", "beginLeftStance")),
                       device=device)
    cfg = _walk_cfg(name)
    scs = {t: _step_scs(skel, name, t, stacked) for t in (1, n_steps)}

    def run(seed, steps=n_steps):
        gen = torch.Generator(device=device).manual_seed(seed)
        return cw.constrained_walk_full_crowd(
            skel, stacked, paths, start, steps,
            draws=walk.torch_sampler(gen, stacked, n_chars, 128),
            step_scs=scs[steps], cfg=cfg)

    run(1, 1)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    rates, times, errors = [], [], []
    finite = True
    for seed in range(2, 2 + reps):  # timed runs, each on fresh draws
        t0 = time.perf_counter()
        segs, nf, _, errs = run(seed)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        times.append(dt)
        rates.append(float(nf.sum()) / dt)
        errors.append(float(errs[nf > 0].mean()))
        finite = finite and bool(torch.isfinite(segs).all()) and bool(
            torch.isfinite(errs).all())
    counts = kernels.launch_counts()
    fps = float(np.median(rates))
    print(f"crowd {name}: {n_chars} chars x {n_steps} steps on {card}, "
          f"{WALKS[name][0]}: median {fps:.1f} frames/s over {reps} runs "
          f"(seconds {times}, frames/s {rates}), mean_err per run {errors}, "
          f"finite={finite}, launches per run "
          f"{ {k: v / reps for k, v in counts.items() if v} }", flush=True)
    must, must_not = WALK_KERNELS[name]
    if not finite or min(rates) <= 0:
        _fail(f"crowd {name}: output is not finite or empty")
    if any(counts[k] <= 0 for k in must) or any(counts[k] for k in must_not):
        _fail(f"crowd {name}: launched {counts}, needs {must} and not "
              f"{must_not}")
    return float(np.median(times)), fps, errors, counts, run


def phase_random_reference(stacked_gpu):
    """The random walks (concatenating and segment form) and the
    boundary-row constrained walk, small, on the GPU path (B6) and the CPU
    path (its twin) with the same draws: node ids, frame counts and valid
    frames (within the whole-walk bound 1e-2) must agree."""
    import torch
    from morphablegraphs_tpu_torch.ops import spline_path
    from morphablegraphs_tpu_torch.synthesis import constrained_walk as cw
    from morphablegraphs_tpu_torch.synthesis import walk
    n_chars, n_steps = 8, 4
    start = stacked_gpu.node_id(("walk", "beginLeftStance"))
    gen = torch.Generator().manual_seed(12)
    one = [walk.torch_sampler(gen, stacked_gpu, n_chars, 1)(t)
           for t in range(n_steps)]
    many = [walk.torch_sampler(gen, stacked_gpu, n_chars, 64)(t)
            for t in range(n_steps)]
    rng = np.random.default_rng(4)
    paths = [rand_path(rng, 256, "cpu") for _ in range(n_chars)]

    def on(draws, dev):
        return lambda t: walk.StepDraws(*(x.to(dev) for x in (
            draws[t].comp_gumbel, draws[t].normal, draws[t].trans_gumbel)))

    def runs(dev):
        st = stacked_gpu.to(dev)
        ids = torch.full((n_chars,), start, device=dev)
        buf, nv, w_ids, _ = walk.random_walk(st, ids, n_steps, on(one, dev),
                                             max_step_frames=RANDOM_FRAMES)
        seg, nf, s_ids, _ = walk.random_walk_segments(
            st, ids, n_steps, on(one, dev), max_step_frames=RANDOM_FRAMES)
        bseg, bnf, b_ids, _ = cw.constrained_walk(
            st, spline_path.stack_paths([p.to(dev) for p in paths]), ids,
            n_steps, on(many, dev), max_step_frames=RANDOM_FRAMES)
        return {"random_walk": (buf[:, None], nv[:, None], w_ids),
                "random_walk_segments": (seg, nf, s_ids),
                "constrained_walk (boundary rows)": (bseg, bnf, b_ids)}

    gpu, cpu = runs("cuda"), runs("cpu")
    for name, (fg, ng, ig) in gpu.items():
        fc, nc, ic = cpu[name]
        fg, ng, ig = fg.cpu(), ng.cpu(), ig.cpu()
        same = torch.equal(ig, ic) and torch.equal(ng, nc)
        valid = (torch.arange(fg.shape[2])[None, None] < nc[..., None])
        diff = float(((fg - fc).abs() * valid[..., None]).max())
        print(f"reference {name}: GPU vs CPU ({n_chars} chars x {n_steps} "
              f"steps): node ids and frame counts equal={same}, max frame "
              f"diff={diff:.3e} (bound {WALK_FRAMES_ATOL})", flush=True)
        if not same:
            _fail(f"the GPU {name} took other nodes than the CPU walk")
        if diff > WALK_FRAMES_ATOL:
            _fail(f"the GPU {name}'s frames disagree with the CPU walk's")


def _seam_jumps(stacked, buf, n_valid, ids, latents, n_chars: int = 8):
    """The largest root jump between consecutive frames of the first
    n_chars concatenated random walks, and of the same walks' clips
    concatenated by the numpy reference (tests/reference_oracle.py, BASELINE
    config 2's anchor)."""
    import torch
    from morphablegraphs_tpu_torch.synthesis import walk
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "tests"))
    from reference_oracle import oracle_align_concat
    ours, oracle = 0.0, 0.0
    for c in range(n_chars):
        frames = buf[c, : int(n_valid[c])].cpu().numpy()
        ours = max(ours, float(np.linalg.norm(np.diff(frames[:, :3], axis=0),
                                              axis=1).max()))
        steps = [t for t in range(ids.shape[1]) if int(ids[c, t]) >= 0]
        clips = []
        for t in steps:
            f, n = walk.back_project_node(stacked, ids[c, t:t + 1],
                                          latents[c, t:t + 1], RANDOM_FRAMES)
            clips.append(f[0, : int(n[0])].cpu().numpy())
        ref = oracle_align_concat(clips, window=20)[:, :3]
        oracle = max(oracle, float(np.linalg.norm(np.diff(ref, axis=0),
                                                  axis=1).max()))
    return ours, oracle


def phase_random_crowd(name, stacked, device, card: str, reps: int = 3):
    """A random-walk crowd of 1024 characters x 8 steps, 160 frames a step
    (BASELINE config 5): `segments` is random_walk_segments, the benchmark's
    form; `concat` is random_walk, which appends to one buffer per
    character; `canonical` is the segment form without the time warp
    (use_time=False).  A warm-up run, then `reps` timed runs on fresh draws.
    Returns (median seconds, median frames/s, launches, run)."""
    import torch
    from morphablegraphs_tpu_torch.ops import kernels
    from morphablegraphs_tpu_torch.synthesis import walk
    start = torch.full((CROWD_CHARS,),
                       stacked.node_id(("walk", "beginLeftStance")),
                       device=device)
    fn = walk.random_walk if name == "concat" else walk.random_walk_segments
    # the time-warped walks emit through the emit kernel; the canonical
    # timeline builds its basis and goes through B6
    use_time = name != "canonical"
    kernel = "emit_frames" if use_time else "crowd_back_project"

    def run(seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        return fn(stacked, start, CROWD_STEPS,
                  walk.torch_sampler(gen, stacked, CROWD_CHARS, 1),
                  max_step_frames=RANDOM_FRAMES, use_time=use_time)

    run(1)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    rates, times, finite = [], [], True
    for seed in range(2, 2 + reps):
        t0 = time.perf_counter()
        frames, counts, ids, latents = run(seed)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        times.append(dt)
        rates.append(float(counts.sum()) / dt)
        finite = finite and bool(torch.isfinite(frames).all())
    launches = kernels.launch_counts()
    fps = float(np.median(rates))
    print(f"crowd random {name}: {CROWD_CHARS} chars x {CROWD_STEPS} steps, "
          f"{RANDOM_FRAMES} frames a step, on {card}: median {fps:.1f} "
          f"frames/s over {reps} runs (seconds {times}, frames/s {rates}), "
          f"finite={finite}, launches {launches}", flush=True)
    others = [k for k, v in launches.items() if v and k != kernel]
    if not finite or min(rates) <= 0:
        _fail(f"crowd random {name}: output is not finite or empty")
    if launches[kernel] <= 0 or others:
        _fail(f"crowd random {name}: launched {launches}, needs {kernel} "
              "only")
    if name == "concat":
        ours, oracle = _seam_jumps(stacked, frames, counts, ids, latents)
        print(f"crowd random concat: max root seam jump {ours:.3f} cm/frame "
              f"over 8 walks, the numpy reference concatenation of the same "
              f"clips {oracle:.3f} (ratio {ours / max(oracle, 1e-9):.3f})",
              flush=True)
        if not ours <= 1.01 * oracle + 1e-3:
            _fail("the random walk's seams jump further than the reference "
                  "concatenation's")
    return float(np.median(times)), fps, launches, run


# Phase 16: the packaged graph.  The reference-scale walk graph with a
# static idle primitive (a seeded 60-frame clip at D 79), transition models
# on every standard edge (fitted on the card: TM_PAIRS self-supervised
# pairs, TM_COMPONENTS components) and a pfnn/ section at the published
# PFNN widths (Holden et al., SIGGRAPH 2017: input 342, output 311, hidden
# 512, 4 phase control points; seeded weights, as the JAX tests make them:
# no trained weights ship with the repository), written by the port's
# zip_writer and loaded by load_graph on the card; then phase 13's config-3
# request with use_transition_model.
TM_PAIRS, TM_COMPONENTS = 2000, 4
PFNN_X, PFNN_Y, PFNN_HIDDEN, PFNN_CONTROLS = 342, 311, 512, 4
PFNN_CROWD, PFNN_STREAM = 1024, 100
PACKAGE_REPS = 2
IDLE_FRAMES = 60
# write_bvh keeps 6 decimals of a cm and of a degree; float32 roots of up
# to a few hundred cm keep ~3e-5 cm: the round trip holds the root within
# 1e-3 cm and each unit joint quaternion, up to its sign, within 1e-4
BVH_ROOT_ATOL, BVH_QUAT_ATOL = 1e-3, 1e-4
# retargeting: fp32 quaternion products along chains of up to 8 joints,
# contracted into FMAs on the card and not on the CPU
RETARGET_ATOL = 1e-4
# the retargeted positions on the doubled rig: twice the source's, within
# fp32 rounding of positions up to ~400 cm
RETARGET_POS_ATOL = 1e-2
# PFNN: three fp32 layers (sums of 342 and 512 products; TF32 off) on the
# card against the CPU, relative to the output's scale
PFNN_RTOL = 1e-4


def _package_graph_dict(device):
    """The reference-scale walk graph dict plus an idle node whose model
    is a static primitive fitted on `device` to a seeded clip."""
    import torch
    from morphablegraphs_tpu_torch.models.static_primitive import \
        make_static_model_json
    from morphablegraphs_tpu_torch.utils import synthetic
    gd = synthetic.make_reference_scale_graph_dict()
    d = 3 + 4 * synthetic.REF_N_JOINTS
    rng = np.random.default_rng(16)
    ts = np.linspace(0, 2 * np.pi, IDLE_FRAMES)[:, None]
    clip = np.sin(ts + rng.uniform(0, np.pi, d)[None]) * 0.2
    clip[:, :3] = [0.0, 90.0, 0.0] + 2.0 * np.sin(ts)
    q = clip[:, 3:].reshape(IDLE_FRAMES, -1, 4)
    q[..., 0] += 1.0
    clip[:, 3:] = (q / np.linalg.norm(q, axis=-1, keepdims=True)).reshape(
        IDLE_FRAMES, -1)
    idle = make_static_model_json(
        torch.as_tensor(clip, dtype=torch.float32, device=device),
        n_basis=16, name="walk_idle")
    walk = gd["subgraphs"]["walk"]
    walk["nodes"]["idle"] = {"name": "walk_idle", "mm": idle}
    walk["info"]["idle_states"] = ["idle"]
    gd["transitions"]["walk_idle"] = ["walk_beginLeftStance"]
    gd["transitions"]["walk_endRightStance"] = ["walk_idle"]
    return gd, clip


def _pfnn_arrays():
    rng = np.random.default_rng(17)
    p, h, x, y = PFNN_CONTROLS, PFNN_HIDDEN, PFNN_X, PFNN_Y
    weights = {"W0": rng.standard_normal(p * h * x) * 0.1,
               "W1": rng.standard_normal(p * h * h) * 0.1,
               "W2": rng.standard_normal(p * y * h) * 0.1,
               "b0": rng.standard_normal(p * h) * 0.1,
               "b1": rng.standard_normal(p * h) * 0.1,
               "b2": rng.standard_normal(p * y) * 0.1}
    means = {"Xmean": rng.standard_normal(x) * 0.1,
             "Xstd": rng.uniform(0.5, 2.0, x),
             "Ymean": rng.standard_normal(y) * 0.1,
             "Ystd": rng.uniform(0.5, 2.0, y)}
    return ({k: v.astype(np.float32) for k, v in weights.items()},
            {k: v.astype(np.float32) for k, v in means.items()})


def _build_package(path, device):
    """Write the phase's package -> (its seconds by stage, the idle clip,
    the number of transition models)."""
    import torch
    from morphablegraphs_tpu_torch.models import graph as graph_mod
    from morphablegraphs_tpu_torch.models import skeleton as sk
    from morphablegraphs_tpu_torch.models import transition_model as tm
    from morphablegraphs_tpu_torch.models.zip_writer import write_graph_zip
    from morphablegraphs_tpu_torch.utils import synthetic
    t0 = time.perf_counter()
    gd, clip = _package_graph_dict(device)
    fit_graph = graph_mod.build_graph_from_dict(gd, device=device)
    t1 = time.perf_counter()
    tm.fit_transition_models_for_graph(fit_graph, n_pairs=TM_PAIRS,
                                       n_components=TM_COMPONENTS, seed=0)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    models = [(f, t, m) for f, node in fit_graph.nodes.items()
              for t, m in node.transition_models.items()]
    if not models or not all(bool(torch.isfinite(m.cond_cov_chol).all())
                             and bool(torch.isfinite(m.weights).all())
                             for _, _, m in models):
        _fail("a transition model fitted on the card is not finite")
    entries = [{"from": f"{f[0]}_{f[1]}", "to": f"{t[0]}_{t[1]}",
                "model": tm.to_json(m)} for f, t, m in models]
    weights, means = _pfnn_arrays()
    walk = gd["subgraphs"]["walk"]
    write_graph_zip(
        path, sk.load_bvh(synthetic.REF_BVH)[0],
        {"walk": {"nodes": {mp: n["mm"] for mp, n in walk["nodes"].items()},
                  "info": walk["info"]}},
        gd["transitions"], start_node=tuple(gd["startNode"]),
        format_version=4.0, pfnn_data={"weights": weights, "means": means},
        transition_models=entries)
    t3 = time.perf_counter()
    return {"graph": t1 - t0, "fit": t2 - t1, "write": t3 - t2}, clip, \
        len(entries)


def _pfnn_codec(d):
    """A PFNNWrapper encode/decode pair for the phase's seeded network: the
    input holds the position, heading, target and phase, zero-padded to
    PFNN_X; the root moves 2 cm a frame toward the target, nudged by the
    first outputs, and each joint turns by a few of them."""
    n_joints = (d - 3) // 4

    def encode(w, target_dir):
        w.target = target_dir
        x = np.zeros(PFNN_X)
        x[:12] = np.concatenate([w.position * 0.01, w.direction, target_dir,
                                 [np.sin(2 * np.pi * w.phase),
                                  np.cos(2 * np.pi * w.phase), 1.0]])
        return x

    def decode(y, w):
        pos = w.position + 2.0 * w.target + 0.05 * np.tanh(
            np.array([y[0], 0.0, y[2]]))
        frame = np.zeros(d, np.float32)
        frame[:3] = pos
        q = np.concatenate([np.ones((n_joints, 1)), 0.02 * np.tanh(
            y[3: 3 + 3 * n_joints].reshape(n_joints, 3))], axis=1)
        frame[3:] = (q / np.linalg.norm(q, axis=1, keepdims=True)).reshape(-1)
        return frame, pos, 0.02 + 0.01 / (1.0 + np.exp(-y[-1]))
    return encode, decode


def phase_package(device, smi: str, zip_copy=None):
    """Phase 16: build the package (graph, transition-model fits on the
    card, pfnn/ section) and load it with load_graph on the card and on
    the CPU; the config-3 request with use_transition_model on the card,
    once warm (recording each kernel's shapes) and PACKAGE_REPS times
    timed, B2, B5 and the emit kernel launched in each; the kernels held
    against their twins at the request's shapes; the result through
    write_bvh -> load_bvh -> bvh_to_quat_frames, and retargeted to REF_BVH
    at twice its size on the card and on the CPU; the PFNN crowd step of
    PFNN_CROWD characters on the card against the CPU, and PFNN_STREAM
    frames of the planner's PFNN locomotion through PFNNWrapper; the
    request at one LM iteration on the card and on the CPU with the same
    draws.  -> (launches of the last timed request, {kernel: {shape:
    launches}}, {kernel: [held results]}, the phase's seconds)."""
    import tempfile

    import torch
    from morphablegraphs_tpu_torch.models import graph as graph_mod
    from morphablegraphs_tpu_torch.models import pfnn, retarget
    from morphablegraphs_tpu_torch.models import primitive as prim_mod
    from morphablegraphs_tpu_torch.models import skeleton as sk
    from morphablegraphs_tpu_torch.ops import kernels
    from morphablegraphs_tpu_torch.synthesis import state_planner as sp
    from morphablegraphs_tpu_torch.synthesis.motion_generator import \
        MotionGenerator
    from morphablegraphs_tpu_torch.utils import synthetic
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(pathlib.Path(tmp) / "packaged_walk.zip")
        build_s, clip, n_models = _build_package(path, device)
        if zip_copy is not None:  # phase 18 serves it
            import shutil
            shutil.copy(path, zip_copy)
        size_mb = pathlib.Path(path).stat().st_size / 2 ** 20
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph = graph_mod.load_graph(path, device=device)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        graph_cpu = graph_mod.load_graph(path, device="cpu")
        load_cpu_s = time.perf_counter() - t0
        ref_path = str(pathlib.Path(tmp) / "ref.bvh")
        pathlib.Path(ref_path).write_text(synthetic.REF_BVH)
        dst = retarget.load_target_skeleton(ref_path, 2.0)
        bvh_path = str(pathlib.Path(tmp) / "request.bvh")

        # the loaded graph: node keys, types, models and tensors
        idle = graph.nodes.get(("walk", "idle"))
        models = sum(len(n.transition_models) for n in graph.nodes.values())
        if (set(graph.nodes) != set(graph_cpu.nodes) or idle is None
                or idle.node_type != graph_mod.NODE_TYPE_IDLE
                or idle.primitive.n_spatial != 1 or models != n_models
                or graph.pfnn_data is None
                or graph.skeleton.n_animated != synthetic.REF_N_JOINTS):
            _fail("the loaded package lacks a node, the idle primitive, a "
                  "transition model, its pfnn/ section or its skeleton")
        for key, node in graph.nodes.items():
            p, q = node.primitive, graph_cpu.nodes[key].primitive
            if p.mean_s.device.type != "cuda" or not torch.equal(
                    p.eigen_s.cpu(), q.eigen_s) or not torch.equal(
                    p.gmm.prec_chol.cpu(), q.gmm.prec_chol):
                _fail(f"load_graph on the card gave node {key} other "
                      "tensors, or tensors off the card")
        f, n, _ = prim_mod.sample_frames(
            torch.Generator(device=device).manual_seed(0), idle.primitive,
            IDLE_FRAMES + 4)
        idle_err = float(np.abs(f[: int(n)].cpu().numpy() - clip).max())
        print(f"package: {size_mb:.1f} MB zip ({len(graph.nodes)} nodes, "
              f"{n_models} transition models, pfnn/ at X {PFNN_X}, Y "
              f"{PFNN_Y}, hidden {PFNN_HIDDEN}, {PFNN_CONTROLS} control "
              f"points) built in {sum(build_s.values()):.2f} s (graph and "
              f"static fit {build_s['graph']:.2f}, transition models on the "
              f"card {build_s['fit']:.2f} for {TM_PAIRS} pairs and "
              f"{TM_COMPONENTS} components each, zip {build_s['write']:.2f})"
              f"; load_graph on {device} {load_s:.3f} s, on the CPU "
              f"{load_cpu_s:.3f} s; the idle primitive's draw within "
              f"{idle_err:.2e} of its clip", flush=True)
        if int(n) != IDLE_FRAMES or idle_err > 0.1:
            _fail("the static idle primitive does not reproduce its clip")

        # the config-3 request with transition models
        mg_input, cfg, seed = _requests()["config3"]
        cfg = dict(cfg, use_transition_model=True)
        gen = MotionGenerator(graph, cfg, seed=seed, device=device)
        conditioned = []
        transition_gmm = gen._transition_gmm

        def counted(key):
            out = transition_gmm(key)
            conditioned.append(out is not None)
            return out
        gen._transition_gmm = counted
        shapes = {k: {} for k in REQUEST_KERNELS}
        walls, runs = [], []
        for rep in range(PACKAGE_REPS + 1):
            saved = _record_shapes(shapes) if rep == 0 else {}
            conditioned.clear()
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            try:
                res = gen.generate_motion(mg_input)
                torch.cuda.synchronize()
            finally:
                _restore_kernels(saved)
            wall = time.perf_counter() - t0
            counts = kernels.launch_counts()
            if not np.all(np.isfinite(res.frames)) or res.stats[
                    "n_steps"] < 2 or len(res.frames) <= 30:
                _fail("the package's request: frames not finite or too "
                      "short")
            if any(counts[k] <= 0 for k in REQUEST_KERNELS):
                _fail(f"the package's request did not launch B2, B5 and "
                      f"the emit kernel: {counts}")
            if sum(conditioned) < 1:
                _fail("the package's request drew no step from a "
                      "transition model")
            if rep:
                walls.append(wall)
                runs.append((res, counts, sum(conditioned)))
        st = [r.stats for r, _, _ in runs]
        print(f"package request (config 3, use_transition_model) on "
              f"{device} ({smi}): {PACKAGE_REPS} timed after a warm one: "
              f"wall s {[round(w, 4) for w in walls]}, p50 step latency s "
              f"{[round(x['p50_step_latency'], 4) for x in st]}, steps "
              f"{[x['n_steps'] for x in st]} ({[c for _, _, c in runs]} "
              f"drawn from a transition model), average_error "
              f"{[round(x['average_error'], 3) for x in st]}, frames "
              f"{[len(r.frames) for r, _, _ in runs]}; launches per request "
              f"of B2/B5/emit "
              f"{[tuple(c[k] for k in REQUEST_KERNELS) for _, c, _ in runs]}"
              f"; kernel shapes in the warm request (launches of each) "
              + str({k: {str(s_): n_ for s_, n_ in v.items()}
                     for k, v in shapes.items()}), flush=True)
        held = _hold_shapes(graph.nodes[("walk", "leftStance")].primitive,
                            device, shapes, {k: set() for k in shapes},
                            "package", seed=41)

        # BVH round trip and retargeting of the result
        frames = res.frames.copy()
        q = frames[:, 3:].reshape(len(frames), -1, 4)
        frames[:, 3:] = (q / np.linalg.norm(q, axis=-1, keepdims=True)
                         ).reshape(len(frames), -1)
        sk.write_bvh(graph.skeleton, frames, bvh_path)
        skel2, euler = sk.load_bvh(bvh_path)
        back = sk.bvh_to_quat_frames(skel2, euler)
        root_err = float(np.abs(back[:, :3] - frames[:, :3]).max())
        qa, qb = back[:, 3:].reshape(q.shape), frames[:, 3:].reshape(q.shape)
        quat_err = float(np.minimum(np.abs(qa - qb).max(-1),
                                    np.abs(qa + qb).max(-1)).max())
        t0 = time.perf_counter()
        out_gpu = retarget.retarget_frames(graph.skeleton, frames, dst,
                                           scale_factor=2.0, device=device)
        t_rt = time.perf_counter() - t0
        out_cpu = retarget.retarget_frames(graph.skeleton, frames, dst,
                                           scale_factor=2.0, device="cpu")
        rt_err = float(np.abs(out_gpu - out_cpu).max())
        p_src = sk.fk_positions(graph.skeleton, torch.as_tensor(frames))
        p_dst = sk.fk_positions(dst, torch.as_tensor(out_cpu))
        pos_err = float((p_dst - 2.0 * p_src).abs().max())
        print(f"package BVH: {len(frames)} frames through write_bvh -> "
              f"load_bvh -> bvh_to_quat_frames: root max abs diff "
              f"{root_err:.3e} (tol {BVH_ROOT_ATOL}), unit joint "
              f"quaternions up to sign {quat_err:.3e} (tol {BVH_QUAT_ATOL})"
              f"; retargeted to REF_BVH x2 on {device} in {t_rt:.3f} s, "
              f"against the CPU {rt_err:.3e} (tol {RETARGET_ATOL}), "
              f"positions against twice the source's {pos_err:.3e} cm (tol "
              f"{RETARGET_POS_ATOL})", flush=True)
        if root_err > BVH_ROOT_ATOL or quat_err > BVH_QUAT_ATOL:
            _fail("the BVH round trip moved the request's frames")
        if rt_err > RETARGET_ATOL or pos_err > RETARGET_POS_ATOL:
            _fail("retargeting on the card disagrees with the CPU or the "
                  "doubled rig")

    # PFNN: the crowd step and a stream through the planner
    model = pfnn.load_from_arrays(graph.pfnn_data["weights"],
                                  graph.pfnn_data["means"], PFNN_CONTROLS,
                                  PFNN_HIDDEN, device=device)
    model_cpu = pfnn.load_from_arrays(graph.pfnn_data["weights"],
                                      graph.pfnn_data["means"],
                                      PFNN_CONTROLS, PFNN_HIDDEN)
    g = torch.Generator().manual_seed(43)
    xs = torch.randn((PFNN_CROWD, PFNN_X), generator=g)
    phases = torch.rand(PFNN_CROWD, generator=g)
    y_gpu = pfnn.forward_crowd(model, xs.to(device), phases.to(device))
    y_cpu = pfnn.forward_crowd(model_cpu, xs, phases)
    scale = float(y_cpu.abs().max())
    pfnn_err = float((y_gpu.cpu() - y_cpu).abs().max())
    crowd_ms = _time_ms(lambda: pfnn.forward_crowd(
        model, xs.to(device), phases.to(device)), 20)
    w_flops = 2 * PFNN_CONTROLS * PFNN_HIDDEN * (PFNN_X + PFNN_HIDDEN
                                                 + PFNN_Y)
    codec = _pfnn_codec(graph.skeleton.n_frame_params)
    planner = sp.MGStatePlanner(
        graph, sp.MGStatePlanningSettings(
            min_pfnn_target_distance=5.0, min_pfnn_primitive_steps=50,
            max_pfnn_frames=PFNN_STREAM),
        device=device, pfnn_wrapper=pfnn.PFNNWrapper(model, *codec))
    planner.use_pfnn = True
    t0 = time.perf_counter()
    # one target beyond the stream's reach: every step yields a frame
    planner.generate_locomotion("walk", np.array([[0.0, 0.0, 400.0]]))
    torch.cuda.synchronize()
    t_stream = time.perf_counter() - t0
    states = list(planner.state_queue._queue)
    streamed = sum(len(e.state.frames) for e in states)
    finite = all(np.all(np.isfinite(e.state.frames)) for e in states)
    print(f"package PFNN: forward_crowd of {PFNN_CROWD} characters on "
          f"{device} {crowd_ms:.4f} ms (CUDA events; "
          f"{PFNN_CROWD * w_flops / crowd_ms / 1e9:.2f} TFLOP/s of the 4 "
          f"control points' layers' {PFNN_CROWD * w_flops / 1e9:.2f} GFLOP,"
          f" bound {PFNN_CROWD * w_flops / PEAK_FP32_PER_S * 1e3:.4f} ms), "
          f"against the CPU max "
          f"abs diff {pfnn_err:.3e} (tol {PFNN_RTOL} x max |y| "
          f"{scale:.2f}); PFNNWrapper drove the planner's PFNN locomotion "
          f"for {streamed} frames in {len(states)} states, "
          f"{t_stream:.3f} s ({1e3 * t_stream / max(streamed, 1):.2f} ms a "
          f"frame)", flush=True)
    if pfnn_err > PFNN_RTOL * scale or not bool(
            torch.isfinite(y_gpu).all()):
        _fail("the PFNN crowd step on the card disagrees with the CPU")
    if streamed != PFNN_STREAM or not finite:
        _fail(f"the PFNN stream gave {streamed} frames, not "
              f"{PFNN_STREAM}, or frames not finite")

    # the request at one LM iteration on the card and on the CPU
    cfg1 = dict(cfg, lm_iterations=1)
    ref = {}
    for dev, g_ in ((device, graph), ("cpu", graph_cpu)):
        t0 = time.perf_counter()
        ref[dev] = (MotionGenerator(g_, cfg1, device=dev,
                                    sampler=_host_sampler(graph_cpu, 7))
                    .generate_motion(mg_input), time.perf_counter() - t0)
    (a, t_gpu), (b, t_cpu) = ref[device], ref["cpu"]
    keys_ok = [s_.node_key for s_ in a.steps] == [s_.node_key
                                                  for s_ in b.steps]
    err_a = np.array([s_.error for s_ in a.steps])
    err_b = np.array([s_.error for s_ in b.steps])
    same_len = keys_ok and a.frames.shape == b.frames.shape
    frame_err, flips = (_quat_frames_diff(a.frames, b.frames)
                        if same_len else (float("inf"), -1))
    print(f"package reference (1 LM iteration, use_transition_model): GPU "
          f"{t_gpu:.3f} s vs CPU {t_cpu:.3f} s, {len(a.steps)} steps, node "
          f"keys equal={keys_ok}, max |err| diff "
          f"{float(np.abs(err_a - err_b).max()) if keys_ok else -1:.3e}, "
          f"frames {a.frames.shape} max abs diff {frame_err:.3e} (tol "
          f"{WALK_FRAMES_ATOL}; {flips} joint quaternions with the other "
          f"sign)", flush=True)
    if not same_len or np.any(np.abs(err_a - err_b)
                              > 0.05 + 1e-2 * np.abs(err_b)) \
            or frame_err > WALK_FRAMES_ATOL:
        _fail("the package's request: the GPU path disagrees with the CPU "
              "path")
    return runs[-1][1], shapes, held, time.perf_counter() - t_phase


# Phase 17: offline construction and cluster-tree search through the
# command line.  TRAIN_CLIPS BVH clips (load_motion_data's default
# max_count, the reference's) of the reference-scale leftStance primitive,
# each a seeded draw back-projected on its own time warp, trained by `cli
# train` with the default config (max_gmm_components 40: a BIC scan over K
# = 1..40 on 100 rows) on the card and on the CPU; `cli cluster-trees` with
# configs/space_partitioning.json (10,000 samples, 4 x 4 levels) for every
# node of the reference-scale walk graph, the trees packed by zip_writer
# and loaded by load_graph; `cli run` of phase 13's config-3 request under
# configs/cluster_tree_search_algorithm.config (every constrained step
# ranks its node's 10,000 tree rows with the exact evaluator, then the LM
# on B2 and B5, the step on the emit kernel), once warm and CLUSTER_REPS
# times timed; the same request on the CPU at one LM iteration.
TRAIN_CLIPS = 100
CLUSTER_REPS = 2
CLUSTER_CONFIG = "configs/cluster_tree_search_algorithm.config"
SPACE_PARTITIONING = "configs/space_partitioning.json"
CLUSTER_SAMPLES = 10000  # SPACE_PARTITIONING's n_random_samples
# the model trained on the card against the CPU's: float32 grids, fits and
# z-transforms in both, the SVD and the EM (float64) on the host and the
# card: the fPCA fields to 1e-4 of their scale, the mixture's weights and
# means to 1e-3 (tests/test_torch_construct.py's bounds)
TRAIN_RTOL, TRAIN_GMM_ATOL = 1e-4, 1e-3


def _train_clip_frames(device, n_clips: int = TRAIN_CLIPS):
    """The first n_clips of TRAIN_CLIPS clips of the reference-scale
    leftStance primitive: seeded draws back-projected with their time
    warps, the joint quaternions normalized (BVH stores rotations) ->
    (the skeleton, {name: frames float64})."""
    import torch
    from morphablegraphs_tpu_torch.models import primitive as prim_mod
    from morphablegraphs_tpu_torch.models import skeleton as sk
    from morphablegraphs_tpu_torch.utils import synthetic
    gd = synthetic.make_reference_scale_graph_dict()
    prim = prim_mod.load_primitive_json(
        gd["subgraphs"]["walk"]["nodes"]["leftStance"]["mm"], device=device)
    skel = sk.load_bvh(synthetic.REF_BVH)[0]
    gen = torch.Generator(device=device).manual_seed(17)
    lat = prim_mod.sample_latent(gen, prim, TRAIN_CLIPS)
    clips = {}
    for i in range(n_clips):
        f, n, _ = prim_mod.back_project(prim, lat[i], 2 * 192, use_time=True)
        f = f[: int(n)].cpu().numpy().astype(np.float64)
        q = f[:, 3:].reshape(len(f), -1, 4)
        f[:, 3:] = (q / np.linalg.norm(q, axis=-1, keepdims=True)).reshape(
            len(f), -1)
        clips[f"clip{i:03d}"] = f
    return skel, clips


def _write_train_clips(folder, device):
    """The TRAIN_CLIPS clips as BVH files -> the skeleton."""
    from morphablegraphs_tpu_torch.models import skeleton as sk
    skel, clips = _train_clip_frames(device)
    for name, f in clips.items():
        sk.write_bvh(skel, f, str(pathlib.Path(folder) / f"{name}.bvh"))
    return skel


def _train(folder, out, device):
    """`cli train` on `device` -> (model JSON, {stage: seconds, and the
    DTW's total path cost "dtw_cost"}, wall s, the warping functions)."""
    import torch
    from morphablegraphs_tpu_torch.construct import constructor
    from morphablegraphs_tpu_torch.serve import cli
    made, stages = [], {}
    load, ctor = cli.load_motion_data, cli.MotionModelConstructor
    warps = {}

    def timed_load(*a, **kw):
        t0 = time.perf_counter()
        r = load(*a, **kw)
        stages["load"] = time.perf_counter() - t0
        return r

    class Recorded(constructor.MotionModelConstructor):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

        def construct_model(self, *a, **kw):
            r = super().construct_model(*a, **kw)
            warps.update({k: list(v) for k, v in
                          self._temporal_data.items()})
            return r
    cli.load_motion_data, cli.MotionModelConstructor = timed_load, Recorded
    try:
        t0 = time.perf_counter()
        cli.main(["train", folder, "walk_leftStance", "--output", out,
                  "--device", str(device)])
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        cli.load_motion_data, cli.MotionModelConstructor = load, ctor
    stages.update(made[-1].timings, dtw_cost=made[-1].dtw_cost)
    with open(out) as f:
        return json.load(f), stages, wall, warps


def _cluster_package(tmp, device):
    """`cli cluster-trees` over the reference-scale walk graph's models
    with configs/space_partitioning.json, the trees packed into a format-4
    zip by zip_writer -> (zip path, seconds per node, its size in MB)."""
    from morphablegraphs_tpu_torch.construct.space_partitioning import \
        ClusterTree
    from morphablegraphs_tpu_torch.models import skeleton as sk
    from morphablegraphs_tpu_torch.models.zip_writer import write_graph_zip
    from morphablegraphs_tpu_torch.serve import cli
    from morphablegraphs_tpu_torch.utils import synthetic
    gd = synthetic.make_reference_scale_graph_dict()
    walk = gd["subgraphs"]["walk"]
    mdir = pathlib.Path(tmp) / "models"
    mdir.mkdir()
    per_node = {}
    for mp, node in walk["nodes"].items():
        sub = mdir / mp
        sub.mkdir()
        (sub / f"walk_{mp}_mm.json").write_text(json.dumps(node["mm"]))
        t0 = time.perf_counter()
        cli.main(["cluster-trees", str(sub), "--config", SPACE_PARTITIONING,
                  "--device", str(device)])
        per_node[mp] = time.perf_counter() - t0
    trees = {mp: ClusterTree.load(str(mdir / mp / f"walk_{mp}"),
                                  device=device)
             for mp in walk["nodes"]}
    path = write_graph_zip(
        str(pathlib.Path(tmp) / "cluster_walk.zip"),
        sk.load_bvh(synthetic.REF_BVH)[0],
        {"walk": {"nodes": {mp: n["mm"] for mp, n in walk["nodes"].items()},
                  "info": walk["info"], "cluster_trees": trees}},
        gd["transitions"], start_node=tuple(gd["startNode"]),
        format_version=4.0)
    return path, per_node, pathlib.Path(path).stat().st_size / 2 ** 20, \
        trees


class _PoolSpy:
    """Wraps generator.score_pool: each call's rows, its argmin, its least
    error and CUDA events around it (the pool's ms per step)."""

    def __init__(self, device):
        from morphablegraphs_tpu_torch.synthesis import generator
        self.generator, self.orig = generator, generator.score_pool
        self.calls, self.cuda = [], device is not None and str(
            device).startswith("cuda")

    def __enter__(self):
        import torch

        def spy(skel, prim, sc, pool, *a, **kw):
            ev = None
            if self.cuda:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            errors = self.orig(skel, prim, sc, pool, *a, **kw)
            if ev is not None:
                ev[1].record()
            i = torch.argmin(errors)
            self.calls.append((pool.shape[0], i, errors[i], ev))
            return errors
        self.generator.score_pool = spy
        return self

    def __exit__(self, *exc):
        self.generator.score_pool = self.orig
        return False

    def rows(self):
        """[(rows, argmin, least error, ms or None)] after a synchronize."""
        return [(n, int(i), float(e),
                 ev[0].elapsed_time(ev[1]) if ev is not None else None)
                for n, i, e, ev in self.calls]


def phase_cluster(device, smi: str):
    """Phase 17: train (card and CPU), cluster trees through the CLI, the
    cluster-tree request through `cli run` (warm + CLUSTER_REPS timed, B2,
    B5 and the emit kernel launched in each, each shape held against its
    twin) and the same request on the CPU at one LM iteration.  ->
    (launches of the last timed request, {kernel: {shape: launches}},
    {kernel: [held results]}, the phase's seconds)."""
    import tempfile

    import torch
    from morphablegraphs_tpu_torch.models import graph as graph_mod
    from morphablegraphs_tpu_torch.ops import kernels
    from morphablegraphs_tpu_torch.serve import cli
    from morphablegraphs_tpu_torch.synthesis.motion_generator import \
        MotionGenerator
    from morphablegraphs_tpu_torch.utils.config import load_config
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp_p = pathlib.Path(tmp)
        clips = tmp_p / "clips"
        clips.mkdir()
        t0 = time.perf_counter()
        _write_train_clips(str(clips), device)
        t_clips = time.perf_counter() - t0

        # 1. train on the card, then on the CPU from the same files
        kernels.reset_launch_counts()
        m_g, st_g, wall_g, warps_g = _train(str(clips),
                                            str(tmp_p / "gpu_mm.json"),
                                            device)
        train_launches = dict(kernels.launch_counts())
        m_c, st_c, wall_c, warps_c = _train(str(clips),
                                            str(tmp_p / "cpu_mm.json"), "cpu")
        sp_g, sp_c = m_g["sspm"], m_c["sspm"]
        k_g, k_c = len(m_g["gmm"]["weights"]), len(m_c["gmm"]["weights"])
        warp_diff = sum(int(np.sum(np.asarray(warps_g[k])
                                   != np.asarray(warps_c[k])))
                        for k in warps_g)
        shapes_ok = (k_g == k_c and sp_g["n_coeffs"] == sp_c["n_coeffs"]
                     and len(sp_g["eigen"]) == len(sp_c["eigen"])
                     and len(m_g["tspm"]["eigen"][0])
                     == len(m_c["tspm"]["eigen"][0]))
        gaps = {}
        if shapes_ok:
            for name, a, b in (
                    ("spatial mean", sp_g["mean"], sp_c["mean"]),
                    ("spatial eigen", sp_g["eigen"], sp_c["eigen"]),
                    ("temporal mean", m_g["tspm"]["mean"],
                     m_c["tspm"]["mean"]),
                    ("temporal eigen", m_g["tspm"]["eigen"],
                     m_c["tspm"]["eigen"])):
                a, b = np.asarray(a), np.asarray(b)
                gaps[name] = float(np.abs(a - b).max() / np.abs(b).max())
            order_g = np.argsort(np.asarray(m_g["gmm"]["means"])[:, 0])
            order_c = np.argsort(np.asarray(m_c["gmm"]["means"])[:, 0])
            for f in ("weights", "means"):
                gaps[f"gmm {f}"] = float(np.abs(
                    np.asarray(m_g["gmm"][f])[order_g]
                    - np.asarray(m_c["gmm"][f])[order_c]).max())
        # the DTW's total path cost, the card's against the CPU's
        cost_g, cost_c = st_g.pop("dtw_cost"), st_c.pop("dtw_cost")
        gaps["dtw cost"] = abs(cost_g - cost_c) / abs(cost_c)
        print(f"cluster train: {TRAIN_CLIPS} BVH clips of the "
              f"reference-scale leftStance (D "
              f"{3 + 4 * len(m_g['sspm']['animated_joints'])}) written in "
              f"{t_clips:.2f} s; `cli train` on {device} ({smi}) "
              f"{wall_g:.2f} s: " + ", ".join(
                  f"{k} {v:.3f}" for k, v in st_g.items())
              + f" s; on the CPU {wall_c:.2f} s: " + ", ".join(
                  f"{k} {v:.3f}" for k, v in st_c.items())
              + f" s; the model: n_basis {sp_g['n_coeffs']}, k_s "
              f"{len(sp_g['eigen'])}, k_t {len(m_g['tspm']['eigen'][0])}, "
              f"K {k_g} (CPU K {k_c}); port kernel launches in training "
              f"{train_launches}; card vs CPU gaps {gaps} (tol fPCA "
              f"{TRAIN_RTOL} of scale, GMM {TRAIN_GMM_ATOL}); warp indices "
              f"that differ {warp_diff}", flush=True)
        if not shapes_ok or any(
                v > (TRAIN_GMM_ATOL if k.startswith("gmm") else TRAIN_RTOL)
                for k, v in gaps.items()):
            _fail("the model trained on the card disagrees with the CPU's")
        for a, b in (("spatial mean", "mean"),):
            if not np.all(np.isfinite(np.asarray(sp_g[b]))):
                _fail(f"the trained {a} is not finite")

        # 2. cluster trees through the CLI, packed and loaded on the card
        zip_path, per_node, size_mb, trees = _cluster_package(tmp, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph = graph_mod.load_graph(zip_path, device=device)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        graph_cpu = graph_mod.load_graph(zip_path, device="cpu")
        for key, node in graph.nodes.items():
            tree = node.cluster_tree
            if tree is None or tree.data.shape[0] != CLUSTER_SAMPLES or \
                    tree.device_data().device.type != \
                    torch.device(device).type or \
                    not np.array_equal(tree.data, trees[key[1]].data):
                _fail(f"node {key}'s cluster tree did not load onto the "
                      "card with its 10,000 samples")
        print(f"cluster trees: `cli cluster-trees` with "
              f"{SPACE_PARTITIONING} (10,000 samples, 4 x 4 levels) on "
              f"{device}: seconds per node "
              f"{ {k: round(v, 3) for k, v in per_node.items()} }; the zip "
              f"{size_mb:.1f} MB; load_graph on {device} {t_load:.3f} s",
              flush=True)

        # 3. `cli run` of config 3's request under cluster-tree search
        in_dir = tmp_p / "in"
        in_dir.mkdir()
        (in_dir / "request.json").write_text(json.dumps(REQUEST_CONFIG3))
        results = []
        gen_cls = cli.MotionGenerator

        class Recorded(MotionGenerator):
            def generate_motion(self, *a, **kw):
                r = super().generate_motion(*a, **kw)
                results.append(r)
                return r
        shapes = {k: {} for k in REQUEST_KERNELS}
        walls, runs = [], []
        cli.MotionGenerator = Recorded
        try:
            for rep in range(CLUSTER_REPS + 1):
                saved = _record_shapes(shapes) if rep == 0 else {}
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                try:
                    with _PoolSpy(device) as spy:
                        cli.main(["run", zip_path, str(in_dir),
                                  str(tmp_p / f"out{rep}"), "--config",
                                  CLUSTER_CONFIG, "--device", str(device)])
                        torch.cuda.synchronize()
                finally:
                    _restore_kernels(saved)
                wall = time.perf_counter() - t0
                counts = kernels.launch_counts()
                res = results[-1]
                pools = spy.rows()
                if not np.all(np.isfinite(res.frames)) or \
                        res.stats["n_steps"] < 2:
                    _fail("the cluster-tree request: frames not finite or "
                          "too few steps")
                if any(counts[k] <= 0 for k in REQUEST_KERNELS):
                    _fail("the cluster-tree request did not launch B2, B5 "
                          f"and the emit kernel: {counts}")
                if not pools or any(n != CLUSTER_SAMPLES for n, *_ in pools):
                    _fail("a constrained step of the cluster-tree request "
                          f"did not rank its tree's rows: {pools}")
                if not (tmp_p / f"out{rep}" / "output.bvh").exists():
                    _fail("`cli run` wrote no BVH")
                if rep:
                    walls.append(wall)
                    runs.append((res, counts, pools))
        finally:
            cli.MotionGenerator = gen_cls
        st = [r.stats for r, _, _ in runs]
        pool_ms = [[None if ms is None else round(ms, 3) for *_, ms in p]
               for _, _, p in runs]
        print(f"cluster request (config 3 under {CLUSTER_CONFIG}, `cli run`)"
              f" on {device} ({smi}): {CLUSTER_REPS} timed after a warm one "
              f"(the load_graph of each included): wall s "
              f"{[round(w, 4) for w in walls]}, p50 step latency s "
              f"{[round(x['p50_step_latency'], 4) for x in st]}, steps "
              f"{[x['n_steps'] for x in st]}, average_error "
              f"{[round(x['average_error'], 3) for x in st]}; the pool "
              f"(10,000 tree rows) scored per constrained step in ms (CUDA "
              f"events around score_pool) {pool_ms}; launches per request "
              f"of B2/B5/emit "
              f"{[tuple(c[k] for k in REQUEST_KERNELS) for _, c, _ in runs]}"
              f"; kernel shapes in the warm request (launches of each) "
              + str({k: {str(s_): n_ for s_, n_ in v.items()}
                     for k, v in shapes.items()}), flush=True)
        held = _hold_shapes(graph.nodes[("walk", "leftStance")].primitive,
                            device, shapes, {k: set() for k in shapes},
                            "cluster", seed=42)

    # the request at one LM iteration on the card and on the CPU
    cfg1 = dict(load_config(CLUSTER_CONFIG), lm_iterations=1)
    ref = {}
    for dev, g_ in ((device, graph), ("cpu", graph_cpu)):
        with _PoolSpy(dev) as spy:
            t0 = time.perf_counter()
            r = MotionGenerator(g_, cfg1, device=dev,
                                sampler=_host_sampler(graph_cpu, 7)
                                ).generate_motion(REQUEST_CONFIG3)
            ref[dev] = (r, time.perf_counter() - t0, spy.rows())
    (a, t_gpu, rows_a), (b, t_cpu, rows_b) = ref[device], ref["cpu"]
    keys_ok = [s_.node_key for s_ in a.steps] == [s_.node_key
                                                  for s_ in b.steps]
    err_a = np.array([s_.error for s_ in a.steps])
    err_b = np.array([s_.error for s_ in b.steps])
    same_len = keys_ok and a.frames.shape == b.frames.shape
    other_rows = sum(x[1] != y[1] for x, y in zip(rows_a, rows_b))
    least = np.array([[x[2], y[2]] for x, y in zip(rows_a, rows_b)])
    frame_err, flips = (_quat_frames_diff(a.frames, b.frames)
                        if same_len else (float("inf"), -1))
    print(f"cluster reference (1 LM iteration): GPU {t_gpu:.3f} s vs CPU "
          f"{t_cpu:.3f} s, {len(a.steps)} steps, node keys equal={keys_ok}, "
          f"{len(rows_a)} pools, {other_rows} with another chosen tree row, "
          f"the chosen rows' errors max abs diff "
          f"{float(np.abs(least[:, 0] - least[:, 1]).max()):.3e}, step "
          f"errors max abs diff "
          f"{float(np.abs(err_a - err_b).max()) if keys_ok else -1:.3e}, "
          f"frames {a.frames.shape} max abs diff {frame_err:.3e} (tol "
          f"{WALK_FRAMES_ATOL}; {flips} joint quaternions with the other "
          f"sign)", flush=True)
    if not same_len or len(rows_a) != len(rows_b) or np.any(
            np.abs(least[:, 0] - least[:, 1])
            > 0.05 + 1e-2 * np.abs(least[:, 1])) or np.any(
            np.abs(err_a - err_b) > 0.05 + 1e-2 * np.abs(err_b)) \
            or frame_err > WALK_FRAMES_ATOL:
        _fail("the cluster-tree request: the GPU path disagrees with the "
              "CPU path")
    return runs[-1][1], shapes, held, time.perf_counter() - t_phase


# Phase 18: the service edge (serve/rest.py) and the process group
SERVICE_REPS = 2  # timed calls of each endpoint, after one that warms
SERVICE_KERNELS = ("score_locomotion_candidates",) + REQUEST_KERNELS
# an endpoint's frames and the direct call's, both parsed back from BVH
# text (6 decimals of a cm and of a degree): phase 16's round-trip bound
SERVICE_BVH_ATOL = BVH_ROOT_ATOL
# the /set_height_map terrain: world heights on a TERRAIN_N x TERRAIN_N
# grid of TERRAIN_SCALE-cm texels from TERRAIN_ORIGIN (x, z)
TERRAIN_ORIGIN, TERRAIN_SCALE, TERRAIN_N = (-150.0, -100.0), 10.0, 31
GROUP_RANKS = 2  # gloo ranks spawned on the one card
GROUP_CLIPS = 20  # phase 17's first clips, the two-rank DTW's input
GROUP_FRAMES_ATOL = 1e-5  # a rank's rows against the one-process crowd
SERVER_START_S = 300  # the CLI server's start, its first request included


def _serving_requests():
    """Phase 9's 8 trajectory requests."""
    return [_traj_request(x, z) for x, z in
            [(20, 100), (-20, 100), (0, 120), (40, 90), (-40, 90),
             (10, 140), (-10, 60), (30, 150)]]


def _service_config():
    """Config 3's (phase 13), capped at phase 13's keyframe request's 4
    steps (config 3's request takes 4)."""
    cfg = _requests()["config3"][1]
    cfg["debug_max_step"] = REQUEST_KF_MAX_STEP
    return cfg


def _terrain():
    """[z rows, x columns] world heights of the /set_height_map grid."""
    x = TERRAIN_ORIGIN[0] + TERRAIN_SCALE * np.arange(TERRAIN_N)
    z = TERRAIN_ORIGIN[1] + TERRAIN_SCALE * np.arange(TERRAIN_N)
    return 3.0 * np.sin(x[None, :] / 40.0) + 0.02 * z[:, None]


def _http(base: str, method: str, path: str, body=None, timeout=600):
    """(status, body bytes) of one request to a local server, past any
    proxy the environment names."""
    import urllib.error
    import urllib.request
    data = None if body is None else (
        body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(base + path, data=data, method=method)
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        with opener.open(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _bvh_frames(text: str):
    from morphablegraphs_tpu_torch.models import skeleton as sk
    skel, euler = sk.load_bvh(text)
    return sk.bvh_to_quat_frames(skel, euler)


def _bvh_diff(a: str, b: str):
    """_quat_frames_diff of two BVH texts' frames (inf: other lengths)."""
    fa, fb = _bvh_frames(a), _bvh_frames(b)
    if fa.shape != fb.shape:
        return float("inf"), -1
    return _quat_frames_diff(fa, fb)


def _direct_batch(ref, reqs):
    """The batch endpoint's work as direct calls on the context `ref`:
    split_batchable, one generate_batch, MGContext.run for the others ->
    the endpoint's answer {"results": [...]}."""
    from morphablegraphs_tpu_torch.models.skeleton import write_bvh
    bg = ref.batched_generator()
    ids, fallback, parsed = bg.split_batchable(reqs)
    frames = bg.generate_batch([reqs[i] for i in ids],
                               parsed_list=[parsed[i] for i in ids])
    out = [None] * len(reqs)
    for i, f in zip(ids, frames):
        out[i] = {"bvh": write_bvh(ref.graph.skeleton, f), "batched": True}
    for i in fallback:
        out[i] = {**ref.run(reqs[i]), "batched": False}
    return {"results": out}


def _service_calls():
    """[(endpoint, route, body, direct(ref ctx) -> the direct call's
    answer in the endpoint's form, reps)], in the order they are sent: the
    direct call runs on a second context that receives the same calls in
    the same order, so both contexts' generators draw the same samples.
    The batch after /set_configuration holds the 8 trajectory requests
    only: the keyframe request under phase 14's timed config would add
    its global passes to the phase's seconds."""
    from morphablegraphs_tpu_torch.serve import rest
    batch = {"requests": _serving_requests() + [REQUEST_KEYFRAME]}
    trajectories = {"requests": _serving_requests()}
    timed_cfg = _options_requests()["timed"][1]
    terrain = {"height_map": _terrain().tolist(),
               "origin": list(TERRAIN_ORIGIN), "scale": TERRAIN_SCALE}

    def run(mg_input):
        return lambda ref: ref.run(mg_input)

    def direct_batch(body):
        return lambda ref: _direct_batch(ref, body["requests"])

    def configure(ref):
        return json.loads(rest.set_configuration(
            ref, json.dumps(timed_cfg).encode())[2])

    def height_map(ref):
        return json.loads(rest.set_height_map_route(
            ref, json.dumps(terrain).encode())[2])
    return [
        ("run", "/run_morphablegraphs", REQUEST_CONFIG3, run(REQUEST_CONFIG3),
         1 + SERVICE_REPS),
        ("batch", "/run_morphablegraphs_batch", batch, direct_batch(batch),
         1 + SERVICE_REPS),
        ("set_configuration", "/set_configuration", timed_cfg, configure, 1),
        ("batch_reconfigured", "/run_morphablegraphs_batch", trajectories,
         direct_batch(trajectories), 1),
        ("set_height_map", "/set_height_map", terrain, height_map, 1),
        ("run_terrain", "/run_morphablegraphs", REQUEST_TIMED,
         run(REQUEST_TIMED), 1)]


def _hold_answer(name, got: dict, want: dict, min_frames: int = 30):
    """An endpoint's JSON answer against the direct call's: every BVH
    within SERVICE_BVH_ATOL once parsed back, the other fields equal.
    -> the worst BVH difference."""
    worst = 0.0
    pairs = ([(got, want)] if "results" not in want
             else list(zip(got["results"], want["results"])))
    if "results" in want and len(got["results"]) != len(want["results"]):
        _fail(f"service {name}: {len(got['results'])} results for "
              f"{len(want['results'])} requests")
    for g, w in pairs:
        if g.keys() != w.keys() or any(g[k] != w[k] for k in g
                                       if k != "bvh"):
            _fail(f"service {name}: the answer's fields differ from the "
                  f"direct call's: {sorted(g)} vs {sorted(w)}")
        if "bvh" in w:
            d, _ = _bvh_diff(g["bvh"], w["bvh"])
            worst = max(worst, d)
            if not d <= SERVICE_BVH_ATOL or len(_bvh_frames(g["bvh"])) \
                    <= min_frames:
                _fail(f"service {name}: the endpoint's frames differ from "
                      f"the direct call's by {d:.3e} (tol "
                      f"{SERVICE_BVH_ATOL}) or are too few")
    return worst


def phase_service_endpoints(graph, stacked, device, smi: str, held_b1):
    """Phase 18's in-process part: a server thread over make_app(MGContext(
    graph, device)) on 127.0.0.1 takes _service_calls over HTTP, each
    followed by its direct call on a second context; each endpoint's
    answer is held against the direct call's; the kernels' launches are
    counted per endpoint and their shapes recorded, then held against
    their twins.  -> (launches {endpoint: counts}, shapes, held, the
    profile's run (the batch endpoint's direct call) and its median wall
    seconds)."""
    import copy
    import threading

    import torch
    from morphablegraphs_tpu_torch.ops import kernels
    from morphablegraphs_tpu_torch.serve import rest
    cfg = _service_config()
    ctx = rest.MGContext(graph, cfg, device=device)
    ref = rest.MGContext(graph, copy.deepcopy(cfg), device=device)
    server = rest.make_server(rest.make_app(ctx), "127.0.0.1", 0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    shapes = {k: {} for k in SERVICE_KERNELS}
    launches, batch_wall = {}, None
    try:
        for name, route, body, direct, reps in _service_calls():
            walls, direct_walls, worst = [], [], 0.0
            for rep in range(reps):
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                saved = _record_shapes(shapes)
                t0 = time.perf_counter()
                status, payload = _http(base, "POST", route, body)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                _restore_kernels(saved)
                counts = launches[name] = kernels.launch_counts()
                t0 = time.perf_counter()
                want = direct(ref)
                torch.cuda.synchronize()
                direct_walls.append(time.perf_counter() - t0)
                if status != 200:
                    _fail(f"service {name}: {route} answered {status}: "
                          f"{payload[:300]!r}")
                worst = max(worst, _hold_answer(name, json.loads(payload),
                                                want))
            if name == "batch":
                flags = [r["batched"] for r in json.loads(payload)["results"]]
                if flags != [True] * 8 + [False]:
                    _fail(f"service batch: the batched flags are {flags}, "
                          "not 8 batched and the keyframe request not")
            if name == "set_configuration" and ctx._batched_generator \
                    is not None:
                _fail("/set_configuration kept the cached BatchedGenerator")
            if name == "set_height_map":
                _check_terrain(ctx)
            kinds = (SERVICE_KERNELS if name.startswith("batch") else
                     REQUEST_KERNELS if name.startswith("run") else ())
            if any(counts[k] <= 0 for k in kinds):
                _fail(f"service {name} did not launch {kinds}: {counts}")
            timed_e, timed_d = walls[-SERVICE_REPS:], direct_walls[
                -SERVICE_REPS:]
            print(f"service {name} ({route}) on {device} ({smi}): "
                  f"{len(walls)} call(s){', the first warms' if reps > 1 else ''}:"
                  f" endpoint wall s {[round(w, 4) for w in walls]}, direct "
                  f"call wall s {[round(w, 4) for w in direct_walls]}; the "
                  f"service's own cost (median endpoint - median direct, "
                  f"timed calls) "
                  f"{float(np.median(timed_e) - np.median(timed_d)):.4f} s;"
                  f" answers within {worst:.2e} of the direct call's; "
                  f"launches of B1/B2/B5/emit "
                  f"{tuple(counts[k] for k in SERVICE_KERNELS)}", flush=True)
            if name == "batch":
                batch_wall = float(np.median(timed_d))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    print("service kernel shapes (launches of each over all endpoint calls):"
          f" {json.dumps({k: {str(s): n for s, n in v.items()} for k, v in shapes.items()})}",
          flush=True)
    prim = graph.nodes[("walk", "leftStance")].primitive.to(device)
    held = _hold_shapes(prim, device, shapes,
                        {k: set() for k in REQUEST_KERNELS}, "service",
                        seed=43)
    held["score_locomotion_candidates"] = _hold_b1(
        stacked, graph.skeleton, device, shapes, held_b1)
    # the profile's batch: the endpoint's direct call on a context of the
    # service's config (the second context's is phase 14's by now)
    prof_ctx = rest.MGContext(graph, _service_config(), device=device)
    reqs = _serving_requests() + [REQUEST_KEYFRAME]
    return (launches, shapes, held,
            lambda _=None: _direct_batch(prof_ctx, reqs), batch_wall)


def _check_terrain(ctx):
    """The scene's heights at the grid's texels are the grid's."""
    grid = _terrain()
    scene = ctx.generator.scene_interface
    for iz in range(0, TERRAIN_N, 5):
        for ix in range(0, TERRAIN_N, 5):
            x = TERRAIN_ORIGIN[0] + TERRAIN_SCALE * ix
            z = TERRAIN_ORIGIN[1] + TERRAIN_SCALE * iz
            if abs(scene.get_height(x, z) - grid[iz, ix]) > 1e-9:
                _fail(f"/set_height_map: the scene's height at ({x}, {z}) "
                      f"is {scene.get_height(x, z)}, not {grid[iz, ix]}")


def _hold_b1(stacked, skel, device, shapes, held_b1):
    """B1 at each recorded (C, N, table rows) shape: the shapes phase 3
    held are named, the others held now against the twin."""
    out = []
    for (c, n, g8), launched in sorted(
            shapes["score_locomotion_candidates"].items()):
        if (c, g8) in held_b1:
            out.append(dict(shape=f"[{c}, {n}, {g8}]", launches=launched,
                            held_by="phase 3"))
            continue
        from morphablegraphs_tpu_torch.ops import kernels
        args = _b1_inputs(stacked, skel, c, g8 - 8, device, seed=77)[:4]
        err, summary = _check_scores(
            "B1", kernels.score_locomotion_candidates(*args),
            kernels.score_locomotion_candidates_ref(*args))
        print(f"service B1 [{c}, {n}, {g8}]: {summary}", flush=True)
        out.append(dict(shape=f"[{c}, {n}, {g8}]", launches=launched,
                        max_abs_err=err))
    return out


def _serving_outputs(graph, device, group=None):
    """Phase 9's 8 requests through BatchedGenerator(graph, device, group)
    -> (their frames, the crowd's (segments, n_frames, node_ids, errors)
    on the host)."""
    from morphablegraphs_tpu_torch import parallel
    from morphablegraphs_tpu_torch.serve.batch import BatchedGenerator
    bg = BatchedGenerator(graph, device=device, group=group)
    inner, out = parallel.constrained_crowd_sharded, []

    def capture(*a, **kw):
        r = inner(*a, **kw)
        out.append(tuple(x.cpu() for x in r))
        return r
    parallel.constrained_crowd_sharded = capture
    try:
        frames = bg.generate_batch(_serving_requests())
    finally:
        parallel.constrained_crowd_sharded = inner
    return frames, out[0]


def _dtw(skel, clips, device):
    """constructor.align_frames_temporally of the clips on `device` (over
    the default process group when one of several ranks is up) ->
    (warping functions {name: [int]}, warped frames {name: array})."""
    from morphablegraphs_tpu_torch.construct import constructor
    warped, warps = constructor.align_frames_temporally(skel, clips,
                                                        device=device)
    return {k: [int(i) for i in v] for k, v in warps.items()}, warped


def _group_rank(rank: int, tmp: str, device: str):
    """One rank of the two-rank gloo group (spawned), on `device`: the
    serving crowd and the DTW over the group -> out<rank>.pt."""
    import datetime
    import os

    import torch
    import torch.distributed as dist
    from morphablegraphs_tpu_torch.ops import cuda_build
    device = torch.device(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    if device.type == "cuda":
        cuda_build.load_library()
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"),
                                     GROUP_RANKS),
        rank=rank, world_size=GROUP_RANKS,
        timeout=datetime.timedelta(seconds=300))
    try:
        clips = torch.load(os.path.join(tmp, "clips.pt"), weights_only=False)
        graph, _ = _ref_model(device)
        sync()
        t0 = time.perf_counter()
        frames, crowd = _serving_outputs(graph, device, dist.group.WORLD)
        sync()
        t1 = time.perf_counter()
        warps, warped = _dtw(graph.skeleton, clips, device)
        sync()
        torch.save(dict(frames=frames, crowd=crowd, warps=warps,
                        warped=warped,
                        seconds=(t1 - t0, time.perf_counter() - t1)),
                   os.path.join(tmp, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _crowds_equal(a, b) -> float:
    """The worst difference of two serving crowds (frames list, (segments,
    n_frames, node_ids, errors)): frames and segments absolute, errors
    relative to 1 + |error|; inf when frame counts or node ids differ."""
    import torch
    (fa, ca), (fb, cb) = a, b
    if not (torch.equal(ca[1], cb[1]) and torch.equal(ca[2], cb[2])) or [
            f.shape for f in fa] != [f.shape for f in fb]:
        return float("inf")
    return max(max(float(np.abs(x - y).max()) for x, y in zip(fa, fb)),
               float((ca[0] - cb[0]).abs().max()),
               float(((ca[3] - cb[3]).abs() / (1.0 + cb[3].abs())).max()))


class _CliServer:
    """`python -m morphablegraphs_tpu_torch.serve.cli serve zip --port P`
    in its own process (on the card, its default; on the CPU only when
    `device` is), started at construction."""

    def __init__(self, zip_path: str, device):
        import queue
        import socket
        import threading
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            self.port = sock.getsockname()[1]
        self.name = pathlib.Path(zip_path).name
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "morphablegraphs_tpu_torch.serve.cli",
             "serve", zip_path, "--port", str(self.port)]
            + (["--device", "cpu"] if str(device) == "cpu" else []),
            cwd=str(pathlib.Path(__file__).resolve().parent),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.lines = queue.Queue()
        threading.Thread(target=lambda: [self.lines.put(x)
                                         for x in self.proc.stdout],
                         daemon=True).start()

    def check(self, smi: str):
        """Wait for its serving line, then phase 13's config-3 request,
        /get_skeleton and a bad JSON body (400)."""
        import queue
        seen = []
        while True:
            try:
                line = self.lines.get(timeout=SERVER_START_S)
            except queue.Empty:
                _fail(f"`cli serve` printed no serving line in "
                      f"{SERVER_START_S} s: {''.join(seen)[-2000:]}")
            seen.append(line)
            if line.startswith("serving morphablegraphs on :"):
                break
            if self.proc.poll() is not None:
                _fail(f"`cli serve` exited {self.proc.returncode}: "
                      f"{''.join(seen)[-2000:]}")
        if line.strip() != f"serving morphablegraphs on :{self.port}":
            _fail(f"`cli serve` serves on another port: {line.strip()}")
        t_up = time.perf_counter() - self.t0
        base = f"http://127.0.0.1:{self.port}"
        t1 = time.perf_counter()
        got = [_http(base, "POST", "/run_morphablegraphs", REQUEST_CONFIG3)]
        t_req = time.perf_counter() - t1
        got.append(_http(base, "GET", "/get_skeleton"))
        got.append(_http(base, "POST", "/run_morphablegraphs", b"not json{"))
        status = [g[0] for g in got]
        n_frames = (len(_bvh_frames(json.loads(got[0][1])["bvh"]))
                    if status[0] == 200 else 0)
        print(f"service cli serve ({smi}): `cli serve {self.name} --port "
              f"{self.port}` up in {t_up:.2f} s (a fresh process: imports, "
              f"the card, load_graph); config 3's request {t_req:.3f} s (its "
              f"first) with {n_frames} frames; statuses {status} (expected "
              f"[200, 200, 400])", flush=True)
        if status != [200, 200, 400] or n_frames <= 30 or \
                b"HIERARCHY" not in got[1][1]:
            _fail(f"`cli serve` answered {status}")

    def stop(self):
        self.proc.terminate()
        try:
            self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=60)


def phase_service(graph, stacked, device, smi: str, zip_path: str, held_b1):
    """Phase 18: the endpoints in process; then, while two spawned gloo
    ranks split the serving crowd and a 20-clip DTW and `cli serve` starts
    in its own process, the serving crowd over a world-size-1 NCCL group
    against the direct call, the CLI server's answers, and the ranks'
    results against the one-process ones.  -> (launches per endpoint,
    shapes, held, the batch profile's run and wall, the phase's
    seconds)."""
    import os

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    t_phase = time.perf_counter()
    launches, shapes, held, profiled, batch_wall = phase_service_endpoints(
        graph, stacked, device, smi, held_b1)
    t_endpoints = time.perf_counter() - t_phase

    direct = _serving_outputs(graph, device)
    skel, clips = _train_clip_frames(device, GROUP_CLIPS)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(clips, os.path.join(tmp, "clips.pt"))
        t0 = time.perf_counter()
        group = mp.start_processes(_group_rank, args=(tmp, str(device)),
                                   nprocs=GROUP_RANKS, join=False,
                                   start_method="spawn")
        server = _CliServer(zip_path, device)
        try:
            t1 = time.perf_counter()
            backend = "nccl" if torch.device(device).type == "cuda" \
                else "gloo"
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
            try:
                nccl = _serving_outputs(graph, device, dist.group.WORLD)
                torch.cuda.synchronize()
            finally:
                dist.destroy_process_group()
            t_nccl = time.perf_counter() - t1
            err_nccl = _crowds_equal(nccl, direct)
            print(f"service group (a) ({smi}): the serving crowd over a "
                  f"world-size-1 {backend} group in {t_nccl:.3f} s (init included; the "
                  f"gloo ranks and the CLI server start meanwhile): frames "
                  f"and errors within {err_nccl:.2e} of the direct call's "
                  f"(tol {GROUP_FRAMES_ATOL}), node ids and frame counts "
                  f"{'equal' if np.isfinite(err_nccl) else 'DIFFERENT'}",
                  flush=True)
            if not err_nccl <= GROUP_FRAMES_ATOL:
                _fail("the NCCL group's serving crowd differs from the "
                      "direct call")
            t1 = time.perf_counter()
            one_dtw = _dtw(skel, clips, device)
            t_dtw = time.perf_counter() - t1
            server.check(smi)
            while not group.join(timeout=600):
                pass
        except Exception as e:  # a rank that raised, or the NCCL group
            _fail(f"phase 18's groups: {type(e).__name__}: {e}")
        finally:
            server.stop()
            for p in group.processes:
                if p.is_alive():
                    p.terminate()
        t_group = time.perf_counter() - t0
        outs = [torch.load(os.path.join(tmp, f"out{r}.pt"),
                           weights_only=False) for r in range(GROUP_RANKS)]
    worst, warp_diff = 0.0, 0
    for o in outs:
        worst = max(worst, _crowds_equal((o["frames"], o["crowd"]), direct))
        warp_diff += sum(o["warps"].get(k) != v
                         for k, v in one_dtw[0].items())
        worst = max(worst, max(float(np.abs(np.asarray(o["warped"][k])
                                            - np.asarray(v)).max())
                               for k, v in one_dtw[1].items()))
    print(f"service group (b) ({smi}): {GROUP_RANKS} gloo ranks spawned on "
          f"the one card (NCCL refuses two ranks on one card; "
          f"{torch.cuda.device_count()} card(s) visible) split the serving crowd {8 // GROUP_RANKS}/"
          f"{8 // GROUP_RANKS} and the {GROUP_CLIPS}-clip DTW's pairs: "
          f"{t_group:.2f} s from spawn to join (group (a) and the CLI "
          f"server's check ran meanwhile), each rank's crowd and DTW s "
          f"{[tuple(round(s, 3) for s in o['seconds']) for o in outs]} "
          f"(a fresh process's first crowd), the one-process DTW "
          f"{t_dtw:.3f} s; frames within {worst:.2e} of the one-process "
          f"results (tol {GROUP_FRAMES_ATOL}), {warp_diff} warping "
          f"functions different", flush=True)
    if not worst <= GROUP_FRAMES_ATOL or warp_diff:
        _fail("the gloo group's crowd or DTW differs from one process's")
    t = time.perf_counter() - t_phase
    print(f"phase 18 seconds: {t:.1f} (endpoints {t_endpoints:.1f}, the "
          f"groups and the CLI server {t - t_endpoints:.1f}) ({smi})",
          flush=True)
    return launches, shapes, held, profiled, batch_wall, t


def _trace_summary(prof, device_type, prefix="walk."):
    """(kernels [(name, device ms)], stages {walk.* name: [host ms, device
    busy ms, device span ms]}; `prefix` names the ranges, a string or a
    tuple of them) of a torch.profiler trace, read from its raw
    events: building `prof.events()`' trees of a families run (~1M events)
    takes minutes.  The walk.* ranges appear twice, on the host timeline
    and as a span on the device's; kernels are the other device events.  A
    kernel's busy time counts toward the range whose host interval holds
    the start of the torch op that launched it (the op its linked
    correlation id names) on any thread: unlike
    FunctionEvent.device_time_total, which reads one thread's tree, it
    counts the autograd engine's backward ops (the closed LM's jacrev) in
    walk.lm.  The port's kernels, launched through ctypes outside any torch
    op, count toward no range."""
    op_start, ranges, kernels, stages = {}, [], [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        on_device = e.device_type() == device_type
        if name.startswith(prefix):
            stage = stages.setdefault(name, [0.0, 0.0, 0.0])
            stage[2 if on_device else 0] += e.duration_ns() / 1e6
            if not on_device:
                ranges.append((e.start_ns(), e.end_ns(), name))
        elif on_device:
            kernels.append((name, e.duration_ns() / 1e6,
                            e.linked_correlation_id()))
        elif e.linked_correlation_id() == 0:
            op_start[e.correlation_id()] = e.start_ns()
    ranges.sort()
    starts = [r[0] for r in ranges]
    for _, ms, link in kernels:
        t = op_start.get(link)
        i = -1 if t is None else bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < ranges[i][1]:
            stages[ranges[i][2]][1] += ms
    return [(n, ms) for n, ms, _ in kernels], stages


def phase_profile(name, run, crowd_seconds: float, prefix="walk."):
    """One more crowd run (or request) under torch.profiler: device busy
    time from the CUDA kernel events, CPU / device time per stage (the
    walk.* ranges of constrained_walk.full_walk_step, or a request's
    request.* ranges), and each of the port's kernels' device time and
    launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernel_events, stages = _trace_summary(
        prof, torch.autograd.DeviceType.CUDA, prefix)
    busy_ms = sum(ms for _, ms in kernel_events)
    by_kernel, ours = {}, {}
    for kname, kms in kernel_events:
        by_kernel[kname] = by_kernel.get(kname, 0.0) + kms
        port = _port_kernel(kname)
        if port:
            ms, count = ours.get(port, (0.0, 0))
            ours[port] = (ms + kms, count + 1)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]
    print(f"profile {name}: one run, {len(kernel_events)} kernel "
          f"launches, "
          f"device busy {busy_ms:.1f} ms; wall {wall * 1e3:.1f} ms under "
          f"the profiler, {crowd_seconds * 1e3:.1f} ms without -> device "
          f"idle share {1.0 - busy_ms / (crowd_seconds * 1e3):.3f}", flush=True)
    print(f"profile {name} stages (host ms / device busy ms / device "
          "span ms): "
          + ", ".join(f"{k} {h:.1f}/{b:.1f}/{sp:.1f}"
                      for k, (h, b, sp) in sorted(stages.items())),
          flush=True)
    print(f"profile {name} top kernels (device ms): " + "; ".join(
        f"{name[:60]} {ms:.2f}" for name, ms in top), flush=True)
    print(f"profile {name} the port's kernels (device ms / launches): "
          + "; ".join(f"{k} {ms:.2f}/{n}" for k, (ms, n) in sorted(
              ours.items())), flush=True)


def _resource_usage():
    """Registers, stack and local memory (spills) of the port's kernels, as
    cuobjdump reads them from the built library -> (one summary per
    instance of the selection kernels, one per instance of the others)."""
    from morphablegraphs_tpu_torch.ops import cuda_build
    tool = pathlib.Path(cuda_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "--dump-resource-usage",
                          str(cuda_build.library_path())],
                         capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        _fail(f"cuobjdump: {out.stderr.strip()}")
    usage = r"\S*:\s+REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)"
    selection = [f"{'B3' if m.group(1) == '1' else 'B1'} lanes {m.group(2)}: "
                 f"{m.group(3)} registers, {m.group(5)} B local"
                 for m in re.finditer(r"score_loco_kernelILb([01])ELi(\d+)E"
                                      + usage, out.stdout)]
    others = [f"{m.group(1)}{'<' + m.group(3) + '>' if m.group(3) else ''}: "
              f"{m.group(4)} registers, {m.group(5)} B stack, {m.group(6)} B "
              "local"
              for m in re.finditer(r"\d(chol_solve_kernel|"
                                   r"chol_solve_smem_kernel|lm_delta_kernel|"
                                   r"lm_delta_smem_kernel|gmm_scores_kernel|"
                                   r"back_project_kernel|emit_frames_kernel)"
                                   r"(ILi(\d+)E)?" + usage, out.stdout)]
    if not selection or len(others) < 12:
        _fail("cuobjdump does not list every kernel of the port")
    return selection, others


def main():
    import torch
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    from morphablegraphs_tpu_torch.ops import cuda_build

    device = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    smi = _nvidia_smi()
    print(f"device: {kind} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible)",
          flush=True)
    print(smi, flush=True)

    t0 = time.perf_counter()
    cuda_build.load_library()
    print(f"build: kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    selection, others = _resource_usage()
    print("resources of score_loco.cu: " + "; ".join(selection), flush=True)
    print("resources of the other kernels: " + "; ".join(sorted(others)),
          flush=True)

    graph, stacked = _ref_model(device)
    skel = graph.skeleton
    res = {}
    b1_err, b1_times = phase_selection(stacked, skel, device, False)
    res["chol_solve"] = phase_b2(device)
    b3_err, b3_times = phase_selection(stacked, skel, device, True)
    res["lm_delta"] = phase_b4(device)
    res["gmm_scores"] = phase_b5(stacked, device)
    res["crowd_back_project"], res["emit_frames"] = phase_b6(stacked, device)
    for name, err, times in (
            ("score_locomotion_candidates", b1_err, b1_times),
            ("score_locomotion_candidates_ee", b3_err, b3_times)):
        res[name] = times[(KERNEL_CHARS, 264)]  # `ms` arrives at the flush
        res[name]["max_abs_err"] = err

    serve_counts = phase_serve(graph, device)
    requests = phase_request(graph, device)
    t14 = time.perf_counter()
    options = phase_options(graph, device)
    t14 = [time.perf_counter() - t14]
    res_request = phase_request_kernels(graph, device)
    phase_reference(stacked, skel)
    phase_request_reference(graph)
    t0 = time.perf_counter()
    phase_options_reference(graph)
    t14.append(time.perf_counter() - t0)
    t15 = time.perf_counter()
    planner_graph = _planner_graph()
    planner_counts, planner_shapes, t_sessions = phase_planner(
        planner_graph, device, smi)
    res_planner = phase_planner_kernels(planner_graph, device,
                                        planner_shapes)
    t_reference = phase_planner_reference(planner_graph)
    print(f"phase 15 seconds: {time.perf_counter() - t15:.1f} (sessions "
          f"{t_sessions:.1f}, GPU vs CPU reference {t_reference:.1f})",
          flush=True)
    service_tmp = tempfile.TemporaryDirectory()
    service_zip = str(pathlib.Path(service_tmp.name) / "packaged_walk.zip")
    package_counts, package_shapes, package_held, t16 = phase_package(
        device, smi, zip_copy=service_zip)
    print(f"phase 16 seconds: {t16:.1f}", flush=True)
    cluster_counts, cluster_shapes, cluster_held, t17 = phase_cluster(
        device, smi)
    print(f"phase 17 seconds: {t17:.1f}", flush=True)
    phase_random_reference(stacked)
    crowds = {name: phase_crowd(name, stacked, skel, device, smi)
              for name in CROWDS}
    fused, unfused = crowds["ee_fused"][1], crowds["ee"][1]
    print(f"crowd ee: LM step through B4 {fused:.1f} frames/s vs through "
          f"B2 {unfused:.1f} frames/s (ratio {fused / unfused:.3f})",
          flush=True)
    randoms = {name: phase_random_crowd(name, stacked, device, smi)
               for name in ("segments", "concat", "canonical")}
    (service_counts, service_shapes, service_held, service_run,
     service_wall, _) = phase_service(graph, stacked, device, smi,
                                      service_zip, set(b1_times))
    service_tmp.cleanup()
    _flush_kernel_lines()
    for name in ("root", "ee", "lm_exact", "families"):
        phase_profile(name, crowds[name][4], crowds[name][0])
    phase_profile("random segments (config 5)", randoms["segments"][3],
                  randoms["segments"][0])
    for name, (gen, mg_input, wall, _) in requests.items():
        phase_profile(f"request {name}",
                      lambda _, gen=gen, mg_input=mg_input:
                      gen.generate_motion(mg_input), wall, "request.")
    t0 = time.perf_counter()
    for name, (run, wall, _, _) in options.items():
        phase_profile(f"request {name}", run, wall, "request.")
    t14.append(time.perf_counter() - t0)
    phase_profile("service batch (the batch endpoint's direct call: 8 "
                  "requests through BatchedGenerator, the keyframe request "
                  "through MGContext.run)", service_run, service_wall,
                  ("walk.", "request."))
    print(f"phase 14 seconds: requests {t14[0]:.1f}, GPU vs CPU reference "
          f"{t14[1]:.1f}, their profiles (phase 12) {t14[2]:.1f}; total "
          f"{sum(t14):.1f}", flush=True)

    src = "morphablegraphs_tpu_torch/csrc/"
    tpu = "morphablegraphs_tpu/ops/pallas_kernels.py:"
    # (kernel, source, TPU kernel's line, the run whose launches count)
    table = (("score_locomotion_candidates", "score_loco.cu", 561,
              serve_counts),
             ("chol_solve", "chol_solve.cu", 755, serve_counts),
             ("score_locomotion_candidates_ee", "score_loco.cu", 477,
              crowds["ee"][3]),
             ("lm_delta", "lm_delta.cu", 886, crowds["ee_fused"][3]),
             ("gmm_scores", "gmm_scores.cu", 163, crowds["root"][3]),
             ("crowd_back_project", "back_project.cu", 76,
              randoms["canonical"][2]),
             ("emit_frames", "back_project.cu", 76, randoms["segments"][2]))
    # the request path's launches and the kernels at its shapes
    req_counts = requests["config3"][3]
    by_request = {name: r[3] for name, r in requests.items()}
    by_request.update({name: o[2] for name, o in options.items()})
    b5_global = {name: o[3] for name, o in options.items()}
    request = {"chol_solve": [res_request["chol_solve"]],
               "gmm_scores": [res_request["gmm_scores_1"],
                              res_request["gmm_scores_50"],
                              res_request["gmm_scores_window"]],
               "emit_frames": [res_request["emit_frames_step"],
                               res_request["emit_frames_convert"],
                               res_request["emit_frames_rebuild"]]}
    print(f"chip_smoke seconds: {time.perf_counter() - t_start:.1f}",
          flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src + source,
         "replaces": f"{tpu}{line}", "launches": counts[name], **res[name],
         **({"request": {"launches": req_counts[name],
                         "launches_by_request": {
                             r: c[name] for r, c in by_request.items()},
                         **({"launches_in_global_passes": b5_global}
                            if name == "gmm_scores" else {}),
                         "shapes": request[name]}}
            if name in request else {}),
         **({"planner": {
             "launches": planner_counts[name],
             "shapes": {str(list(k)): n
                        for k, n in planner_shapes[name].items()},
             "held": res_planner[name]}}
            if name in planner_shapes else {}),
         **({"package": {
             "launches": package_counts[name],
             "shapes": {str(list(k)): n
                        for k, n in package_shapes[name].items()},
             "held": package_held[name]}}
            if name in package_shapes else {}),
         **({"cluster": {
             "launches": cluster_counts[name],
             "shapes": {str(list(k)): n
                        for k, n in cluster_shapes[name].items()},
             "held": cluster_held[name]}}
            if name in cluster_shapes else {}),
         **({"service": {
             "launches": {e: c[name] for e, c in service_counts.items()},
             "shapes": {str(list(k)): n
                        for k, n in service_shapes[name].items()},
             "held": service_held[name]}}
            if name in service_shapes else {})}
        for name, source, line, counts in table]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
