"""The PFNN crowd: `synthesis.pfnn_crowd.pfnn_crowd_walk`, one walk after
another, each of every character's frames.

Set-up writes the configuration's network (`model_pfnn.arrays`, from the
seed) as a graph zip's pfnn/ section (`models.zip_writer`) and loads it as
a package ships it (`models.pfnn.read_pfnn_from_zip`); each character's
path comes from `generate.paths`.  Reads from the traffic file:
characters, frames, the path's shape and path_granularity, jog_share (the
characters that jog, the others walk), speed_cm_s (per gait), blend_bias,
judged.  Each walk draws its characters' gaits and starting phases from
the seed and the walk's index, on the device.

To judge the walk frame by frame from the program's own state, the driver
observes the entry's frame step (`pfnn_crowd._frame_step`) in the judged
walk alone and keeps the judged rows of what it was handed and what it
returned.  Where the program makes no such call, the judge says so
(`state_missing`), so `correct` comes out false with that reason rather
than the run failing."""

from __future__ import annotations

import contextlib
import dataclasses
import pathlib
import tempfile

import torch

from .. import generate, model_pfnn
from ..reference import judge_pfnn
from ..reference import pfnn as ref_pfnn
from . import common

ROOT = pathlib.Path(__file__).resolve().parents[2]
WALK_STREAM = 2 ** 22


class Driver(common.Driver):
    RATE = "frames_per_s.crowd"

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from morphablegraphs_tpu_torch.models import pfnn, zip_writer
        from morphablegraphs_tpu_torch.ops import spline_path
        from morphablegraphs_tpu_torch.synthesis import pfnn_crowd
        self.entry = pfnn_crowd
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.kept = None
        tr = traffic
        self.arrays = model_pfnn.arrays(config, seed)
        self.skeleton = pfnn.skeleton_of(model_pfnn.joints(config))
        build = ROOT / "build"
        build.mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            path = str(pathlib.Path(tmp) / "pfnn_holden.zip")
            zip_writer.write_graph_zip(path, self.skeleton, {}, {},
                                       pfnn_data=self.arrays)
            self.model = pfnn.read_pfnn_from_zip(
                path, config["n_controls"], config["hidden"], device=device)
        self.control_points = generate.paths(seed, tr["characters"], tr)
        # built on the host, moved to the card one leaf at a time
        self.paths = spline_path.map_leaves(spline_path.stack_paths([
            spline_path.build(p, unconstrained_dims=(1,),
                              granularity=tr["path_granularity"],
                              device="cpu")
            for p in self.control_points]), lambda x: x.to(device))
        self._judged = torch.as_tensor(common.judged_characters(
            seed, tr["characters"], tr["judged"]), device=device)

    # -- one walk --------------------------------------------------------
    def draws(self, index: int):
        """(gait [C, 6], starting phase [C], speed [C] cm/s) of walk
        `index`, drawn on the device."""
        tr, dev = self.traffic, self.device
        gen = torch.Generator(device=dev).manual_seed(
            generate.stream_seed(self.seed, WALK_STREAM + index))
        c = tr["characters"]
        jog = torch.rand((c,), generator=gen, device=dev) < tr["jog_share"]
        phase = torch.rand((c,), generator=gen, device=dev)
        zero = torch.zeros((c,), device=dev)
        gait = torch.stack([zero, (~jog).float(), jog.float(), zero, zero,
                            zero], -1)
        speed = torch.where(jog, float(tr["speed_cm_s"]["jog"]),
                            float(tr["speed_cm_s"]["walk"]))
        return gait, phase, speed

    def walk(self, index: int, keep: bool = False) -> torch.Tensor:
        gait, phase, speed = self.draws(index)
        seen = []
        with self._observed(seen) if keep else contextlib.nullcontext():
            frames, n_frames = self.entry.pfnn_crowd_walk(
                self.model, self.paths, gait, phase, self.traffic["frames"],
                speed, self.traffic["blend_bias"], skeleton=self.skeleton)
        if keep:
            idx = self._judged
            self.kept = dict(seen=seen, n_frames=n_frames[idx],
                             speed=speed[idx], emitted=frames[idx],
                             nonfinite=(~torch.isfinite(frames)).sum())
        return n_frames.sum()

    @contextlib.contextmanager
    def _observed(self, into: list):
        """Within: the judged rows of each frame step's state, arc and
        outputs, appended to `into` as one dict a frame."""
        step = getattr(self.entry, "_frame_step", None)
        if step is None:
            yield
            return
        idx = self._judged

        def spy(model, paths, parents, bias, state, arc, speed):
            out = step(model, paths, parents, bias, state, arc, speed)
            new, arc_out, facing, y, frame = out
            seen = {"in." + f.name: getattr(state, f.name)[idx]
                    for f in dataclasses.fields(state)}
            seen.update({"out." + f.name: getattr(new, f.name)[idx]
                         for f in dataclasses.fields(new)})
            seen.update({"in.arc": arc[idx], "out.arc": arc_out[idx],
                         "facing": facing[idx], "y": y[idx],
                         "frame": frame[idx]})
            into.append(seen)
            return out

        self.entry._frame_step = spy
        try:
            yield
        finally:
            self.entry._frame_step = step

    # -- judging ---------------------------------------------------------
    def observed(self, kept) -> dict | None:
        """The kept frames stacked, [F, R, ...] each; None where nothing
        was observed."""
        if kept is None or not kept["seen"]:
            return None
        names = kept["seen"][0].keys()
        if not set(judge_pfnn.STATE) <= {n[3:] for n in names
                                          if n.startswith("in.")}:
            return None
        return {n: torch.stack([s[n] for s in kept["seen"]]) for n in names}

    def program_outputs(self, observed: dict, device) -> dict:
        keys = ["facing", "y", "frame"] + ["out." + k
                                            for k in judge_pfnn.STATE]
        return {k: judge_pfnn.flat(observed[k]).to(device, torch.float64)
                for k in keys}

    def reference_outputs(self, kept, dtype, device, round_fn=None) -> dict:
        """The reference in the program's place, from the program's
        observed state, its facing from its own path (the control: float32
        and ops.tf32_round)."""
        net = ref_pfnn.Network(self.arrays, dtype, device, round_fn)
        observed = self.observed(kept)
        return judge_pfnn.reference_outputs(
            net, self.parents(), observed, kept["speed"],
            self.traffic["blend_bias"], dtype, device,
            path=self.judged_paths(observed, dtype, device))

    def judged_paths(self, observed: dict, dtype, device):
        return judge_pfnn.frames_path(
            self.control_points[self._judged.cpu().numpy()],
            self.traffic["path_granularity"], observed["y"].shape[0], dtype,
            device)

    def parents(self) -> tuple:
        return tuple(p for _, p, _ in model_pfnn.joints(self.config))

    def judge(self, kept, device, outputs=None) -> dict:
        """kept: the judged walk's observations -> the numbers compared;
        outputs, where given, stand in for the program's (a control)."""
        observed = self.observed(kept)
        if observed is None:
            return judge_pfnn.missing()
        net = ref_pfnn.Network(self.arrays, torch.float64, device)
        path = self.judged_paths(observed, torch.float64, device)
        if outputs is None:
            outputs = self.program_outputs(observed, device)
        return judge_pfnn.judge(
            net, self.parents(), path, observed, outputs, kept["speed"],
            self.traffic["blend_bias"], kept["n_frames"].to(device),
            self.traffic["frames"], kept["nonfinite"].to(device),
            kept["emitted"])

    # -- counts ----------------------------------------------------------
    def shapes(self) -> dict:
        c = self.config
        return {"pfnn": dict(n=self.traffic["characters"],
                             frames=self.traffic["frames"], x=c["x_dim"],
                             h=c["hidden"], y=c["y_dim"],
                             p=c["n_controls"])}
