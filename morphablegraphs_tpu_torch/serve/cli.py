"""Command-line entry points (port of morphablegraphs_tpu.serve.cli).

    python -m morphablegraphs_tpu_torch.serve.cli train MOTION_DIR NAME \
        [--nproc N]
    python -m morphablegraphs_tpu_torch.serve.cli cluster-trees MODEL_DIR \\
        [--config configs/space_partitioning.json]
    python -m morphablegraphs_tpu_torch.serve.cli run GRAPH.zip INPUT_DIR \\
        OUTPUT_DIR [--config configs/standard_algorithm.config]
    python -m morphablegraphs_tpu_torch.serve.cli serve GRAPH.zip [--port P] \
        [--nproc N]
    python -m morphablegraphs_tpu_torch.serve.cli set-config CONFIG [--url U]

Replaces reference examples/run_construction.py (train),
mg_command_line_interface.py (the offline pipeline),
generate_cluster_trees.py and mg_rest_interface.py (serve: the REST
service of serve/rest.py).  Every command runs on the CUDA device unless
it is given --device cpu.  `train` and `serve` run on one rank, this
process, unless given --nproc N: then over N ranks (`parallel.launch`),
one process per card, the DTW's pair grids and each batch's crowd split
over them, as the JAX package's training and batch span every device.
Extra ranks cost their start (seconds each) and a batch's split pays a
gather: on four H100 cards neither paid back (ROADMAP, "Known
differences").  `mg-torch` is the same command line.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional

import torch
import torch.distributed as dist

from .. import parallel
from ..construct.constructor import (MotionModelConstructor,
                                     define_sections_from_annotations,
                                     define_sections_from_keyframes)
from ..construct.space_partitioning import build_cluster_tree_for_primitive
from ..models import primitive as prim_mod
from ..models.graph import load_graph
from ..models.skeleton import bvh_to_quat_frames, load_bvh, write_bvh
from ..synthesis.motion_generator import MotionGenerator
from ..utils import device as device_mod
from ..utils.config import default_config, load_config


def load_motion_data(motion_folder: str, max_count: int = 100):
    """A BVH directory -> (its first skeleton, {name: quaternion frames}),
    at most max_count files in name order (reference run_construction.py
    :40-75 load_motion_data)."""
    motions = {}
    skeleton = None
    paths = sorted(glob.glob(os.path.join(motion_folder, "*.bvh")))
    for path in paths[:max_count]:
        skel, euler = load_bvh(path)
        if skeleton is None:
            skeleton = skel
        motions[os.path.basename(path)[:-4]] = bvh_to_quat_frames(skel,
                                                                  euler)
    return skeleton, motions


def train_model(motion_folder: str, name: str,
                output_filename: Optional[str] = None, version: int = 3,
                config: Optional[dict] = None, export_sample: bool = True,
                device=None) -> Optional[str]:
    """Train a motion primitive from a BVH directory on `device` (CUDA
    unless named), write its model JSON and, with export_sample, a BVH of
    one draw of the trained model next to it (reference
    run_construction.py:156-222 train_model, with its round-trip check).
    In a default process group of several ranks (`cli train --nproc`)
    every rank loads and aligns the clips and the DTW's pair grids split
    over the ranks; rank 0 alone fits and writes the model, and the other
    ranks return None.

    The DTW runs per section (reference :164-176) when the folder has a
    `keyframes.json` ({motion name: split frame}: two sections per clip;
    clips without an entry are left out) or per-motion
    `<name>_sections.json` files ({"semantic_annotation": {label:
    [frames...]}}); otherwise over whole clips.  -> the model's path."""
    dev = device_mod.resolve(device, "train_model")
    skeleton, motions = load_motion_data(motion_folder)
    if skeleton is None or not motions:
        raise ValueError(f"no BVH files found in {motion_folder}")
    keyframes_path = os.path.join(motion_folder, "keyframes.json")
    sections = None
    if os.path.isfile(keyframes_path):
        with open(keyframes_path) as f:
            keyframes = json.load(f)
        sections = define_sections_from_keyframes(motions, keyframes)
        if sections:
            motions = {k: motions[k] for k in sections}
    else:
        motions, sections = define_sections_from_annotations(motion_folder,
                                                             motions)
    c = MotionModelConstructor(skeleton, config, device=dev)
    c.set_motions(motions)
    c.set_dtw_sections(sections)
    if dist.is_available() and dist.is_initialized() and dist.get_rank():
        c.align()
        return None
    model = c.construct_model(name, version=version)
    output_filename = output_filename or f"{name}_mm.json"
    with open(output_filename, "w") as f:
        json.dump(model, f)
    if export_sample:
        # the sample's path replaces the model's extension ("walk.json"
        # -> "walk_sample.bvh"), never the model file itself
        base = output_filename
        for suffix in ("_mm.json", ".json"):
            if base.endswith(suffix):
                base = base[: -len(suffix)]
                break
        prim = prim_mod.load_primitive(output_filename, device=dev)
        frames, n, _ = prim_mod.sample_frames(
            torch.Generator(device=dev).manual_seed(0), prim,
            max_frames=prim.n_canonical_frames * 2)
        write_bvh(skeleton, frames[: int(n)].cpu().numpy(),
                  base + "_sample.bvh")
    return output_filename


def run_pipeline(graph_path: str, input_dir: str, output_dir: str,
                 config: Optional[dict] = None, device=None) -> str:
    """Offline synthesis: the newest constraint JSON in input_dir -> a BVH
    and its annotation files in output_dir, on `device` (CUDA unless
    named) (reference mg_command_line_interface.py:29-60).  -> the BVH's
    path."""
    from .export import AnnotatedMotion
    inputs = sorted(glob.glob(os.path.join(input_dir, "*.json")),
                    key=os.path.getmtime)
    if not inputs:
        raise ValueError(f"no input JSON in {input_dir}")
    with open(inputs[-1]) as f:
        mg_input = json.load(f)
    dev = device_mod.resolve(device, "run_pipeline")
    graph = load_graph(graph_path, device=dev)
    gen = MotionGenerator(graph, config or default_config(), device=dev)
    result = gen.generate_motion(mg_input)
    os.makedirs(output_dir, exist_ok=True)
    out = os.path.join(output_dir, "output")
    AnnotatedMotion(graph.skeleton, result.frames,
                    result.action_ranges).export(out)
    return out + ".bvh"


def generate_cluster_trees(model_dir: str, n_samples: int = 10000,
                           n_subdivisions: int = 4, max_level: int = 4,
                           seed: int = 0, device=None) -> list:
    """A cluster tree for every *_mm.json under model_dir, its samples
    drawn on `device` (CUDA unless named) from a torch.Generator seeded
    with `seed`, saved next to the model as `<prefix>_cluster_tree.json`
    and `.data` (reference examples/generate_cluster_trees.py and
    construction/cluster_tree_builder.py).  -> the JSON paths."""
    dev = device_mod.resolve(device, "generate_cluster_trees")
    out = []
    for path in sorted(glob.glob(os.path.join(model_dir, "**", "*_mm.json"),
                                 recursive=True)):
        prim = prim_mod.load_primitive(path, device=dev)
        tree = build_cluster_tree_for_primitive(
            torch.Generator(device=dev).manual_seed(seed), prim,
            n_samples=n_samples, n_subdivisions=n_subdivisions,
            max_level=max_level)
        prefix = path[: -len("_mm.json")]
        tree.save(prefix)
        out.append(prefix + "_cluster_tree.json")
    return out


def _train_rank(ranks, motion_folder: str, name: str,
                output: Optional[str], version: int):
    """`cli train` on one rank; rank 0 prints the model's path."""
    path = train_model(motion_folder, name, output, version,
                       device=ranks.device)
    if path is not None:
        print(path)


def main(argv=None):
    p = argparse.ArgumentParser(prog="mg-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def with_device(parser):
        parser.add_argument("--device", default="cuda",
                            help="torch device to run on (default cuda)")
        return parser

    def with_ranks(parser):
        parser.add_argument(
            "--nproc", type=int, default=1,
            help="ranks, one process each, rank r on card r (default 1); "
                 "more ranks than cards share them over gloo")
        return with_device(parser)

    t = with_ranks(sub.add_parser(
        "train", help="train a motion primitive from BVH clips"))
    t.add_argument("motion_folder")
    t.add_argument("name")
    t.add_argument("--output")
    t.add_argument("--version", type=int, default=3)

    r = with_device(sub.add_parser(
        "run", help="run synthesis on the newest input JSON"))
    r.add_argument("graph_path")
    r.add_argument("input_dir")
    r.add_argument("output_dir")
    r.add_argument("--config")

    ct = with_device(sub.add_parser(
        "cluster-trees", help="build cluster trees for models"))
    ct.add_argument("model_dir")
    ct.add_argument("--samples", type=int, default=10000)
    ct.add_argument("--config", default=None,
                    help="space_partitioning.json (reference examples/config/"
                         "space_partitioning.json schema)")

    s = with_ranks(sub.add_parser("serve", help="start the REST service"))
    s.add_argument("graph_path")
    s.add_argument("--port", type=int, default=8889)

    sc = sub.add_parser("set-config", help="POST an algorithm config to a "
                        "running server (reference "
                        "mg_set_rest_interface_config.py)")
    sc.add_argument("config_file")
    sc.add_argument("--url", default="http://localhost:8889")

    args = p.parse_args(argv)
    if args.cmd == "train":
        parallel.launch(_train_rank, (args.motion_folder, args.name,
                                      args.output, args.version),
                        nproc=args.nproc, device=args.device)
    elif args.cmd == "run":
        cfg = load_config(args.config) if args.config else None
        print(run_pipeline(args.graph_path, args.input_dir, args.output_dir,
                           cfg, device=args.device))
    elif args.cmd == "cluster-trees":
        n_samples, n_sub, max_level, seed = args.samples, 4, 4, 0
        if args.config:
            with open(args.config) as f:
                sp = json.load(f)
            n_samples = int(sp.get("n_random_samples", n_samples))
            n_sub = int(sp.get("n_subdivisions_per_level", n_sub))
            # the reference stores a huge n_levels and lets the sample
            # count bound the recursion: clamped to 8
            max_level = min(int(sp.get("n_levels", max_level)), 8)
            seed = int(sp.get("random_seed") or 0)
        for f in generate_cluster_trees(args.model_dir, n_samples, n_sub,
                                        max_level, seed, device=args.device):
            print(f)
    elif args.cmd == "serve":
        from . import rest
        rest.main(args.graph_path, args.port, device=args.device,
                  nproc=args.nproc)
    elif args.cmd == "set-config":
        import urllib.request
        with open(args.config_file, "rb") as f:
            body = f.read()
        req = urllib.request.Request(args.url.rstrip("/")
                                     + "/set_configuration", data=body,
                                     method="POST")
        with urllib.request.urlopen(req) as resp:
            print(resp.read().decode())


if __name__ == "__main__":
    main()
