"""Shared fixtures of the PyTorch-port parity tests: the same synthetic model,
paths, constraint sets and random draws for the JAX package and the port,
handed across as numpy arrays."""

import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morphablegraphs_tpu.constraints import compiled as cj
from morphablegraphs_tpu.models import graph as gj
from morphablegraphs_tpu.models import skeleton as skj
from morphablegraphs_tpu.ops import spline_path as spj
from morphablegraphs_tpu.utils import synthetic as synj
from morphablegraphs_tpu_torch.constraints import compiled as ct
from morphablegraphs_tpu_torch.models import graph as gt
from morphablegraphs_tpu_torch.models import skeleton as skt
from morphablegraphs_tpu_torch.ops import spline_path as spt
from morphablegraphs_tpu_torch.synthesis import walk as wt


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def model(scale: str):
    """(JAX skeleton, JAX StackedGraph, port skeleton, port StackedGraph
    carrying the JAX graph's leaves, including its step statistics)."""
    if scale == "toy":
        gd, bvh = synj.make_graph_dict(), synj.TEST_BVH
    else:
        gd, bvh = synj.make_reference_scale_graph_dict(), synj.REF_BVH
    skel_j, _ = skj.load_bvh(bvh)
    st_j = gj.stack_graph(gj.build_graph_from_dict(gd))
    skel_t, _ = skt.load_bvh(bvh)
    return skel_j, st_j, skel_t, gt.from_jax_numpy(to_numpy(st_j))


def port_skeleton(skel_j) -> skt.Skeleton:
    """The port's Skeleton with a JAX Skeleton's topology, offsets and rest
    rotations (for skeletons built without a BVH file)."""
    return skt.Skeleton(
        node_names=skel_j.node_names, parents=skel_j.parents,
        offsets=np.asarray(skel_j.offsets), node_channels=skel_j.node_channels,
        animated_joints=skel_j.animated_joints, frame_time=skel_j.frame_time,
        joint_weights=skel_j.joint_weights,
        rest_rotations=skel_j.rest_rotations)


def bspline_knots(n_basis: int, n_frames: int) -> np.ndarray:
    """The JAX package's clamped cubic knot vector."""
    from morphablegraphs_tpu.ops import bspline as bsj
    return bsj.clamped_knots(n_basis, n_frames)


def fixed_joint_skeleton():
    """JAX's three-node skeleton of tests/test_pallas_kernels.py: an animated
    Hips, a fixed joint with a 90-degree rest rotation about z, and its
    tip.  Returns (JAX skeleton, port skeleton)."""
    half = np.deg2rad(90) / 2
    rot90z = [float(np.cos(half)), 0.0, 0.0, float(np.sin(half))]
    skel_j = skj.load_skeleton_json({
        "root": "Hips", "animated_joints": ["Hips"],
        "nodes": {
            "Hips": {"offset": [0, 1, 0], "children": ["Fixed"]},
            "Fixed": {"offset": [0, 10, 0], "children": ["Tip"],
                      "rotation": rot90z},
            "Tip": {"offset": [0, 5, 0], "children": []},
        }})
    return skel_j, port_skeleton(skel_j)


def ee_step_scs(skel_j, joint: str, frame: float, position, n_steps: int,
                weight: float = 1.0):
    """bench.py's ee constraint sets: a keyframe on `joint` in user slot 2
    on every step.  Returns (JAX host sets, the port's host sets)."""
    base = cj.set_keyframe_constraint(
        cj.empty_step_constraints(skel_j, 0), 2, skel_j, joint, frame,
        position=np.asarray(position, np.float32), weight=weight)
    scs_j = jax.tree.map(lambda x: np.broadcast_to(
        np.asarray(x), (n_steps,) + np.shape(x)).copy(), base)
    return scs_j, ct.from_jax_numpy(scs_j, host=True)


def rand_paths(n: int, seed: int = 0, granularity: int = 256,
               seg_len: float = 60.0):
    """n random 4-point walking paths (JAX PathSplines)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pts = [[0.0, 0.0, 0.0]]
        x, z, h = 0.0, 0.0, rng.uniform(-0.6, 0.6)
        for _ in range(3):
            h += rng.uniform(-0.4, 0.4)
            x += seg_len * np.sin(h)
            z += seg_len * np.cos(h)
            pts.append([x, 0.0, z])
        out.append(spj.build(np.asarray(pts, np.float32),
                             unconstrained_dims=(1,),
                             granularity=granularity))
    return out


def stack_jax_paths(paths):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *paths)


def port_paths(paths_j_stacked) -> spt.PathSpline:
    return spt.from_jax_numpy(to_numpy(paths_j_stacked))


def port_sc(scs_j) -> ct.StepConstraints:
    """Per-character JAX StepConstraints (list) -> one port set with a
    leading [C] axis."""
    return ct.from_jax_numpy(jax.tree.map(
        lambda *xs: np.stack([np.asarray(x) for x in xs]), *scs_j))


def loco_sc(skel_j, st_j, node_id: int, path, travelled: float,
            goal_arc: float, prev_last, has_prev: float):
    """A JAX constraint set with the walk's locomotion slots filled."""
    n_can = float(st_j.n_canonical[node_id])
    sc = jax.tree.map(jnp.asarray, cj.empty_step_constraints(skel_j, 0))
    loco = cj.LocoSpec(
        goal_arc=jnp.asarray(goal_arc), half_arc=jnp.asarray(goal_arc / 2),
        node=jnp.asarray(0, jnp.int32), end_kf=jnp.asarray(n_can - 1),
        mid_kf=jnp.asarray((n_can - 1) / 2),
        dim_mask=jnp.array([1.0, 0, 1.0]), pos_weight=jnp.asarray(1.0),
        dir_weight=jnp.asarray(0.8))
    sc = sc.replace(traj=path, traj_active=jnp.asarray(1.0),
                    traj_node=jnp.asarray(0, jnp.int32),
                    traj_min_arc=jnp.asarray(travelled),
                    n_canonical=jnp.asarray(n_can),
                    has_prev=jnp.asarray(has_prev),
                    prev_last=jnp.asarray(prev_last))
    return cj.fill_locomotion_slots(sc, path, loco)


def prev_frame(d: int, x: float, z: float, seed: int = 0) -> np.ndarray:
    """A plausible previous last frame: root at (x, ., z), unit quats."""
    rng = np.random.default_rng(seed)
    f = np.zeros(d, np.float32)
    f[0], f[1], f[2] = x, 90.0, z
    q = rng.standard_normal((d - 3) // 4 * 4).reshape(-1, 4) * 0.1
    q[:, 0] += 1.0
    f[3:] = (q / np.linalg.norm(q, axis=1, keepdims=True)).reshape(-1)
    return f


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6))
def jax_walk_draws(key, n_chars, n_steps, n_samples, k_comp, l_dim,
                   n_nodes):
    """The noise constrained_walk_full_crowd draws from `key`: characters
    split(key, n_chars); per step split(state key, 3) -> (k_s, k_t, k_n),
    split(k_s) -> (k_comp, k_norm); `categorical` is argmax(logits +
    gumbel(k, shape)).  Returns [C, S, ...] arrays."""
    def per_char(kc):
        def body(k_state, _):
            k_s, k_t, k_n = jax.random.split(k_state, 3)
            k_c, k_nm = jax.random.split(k_s)
            return k_n, (
                jax.random.gumbel(k_c, (n_samples, k_comp), jnp.float32),
                jax.random.normal(k_nm, (n_samples, l_dim), jnp.float32),
                jax.random.gumbel(k_t, (n_nodes,), jnp.float32))
        return jax.lax.scan(body, kc, None, length=n_steps)[1]
    return jax.vmap(per_char)(jax.random.split(key, n_chars))


def port_draws(draws_j):
    """[C, S, ...] JAX draws -> step index -> port StepDraws."""
    gc, nz, gt_ = (torch.as_tensor(np.array(a)) for a in draws_j)

    def at(t):
        return wt.StepDraws(comp_gumbel=gc[:, t].contiguous(),
                             normal=nz[:, t].contiguous(),
                             trans_gumbel=gt_[:, t].contiguous())
    return at


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def jax_random_walk_draws(keys, n_steps, k_comp, l_dim, n_nodes):
    """The noise the JAX random walks draw from per-character keys [C]
    (random_walk_crowd: split(key, n_chars); random_walk: key[None]): per
    step split(state key, 3) -> (k_sample, k_trans, k_next),
    sample_node_latent's split(k_sample) -> (k_comp, k_norm), one
    categorical draw of a component and of a transition.  Returns
    [C, S, ...] arrays."""
    def per_char(kc):
        def body(k_state, _):
            k_s, k_t, k_n = jax.random.split(k_state, 3)
            k_c, k_nm = jax.random.split(k_s)
            return k_n, (
                jax.random.gumbel(k_c, (k_comp,), jnp.float32),
                jax.random.normal(k_nm, (l_dim,), jnp.float32),
                jax.random.gumbel(k_t, (n_nodes,), jnp.float32))
        return jax.lax.scan(body, kc, None, length=n_steps)[1]
    return jax.vmap(per_char)(keys)


def port_random_draws(draws_j):
    """[C, S, ...] JAX random-walk draws -> step index -> port StepDraws
    with one draw per character ([C, 1, K], [C, 1, L], [C, N])."""
    gc, nz, gt_ = (np.array(a) for a in draws_j)
    return port_draws((gc[:, :, None], nz[:, :, None], gt_))


# joints of the family constraints on each model (the toy skeleton has no
# hands: its Leg and Head stand in for them)
FAMILY_JOINTS = {
    "toy": dict(head="Head", spine="Spine", hand="Leg", hand2="Head"),
    "ref": dict(head="Head", spine="Spine1", hand="RightHand",
                hand2="LeftHand"),
}
FAMILIES = ("look_at", "rel_transform", "joint_rotation", "pose", "ca",
            "traj_set", "active_range")
LOOK_AT_TARGET = (200.0, 150.0, -300.0)
JR_QUAT = (float(np.cos(np.pi / 12)), float(np.sin(np.pi / 12)), 0.0, 0.0)


def ts_splines(sp_mod, granularity: int = 256):
    """The trajectory set's two splines (built by sp_mod, the JAX package's
    spline_path or the port's): a 100 cm one for the hand, and a 10 cm one
    for the second joint, whose arc runs off its end within a step."""
    return [sp_mod.build(np.array([[25.0, 100.0, 0.0], [28.0, 102.0, 50.0],
                                   [30.0, 100.0, 100.0]], np.float32),
                         granularity=granularity),
            sp_mod.build(np.array([[-25.0, 100.0, 0.0],
                                   [-25.0, 100.0, 10.0]], np.float32),
                         granularity=granularity)]


def add_family(mod, sp_mod, sc, skel, scale: str, family: str,
               pose_frame=None):
    """sc with one family's slot(s) set through `mod`'s builders (the JAX
    package's compiled module or the port's) on `scale`'s joints; "all"
    sets every family (the pose from pose_frame [D])."""
    j = FAMILY_JOINTS[scale]
    if family == "all":
        for f in FAMILIES:
            sc = add_family(mod, sp_mod, sc, skel, scale, f, pose_frame)
        return sc
    if family == "look_at":
        return mod.set_look_at_constraint(sc, skel, j["head"],
                                          np.asarray(LOOK_AT_TARGET), 20.0)
    if family == "rel_transform":
        return mod.set_relative_transform_constraint(
            sc, skel, j["hand"], j["spine"], [10.0, -20.0, 5.0], 15.0,
            weight=0.9)
    if family == "joint_rotation":
        return mod.set_joint_rotation_constraint(sc, skel, j["spine"],
                                                 JR_QUAT, 12.0, weight=1.1)
    if family == "pose":
        return mod.set_pose_constraint(sc, skel, pose_frame, weight=0.5)
    if family == "ca":
        sc = mod.set_ca_constraint(sc, skel, j["hand"], [30.0, 100.0, 40.0])
        return mod.set_ca_constraint(sc, skel, j["head"],
                                     [-20.0, np.nan, 60.0], weight=0.7,
                                     slot=1)
    if family == "traj_set":
        return mod.set_trajectory_set_constraint(
            sc, skel, [j["hand"], j["hand2"]], ts_splines(sp_mod),
            arc0=[0.0, 3.0], weight=1.3)
    if family == "active_range":
        return mod.set_trajectory_active_range(sc, 5.0, 40.0)
    raise ValueError(family)


def request_graphs(graph_dict: dict, bvh: str):
    """The JAX package's graph and the port's from one graph dict, each
    with its skeleton from `bvh`; the port's step statistics are JAX's
    (`copy_step_statistics`)."""
    g_j = gj.build_graph_from_dict(graph_dict)
    g_j.skeleton = skj.load_bvh(bvh)[0]
    g_t = gt.build_graph_from_dict(graph_dict)
    g_t.skeleton = skt.load_bvh(bvh)[0]
    copy_step_statistics(g_j, g_t)
    return g_j, g_t


def copy_step_statistics(graph_j, graph_t):
    """Carry the JAX graph's average step lengths (drawn with
    PRNGKey(1234)) into the port's graph (drawn from a torch.Generator):
    the planner's end condition reads them."""
    for key, node in graph_j.nodes.items():
        graph_t.nodes[key].average_step_length = node.average_step_length


def jax_key_sampler(graph_j, seed: int):
    """The draws of the JAX MotionGenerator(seed=seed), replayed for the
    port's sampler hook: `_next_key` splits PRNGKey(seed) once per draw and
    each sub-key feeds one `sample_latent(sub, prim, n)`; the port calls
    sampler(node_key, n) at the same points in the same order.

    With a transition model, the port passes the conditioned mixture,
    sampler(node_key, n, gmm=...), where JAX calls
    `tm.predict_parameters(self._next_key(), model, prev, n)`, i.e.
    `gmm.sample(key, predict(model, prev), n)`: the replay samples the
    port's mixture with JAX's key.  A constrained step (a pool, n > 1)
    splits one key more before it: JAX evaluates generate_step's own
    `_next_key()` argument first and, given candidates, draws nothing
    with it.  A cluster-tree step's pool is the node's tree data: the
    port calls sampler(node_key, 0) where JAX takes that key, and the
    replay takes it without drawing."""
    from morphablegraphs_tpu.models import primitive as prj
    from morphablegraphs_tpu.ops import gmm as gmm_j
    state = {"key": jax.random.PRNGKey(seed)}

    def next_key():
        state["key"], sub = jax.random.split(state["key"])
        return sub

    def sampler(node_key, n, gmm=None):
        if n == 0:
            next_key()
            return np.zeros((0, graph_j.nodes[node_key].primitive.n_latent),
                            np.float32)
        if gmm is None:
            return np.array(prj.sample_latent(
                next_key(), graph_j.nodes[node_key].primitive, n))
        if n > 1:
            next_key()
        return np.array(gmm_j.sample(next_key(), gmm_j.GMM(
            *(jnp.asarray(getattr(gmm, f).cpu().numpy()) for f in (
                "weights", "means", "cov_chol", "prec_chol"))), n))
    return sampler



def rotations_diff(a, b) -> float:
    """The largest difference of frames a, b [..., 3 + 4J], each joint
    quaternion compared up to its sign (q and -q are one rotation)."""
    q_a = a[..., 3:].reshape(a.shape[:-1] + (-1, 4))
    q_b = b[..., 3:].reshape(b.shape[:-1] + (-1, 4))
    diff = np.minimum(np.abs(q_a - q_b).max(-1), np.abs(q_a + q_b).max(-1))
    return max(float(np.abs(a[..., :3] - b[..., :3]).max()),
               float(diff.max()))


# the toy requests of the request-path tests
WALK_INPUT = {
    "startPose": {"position": [0, 0, 0], "orientation": [0, 0, 0]},
    "elementaryActions": [{
        "action": "walk",
        "constraints": [{"joint": "Hips", "trajectoryConstraints": [
            {"position": [0.0, None, 0.0]}, {"position": [5.0, None, 40.0]},
            {"position": [15.0, None, 80.0]},
            {"position": [20.0, None, 120.0]}]}],
    }],
}

KEYFRAME_INPUT = {
    "startPose": {"position": [0, 0, 0], "orientation": [0, 0, 0]},
    "elementaryActions": [{
        "action": "walk",
        "constraints": [{"joint": "Hips", "keyframeConstraints": [{
            "position": [10.0, None, 35.0],
            "semanticAnnotation": {"end": True}}]}],
    }],
}


def request_both(graphs, mg_input, cfg, seed):
    """(JAX result, port result, the port's kernel launches) of one
    request, the port drawing the JAX generator's samples."""
    from morphablegraphs_tpu.synthesis.motion_generator import \
        MotionGenerator as MotionGeneratorJ
    from morphablegraphs_tpu_torch.ops import kernels
    from morphablegraphs_tpu_torch.synthesis.motion_generator import \
        MotionGenerator
    g_j, g_t = graphs
    res_j = MotionGeneratorJ(g_j, cfg, seed=seed).generate_motion(mg_input)
    kernels.reset_launch_counts()
    res_t = MotionGenerator(g_t, cfg, seed=seed, device="cpu",
                            sampler=jax_key_sampler(g_j, seed)
                            ).generate_motion(mg_input)
    return res_j, res_t, kernels.launch_counts()


def assert_request_matches(res_j, res_t, frames=True):
    """The request tests' tolerances (tests/test_torch_motion_generator.py's
    docstring): node keys, counts and frame ranges exactly."""
    assert [s.node_key for s in res_t.steps] == \
        [s.node_key for s in res_j.steps]
    assert res_t.stats["n_steps"] == res_j.stats["n_steps"]
    assert res_t.stats["objective_evaluations"] == \
        res_j.stats["objective_evaluations"]
    for a, b in zip(res_j.steps, res_t.steps):
        np.testing.assert_allclose(b.error, a.error, rtol=2e-3, atol=1e-4)
        np.testing.assert_allclose(b.parameters, a.parameters, atol=5e-3)
        np.testing.assert_allclose(b.arc_length, a.arc_length, atol=2e-2)
        assert (b.start_frame, b.end_frame) == (a.start_frame, a.end_frame)
        assert len(b.user_constraints) == len(a.user_constraints)
        for (bj, bp, bk, bo), (aj, ap, ak, ao) in zip(b.user_constraints,
                                                      a.user_constraints):
            assert (bj, bk, bo is None) == (aj, ak, ao is None)
            np.testing.assert_array_equal(bp, ap)
    np.testing.assert_allclose(res_t.stats["average_error"],
                               res_j.stats["average_error"], rtol=2e-3)
    assert res_t.action_ranges == res_j.action_ranges
    assert res_t.frames.shape == res_j.frames.shape
    assert np.all(np.isfinite(res_t.frames))
    if frames:
        np.testing.assert_allclose(res_t.frames, res_j.frames, rtol=1e-3,
                                   atol=1e-2)


@pytest.fixture(scope="module", autouse=True)
def release_jax_executables():
    """Module fixture (import it into a test module to use it): free every
    XLA executable the process holds when the module ends
    (`jax.clear_caches`; the persistent cache stays).  Every loaded
    executable holds memory mappings and a test worker's modules
    accumulate them; a worker that passes the kernel's limit
    (vm.max_map_count, 65,530 by default) crashes in a later module's
    compile or cache read."""
    yield
    jax.clear_caches()
    gc.collect()


def reference_pickle_tree(rng, n: int = 64, dim: int = 5):
    """A pickled stub of the reference's ClusterTree object graph under the
    reference's module paths (morphablegraphs.space_partitioning.*), made
    without the reference package as tests/test_graph.py makes it: fake
    modules are registered only while pickling.  Two inner nodes whose
    indices are None, each over one KDTreeWrapper leaf that stores raw
    point lists.  -> (payload bytes, data [n, dim] float64)."""
    import pickle
    import sys
    import types

    data = rng.standard_normal((n, dim))
    names = ["morphablegraphs", "morphablegraphs.space_partitioning"] + [
        f"morphablegraphs.space_partitioning.{m}" for m in (
            "cluster_tree", "cluster_tree_node", "kdtree_wrapper_node",
            "kdtree")]
    mods = {name: types.ModuleType(name) for name in names}

    def make_cls(mod_name, cls_name):
        cls = type(cls_name, (object,), {"__module__": mod_name})
        setattr(mods[mod_name], cls_name, cls)
        return cls

    sp = "morphablegraphs.space_partitioning."
    ct_cls = make_cls(sp + "cluster_tree", "ClusterTree")
    ctn_cls = make_cls(sp + "cluster_tree_node", "ClusterTreeNode")
    kdw_cls = make_cls(sp + "kdtree_wrapper_node", "KDTreeWrapper")
    kdt_cls = make_cls(sp + "kdtree", "KDTree")

    def kd_wrapper(indices):
        w = kdw_cls.__new__(kdw_cls)
        t = kdt_cls.__new__(kdt_cls)
        t.data = data[indices].tolist()
        t.root = None
        w.kdtree, w.dim, w.type = t, dim, "kd_tree_wrapper"
        return w

    def ctn(indices, clusters, leaf, depth):
        node = ctn_cls.__new__(ctn_cls)
        node.id, node.clusters, node.leaf = "x", clusters, leaf
        node.mean = data[indices].mean(axis=0)
        node.type = "leaf" if leaf else "inner"
        node.depth = depth
        node.indices = None
        return node

    half = n // 2
    left = ctn(np.arange(half), [kd_wrapper(np.arange(half))], True, 1)
    right = ctn(np.arange(half, n), [kd_wrapper(np.arange(half, n))], True,
                1)
    tree = ct_cls.__new__(ct_cls)
    tree.data = data
    tree.root = ctn(np.arange(n), [left, right], False, 0)
    tree.n_subdivisions, tree.max_level = 2, 2
    sys.modules.update(mods)
    try:
        payload = pickle.dumps(tree, protocol=2)
    finally:
        for k in mods:
            sys.modules.pop(k, None)
    return payload, data


def assert_trees_equal(a, b):
    """Two ClusterTrees (either package's): settings, data and every node's
    mean and indices exactly."""
    assert (a.n_subdivisions, a.max_level) == (b.n_subdivisions,
                                               b.max_level)
    np.testing.assert_array_equal(np.asarray(a.data), np.asarray(b.data))

    def walk(x, y):
        np.testing.assert_array_equal(x.mean, y.mean)
        np.testing.assert_array_equal(x.indices, y.indices)
        assert len(x.children) == len(y.children)
        for cx, cy in zip(x.children, y.children):
            walk(cx, cy)
    walk(a.root, b.root)


def assert_model_json_close(a: dict, b: dict, gmm_keys):
    """Two model JSONs: the same keys and values, float arrays to 1e-4
    relative, the keys in gmm_keys left out (at any depth)."""
    assert a.keys() == b.keys()
    for k in a:
        if k in gmm_keys:
            continue
        x, y = a[k], b[k]
        if isinstance(x, dict):
            assert_model_json_close(x, y, gmm_keys)
        elif isinstance(x, (list, float)) and np.asarray(y).dtype.kind == "f":
            x, y = np.asarray(x), np.asarray(y)
            np.testing.assert_allclose(x, y, rtol=1e-4,
                                       atol=1e-4 * max(np.abs(y).max(), 1e-3),
                                       err_msg=k)
        else:
            assert x == y, k
