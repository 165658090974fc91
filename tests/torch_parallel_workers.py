"""The processes of tests/test_torch_parallel.py: the ranks of a gloo group
on the CPU, one process each, and one process with no group that makes the
port's single-process references.  Imports no JAX (the port's
multi-process path runs without it): the test process makes the inputs,
with the JAX package where it needs to, and pickles them as numpy arrays;
each process runs every check of its world size (1: the references) with
one torch thread, so that the replicated parts of a rank's run do the
single-process run's arithmetic in its order, and pickles its results for
the test cases to read.
"""
import os
import pickle
import time
import traceback

import numpy as np


def _features(raw):
    from metricsfm_tpu_torch.models.incremental import ImageFeatures
    return {i: ImageFeatures(**f) for i, f in raw.items()}


def port_scene(gt, pose_noise, pt_noise):
    """The port Scene of tests/test_torch_submap_ba._noisy_scenes: the
    make_scene ground truth moved by the given noise."""
    from metricsfm_tpu_torch.models.scene import CameraModel, Scene
    n_cams, n_pts = gt["poses"].shape[0], gt["points"].shape[0]
    scene = Scene(n_cams, 1_000_000)
    f = float(gt["intrs"][0, 0])
    mi = scene.add_camera_model(CameraModel(f=f, f_hint=f, calibrated=True))
    for i in range(n_cams):
        scene.register_image(i, gt["poses"][i] + pose_noise[i], mi, n_pts)
    for p in range(n_pts):
        obs = {i: p for i in range(n_cams) if gt["vis"][i, p]}
        if len(obs) >= 2:
            scene.add_track(gt["points"][p] + pt_noise[p], obs)
    return scene


def ba_configs():
    """The LM configurations of the 5-camera problems.  The PCG one solves
    every step to cg_tol: with the forcing sequence's loose early solves
    the 40-iteration trajectory of this small problem is sensitive enough
    that any change of summation order (the rank count, or a permutation
    of the tracks) moves its poses by up to ~2e-4."""
    from metricsfm_tpu_torch.ba.lm import LMConfig
    return {"dense": LMConfig(max_iterations=40),
            "pcg": LMConfig(max_iterations=40, cg_iterations=50,
                            cg_forcing=False)}


def scale_config():
    from metricsfm_tpu_torch.ba.lm import LMConfig
    return LMConfig(max_iterations=6, cg_iterations=50)


SUBMAP_CFG = dict(max_iterations=15)


def recording(pipe, name, rec):
    """Record what `pipe.name` returns."""
    fn = getattr(pipe, name)

    def wrapped(*a, **k):
        rec[name] = fn(*a, **k)
        return rec[name]
    setattr(pipe, name, wrapped)


def scene_record(scene):
    """A pipeline scene's registered set, poses and tracks, as numpy."""
    return {"registered": list(scene.registered),
            "poses": {i: np.asarray(scene.poses[i]) for i in
                      scene.registered},
            "tracks": [(dict(t.obs), np.asarray(t.xyz), bool(t.is_bad))
                       for t in scene.tracks]}


def _ba(mesh, inp, out):
    from metricsfm_tpu_torch.ba import problem as bp
    from metricsfm_tpu_torch.parallel.sharded_ba import solve_lm_sharded
    for name, arrays in inp["ba"].items():
        prob = bp.from_numpy(arrays, device="cpu")
        for solver, cfg in ba_configs().items():
            solved, info = solve_lm_sharded(prob, mesh, cfg)
            out[f"ba/{name}/{solver}"] = {
                "poses": solved.poses.numpy(),
                "points": solved.points.numpy(), "info": info}


def _matcher(mesh, inp, out):
    from metricsfm_tpu_torch.parallel.sharded_matching import \
        match_pairs_sharded
    for name, (d1, d2, m1, m2) in inp["match"].items():
        res = match_pairs_sharded(d1, d2, m1, m2, mesh)
        out[f"match/{name}"] = {k: v.numpy() for k, v in res.items()}


def _graph(feats, fold, mesh=None):
    from metricsfm_tpu_torch.config import GraphOptions
    from metricsfm_tpu_torch.models.match_graph import (MatchGraphBuilder,
                                                        candidates_all)
    graph = MatchGraphBuilder(GraphOptions(geoverify_min_inliers=20),
                              out_fold=fold, batch_pairs=8, device="cpu",
                              mesh=mesh).build(feats, candidates_all(5))
    return {k: (v.kp_i, v.kp_j) for k, v in graph.items()}


def _submaps(inp, mesh=None):
    """solve_submaps and hierarchical_ba on tests/test_submap_ba.py's
    18-camera scene (windows of 8, overlap 2)."""
    from metricsfm_tpu_torch.ba.lm import LMConfig
    from metricsfm_tpu_torch.parallel import submap_ba
    sub = inp["submap"]
    scene = port_scene(sub["gt"], sub["pose_noise"], sub["pt_noise"])
    parts = submap_ba.partition_images(scene.registered, 8, 2)
    probs, _ = submap_ba.build_submap_problems(scene, sub["kp_xy"], parts,
                                               device="cpu")
    solved, info = submap_ba.solve_submaps(probs, LMConfig(**SUBMAP_CFG),
                                           mesh=mesh)
    out = {"poses": [p.poses.numpy() for p in solved],
           "points": [p.points.numpy() for p in solved],
           "info": info, "parts": parts}
    submap_ba.hierarchical_ba(scene, sub["kp_xy"], max_cams=8, overlap=2,
                              cfg=LMConfig(**SUBMAP_CFG), mesh=mesh,
                              device="cpu")
    return out, scene_record(scene)


def _slam(inp, fold, mesh=None):
    from metricsfm_tpu_torch.config import street_preset
    from metricsfm_tpu_torch.models import slam_gps
    pipe = slam_gps.SLAMGPS(street_preset(), device="cpu", mesh=mesh)
    rec = {}
    recording(pipe, "feature_matching", rec)
    sc = pipe.run(fold, features=_features(inp["street_features"]),
                  rematch=True)
    return {"matches": rec["feature_matching"], "stats": dict(pipe.stats),
            "scene": scene_record(sc)}


def _cli_sfm(fold):
    from metricsfm_tpu_torch import cli
    scenes = cli.main(["sfm", fold, "--mode", "web", "--matching", "all",
                       "--no-resize", "--max-kp", "1024", "--device", "cpu"])
    return [scene_record(s) for s in scenes]


def checks_1(inp, tmp, out):
    """No group: the port's single-process references of every check."""
    from metricsfm_tpu_torch.ba import problem as bp
    from metricsfm_tpu_torch.ba.lm import solve_lm
    for name, arrays in inp["ba"].items():
        prob = bp.from_numpy(arrays, device="cpu")
        for solver, cfg in ba_configs().items():
            solved, info = solve_lm(prob, cfg)
            out[f"ba/{name}/{solver}"] = {"poses": solved.poses.numpy(),
                                          "info": info}
    solved, info = solve_lm(bp.from_numpy(inp["scale"], device="cpu"),
                            scale_config())
    out["scale"] = {"poses": solved.poses.numpy(), "info": info}
    out["graph"] = _graph(_features(inp["graph_features"]),
                          os.path.join(tmp, "graph_one"))
    out["submap"], out["hier"] = _submaps(inp)
    out["slam"] = _slam(inp, os.path.join(tmp, "street_one"))
    out["cli"] = _cli_sfm(os.path.join(tmp, "sfm_one"))


def checks_2(mesh, inp, tmp, out):
    """World size 2: sharded LM, the matcher, submaps, SLAM, cli sfm."""
    _ba(mesh, inp, out)
    _matcher(mesh, inp, out)
    out["submap"], out["hier"] = _submaps(inp, mesh)
    out["slam"] = _slam(inp, os.path.join(tmp, "street_mesh"), mesh)
    out["cli"] = _cli_sfm(os.path.join(tmp, "sfm_mesh"))


def checks_4(mesh, inp, tmp, out):
    """World size 4: shard_tracks, sharded LM (and at scale), the matcher
    with padding, the sharded match graph."""
    from metricsfm_tpu_torch.ba import problem as bp
    from metricsfm_tpu_torch.parallel.mesh import shard_tracks
    from metricsfm_tpu_torch.parallel.sharded_ba import solve_lm_sharded

    prob = bp.from_numpy(inp["ba"]["plain"], device="cpu")
    out["shard_tracks"] = bp.to_numpy(shard_tracks(prob, mesh))
    odd = bp.from_numpy({k: v[:-1] if k in ("points", "track_cam",
                                             "track_uv", "track_mask",
                                             "track_weight", "point_mut")
                         else v for k, v in inp["ba"]["plain"].items()},
                        device="cpu")
    try:
        shard_tracks(odd, mesh)
        out["shard_tracks_odd"] = None
    except AssertionError as e:
        out["shard_tracks_odd"] = str(e)

    _ba(mesh, inp, out)
    t0 = time.perf_counter()
    big = bp.from_numpy(inp["scale"], device="cpu")
    solved, info = solve_lm_sharded(big, mesh, scale_config())
    out["scale"] = {"poses": solved.poses.numpy(), "info": info,
                    "seconds": time.perf_counter() - t0}
    _matcher(mesh, inp, out)

    out["graph"] = _graph(_features(inp["graph_features"]),
                          os.path.join(tmp, "graph_mesh"), mesh)


def run(rank, world, port, tmp, timeout_s):
    """One process: at world > 1 a rank, which brings up the gloo group
    through the launcher environment; at world 1 the references, with no
    group.  Runs the checks of `world` and writes result_{world}_{rank}.pkl
    (or error_{world}_{rank}.txt, then raises)."""
    import torch
    torch.set_num_threads(1)
    if world > 1:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                          MASTER_ADDR="localhost", MASTER_PORT=str(port))
    import torch.distributed as dist
    from metricsfm_tpu_torch.parallel import mesh as pm
    try:
        t0 = time.perf_counter()
        with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
            inp = pickle.load(f)
        if world == 1:
            out = {}
            checks_1(inp, tmp, out)
        else:
            pm.initialize_distributed(device="cpu", timeout_s=timeout_s)
            mesh = pm.make_global_mesh()
            out = {"backend": mesh.backend, "size": mesh.size,
                   "device": str(mesh.device)}
            (checks_2 if world == 2 else checks_4)(mesh, inp, tmp, out)
        out["seconds"] = time.perf_counter() - t0
        with open(os.path.join(tmp, f"result_{world}_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(tmp, f"error_{world}_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
