"""The port's multi-process code (parallel/mesh, sharded_ba,
sharded_matching, the mesh hooks of MatchGraphBuilder, SLAMGPS,
solve_submaps / hierarchical_ba and `cli sfm`) at 2 and 4 gloo ranks on
the CPU, against the port's single-process functions and the JAX
package's sharded ones on the 8-device CPU mesh (tests/conftest.py).

One group of ranks per world size is spawned for the whole module, and
one process without a group that makes the port's single-process
references (tests/torch_parallel_workers.py, one torch thread each): each
runs every check of its world size on inputs made here from seeded numpy
(and the JAX package's scene builders) and pickles its results; while
they run, this process makes the JAX references.  The
JAX mesh has 8 devices and the port's 2 or 4 ranks, so the sharded sums
run in different orders: the tolerances against JAX are its own test's
(tests/test_parallel.py), those against the port's solve_lm absorb only
the order of summation.
"""
import dataclasses
import multiprocessing
import os
import pickle
import shutil
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from metricsfm_tpu.ba import LMConfig as JLM
from metricsfm_tpu.config import GraphOptions as JGraphOptions
from metricsfm_tpu.models.match_graph import MatchGraphBuilder as JBuilder
from metricsfm_tpu.models.scene import CameraModel as JCam
from metricsfm_tpu.models.scene import Scene as JScene
from metricsfm_tpu.ops import projection as jproj
from metricsfm_tpu.parallel import make_mesh as jmake_mesh
from metricsfm_tpu.parallel import mesh as jmesh
from metricsfm_tpu.parallel.sharded_ba import make_sharded_lm as jsharded_lm
from metricsfm_tpu.parallel import submap_ba as jsub
from metricsfm_tpu.parallel.sharded_matching import \
    match_pairs_sharded as jmatch_sharded
from metricsfm_tpu_torch.models.match_graph import candidates_all
from metricsfm_tpu_torch.ops import matching
from metricsfm_tpu_torch.parallel import mesh as tmesh
from metricsfm_tpu_torch.utils import synth
from tests import torch_parallel_workers as workers
from tests.conftest import make_scene
from tests.test_ba import perturb, scene_to_problem
from tests.test_match_graph import synthetic_features
from tests.test_slam_gps import synth_keyframe_features, synth_street
from tests.torch_threads import torch_threads  # noqa: F401

WORLDS = (2, 4)
GROUPS = (1,) + WORLDS           # 1: the single-process references
SCALE_NOISE_PX = 0.3
SFM_VIEWS = 4
JOIN_TIMEOUT_S = 400.0
GROUP_TIMEOUT_S = 300.0


# ---------------------------------------------------------------- inputs
def _ba_problem(seed, n_cams, n_pts, noise_px):
    """make_scene as a JAX BAProblem (camera 0 and the intrinsics frozen),
    perturbed as tests/test_parallel.py perturbs it."""
    rng = np.random.default_rng(seed)
    sc = make_scene(rng, n_cams=n_cams, n_pts=n_pts, noise_px=noise_px)
    prob = scene_to_problem(sc)
    prob = prob._replace(pose_mut=jnp.ones((n_cams,)).at[0].set(0.0),
                         intr_mut=jnp.zeros_like(prob.intr_mut))
    return perturb(prob, rng, sig_pose=0.01, sig_pt=0.05)


def _with_priors(prob, seed):
    """Nonzero GPS anchors (z down-weighted) and full pose priors around
    the problem's own cameras.  Their weights make the priors' curvature
    resolvable in the f32 cost: at a tenth of them the priors leave a
    valley flatter than the cost's rounding, along which any change of
    summation order (a permutation of the tracks, unsharded) moves the
    poses by ~2e-3."""
    rng = np.random.default_rng(100 + seed)
    C = prob.poses.shape[0]
    centers = np.asarray(jax.vmap(jproj.camera_center)(prob.poses))
    return prob._replace(
        gps_pos=jnp.asarray(centers + 0.05 * rng.normal(size=centers.shape),
                            jnp.float32),
        gps_weight=jnp.asarray(np.tile([20.0, 20.0, 4.0], (C, 1)),
                               jnp.float32),
        pose_prior=prob.poses + 0.01 * jnp.asarray(
            rng.normal(size=prob.poses.shape), jnp.float32),
        pose_prior_weight=jnp.full((C, 6), 5.0, jnp.float32))


def _numpy(prob):
    return {k: np.asarray(v) for k, v in prob._asdict().items()}


def _match_batch():
    """tests/test_parallel.py's 8 pairs of 128 x 128 descriptors."""
    rng = np.random.default_rng(0)
    B, N, D = 8, 128, 128
    d = rng.normal(size=(B, N, D)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    noise = d + 0.02 * rng.normal(size=d.shape).astype(np.float32)
    noise /= np.linalg.norm(noise, axis=-1, keepdims=True)
    mask = np.ones((B, N), bool)
    return d, noise, mask, mask


def _raw(feats):
    return {i: dataclasses.asdict(f) for i, f in feats.items()}


def _inputs(tmp):
    plain = _ba_problem(0, 5, 128, 0.5)
    jax_ba = {"plain": plain, "priors": _with_priors(plain, 0)}
    d1, d2, m1, m2 = _match_batch()
    graph_feats, graph_perms = synthetic_features(
        np.random.default_rng(0), n_imgs=5)
    rng = np.random.default_rng(1)
    gt = make_scene(rng, n_cams=18, n_pts=200, focal=900.0, noise_px=0.2)
    submap = {"gt": gt, "pose_noise": rng.normal(0, 0.01, (18, 6)),
              "pt_noise": rng.normal(0, 0.05, (200, 3)),
              "kp_xy": {i: gt["obs"][i] for i in range(18)}}
    street_rng = np.random.default_rng(0)
    src = os.path.join(tmp, "street_src")
    os.makedirs(src)
    synth_street(src, street_rng)
    street_feats = synth_keyframe_features(street_rng, src)
    for name in ("street_mesh", "street_one"):
        shutil.copytree(src, os.path.join(tmp, name))
    rendered = synth.render_scene(seed=0, n_cams=SFM_VIEWS, width=400,
                                  height=300, focal=400.0)
    for name in ("graph_mesh", "graph_one"):
        os.makedirs(os.path.join(tmp, name))
    for name in ("sfm_mesh", "sfm_one"):
        os.makedirs(os.path.join(tmp, name))
        synth.write_scene_images(os.path.join(tmp, name), rendered)
    inp = {"ba": {k: _numpy(v) for k, v in jax_ba.items()},
           "scale": _numpy(_ba_problem(1, 48, 6144, SCALE_NOISE_PX)),
           "match": {"8": (d1, d2, m1, m2),
                     "7": (d1[:7], d2[:7], m1[:7], m2[:7])},
           "graph_features": _raw(graph_feats),
           "submap": submap, "street_features": _raw(street_feats)}
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    return inp, jax_ba, graph_feats, graph_perms


def _jax_submaps(sub, mesh):
    """JAX's solve_submaps on its mesh, on the JAX Scene of the workers'
    port_scene (the 18-camera scene of tests/test_submap_ba.py)."""
    gt = sub["gt"]
    n_cams, n_pts = gt["poses"].shape[0], gt["points"].shape[0]
    scene = JScene(n_cams, 1_000_000)
    f = float(gt["intrs"][0, 0])
    mi = scene.add_camera_model(JCam(f=f, f_hint=f, calibrated=True))
    for i in range(n_cams):
        scene.register_image(i, gt["poses"][i] + sub["pose_noise"][i], mi,
                             n_pts)
    for p in range(n_pts):
        obs = {i: p for i in range(n_cams) if gt["vis"][i, p]}
        if len(obs) >= 2:
            scene.add_track(gt["points"][p] + sub["pt_noise"][p], obs)
    parts = jsub.partition_images(scene.registered, 8, 2)
    probs, _ = jsub.build_submap_problems(scene, sub["kp_xy"], parts)
    out, info = jsub.solve_submaps(probs, JLM(**workers.SUBMAP_CFG),
                                   mesh=mesh)
    return {"poses": [np.asarray(out.poses)[s][:len(part)]
                      for s, part in enumerate(parts)],
            "final_cost": np.asarray(info["final_cost"]), "parts": parts}


# ---------------------------------------------------------------- groups
def _free_ports(n):
    """n distinct free ports (the sockets are held until all are bound)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("localhost", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _start(world, port, tmp):
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=workers.run,
                         args=(r, world, port, tmp, GROUP_TIMEOUT_S))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def _join(world, procs, tmp, deadline):
    """Every rank's results; a rank that fails or outlives the deadline
    fails the group (its error file is shown)."""
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errs = []
    for r, p in enumerate(procs):
        err = os.path.join(tmp, f"error_{world}_{r}.txt")
        if p.exitcode != 0 or os.path.exists(err):
            text = open(err).read() if os.path.exists(err) else ""
            errs.append(f"rank {r}/{world}: exit code {p.exitcode}\n{text}")
    assert not errs, "\n".join(errs)
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"result_{world}_{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("torch_parallel"))
    inp, jax_ba, graph_feats, graph_perms = _inputs(tmp)
    groups = {w: _start(w, port, tmp)
              for w, port in zip(GROUPS, _free_ports(len(GROUPS)))}
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    jref = {}
    try:
        # the JAX references, while the ranks run (one JAX solver a
        # config: each build compiles)
        mesh8 = jmake_mesh(8)
        for solver, cfg in workers.ba_configs().items():
            jsolve = jsharded_lm(mesh8, JLM(max_iterations=cfg.max_iterations,
                                            cg_iterations=cfg.cg_iterations,
                                            cg_forcing=cfg.cg_forcing))
            for name, jp in jax_ba.items():
                jout, jinfo = jsolve(jmesh.shard_tracks(jp, mesh8))
                jref[f"ba/{name}/{solver}"] = (
                    np.asarray(jout.poses), float(jinfo["final_cost"]))
        res = jmatch_sharded(*inp["match"]["8"], mesh8)
        jref["match/8"] = {k: np.asarray(v) for k, v in res.items()}
        jref["shard_tracks"] = jmesh.shard_tracks(jax_ba["plain"],
                                                  jmake_mesh(4))
        jgraph = JBuilder(JGraphOptions(geoverify_min_inliers=20),
                          batch_pairs=8, mesh=mesh8).build(
            graph_feats, candidates_all(5))
        jref["graph"] = {k: (v.kp_i, v.kp_j) for k, v in jgraph.items()}
        jref["submap"] = _jax_submaps(inp["submap"], mesh8)
    except BaseException:
        for procs in groups.values():
            for p in procs:
                p.kill()
        raise
    results = {w: _join(w, procs, tmp, deadline) for w, procs in
               groups.items()}
    return {"tmp": tmp, "inp": inp,
            "ref": {"jax": jref, "port": results.pop(1)[0]},
            "res": results, "graph_perms": graph_perms}


# ------------------------------------------------------------------ mesh
@pytest.mark.parametrize("n,p", [(103, 4), (8, 3), (0, 2), (5, 1)])
def test_owned_range_matches_jax(n, p):
    for k in range(p):
        assert tmesh.owned_range(n, k, p) == jmesh.owned_range(n, k, p)
    assert tmesh.owned_range(n) == (0, n)      # no group: one process


@pytest.mark.parametrize("shape,multiple,axis", [
    ((7, 3), 4, 0), ((8, 3), 4, 0), ((5, 6, 2), 4, 1), ((0, 2), 3, 0)])
def test_pad_to_multiple_matches_jax(shape, multiple, axis):
    x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape) + 1
    got = tmesh.pad_to_multiple(x, multiple, axis, value=-1)
    np.testing.assert_array_equal(
        got, jmesh.pad_to_multiple(x, multiple, axis, value=-1))


def test_initialize_distributed_without_launcher_is_a_noop(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert tmesh.initialize_distributed() == 0
    assert not dist.is_initialized()
    mesh = tmesh.make_global_mesh(device="cpu")
    assert mesh.size == 1 and mesh.group is None
    assert mesh.shape == {"data": 1} and mesh.axis_names == ("data",)
    t = torch.arange(6.0).reshape(3, 2)
    assert mesh.psum(t) is t and mesh.all_gather_rows(t) is t
    with pytest.raises(ValueError):
        tmesh.make_mesh(2, device="cpu")


def test_initialize_distributed_refuses_cuda_without_a_card(monkeypatch):
    """Under a launcher environment the group's device defaults to the
    card: without one it raises before any group starts (the CPU only when
    the caller passes it)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_PORT", str(_free_ports(1)[0]))
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.initialize_distributed(device=device)
    assert not dist.is_initialized()


def test_ranks_run_gloo_on_the_cpu(runs):
    for w in WORLDS:
        for r in runs["res"][w]:
            assert (r["backend"], r["size"], r["device"]) == ("gloo", w,
                                                              "cpu")


def test_shard_tracks_blocks_match_jax_shards(runs):
    """Rank k's block of every field equals the shard that JAX's
    shard_tracks places on device k of a 4-device mesh."""
    jp = runs["ref"]["jax"]["shard_tracks"]
    devs = list(jmake_mesh(4).devices.flat)
    for k, res in enumerate(runs["res"][4]):
        for field, got in res["shard_tracks"].items():
            arr = getattr(jp, field)
            shard = [s for s in arr.addressable_shards
                     if s.device == devs[k]][0]
            np.testing.assert_array_equal(got, np.asarray(shard.data),
                                          err_msg=field)


def test_shard_tracks_refuses_an_indivisible_track_count(runs):
    for res in runs["res"][4]:
        assert res["shard_tracks_odd"] == \
            "track count 127 not divisible by mesh axis 4"


# ------------------------------------------------------------- sharded LM
BA_CASES = [(w, n, s) for w in WORLDS for n in ("plain", "priors")
            for s in ("dense", "pcg")]


@pytest.mark.parametrize("world,name,solver", BA_CASES)
def test_sharded_lm_matches_solve_lm(runs, world, name, solver):
    """The same iterations, the final cost within 1e-4 relative and the
    poses within 1e-4 of the port's single-process solve_lm; the poses
    bit-equal on every rank."""
    key = f"ba/{name}/{solver}"
    poses, info = (runs["ref"]["port"][key][k] for k in ("poses", "info"))
    ranks = [r[key] for r in runs["res"][world]]
    got = ranks[0]
    assert got["info"]["iterations"] == info["iterations"]
    assert got["info"]["final_cost"] < 0.05 * got["info"]["initial_cost"]
    assert abs(got["info"]["final_cost"] - info["final_cost"]) \
        <= 1e-4 * info["final_cost"]
    np.testing.assert_allclose(got["poses"], poses, atol=1e-4)
    for other in ranks[1:]:
        assert np.array_equal(other["poses"], got["poses"])
        assert np.array_equal(other["points"], got["points"])
        assert other["info"] == got["info"]


@pytest.mark.parametrize("world,name,solver", BA_CASES)
def test_sharded_lm_matches_jax(runs, world, name, solver):
    """Against JAX's solve_lm_sharded on the 8-device mesh, at least as
    tight as its own test (cost within 5 %, poses within 1e-2)."""
    key = f"ba/{name}/{solver}"
    jposes, jcost = runs["ref"]["jax"][key]
    got = runs["res"][world][0][key]
    cost = got["info"]["final_cost"]
    gap = abs(cost - jcost) / jcost
    pose_gap = float(np.abs(got["poses"] - jposes).max())
    print(f"{key} at {world} ranks: cost {cost:.6e} vs JAX {jcost:.6e} "
          f"(relative {gap:.2e}), poses {pose_gap:.2e}")
    assert gap < 0.05
    assert pose_gap < 1e-2


def test_sharded_lm_at_scale(runs):
    """tests/test_ba_scale.py's 48 cameras x 6,144 points (a 432-dof
    reduced system, 1,536 tracks a rank) through PCG at 4 ranks against
    solve_lm, with 0.3 px of noise so that the final cost is no f32 floor:
    cost within 1e-4 relative, poses within 1e-4, the residual at the
    noise."""
    poses, info = (runs["ref"]["port"]["scale"][k] for k in ("poses",
                                                             "info"))
    got = runs["res"][4][0]["scale"]
    assert got["info"]["iterations"] == info["iterations"]
    assert abs(got["info"]["final_cost"] - info["final_cost"]) \
        <= 1e-4 * info["final_cost"]
    np.testing.assert_allclose(got["poses"], poses, atol=1e-4)
    assert got["info"]["rms_px"] < 1.5 * SCALE_NOISE_PX * np.sqrt(2)


# ------------------------------------------------------------ the matcher
@pytest.mark.parametrize("world,name", [(2, "8"), (4, "8"), (4, "7")])
def test_sharded_matcher_equals_match_pair(runs, world, name):
    """idx2, good and all of every pair equal the per-pair match_pair (B =
    7 at 4 ranks pads one masked pair)."""
    d1, d2, m1, m2 = runs["inp"]["match"][name]
    got = runs["res"][world][0][f"match/{name}"]
    assert got["idx2"].shape == (len(d1), d1.shape[1])
    for b in range(len(d1)):
        want = matching.match_pair(*(torch.from_numpy(a[b])
                                     for a in (d1, d2, m1, m2)))
        for k in ("idx2", "good", "all"):
            assert np.array_equal(got[k][b], want[k].numpy()), (b, k)
    for other in runs["res"][world][1:]:
        for k, v in other[f"match/{name}"].items():
            assert np.array_equal(v, got[k])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_matcher_agrees_with_jax(runs, world):
    """Index agreement with JAX's match_pairs_sharded above 0.999 (bf16
    products summed in different orders: divergence 3c)."""
    got = runs["res"][world][0]["match/8"]
    want = runs["ref"]["jax"]["match/8"]
    assert (got["idx2"] == want["idx2"]).mean() > 0.999
    for b in range(8):      # tests/test_parallel.py's identity check
        g = got["good"][b]
        assert g.sum() > 128 * 0.7
        assert (got["idx2"][b][g] == np.arange(128)[g]).mean() > 0.99


# --------------------------------------------------------- the match graph
def _same_file(a, b):
    """Two store files hold the same data (.npz archives array by array:
    their zip headers carry the write time)."""
    if a.endswith(".npz"):
        with np.load(a) as za, np.load(b) as zb:
            return sorted(za.files) == sorted(zb.files) and all(
                np.array_equal(za[k], zb[k]) for k in za.files)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def _pairs_of(graph):
    return {k: set(zip(np.asarray(a).tolist(), np.asarray(b).tolist()))
            for k, (a, b) in graph.items()}


def test_sharded_match_graph_equals_unsharded(runs):
    """At 4 ranks and batch_pairs 8 the same pairs and the same matches as
    the port's unsharded builder at batch_pairs 8, on every rank."""
    want = _pairs_of(runs["ref"]["port"]["graph"])
    assert len(want) >= 8
    for res in runs["res"][4]:
        assert _pairs_of(res["graph"]) == want


def test_sharded_match_graph_agrees_with_jax(runs):
    """Against JAX's sharded builder: the same pairs, each with an overlap
    of at least 0.95 (JAX's own bar; the RANSAC draws differ)."""
    got = _pairs_of(runs["res"][4][0]["graph"])
    want = _pairs_of(runs["ref"]["jax"]["graph"])
    assert set(got) == set(want)
    for k in got:
        assert len(got[k] & want[k]) >= 0.95 * max(len(got[k]), len(want[k]))


def test_sharded_match_graph_writes_the_unsharded_shards(runs):
    """The match shards that rank 0 writes equal the unsharded run's, file
    for file."""
    a = os.path.join(runs["tmp"], "graph_mesh")
    b = os.path.join(runs["tmp"], "graph_one")
    names = sorted(os.listdir(b))
    assert names and sorted(os.listdir(a)) == names
    assert any(n.endswith("_match.npz") for n in names)
    for n in names:
        assert _same_file(os.path.join(a, n), os.path.join(b, n)), n


# --------------------------------------------------------------- submaps
def test_solve_submaps_on_mesh_equals_unsharded(runs):
    """tests/test_submap_ba.py's 18-camera scene at 2 ranks: every submap
    equals its unsharded solve (cost within 1e-5 relative), and every rank
    holds every submap."""
    want = runs["ref"]["port"]["submap"]
    ranks = [r["submap"] for r in runs["res"][2]]
    got = ranks[0]
    assert len(want["parts"]) >= 3
    np.testing.assert_allclose(got["info"]["final_cost"],
                               want["info"]["final_cost"], rtol=1e-5)
    assert list(got["info"]["iterations"]) == \
        list(want["info"]["iterations"])
    assert (got["info"]["final_cost"] < got["info"]["initial_cost"]).all()
    for s, poses in enumerate(want["poses"]):
        np.testing.assert_allclose(got["poses"][s], poses, atol=1e-6)
    for other in ranks[1:]:
        for s in range(len(want["poses"])):
            assert np.array_equal(other["poses"][s], got["poses"][s])


def test_solve_submaps_on_mesh_matches_jax(runs):
    """The 2-rank solve_submaps against JAX's solve_submaps on the 8-device
    mesh, on the same submaps: each final cost within 1e-4 relative and
    its poses within 2e-3, the bars of
    tests/test_torch_submap_ba.py::test_solve_submaps_matches_jax (the
    soft gauge leaves a valley along which the two packages' f32 steps
    part at one cost)."""
    want = runs["ref"]["jax"]["submap"]
    got = runs["res"][2][0]["submap"]
    assert got["parts"] == want["parts"]
    gap = np.abs(got["info"]["final_cost"] / want["final_cost"] - 1).max()
    pose_gap = max(float(np.abs(g - w).max())
                   for g, w in zip(got["poses"], want["poses"]))
    print(f"solve_submaps at 2 ranks vs JAX on 8 devices: cost {gap:.2e}, "
          f"poses {pose_gap:.2e}")
    np.testing.assert_allclose(got["info"]["final_cost"], want["final_cost"],
                               rtol=1e-4)
    for g, w in zip(got["poses"], want["poses"]):
        np.testing.assert_allclose(g, w, atol=2e-3)


def test_hierarchical_ba_on_mesh_equals_unsharded(runs):
    want = runs["ref"]["port"]["hier"]
    for res in runs["res"][2]:
        got = res["hier"]
        assert got["registered"] == want["registered"]
        for i in want["registered"]:
            np.testing.assert_allclose(got["poses"][i], want["poses"][i],
                                       atol=1e-6)


# ------------------------------------------------------------------ SLAM
def test_slam_rematch_on_mesh_equals_one_rank(runs):
    """SLAMGPS(mesh=).run(rematch=True) at 2 ranks: the same verified pairs
    and matches, and the same tracks, as the one-process run, on every
    rank."""
    want = runs["ref"]["port"]["slam"]
    assert want["stats"]["verified_pairs"] > 0
    for res in runs["res"][2]:
        got = res["slam"]
        assert got["stats"] == want["stats"]
        assert set(got["matches"]) == set(want["matches"])
        for k, (ki, kj) in want["matches"].items():
            assert np.array_equal(got["matches"][k][0], ki)
            assert np.array_equal(got["matches"][k][1], kj)
        gt, wt = got["scene"]["tracks"], want["scene"]["tracks"]
        assert len(gt) == len(wt)
        for (o1, x1, b1), (o2, x2, b2) in zip(gt, wt):
            assert o1 == o2 and b1 == b2
            np.testing.assert_allclose(x1, x2, atol=1e-5)
    # rank 0 alone wrote the exports
    out = os.path.join(runs["tmp"], "street_mesh", "mtpu_out")
    assert os.path.exists(os.path.join(out, "pose.qin"))


# ------------------------------------------------------------------- cli
def test_cli_sfm_at_two_ranks(runs):
    """`cli sfm` under the launcher environment at 2 ranks: rank 0
    registers the single-process run's set, the other rank returns no
    scene, and the outputs are the single-process run's files, written
    once."""
    want = runs["ref"]["port"]["cli"]
    r0, r1 = (r["cli"] for r in runs["res"][2])
    assert r1 == []
    assert [s["registered"] for s in r0] == [s["registered"] for s in want]
    assert len(want[0]["registered"]) == SFM_VIEWS
    a = os.path.join(runs["tmp"], "sfm_mesh", "mtpu_db")
    b = os.path.join(runs["tmp"], "sfm_one", "mtpu_db")

    def listing(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)
    assert listing(a) == listing(b)
    shards = [n for n in os.listdir(b) if n.endswith("_match.npz")]
    assert shards
    for n in shards:
        assert _same_file(os.path.join(a, n), os.path.join(b, n)), n
