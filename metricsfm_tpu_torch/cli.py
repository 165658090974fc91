"""Command-line entry point of the PyTorch port.

  python -m metricsfm_tpu_torch.cli sfm <image_fold> [--mode web|uav]
      [--out DIR] [--max-kp N] [--no-resize]
      [--matching all|priori|feature] [--debug-matches] [--device cuda|cpu]
  python -m metricsfm_tpu_torch.cli slam <fold> [--device cuda|cpu]
      (KeyFramePts.txt / pos.txt / rgb.txt, optional image/ keyframes)
  python -m metricsfm_tpu_torch.cli dense <fold> [--pose-file F]
      [--disp 128] [--method sgm|elas] [--device cuda|cpu]
  python -m metricsfm_tpu_torch.cli calib <video> <out_fold> [--frame-step N]
      [--device cuda|cpu]

Counterparts of `metricsfm_tpu.cli sfm` (the reference's test_sfm.cc
program), `metricsfm_tpu.cli slam` (GPS-aided SLAM refinement of a street
sequence, the reference's test_slam program; writes <fold>/mtpu_out and
<fold>/accuracy.txt) and `metricsfm_tpu.cli dense` (pairwise stereo over
the consecutive views of a SURE pose file, e.g. the `sfm_sure.txt` that
`sfm` writes) and `metricsfm_tpu.cli calib` (video frames decoded with
cv2, then `sfm` in web mode on them, the reference's test_calib program).
`--method sgm` runs on a card through the CUDA kernels of ops/sgm_kernel,
with --device cpu through their plain versions; `--method elas` is plain
torch on either device (the reference has no kernel for it).

`sfm` also runs under torchrun, one process per card:

  torchrun --nproc_per_node=N -m metricsfm_tpu_torch.cli sfm <image_fold>

Rank 0 extracts the features while the others wait; every rank verifies
its share of each batch of candidate pairs (parallel/mesh, NCCL with a
card per rank, gloo on the CPU); rank 0 alone reconstructs and writes.
`slam` and `dense` stay single-process; `calib` ends in `sfm`.
"""
from __future__ import annotations

import argparse
import os
import sys


def _device(name: str):
    from .utils.device import resolve
    return resolve(name, "--device")


def cmd_sfm(args):
    """Images -> features -> match graph -> incremental SfM -> exports.
    Returns the reconstructed scenes (on ranks other than 0 of a
    multi-process run, which reconstruct nothing: an empty list)."""
    import torch.distributed as dist

    from .parallel.mesh import initialize_distributed

    device = _device(args.device)
    started = not dist.is_initialized()
    rank = initialize_distributed(device=device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    try:
        return _sfm(args, device, rank, world)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _sfm(args, device, rank: int, world: int):
    import dataclasses

    import torch.distributed as dist

    from .config import PRESETS
    from .io import exports
    from .models.database import Database
    from .models.incremental import IncrementalSfM
    from .models.match_graph import build_match_graph
    from .utils.tracing import GLOBAL_TRACER, span

    cfg = PRESETS[args.mode]()
    # optional overrides (small test scenes / CPU runs); `calib` passes
    # none of them
    if getattr(args, "max_kp", 0):
        cfg = dataclasses.replace(cfg, database=dataclasses.replace(
            cfg.database, max_keypoints=args.max_kp))
    if getattr(args, "no_resize", False):
        cfg = dataclasses.replace(cfg, database=dataclasses.replace(
            cfg.database, resize=False))
    if getattr(args, "matching", None):
        cfg = dataclasses.replace(cfg, graph=dataclasses.replace(
            cfg.graph, matching_type=args.matching))
    db = Database(args.fold, cfg.database, output_fold=args.out,
                  device=device)
    print(f"{db.n_images} images on {device}")
    with span("sfm/feature_extraction", sync=True):
        if rank == 0:
            db.feature_extraction(verbose=True)
        if world > 1:
            dist.barrier()
    with span("sfm/match_graph", sync=True):
        matches = build_match_graph(
            db, cfg, verbose=True,
            debug_render_dir=(os.path.join(db.out, "match_renders")
                              if getattr(args, "debug_matches", False)
                              else None))
    if rank != 0:
        return []
    feats = {i: db.features(i) for i in range(db.n_images)}
    with span("sfm/reconstruct", sync=True):
        sfm = IncrementalSfM(feats, matches, cfg, device=device)
        scenes = sfm.run(verbose=True)
    for k, scene in enumerate(scenes):
        fold = os.path.join(db.out, f"model_{k}")
        os.makedirs(fold, exist_ok=True)
        kp_xy = {i: feats[i].xy for i in scene.registered}
        with span("sfm/exports"):
            exports.write_cams_points(fold, scene)
            exports.write_point_cloud(os.path.join(fold, "cloud.txt"), scene)
            exports.write_bundler(os.path.join(fold, "bundle.rd.out"), scene,
                                  kp_xy)
            exports.write_cmvs(os.path.join(fold, "cmvs"), scene, kp_xy)
            names = {i: os.path.basename(db.image_paths[i])
                     for i in scene.registered}
            principal = {i: (feats[i].width / 2.0, feats[i].height / 2.0)
                         for i in scene.registered}
            sizes = {i: (feats[i].width, feats[i].height)
                     for i in scene.registered}
            exports.write_openmvs(os.path.join(fold, "sfm_openmvs.txt"),
                                  scene, kp_xy, names, principal, sizes)
            exports.write_sure(os.path.join(fold, "sfm_sure.txt"), scene,
                               names, principal, sizes)
            exports.write_undistorted_images(
                os.path.join(fold, "undistort_images"), scene,
                {i: db.image_paths[i] for i in scene.registered},
                device=device)
        print(f"model {k}: {len(scene.registered)} cams, "
              f"{scene.n_points()} points -> {fold}")
    print("-- stage times --")
    print(GLOBAL_TRACER.report())
    return scenes


def cmd_slam(args):
    """KeyFramePts.txt + pos.txt + rgb.txt -> GPS-aligned, GPS-anchored BA
    -> exports, with the street preset.  Returns the scene."""
    from .config import street_preset
    from .models.slam_gps import SLAMGPS
    from .utils.tracing import GLOBAL_TRACER, span

    pipe = SLAMGPS(street_preset(), device=_device(args.device))
    with span("slam/run", sync=True):
        scene = pipe.run(args.fold, verbose=True)
    print(f"{len(scene.registered)} cams, {scene.n_points()} points")
    print("-- stage times --")
    print(GLOBAL_TRACER.report())
    return scene


def cmd_dense(args):
    """Pose file + images -> rectified pairs -> SGM or ELAS -> depth maps
    and a cloud in <fold>/dense.  Returns the per-pair point clouds."""
    from .config import DenseOptions
    from .models.dense import DenseReconstruction
    from .utils.tracing import GLOBAL_TRACER, span

    device = _device(args.device)
    dr = DenseReconstruction(DenseOptions(disp_size=args.disp,
                                          method=args.method), device=device)
    with span("dense/run", sync=True):
        clouds = dr.run(args.fold, pose_file=args.pose_file, verbose=True)
    print("-- stage times --")
    print(GLOBAL_TRACER.report())
    return clouds


def cmd_calib(args):
    """Video -> frames + self-calibrating SfM run (ref test_calib.cc:31-140):
    every `frame_step`-th frame is written as <out>/NNNNNN.jpg, then `sfm`
    runs in web mode on that folder.  Returns the scenes."""
    _device(args.device)        # refuse a missing card before decoding
    os.makedirs(args.out, exist_ok=True)
    try:
        import cv2
    except ImportError:
        sys.exit("calib requires cv2 for video decoding")
    cap = cv2.VideoCapture(args.video)
    i = saved = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if i % args.frame_step == 0:
            cv2.imwrite(os.path.join(args.out, f"{saved:06d}.jpg"), frame)
            saved += 1
        i += 1
    cap.release()
    print(f"extracted {saved} frames")
    args.fold = args.out
    args.mode = "web"
    args.out = None
    return cmd_sfm(args)


def main(argv=None):
    p = argparse.ArgumentParser(prog="metricsfm_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("sfm", help="incremental SfM on an image folder")
    ps.add_argument("fold")
    ps.add_argument("--mode", choices=["web", "uav"], default="web")
    ps.add_argument("--out", default=None)
    ps.add_argument("--max-kp", type=int, default=0,
                    help="override keypoint budget per image")
    ps.add_argument("--no-resize", action="store_true",
                    help="skip resize to the working resolution")
    ps.add_argument("--matching", choices=["all", "priori", "feature"],
                    default=None, help="override candidate strategy")
    ps.add_argument("--debug-matches", action="store_true",
                    help="write per-pair match renders to <out>/"
                    "match_renders (ref fine_matching_graph.cc:156-180 "
                    "debug blocks)")
    ps.add_argument("--device", default="cuda",
                    help="torch device: cuda (default; raises without a "
                    "card) or cpu")
    ps.set_defaults(fn=cmd_sfm)

    pl = sub.add_parser("slam", help="GPS-aided SLAM refinement")
    pl.add_argument("fold")
    pl.add_argument("--device", default="cuda",
                    help="torch device: cuda (default; raises without a "
                    "card) or cpu")
    pl.set_defaults(fn=cmd_slam)

    pd = sub.add_parser("dense", help="dense pairwise stereo")
    pd.add_argument("fold")
    pd.add_argument("--pose-file", default=None)
    pd.add_argument("--disp", type=int, default=128)
    pd.add_argument("--method", choices=["sgm", "elas"], default="sgm",
                    help="stereo method: sgm (CUDA kernels on a card) or "
                    "elas (ROBOTICS preset)")
    pd.add_argument("--device", default="cuda",
                    help="torch device: cuda (default; raises without a "
                    "card) or cpu")
    pd.set_defaults(fn=cmd_dense)

    pc = sub.add_parser("calib", help="video -> frames -> self-calibrating SfM")
    pc.add_argument("video")
    pc.add_argument("out")
    pc.add_argument("--frame-step", type=int, default=10)
    pc.add_argument("--device", default="cuda",
                    help="torch device: cuda (default; raises without a "
                    "card) or cpu")
    pc.set_defaults(fn=cmd_calib)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
