"""Bundle-adjustment solves of one generated UAV survey, back to back.

The mix's ``problems`` says which solves the survey's user waits for:
``full``, the periodic full BA of the whole survey, or ``partial``, the
local BAs around a fixed set of ``around_views`` (cut from the survey by
the partial rule of ``IncrementalSfM._bundle``: the around-view and the
views covisible with it are free, every track any of them observes is in
the problem, and its other observers are frozen anchors; tracks of three
views or more weigh ``weight_multiview``).  The LM settings follow
``_bundle``'s for that solve at the configuration's settings.

Set-up generates the survey on the card and builds every problem once,
padded as ``Scene.to_ba_problem`` pads them.  In the window each solve
starts from a fresh seeded perturbation of the ground truth, drawn on the
card; the problems are taken in a seeded order.  The check runs the plain
reference LM (``reference/ba_lm.py``) in float64 from the same start to
its optimum, for ``check_solves`` solves drawn from the seed.
"""
from __future__ import annotations

import math
import time

import torch

from ..gen import survey as survey_gen
from ..reference import ba_lm

# the reference's own optimum: run until the cost stops moving
REF_OPTIMUM = {"max_iterations": 40, "rtol": 1e-12, "init_lambda": 1e-6}


def bucket(n: int, minimum: int) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def lm_settings(settings: dict, full: bool, n_images: int) -> dict:
    """The LMConfig fields ``IncrementalSfM._bundle`` passes for a
    periodic full BA (`full`) or a partial BA over n_images cameras."""
    ba, sfm = settings["ba"], settings["sfm"]
    use_cg = ba["cg_iterations"] != 0 and n_images >= sfm["th_cg_cameras"]
    cg = (ba["cg_iterations"] if ba["cg_iterations"] > 0
          else ba["cg_auto_iterations"]) if use_cg else 0
    return {"max_iterations": sfm["th_step_full_ba_iterations"] if full
            else sfm["partial_ba_iterations"],
            "huber_delta": ba["huber_delta"],
            "init_lambda": ba["init_lambda"],
            "rtol": max(ba["rtol"], sfm["intermediate_ba_rtol"]),
            "cg_iterations": cg, "cg_tol": ba["cg_tol"],
            "cg_forcing": ba["cg_forcing"]}


class Problem:
    """One BA problem: its cameras (survey ids), tracks and free set."""

    def __init__(self, sv, cams, tracks, free_cams, weight_multiview, full,
                 settings):
        dev = sv["points"].device
        remap = torch.full((sv["poses"].shape[0],), -1, dtype=torch.int64,
                           device=dev)
        remap[cams] = torch.arange(cams.numel(), device=dev)
        self.mask = sv["track_mask"][tracks]
        self.track_cam = torch.where(self.mask, remap[sv["track_cam"][tracks]],
                                     0)
        self.track_uv = sv["track_uv"][tracks]
        n_views = self.mask.sum(dim=1)
        self.weight = torch.where(n_views >= 3, weight_multiview, 1.0).to(
            torch.float64)
        self.pose_free = free_cams[cams]
        self.gauge = int(torch.nonzero(~self.pose_free)[0, 0])
        self.truth = (sv["poses"][cams], sv["intr"], sv["points"][tracks])
        self.lm = lm_settings(settings, full, cams.numel())
        self.C, self.P = cams.numel(), tracks.numel()
        self.obs = ba_lm.observations(self.track_cam, self.track_uv,
                                      self.mask, self.weight)
        self.prog = None

    def shape(self):
        return (bucket(self.C, 8), bucket(self.P, 16),
                self.lm["cg_iterations"])

    def build_program(self, bp):
        """The program's BAProblem, padded as Scene.to_ba_problem pads."""
        C, P, _ = self.shape()
        dev = self.mask.device

        def pad(x, n, fill=0.0):
            out = torch.full((n,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                             device=dev)
            out[:x.shape[0]] = x
            return out

        intrs = torch.tensor([[1.0, 0.0, 0.0]] * 4, dtype=torch.float64,
                             device=dev)
        self.prog = bp.build_problem(
            pad(self.truth[0], C), intrs, torch.zeros(C, dtype=torch.int64),
            pad(self.truth[2], P), pad(self.track_cam, P),
            pad(self.track_uv, P), pad(self.mask, P, False),
            pad(self.weight, P, 1.0),
            pose_mut=pad(self.pose_free.to(torch.float64), C),
            intr_mut=torch.tensor([1.0, 0.0, 0.0, 0.0]),
            point_mut=pad(torch.ones(self.P, dtype=torch.float64), P),
            device=dev)

    def start(self, sigma: dict, seed: int, k: int):
        """The seeded start of solve k (float64): truth perturbed, frozen
        cameras at their truth.  Each group's perturbation has exactly its
        RMS and a seeded direction (the scalars of the intrinsics a seeded
        sign), so starts differ in direction only."""
        dev = self.mask.device
        g = torch.Generator(device=dev)
        g.manual_seed((int(seed) * 1_000_003 + k) % (2 ** 63))

        def n(shape, s):
            """Normal draws rescaled to an RMS of exactly s: every start
            sits as far from the truth as every other."""
            x = torch.randn(shape, generator=g, device=dev,
                            dtype=torch.float64)
            return s * x / x.square().mean().sqrt() if x.numel() > 1 \
                else s * x.sign()

        poses, intr, points = self.truth
        free = self.pose_free[:, None]
        d = torch.cat([n((int(free.sum()), 3), sigma["rot_rad"]),
                       n((int(free.sum()), 3), sigma["trans_m"])], dim=1)
        poses = poses.clone()
        poses[self.pose_free] += d
        intr = torch.stack([intr[0] * (1 + n((), sigma["focal_rel"])),
                            intr[1] + n((), sigma["k1"]),
                            intr[2] + n((), sigma["k2"])])
        points = points + n(points.shape, sigma["point_m"])
        return poses, intr, points


def full_problems(sv, settings, mix):
    C = sv["poses"].shape[0]
    dev = sv["points"].device
    free = torch.ones(C, dtype=torch.bool, device=dev)
    free[0] = False                       # the gauge: first registered view
    return [Problem(sv, torch.arange(C, device=dev),
                    torch.arange(sv["points"].shape[0], device=dev), free,
                    1.0, True, settings)]


def around_views(n_views: int, count: int):
    """A fixed spread of `count` views over the survey's flight order,
    edges and interior alike."""
    return sorted({round(i * (n_views - 1) / (count - 1))
                   for i in range(count)})


def partial_problems(sv, settings, mix):
    C = sv["poses"].shape[0]
    dev = sv["points"].device
    cam, mask = sv["track_cam"], sv["track_mask"]
    out = []
    for a in around_views(C, mix["around_views"]):
        seed_tr = (mask & (cam == a)).any(dim=1)
        vis = torch.zeros(C, dtype=torch.bool, device=dev)
        vis[cam[seed_tr][mask[seed_tr]]] = True
        vis[a] = True
        tracks = torch.nonzero((mask & vis[cam]).any(dim=1))[:, 0]
        images = torch.unique(cam[tracks][mask[tracks]])
        free = vis.clone()
        free[0] = False                   # the gauge: first registered view
        if bool(free[images].all()):
            free[images.min()] = False    # no frozen anchor: pin the lowest
        out.append(Problem(sv, images, tracks, free,
                           settings["sfm"]["weight_multiview"], False,
                           settings))
    return out


class Driver:
    def __init__(self, cell, seed, device, solver="program"):
        self.cell, self.seed, self.device = cell, seed, device
        self.solver = solver
        self.cfg = cell["config_spec"]
        self.mix = cell["mix"]
        self.done = []
        self.outputs = {}

    # -- set-up --------------------------------------------------------
    def setup(self):
        from metricsfm_tpu_torch.ba import lm
        from metricsfm_tpu_torch.ba import problem as bp
        self.lm = lm
        sv = survey_gen.make_survey(self.cfg["survey"], self.seed,
                                    self.device)
        make = {"full": full_problems, "partial": partial_problems}
        self.problems = make[self.mix["problems"]](sv, self.cfg["settings"],
                                                   self.mix)
        g = torch.Generator().manual_seed(int(self.seed) % (2 ** 63))
        self.order = torch.randperm(len(self.problems), generator=g).tolist()
        warmed = set()
        for i, p in enumerate(self.problems):
            p.build_program(bp)
            if p.shape() not in warmed:     # first use of each shape
                warmed.add(p.shape())
                self._solve(p, -1 - i, warm=True)
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _solve(self, p, k, warm=False):
        """Solve k of problem p from its seeded start: (poses, intr,
        points) of the answer and the solver's info."""
        start = p.start(self.cfg["start"], self.seed, k)
        if self.solver == "control":
            poses, intr, points, info = ba_lm.solve(
                p.obs, *start, p.pose_free, True,
                delta=p.lm["huber_delta"],
                max_iterations=1 if warm else p.lm["max_iterations"],
                rtol=p.lm["rtol"], init_lambda=p.lm["init_lambda"],
                precision="tf32")
            return (poses, intr, points), {"final_cost": info["cost"],
                                           "initial_cost":
                                               info["initial_cost"],
                                           "iterations": info["iterations"]}
        cfg = self.lm.LMConfig(**p.lm)
        if warm:
            cfg = cfg._replace(max_iterations=1)
        f32 = torch.float32
        prob = p.prog._replace(
            poses=_pad(start[0].to(f32), p.prog.poses),
            intrs=torch.cat([start[1].to(f32)[None], p.prog.intrs[1:]]),
            points=_pad(start[2].to(f32), p.prog.points))
        out, info = self.lm.solve_lm(prob, cfg)
        return (out.poses[:p.C], out.intrs[0], out.points[:p.P]), info

    # -- window --------------------------------------------------------
    def window(self, seconds):
        from metricsfm_tpu_torch.ops import segsum
        launches0 = segsum.segment_sum.launches
        t0 = time.perf_counter()
        k = 0
        while True:
            i = self.order[k % len(self.problems)]
            p = self.problems[i]
            ts = time.perf_counter()
            ans, info = self._solve(p, k)
            self._sync()
            dt = time.perf_counter() - ts
            self.done.append({"k": k, "problem": i, "seconds": dt,
                              "iterations": int(info["iterations"]),
                              "initial_cost": float(info["initial_cost"]),
                              "final_cost": float(info["final_cost"])})
            self.outputs[k] = tuple(x.detach().clone() for x in ans)
            k += 1
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        lines = [f"solve {d['k']} problem {d['problem']} "
                 f"{d['seconds']:.6f} s {d['iterations']} iterations "
                 f"cost {d['initial_cost']:.6g} -> {d['final_cost']:.6g}"
                 for d in self.done]
        return {"attempted": len(self.done), "wall_s": wall,
                "iterations": sum(d["iterations"] for d in self.done),
                "segsum_launches": segsum.segment_sum.launches - launches0,
                "lines": lines}

    def end_to_end(self, win):
        return {"ba_solves_per_min": 60.0 * win["attempted"] / win["wall_s"]}

    def traced(self):
        """Solves after the window under the profiler, until the mix's
        `trace_seconds` have passed (one at least), in the window's order
        and from their own seeded starts."""
        from ..core import trace
        k0 = len(self.done)

        def solves():
            k, its, t0 = k0, 0, time.perf_counter()
            while k == k0 or (time.perf_counter() - t0
                              < self.mix.get("trace_seconds", 0)):
                p = self.problems[self.order[k % len(self.problems)]]
                its += int(self._solve(p, k)[1]["iterations"])
                k += 1
            return its

        its, tr = trace.capture(solves)
        tr.iterations = its
        return tr

    def record(self, win, tr):
        return {"window": win, "trace": tr, "units": self.done}

    # -- check ---------------------------------------------------------
    def release(self):
        for p in self.problems:
            p.prog = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        """(numbers compared with their limits, solves found wrong)."""
        limits = self.cell.get("limits", {})
        failed = sum(1 for d in self.done
                     if not (math.isfinite(d["final_cost"])
                             and d["final_cost"] <= d["initial_cost"]))
        g = torch.Generator().manual_seed(int(self.seed) % (2 ** 63) + 1)
        n = min(self.mix["check_solves"], len(self.done))
        picks = torch.randperm(len(self.done), generator=g)[:n].tolist()
        worst = {}
        for j in picks:
            d = self.done[j]
            p = self.problems[d["problem"]]
            start = p.start(self.cfg["start"], self.seed, d["k"])
            ref = ba_lm.solve(p.obs, *start, p.pose_free, True,
                              delta=p.lm["huber_delta"], **REF_OPTIMUM)
            gaps = ba_lm.gaps(p.obs, self.outputs[d["k"]], ref[:3],
                              p.lm["huber_delta"], p.gauge, d["final_cost"])
            bad = False
            for name, v in gaps.items():
                worst[name] = max(worst.get(name, -math.inf), v)
                bad |= name in limits and not v <= limits[name]
            failed += bad
        checks = [(name, worst[name], limits.get(name, math.inf))
                  for name in sorted(worst)
                  if name in limits or not limits]
        return checks, failed


def _pad(x, like):
    out = torch.zeros_like(like)
    out[:x.shape[0]] = x
    return out
