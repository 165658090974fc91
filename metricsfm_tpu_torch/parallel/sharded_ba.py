"""Track-sharded Levenberg-Marquardt bundle adjustment over a mesh of ranks.

Counterpart of metricsfm_tpu/parallel/sharded_ba.py (replacing the
reference's single-threaded Ceres DENSE_SCHUR, optimizer.cc:47):

* Tracks (points and their observations) are split over the mesh's ranks
  in contiguous blocks; cameras are replicated.  Every term of the reduced
  camera system is a sum over tracks, so each rank computes its partial
  and one all-reduce completes it: ba/lm.py's functions with the mesh's
  `psum` as their `reduce`, not a second LM.
* Each rank's solve_lm makes the segment plans (ops/segsum) of its own
  block, so its partial sums run in a fixed order and a rank repeats its
  run bit for bit, GPS triples included.  Against one process the split
  still rounds: each rank rounds its half of a sum before the all-reduce
  adds the halves.
* Point elimination and back-substitution stay local to each rank.
* The reduced camera solve (dense Cholesky, or PCG with one (D,)
  all-reduce per CG iteration) is replicated on every rank.

The JAX package runs its LM in host chunks against the TPU transport's
per-call deadline; the port's LM is a host loop already, so it has none.
"""
from __future__ import annotations

from ..ba.lm import LMConfig, solve_lm
from ..ba.problem import BAProblem
from .mesh import Mesh, shard_tracks


def make_sharded_lm(mesh: Mesh, cfg: LMConfig = LMConfig(),
                    axis_name: str = "data"):
    """The sharded LM solver of `mesh`.

    Returns solve(local_problem) -> (local_problem, info): `local_problem`
    is this rank's block of tracks (parallel.mesh.shard_tracks) with every
    camera; `info` holds the whole problem's initial_cost, final_cost,
    iterations, lambda, converged and rms_px (host numbers, equal on every
    rank), as solve_lm returns them.
    """
    def solve(problem: BAProblem):
        return solve_lm(problem, cfg, reduce=mesh.psum)

    return solve


def solve_lm_sharded(problem: BAProblem, mesh: Mesh,
                     cfg: LMConfig = LMConfig(), axis_name: str = "data"):
    """Shard the tracks of the whole `problem`, solve, and gather the
    points back: returns the whole solved problem (on the mesh's device)
    and the info, on every rank."""
    local = shard_tracks(problem, mesh, axis_name)
    out, info = make_sharded_lm(mesh, cfg, axis_name)(local)
    whole = problem._replace(**{k: v.to(mesh.device) for k, v in
                                problem._asdict().items()})
    return whole._replace(poses=out.poses, intrs=out.intrs,
                          points=mesh.all_gather_rows(out.points)), info
