"""The process mesh and problem sharding helpers, on torch.distributed.

Counterpart of metricsfm_tpu/parallel/mesh.py.  The JAX package is
single-controller: one process holds a `jax.sharding.Mesh` over every local
chip.  The port is SPMD, one process per card (what `torchrun` starts):
a `Mesh` is this process's view of a 1-D group of ranks, with the two
collectives the sharded modules use (`psum`, the sum over the ranks, and
`all_gather_rows`, row blocks concatenated in rank order).  At world size 1
with no process group both are the identity, as `lax.psum` is on a
one-device mesh.

The backend follows the devices (`initialize_distributed`): NCCL when
every rank has a card of its own, gloo on the CPU or when ranks share a
card (NCCL cannot put two ranks on one GPU).  Gloo runs `all_reduce` and
`broadcast` on CUDA tensors but not `all_gather`, so `all_gather_rows` is
an `all_reduce` into a zeroed buffer in which each rank fills its own
rows: one code path for both backends, exact for every value (x + 0 = x).
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve as resolve_device

# the rank's device chosen by initialize_distributed
_RANK_DEVICE: Optional[torch.device] = None

DEFAULT_TIMEOUT_S = 1800.0


class Mesh:
    """A 1-D mesh of ranks: the process group (None at world size 1 with
    no group), this process's rank in it, its size and the rank's device.
    `shape` maps the axis name to the size, as a JAX mesh's does."""

    def __init__(self, group=None, rank: int = 0, size: int = 1,
                 device="cuda", axis_name: str = "data"):
        self.group = group
        self.rank = rank
        self.size = size
        self.device = torch.device(device)
        self.axis_names = (axis_name,)
        self.shape = {axis_name: size}

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the ranks, on every rank (a new tensor;
        `t` itself is left as it is)."""
        if self.group is None:
            return t
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=self.group)
        return out

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's (n, ...) block, concatenated in rank order: (size *
        n, ...) on every rank.  Blocks have one shape on every rank."""
        if self.group is None:
            return t
        n = t.shape[0]
        dtype = torch.uint8 if t.dtype == torch.bool else t.dtype
        buf = torch.zeros((self.size * n, *t.shape[1:]), dtype=dtype,
                          device=t.device)
        buf[self.rank * n:(self.rank + 1) * n] = t
        dist.all_reduce(buf, group=self.group)
        return buf.bool() if t.dtype == torch.bool else buf

    def broadcast_object(self, obj, src: int = 0):
        """A picklable host object from rank `src` (of this mesh) to every
        rank."""
        if self.group is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(
            box, src=dist.get_global_rank(self.group, src), group=self.group,
            device=self.device if self.backend == "nccl" else None)
        return box[0]

    def barrier(self):
        if self.group is not None:
            dist.barrier(group=self.group)

    def rows(self, n: int):
        """This rank's contiguous [lo, hi) block of n rows (owned_range; n
        divisible by the mesh size gives every rank n / size rows)."""
        return owned_range(n, self.rank, self.size)


def _env_int(name, default=None):
    v = os.environ.get(name)
    return default if v is None else int(v)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device=None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
    """Bring up the process group of a multi-process run; returns the rank.

    Safe to call in every entry path: without a launcher environment
    (`torchrun` sets RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
    MASTER_ADDR and MASTER_PORT) and without arguments it is a no-op
    returning 0; a group already up returns its rank.  The arguments
    override the environment: `coordinator_address` "host:port",
    `num_processes` the world size, `process_id` the rank.

    `device` defaults to the card, and raises without one: the CPU runs
    only when the caller passes it.  The backend follows the devices: gloo
    on the CPU, or when ranks share a card (LOCAL_WORLD_SIZE above the card
    count); NCCL otherwise.  The rank's card (LOCAL_RANK modulo the card
    count) becomes the current device.  The group's timeout is
    finite (`timeout_s`): a rank that fails or diverges ends the run with
    an error instead of a hang.
    """
    global _RANK_DEVICE
    if dist.is_initialized():
        return dist.get_rank()
    rank = process_id if process_id is not None else _env_int("RANK")
    world = num_processes if num_processes is not None \
        else _env_int("WORLD_SIZE")
    if coordinator_address is None and rank is None and world is None:
        return 0                                   # single-process run
    if rank is None or world is None:
        raise ValueError("initialize_distributed: the rank and the world "
                         "size must both be set (RANK / WORLD_SIZE)")
    if coordinator_address is not None:
        addr, port = coordinator_address.rsplit(":", 1)
    else:
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ.get("MASTER_PORT")
        if port is None:
            raise ValueError("initialize_distributed: MASTER_PORT is not "
                             "set")
    local_rank = _env_int("LOCAL_RANK", rank)
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
    dev = resolve_device(device if device is not None else "cuda")
    if dev.type == "cpu":
        backend = "gloo"
    else:
        n_cards = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % n_cards)
        backend = "gloo" if local_world > n_cards else "nccl"
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    _RANK_DEVICE = dev
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"rank {rank}/{world}: backend {backend}, device {dev} ({name})",
          flush=True)
    return rank


def _rank_device(device):
    if device is not None:
        return resolve_device(device)
    if _RANK_DEVICE is None:
        raise ValueError("the process group was not brought up by "
                         "initialize_distributed: pass the rank's device")
    return _RANK_DEVICE


def make_mesh(n_data: Optional[int] = None, axis_name: str = "data",
              device=None) -> Optional[Mesh]:
    """1-D mesh over the first n_data ranks (default: all).

    With a process group up, every rank must call it (a subgroup's
    creation is collective); ranks outside the first n_data get None.  The
    device defaults to the rank's device of initialize_distributed.
    Without a group it is the size-1 mesh on `device` (default the card).
    """
    if not dist.is_initialized():
        if n_data not in (None, 1):
            raise ValueError(f"make_mesh({n_data}): no process group is up "
                             "(initialize_distributed), so 1 rank")
        return Mesh(None, 0, 1, resolve_device(device or "cuda"), axis_name)
    world = dist.get_world_size()
    n = world if n_data is None else n_data
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh({n_data}): the world has {world} ranks")
    if n == world:
        group = dist.group.WORLD
    else:
        group = dist.new_group(ranks=list(range(n)))
    rank = dist.get_rank()
    if rank >= n:
        return None
    return Mesh(group, rank, n, _rank_device(device), axis_name)


def make_global_mesh(axis_name: str = "data", device=None) -> Mesh:
    """1-D mesh over all ranks of all processes (identical to make_mesh
    with no n_data)."""
    return make_mesh(None, axis_name, device)


def owned_range(n_items: int, process_id: Optional[int] = None,
                process_count: Optional[int] = None):
    """Contiguous [lo, hi) shard of an item axis owned by this process
    (default: this rank of the process group, of its world size).

    The host-sharded store policy: each process extracts / matches / pages
    only its image range (the reference's per-image files map naturally to
    per-host shards — SURVEY §5); resume stays per shard.
    """
    up = dist.is_initialized()
    p = (dist.get_rank() if up else 0) if process_id is None else process_id
    n = (dist.get_world_size() if up else 1) if process_count is None \
        else process_count
    per = -(-n_items // n)
    lo = min(p * per, n_items)
    return lo, min(lo + per, n_items)


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0,
                    value=0):
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=value)


TRACK_FIELDS = ("points", "track_cam", "track_uv", "track_mask",
                "track_weight", "point_mut")


def shard_tracks(problem, mesh: Mesh, axis_name: str = "data"):
    """This rank's contiguous block of a BAProblem's track-indexed fields,
    on the mesh's device; camera-indexed fields are replicated.  The track
    count must be a multiple of the mesh size (bucketed shapes already
    are, since buckets are powers of two)."""
    n = mesh.shape[axis_name]
    assert problem.n_points % n == 0, \
        f"track count {problem.n_points} not divisible by mesh axis {n}"
    lo, hi = mesh.rows(problem.n_points)
    return problem._replace(**{
        k: (v[lo:hi] if k in TRACK_FIELDS else v).to(mesh.device)
        for k, v in problem._asdict().items()})
