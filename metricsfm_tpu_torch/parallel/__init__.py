"""parallel of the PyTorch port (see metricsfm_tpu_torch/__init__.py):
the mesh of ranks on torch.distributed, track-sharded BA, pair-sharded
matching and hierarchical submap BA."""
from .mesh import make_mesh, shard_tracks  # noqa: F401
from .sharded_ba import solve_lm_sharded  # noqa: F401
