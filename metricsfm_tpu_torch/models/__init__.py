"""Scene data model + pipeline drivers (incremental SfM)."""
from .scene import Scene, CameraModel  # noqa: F401
