from .model import InstantMesh, InstantMeshConfig
from .pipeline import InstantMeshPipeline, orbit_poses_to_input_cameras

__all__ = ["InstantMesh", "InstantMeshConfig", "InstantMeshPipeline",
           "orbit_poses_to_input_cameras"]
