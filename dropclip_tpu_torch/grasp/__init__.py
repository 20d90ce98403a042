"""Grasping: 6-DoF grasp containers, 2D rectangles, language-guided
ranking, gripper marker meshes."""

from .grasps import (Grasp2D, SceneGrasps, SceneGrasps2D,  # noqa: F401
                     rank_grasps_by_query)
from .gripper import (create_gripper_marker, load_obj,  # noqa: F401
                      make, save_obj)
