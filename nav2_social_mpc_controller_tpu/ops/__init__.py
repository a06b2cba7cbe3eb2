"""The low-level op library: the reusable array primitives under the
framework, collected behind one import point.

  bicubic_interpolate   Catmull-Rom grid sampling as stencil matmuls with an
                        analytic custom JVP (world/grid.py)
  bicubic_linearize     (value, d/drow, d/dcol) sampling (world/grid.py)
  crop_grid_window      rolling-window grid crop, exact under a reachable-set
                        bound (world/grid.py)
  expand_blocks         block-constant control expansion as a one-hot product
                        (models/motion.py)
  default_linear_solve  batched tiny-SPD Cholesky solve (solver/lm.py)
  esdf_nearest_obstacle_diff
                        ESDF nearest-obstacle lookup (world/grid.py)
"""

from nav2_social_mpc_controller_tpu.models.motion import expand_blocks  # noqa: F401
from nav2_social_mpc_controller_tpu.solver.lm import default_linear_solve  # noqa: F401
from nav2_social_mpc_controller_tpu.world.grid import (  # noqa: F401
    bicubic_interpolate,
    bicubic_interpolate_gather,
    bicubic_linearize,
    crop_grid_window,
    esdf_nearest_obstacle_diff,
    sample_costmap,
)
