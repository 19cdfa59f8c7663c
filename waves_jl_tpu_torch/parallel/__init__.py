from .domain import acoustic_rhs_2d_sharded, fd_dy_halo, make_sharded_rollout
from .fused_domain import make_fused_sharded_rollout
from .mesh import Mesh, make_mesh
