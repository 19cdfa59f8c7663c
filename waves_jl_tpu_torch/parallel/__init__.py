from .domain import acoustic_rhs_2d_sharded, fd_dy_halo, make_sharded_rollout
from .dp import Replicas, make_dp_scan_train_steps, make_dp_train_step, shard_batch
from .fused_domain import make_fused_sharded_rollout
from .mesh import Mesh, batch_sharded, make_mesh, make_mesh_2d, replicated
