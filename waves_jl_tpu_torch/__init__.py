"""waves_jl_tpu_torch: the PyTorch and CUDA port of waves_jl_tpu.

The acoustic FDTD environment with its fused RK4 kernel written in CUDA for
Hopper, the flagship latent surrogate with its training, and the MPC
controllers. Entry points run on the card unless the caller passes
device="cpu"; on the CPU every kernel takes its plain PyTorch version.

The top level exports the JAX package's names (`import waves_jl_tpu_torch as
w; w.two_dim(...)`); the submodules `models`, `train`, `control`, ... load
on first access, so `viz` needs matplotlib only when it draws.
`entry_points` holds the counterparts of `__graft_entry__.py`'s `entry()` and
`dryrun_multichip(n)`.
"""

from .constants import AIR, ALUMINIUM, BRASS, COPPER, DESIGN_SPEED, WATER
from .dims import (
    OneDim,
    ThreeDim,
    TwoDim,
    build_dirichlet,
    build_grid,
    build_wave,
    get_dx,
    get_dy,
    get_dz,
    one_dim,
    one_dim_spacing,
    three_dim,
    two_dim,
    two_dim_spacing,
)
from .ops.fd import fd_dx, fd_dy, fd_grad_1d, gradient_matrix, laplacian_matrix
from .ops.metrics import circle_mask, displacement, energy, flux
from .ops.pml import build_pml
from .utils.gaussians import build_normal
from .utils.interp import LinearInterpolation, flatten_repeated_last_dim, linear_interp
from .physics.dynamics import (
    AcousticDynamics1D,
    AcousticDynamics2D,
    AcousticDynamics3D,
    Integrator,
    acoustic_rhs_2d,
    acoustic_rhs_3d,
    build_tspan,
    make_acoustic_dynamics_1d,
    make_acoustic_dynamics_2d,
    make_acoustic_dynamics_3d,
    runge_kutta,
)
from .designs import (
    AdjustablePositionScatterers,
    AdjustableRadiiScatterers,
    Cloak,
    Cylinders,
    DesignInterpolator,
    DesignSpace,
    NoDesign,
    SpeedField,
    build_action_space,
    build_radii_design_space,
    build_rectangular_grid_design_space,
    build_simple_radii_design_space,
    build_triple_ring_design_space,
    hexagon_ring,
    location_mask,
    normalize_design,
    speed,
    stack_cylinders,
)
from .sources import GaussianSource, NoSource, Source

__version__ = "0.1.0"


def __getattr__(name):
    """The submodules on first access (w.models, w.train, ...), so that
    importing the package loads neither matplotlib nor the trainers."""
    if name in ("models", "train", "control", "parallel", "viz", "data", "env",
                "native", "physics", "ops", "utils", "entry_points"):
        import importlib

        return importlib.import_module("." + name, __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
