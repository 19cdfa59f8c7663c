"""waves_jl_tpu_torch: the PyTorch and CUDA port of waves_jl_tpu.

The acoustic FDTD environment with its fused RK4 kernel written in CUDA for
Hopper, the flagship latent surrogate with its training, and the MPC
controllers. Entry points run on the card unless the caller passes
device="cpu"; on the CPU every kernel takes its plain PyTorch version.
"""

__version__ = "0.1.0"
