"""Surrogate models of the port, under the JAX package's names."""
from .acoustic_energy_model import (
    AcousticEnergyModel,
    SinusoidalSource,
    compute_latent_energy,
    energy_loss,
    energy_loss_ranking,
    pool_ranking_loss,
)
from .design_encoder import DesignMLP, design_encoder_apply, unroll_design_sequence
from .node import NODEDynamics, NODEEnergyModel, node_loss
from .pinn import WaveControlPINN, WaveControlPINNLoss, build_pinn_grid
from .layers import CNNBase, MLP, ResidualBlock, embed_sin, leaky_relu, sin_basis
from .policy import AmortizedPolicy, PolicyNet, bc_loss
from .wave_encoder import WaveEncoder, WaveEncoderScalarHead
