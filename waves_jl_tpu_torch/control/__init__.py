"""Controllers of the port."""
from .mpc import (EXACT_CHUNK, BatchedOracle, CEMShooting, EnsembleShooting, GradientShooting,
                  HybridShooting, OracleShooting, PoolProbe, RandomShooting,
                  build_action_sequence, coarsen_env_state, compute_action_cost,
                  make_action_episode, make_exact_scorer, make_hybrid_action_fused,
                  make_hybrid_episode_fused, make_mpc_episode_fused, make_mpc_episode_recorded,
                  make_oracle_action_fused, make_oracle_episode_fused, make_policy_episode_fused,
                  make_pool_probe_fused, selection_tspan, sequential_energy)

__all__ = ["EXACT_CHUNK", "BatchedOracle", "CEMShooting", "EnsembleShooting",
           "GradientShooting", "HybridShooting", "OracleShooting", "PoolProbe", "RandomShooting",
           "build_action_sequence", "coarsen_env_state", "compute_action_cost",
           "make_action_episode", "make_exact_scorer", "make_hybrid_action_fused",
           "make_hybrid_episode_fused", "make_mpc_episode_fused",
           "make_mpc_episode_recorded", "make_oracle_action_fused", "make_oracle_episode_fused",
           "make_policy_episode_fused", "make_pool_probe_fused", "selection_tspan",
           "sequential_energy"]
