"""Training of the surrogate on the card (counterpart of
`waves_jl_tpu/train`): the dense, windowed and streaming trainers, Adam with
accumulation as optax computes it, and checkpoints in the JAX package's
npz format; with `mesh=`, the dense and windowed trainers run data-parallel
over replicas of the model (`parallel.dp`)."""
from .checkpoint import load_checkpoint, save_checkpoint
from .loop import (
    TrainConfig,
    make_eval_step,
    make_optimizer,
    make_train_step,
    train,
    train_windowed,
    validate,
)
from .stream import (
    gather_window_batch_host,
    make_scan_train_steps_batched,
    train_streaming,
)
from .windows import (
    episode_axes,
    gather_window,
    gather_window_batch,
    make_dp_scan_train_steps_windowed,
    make_scan_eval_windowed,
    make_scan_train_steps_windowed,
    sample_window_indices,
    sample_window_indices_dp,
    stack_episodes,
)
