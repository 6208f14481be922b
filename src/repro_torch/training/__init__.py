"""Training substrate: optimizer, losses, data, checkpointing, fault tolerance."""
from repro_torch.training.optimizer import AdamW, AdamWState, wsd_schedule, global_norm, clip_by_global_norm
from repro_torch.training.losses import chunked_softmax_xent
from repro_torch.training.train import TrainState, init_train_state, make_train_step, make_eval_step
from repro_torch.training.data import DataConfig, PackedLMStream, make_prompts
from repro_torch.training.checkpoint import (
    save_checkpoint,
    save_checkpoint_async,
    restore_checkpoint,
    latest_step,
    list_steps,
)
from repro_torch.training.fault import StepWatchdog, PreemptionGuard, run_with_restarts

__all__ = [
    "AdamW", "AdamWState", "wsd_schedule", "global_norm", "clip_by_global_norm",
    "chunked_softmax_xent",
    "TrainState", "init_train_state", "make_train_step", "make_eval_step",
    "DataConfig", "PackedLMStream", "make_prompts",
    "save_checkpoint", "save_checkpoint_async", "restore_checkpoint",
    "latest_step", "list_steps",
    "StepWatchdog", "PreemptionGuard", "run_with_restarts",
]
