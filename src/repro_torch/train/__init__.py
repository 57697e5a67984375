"""Training substrate of the port: optimizer, loop, checkpointing, data
(counterpart of `repro/train/`; `elastic` waits for the port's mesh,
ROADMAP Queue 1 item 7)."""
from repro_torch.train.adamw import AdamW, AdamWState
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import dlrm_batches, gnn_batches, token_batches
from repro_torch.train.loop import LoopConfig, TrainLoop, make_train_step

__all__ = [
    "AdamW", "AdamWState",
    "make_train_step", "TrainLoop", "LoopConfig",
    "CheckpointManager",
    "token_batches", "gnn_batches", "dlrm_batches",
]
