"""Train-step factory and fault-tolerant loop (counterpart of
`repro/train/loop.py`).

`make_train_step` builds the eager (params, opt_state, batch) -> update
step: `torch.autograd` takes the place of `jax.value_and_grad`, and a
Python loop over microbatch splits the place of `lax.scan`; optionally
top-k gradient compression with error feedback.  A parameter the loss
does not reach gets a zero gradient, as under `jax.grad`.

`TrainLoop` adds the production concerns: periodic atomic checkpoints,
automatic restore-and-retry on step failure (node-failure model: any
exception inside the step) and deadline-based straggler accounting.  It
synchronises the loss's device where the reference blocks on the loss, so
a device error surfaces inside the step's retry.
"""
from __future__ import annotations

import dataclasses
import time
from collections.abc import Callable

import numpy as np
import torch

from repro_torch.distributed.compression import compress_grads_with_feedback
from repro_torch.train.adamw import AdamW
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, grads): the loss detached, grads a tree like `params`."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten_like(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten_like(params, grads)


def make_train_step(
    loss_fn: Callable,
    optimizer: AdamW,
    *,
    microbatches: int = 1,
    compress_ratio: float | None = None,
):
    """loss_fn(params, batch) -> scalar. Returns step(params, opt, batch[, res])."""

    def split_batch(batch, i):
        def slice_leaf(x):
            mb = x.shape[0] // microbatches
            return x[i * mb:(i + 1) * mb]
        return tree_map(slice_leaf, batch)

    if compress_ratio is None:
        def train_step(params, opt_state, batch):
            if microbatches == 1:
                loss, grads = value_and_grad(loss_fn, params, batch)
            else:
                device = tree_leaves(params)[0].device
                loss = torch.zeros((), device=device)
                grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                       device=p.device), params)
                for i in range(microbatches):
                    loss_i, g_i = value_and_grad(loss_fn, params, split_batch(batch, i))
                    loss = loss + loss_i
                    grads = tree_map(torch.add, grads, g_i)
                loss = loss / microbatches
                grads = tree_map(lambda g: g / microbatches, grads)
            new_params, new_opt, gnorm = optimizer.update(grads, opt_state, params)
            return new_params, new_opt, {"loss": loss, "grad_norm": gnorm}
        return train_step

    def train_step_compressed(params, opt_state, batch, residuals):
        loss, grads = value_and_grad(loss_fn, params, batch)
        sent, new_res = compress_grads_with_feedback(grads, residuals, compress_ratio)
        new_params, new_opt, gnorm = optimizer.update(sent, opt_state, params)
        return new_params, new_opt, new_res, {"loss": loss, "grad_norm": gnorm}

    return train_step_compressed


def _block_until_ready(x: torch.Tensor) -> None:
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 25
    max_retries: int = 3
    straggler_factor: float = 3.0   # step slower than factor*median == straggler
    log_every: int = 10


class TrainLoop:
    """Fault-tolerant driver around a train step."""

    def __init__(
        self,
        step_fn: Callable,
        ckpt: CheckpointManager,
        cfg: LoopConfig,
        *,
        fault_hook: Callable[[int], None] | None = None,
    ):
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.cfg = cfg
        self.fault_hook = fault_hook  # test hook: raise to simulate node loss
        self.step_times: list[float] = []
        self.stragglers: list[int] = []
        self.retries = 0

    def run(self, params, opt_state, batches, start_step: int = 0):
        state = (params, opt_state)
        step = start_step
        it = iter(batches)
        history = []
        while step < self.cfg.total_steps:
            try:
                batch = next(it)
            except StopIteration:
                break
            t0 = time.perf_counter()
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                params, opt_state, metrics = self.step_fn(state[0], state[1], batch)
                _block_until_ready(metrics["loss"])
            except Exception:
                # node-failure model: restore the last checkpoint and retry
                self.retries += 1
                if self.retries > self.cfg.max_retries:
                    raise
                restored = self.ckpt.restore_latest(template=state)
                if restored is not None:
                    state, step = restored["state"], restored["step"]
                continue
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            med = float(np.median(self.step_times[-20:]))
            if len(self.step_times) > 5 and dt > self.cfg.straggler_factor * med:
                self.stragglers.append(step)  # deadline-based detection
            state = (params, opt_state)
            history.append(float(metrics["loss"]))
            step += 1
            if step % self.cfg.checkpoint_every == 0:
                self.ckpt.save(step, {"state": state, "step": step})
        return state, history
