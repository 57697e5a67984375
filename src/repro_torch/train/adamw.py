"""AdamW (decoupled weight decay) as functional tree ops (counterpart of
`repro/train/adamw.py`).

Not `torch.optim.AdamW`: the reference clips the global gradient norm,
warms the learning rate up linearly, decays every leaf and keeps its
moments in float32, and so does this.  The step count is incremented
before the schedule reads it, and the bias corrections are float32.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    m: dict
    v: dict
    count: torch.Tensor        # int32 scalar on the params' device


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100

    def init(self, params) -> AdamWState:
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        device = tree_leaves(params)[0].device
        return AdamWState(
            m=tree_map(zeros, params),
            v=tree_map(zeros, params),
            count=torch.zeros((), dtype=torch.int32, device=device),
        )

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        warm = torch.clamp(step.to(torch.float32) / max(self.warmup_steps, 1), max=1.0)
        return self.lr * warm

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """(new params, new state, global gradient norm before the clip)."""
        gnorm = torch.sqrt(
            sum(torch.sum(torch.square(g.to(torch.float32))) for g in tree_leaves(grads))
        )
        scale = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
        grads = tree_map(lambda g: g.to(torch.float32) * scale, grads)
        count = state.count + 1
        lr = self.schedule(count)
        b1c = 1.0 - self.b1 ** count.to(torch.float32)
        b2c = 1.0 - self.b2 ** count.to(torch.float32)

        new_m = tree_map(lambda m, g: self.b1 * m + (1 - self.b1) * g, state.m, grads)
        new_v = tree_map(lambda v, g: self.b2 * v + (1 - self.b2) * g * g, state.v, grads)

        def step_fn(p, m, v):
            upd = (m / b1c) / (torch.sqrt(v / b2c) + self.eps)
            p32 = p.to(torch.float32)
            return (p32 - lr * (upd + self.weight_decay * p32)).to(p.dtype)

        new_params = tree_map(step_fn, params, new_m, new_v)
        return new_params, AdamWState(m=new_m, v=new_v, count=count), gnorm
