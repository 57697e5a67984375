"""End-to-end training driver (counterpart of `repro/launch/train.py`).

Runs a GNN `--arch` at its smoke or full config with the port's substrate:
AdamW, the fault-tolerant loop, checkpoints and the data pipeline, on
`--device` (the card unless `--device cpu`).  As in the reference, both
presets train on `gnn_batches` of the arch's smoke batch.  Weights are
drawn from a CPU generator seeded 0 and moved to the device, so the card
and the CPU start from the same weights.

  PYTHONPATH=src python -m repro_torch.launch.train --arch graphsage-reddit \
      --preset smoke --steps 20 --device cpu

LM and DLRM training (the `lm` and `recsys` families) wait for the
backward of `forward_train` and of the embedding bag (ROADMAP Queue 1
item 5).
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device
from repro_torch.launch.steps import _GNN_INIT, _GNN_LOSS
from repro_torch.train.adamw import AdamW
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import gnn_batches
from repro_torch.train.loop import LoopConfig, TrainLoop, make_train_step
from repro_torch.tree import tree_map


def build_training(arch_id: str, preset: str, *, device: str | torch.device = "cuda"):
    """(config, params, loss(params, batch), batch iterator) of `arch_id`
    at `preset` ("smoke" or "full") on `device`."""
    spec = get_arch(arch_id)
    if spec.family != "gnn":
        raise NotImplementedError(
            f"training the {spec.family} family ({arch_id}) is not ported yet: it waits "
            "for ROADMAP Queue 1 item 5 (the backward of forward_train and of the bag)")
    dev = resolve_device(device)
    cfg = spec.smoke_config() if preset == "smoke" else spec.full_config()
    loss_base = _GNN_LOSS[arch_id]
    params = tree_map(lambda t: t.to(dev), _GNN_INIT[arch_id](torch.Generator().manual_seed(0),
                                                               cfg))
    loss = lambda p, b: loss_base(p, b, cfg)  # noqa: E731
    data = gnn_batches(lambda s: spec.smoke_batch(cfg, s), device=dev)
    return cfg, params, loss, data


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg, params, loss, data = build_training(args.arch, args.preset, device=args.device)
    opt = AdamW(lr=args.lr, warmup_steps=min(args.steps // 10 + 1, 100))
    opt_state = opt.init(params)
    step_fn = make_train_step(loss, opt)
    ckpt = CheckpointManager(args.ckpt_dir)
    start = 0
    if args.resume:
        restored = ckpt.restore_latest(template=(params, opt_state))
        if restored:
            (params, opt_state), start = restored["state"], restored["step"]
            print(f"resumed from step {start}")
    loop = TrainLoop(
        step_fn, ckpt,
        LoopConfig(total_steps=args.steps, checkpoint_every=args.ckpt_every),
    )
    t0 = time.time()
    (params, opt_state), history = loop.run(params, opt_state, data, start_step=start)
    dt = time.time() - t0
    n = max(len(history), 1)
    print(
        f"arch={args.arch} device={args.device} steps={len(history)} "
        f"loss {history[0]:.4f} -> {history[-1]:.4f} "
        f"({dt:.1f}s, {dt / n * 1e3:.0f} ms/step, "
        f"stragglers={len(loop.stragglers)}, retries={loop.retries})"
    )
    if math.isnan(history[-1]):
        raise RuntimeError("training diverged")


if __name__ == "__main__":
    main()
