"""End-to-end training driver (counterpart of `repro/launch/train.py`).

Runs any `--arch` at its smoke or full config with the port's substrate:
AdamW, the fault-tolerant loop, checkpoints and the data pipeline, on
`--device` (the card unless `--device cpu`).  As in the reference, an LM
trains on `token_batches(vocab, --batch, --seq)`, DLRM on
`dlrm_batches(cfg, --batch)` (defaults 8 and 128), and a GNN, at either
preset, on `gnn_batches` of the arch's smoke batch; a GNN has no batch or
sequence size, so it refuses `--batch` and `--seq` rather than ignore
them.  Weights are drawn from a CPU generator seeded 0 and moved to the
device, so the card and the CPU start from the same weights.

  PYTHONPATH=src python -m repro_torch.launch.train --arch moonshot-v1-16b-a3b \
      --preset smoke --steps 20 --device cpu
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile
import time

import torch  # repro: noqa RPR001 -- train entry point; torch is its purpose

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device
from repro_torch.launch.steps import _GNN_INIT, _GNN_LOSS
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.models import transformer as tfm
from repro_torch.train.adamw import AdamW
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import dlrm_batches, gnn_batches, token_batches
from repro_torch.train.loop import LoopConfig, TrainLoop, make_train_step
from repro_torch.tree import tree_map


def build_training(arch_id: str, preset: str, batch: int | None = None,
                   seq: int | None = None, *, device: str | torch.device = "cuda"):
    """(config, params, loss(params, batch), batch iterator) of `arch_id`
    at `preset` ("smoke" or "full") on `device`.  `batch` and `seq` size
    an LM's token batches (default 8 x 128) and `batch` DLRM's rows
    (default 8); a GNN takes neither."""
    spec = get_arch(arch_id)
    if spec.family == "gnn" and (batch is not None or seq is not None):
        raise ValueError(f"{arch_id} is a GNN: it trains on its smoke batches and takes no "
                         "batch or sequence size")
    batch = 8 if batch is None else batch
    seq = 128 if seq is None else seq
    dev = resolve_device(device)
    cfg = spec.smoke_config() if preset == "smoke" else spec.full_config()
    gen = torch.Generator().manual_seed(0)
    if spec.family == "lm":
        params = tfm.init_params(gen, cfg)
        loss = lambda p, b: tfm.loss_fn(p, b, cfg)  # noqa: E731
        data = token_batches(cfg.vocab, batch, seq, device=dev)
    elif spec.family == "gnn":
        loss_base = _GNN_LOSS[arch_id]
        params = _GNN_INIT[arch_id](gen, cfg)
        loss = lambda p, b: loss_base(p, b, cfg)  # noqa: E731
        data = gnn_batches(lambda s: spec.smoke_batch(cfg, s), device=dev)
    else:
        params = dlrm_mod.dlrm_init(gen, cfg)
        loss = lambda p, b: dlrm_mod.dlrm_loss(p, b, cfg)  # noqa: E731
        data = dlrm_batches(cfg, batch, device=dev)
    return cfg, tree_map(lambda t: t.to(dev), params), loss, data


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=None,
                    help="LM and DLRM: rows a batch (default 8); not for a GNN")
    ap.add_argument("--seq", type=int, default=None,
                    help="LM: tokens a row (default 128); not for a GNN")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if get_arch(args.arch).family == "gnn":
        for flag, value in (("--batch", args.batch), ("--seq", args.seq)):
            if value is not None:
                ap.error(f"{flag} sizes LM and DLRM batches; {args.arch} is a GNN, which "
                         "trains on its smoke batches")

    cfg, params, loss, data = build_training(args.arch, args.preset, args.batch, args.seq,
                                             device=args.device)
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
