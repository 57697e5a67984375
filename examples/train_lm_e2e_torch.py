"""End-to-end driver on repro_torch: train a small LM for a few hundred
steps with the full substrate (AdamW, checkpoints, the fault-tolerant
loop), the port of `examples/train_lm_e2e.py`.

Reduced to CPU-feasible sizes by --dim/--layers/--steps; the same code path
trains the full configs (`python -m repro_torch.launch.train --preset full`).

    PYTHONPATH=src python examples/train_lm_e2e_torch.py --steps 200               # the card
    PYTHONPATH=src python examples/train_lm_e2e_torch.py --steps 200 --device cpu
"""
import argparse
import math
import tempfile
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import TransformerConfig, init_params, loss_fn
from repro_torch.train import (
    AdamW,
    CheckpointManager,
    LoopConfig,
    TrainLoop,
    make_train_step,
    token_batches,
)
from repro_torch.tree import tree_map


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full-100m", action="store_true",
                    help="true ~100M-param config (slow on the CPU)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.full_100m:
        cfg = TransformerConfig(
            name="lm-100m", n_layers=12, d_model=768, n_heads=12,
            n_kv_heads=12, d_ff=2048, vocab=32768, dtype="float32",
        )
    else:
        cfg = TransformerConfig(
            name="lm-small", n_layers=args.layers, d_model=args.dim,
            n_heads=max(args.dim // 32, 2), n_kv_heads=max(args.dim // 64, 1),
            d_ff=args.dim * 3, vocab=args.vocab, dtype="float32",
            q_chunk=64, kv_chunk=64,
        )
    print(f"config: {cfg.name} params={cfg.param_count()/1e6:.1f}M device={dev}")

    # drawn on the CPU, so every device starts from the same weights
    params = tree_map(lambda t: t.to(dev), init_params(torch.Generator().manual_seed(0), cfg))
    opt = AdamW(lr=3e-4, warmup_steps=20)
    opt_state = opt.init(params)
    step = make_train_step(lambda p, b: loss_fn(p, b, cfg), opt)

    ckpt = CheckpointManager(tempfile.mkdtemp(prefix="lm_e2e_torch_"))
    loop = TrainLoop(step, ckpt, LoopConfig(
        total_steps=args.steps, checkpoint_every=max(args.steps // 4, 1),
    ))
    data = token_batches(cfg.vocab, args.batch, args.seq, steps=args.steps + 8, device=dev)
    t0 = time.time()
    (params, opt_state), hist = loop.run(params, opt_state, data)
    dt = time.time() - t0
    print(
        f"{len(hist)} steps in {dt:.0f}s ({dt/max(len(hist),1)*1e3:.0f} ms/step): "
        f"loss {hist[0]:.3f} -> {hist[-1]:.3f}"
    )
    assert hist[-1] < hist[0], "loss must decrease"
    assert math.isfinite(hist[-1])
    print("OK — checkpoints in", ckpt.dir, "steps:", ckpt.all_steps())


if __name__ == "__main__":
    main()
