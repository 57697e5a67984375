"""Batched serving driver: LM decode and DLRM scoring (counterpart of
`repro/launch/serve.py`).

`serve_lm` prefills a batch of prompts, then decodes greedily with the KV
cache; on a card, sliding-window archs decode through the `swa_attention`
CUDA kernel.  `serve_dlrm` times click-logit forwards of a DLRM batch,
whose 26 table lookups are one `embedding_bag` kernel launch per forward.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch dlrm-mlperf --device cpu

The defaults mirror the reference's: for an LM the smoke config, batch 4,
a 32-token prompt and 16 new tokens; for DLRM the smoke config and
`smoke_batch`'s 16 rows (`--batch N` draws N rows by the same recipe,
where the reference ignores `--batch`).  The device defaults to the card
and raises when there is none.  Partition serving (`--arch partition`) is
not ported yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.device import preflight
from repro_torch.models import transformer as tfm
from repro_torch.models.dlrm import DLRMConfig, dlrm_forward, dlrm_init


@dataclasses.dataclass
class ServeResult:
    tokens: np.ndarray        # (B, gen_tokens + 1) int32: prefill's token, then decode's
    logits: torch.Tensor      # (B, 1, V) float32 of the last decode step
    prefill_s: float
    decode_s: float
    device: str

    @property
    def tokens_per_s(self) -> float:
        b, n = self.tokens.shape
        return b * (n - 1) / max(self.decode_s, 1e-9)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_lm(cfg: tfm.TransformerConfig, batch: int = 4, prompt_len: int = 32,
             gen_tokens: int = 16, *, device: str | torch.device = "cuda",
             params: dict | None = None) -> ServeResult:
    """Prefill `batch` prompts of `prompt_len` tokens, then `gen_tokens`
    greedy decode steps.  Weights default to `init_params` from a generator
    seeded with 0 on the device; the prompts are the reference's numpy draw
    from seed 0.  The device is checked, and the kernels built and loaded,
    before the first request."""
    dev = preflight(device)
    if params is None:
        params = tfm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (batch, prompt_len))
    tokens = torch.from_numpy(prompts.astype(np.int32)).to(dev)
    max_len = tokens.shape[1] + gen_tokens + 1

    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = tfm.forward_prefill(params, tokens, cfg, max_len)
        tok = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        out = [tok]
        t0 = time.perf_counter()
        for _ in range(gen_tokens):
            logits, cache = tfm.forward_decode(params, tok, cache, cfg)
            tok = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
            out.append(tok)
        _sync(dev)
        t_decode = time.perf_counter() - t0
    return ServeResult(tokens=torch.cat(out, dim=1).cpu().numpy(), logits=logits,
                       prefill_s=t_prefill, decode_s=t_decode, device=str(dev))


@dataclasses.dataclass
class DLRMServeResult:
    scores: torch.Tensor      # (B,) float32 click logits of the last timed forward
    batch_s: float            # mean seconds per timed forward
    forwards: int             # forwards run, the untimed warm-up included
    device: str

    @property
    def us_per_batch(self) -> float:
        return self.batch_s * 1e6

    @property
    def samples_per_s(self) -> float:
        return self.scores.shape[0] / max(self.batch_s, 1e-12)


def serve_dlrm(cfg: DLRMConfig, batch: dict, iters: int = 10, *,
               device: str | torch.device = "cuda", params: dict | None = None) -> DLRMServeResult:
    """Score `batch` (dense, sparse_idx, sparse_mask) `iters` times and
    report the mean time per forward.  Weights default to `dlrm_init` from
    a generator seeded with 0 on the device.  The device is checked, and
    the kernels built and loaded, before the first request; one untimed
    forward then warms the device (the reference's first timed forward
    includes its jit compile)."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    dev = preflight(device)
    if params is None:
        params = dlrm_init(torch.Generator(device=dev).manual_seed(0), cfg)
    inputs = {key: batch[key].to(dev) for key in ("dense", "sparse_idx", "sparse_mask")}
    with torch.inference_mode():
        dlrm_forward(params, inputs, cfg)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            scores = dlrm_forward(params, inputs, cfg)
        _sync(dev)
        dt = (time.perf_counter() - t0) / iters
    return DLRMServeResult(scores=scores, batch_s=dt, forwards=iters + 1, device=str(dev))


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=None,
                    help="LM: prompts (default 4); DLRM: rows (default smoke_batch's 16)")
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    args = ap.parse_args(argv)
    if args.arch == "partition":
        raise NotImplementedError(
            "--arch partition: partition serving is not ported yet (see ROADMAP.md)")
    from repro_torch.configs import dlrm_mlperf, get_arch

    spec = get_arch(args.arch)
    cfg = spec.smoke_config()
    if spec.family == "recsys":
        batch = (dlrm_mlperf.smoke_batch(cfg, 0) if args.batch is None
                 else dlrm_mlperf.draw_batch(cfg, args.batch, 0))
        res = serve_dlrm(cfg, batch, device=args.device)
        print(f"dlrm serve: device={res.device} batch={res.scores.shape[0]} "
              f"{res.us_per_batch:.0f} us/batch ({res.samples_per_s:.0f} samples/s)")
        return
    n_prompts = 4 if args.batch is None else args.batch
    res = serve_lm(cfg, n_prompts, args.prompt, args.tokens, device=args.device)
    total = n_prompts * args.tokens
    print(
        f"arch={args.arch} device={res.device} batch={n_prompts} "
        f"prefill({args.prompt} tok) {res.prefill_s * 1e3:.0f}ms, decode {args.tokens} tok x "
        f"{n_prompts} = {total} tok in {res.decode_s * 1e3:.0f}ms "
        f"({res.tokens_per_s:.0f} tok/s)"
    )


if __name__ == "__main__":
    main()
