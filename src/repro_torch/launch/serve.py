"""Batched LM serving driver (counterpart of `repro/launch/serve.py`).

Prefills a batch of prompts, then decodes greedily with the KV cache; on a
card, sliding-window archs decode through the `swa_attention` CUDA kernel.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b --device cpu

The defaults mirror the reference's (smoke config, batch 4, a 32-token
prompt, 16 new tokens); the device defaults to the card and raises when
there is none.  Partition serving (`--arch partition`) and DLRM scoring
are not ported yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.device import preflight
from repro_torch.models import transformer as tfm


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


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    args = ap.parse_args(argv)
    if args.arch in ("partition", "dlrm-mlperf"):
        raise NotImplementedError(
            f"--arch {args.arch}: only LM serving is ported so far (see ROADMAP.md)")
    from repro_torch.configs import get_arch

    cfg = get_arch(args.arch).smoke_config()
    res = serve_lm(cfg, args.batch, args.prompt, args.tokens, device=args.device)
    total = args.batch * args.tokens
    print(
        f"arch={args.arch} device={res.device} batch={args.batch} "
        f"prefill({args.prompt} tok) {res.prefill_s * 1e3:.0f}ms, decode {args.tokens} tok x "
        f"{args.batch} = {total} tok in {res.decode_s * 1e3:.0f}ms "
        f"({res.tokens_per_s:.0f} tok/s)"
    )


if __name__ == "__main__":
    main()
