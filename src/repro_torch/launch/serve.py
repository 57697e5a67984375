"""Batched serving driver: LM decode, DLRM scoring and partition lookups
(counterpart of `repro/launch/serve.py`).

`serve_lm` prefills a batch of prompts, then decodes greedily with the KV
cache; on a card, sliding-window archs decode through the `swa_attention`
CUDA kernel.  `serve_dlrm` times click-logit forwards of a DLRM batch,
whose 26 table lookups are one `embedding_bag` kernel launch per forward.
`serve_partition` partitions a graph through `repro_torch.api.partition`,
promotes the result into a resident `PartitionService` and serves batched
node->block lookups.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch dlrm-mlperf --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch partition --device cpu

The defaults mirror the reference's: for an LM the smoke config, batch 4,
a 32-token prompt and 16 new tokens; for DLRM the smoke config and
`smoke_batch`'s 16 rows (`--batch N` draws N rows by the same recipe,
where the reference ignores `--batch`); for a partition `--graph
gen:grid:side=64`, `--k 16`, driver buffcut and 64 batches of 4 lookups.
The device defaults to the card and raises when there is none.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import TYPE_CHECKING

import numpy as np

from repro_torch.device import preflight

if TYPE_CHECKING:
    import torch

    from repro_torch.models import transformer as tfm
    from repro_torch.models.dlrm import DLRMConfig


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
    import torch

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
    # the LM and DLRM stacks load here, so `--arch partition` never pays them
    import torch

    from repro_torch.models import transformer as tfm

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
    import torch

    from repro_torch.models.dlrm import dlrm_forward, dlrm_init

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


def serve_partition(source: str, k: int, driver: str, batch: int, queries: int, *,
                    device: str = "cuda") -> None:
    """Placement as a service through `repro_torch.serve`: one
    `repro_torch.api.partition` call (its V-cycles on `device`) builds the
    resident service; serving is batched node->block lookups through a
    `ServeSession`.  Only the lookups are timed; the answers are then
    checked against the partition's labels."""
    from repro_torch.api import partition
    from repro_torch.serve import ServeSession

    res = partition(source, k=k, driver=driver, device=device)
    service = res.into_service()
    n = service.n
    rng = np.random.default_rng(0)
    reqs = [rng.integers(0, n, batch).astype(np.int64) for _ in range(queries)]
    with ServeSession(service) as sess:
        t0 = time.perf_counter()
        outs = [sess.lookup(q) for q in reqs]
        dt = time.perf_counter() - t0
    checksum = 0
    for q, out in zip(reqs, outs):
        if not np.array_equal(out, res.labels[q]):
            raise RuntimeError(
                "served labels diverged from the partition result "
                f"(batch of {q.shape[0]} lookups)"
            )
        checksum += int(out.sum())
    total = batch * queries
    print(
        f"partition serve: driver={res.provenance['driver']} device={device} n={n} "
        f"k={res.k} cut_ratio={res.cut_ratio:.4f} balance={res.balance:.3f} | "
        f"{queries} batches x {batch} lookups in {dt*1e3:.1f}ms "
        f"({total / max(dt, 1e-9):.0f} lookups/s, checksum={checksum})"
    )


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=None,
                    help="LM: prompts (default 4); DLRM: rows (default smoke_batch's 16); "
                         "partition: lookups a batch (default 4)")
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--graph", default="gen:grid:side=64",
                    help="partition mode: graph source (path or gen: spec)")
    ap.add_argument("--k", type=int, default=16, help="partition mode: blocks")
    ap.add_argument("--driver", default="buffcut",
                    help="partition mode: registry driver name")
    ap.add_argument("--queries", type=int, default=64,
                    help="partition mode: lookup batches to serve")
    args = ap.parse_args(argv)
    if args.arch == "partition":
        serve_partition(args.graph, args.k, args.driver,
                        4 if args.batch is None else args.batch, args.queries,
                        device=args.device)
        return
    from repro_torch.configs import dlrm_mlperf, get_arch

    spec = get_arch(args.arch)
    if spec.family == "gnn":
        raise ValueError(f"{args.arch} is a GNN: serve has no GNN mode; train it with "
                         "python -m repro_torch.launch.train")
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
