"""Serving example on repro_torch: batched prefill + KV-cache decode for
the SWA arch (h2o-danube), the port of `examples/serve_decode.py`.  On a
card each decode step of each layer runs the sliding-window decode kernel;
`--arch` serves any other LM arch of the registry (the MoE archs too) the
same way.

    PYTHONPATH=src python examples/serve_decode_torch.py               # the card
    PYTHONPATH=src python examples/serve_decode_torch.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.device import preflight
from repro_torch.models import transformer as tfm

BATCH, PROMPT, GEN = 4, 24, 16


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    args = ap.parse_args(argv)
    dev = preflight(args.device)

    cfg = get_arch(args.arch).smoke_config()  # reduced dims, same family
    params = tfm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (BATCH, PROMPT)).astype(np.int32))

    with torch.inference_mode():
        logits, cache = tfm.forward_prefill(params, prompts.to(dev), cfg, PROMPT + GEN + 1)
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        out = [tok]
        t0 = time.perf_counter()
        for _ in range(GEN):
            logits, cache = tfm.forward_decode(params, tok, cache, cfg)
            tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
            out.append(tok)
        gen = torch.cat(out, dim=1).cpu()  # waits for the device
        dt = time.perf_counter() - t0
    print(f"{args.arch} on {dev}: decoded {BATCH}x{GEN} tokens in {dt*1e3:.0f} ms "
          f"({BATCH*GEN/dt:.0f} tok/s, window={cfg.sliding_window}, "
          f"experts={cfg.n_experts})")
    print("sample:", gen[0].tolist())
    assert bool(torch.isfinite(logits).all())
    assert int(cache["pos"][0]) == PROMPT + GEN
    print("OK")


if __name__ == "__main__":
    main()
