"""The paper's systems payoff end to end on repro_torch: BuffCut as the
placement service for distributed GNN training (the port of
`examples/gnn_partition_pipeline.py`).  The placement service dispatches
through `repro_torch.api.partition`.

 1. Stream-partition a graph into 8 'device' blocks with BuffCut,
 2. quantify the halo-exchange bytes a GNN layer would move vs
    random/hash placement,
 3. train a GraphSAGE model on the placement, sampling neighbors with
    partition-aware bias (fewer cross-shard gathers); the node features
    stay on the device and are gathered there by the sampled ids.

    PYTHONPATH=src python examples/gnn_partition_pipeline_torch.py               # the card
    PYTHONPATH=src python examples/gnn_partition_pipeline_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.distributed.gnn_placement import (
    place_graph,
    placement_report,
    reorder_for_shards,
)
from repro_torch.graphs import (
    apply_order,
    cross_block_fraction,
    random_order,
    rgg_graph,
    sample_multihop,
)
from repro_torch.models import gnn
from repro_torch.train.adamw import AdamW
from repro_torch.train.loop import make_train_step
from repro_torch.tree import tree_map

N_SHARDS = 8
D_FEAT = 32


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args(argv).device)

    g = apply_order(rgg_graph(2048, seed=3), random_order(rgg_graph(2048, seed=3), 1))
    print(f"graph n={g.n} m={g.m}")

    # --- 1+2: placement quality
    report = placement_report(g, N_SHARDS, D_FEAT, device=str(dev))
    for method, r in report.items():
        print(f"{method:8s} halo={r['halo_MB_per_layer']:.3f} MB/layer "
              f"imbalance={r['load_imbalance']:.3f}")
    if not report["buffcut"]["halo_MB_per_layer"] < report["random"]["halo_MB_per_layer"]:
        raise RuntimeError("BuffCut's placement moves no fewer halo bytes than random's")

    placement = place_graph(g, N_SHARDS, method="buffcut", device=str(dev))
    reorder_for_shards(g, placement)
    print("shard sizes:", np.bincount(placement.block).tolist())

    # --- 3: train GraphSAGE with partition-aware sampling
    cfg = gnn.GraphSAGEConfig(n_layers=2, d_hidden=32, d_in=D_FEAT, n_classes=4,
                              sample_sizes=(8, 4))
    params = tree_map(lambda t: t.to(dev), gnn.sage_init(torch.Generator().manual_seed(0), cfg))
    opt = AdamW(lr=1e-2, warmup_steps=5)
    opt_state = opt.init(params)
    step = make_train_step(lambda p, b: gnn.sage_loss(p, b, cfg), opt)
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.standard_normal((g.n, D_FEAT)).astype(np.float32)).to(dev)
    # geography-correlated labels
    labels = torch.from_numpy((placement.block % 4).astype(np.int32)).to(dev)

    losses = []
    for it in range(30):
        seeds = rng.integers(0, g.n, 64)
        layers = sample_multihop(g, seeds, cfg.sample_sizes, seed=it,
                                 block_of=placement.block)
        batch = {
            "feats": [feats[torch.from_numpy(la).to(dev)] for la in layers],
            "labels": labels[torch.from_numpy(seeds).to(dev)],
        }
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
    cross = cross_block_fraction(g, layers, placement.block)
    print(f"sage loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"cross-shard gather fraction {cross:.3f}")
    if not losses[-1] < losses[0]:
        raise RuntimeError("the loss did not fall")
    print("OK")


if __name__ == "__main__":
    main()
