"""GNN zoo: EGNN, MeshGraphNet, SchNet, GraphSAGE (counterpart of
`repro/models/gnn.py`).

Message passing runs over an explicit edge index (src, dst): gather ->
compute -> segment sum (`index_add`; neither torch_scatter nor
torch_geometric is used).  All shapes are static: padding edges point at
valid nodes and carry mask 0.

Each model keeps the reference's functional form, `*_init(gen, cfg)`,
`*_apply(params, batch, cfg)` and `*_loss`, over dicts of tensors with
`(fan_in, fan_out)` weights; `init` draws from the generator on its
device.  The batch dict always carries
  x         (N, F)   node features
  edge_src  (E,)     int32
  edge_dst  (E,)     int32
  edge_mask (E,)     float, 0 for padding edges
plus model-specific extras (coords, edge features, targets...).

Where the reference differs from torch's defaults, the reference wins:
- JAX drops out-of-range segment ids and clamps gathers; here each apply
  checks its edge, species and graph ids once and raises on one out of
  range (labels are the caller's to keep in range, as in
  `cross_entropy_loss`: the sampled GraphSAGE step never waits on the
  card).
- GraphSAGE normalises by `sqrt(sum(h * h))`, whose gradient on an
  all-zero row is NaN as `jnp.linalg.norm`'s is (ROADMAP, Known states);
  `torch.linalg.vector_norm` would give 0 there.
- softplus is `logaddexp(x, 0)`, as `jax.nn.softplus`, with no switch to
  the identity above 20.
- `sage_init` gives `self_{i}` and `nbr_{i}` the same start, as the
  reference, which passes one key to both.
Segment sums on a card use float atomics, so their last bits vary from
run to run; no label depends on them.

`sage_fullgraph_halo_loss` (a shard_map over a device mesh) waits for the
port's collectives (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import mlp_apply, mlp_init


def _check_index(ids: torch.Tensor, n: int, what: str) -> None:
    if ids.numel() and bool(((ids < 0) | (ids >= n)).any()):
        raise IndexError(f"{what} holds an index outside [0, {n})")


def _segment_sum(data: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    return data.new_zeros((n, *data.shape[1:])).index_add(0, ids, data)


def _segment_mean(data, ids, n, mask=None):
    if mask is not None:
        data = data * mask[:, None]
        ones = mask
    else:
        ones = torch.ones(data.shape[0], dtype=data.dtype, device=data.device)
    tot = _segment_sum(data, ids, n)
    cnt = _segment_sum(ones, ids, n)
    return tot / torch.clamp(cnt, min=1.0)[:, None]


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean of `data`'s rows per segment (masked rows weigh 0; an empty
    segment gives 0)."""
    _check_index(segment_ids, num_segments, "segment_ids")
    return _segment_mean(data, segment_ids.long(), num_segments, mask)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _edges(batch: dict, n: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    src, dst = batch["edge_src"], batch["edge_dst"]
    _check_index(src, n, "edge_src")
    _check_index(dst, n, "edge_dst")
    return src.long(), dst.long(), batch["edge_mask"]


def _masked_mean(err: torch.Tensor, batch: dict) -> torch.Tensor:
    nm = batch.get("node_mask")
    if nm is not None:
        return (err * nm).sum() / torch.clamp(nm.sum(), min=1.0)
    return err.mean()


# =====================================================================
# EGNN [Satorras et al., arXiv:2102.09844]: E(n)-equivariant
# =====================================================================

@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    name: str = "egnn"
    n_layers: int = 4
    d_hidden: int = 64
    d_in: int = 16
    d_coord: int = 3
    d_out: int = 1


def egnn_init(gen: torch.Generator, cfg: EGNNConfig) -> dict:
    h = cfg.d_hidden
    params: dict = {
        "embed": mlp_init(gen, [cfg.d_in, h]),
        "readout": mlp_init(gen, [h, h, cfg.d_out]),
    }
    for i in range(cfg.n_layers):
        params[f"edge_{i}"] = mlp_init(gen, [2 * h + 1, h, h])
        params[f"coord_{i}"] = mlp_init(gen, [h, h, 1])
        params[f"node_{i}"] = mlp_init(gen, [2 * h, h, h])
    return params


def egnn_apply(params: dict, batch: dict, cfg: EGNNConfig):
    x = batch["coords"]                       # (N, 3)
    n = x.shape[0]
    src, dst, emask = _edges(batch, n)
    h = mlp_apply(params["embed"], batch["x"])
    for i in range(cfg.n_layers):
        diff = x[src] - x[dst]                 # (E, 3)
        d2 = torch.sum(diff * diff, dim=-1, keepdim=True)
        m = mlp_apply(
            params[f"edge_{i}"], torch.cat([h[src], h[dst], d2], dim=-1), act=F.silu,
        ) * emask[:, None]
        # coordinate update (normalized difference * scalar gate)
        gate = mlp_apply(params[f"coord_{i}"], m, act=F.silu)
        # sqrt(d2 + eps): the bare sqrt has an infinite gradient at
        # coincident nodes (self-loop padding edges hit this exactly)
        upd = diff / (torch.sqrt(d2 + 1e-8) + 1.0) * gate * emask[:, None]
        x = x + _segment_sum(upd, dst, n) / torch.clamp(
            _segment_sum(emask, dst, n), min=1.0)[:, None]
        agg = _segment_sum(m, dst, n)
        h = h + mlp_apply(params[f"node_{i}"], torch.cat([h, agg], dim=-1), act=F.silu)
    out = mlp_apply(params["readout"], h)
    return out, x


def egnn_loss(params: dict, batch: dict, cfg: EGNNConfig) -> torch.Tensor:
    pred, _ = egnn_apply(params, batch, cfg)
    return _masked_mean(torch.square(pred - batch["target"]).sum(-1), batch)


# =====================================================================
# MeshGraphNet [Pfaff et al., arXiv:2010.03409]
# =====================================================================

@dataclasses.dataclass(frozen=True)
class MeshGraphNetConfig:
    name: str = "meshgraphnet"
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    d_node_in: int = 8
    d_edge_in: int = 4
    d_out: int = 3


def _mgn_mlp_sizes(cfg: MeshGraphNetConfig, d_in: int) -> list[int]:
    return [d_in] + [cfg.d_hidden] * cfg.mlp_layers


def mgn_init(gen: torch.Generator, cfg: MeshGraphNetConfig) -> dict:
    h = cfg.d_hidden
    params: dict = {
        "node_enc": mlp_init(gen, _mgn_mlp_sizes(cfg, cfg.d_node_in)),
        "edge_enc": mlp_init(gen, _mgn_mlp_sizes(cfg, cfg.d_edge_in)),
        "decoder": mlp_init(gen, [h, h, cfg.d_out]),
    }
    for i in range(cfg.n_layers):
        params[f"edge_{i}"] = mlp_init(gen, _mgn_mlp_sizes(cfg, 3 * h))
        params[f"node_{i}"] = mlp_init(gen, _mgn_mlp_sizes(cfg, 2 * h))
    return params


def mgn_apply(params: dict, batch: dict, cfg: MeshGraphNetConfig) -> torch.Tensor:
    n = batch["x"].shape[0]
    src, dst, emask = _edges(batch, n)
    h = mlp_apply(params["node_enc"], batch["x"], act=torch.relu)
    e = mlp_apply(params["edge_enc"], batch["edge_attr"], act=torch.relu)
    for i in range(cfg.n_layers):
        e_new = mlp_apply(
            params[f"edge_{i}"], torch.cat([e, h[src], h[dst]], dim=-1), act=torch.relu,
        )
        e = e + e_new * emask[:, None]
        agg = _segment_sum(e * emask[:, None], dst, n)  # sum aggregator
        h = h + mlp_apply(params[f"node_{i}"], torch.cat([h, agg], dim=-1), act=torch.relu)
    return mlp_apply(params["decoder"], h)


def mgn_loss(params: dict, batch: dict, cfg: MeshGraphNetConfig) -> torch.Tensor:
    pred = mgn_apply(params, batch, cfg)
    return _masked_mean(torch.square(pred - batch["target"]).sum(-1), batch)


# =====================================================================
# SchNet [Schütt et al., arXiv:1706.08566]
# =====================================================================

@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    n_species: int = 32
    d_out: int = 1


def schnet_init(gen: torch.Generator, cfg: SchNetConfig) -> dict:
    h = cfg.d_hidden
    embed = torch.randn((cfg.n_species, h), generator=gen, dtype=torch.float32,
                        device=gen.device) * 0.1
    params: dict = {
        "species_embed": embed,
        "readout": mlp_init(gen, [h, h // 2, cfg.d_out]),
    }
    for i in range(cfg.n_interactions):
        params[f"filter_{i}"] = mlp_init(gen, [cfg.n_rbf, h, h])
        params[f"in_{i}"] = mlp_init(gen, [h, h])
        params[f"out_{i}"] = mlp_init(gen, [h, h, h])
    return params


def _rbf_expand(dist: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    centers = torch.linspace(0.0, cutoff, n_rbf, dtype=dist.dtype, device=dist.device)
    gamma = 10.0 / cutoff
    return torch.exp(-gamma * torch.square(dist[:, None] - centers[None, :]))


def schnet_apply(params: dict, batch: dict, cfg: SchNetConfig) -> torch.Tensor:
    coords = batch["coords"]
    n = coords.shape[0]
    src, dst, emask = _edges(batch, n)
    species = batch["species"]
    _check_index(species, params["species_embed"].shape[0], "species")
    h = params["species_embed"][species.long()]
    dist = torch.sqrt(torch.sum(torch.square(coords[src] - coords[dst]), dim=-1) + 1e-12)
    rbf = _rbf_expand(dist, cfg.n_rbf, cfg.cutoff)
    # smooth cutoff envelope
    env = 0.5 * (torch.cos(math.pi * torch.clamp(dist / cfg.cutoff, 0, 1)) + 1.0)
    w_cut = env * emask
    for i in range(cfg.n_interactions):
        filt = mlp_apply(params[f"filter_{i}"], rbf, act=_softplus)  # (E, h)
        x = mlp_apply(params[f"in_{i}"], h)
        msg = x[src] * filt * w_cut[:, None]   # cfconv
        agg = _segment_sum(msg, dst, n)
        h = h + mlp_apply(params[f"out_{i}"], agg, act=_softplus)
    return mlp_apply(params["readout"], h)


def schnet_loss(params: dict, batch: dict, cfg: SchNetConfig) -> torch.Tensor:
    pred = schnet_apply(params, batch, cfg)
    # molecule-level energy: sum node contributions per graph, then MSE
    graph_id, n_graphs = batch["graph_id"], int(batch["n_graphs"])
    _check_index(graph_id, n_graphs, "graph_id")
    energy = _segment_sum(pred[:, 0], graph_id.long(), n_graphs)
    return torch.mean(torch.square(energy - batch["target"]))


# =====================================================================
# GraphSAGE [Hamilton et al., arXiv:1706.02216]: mean aggregator
# =====================================================================

@dataclasses.dataclass(frozen=True)
class GraphSAGEConfig:
    name: str = "graphsage"
    n_layers: int = 2
    d_hidden: int = 128
    d_in: int = 602
    n_classes: int = 41
    sample_sizes: tuple[int, ...] = (25, 10)


def sage_init(gen: torch.Generator, cfg: GraphSAGEConfig) -> dict:
    """`self_{i}` and `nbr_{i}` start equal: the reference draws both from
    one key."""
    params: dict = {}
    d_prev = cfg.d_in
    for i in range(cfg.n_layers):
        params[f"self_{i}"] = mlp_init(gen, [d_prev, cfg.d_hidden])
        params[f"nbr_{i}"] = {k: v.clone() for k, v in params[f"self_{i}"].items()}
        d_prev = cfg.d_hidden
    params["classify"] = mlp_init(gen, [cfg.d_hidden, cfg.n_classes])
    return params


def _unit_rows(h: torch.Tensor) -> torch.Tensor:
    """h / max(||h||, 1e-6) row by row; the norm as sqrt(sum(h * h)), whose
    gradient at an all-zero row is NaN, as the reference's."""
    norm = torch.sqrt(torch.sum(h * h, dim=-1, keepdim=True))
    return h / torch.clamp(norm, min=1e-6)


def sage_apply_fullgraph(params: dict, batch: dict, cfg: GraphSAGEConfig) -> torch.Tensor:
    """Full-graph mode: aggregate over the edge index."""
    h = batch["x"]
    n = h.shape[0]
    src, dst, emask = _edges(batch, n)
    for i in range(cfg.n_layers):
        agg = _segment_mean(h[src], dst, n, emask)
        h = torch.relu(
            mlp_apply(params[f"self_{i}"], h) + mlp_apply(params[f"nbr_{i}"], agg)
        )
        h = _unit_rows(h)
    return mlp_apply(params["classify"], h)


def sage_apply_sampled(params: dict, batch: dict, cfg: GraphSAGEConfig) -> torch.Tensor:
    """Sampled mode: layered feature tensors from the fanout sampler.

    batch["feats"] is a list of (B * prod(fanouts[:h]), F) feature tensors,
    deepest hop last (graphs/sampler.py layout).
    """
    fanouts = cfg.sample_sizes
    hs = list(batch["feats"])
    for i in range(cfg.n_layers):
        nxt = []
        for depth in range(len(hs) - 1):
            parent, child = hs[depth], hs[depth + 1]
            f = fanouts[depth] if depth < len(fanouts) else fanouts[-1]
            agg = child.reshape(parent.shape[0], f, -1).mean(dim=1)
            nh = torch.relu(
                mlp_apply(params[f"self_{i}"], parent) + mlp_apply(params[f"nbr_{i}"], agg)
            )
            nxt.append(_unit_rows(nh))
        hs = nxt
    return mlp_apply(params["classify"], hs[0])


def sage_loss(params: dict, batch: dict, cfg: GraphSAGEConfig) -> torch.Tensor:
    if "feats" in batch:
        logits = sage_apply_sampled(params, batch, cfg)
    else:
        logits = sage_apply_fullgraph(params, batch, cfg)
    labels = batch["labels"]
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None].long())[:, 0]
    return _masked_mean(logz - gold, batch)
