"""Per-family sharding rules over a `DeviceMesh` (counterpart of
`repro/distributed/sharding.py`).

A rule maps a parameter or batch leaf's path to a spec template over the
logical axes
  dp    — pure data parallel (("pod", "data") on the multi-pod mesh)
  fsdp  — parameter/optimizer sharding axis ("data")
  tp    — tensor parallel axis ("model")
Templates resolve per mesh, so one rule set serves the 16x16 and the
2x16x16 meshes.  A resolved spec is the reference's `PartitionSpec` as a
tuple: one entry a tensor dimension, None (replicated), an axis name, or
a tuple of axis names (the dimension split over several axes, the first
major).  `spec_str` prints it as JAX prints a `PartitionSpec`.

`MeshSharding.placements(shape)` turns a spec into DTensor placements: a
mesh axis that splits tensor dimension d is `Shard(d)`, any other is
`Replicate()`.  A dimension split over two axes gives each rank the block
JAX gives the same device (data-major), because DTensor splits a
dimension over mesh dimensions in mesh order; a spec whose axes run
against the mesh's order is refused.  So is a dimension that its axes do
not divide, as JAX refuses it (DTensor would shard it unevenly); the
batch's fallback to replication is `launch/steps.py::_shardings_with_fallback`.
"""
from __future__ import annotations

import dataclasses
import re

from torch.distributed.device_mesh import DeviceMesh  # repro: noqa RPR001 -- torch-resident module, lazy
from torch.distributed.tensor import Replicate, Shard  # repro: noqa RPR001 -- torch-resident module

from repro_torch.tree import tree_flatten_with_path, tree_unflatten_like


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Ordered (regex, spec template) pairs; first match wins.

    Templates use axis aliases: 'dp' (batch), 'fsdp', 'tp'."""
    params: tuple[tuple[str, tuple], ...]
    batch: tuple[tuple[str, tuple], ...]

    def resolve(self, mesh: DeviceMesh, template: tuple) -> tuple:
        has_pod = "pod" in mesh.mesh_dim_names

        def ax_one(a):
            if a == "dp":
                return ("pod", "data") if has_pod else ("data",)
            if a == "fsdp":
                return ("data",)
            if a == "tp":
                return ("model",)
            return (a,)

        def ax(a):
            if a is None:
                return None
            parts = a if isinstance(a, tuple) else (a,)
            flat = tuple(x for p in parts for x in ax_one(p))
            return flat if len(flat) > 1 else flat[0]

        return tuple(ax(a) for a in template)

    def spec_for(self, mesh: DeviceMesh, kind: str, path: str) -> tuple:
        rules = self.params if kind == "params" else self.batch
        # optimizer states wrap param paths ("m/wq", "v/embed"): match both
        # the full path and the path with the leading component stripped.
        candidates = [path]
        if "/" in path:
            candidates.append(path.split("/", 1)[1])
        for pattern, template in rules:
            for cand in candidates:
                if re.fullmatch(pattern, cand):
                    return self.resolve(mesh, template)
        return ()  # replicate by default


def spec_str(spec: tuple) -> str:
    """The spec as JAX prints the same `PartitionSpec`."""
    return "PartitionSpec(" + ", ".join(repr(a) for a in spec) + \
        ("," if len(spec) == 1 else "") + ")"


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class MeshSharding:
    """A spec on a mesh: the counterpart of a `NamedSharding`."""
    mesh: DeviceMesh
    spec: tuple

    def __str__(self) -> str:
        return spec_str(self.spec)

    def placements(self, shape: tuple | None = None) -> tuple:
        """DTensor placements, one a mesh dimension.  With `shape`, a
        dimension its axes do not divide raises ValueError."""
        names = self.mesh.mesh_dim_names
        out = [Replicate() for _ in names]
        for dim, entry in enumerate(self.spec):
            axes = _axes(entry)
            if not axes:
                continue
            idx = [names.index(a) for a in axes]
            if idx != sorted(idx):
                raise ValueError(f"spec {spec_str(self.spec)} splits dimension {dim} "
                                 f"against the mesh's axis order {names}")
            if shape is not None:
                n = 1
                for i in idx:
                    n *= self.mesh.size(i)
                if shape[dim] % n:
                    raise ValueError(f"dimension {dim} of shape {tuple(shape)} does not "
                                     f"divide over {axes} ({n} ranks)")
            for i in idx:
                out[i] = Shard(dim)
        return tuple(out)


# ---------------------------------------------------------------- LM rules

def lm_sharding_rules(moe: bool = False, head_tp: bool = False,
                      kv_tp: bool = False) -> ShardingRules:
    """FSDP('data') x TP('model') for the transformer zoo.

    Layer-stacked weights (L, in, out): contraction dim sharded over fsdp,
    head/ff output dim over tp (column-parallel), projection back
    row-parallel.  MoE experts shard over tp (expert parallelism).
    head_tp/kv_tp: head-parallel attention for archs whose q / kv head
    counts divide the TP axis; by default attention weights are FSDP only
    and attention compute is sequence-parallel (valid for any head count).
    """
    wq_spec = (None, "fsdp", "tp") if head_tp else (None, "fsdp", None)
    wkv_spec = (None, "fsdp", "tp") if kv_tp else (None, "fsdp", None)
    wo_spec = (None, "tp", "fsdp") if head_tp else (None, None, "fsdp")
    params = [
        (r"embed", (None, "tp")),                   # (V, d)
        (r"unembed", ("fsdp", "tp")),               # (d, V): vocab-parallel logits
        (r"final_norm", (None,)),
        (r"(attn|ffn)_norm", (None, None)),
        (r"wq", wq_spec),                           # (L, d, heads*hd)
        (r"wk|wv", wkv_spec),
        (r"wo", wo_spec),                           # (L, heads*hd, d)
        (r"ffn_w1|ffn_w3", (None, "fsdp", "tp")),   # (L, d, f)
        (r"ffn_w2", (None, "tp", "fsdp")),          # (L, f, d)
        (r"router", (None, "fsdp", None)),          # (L, d, E)
        (r"moe_w1|moe_w3", (None, "tp", "fsdp", None)),  # (L, E, d, f): EP on E
        (r"moe_w2", (None, "tp", None, "fsdp")),    # (L, E, f, d)
        (r"shared_w1|shared_w3", (None, "fsdp", "tp")),
        (r"shared_w2", (None, "tp", "fsdp")),
    ]
    batch = [
        (r"tokens|labels|mask", ("dp", None)),
        # (L, B, S, KV, hd): batch over dp and sequence over the model axis
        (r"cache/(k|v)", (None, "dp", "tp", None, None)),
        (r"cache/pos", ("dp",)),
    ]
    return ShardingRules(params=tuple(params), batch=tuple(batch))


def lm_decode_sharding_rules() -> ShardingRules:
    """Decode: weights sharded over both mesh axes, activations one token.
    Attention projections shard the d_model input dim over 'model'
    (row-parallel) and the output dim over 'data'."""
    base = lm_sharding_rules()
    params = [
        (r"embed", ("fsdp", "tp")),                 # (V, d)
        (r"unembed", ("fsdp", "tp")),
        (r"final_norm", (None,)),
        (r"(attn|ffn)_norm", (None, None)),
        (r"wq|wk|wv", (None, "tp", "fsdp")),        # (L, d, H*hd)
        (r"wo", (None, "fsdp", "tp")),              # (L, H*hd, d)
        (r"ffn_w1|ffn_w3", (None, "fsdp", "tp")),   # (L, d, f)
        (r"ffn_w2", (None, "tp", "fsdp")),
        (r"router", (None, "fsdp", None)),
        (r"moe_w1|moe_w3", (None, "tp", "fsdp", None)),
        (r"moe_w2", (None, "tp", None, "fsdp")),
        (r"shared_w1|shared_w3", (None, "fsdp", "tp")),
        (r"shared_w2", (None, "tp", "fsdp")),
    ]
    return ShardingRules(params=tuple(params), batch=base.batch)


# --------------------------------------------------------------- GNN rules

def gnn_sharding_rules() -> ShardingRules:
    """Node/edge arrays row-sharded over dp (a BuffCut placement decides
    which rows — distributed/gnn_placement.py); small params replicated."""
    params = [
        (r".*", ()),  # GNN weights are tiny: replicate
    ]
    batch = [
        (r"x|coords|target|species|labels|node_mask|graph_id", ("dp",)),
        (r"edge_src|edge_dst|edge_mask|edge_attr", ("dp",)),
        (r"feats/.*", ("dp",)),
    ]
    return ShardingRules(params=tuple(params), batch=tuple(batch))


# -------------------------------------------------------------- DLRM rules

def dlrm_sharding_rules() -> ShardingRules:
    params = [
        (r"tables", (None, ("fsdp", "tp"), None)),  # rows over all devices
        (r"(bot|top)/.*", ()),                      # dense MLPs replicated
    ]
    batch = [
        (r"dense|labels", ("dp",)),
        (r"sparse_idx|sparse_mask", ("dp",)),
        (r"query_.*", ()),
        (r"candidates", ("dp",)),                   # 1M candidates row-sharded
    ]
    return ShardingRules(params=tuple(params), batch=tuple(batch))


# ---------------------------------------------------------------- resolve

def _path_str(path) -> str:
    """A leaf's path as the reference joins it: the port's tree paths are
    already "/"-joined; a sequence of parts is joined here."""
    if isinstance(path, str):
        return path
    return "/".join(str(p) for p in path)


def _fit_rank(spec: tuple, ndim: int) -> tuple:
    """Pad/trim a spec to the leaf's rank."""
    parts = list(spec)
    if len(parts) < ndim:
        parts = parts + [None] * (ndim - len(parts))
    elif len(parts) > ndim:
        parts = parts[:ndim]
    return tuple(parts)


def _shardings(rules: ShardingRules, mesh: DeviceMesh, kind: str, tree):
    leaves = [MeshSharding(mesh, _fit_rank(rules.spec_for(mesh, kind, _path_str(p)), getattr(x, "ndim", 0)))
              for p, x in tree_flatten_with_path(tree)]
    return tree_unflatten_like(tree, leaves)


def param_shardings(rules: ShardingRules, mesh: DeviceMesh, params):
    """A tree like `params` of `MeshSharding`s (leaves: tensors, meta
    tensors or arrays)."""
    return _shardings(rules, mesh, "params", params)


def batch_shardings(rules: ShardingRules, mesh: DeviceMesh, batch):
    return _shardings(rules, mesh, "batch", batch)
