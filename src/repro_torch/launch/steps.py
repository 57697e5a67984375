"""Per-(arch x shape) step construction over a device mesh (counterpart of
`repro/launch/steps.py`).

`build_cell()` returns everything needed to run one cell on one mesh:
  step_fn        the step (train / prefill / decode / serve / retrieval) over
                 DTensors placed by the family's sharding rules
  arg_structs    every argument as a meta tensor (params included: nothing
                 is ever allocated)
  in_shardings / out_shardings / donate
  model_flops    6*N*D (dense) or 6*N_active*D (MoE) for the roofline

Leading batch/node/edge dims that the data-parallel degree does not divide
are padded up (masked padding rows, noted per cell), and a batch dimension
that its axes still do not divide is replicated
(`_shardings_with_fallback`), as in the reference.

`step_cell(cell, mesh, args)` places the arguments by `in_shardings` and
runs the step once under an optional dispatch mode: on real tensors it
computes, with `args=None` it runs on fake tensors under `FakeTensorMode`
(the dry-run's counterpart of the reference's `lower_cell`; nothing is
compiled in either case).  `_GNN_LOSS` and `_GNN_INIT` are the trainers'
tables.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeDef
from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import (
    MeshSharding, ShardingRules, batch_shardings, dlrm_sharding_rules, gnn_sharding_rules,
    lm_decode_sharding_rules, lm_sharding_rules, param_shardings,
)
from repro_torch.launch.mesh import axis_size, dp_size
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import transformer as tfm
from repro_torch.train.adamw import AdamW, AdamWState
from repro_torch.train.loop import value_and_grad
from repro_torch.tree import tree_leaves as _leaves
from repro_torch.tree import tree_map

_GNN_LOSS = {
    "egnn": gnn_mod.egnn_loss,
    "meshgraphnet": gnn_mod.mgn_loss,
    "schnet": gnn_mod.schnet_loss,
    "graphsage-reddit": gnn_mod.sage_loss,
}

_GNN_INIT = {
    "egnn": gnn_mod.egnn_init,
    "meshgraphnet": gnn_mod.mgn_init,
    "schnet": gnn_mod.schnet_init,
    "graphsage-reddit": gnn_mod.sage_init,
}

# dims of each family's cells at smoke size (with `smoke_config()`)
SMOKE_DIMS = {
    "lm": {"batch": 8, "seq": 64},
    "gnn": {"n": 96, "e_dir": 384, "f": 8, "graphs": 4},
    "recsys": {"batch": 32, "candidates": 64},
}

# the config field each GNN's feature width sets
_GNN_DIN = {"egnn": "d_in", "meshgraphnet": "d_node_in", "schnet": None,
            "graphsage-reddit": "d_in"}

_GNN_FLOP_FACTOR = {  # ~flops per (edge + node) unit per layer: 2*d^2-ish
    "egnn": 6, "meshgraphnet": 10, "schnet": 6, "graphsage-reddit": 4,
}


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    kind: str
    step_fn: object
    arg_structs: tuple
    in_shardings: tuple
    out_shardings: object
    donate: tuple
    model_flops: float
    notes: str = ""
    skip: str | None = None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _structs(spec_tree):
    """A tree of `(shape, dtype)` pairs (an arch's `input_specs`) as meta
    tensors."""
    if isinstance(spec_tree, dict):
        return {k: _structs(v) for k, v in spec_tree.items()}
    shape, dtype = spec_tree
    return _meta(shape, dtype)


def _eval_shape(fn, *args):
    """fn's result as meta tensors, computed on fake tensors (no memory)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        out = fn(*args)
    return tree_map(lambda t: _meta(t.shape, t.dtype), out)


def _pad_dim0(struct: torch.Tensor, mult: int) -> torch.Tensor:
    if not struct.shape:
        return struct
    d0 = struct.shape[0]
    target = math.ceil(d0 / mult) * mult
    if target == d0:
        return struct
    return _meta((target, *struct.shape[1:]), struct.dtype)


def _pad_tree_dim0(tree, mult: int):
    return tree_map(lambda s: _pad_dim0(s, mult), tree)


def _shardings_with_fallback(rules: ShardingRules, mesh: DeviceMesh, tree):
    """batch shardings, replicating any dim its axes do not divide."""
    base = batch_shardings(rules, mesh, tree)
    names = mesh.mesh_dim_names

    def fix(struct, sh):
        spec = list(sh.spec) + [None] * (len(struct.shape) - len(sh.spec))
        for i, (dim, ax) in enumerate(zip(struct.shape, spec)):
            if ax is None:
                continue
            n = 1
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                n *= mesh.size(names.index(a))
            if dim % n != 0:
                spec[i] = None  # fallback: replicate this dim
        return MeshSharding(mesh, tuple(spec))

    return tree_map(fix, tree, base)


def _opt_shardings(rules: ShardingRules, mesh: DeviceMesh, opt_struct: AdamWState):
    return AdamWState(**param_shardings(rules, mesh, opt_struct._asdict()))


def _replicated_scalar(x):
    """A scalar result made one replicated value (a DTensor Partial is
    reduced)."""
    if spmd.is_dtensor(x):
        return spmd.with_placements(x, spmd.replicated(x.device_mesh.ndim))
    return x


def _micro_slice(x, i: int, micro: int):
    """Microbatch i of `micro` along dim 0: each rank slices its own rows,
    so a microbatch keeps the batch's layout (on one rank, the global
    slice)."""
    if not spmd.is_dtensor(x):
        mb = x.shape[0] // micro
        return x[i * mb:(i + 1) * mb]
    loc = x.to_local()
    mb = loc.shape[0] // micro
    return spmd.local_out(loc[i * mb:(i + 1) * mb], x.device_mesh, x.placements,
                          (x.shape[0] // micro, *x.shape[1:]))


def _train_step(loss_of, opt: AdamW, micro: int = 1):
    """value_and_grad + AdamW over (params, opt_state, batch), with
    gradient accumulation over `micro` microbatches in float32."""

    def step(params, opt_state, batch):
        if micro == 1:
            loss, grads = value_and_grad(loss_of, params, batch)
        else:
            loss, grads = None, None
            for i in range(micro):
                l_i, g_i = value_and_grad(
                    loss_of, params, tree_map(lambda x: _micro_slice(x, i, micro), batch))
                g_i = tree_map(lambda g: g.to(torch.float32), g_i)
                loss = l_i if loss is None else loss + l_i
                grads = g_i if grads is None else tree_map(torch.add, grads, g_i)
            loss = loss / micro
            grads = tree_map(lambda g: g / micro, grads)
        new_p, new_o, gnorm = opt.update(grads, opt_state, params)
        return new_p, new_o, {"loss": loss, "grad_norm": gnorm}

    return step


@contextlib.contextmanager
def _hooks(cfg, mesh, act=None, attn=None, moe_spec=None):
    tfm.set_activation_sharding(act)
    tfm.set_attn_sharding(attn)
    if cfg.n_experts and moe_spec is not None:
        tfm.set_moe_spmd(mesh, x_spec=moe_spec)
    try:
        yield
    finally:
        tfm.set_activation_sharding(None)
        tfm.set_attn_sharding(None)
        tfm.set_moe_spmd(None)


# =====================================================================
# LM cells
# =====================================================================

def _lm_model_flops(cfg, tokens: int, kind: str) -> float:
    n_active = cfg.active_param_count()
    per_tok = 6.0 * n_active if kind == "train" else 2.0 * n_active
    return per_tok * tokens


def _lm_params_struct(cfg):
    return _eval_shape(lambda: tfm.init_params(torch.Generator(), cfg))


def _build_lm_cell(spec, cfg, shape: ShapeDef, mesh: DeviceMesh,
                   attn_mode: str = "seq") -> Cell:
    """attn_mode: 'seq' (sequence-parallel attention, valid for any head
    count) or 'head_tp' (head-parallel QKVO; needs n_heads % tp == 0; kv
    heads shard only when they divide)."""
    tp = axis_size(mesh, "model")
    head_tp = attn_mode == "head_tp" and cfg.n_heads % tp == 0
    kv_tp = head_tp and cfg.n_kv_heads % tp == 0
    rules = lm_sharding_rules(moe=cfg.n_experts > 0, head_tp=head_tp, kv_tp=kv_tp)
    dp_axes = ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)
    # sequence parallelism: batch over dp, sequence over the TP axis
    seq_spec = (dp_axes, "model", None)
    if head_tp:
        q_spec = (dp_axes, None, "model", None)
        kv_spec = (dp_axes, None, "model" if kv_tp else None, None)
    else:
        # q sequence-sharded over 'model' against k/v batch-sharded only
        q_spec = (dp_axes, "model", None, None)
        kv_spec = (dp_axes, None, None, None)
    seq_pl = MeshSharding(mesh, seq_spec).placements()
    q_pl = MeshSharding(mesh, q_spec).placements()
    kv_pl = MeshSharding(mesh, kv_spec).placements()

    def attn_shard(x, role):
        return spmd.with_placements(x, q_pl if role == "q" else kv_pl)

    def act_shard(x):
        return spmd.with_placements(x, seq_pl) if x.ndim == 3 else x

    params_struct = _lm_params_struct(cfg)
    p_shard = param_shardings(rules, mesh, params_struct)
    batch_struct = _structs(spec.input_specs(cfg, shape))

    if shape.kind == "train":
        opt = AdamW()
        opt_struct = _eval_shape(opt.init, params_struct)
        o_shard = _opt_shardings(rules, mesh, opt_struct)
        b_shard = _shardings_with_fallback(rules, mesh, batch_struct)
        # gradient-accumulation microbatches: activation memory scales 1/m
        micro = 2 if cfg.d_model < 8192 else 8
        step = _train_step(lambda p, b: tfm.loss_fn(p, b, cfg), opt, micro)

        def train_step(params, opt_state, batch):
            with _hooks(cfg, mesh, act_shard, attn_shard, seq_spec):
                new_p, new_o, metrics = step(params, opt_state, batch)
            return new_p, new_o, tree_map(_replicated_scalar, metrics)

        return Cell(
            arch_id=spec.arch_id, shape_name=shape.name, kind="train",
            step_fn=train_step,
            arg_structs=(params_struct, opt_struct, batch_struct),
            in_shardings=(p_shard, o_shard, b_shard),
            out_shardings=(p_shard, o_shard, None),
            donate=(0, 1),
            model_flops=_lm_model_flops(
                cfg, shape.dims["batch"] * shape.dims["seq"], "train"
            ),
        )

    if shape.kind == "prefill":
        # prefill is compute-shaped like training: FSDP weights and
        # sequence-parallel attention
        b_shard = _shardings_with_fallback(rules, mesh, batch_struct)
        max_len = shape.dims["seq"]
        cache_struct = {
            "k": _meta((cfg.n_layers, shape.dims["batch"], max_len, cfg.n_kv_heads,
                        cfg.d_head), cfg.torch_dtype),
            "v": _meta((cfg.n_layers, shape.dims["batch"], max_len, cfg.n_kv_heads,
                        cfg.d_head), cfg.torch_dtype),
            "pos": _meta((shape.dims["batch"],), torch.int32),
        }
        cache_shard = _shardings_with_fallback(rules, mesh, {"cache": cache_struct})["cache"]

        def prefill_step(params, batch):
            with _hooks(cfg, mesh, act_shard, attn_shard, seq_spec):
                logits, cache = tfm.forward_prefill(params, batch["tokens"], cfg, max_len)
            # the cache leaves in the decode layout, never replicated whole
            return logits, _place_like(cache, cache_shard)

        return Cell(
            arch_id=spec.arch_id, shape_name=shape.name, kind="prefill",
            step_fn=prefill_step,
            arg_structs=(params_struct, batch_struct),
            in_shardings=(p_shard, b_shard),
            out_shardings=(None, cache_shard),
            donate=(),
            model_flops=_lm_model_flops(
                cfg, shape.dims["batch"] * shape.dims["seq"], "prefill"
            ),
        )

    # decode (incl. long_500k)
    rules_d = lm_decode_sharding_rules()
    p_shard_d = param_shardings(rules_d, mesh, params_struct)
    b_shard = _shardings_with_fallback(rules_d, mesh, batch_struct)

    def decode_step(params, batch):
        with _hooks(cfg, mesh, moe_spec=(dp_axes, None, None)):  # decode: (B, 1, d)
            logits, cache = tfm.forward_decode(params, batch["tokens"], batch["cache"], cfg)
        return logits, cache

    return Cell(
        arch_id=spec.arch_id, shape_name=shape.name, kind="decode",
        step_fn=decode_step,
        arg_structs=(params_struct, batch_struct),
        in_shardings=(p_shard_d, b_shard),
        out_shardings=(None, b_shard["cache"]),  # the new cache keeps its layout
        donate=(1,),  # the cache is updated in place
        model_flops=_lm_model_flops(cfg, shape.dims["batch"], "decode"),
    )


def _place_like(tree, shardings):
    """DTensor leaves of `tree` redistributed to `shardings`' placements."""
    def place(x, sh):
        if not spmd.is_dtensor(x):
            return x
        return spmd.with_placements(x, sh.placements(tuple(x.shape)))
    return tree_map(place, tree, shardings)


# =====================================================================
# GNN cells
# =====================================================================

def _gnn_model_flops(arch_id: str, cfg, shape: ShapeDef) -> float:
    n, e = shape.dims["n"], shape.dims["e_dir"]
    d = getattr(cfg, "d_hidden", 64)
    layers = getattr(cfg, "n_layers", getattr(cfg, "n_interactions", 3))
    # message MLP ~ 2*d^2 per edge, node MLP ~ 2*d^2 per node, x3 for bwd
    return 3.0 * layers * (e + n) * 2.0 * d * d * _GNN_FLOP_FACTOR[arch_id] / 4.0


def _gathered_loss(loss_fn):
    """A GNN loss over a row-sharded batch: segment sums and edge gathers
    have no DTensor rule, so the node and edge arrays are gathered whole
    (what GSPMD emits for the same formulation) and every rank computes
    the loss on the whole graph; `sage_fullgraph_halo_loss` is the
    formulation that moves only the cut's frontier."""

    def loss(params, batch):
        leaves = [x for x in list(params.values()) + list(batch.values())
                  if spmd.is_dtensor(x)]
        if not leaves:
            return loss_fn(params, batch)
        mesh = leaves[0].device_mesh
        repl = spmd.replicated(mesh.ndim)

        def local(x):
            return spmd.local_in(x, repl) if spmd.is_dtensor(x) else x

        out = loss_fn(tree_map(local, params), tree_map(local, batch))
        return spmd.local_out(out, mesh, repl, ())

    return loss


def _build_gnn_cell(spec, cfg, shape: ShapeDef, mesh: DeviceMesh) -> Cell:
    rules = gnn_sharding_rules()
    f = shape.dims["f"]
    din_field = _GNN_DIN[spec.arch_id]
    if din_field is not None:
        cfg = dataclasses.replace(cfg, **{din_field: f})
    if spec.arch_id == "graphsage-reddit":
        n_cls = 41 if shape.name == "minibatch_lg" else 47
        cfg = dataclasses.replace(cfg, n_classes=n_cls)

    params_struct = _eval_shape(lambda: _GNN_INIT[spec.arch_id](torch.Generator(), cfg))
    p_shard = param_shardings(rules, mesh, params_struct)
    dp = dp_size(mesh)
    batch_struct = _pad_tree_dim0(_structs(spec.input_specs(cfg, shape)), dp)
    b_shard = _shardings_with_fallback(rules, mesh, batch_struct)

    n_graphs = shape.dims.get("graphs", 1)
    loss_base = _GNN_LOSS[spec.arch_id]

    def loss_fn(p, b):
        if spec.arch_id == "schnet":
            b = dict(b)
            b["n_graphs"] = max(math.ceil(n_graphs / dp) * dp, dp) if n_graphs > 1 else 1
        return loss_base(p, b, cfg)

    opt = AdamW()
    opt_struct = _eval_shape(opt.init, params_struct)
    o_shard = _opt_shardings(rules, mesh, opt_struct)
    step = _train_step(_gathered_loss(loss_fn), opt)

    def train_step(params, opt_state, batch):
        new_p, new_o, metrics = step(params, opt_state, batch)
        return new_p, new_o, tree_map(_replicated_scalar, metrics)

    return Cell(
        arch_id=spec.arch_id, shape_name=shape.name, kind="train",
        step_fn=train_step,
        arg_structs=(params_struct, opt_struct, batch_struct),
        in_shardings=(p_shard, o_shard, b_shard),
        out_shardings=(p_shard, o_shard, None),
        donate=(0, 1),
        model_flops=_gnn_model_flops(spec.arch_id, cfg, shape),
        notes=f"leading dims padded to multiples of dp={dp}",
    )


# =====================================================================
# DLRM cells
# =====================================================================

def _dlrm_model_flops(cfg, shape: ShapeDef) -> float:
    b = shape.dims.get("batch", 1)
    mlp = 0
    sizes = (cfg.n_dense,) + cfg.bot_mlp
    mlp += sum(2 * a * o for a, o in zip(sizes, sizes[1:]))
    d_top = cfg.n_interact + cfg.embed_dim
    sizes = (d_top,) + cfg.top_mlp
    mlp += sum(2 * a * o for a, o in zip(sizes, sizes[1:]))
    interact = 2 * (cfg.n_sparse + 1) ** 2 * cfg.embed_dim
    factor = 3.0 if shape.kind == "train" else 1.0
    flops = factor * b * (mlp + interact)
    if shape.kind == "retrieval":
        flops += 2.0 * shape.dims["candidates"] * cfg.embed_dim
    return flops


def _build_dlrm_cell(spec, cfg, shape: ShapeDef, mesh: DeviceMesh) -> Cell:
    rules = dlrm_sharding_rules()
    params_struct = _eval_shape(lambda: dlrm_mod.dlrm_init(torch.Generator(), cfg))
    p_shard = param_shardings(rules, mesh, params_struct)
    batch_struct = _structs(spec.input_specs(cfg, shape))
    b_shard = _shardings_with_fallback(rules, mesh, batch_struct)

    if shape.kind == "train":
        opt = AdamW()
        opt_struct = _eval_shape(opt.init, params_struct)
        o_shard = _opt_shardings(rules, mesh, opt_struct)
        step = _train_step(lambda p, b: dlrm_mod.dlrm_loss(p, b, cfg), opt)

        def train_step(params, opt_state, batch):
            new_p, new_o, metrics = step(params, opt_state, batch)
            return new_p, new_o, tree_map(_replicated_scalar, metrics)

        return Cell(
            arch_id=spec.arch_id, shape_name=shape.name, kind="train",
            step_fn=train_step,
            arg_structs=(params_struct, opt_struct, batch_struct),
            in_shardings=(p_shard, o_shard, b_shard),
            out_shardings=(p_shard, o_shard, None),
            donate=(0, 1),
            model_flops=_dlrm_model_flops(cfg, shape),
        )

    if shape.kind == "retrieval":
        def retrieval_step(params, batch):
            return dlrm_mod.dlrm_retrieval(params, batch, cfg)
        fn = retrieval_step
    else:
        def serve_step(params, batch):
            return dlrm_mod.dlrm_forward(params, batch, cfg)
        fn = serve_step

    return Cell(
        arch_id=spec.arch_id, shape_name=shape.name, kind=shape.kind,
        step_fn=fn,
        arg_structs=(params_struct, batch_struct),
        in_shardings=(p_shard, b_shard),
        out_shardings=None,
        donate=(),
        model_flops=_dlrm_model_flops(cfg, shape),
    )


# =====================================================================
# dispatch
# =====================================================================

def build_cell(arch_id: str, shape_name: str, mesh: DeviceMesh, *, unroll: bool = False,
               cfg_override=None, attn_mode: str = "seq", dims_override=None) -> Cell:
    """`unroll` is the reference's switch for XLA's layer scan; the port's
    layers are a Python loop, so every layer is always seen, and it only
    sets `scan_unroll` as the reference does.  `cfg_override` replaces the
    arch config entirely; `dims_override` replaces some of the shape's
    dims (a cell at smoke size)."""
    spec = get_arch(arch_id)
    shape = spec.shapes[shape_name]
    if dims_override:
        shape = dataclasses.replace(shape, dims={**shape.dims, **dims_override})
    if shape.skip:
        return Cell(
            arch_id=arch_id, shape_name=shape_name, kind=shape.kind,
            step_fn=None, arg_structs=(), in_shardings=(), out_shardings=None,
            donate=(), model_flops=0.0, skip=shape.skip,
        )
    cfg = cfg_override if cfg_override is not None else spec.full_config()
    if spec.family == "lm":
        if unroll and cfg_override is None:
            cfg = dataclasses.replace(cfg, scan_unroll=cfg.n_layers)
        return _build_lm_cell(spec, cfg, shape, mesh, attn_mode=attn_mode)
    if spec.family == "gnn":
        return _build_gnn_cell(spec, cfg, shape, mesh)
    if spec.family == "recsys":
        return _build_dlrm_cell(spec, cfg, shape, mesh)
    raise ValueError(spec.family)


def place_args(cell: Cell, mesh: DeviceMesh, args) -> tuple:
    """Each argument leaf (a tensor the same on every rank) as a DTensor
    on `mesh` under `cell.in_shardings`; each rank keeps its own block."""
    def place(x, sh):
        if spmd.is_dtensor(x):
            return spmd.with_placements(x, sh.placements(tuple(x.shape)))
        return distribute_tensor(x.to(mesh.device_type), mesh,
                                 sh.placements(tuple(x.shape)), src_data_rank=None)
    return tuple(tree_map(place, a, s) for a, s in zip(args, cell.in_shardings))


def _fake_args(cell: Cell, device: str) -> tuple:
    return tuple(tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device=device), a)
                 for a in cell.arg_structs)


def step_cell(cell: Cell, mesh: DeviceMesh, args=None, *, mode=None):
    """Run the cell's step once on `mesh` and return its outputs.

    `args`: the step's arguments as tensors, the same on every rank
    (placed here), or already-placed DTensors.  With `args=None` the step
    runs on fake tensors of the cell's shapes under `FakeTensorMode`: no
    memory is allocated and nothing computes, as a lowering computes
    nothing.  `mode`: a context manager entered around the step (e.g. the
    step analysis's counters)."""
    from torch.distributed.tensor.experimental import implicit_replication

    if cell.skip:
        raise ValueError(f"{cell.arch_id} x {cell.shape_name} is skipped: {cell.skip}")
    fake = contextlib.nullcontext()
    if args is None:
        from torch._subclasses.fake_tensor import FakeTensorMode

        fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        if args is None:
            args = _fake_args(cell, mesh.device_type)
        placed = place_args(cell, mesh, args)
        if hasattr(mode, "track"):  # count the arguments' local shards as live
            mode.track([x.to_local() if spmd.is_dtensor(x) else x
                        for a in placed for x in _leaves(a)])
        with implicit_replication(), (mode if mode is not None else contextlib.nullcontext()):
            return cell.step_fn(*placed)


def full_value(x):
    """A DTensor's global value on every rank (a plain tensor passes)."""
    return x.full_tensor() if isinstance(x, DTensor) else x
