"""The port's device mesh against the reference's, on the CPU: sharding
rules, local shards, the ring collective matmul, `quantized_psum`, the
expert-parallel MoE, the halo-exchange GraphSAGE loss and elastic
resharding.

Multi-rank cases run once a module: a script spawns 4 gloo ranks (a (2, 2)
mesh, and the world group for the ring and the int8 all-reduce) and 2
ranks (the (1, 2) and (2, 1) meshes), while the reference runs in a
subprocess with `XLA_FLAGS=--xla_force_host_platform_device_count=4` on
meshes from `repro.launch.mesh.make_host_mesh` under `jax.jit`.  Inputs
are drawn here from numpy seeds and handed to both as one npz file; each
side writes its results to files the tests read.  One-rank cases run in
this process on a world of one, which each fixture destroys."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
ARCHS = ("llama4-scout-17b-a16e", "moonshot-v1-16b-a3b", "stablelm-3b", "command-r-plus-104b",
         "h2o-danube-1.8b", "egnn", "meshgraphnet", "schnet", "graphsage-reddit",
         "dlrm-mlperf")
SHARD_MESHES = ((2, 2), (1, 2), (2, 1))


# ---------------------------------------------------------------- inputs

def _make_inputs(path: Path) -> None:
    """Every multi-rank case's inputs, drawn from numpy seeds (weights from
    the port's initialisers with a seeded generator)."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.gnn_placement import assemble_halo_batch, halo_batch
    from repro_torch.graphs import grid_mesh_graph
    from repro_torch.models import dlrm as dlrm_mod
    from repro_torch.models import gnn
    from repro_torch.models import transformer as tfm

    rng = np.random.default_rng(0)
    out: dict = {}
    moon = get_arch("moonshot-v1-16b-a3b").smoke_config()
    for k, v in tfm.init_params(torch.Generator().manual_seed(1), moon).items():
        out[f"lm/{k}"] = v.float().numpy()
    dl = get_arch("dlrm-mlperf").smoke_config()
    out["dlrm/tables"] = dlrm_mod.dlrm_init(torch.Generator().manual_seed(2), dl)[
        "tables"].numpy()
    out["batch/tokens"] = rng.integers(0, 512, (3, 32)).astype(np.int32)   # 3 rows: fallback
    out["batch/labels"] = rng.integers(0, 512, (3, 32)).astype(np.int32)
    out["gnnb/x"] = rng.standard_normal((50, 6)).astype(np.float32)        # 50 rows: 4 fall back
    out["ring/x"] = rng.standard_normal((16, 8)).astype(np.float32)
    out["ring/w"] = rng.standard_normal((8, 5)).astype(np.float32)
    out["qpsum/x"] = (rng.standard_normal((4, 37)) * rng.uniform(0.1, 10, (4, 1))).astype(
        np.float32)
    out["moe/x3"] = rng.standard_normal((4, 8, moon.d_model)).astype(np.float32)
    g = grid_mesh_graph(10)
    block = rng.integers(0, 8, g.n)
    hb = halo_batch(g, block, 4, rng.standard_normal((g.n, 5)).astype(np.float32),
                    rng.integers(0, 3, g.n).astype(np.int32))
    for k, v in hb.items():
        if k not in ("node", "n_shards"):
            out[f"halo/{k}"] = v
    for k, v in assemble_halo_batch(hb).items():
        out[f"halo_whole/{k}"] = v
    sage = gnn.GraphSAGEConfig(n_layers=2, d_hidden=8, d_in=5, n_classes=3)
    for name, sub in gnn.sage_init(torch.Generator().manual_seed(3), sage).items():
        for k, v in sub.items():
            out[f"sage/{name}/{k}"] = v.numpy()
    np.savez(path, **out)


# ------------------------------------------------------------- reference

REF_SCRIPT = r'''
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[1])
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.configs import get_arch
from repro.launch.mesh import make_host_mesh
from repro.launch import steps as rsteps
from repro.distributed import sharding as rs
from repro.distributed.overlap import collective_matmul_allgather, allgather_matmul_reference
from repro.distributed.compression import quantized_psum, quantize_int8
from repro.models import transformer as tfm, gnn, dlrm
from repro.train.adamw import AdamW

out_dir = sys.argv[2]
inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
res, specs = {}, {}

def path_str(path):
    return rs._path_str(path)

def family_rules(spec, cfg):
    if spec.family == "lm":
        return {"lm": rs.lm_sharding_rules(moe=cfg.n_experts > 0),
                "lm_decode": rs.lm_decode_sharding_rules()}
    if spec.family == "gnn":
        return {"gnn": rs.gnn_sharding_rules()}
    return {"dlrm": rs.dlrm_sharding_rules()}

def init_struct(spec, cfg):
    key = jax.random.PRNGKey(0)
    if spec.family == "lm":
        return jax.eval_shape(lambda: tfm.init_params(key, cfg))
    if spec.family == "gnn":
        return jax.eval_shape(lambda: rsteps._GNN_INIT[spec.arch_id](key, cfg))
    return jax.eval_shape(lambda: dlrm.dlrm_init(key, cfg))

for shape in ((1, 1), (2, 2)):
    mesh = make_host_mesh(*shape)
    for arch in %(archs)r:
        spec = get_arch(arch)
        cfg = spec.smoke_config()
        params = init_struct(spec, cfg)
        opt = jax.eval_shape(AdamW().init, params)._asdict()
        for rname, rules in family_rules(spec, cfg).items():
            for kind, tree in (("params", params), ("opt", opt)):
                sh = rs.param_shardings(rules, mesh, tree)
                for p, s in jax.tree_util.tree_flatten_with_path(sh)[0]:
                    specs[f"{arch}|{rname}|{kind}|{shape[0]}x{shape[1]}|{path_str(p)}"] = str(s.spec)

# local shards on the (2, 2), (1, 2) and (2, 1) meshes
def shard_cases(mesh):
    lm = {k[3:]: v for k, v in inp.items() if k.startswith("lm/")}
    cases = {}
    for rname, rules in (("lm", rs.lm_sharding_rules(moe=True)),
                         ("lm_decode", rs.lm_decode_sharding_rules())):
        sh = rs.param_shardings(rules, mesh, lm)
        for k in lm:
            cases[f"{rname}/{k}"] = (lm[k], sh[k])
    tab = inp["dlrm/tables"]
    cases["dlrm/tables"] = (tab, rs.param_shardings(rs.dlrm_sharding_rules(), mesh,
                                                    {"tables": tab})["tables"])
    batch = {"tokens": inp["batch/tokens"], "labels": inp["batch/labels"]}
    bs = rsteps._shardings_with_fallback(
        rs.lm_sharding_rules(), mesh,
        {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in batch.items()})
    for k in batch:
        cases[f"batch/{k}"] = (batch[k], bs[k])
    x = inp["gnnb/x"]
    gs = rsteps._shardings_with_fallback(rs.gnn_sharding_rules(), mesh,
                                         {"x": jax.ShapeDtypeStruct(x.shape, x.dtype)})
    cases["gnnb/x"] = (x, gs["x"])
    return cases

for shape in %(shard_meshes)r:
    mesh = make_host_mesh(*shape)
    grid = mesh.devices
    for name, (arr, sh) in shard_cases(mesh).items():
        specs[f"shard_spec|{name}|{shape[0]}x{shape[1]}"] = str(sh.spec)
        placed = jax.device_put(arr, sh)
        by_dev = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
        for i in range(grid.shape[0]):
            for j in range(grid.shape[1]):
                res[f"shard|{name}|{shape[0]}x{shape[1]}|{i}|{j}"] = by_dev[grid[i, j]]

# ring matmul and quantized_psum over a 4-device axis
mesh = make_host_mesh(1, 4)
x, w = inp["ring/x"], inp["ring/w"]
f1 = shard_map(lambda xl, w: collective_matmul_allgather(xl, w, "model"), mesh=mesh,
               in_specs=(P("model"), P()), out_specs=P("model"), check_rep=False)
f2 = shard_map(lambda xl, w: allgather_matmul_reference(xl, w, "model"), mesh=mesh,
               in_specs=(P("model"), P()), out_specs=P("model"), check_rep=False)
res["ring/out"] = np.asarray(f1(x, w))
res["ring/ref"] = np.asarray(f2(x, w))
xq = inp["qpsum/x"]
def qbody(xl):
    q, s = quantize_int8(xl[0])
    return q[None], s[None], quantized_psum(xl[0], "model")[None]
fq = shard_map(qbody, mesh=mesh, in_specs=(P("model"),),
               out_specs=(P("model"), P("model"), P("model")), check_rep=False)
q, s, tot = fq(xq)
res["qpsum/q"], res["qpsum/scale"], res["qpsum/sum"] = map(np.asarray, (q, s, tot))

# the expert-parallel MoE on a (2, 2) mesh
cfg0 = get_arch("moonshot-v1-16b-a3b").smoke_config()
layer = {k[3:]: v[0] for k, v in inp.items() if k.startswith("lm/") and k[3:] in (
    "router", "moe_w1", "moe_w2", "moe_w3", "shared_w1", "shared_w2", "shared_w3")}
x3 = inp["moe/x3"]
mesh = make_host_mesh(2, 2)
for tag, cf in (("default", cfg0.capacity_factor), ("cf64", 64.0)):
    import dataclasses
    cfg = dataclasses.replace(cfg0, capacity_factor=cf)
    tfm.set_moe_spmd(mesh, x_spec=P(("data",), "model", None))
    res[f"moe/{tag}/out"] = np.asarray(jax.jit(lambda x, l: tfm.moe_ffn(x, l, cfg))(x3, layer))
    tfm.set_moe_spmd(None)
    b, s_len, d = x3.shape
    t_loc = b * s_len // 4
    cap_loc = tfm._moe_cap(t_loc, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    kept = []
    for i in range(2):
        for j in range(2):
            xl = x3[i * b // 2:(i + 1) * b // 2, j * s_len // 2:(j + 1) * s_len // 2]
            fs, ft, fw, keep = tfm._moe_dispatch(jnp.asarray(xl.reshape(-1, d)),
                                                 layer["router"], cfg.n_experts,
                                                 cfg.top_k, cap_loc)
            res[f"moe/{tag}/slot|{i}|{j}"] = np.asarray(fs)
            res[f"moe/{tag}/keep|{i}|{j}"] = np.asarray(keep)
            kept.append(np.asarray(keep).mean())
    res[f"moe/{tag}/kept"] = np.asarray(np.mean(kept))
    res[f"moe/{tag}/cap_loc"] = np.asarray(cap_loc)

# the halo loss on 4 dp ranks, jitted value_and_grad on an Auto-axes mesh
sage_cfg = gnn.GraphSAGEConfig(n_layers=2, d_hidden=8, d_in=5, n_classes=3)
params = {}
for k, v in inp.items():
    if k.startswith("sage/"):
        _, a, b_ = k.split("/")
        params.setdefault(a, {})[b_] = v
batch = {k[5:]: v for k, v in inp.items() if k.startswith("halo/")}
mesh = make_host_mesh(4, 1)
f = jax.jit(jax.value_and_grad(
    lambda p, b: gnn.sage_fullgraph_halo_loss(p, b, sage_cfg, mesh, ("data",))))
loss, grads = f(params, batch)
res["halo/loss"] = np.asarray(loss)
for a in grads:
    for b_ in grads[a]:
        res[f"halo/grad/{a}/{b_}"] = np.asarray(grads[a][b_])

np.savez(os.path.join(out_dir, "ref.npz"), **res)
with open(os.path.join(out_dir, "ref_specs.json"), "w") as fh:
    json.dump(specs, fh)
'''


# ------------------------------------------------------------------ port

PORT_SCRIPT = r'''
import dataclasses, os, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[5])
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def lm_host(inp):
    return {k[3:]: v for k, v in inp.items() if k.startswith("lm/")}


def shard_cases(mesh, inp):
    from repro_torch.distributed import sharding as rs
    from repro_torch.launch import steps
    lm = lm_host(inp)
    cases = {}
    for rname, rules in (("lm", rs.lm_sharding_rules(moe=True)),
                         ("lm_decode", rs.lm_decode_sharding_rules())):
        sh = rs.param_shardings(rules, mesh, lm)
        for k in lm:
            cases[f"{rname}/{k}"] = (lm[k], sh[k])
    tab = inp["dlrm/tables"]
    cases["dlrm/tables"] = (tab, rs.param_shardings(rs.dlrm_sharding_rules(), mesh,
                                                    {"tables": tab})["tables"])
    batch = {"tokens": inp["batch/tokens"], "labels": inp["batch/labels"]}
    meta = {k: torch.empty(v.shape, dtype=torch.int32, device="meta") for k, v in batch.items()}
    bs = steps._shardings_with_fallback(rs.lm_sharding_rules(), mesh, meta)
    for k in batch:
        cases[f"batch/{k}"] = (batch[k], bs[k])
    x = inp["gnnb/x"]
    gs = steps._shardings_with_fallback(rs.gnn_sharding_rules(), mesh,
                                        {"x": torch.empty(x.shape, device="meta")})
    cases["gnnb/x"] = (x, gs["x"])
    return cases


def local_shards(mesh, inp, out):
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.train.elastic import reshard_state
    shape = "x".join(str(mesh.size(i)) for i in range(mesh.ndim))
    i, j = mesh.get_coordinate()
    for name, (arr, sh) in shard_cases(mesh, inp).items():
        out[f"shard_spec|{name}|{shape}"] = str(sh)
        t = torch.from_numpy(arr)
        d = distribute_tensor(t, mesh, sh.placements(t.shape), src_data_rank=None)
        out[f"shard|{name}|{shape}|{i}|{j}"] = d.to_local().numpy()
    # elastic: the same host state resharded onto this mesh reads back whole
    from repro_torch.distributed.sharding import lm_sharding_rules
    state = reshard_state(lm_host(inp), lm_sharding_rules(moe=True), mesh)
    out[f"elastic_ok|{shape}"] = all(
        np.array_equal(state[k].full_tensor().numpy(), v) for k, v in lm_host(inp).items())


def four(inp, out):
    from repro_torch.configs import get_arch
    from repro_torch.distributed import sharding as rs
    from repro_torch.distributed.compression import quantize_int8, quantized_psum
    from repro_torch.distributed.overlap import (allgather_matmul_reference,
                                                 collective_matmul_allgather)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import gnn
    from repro_torch.models import transformer as tfm
    from repro_torch.train.elastic import reshard_state
    from repro_torch.train.loop import value_and_grad
    from torch.distributed.tensor import distribute_tensor
    rank = dist.get_rank()
    mesh = make_host_mesh(2, 2, device="cpu")
    local_shards(mesh, inp, out)
    # the ring over the world group, rows in rank order
    world = dist.group.WORLD
    xb = torch.from_numpy(inp["ring/x"]).chunk(4)[rank].contiguous()
    w = torch.from_numpy(inp["ring/w"])
    out["ring/out"] = collective_matmul_allgather(xb, w, world).numpy()
    out["ring/ag"] = allgather_matmul_reference(xb, w, world).numpy()
    xq = torch.from_numpy(inp["qpsum/x"][rank])
    q, s = quantize_int8(xq)
    out["qpsum/q"], out["qpsum/scale"] = q.numpy(), s.numpy()
    out["qpsum/sum"] = quantized_psum(xq, world).numpy()
    # the expert-parallel MoE on the (2, 2) mesh
    cfg0 = get_arch("moonshot-v1-16b-a3b").smoke_config()
    x3 = torch.from_numpy(inp["moe/x3"])
    i, j = mesh.get_coordinate()
    for tag, cf in (("default", cfg0.capacity_factor), ("cf64", 64.0)):
        cfg = dataclasses.replace(cfg0, capacity_factor=cf)
        params = reshard_state(lm_host(inp), rs.lm_sharding_rules(moe=True), mesh)
        layer = {k: v[0] for k, v in params.items() if k in (
            "router", "moe_w1", "moe_w2", "moe_w3", "shared_w1", "shared_w2", "shared_w3")}
        spec = (("data",), "model", None)
        xd = distribute_tensor(x3, mesh, rs.MeshSharding(mesh, spec).placements(),
                               src_data_rank=None)
        tfm.set_moe_spmd(mesh, x_spec=spec)
        try:
            y = tfm.moe_ffn(xd, layer, cfg)
            cap_loc = tfm._moe_spmd_layout(x3.shape, cfg)[-1]
        finally:
            tfm.set_moe_spmd(None)
        out[f"moe/{tag}/out"] = y.full_tensor().numpy()
        xl = xd.to_local()
        fs, ft, fw, keep = tfm._moe_dispatch(xl.reshape(-1, xl.shape[-1]),
                                             layer["router"].full_tensor(), cfg.n_experts,
                                             cfg.top_k, cap_loc)
        out[f"moe/{tag}/slot|{i}|{j}"] = fs.numpy()
        out[f"moe/{tag}/keep|{i}|{j}"] = keep.numpy()
        out[f"moe/{tag}/cap_loc"] = cap_loc
    # the halo loss on 4 dp ranks; the DTensor batch keeps each rank's rows
    hmesh = make_host_mesh(4, 1, device="cpu")
    sage_cfg = gnn.GraphSAGEConfig(n_layers=2, d_hidden=8, d_in=5, n_classes=3)
    params = {}
    for k, v in inp.items():
        if k.startswith("sage/"):
            _, a, b = k.split("/")
            params.setdefault(a, {})[b] = torch.from_numpy(v)
    batch = {k[5:]: torch.from_numpy(v) for k, v in inp.items() if k.startswith("halo/")}
    shard = rs.MeshSharding(hmesh, (("data",),))
    batch = {k: distribute_tensor(v, hmesh, shard.placements(v.shape), src_data_rank=None)
             for k, v in batch.items()}
    loss, grads = value_and_grad(
        lambda p, b: gnn.sage_fullgraph_halo_loss(p, b, sage_cfg, hmesh, ("data",)),
        params, batch)
    out["halo/loss"] = loss.numpy()
    for a in grads:
        for b in grads[a]:
            out[f"halo/grad/{a}/{b}"] = grads[a][b].numpy()
    # the same plain parameters as DTensors (replicated): the same gradients
    pd = {a: {b: distribute_tensor(v, hmesh, rs.MeshSharding(hmesh, ()).placements(),
                                   src_data_rank=None) for b, v in sub.items()}
          for a, sub in params.items()}
    loss_d, grads_d = value_and_grad(
        lambda p, b: gnn.sage_fullgraph_halo_loss(p, b, sage_cfg, hmesh, ("data",)),
        pd, batch)
    whole = lambda x: x.full_tensor() if hasattr(x, "full_tensor") else x  # noqa: E731
    out["halo/loss_dtensor"] = whole(loss_d).numpy()
    for a in grads_d:
        for b in grads_d[a]:
            out[f"halo/grad_dtensor/{a}/{b}"] = whole(grads_d[a][b]).numpy()
    # train cells on the (2, 2) mesh against the plain step on one rank,
    # then head-parallel attention on (2, 2) (kv heads split too) and on
    # (1, 4) (4 q heads split, 2 kv heads not: each rank indexes its kv head)
    train_cells(mesh, out)
    train_cells(mesh, out, head_tp=True)
    train_cells(make_host_mesh(1, 4, device="cpu"), out, head_tp=True)
    # the spec strings at (2, 2)
    if rank == 0:
        out["specs"] = spec_strings(mesh, sys.argv[4].split(","))


def train_cells(mesh, out, head_tp=False):
    """A train cell's step on the mesh and the same step on whole plain
    tensors: loss, gradient norm and the largest parameter difference.
    The LM at 2 x 32 tokens takes the FSDP matmul, at 2 x 2 (one token a
    rank and microbatch) the gathered-token one."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import SMOKE_DIMS, _train_step, build_cell, full_value, step_cell
    from repro_torch.models import dlrm as dlrm_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.train.adamw import AdamW
    from repro_torch.tree import tree_leaves, tree_map
    cases = (("stablelm-3b", {"batch": 4, "seq": 32}), ("stablelm-3b", {"batch": 4, "seq": 2}),
             ("moonshot-v1-16b-a3b", {"batch": 4, "seq": 32}), ("dlrm-mlperf", None))
    if head_tp:
        cases = (("h2o-danube-1.8b", {"batch": 4, "seq": 32}),)
    shape_name = "x".join(str(mesh.size(i)) for i in range(mesh.ndim))
    for arch, dims in cases:
        spec = get_arch(arch)
        cfg = spec.smoke_config()
        if spec.family == "lm":
            cfg = dataclasses.replace(cfg, capacity_factor=64.0)
        shape = "train_4k" if spec.family == "lm" else "train_batch"
        cell = build_cell(arch, shape, mesh, cfg_override=cfg,
                          dims_override=dims or SMOKE_DIMS[spec.family],
                          attn_mode="head_tp" if head_tp else "seq")
        g = torch.Generator().manual_seed(0)
        if spec.family == "lm":
            params = tfm.init_params(g, cfg)
            s = cell.arg_structs[2]["tokens"].shape
            batch = {k: torch.randint(0, cfg.vocab, s, generator=g, dtype=torch.int32)
                     for k in ("tokens", "labels")}
            loss_of, micro = (lambda p, b: tfm.loss_fn(p, b, cfg)), 2
        else:
            params = dlrm_mod.dlrm_init(g, cfg)
            from repro_torch.configs.dlrm_mlperf import draw_batch
            batch = draw_batch(cfg, cell.arg_structs[2]["dense"].shape[0], seed=3)
            loss_of, micro = (lambda p, b: dlrm_mod.dlrm_loss(p, b, cfg)), 1
        opt = AdamW()
        st = opt.init(params)
        new_p, _, m = step_cell(cell, mesh, (params, st, batch))
        ref_p, _, rm = _train_step(loss_of, opt, micro)(params, st, batch)
        tag = f"train/{arch}/{dims['seq'] if dims else 0}"
        if head_tp:
            tag = f"train/{arch}/head_tp/{shape_name}"
        out[tag] = (float(full_value(m["loss"])), float(rm["loss"]),
                    float(full_value(m["grad_norm"])), float(rm["grad_norm"]),
                    max(float((full_value(a) - b).abs().max())
                        for a, b in zip(tree_leaves(new_p), tree_leaves(ref_p))))


from test_torch_distributed import spec_strings  # noqa: E402  (tests/ is on the path)


def two(inp, out):
    from repro_torch.launch.mesh import make_host_mesh
    for shape in ((1, 2), (2, 1)):
        local_shards(make_host_mesh(*shape, device="cpu"), inp, out)


def worker(rank, world, out_dir):
    dist.init_process_group("gloo", init_method="file://" + os.path.join(out_dir, f"pg{world}"),
                            rank=rank, world_size=world)
    inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    out = {}
    try:
        (four if world == 4 else two)(inp, out)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"port{world}_{rank}.pt"))


if __name__ == "__main__":
    world = int(sys.argv[3])
    mp.spawn(worker, args=(world, sys.argv[2]), nprocs=world)
'''


def spec_strings(mesh, archs) -> dict:
    """{arch|rules|params-or-opt|mesh|path: spec string} of every parameter
    and AdamW-state leaf of the archs' smoke configs under each rule set of
    their family (the port's side of the reference's table)."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed import sharding as rs
    from repro_torch.launch import steps
    from repro_torch.models import dlrm
    from repro_torch.models import transformer as tfm
    from repro_torch.train.adamw import AdamW
    from repro_torch.tree import tree_flatten_with_path

    shape = "x".join(str(mesh.size(i)) for i in range(mesh.ndim))
    out = {}
    for arch in archs:
        spec = get_arch(arch)
        cfg = spec.smoke_config()
        if spec.family == "lm":
            params = steps._eval_shape(lambda: tfm.init_params(torch.Generator(), cfg))
            rules = {"lm": rs.lm_sharding_rules(moe=cfg.n_experts > 0),
                     "lm_decode": rs.lm_decode_sharding_rules()}
        elif spec.family == "gnn":
            params = steps._eval_shape(lambda: steps._GNN_INIT[arch](torch.Generator(), cfg))
            rules = {"gnn": rs.gnn_sharding_rules()}
        else:
            params = steps._eval_shape(lambda: dlrm.dlrm_init(torch.Generator(), cfg))
            rules = {"dlrm": rs.dlrm_sharding_rules()}
        opt = steps._eval_shape(AdamW().init, params)._asdict()
        for rname, r in rules.items():
            for kind, tree in (("params", params), ("opt", opt)):
                for p, s in tree_flatten_with_path(rs.param_shardings(r, mesh, tree)):
                    out[f"{arch}|{rname}|{kind}|{shape}|{p}"] = str(s)
    return out


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the reference and both port spawns at once; return their
    results: (reference arrays, reference spec strings, port results by
    world and rank)."""
    d = tmp_path_factory.mktemp("mesh")
    _make_inputs(d / "inputs.npz")
    (d / "ref.py").write_text(REF_SCRIPT % {"archs": ARCHS, "shard_meshes": SHARD_MESHES})
    (d / "port.py").write_text(PORT_SCRIPT)
    procs = [subprocess.Popen([sys.executable, str(d / "ref.py"), str(SRC), str(d)],
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)]
    for world in (4, 2):
        procs.append(subprocess.Popen(
            [sys.executable, str(d / "port.py"), str(SRC), str(d), str(world), ",".join(ARCHS),
             str(Path(__file__).parent)],
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for p in procs:
        text = p.communicate(timeout=300)[0].decode()
        assert p.returncode == 0, text[-4000:]
    ref = dict(np.load(d / "ref.npz"))
    specs = json.loads((d / "ref_specs.json").read_text())
    port = {w: [torch.load(d / f"port{w}_{r}.pt", weights_only=False) for r in range(w)]
            for w in (4, 2)}
    return ref, specs, port, dict(np.load(d / "inputs.npz"))


@pytest.fixture
def world_of_one():
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world_of_one

    init_world_of_one("cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ rules

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", ["1x1", "2x2"])
def test_spec_strings_match_reference(runs, arch, mesh, world_of_one):
    """Every parameter and AdamW-state leaf resolves to the reference's
    PartitionSpec, under each rule set of the arch's family."""
    _, ref_specs, port, _ = runs
    if mesh == "1x1":
        from repro_torch.launch.mesh import make_host_mesh

        mine = spec_strings(make_host_mesh(1, 1, device="cpu"), [arch])
    else:
        mine = port[4][0]["specs"]
    want = {k: v for k, v in ref_specs.items() if k.startswith(f"{arch}|") and f"|{mesh}|" in k}
    got = {k: v for k, v in mine.items() if k.startswith(f"{arch}|") and f"|{mesh}|" in k}
    assert want and got == want


def _shard_names(ref):
    return sorted({k.split("|")[1] for k in ref if k.startswith("shard|")})


@pytest.mark.parametrize("mesh", ["2x2", "1x2", "2x1"])
def test_local_shards_match_reference(runs, mesh):
    """Each rank's block equals the reference's addressable shard at the
    same mesh coordinate: the two-axis table rows, the 4-D expert weights
    and the batch dims that do not divide (replicated)."""
    ref, ref_specs, port, _ = runs
    ranks = port[4] if mesh == "2x2" else port[2]
    n = 0
    for name in _shard_names(ref):
        for out in ranks:
            for k, v in out.items():
                if k.startswith(f"shard|{name}|{mesh}|"):
                    np.testing.assert_array_equal(v, ref[k], err_msg=k)
                    n += 1
        assert ranks[0][f"shard_spec|{name}|{mesh}"] == ref_specs[f"shard_spec|{name}|{mesh}"]
    assert n == len([k for k in ref if k.startswith("shard|") and f"|{mesh}|" in k])
    # the fallback really replicated 3 token rows over 2 data ranks
    if mesh[0] == "2":
        assert ref_specs[f"shard_spec|batch/tokens|{mesh}"] == "PartitionSpec(None, None)"


def test_two_axis_rows_are_data_major(runs):
    """The DLRM tables' rows split over ('data', 'model'): rank (i, j) holds
    block 2i + j, as JAX gives device (i, j)."""
    ref, _, port, _ = runs
    blocks = {}
    for out in port[4]:
        for k, v in out.items():
            if k.startswith("shard|dlrm/tables|2x2|"):
                _, _, _, i, j = k.split("|")
                blocks[2 * int(i) + int(j)] = v
    whole = np.concatenate([blocks[b] for b in range(4)], axis=1)
    ref_whole = np.concatenate([ref[f"shard|dlrm/tables|2x2|{b // 2}|{b % 2}"]
                                for b in range(4)], axis=1)
    np.testing.assert_array_equal(whole, ref_whole)


def test_lm_rules_cover_all_params(world_of_one):
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import lm_sharding_rules, param_shardings
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import tree_leaves

    mesh = make_host_mesh(1, 1, device="cpu")
    for arch in ("stablelm-3b", "moonshot-v1-16b-a3b"):
        cfg = get_arch(arch).smoke_config()
        params = steps._eval_shape(lambda: tfm.init_params(torch.Generator(), cfg))
        sh = param_shardings(lm_sharding_rules(moe=cfg.n_experts > 0), mesh, params)
        assert len(tree_leaves(sh)) == len(tree_leaves(params))


def test_opt_state_paths_match_param_rules(world_of_one):
    """m/<param> and v/<param> resolve to the same spec as <param>."""
    from repro_torch.distributed.sharding import lm_sharding_rules
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(1, 1, device="cpu")
    rules = lm_sharding_rules()
    assert rules.spec_for(mesh, "params", "m/wq") == rules.spec_for(mesh, "params", "wq")
    assert rules.spec_for(mesh, "params", "v/embed") == rules.spec_for(mesh, "params", "embed")


def test_decode_rules_fully_shard_weights(world_of_one):
    from repro_torch.distributed.sharding import lm_decode_sharding_rules, spec_str
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(1, 1, device="cpu")
    r = lm_decode_sharding_rules()
    for name in ("ffn_w1", "wq", "wo", "embed"):
        spec = spec_str(r.spec_for(mesh, "params", name))
        assert "data" in spec and "model" in spec, (name, spec)


def test_placements_refuse_what_jax_refuses(world_of_one):
    """A dimension its axes do not divide, or axes against the mesh's
    order, raise instead of sharding unevenly."""
    from repro_torch.distributed.sharding import MeshSharding
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(1, 1, device="cpu")
    assert MeshSharding(mesh, (None, ("data", "model"))).placements((3, 5))
    with pytest.raises(ValueError, match="mesh's axis order"):
        MeshSharding(mesh, (("model", "data"),)).placements((4,))


# ----------------------------------------------------------- collectives

def test_collective_matmul_bit_equal_to_allgather_version(runs):
    for out in runs[2][4]:
        np.testing.assert_array_equal(out["ring/out"], out["ring/ag"])


def test_collective_matmul_matches_reference(runs):
    ref, _, port, _ = runs
    np.testing.assert_allclose(ref["ring/out"], ref["ring/ref"], rtol=1e-5)
    for r, out in enumerate(port[4]):   # the reference stacks each device's product
        want = ref["ring/out"][r * 16:(r + 1) * 16]
        np.testing.assert_allclose(out["ring/out"], want, rtol=1e-5, atol=1e-6)


def test_quantized_psum_matches_reference(runs):
    """The int8 payload and the scales are the reference's bit for bit; the
    sum is within rtol 1e-6 on every rank."""
    ref, _, port, _ = runs
    for r, out in enumerate(port[4]):
        np.testing.assert_array_equal(out["qpsum/q"], ref["qpsum/q"][r])
        np.testing.assert_array_equal(out["qpsum/scale"], ref["qpsum/scale"][r])
        np.testing.assert_allclose(out["qpsum/sum"], ref["qpsum/sum"][r], rtol=1e-6,
                                   atol=1e-6 * np.abs(ref["qpsum/sum"]).max())


# -------------------------------------------------------------------- MoE

@pytest.mark.parametrize("tag", ["default", "cf64"])
def test_expert_parallel_moe_matches_reference(runs, tag):
    """On a (2, 2) mesh each shard sizes its capacity from its own tokens;
    at the default capacity tokens are dropped on both sides, at capacity
    factor 64 none; the logits and every shard's slots and keep agree."""
    ref, _, port, _ = runs
    kept_port = np.mean([out[f"moe/{tag}/keep|{i}|{j}"].mean()
                         for out in port[4] for i in (0, 1) for j in (0, 1)
                         if f"moe/{tag}/keep|{i}|{j}" in out])
    if tag == "default":
        assert float(ref[f"moe/{tag}/kept"]) < 1.0 and kept_port < 1.0
    else:
        assert float(ref[f"moe/{tag}/kept"]) == 1.0 and kept_port == 1.0
    assert port[4][0][f"moe/{tag}/cap_loc"] == int(ref[f"moe/{tag}/cap_loc"])
    for out in port[4]:
        np.testing.assert_allclose(out[f"moe/{tag}/out"], ref[f"moe/{tag}/out"],
                                   rtol=1e-5, atol=1e-5)
        for k, v in out.items():
            if k.startswith(f"moe/{tag}/slot|") or k.startswith(f"moe/{tag}/keep|"):
                np.testing.assert_array_equal(v, ref[k], err_msg=k)


# ------------------------------------------------------------------- halo

@pytest.mark.parametrize("params_as", ["tensor", "dtensor"])
def test_halo_loss_matches_reference_and_whole_graph(runs, params_as):
    """At 4 ranks the loss and every parameter gradient are within rtol 1e-5
    of the reference's jitted value_and_grad, and of `sage_loss` on the
    assembled graph in one process (so the gradients are whole sums, not
    one rank's part), with the parameters as plain tensors or as
    replicated DTensors."""
    from repro_torch.models import gnn
    from repro_torch.train.loop import value_and_grad

    ref, _, port, inp = runs
    suffix = "" if params_as == "tensor" else "_dtensor"
    cfg = gnn.GraphSAGEConfig(n_layers=2, d_hidden=8, d_in=5, n_classes=3)
    params: dict = {}
    for k, v in inp.items():
        if k.startswith("sage/"):
            _, a, b = k.split("/")
            params.setdefault(a, {})[b] = torch.from_numpy(v)
    whole = {k[11:]: torch.from_numpy(v) for k, v in inp.items()
             if k.startswith("halo_whole/")}
    loss, grads = value_and_grad(lambda p, b: gnn.sage_loss(p, b, cfg), params, whole)
    np.testing.assert_allclose(loss.numpy(), ref["halo/loss"], rtol=1e-5)
    for out in port[4]:
        np.testing.assert_allclose(out[f"halo/loss{suffix}"], ref["halo/loss"], rtol=1e-5)
        np.testing.assert_allclose(out[f"halo/loss{suffix}"], loss.numpy(), rtol=1e-5)
        n = 0
        for k in ref:
            if k.startswith("halo/grad/"):
                _, _, a, b = k.split("/")
                got = out[f"halo/grad{suffix}/{a}/{b}"]
                np.testing.assert_allclose(got, ref[k], rtol=1e-5, atol=1e-7, err_msg=k)
                np.testing.assert_allclose(got, grads[a][b].numpy(), rtol=1e-5, atol=1e-7,
                                           err_msg=k)
                n += 1
        assert n == 10


def test_halo_batch_reassembles_the_graph():
    """Every message of the graph appears once in the halo layout, and the
    frontier holds exactly the nodes with a neighbour in another block."""
    from repro_torch.distributed.gnn_placement import assemble_halo_batch, halo_batch
    from repro_torch.graphs import grid_mesh_graph

    g = grid_mesh_graph(9)
    rng = np.random.default_rng(5)
    block = rng.integers(0, 6, g.n)
    hb = halo_batch(g, block, 3, np.zeros((g.n, 2), np.float32), np.zeros(g.n, np.int32))
    whole = assemble_halo_batch(hb)
    node, m = hb["node"], whole["edge_mask"] > 0
    got = sorted(zip(node[whole["edge_src"][m]].tolist(), node[whole["edge_dst"][m]].tolist()))
    src = np.repeat(np.arange(g.n), np.diff(g.indptr))
    assert got == sorted(zip(src.tolist(), g.indices.tolist()))
    n_loc = hb["x"].shape[0] // 3
    hf_loc = hb["frontier_own"].shape[0] // 3
    owner_rows = [s * n_loc + r for s in range(3)
                  for r in hb["frontier_own"][s * hf_loc:(s + 1) * hf_loc]]
    front = {int(node[r]) for r in owner_rows if node[r] >= 0}
    cross = {int(u) for u, v in zip(src, g.indices) if block[u] != block[v]}
    assert cross <= front and front <= cross | {int(node[r]) for r in owner_rows[:1]}


# ------------------------------------------------------------ train cells

@pytest.mark.parametrize("tag", ["stablelm-3b/32", "stablelm-3b/2", "moonshot-v1-16b-a3b/32",
                                 "dlrm-mlperf/0", "h2o-danube-1.8b/head_tp/2x2",
                                 "h2o-danube-1.8b/head_tp/1x4"])
def test_train_cell_on_the_mesh_equals_the_plain_step(runs, tag):
    """A train cell's step on the (2, 2) mesh (FSDP x sequence parallelism,
    the expert-parallel MoE at capacity factor 64, the row-split DLRM
    tables) gives the plain step's loss and gradient norm, and parameters
    within 1e-6: the gradients are whole sums on every rank."""
    for out in runs[2][4]:
        loss, want_loss, gnorm, want_gnorm, dparam = out[f"train/{tag}"]
        assert loss == pytest.approx(want_loss, rel=1e-6)
        assert gnorm == pytest.approx(want_gnorm, rel=1e-5)
        assert dparam <= 1e-6


# ---------------------------------------------------------------- elastic

@pytest.mark.parametrize("mesh", ["2x2", "1x2", "2x1"])
def test_elastic_reshard_returns_the_host_arrays(runs, mesh):
    ranks = runs[2][4] if mesh == "2x2" else runs[2][2]
    assert all(out[f"elastic_ok|{mesh}"] for out in ranks)


def test_elastic_reshard_and_batch_math_on_one_rank(world_of_one):
    """The reference's elastic test: resharding a host state onto (1, 1)
    returns it, and the per-shard batch is the global one."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import lm_sharding_rules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.train.elastic import dp_degree, per_shard_batch, reshard_state

    cfg = get_arch("stablelm-3b").smoke_config()
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    host = {k: v.numpy() for k, v in params.items()}
    mesh = make_host_mesh(1, 1, device="cpu")
    out = reshard_state(host, lm_sharding_rules(), mesh)
    for k, v in params.items():
        assert torch.equal(out[k].full_tensor(), v)
    assert per_shard_batch(256, mesh) == 256 and dp_degree(mesh) == 1
