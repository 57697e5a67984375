"""The port's launch layer against the reference's: the cell builder on a
(1, 1) mesh for all 40 cells at full width, the step runner at world one
against the plain functions, the per-rank step analysis, the production
mesh, and the dry-run on a fake 4-rank group (in subprocesses: the fake
group is process-wide).  One-rank cases run on a world of one (gloo)
that each fixture destroys."""
import dataclasses
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


@pytest.fixture
def world_of_one():
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world_of_one

    init_world_of_one("cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ref_cells():
    """The reference's `build_cell` for every cell at full width on a
    (1, 1) mesh: kind, skip, notes, model flops and padded argument
    shapes by path."""
    import jax

    from repro.configs import all_cells
    from repro.distributed.sharding import _path_str
    from repro.launch.steps import build_cell

    mesh = jax.make_mesh((1, 1), ("data", "model"))
    out = {}
    for arch, shape in all_cells():
        cell = build_cell(arch, shape, mesh)
        args = {}
        for i, tree in enumerate(cell.arg_structs):
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
                args[f"{i}/{_path_str(path)}"] = (tuple(leaf.shape), str(leaf.dtype))
        out[(arch, shape)] = (cell.kind, cell.skip, cell.notes, cell.model_flops, args)
    return out


def _cells():
    from repro_torch.configs import all_cells

    return all_cells()


@pytest.mark.parametrize("arch,shape", _cells())
def test_cell_matches_reference(ref_cells, world_of_one, arch, shape):
    """kind, skip, notes, padded argument shapes and dtypes, and model
    flops equal the reference's `build_cell` at full width on (1, 1)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.tree import tree_flatten_with_path

    cell = build_cell(arch, shape, make_host_mesh(1, 1, device="cpu"))
    kind, skip, notes, flops, args = ref_cells[(arch, shape)]
    assert (cell.kind, cell.skip, cell.notes) == (kind, skip, notes)
    assert cell.model_flops == pytest.approx(flops, rel=1e-12)
    got = {}
    for i, tree in enumerate(cell.arg_structs):
        for path, leaf in tree_flatten_with_path(tree):
            assert leaf.device.type == "meta", (path, leaf.device)  # nothing allocated
            got[f"{i}/{path}"] = (tuple(leaf.shape), str(leaf.dtype).removeprefix("torch."))
    assert got == args


def test_registry_cell_count():
    from repro_torch.configs import all_cells, get_arch

    cells = all_cells()
    assert len(cells) == 40  # 5 LM x 4 + 4 GNN x 4 + 1 recsys x 4
    skips = [(a, s) for a, s in cells if get_arch(a).shapes[s].skip]
    assert len(skips) == 4
    assert all(s == "long_500k" for _, s in skips)
    assert ("h2o-danube-1.8b", "long_500k") not in skips


def test_input_specs_are_abstract():
    """input_specs never allocate: every leaf is a (shape, dtype) pair."""
    from repro_torch.configs import ARCHS

    def leaves(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                yield from leaves(v)
        else:
            yield tree

    for arch_id, spec in ARCHS.items():
        cfg = spec.full_config()
        for sname, shape in spec.shapes.items():
            if shape.skip:
                continue
            for leaf in leaves(spec.input_specs(cfg, shape)):
                shp, dtype = leaf
                assert isinstance(shp, tuple) and isinstance(dtype, torch.dtype), (arch_id, sname)


def test_build_cell_on_host_mesh(world_of_one):
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell

    mesh = make_host_mesh(1, 1, device="cpu")
    cell = build_cell("graphsage-reddit", "molecule", mesh)
    assert cell.kind == "train"
    assert cell.model_flops > 0
    cell2 = build_cell("llama4-scout-17b-a16e", "long_500k", mesh)
    assert cell2.skip  # documented inapplicability


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_requires_its_devices(world_of_one, multi_pod):
    from repro_torch.launch.mesh import make_production_mesh

    with pytest.raises(ValueError, match="devices"):
        make_production_mesh(multi_pod=multi_pod, device="cpu")


def test_mesh_refuses_a_group_of_the_other_backend(world_of_one):
    """NCCL for cuda, gloo for cpu: a cuda mesh on the gloo group raises."""
    from repro_torch.launch.mesh import make_host_mesh

    with pytest.raises(RuntimeError, match="nccl"):
        make_host_mesh(1, 1, device="cuda")


def test_host_mesh_clamps_to_the_world(world_of_one):
    from repro_torch.launch.mesh import dp_size, make_host_mesh

    mesh = make_host_mesh(4, 4, device="cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert (mesh.size(0), mesh.size(1)) == (1, 1) and dp_size(mesh) == 1


def test_no_mesh_without_a_group():
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_world_of_one"):
        make_host_mesh(1, 1, device="cpu")


# ------------------------------------------------------------ step runner

def _smoke_cell(arch, shape, mesh, **cfg_changes):
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import SMOKE_DIMS, build_cell

    spec = get_arch(arch)
    cfg = dataclasses.replace(spec.smoke_config(), **cfg_changes)
    return cfg, build_cell(arch, shape, mesh, cfg_override=cfg,
                           dims_override=SMOKE_DIMS[spec.family])


def test_lm_prefill_and_decode_cells_equal_plain_at_world_one(world_of_one):
    """h2o-danube (sliding window) at smoke size: the prefill cell's logits
    and cache and four decode steps of the decode cell equal plain
    `forward_prefill` / `forward_decode` bit for bit."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import full_value, step_cell
    from repro_torch.models import transformer as tfm

    mesh = make_host_mesh(1, 1, device="cpu")
    cfg, pre = _smoke_cell("h2o-danube-1.8b", "prefill_32k", mesh)
    _, dec = _smoke_cell("h2o-danube-1.8b", "decode_32k", mesh)
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 24))
                            .astype(np.int32))
    max_len = 64
    logits, cache = step_cell(pre, mesh, (params, {"tokens": toks}))
    want, want_cache = tfm.forward_prefill(params, toks, cfg, max_len)
    assert torch.equal(full_value(logits), want)
    for k in ("k", "v", "pos"):
        assert torch.equal(full_value(cache[k]), want_cache[k]), k
    tok = want.argmax(-1).to(torch.int32)
    mesh_cache = {k: full_value(v).clone() for k, v in cache.items()}
    for _ in range(4):
        lg, mesh_cache = step_cell(dec, mesh, (params, {"tokens": tok, "cache": mesh_cache}))
        mesh_cache = {k: full_value(v) for k, v in mesh_cache.items()}
        wl, want_cache = tfm.forward_decode(params, tok, want_cache, cfg)
        assert torch.equal(full_value(lg), wl)
        tok = wl.argmax(-1).to(torch.int32)
    for k in ("k", "v", "pos"):
        assert torch.equal(mesh_cache[k], want_cache[k]), k


def test_expert_parallel_moe_at_one_rank_equals_one_device(world_of_one):
    """At (1, 1) the expert-parallel MoE sees every token, so its capacity
    is the one-device layer's and the two agree bit for bit."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import lm_sharding_rules
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.train.elastic import reshard_state
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed.sharding import MeshSharding

    mesh = make_host_mesh(1, 1, device="cpu")
    cfg = get_arch("moonshot-v1-16b-a3b").smoke_config()
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    layer = {k: v[0] for k, v in params.items() if v.dim() > 1 and k != "embed"
             and k != "unembed"}
    x3 = torch.randn((2, 16, cfg.d_model), generator=torch.Generator().manual_seed(1))
    want = tfm.moe_ffn(x3, layer, cfg)
    placed = reshard_state({k: v.numpy() for k, v in params.items()}, lm_sharding_rules(True),
                           mesh)
    dlayer = {k: v[0] for k, v in placed.items() if k in layer}
    spec = (("data",), "model", None)
    xd = distribute_tensor(x3, mesh, MeshSharding(mesh, spec).placements(), src_data_rank=None)
    tfm.set_moe_spmd(mesh, x_spec=spec)
    try:
        got = tfm.moe_ffn(xd, dlayer, cfg).full_tensor()
    finally:
        tfm.set_moe_spmd(None)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", ["serve_p99", "retrieval_cand"])
def test_dlrm_cells_equal_plain_at_world_one(world_of_one, shape):
    from repro_torch.configs.dlrm_mlperf import draw_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import full_value, step_cell
    from repro_torch.models import dlrm as dlrm_mod

    mesh = make_host_mesh(1, 1, device="cpu")
    cfg, cell = _smoke_cell("dlrm-mlperf", shape, mesh)
    params = dlrm_mod.dlrm_init(torch.Generator().manual_seed(0), cfg)
    if shape == "serve_p99":
        batch = {k: v for k, v in draw_batch(cfg, 32, seed=1).items() if k != "labels"}
        want = dlrm_mod.dlrm_forward(params, batch, cfg)
    else:
        b = draw_batch(cfg, 1, seed=1)
        batch = {"query_dense": b["dense"], "query_sparse_idx": b["sparse_idx"],
                 "query_sparse_mask": b["sparse_mask"],
                 "candidates": torch.randn((64, cfg.embed_dim),
                                           generator=torch.Generator().manual_seed(2))}
        want = dlrm_mod.dlrm_retrieval(params, batch, cfg)
    got = full_value(step_cell(cell, mesh, (params, batch)))
    assert torch.equal(got, want)


def test_gnn_train_cell_equals_make_train_step_at_world_one(world_of_one):
    """graphsage at smoke size: three steps of the cell equal three of the
    trainer's `make_train_step` on the same batch."""
    from repro_torch.configs.gnn_common import gnn_smoke_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import _GNN_INIT, _GNN_LOSS, full_value, step_cell
    from repro_torch.train import AdamW, make_train_step
    from repro_torch.tree import tree_leaves, tree_map

    mesh = make_host_mesh(1, 1, device="cpu")
    cfg, cell = _smoke_cell("graphsage-reddit", "full_graph_sm", mesh)
    cfg = dataclasses.replace(cfg, d_in=8, n_classes=47)
    batch = gnn_smoke_batch("graphsage", seed=0, n=96, e=384, f=8)
    batch["labels"] = batch["labels"] % cfg.n_classes
    params = _GNN_INIT["graphsage-reddit"](torch.Generator().manual_seed(0), cfg)
    opt = AdamW()
    step = make_train_step(lambda p, b: _GNN_LOSS["graphsage-reddit"](p, b, cfg), opt)
    p1, o1 = params, opt.init(params)
    p2, o2 = params, opt.init(params)
    for _ in range(3):
        p1, o1, m1 = step(p1, o1, batch)
        p2, o2, m2 = step_cell(cell, mesh, (p2, o2, batch))
        p2, o2 = tree_map(full_value, p2), tree_map(full_value, o2)
        assert torch.equal(full_value(m2["loss"]), m1["loss"])
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        assert torch.equal(a, b)


def test_step_cell_on_fake_tensors_allocates_nothing(world_of_one):
    """Without arguments the step runs on fake tensors of the cell's full
    shapes: a 13.96 GB table set costs no memory."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell, step_cell

    mesh = make_host_mesh(1, 1, device="cpu")
    out = step_cell(build_cell("dlrm-mlperf", "serve_p99", mesh), mesh)
    assert tuple(out.shape) == (512,)


# --------------------------------------------------------------- analysis

def test_nbytes():
    from repro_torch.launch.step_analysis import _nbytes

    assert _nbytes(torch.empty((4, 8), dtype=torch.float32, device="meta")) == 128
    assert _nbytes(torch.empty(10, dtype=torch.bfloat16, device="meta")) == 20
    assert _nbytes(torch.empty(16, dtype=torch.bool, device="meta")) == 16


def test_step_counter_counts_collective_output_bytes(world_of_one):
    """Each functional collective adds its output's bytes to its kind (the
    dry-run's tests count DTensor's redistributions on 4 ranks)."""
    import torch.distributed as dist

    from repro_torch.distributed import spmd
    from repro_torch.launch.step_analysis import COLLECTIVES, StepCounter

    group = dist.group.WORLD
    c = StepCounter()
    with c:
        spmd.all_gather(torch.ones(16, 128), 0, group)
        spmd.all_reduce_sum(torch.ones(8, 8, dtype=torch.bfloat16), group)
        spmd.all_to_all(torch.ones(2, 2), group)
        spmd.all_gather(torch.ones(3), 0, group, autograd=True)
    out = c.collective_bytes()
    assert out["all_gather"] == 16 * 128 * 4 + 3 * 4
    assert out["all_reduce"] == 64 * 2
    assert out["all_to_all"] == 16
    assert out["count"] == 4
    assert out["total"] == sum(out[k] for k in COLLECTIVES)


def test_step_counter_counts_local_flops_and_live_bytes():
    from repro_torch.launch.step_analysis import StepCounter

    c = StepCounter()
    a, b = torch.ones(64, 32), torch.ones(32, 16)
    with c:
        y = a @ b
        del y
        z = torch.ones(1024)
    assert c.flops == 2 * 64 * 32 * 16
    assert c.peak >= 1024 * 4 and c.bytes_accessed >= (64 * 32 + 32 * 16 + 64 * 16) * 4
    del z


def test_roofline_terms_bottleneck():
    from repro_torch.launch.step_analysis import HBM_BW, PEAK_FLOPS, RooflineTerms

    assert (PEAK_FLOPS, HBM_BW) == (989e12, 3.35e12)   # one H100 SXM, NVIDIA data sheet
    t = RooflineTerms(flops=989e12, hbm_bytes=1e9, coll_bytes=1e9, n_devices=256)
    assert t.t_compute == pytest.approx(1.0)
    assert t.bottleneck == "compute"
    t2 = RooflineTerms(flops=1e9, hbm_bytes=3.35e12 * 2, coll_bytes=0, n_devices=256)
    assert t2.bottleneck == "memory"


def test_remat_duplication():
    from repro_torch.launch.step_analysis import remat_duplication

    assert remat_duplication(4.0, 3.0) == pytest.approx(1 / 3)
    assert remat_duplication(1.0, 0.0) == 0.0


# ---------------------------------------------------------------- dry-run

DRY_CELLS = (("stablelm-3b", "train_4k"), ("graphsage-reddit", "full_graph_sm"),
             ("dlrm-mlperf", "serve_p99"))


@pytest.fixture(scope="module")
def dry_runs(tmp_path_factory):
    """One cell a family at smoke size on a fake 4-rank group, each in its
    own process (the fake group is process-wide)."""
    d = tmp_path_factory.mktemp("dry")
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = {}
    for arch, shape in DRY_CELLS:
        out = d / f"{arch}.jsonl"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
               shape, "--world", "4", "--smoke", "--json", str(out)]
        if arch == "stablelm-3b":
            cmd.append("--remat")
        procs[arch] = (subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), out)
    res = {}
    for arch, (p, out) in procs.items():
        text = p.communicate(timeout=300)[0].decode()
        assert p.returncode == 0, text[-3000:]
        res[arch] = (json.loads(out.read_text().splitlines()[0]), text)
    return res


@pytest.mark.parametrize("arch,shape", DRY_CELLS)
def test_dry_run_reports_the_reference_keys(dry_runs, arch, shape):
    r, text = dry_runs[arch]
    assert r["status"] == "ok" and (r["arch"], r["shape"], r["mesh"]) == (arch, shape, "2x2")
    for key in ("bytes_per_device", "collectives", "roofline", "notes"):
        assert key in r, key
    assert r["bytes_per_device"]["peak"] >= r["bytes_per_device"]["args"] > 0
    assert r["collectives"]["total"] > 0 and r["collectives"]["count"] > 0
    assert r["roofline"]["flops"] > 0 and r["roofline"]["bottleneck"] in (
        "compute", "memory", "collective")
    assert "dry-run summary: 1 ok, 0 skip, 0 FAIL" in text
    if arch == "stablelm-3b":
        assert 0.0 < r["remat_duplication"] < 1.0
