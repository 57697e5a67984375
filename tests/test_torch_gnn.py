"""repro_torch's GNN path against the JAX package on the CPU.

The fanout sampler and the GNN placement service give the reference's
layers, labels, reports and permutations bit for bit; the four GNN models'
outputs, losses and every parameter's gradient on `gnn_smoke_batch` match
the reference's with its weights carried across by `gnn_params_from_numpy`
(outputs and losses at rtol 1e-5 / atol 1e-6, gradients at rtol 1e-4 /
atol 1e-5; float32 on both sides, summed in other orders); the GNN configs,
shapes, specs and smoke batches equal the reference's; and the example's
pipeline at its own size (BuffCut placement, partition-aware sampling,
GraphSAGE trained with AdamW) follows the reference's losses step by step.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.configs.gnn_common as ref_gc
import repro.models.common as ref_common
import repro.models.gnn as ref_gnn
from repro.distributed import gnn_placement as ref_place
from repro.graphs import apply_order as ref_apply_order
from repro.graphs import grid_mesh_graph as ref_grid
from repro.graphs import random_order as ref_random_order
from repro.graphs import rgg_graph as ref_rgg
from repro.graphs import sampler as ref_sampler
from repro.train.adamw import AdamW as RefAdamW
from repro_torch import configs
from repro_torch.configs import gnn_common
from repro_torch.convert import gnn_params_from_numpy, graph_from_numpy
from repro_torch.distributed import gnn_placement as place
from repro_torch.graphs import cross_block_fraction, sample_block, sample_multihop
from repro_torch.launch.steps import _GNN_INIT, _GNN_LOSS
from repro_torch.models import common, gnn
from repro_torch.train.adamw import AdamW
from repro_torch.train.loop import value_and_grad
from repro_torch.tree import tree_flatten_with_path

ROOT = Path(__file__).resolve().parents[1]
GNN_ARCHS = ["egnn", "meshgraphnet", "schnet", "graphsage-reddit"]
OUT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _port_graph(g):
    return graph_from_numpy(g.indptr, g.indices, g.edge_w, g.node_w)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _to_torch(batch: dict) -> dict:
    out = {}
    for k, v in batch.items():
        if isinstance(v, list):
            out[k] = [torch.from_numpy(np.array(x)) for x in v]
        elif isinstance(v, (int, np.integer)):
            out[k] = int(v)
        else:
            out[k] = torch.from_numpy(np.array(v))
    return out


def _assert_trees_close(ref_tree, port_tree, tol):
    ref_flat = dict(tree_flatten_with_path(_numpy_tree(ref_tree)))
    port_flat = dict(tree_flatten_with_path(port_tree))
    assert sorted(ref_flat) == sorted(port_flat)
    for path, want in ref_flat.items():
        np.testing.assert_allclose(port_flat[path].numpy(), want, err_msg=path, **tol)


# ---------------------------------------------------------------- sampler

def _sampler_graph(kind: str):
    if kind == "grid":
        return ref_grid(24)
    g = ref_rgg(1024, seed=5)
    return ref_apply_order(g, ref_random_order(g, 2))


@pytest.mark.parametrize("biased", [False, True])
@pytest.mark.parametrize("kind", ["grid", "rgg"])
def test_sample_multihop_matches_reference(kind, biased):
    rg = _sampler_graph(kind)
    g = _port_graph(rg)
    block = (np.arange(g.n) * 4 // g.n).astype(np.int64)  # 4 contiguous blocks
    seeds = np.arange(0, g.n, 16)
    bo = block if biased else None
    want = ref_sampler.sample_multihop(rg, seeds, (8, 4), seed=3, block_of=bo)
    got = sample_multihop(g, seeds, (8, 4), seed=3, block_of=bo)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert cross_block_fraction(g, got, block) == ref_sampler.cross_block_fraction(
        rg, want, block)


@pytest.mark.parametrize("kind", ["grid", "rgg"])
def test_sampler_partition_aware(kind):
    """tests/test_graphs.py's rule: the bias reduces cross-shard gathers."""
    g = _port_graph(_sampler_graph(kind))
    block = (np.arange(g.n) * 4 // g.n).astype(np.int64)
    seeds = np.arange(0, g.n, 16)
    f_biased = cross_block_fraction(g, sample_multihop(g, seeds, (8, 4), seed=0,
                                                       block_of=block), block)
    f_plain = cross_block_fraction(g, sample_multihop(g, seeds, (8, 4), seed=0), block)
    assert f_biased <= f_plain + 0.02


def test_sample_block_isolated_node_samples_itself():
    rg = ref_grid(4)
    g = _port_graph(rg)
    g.indptr[:] = 0  # no edges: every node is isolated
    out = sample_block(g, np.array([3, 5]), 4, rng=np.random.default_rng(0))
    assert out.tolist() == [3] * 4 + [5] * 4


# -------------------------------------------------------------- placement

@pytest.fixture(scope="module")
def place_graphs():
    rg = ref_grid(32)
    rg = ref_apply_order(rg, ref_random_order(rg, 3))
    return rg, _port_graph(rg)


@pytest.mark.parametrize("method", ["buffcut", "fennel", "random", "hash"])
def test_place_graph_matches_reference(method, place_graphs):
    rg, g = place_graphs
    want = ref_place.place_graph(rg, 8, method=method)
    got = place.place_graph(g, 8, method=method, device="cpu")
    assert np.array_equal(got.block, want.block)
    assert got.k == want.k == 8
    assert got.cut_edges == want.cut_edges
    assert np.array_equal(got.loads, want.loads)
    assert got.halo_bytes_per_layer(64) == want.halo_bytes_per_layer(64)
    assert np.array_equal(place.reorder_for_shards(g, got),
                          ref_place.reorder_for_shards(rg, want))


@pytest.mark.parametrize("method", ["buffcut", "fennel", "random", "hash"])
def test_place_graph_keeps_the_buffcut_runs_stats(method, place_graphs):
    g = place_graphs[1]
    p = place.place_graph(g, 8, method=method, device="cpu")
    if method != "buffcut":
        assert p.stats is None
        return
    assert p.stats.cut_weight == p.cut_edges
    assert p.stats.n_batches > 0 and 0 < p.stats.ml_time_s <= p.stats.runtime_s


def test_placement_report_matches_reference(place_graphs):
    rg, g = place_graphs
    assert place.placement_report(g, 8, 64, device="cpu") == ref_place.placement_report(
        rg, 8, 64)


def test_buffcut_placement_beats_random(place_graphs):
    """tests/test_distributed.py's payoff check, on the port."""
    rep = place.placement_report(place_graphs[1], n_shards=8, d_feat=64, device="cpu")
    assert rep["buffcut"]["halo_MB_per_layer"] < rep["random"]["halo_MB_per_layer"] * 0.6
    assert rep["buffcut"]["load_imbalance"] < 1.2


def test_placement_reorder_contiguous():
    g = _port_graph(ref_grid(16))
    p = place.place_graph(g, 4, method="hash", device="cpu")
    assert (np.diff(p.block[place.reorder_for_shards(g, p)]) >= 0).all()


def test_place_graph_refuses_an_unknown_method(place_graphs):
    with pytest.raises(ValueError):
        place.place_graph(place_graphs[1], 4, method="metis", device="cpu")


def test_place_graph_defaults_to_the_card(place_graphs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        place.place_graph(place_graphs[1], 4)


# ----------------------------------------------------------------- models

def _case(arch: str, mode: str = "full", seed: int = 0):
    """(ref cfg, ref params, ref batch, port cfg, port params, port batch,
    ref loss, port loss) for one arch at its smoke config."""
    spec_id = arch
    ref_spec, spec = ref_configs.get_arch(spec_id), configs.get_arch(spec_id)
    ref_cfg, cfg = ref_spec.smoke_config(), spec.smoke_config()
    ref_params = ref_gnn_init(arch)(jax.random.PRNGKey(seed), ref_cfg)
    params = gnn_params_from_numpy(_numpy_tree(ref_params), device="cpu")
    ref_batch = ref_spec.smoke_batch(ref_cfg, seed)
    if mode == "sampled":
        ref_batch = _sampled_batch(ref_cfg, seed)
    batch = _to_torch(ref_batch)
    ref_loss = ref_loss_fn(arch)
    return ref_cfg, ref_params, ref_batch, cfg, params, batch, ref_loss, _GNN_LOSS[arch]


def ref_gnn_init(arch):
    return {"egnn": ref_gnn.egnn_init, "meshgraphnet": ref_gnn.mgn_init,
            "schnet": ref_gnn.schnet_init, "graphsage-reddit": ref_gnn.sage_init}[arch]


def ref_loss_fn(arch):
    return {"egnn": ref_gnn.egnn_loss, "meshgraphnet": ref_gnn.mgn_loss,
            "schnet": ref_gnn.schnet_loss, "graphsage-reddit": ref_gnn.sage_loss}[arch]


def _sampled_batch(cfg, seed: int, b: int = 6) -> dict:
    """A sampled GraphSAGE batch in the sampler's layout (seeds, hop 1, hop
    2) with a node mask."""
    rng = np.random.default_rng(seed + 100)
    sizes = [b, b * cfg.sample_sizes[0], b * cfg.sample_sizes[0] * cfg.sample_sizes[1]]
    return {
        "feats": [jnp.asarray(rng.standard_normal((s, cfg.d_in)), jnp.float32) for s in sizes],
        "labels": jnp.asarray(rng.integers(0, cfg.n_classes, b), jnp.int32),
        "node_mask": jnp.asarray((np.arange(b) % 5 != 4).astype(np.float32)),
    }


MODEL_CASES = [("egnn", "full"), ("meshgraphnet", "full"), ("schnet", "full"),
               ("graphsage-reddit", "full"), ("graphsage-reddit", "sampled")]


APPLY = {"egnn": (ref_gnn.egnn_apply, gnn.egnn_apply),
         "meshgraphnet": (ref_gnn.mgn_apply, gnn.mgn_apply),
         "schnet": (ref_gnn.schnet_apply, gnn.schnet_apply),
         "graphsage-reddit": (ref_gnn.sage_apply_fullgraph, gnn.sage_apply_fullgraph),
         "graphsage-reddit/sampled": (ref_gnn.sage_apply_sampled, gnn.sage_apply_sampled)}


def _apply_pair(arch, mode, ref_params, ref_batch, ref_cfg, params, batch, cfg):
    ref_apply, apply = APPLY[arch + ("/sampled" if mode == "sampled" else "")]
    return (jax.jit(lambda p: ref_apply(p, ref_batch, ref_cfg))(ref_params),
            apply(params, batch, cfg))


@pytest.mark.parametrize("arch,mode", MODEL_CASES)
def test_model_forward_matches_reference(arch, mode):
    ref_cfg, ref_params, ref_batch, cfg, params, batch, _, _ = _case(arch, mode)
    want, got = _apply_pair(arch, mode, ref_params, ref_batch, ref_cfg, params, batch, cfg)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for w, g in zip(want, got):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **OUT_TOL)


@pytest.mark.parametrize("arch,mode", MODEL_CASES)
def test_model_loss_and_grads_match_reference(arch, mode):
    ref_cfg, ref_params, ref_batch, cfg, params, batch, ref_loss, loss = _case(arch, mode)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: ref_loss(p, ref_batch, ref_cfg)))(ref_params)
    got_loss, got_grads = value_and_grad(lambda p, b: loss(p, b, cfg), params, batch)
    np.testing.assert_allclose(float(got_loss), float(want_loss), **OUT_TOL)
    _assert_trees_close(want_grads, got_grads, GRAD_TOL)
    assert all(bool(torch.isfinite(g).all()) for _, g in tree_flatten_with_path(got_grads))


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_model_init_has_the_reference_structure(arch):
    ref_cfg = ref_configs.get_arch(arch).smoke_config()
    cfg = configs.get_arch(arch).smoke_config()
    want = _numpy_tree(ref_gnn_init(arch)(jax.random.PRNGKey(0), ref_cfg))
    got = _GNN_INIT[arch](torch.Generator().manual_seed(0), cfg)
    want_flat, got_flat = dict(tree_flatten_with_path(want)), dict(tree_flatten_with_path(got))
    assert sorted(want_flat) == sorted(got_flat)
    for path, w in want_flat.items():
        assert tuple(got_flat[path].shape) == w.shape, path
        assert got_flat[path].dtype == torch.float32
        if path.rsplit("/", 1)[-1].startswith("b"):
            assert not got_flat[path].any()  # biases start at zero
        elif path != "species_embed":  # uniform in +-1/sqrt(fan_in)
            assert float(got_flat[path].abs().max()) <= 1 / np.sqrt(w.shape[0])


def test_sage_init_gives_self_and_nbr_one_start_like_the_reference():
    """The reference passes one key to self_i and nbr_i (ROADMAP, Known
    states); the port draws once and copies."""
    cfg = configs.get_arch("graphsage-reddit").smoke_config()
    p = gnn.sage_init(torch.Generator().manual_seed(0), cfg)
    ref = ref_gnn.sage_init(jax.random.PRNGKey(0), ref_configs.get_arch(
        "graphsage-reddit").smoke_config())
    for i in range(cfg.n_layers):
        np.testing.assert_array_equal(np.asarray(ref[f"self_{i}"]["w0"]),
                                      np.asarray(ref[f"nbr_{i}"]["w0"]))
        assert torch.equal(p[f"self_{i}"]["w0"], p[f"nbr_{i}"]["w0"])
        assert p[f"self_{i}"]["w0"].data_ptr() != p[f"nbr_{i}"]["w0"].data_ptr()


def test_norm_gradient_at_an_all_zero_row_is_nan_like_the_reference():
    """h / max(||h||, 1e-6): JAX's norm has a NaN gradient at 0, and so does
    the port's sqrt(sum(h * h)) (`torch.linalg.vector_norm` would give 0)."""
    def ref_fn(x):
        return jnp.sum(x / jnp.maximum(jnp.linalg.norm(x, axis=-1, keepdims=True), 1e-6))

    x = np.array([[0.0, 0.0, 0.0], [1.0, -2.0, 0.5]], np.float32)
    want = np.asarray(jax.grad(ref_fn)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad(gnn._unit_rows(xt).sum(), xt)
    assert np.isnan(want[0]).all() and torch.isnan(got[0]).all()
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=1e-6, atol=1e-7)


def test_sage_dead_layer_grads_match_reference_and_stay_finite():
    """A first layer whose rows are all zero after the relu: the norm's NaN
    gradient at those rows stops at the relu in both packages (each takes
    the relu's gradient as a select, not a product), so the parameters'
    gradients are finite and equal to the reference's."""
    ref_cfg, ref_params, ref_batch, cfg, params, batch, ref_loss, loss = _case(
        "graphsage-reddit", "sampled")
    for name in ("self_0", "nbr_0"):
        ref_params[name]["b0"] = ref_params[name]["b0"] - 100.0
        params[name]["b0"] = params[name]["b0"] - 100.0
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: ref_loss(p, ref_batch, ref_cfg)))(ref_params)
    got_loss, got = value_and_grad(lambda p, b: loss(p, b, cfg), params, batch)
    assert all(np.isfinite(w).all() for w in jax.tree.leaves(_numpy_tree(want)))
    np.testing.assert_allclose(float(got_loss), float(want_loss), **OUT_TOL)
    _assert_trees_close(want, got, GRAD_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_segment_mean_matches_reference(masked):
    rng = np.random.default_rng(4)
    data = rng.standard_normal((40, 5)).astype(np.float32)
    ids = rng.integers(0, 9, 40).astype(np.int32)  # some of the 12 segments stay empty
    mask = (rng.random(40) > 0.3).astype(np.float32) if masked else None
    want = ref_gnn.segment_mean(jnp.asarray(data), jnp.asarray(ids), 12,
                                None if mask is None else jnp.asarray(mask))
    got = gnn.segment_mean(torch.from_numpy(data), torch.from_numpy(ids), 12,
                           None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


@pytest.mark.parametrize("bad", [-1, 12])
def test_segment_ids_out_of_range_raise(bad):
    """JAX drops out-of-range segment ids; the port refuses them."""
    ids = torch.tensor([0, 3, bad], dtype=torch.int32)
    with pytest.raises(IndexError, match="segment_ids"):
        gnn.segment_mean(torch.ones(3, 2), ids, 12)


def test_edge_ids_out_of_range_raise():
    cfg = configs.get_arch("meshgraphnet").smoke_config()
    params = gnn.mgn_init(torch.Generator().manual_seed(0), cfg)
    batch = _to_torch(ref_gc.gnn_smoke_batch("meshgraphnet", 0))
    batch["edge_dst"][5] = 64
    with pytest.raises(IndexError, match="edge_dst"):
        gnn.mgn_apply(params, batch, cfg)


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(2)
    x, s, b = (rng.standard_normal(shape).astype(np.float32) for shape in ((6, 16), (16,),
                                                                           (16,)))
    want = ref_common.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    got = common.layer_norm(*(torch.from_numpy(a) for a in (x, s, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


def test_softplus_is_the_references_above_20():
    x = np.array([-30.0, -1.0, 0.0, 3.0, 20.5, 40.0], np.float32)
    np.testing.assert_allclose(gnn._softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6)


# ---------------------------------------------------------------- configs

def _shapes(shapes: dict) -> dict:
    return {name: dataclasses.asdict(shape) for name, shape in shapes.items()}


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_configs_match_reference(arch):
    ref_spec, spec = ref_configs.get_arch(arch), configs.get_arch(arch)
    assert spec.family == ref_spec.family == "gnn"
    for which in ("full_config", "smoke_config"):
        assert dataclasses.asdict(getattr(spec, which)()) == dataclasses.asdict(
            getattr(ref_spec, which)())
    assert _shapes(spec.shapes) == _shapes(ref_spec.shapes)
    assert spec.notes == ref_spec.notes
    name = "graphsage" if arch == "graphsage-reddit" else arch
    for shape in spec.shapes.values():
        want = ref_gc.gnn_input_specs(name, ref_spec.shapes[shape.name])
        got = spec.input_specs(spec.full_config(), shape)
        assert sorted(got) == sorted(want)
        for key, (shp, dtype) in got.items():
            assert shp == want[key].shape
            assert str(dtype).removeprefix("torch.") == str(want[key].dtype)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_smoke_batch_matches_reference(arch, seed):
    ref_spec, spec = ref_configs.get_arch(arch), configs.get_arch(arch)
    want = ref_spec.smoke_batch(ref_spec.smoke_config(), seed)
    got = spec.smoke_batch(spec.smoke_config(), seed)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        if isinstance(w, int):
            assert got[key] == w
            continue
        assert got[key].device.type == "cpu"
        assert str(got[key].dtype).removeprefix("torch.") == str(w.dtype)
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(w))


def test_gnn_shapes_and_constants_match_reference():
    assert _shapes(gnn_common.gnn_shapes()) == _shapes(ref_gc.gnn_shapes())
    assert (gnn_common.FANOUT, gnn_common.BATCH_NODES) == (ref_gc.FANOUT, ref_gc.BATCH_NODES)
    with pytest.raises(ValueError):
        gnn_common.gnn_input_specs("gat", gnn_common.gnn_shapes()["molecule"])


# ------------------------------------------------------ the slice as a whole

N_SHARDS, D_FEAT = 8, 32


def _pipeline_reference(rg, seeds_rng_seed: int = 0):
    """The reference example's steps 1-3 at its size: (placement, report,
    initial params, per-step layers, losses)."""
    report = ref_place.placement_report(rg, N_SHARDS, D_FEAT)
    placement = ref_place.place_graph(rg, N_SHARDS, method="buffcut")
    cfg = ref_gnn.GraphSAGEConfig(n_layers=2, d_hidden=32, d_in=D_FEAT, n_classes=4,
                                  sample_sizes=(8, 4))
    params = ref_gnn.sage_init(jax.random.PRNGKey(0), cfg)
    init = _numpy_tree(params)
    opt = RefAdamW(lr=1e-2, warmup_steps=5)
    opt_state = opt.init(params)
    rng = np.random.default_rng(seeds_rng_seed)
    feats = rng.standard_normal((rg.n, D_FEAT)).astype(np.float32)
    labels = (placement.block % 4).astype(np.int32)

    @jax.jit
    def step(p, o, batch):
        loss, grads = jax.value_and_grad(lambda p_: ref_gnn.sage_loss(p_, batch, cfg))(p)
        p2, o2, _ = opt.update(grads, o, p)
        return p2, o2, loss

    layers_all, losses = [], []
    for it in range(30):
        seeds = rng.integers(0, rg.n, 64)
        layers = ref_sampler.sample_multihop(rg, seeds, cfg.sample_sizes, seed=it,
                                             block_of=placement.block)
        layers_all.append(layers)
        batch = {"feats": [jnp.asarray(feats[la]) for la in layers],
                 "labels": jnp.asarray(labels[seeds])}
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(float(loss))
    return placement, report, init, layers_all, losses


def test_example_pipeline_matches_reference():
    """rgg_graph(2048, seed=3) in random_order(., 1), 8 shards, GraphSAGE
    (2 layers, d 32, 4 classes, fanouts 8-4), AdamW(lr 1e-2, warmup 5), 30
    steps of 64 seeds, from the reference's initial weights."""
    rg0 = ref_rgg(2048, seed=3)
    rg = ref_apply_order(rg0, ref_random_order(rg0, 1))
    want_place, want_report, init, want_layers, want_losses = _pipeline_reference(rg)

    g = _port_graph(rg)
    assert place.placement_report(g, N_SHARDS, D_FEAT, device="cpu") == want_report
    placement = place.place_graph(g, N_SHARDS, method="buffcut", device="cpu")
    assert np.array_equal(placement.block, want_place.block)
    cfg = gnn.GraphSAGEConfig(n_layers=2, d_hidden=32, d_in=D_FEAT, n_classes=4,
                              sample_sizes=(8, 4))
    params = gnn_params_from_numpy(init, device="cpu")
    opt = AdamW(lr=1e-2, warmup_steps=5)
    opt_state = opt.init(params)
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.standard_normal((g.n, D_FEAT)).astype(np.float32))
    labels = torch.from_numpy((placement.block % 4).astype(np.int32))
    losses = []
    for it in range(30):
        seeds = rng.integers(0, g.n, 64)
        layers = sample_multihop(g, seeds, cfg.sample_sizes, seed=it, block_of=placement.block)
        for a, b in zip(layers, want_layers[it]):
            assert np.array_equal(a, b)
        batch = {"feats": [feats[torch.from_numpy(la)] for la in layers],
                 "labels": labels[torch.from_numpy(seeds)]}
        loss, grads = value_and_grad(lambda p, b: gnn.sage_loss(p, b, cfg), params, batch)
        params, opt_state, _ = opt.update(grads, opt_state, params)
        losses.append(float(loss))
    np.testing.assert_allclose(losses[:5], want_losses[:5], rtol=1e-5)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-3)
    assert losses[-1] < losses[0]


def test_example_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "gnn_partition_pipeline_torch.py"),
         "--device", "cpu"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("graph n=2048 m=")
    assert [ln.split()[0] for ln in lines[1:5]] == ["buffcut", "fennel", "random", "hash"]
    assert lines[5].startswith("shard sizes: [")
    assert lines[6].startswith("sage loss ") and "cross-shard gather fraction" in lines[6]
    assert lines[-1] == "OK"
