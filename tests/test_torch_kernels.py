"""repro_torch's ell_histogram: plain version vs the JAX oracle and the
Pallas kernel (interpret mode), and the wrapper's CPU dispatch and checks.
The CUDA kernel itself is tested on a card in test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.core.histogram import label_histogram_ell
from repro_torch.graphs import grid_mesh_graph
from repro_torch.kernels import ell_histogram as eh

# the shapes of tests/test_kernels.py::test_histogram_shapes, k=1000 too
SHAPES = [(1, 1, 2), (7, 13, 4), (64, 32, 16), (130, 7, 32), (100, 64, 256), (64, 16, 1000)]


def _inputs(b, w, k, weights, seed=0):
    rng = np.random.default_rng(seed + 1000 * b + w)
    blk = rng.integers(-1, k, (b, w)).astype(np.int32)
    if weights == "int":
        wts = rng.integers(1, 6, (b, w)).astype(np.float32)
    else:
        wts = rng.random((b, w)).astype(np.float32)
    wts *= blk >= 0
    return blk, wts


def _check(got, want, weights):
    if weights == "int":  # integer sums in float32 are exact in any order
        np.testing.assert_array_equal(got, want)
    else:  # the order of the float32 sums differs
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("weights", ["int", "float"])
@pytest.mark.parametrize("b,w,k", SHAPES)
def test_plain_matches_jax_oracle(b, w, k, weights):
    blk, wts = _inputs(b, w, k, weights)
    got = eh.ell_histogram_plain(torch.from_numpy(blk), torch.from_numpy(wts), k)
    want = ref.ell_histogram_ref(jnp.asarray(blk), jnp.asarray(wts), k)
    assert got.shape == (b, k) and got.dtype == torch.float32
    _check(got.numpy(), np.asarray(want), weights)


@pytest.mark.parametrize("weights", ["int", "float"])
@pytest.mark.parametrize("b,w,k", SHAPES)
def test_plain_matches_pallas_kernel_interpreted(b, w, k, weights):
    blk, wts = _inputs(b, w, k, weights, seed=1)
    got = eh.ell_histogram_plain(torch.from_numpy(blk), torch.from_numpy(wts), k)
    want = ops.block_histogram(jnp.asarray(blk), jnp.asarray(wts), k,
                               use_kernel=True, interpret=True)
    _check(got.numpy(), np.asarray(want), weights)


def test_wrapper_takes_plain_version_on_cpu_without_launching():
    blk, wts = _inputs(130, 7, 32, "float")
    before = eh.launches
    got = eh.block_histogram(torch.from_numpy(blk), torch.from_numpy(wts), 32)
    assert eh.launches == before
    want = eh.ell_histogram_plain(torch.from_numpy(blk), torch.from_numpy(wts), 32)
    assert torch.equal(got, want)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    blk, wts = _inputs(8, 8, 4, "int")
    b, w = torch.from_numpy(blk), torch.from_numpy(wts)
    with pytest.raises(TypeError):
        eh.block_histogram(b.long(), w, 4)
    with pytest.raises(TypeError):
        eh.block_histogram(b, w.double(), 4)
    with pytest.raises(ValueError):
        eh.block_histogram(b[:, :4], w, 4)
    with pytest.raises(ValueError):
        eh.block_histogram(b.t(), w.t(), 4)  # not contiguous
    with pytest.raises(ValueError):
        eh.block_histogram(b, w, -1)


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card error path cannot be shown")
    g = grid_mesh_graph(4)
    labels = np.arange(g.n) % 3
    with pytest.raises(RuntimeError, match="no CUDA device"):
        label_histogram_ell(g, labels, device="cuda")
    counts, uniq = label_histogram_ell(g, labels, device="cpu")
    assert counts.shape == (g.n, 3) and list(uniq) == [0, 1, 2]
