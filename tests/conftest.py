"""Shared fixtures. NOTE: no XLA_FLAGS here on purpose — tests must see the
host's real device count (1); only launch/dryrun.py forces 512 devices."""
try:  # property tests degrade to a seeded random-example runner without it
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    import _hypothesis_stub

    _hypothesis_stub.install()

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "faultinject: deterministic IO fault-injection tests (run alone with "
        "`pytest -m faultinject`)",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (repro_torch kernels); skips without one",
    )


from repro.graphs import (  # noqa: E402
    rmat_graph,
    grid_mesh_graph,
    sbm_graph,
    random_order,
    apply_order,
)


@pytest.fixture(scope="session")
def small_rmat():
    return rmat_graph(256, 8, seed=1)


@pytest.fixture(scope="session")
def small_grid():
    return grid_mesh_graph(24)  # 576 nodes


@pytest.fixture(scope="session")
def random_grid():
    g = grid_mesh_graph(24)
    return apply_order(g, random_order(g, 7))


@pytest.fixture(scope="session")
def small_sbm():
    return sbm_graph(384, 8, p_in=0.15, p_out=0.003, seed=3)
