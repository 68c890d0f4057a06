"""Test configuration: the tests run on the CPU, as an 8-device CPU mesh so
sharded code paths are exercised without accelerators (cf. SURVEY.md §4: the
reference never tests multi-device because it has none; we bit-compare
sharded vs single-device).  Run them with ``JAX_PLATFORMS=cpu``; the config
is also pinned here, through jax.config, which works even when jax was
imported before this file.  Tests that need a GPU are marked ``gpu`` and
skip here; ``python chip_smoke.py`` runs their checks on the card.
"""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


def pytest_addoption(parser):
    # parity with the reference test harness (reference tests/conftest.py):
    # external data folders may be passed for cross-checking on real data
    parser.addoption(
        "--datafolder",
        action="append",
        default=[],
        help="data folder to pass to test functions",
    )


def pytest_generate_tests(metafunc):
    if "datafolder" in metafunc.fixturenames:
        metafunc.parametrize("datafolder", metafunc.config.getoption("datafolder"))
