"""Card-only checks (tests/gpu_checks.py) as ``gpu``-marked tests.

They skip wherever JAX's first device is not a GPU — always under this
suite's conftest, which pins the CPU — and ``python chip_smoke.py`` runs
the same checks on the card.  The exactness checks that hold on any
backend also run here on the CPU."""

import pytest

import gpu_checks


@pytest.fixture
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run python chip_smoke.py on the card)")


@pytest.mark.gpu
@pytest.mark.parametrize("check", gpu_checks.CHECKS, ids=lambda c: c.__name__)
def test_on_gpu(gpu, check):
    check()


@pytest.mark.parametrize(
    "check",
    [
        gpu_checks.check_prefix_blocks_match_oracle,
        gpu_checks.check_coo_extraction_matches_numpy,
        gpu_checks.check_mismatch_positions_match_host,
    ],
    ids=lambda c: c.__name__,
)
def test_exactness_checks_on_cpu(check):
    check()
