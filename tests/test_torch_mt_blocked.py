"""The blocked multi-trait chains (fast_blocks=16) of
tests/test_torch_mt_runmcmc.py's CHAINS against jwas_tpu's, within the
same calibrated Monte-Carlo bounds: missing phenotypes, BayesB, BayesC
sampler I and BayesL through K9's plain version (a file of their own, so
that the chains spread over the test workers)."""

import jax
import pytest

from test_torch_mt_runmcmc import check_chain


@pytest.fixture(autouse=True)
def _jax_float32():
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("name", ["missing", "BayesB", "fast_blocks_16", "BayesL"])
def test_blocked_chain_matches_jwas_tpu_within_monte_carlo_error(name, tmp_path):
    check_chain(name, tmp_path, files=name == "BayesL")
