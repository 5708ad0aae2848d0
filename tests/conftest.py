import jax
import pytest

# f64 needed by the paper-faithful solver tests; harmless elsewhere.
# NOTE: no XLA_FLAGS device-count override here — tests run on the real
# single CPU device; only launch/dryrun.py creates the 512 fake devices.
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "transfer_guard: device-driver sweep under "
        "jax.transfer_guard('disallow') — CI runs these as their own step",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA CUDA card (PyTorch port kernels); skips "
        "without one — run on the card with `pytest -m cuda`",
    )


@pytest.fixture(scope="session")
def rng():
    import numpy as np
    return np.random.default_rng(0)
