"""Test harness: an 8-device virtual CPU mesh + float64.

The reference exercises distributed behavior with oversubscribed
``mpirun -n 8`` on one box (SURVEY §4); the JAX equivalent is
``--xla_force_host_platform_device_count=8`` — 8 virtual CPU devices that run
real XLA collectives, so every sharding/collective path is tested without TPU
hardware.  float64 is enabled to reproduce the reference's ~1e-14 f64
residual gates (bench/cholesky/cholinv.cpp:61-66).

These env vars must be set before jax initializes, hence the top of conftest.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # force: the session env pins the TPU platform
# The suite assumes exactly 8 virtual devices; strip any pre-existing count.
flags = [
    f
    for f in os.environ.get("XLA_FLAGS", "").split()
    if "xla_force_host_platform_device_count" not in f
]
flags.append("--xla_force_host_platform_device_count=8")
os.environ["XLA_FLAGS"] = " ".join(flags)

import jax  # noqa: E402

# jax may already be imported (pytest plugins) with the session's TPU platform
# baked into its config defaults — override through the config API, which works
# any time before backend initialization.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

from capital_tpu.parallel.topology import Grid  # noqa: E402


@pytest.fixture(scope="session")
def grid2x2x2() -> Grid:
    """2x2x2 grid — the full 3D SUMMA topology (d=2, c=2)."""
    return Grid.square(c=2)


@pytest.fixture(scope="session")
def grid2x2x1() -> Grid:
    """2x2 face grid, no replication depth (d=2, c=1)."""
    return Grid.square(c=1, devices=jax.devices("cpu")[:4])


@pytest.fixture(scope="session")
def grid_flat8() -> Grid:
    """8x1x1 — the 1D tall-skinny topology."""
    return Grid.flat()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: excluded from the tier-1 gate (pytest -m 'not slow'); "
        "covered by `make audit` targets instead",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card (the PyTorch port's kernels); skips without one",
    )
