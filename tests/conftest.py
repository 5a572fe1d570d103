import os

import numpy as np
import pytest

# NOTE: do NOT set XLA_FLAGS device-count here unconditionally — smoke
# tests and benches must see the single real CPU device by default;
# launch/dryrun.py forces 512 for itself. The one sanctioned opt-in is
# REPRO_TEST_DEVICES=N (the CI `distributed` job sets 8): it forces N
# host devices for the whole pytest process so tests/
# test_distributed_matmul.py can build a real multi-device mesh. This
# must run at conftest import time, before anything imports jax — safe
# here because this module imports only os/numpy/pytest.
_n_dev = os.environ.get("REPRO_TEST_DEVICES", "")
if _n_dev.isdigit() and int(_n_dev) > 1:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={int(_n_dev)}").strip()


@pytest.fixture(scope="session", autouse=True)
def _x64_scope():
    """REPRO_TEST_X64=1 runs the whole tier-1 suite inside the
    repro.compat.enable_x64 scope (the CI x64 matrix axis): the wide
    stream decode then takes its int64-accumulator branch and the n = 32
    oracle runs without the front-end's own enable_x64 wrap — every
    bit-identity assertion must hold either way, which is exactly the
    cross-x64 invariant the wide decode documents. Going through the
    compat shim (jax.experimental.enable_x64 on 0.4.x, jax.enable_x64 on
    0.6+) also exercises the shim itself on both CI JAX versions."""
    if os.environ.get("REPRO_TEST_X64") == "1":
        from repro.compat import enable_x64
        with enable_x64():
            yield
    else:
        yield


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0xC0FFEE)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the port's hand-written kernels); "
        "skipped where there is none")
