import os

# Tests run on a virtual 8-device CPU mesh so multi-device sharding logic is
# exercised without a card (SURVEY.md §4 test plan (c)). Tests must be
# hermetic and fast; the GPU path is covered by the ``gpu``-marked tests and
# chip_smoke.py on a machine with a card.
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

# jax may already be imported (and its config snapshotted) before this file
# runs; the config API still works because backend init is lazy.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


REFERENCE_BIN = "/root/repo/.refbuild/longphase-s"


@pytest.fixture(scope="session")
def reference_binary():
    if not os.path.exists(REFERENCE_BIN):
        pytest.skip("reference binary not built")
    return REFERENCE_BIN


@pytest.fixture(scope="session")
def small_fixture(tmp_path_factory):
    from longphase_s_jax.testing.simulate import make_fixture

    out = tmp_path_factory.mktemp("fix_small")
    return make_fixture(str(out), seed=7, length=120000, coverage=20,
                        read_len=12000, snp_rate=0.001)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: runs the device path compiled for an NVIDIA GPU "
        "(skips where JAX finds none)")
