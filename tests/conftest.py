import os

# Tests run on the CPU backend with a virtual 8-device mesh, so the
# multi-device sharding paths are exercised on any machine.  On a GPU
# machine, MYFM_TEST_PLATFORM=gpu leaves JAX's platform choice alone so
# the tests marked `gpu` run on the card; the same tests are collected
# either way (whether a card is present is decided in the `gpu_device`
# fixture at run time).  Must be set before jax imports.
_PLATFORM = os.environ.get("MYFM_TEST_PLATFORM", "cpu")
if _PLATFORM == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        )
# Persistent compilation cache inside the checkout (gitignored):
# repeated pytest runs skip XLA recompiles.
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), ".jax_cache", "pytest"),
)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "-1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")

from typing import Tuple

import jax

if _PLATFORM == "cpu":
    # a site config can preset jax_platforms, which overrides the env
    # var: set it explicitly as well
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)  # allow float64 oracle tests

import numpy as np
import pytest
import scipy.sparse as sps

from .oracle import FMWeights, fm_oracle_score


@pytest.fixture(autouse=True, scope="module")
def _shed_xla_state_between_modules():
    """Free compiled executables after each test module.

    The full suite compiles hundreds of XLA CPU programs in one
    process; past ~100 live executables the next large compile can
    segfault inside XLA (observed deterministically at
    test_sharded.py::test_estimator_n_devices_api when the whole suite
    runs in one process — any half of the suite passes).  Dropping the
    jit caches between modules keeps the live-program count bounded;
    the persistent compilation cache (JAX_COMPILATION_CACHE_DIR above)
    makes cross-module recompiles cheap.
    """
    yield
    jax.clear_caches()


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: tests of code that runs only on the
    card (compiled Triton kernels) take this fixture and carry the
    `gpu` marker."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip(
            "needs a GPU: the suite runs on the CPU unless "
            "MYFM_TEST_PLATFORM=gpu"
        )
    return devs[0]


@pytest.fixture
def stub_weight() -> FMWeights:
    # A small ground-truth FM with known pairwise structure: rank 4 over
    # 3 features (test strategy of the reference, tests/conftest.py).
    return FMWeights(
        w0=-3.0,
        w=np.array([1.0, 2.0, -1.0]),
        V=np.array(
            [
                [1.0, 0.0, 1.0, -1.0],
                [-1.0, 1.0, 1.0, 0.0],
                [0.0, 1.0, 1.0, -1.0],
            ]
        ),  # [F, R]
    )


def make_sparse_data(
    n_rows: int, weights: FMWeights, seed: int = 0
) -> Tuple[sps.csr_matrix, np.ndarray]:
    rng = np.random.RandomState(seed)
    n_feat = weights.w.shape[0]
    mask = rng.random((n_rows, n_feat)) > 0.5
    vals = rng.choice([-2.0, -1.0, 1.0, 2.0], size=(n_rows, n_feat))
    dense = np.where(mask, vals, 0.0)
    X = sps.csr_matrix(dense)
    score = fm_oracle_score(X, weights)
    return X, score


@pytest.fixture
def middle_data(stub_weight) -> Tuple[sps.csr_matrix, np.ndarray]:
    return make_sparse_data(1000, stub_weight)
