"""Per-module test hygiene.

The reference polices key leaks around every test (CheckKeysTask /
CleanAllKeysTask, SURVEY §4.1); here the analog is clearing the keyed
store and the jit executable caches between test MODULES — without it a
full-suite run accumulates every trained model's device buffers plus
thousands of live XLA executables, and the run eventually dies inside
an XLA compile (observed as a segfault around the 100th test)."""
import gc

import pytest


@pytest.fixture(autouse=True, scope="module")
def _module_cleanup():
    yield
    import jax
    from h2o3_tpu import dkv
    with dkv._LOCK if hasattr(dkv, "_LOCK") else _nullcontext():
        dkv._STORE.clear()
    jax.clear_caches()
    gc.collect()


class _nullcontext:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skipped without one (on the "
        "card: python -m pytest --noconftest -m gpu "
        "tests/test_torch_kernels.py tests/test_torch_imports.py)")
