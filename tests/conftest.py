import os

# Tests must see a single CPU device (the 512-device override is strictly
# scoped to launch/dryrun.py per the assignment).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

# Keep test runs hermetic: no reads/writes of the user-level decode-tile
# autotune cache (tests that exercise persistence re-enable it against a
# tmpdir, see test_tile_cache.py).
os.environ.setdefault("REPRO_TILE_CACHE", "0")

import jax

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)"
    )
