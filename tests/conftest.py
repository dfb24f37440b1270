"""Test harness config.

Tests run on a virtual 8-device CPU mesh so multi-device sharding
paths compile and execute without an accelerator. Set
JAX_PLATFORMS/XLA_FLAGS before jax imports anything. The compiled
GPU path is exercised by ``chip_smoke.py`` on the card, not here.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

#: The reference's small inputs (scoring config, alphabets), vendored.
DATA_DIR = os.path.join(REPO_ROOT, "data")

#: A checkout of the reference (its genome FASTA and golden BWT
#: files); tests that read it skip when it is not given.
REFERENCE_DIR = os.environ.get("GENOMICS_REFERENCE_DIR", "")


def data_path(*parts: str) -> str:
    return os.path.join(DATA_DIR, *parts)


def reference_file(*parts: str) -> str:
    """Path of a file in the reference checkout; skips the calling
    test (decided at run time, never at import) when it is absent."""
    path = os.path.join(REFERENCE_DIR, *parts)
    if not REFERENCE_DIR or not os.path.exists(path):
        pytest.skip(
            f"reference input {os.path.join(*parts)} not present "
            "(set GENOMICS_REFERENCE_DIR to a reference checkout)"
        )
    return path


# ---------------------------------------------------------------------------
# Memory-mapping guard.
#
# Every XLA:CPU executable the suite compiles holds a few mmap'd JIT
# code/data regions until the process exits; a full run compiles
# ~20k programs and was measured hitting the kernel's default
# ``vm.max_map_count`` (65530) — at which point the NEXT compile's
# mmap fails and the compiler aborts/segfaults mid-suite. Dropping
# jax's executable caches releases the mappings (measured: 1418 -> 529
# after 300 compiles), so clear them whenever the count gets within
# half of the limit. Costs a few recompiles for cross-test cache hits;
# keeps the suite deterministic on default kernels.
# ---------------------------------------------------------------------------
import gc  # noqa: E402

_MAPS_FILE = f"/proc/{os.getpid()}/maps"
_MAP_GUARD_LIMIT = 32000


def _map_count() -> int:
    try:
        with open(_MAPS_FILE) as f:
            return sum(1 for _ in f)
    except OSError:
        return 0


@pytest.fixture(autouse=True)
def _mmap_guard():
    yield
    if _map_count() > _MAP_GUARD_LIMIT:
        jax.clear_caches()
        gc.collect()

