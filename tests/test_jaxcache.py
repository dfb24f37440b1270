"""Compile-cache placement: ``JAX_COMPILATION_CACHE_DIR`` when set,
else the fixed ``<repo>/.jax_cache`` (never a temporary or per-process
path). Each case runs in a fresh interpreter so the global JAX config
of the test process is untouched."""

import json
import os
import subprocess
import sys

import pytest

from conftest import REPO_ROOT

_PROBE = (
    "import json, jax\n"
    "from genomics_rs_tpu.utils.jaxcache import enable_persistent_cache\n"
    "got = enable_persistent_cache()\n"
    "print(json.dumps([got, jax.config.jax_compilation_cache_dir]))\n"
)


def _probe(cache_env):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO_ROOT)
    if cache_env is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = cache_env
    r = subprocess.run(
        [sys.executable, "-c", _PROBE], env=env, cwd=REPO_ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("sub", ["a", "nested/b"])
def test_env_dir_wins(tmp_path, sub):
    want = str(tmp_path / sub)
    assert _probe(want) == [want, want]


def test_default_is_fixed_repo_dir():
    want = os.path.join(REPO_ROOT, ".jax_cache")
    assert _probe(None) == [want, want]
    with open(os.path.join(REPO_ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
