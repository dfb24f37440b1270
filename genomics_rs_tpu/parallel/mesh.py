"""Device-mesh helpers.

The reference's only task parallelism is a rayon thread pool over
similarity-matrix rows (``/root/reference/src/main.rs:245-261``). The
device analog is a ``jax.sharding.Mesh`` with a ``data`` axis for
pair-level data parallelism (collectives, not shared memory) and a
``seq`` axis for sequence/wavefront parallelism on long sequences
(SURVEY §2.2, §5).
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh

DATA_AXIS = "data"
SEQ_AXIS = "seq"


def make_mesh(n_devices: int | None = None, axis_name: str = DATA_AXIS) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (all by default)."""
    devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devices)} available"
            )
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def make_mesh_2d(
    n_data: int, n_seq: int, axis_names: tuple[str, str] = (DATA_AXIS, SEQ_AXIS)
) -> Mesh:
    """2-D (data, seq) mesh: pairs sharded over ``data``, wavefront
    tiles of one long pair sharded over ``seq``."""
    devices = jax.devices()
    need = n_data * n_seq
    if need > len(devices):
        raise ValueError(f"requested {need} devices, only {len(devices)} available")
    arr = np.asarray(devices[:need]).reshape(n_data, n_seq)
    return Mesh(arr, axis_names)
