"""Device mesh + sharding layout for multi-chip mapping.

Design (SURVEY.md §2 "Distributed communication backend"):
  * 2D mesh ("data", "index"): read batches are data-parallel over "data";
    the minimizer index tables can be replicated (fits-in-HBM genomes) or
    sharded over "index" with lookups combined by collectives
    (>HBM genomes).
  * No cross-chip collectives on the per-read hot path when the index is
    replicated — the reference's FPGA DMA transport maps to plain host->HBM
    batch staging.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, index_shards: int = 1) -> Mesh:
    devs = jax.devices()
    n = n_devices if n_devices is not None else len(devs)
    assert n % index_shards == 0, "n_devices must be divisible by index_shards"
    data = n // index_shards
    dev_array = np.array(devs[:n]).reshape(data, index_shards)
    return Mesh(dev_array, axis_names=("data", "index"))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Per-read arrays: sharded over the data axis, replicated over index."""
    return NamedSharding(mesh, P("data"))


def index_sharding(mesh: Mesh) -> NamedSharding:
    """Index tables: sharded over the index axis, replicated over data."""
    return NamedSharding(mesh, P("index"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to(x: np.ndarray, mult: int, fill=0) -> np.ndarray:
    n = x.shape[0]
    m = (n + mult - 1) // mult * mult
    if m == n:
        return x
    pad = [(0, m - n)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad, constant_values=fill)
