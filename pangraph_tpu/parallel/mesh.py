"""Multi-chip execution: shard alignment batches over a device mesh.

The reference's parallelism is a rayon thread pool over promises/nodes
(SURVEY.md §2.4). Here the job axis of one merge round's re-alignment batch
is sharded data-parallel across the GPUs of one host with jax.sharding.Mesh
and shard_map: each device runs the stripe kernel on its shard, with no
collectives in the hot loop (embarrassingly parallel over jobs).
"""
from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int = None, axis: str = "jobs") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise RuntimeError(f"need {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def shard_jobs(mesh: Mesh, *arrays, axis: str = "jobs"):
    """Place batch arrays with the leading (job) axis sharded across the mesh."""
    sharding = NamedSharding(mesh, P(axis))
    return [jax.device_put(a, sharding) for a in arrays]


def make_mesh_aligner(n_devices: int = None, params=None, extra_band_width: int = 5, max_attempts: int = 4):
    """A BatchAligner whose bucket batches are sharded data-parallel over
    a 'jobs' device mesh (shard_map; one kernel instance per device)."""
    from pangraph_tpu.ops.batch_align import BatchAligner

    mesh = make_mesh(n_devices)
    return BatchAligner(params, extra_band_width, max_attempts, mesh=mesh)
