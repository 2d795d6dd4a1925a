"""Multi-process / multi-host execution via jax.distributed.

The reference is strictly single-process (commands/main.rs:16 builds one
rayon pool; tree/balance.rs:6 left the parallel schedule disabled). This
module is the multi-process axis of SURVEY.md §2.4 / P4: N processes — each
driving its own devices — initialize a shared jax.distributed runtime,
split the merge tree through the TCP claim/exchange coordinator
(parallel/coordinator.py), and shard each claimed merge's alignment batches
over their per-process LOCAL device mesh. Subgraphs move between merge-tree
levels as gzipped JSON over the coordinator, while alignment batches stay
on each process's own devices.

Worker entrypoint: `python -m pangraph_tpu.parallel.distributed` (see
`worker_main`); `launch_local_cluster` spawns N such workers on one host
with virtual CPU devices for environments without multi-chip hardware (the
driver's dryrun and tests/test_distributed.py use 2 processes x 4 virtual
devices). On GPU hosts, run one worker per GPU (CUDA_VISIBLE_DEVICES) with
the same flags and a reachable coordinator/exchange address.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               virtual_devices: int = None):
    """jax.distributed.initialize with optional virtual CPU devices (test
    environments). Must run before any other jax use in the process."""
    if virtual_devices:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={virtual_devices}"
            ).strip()
    import jax

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax


def local_mesh(axis: str = "jobs"):
    """Per-process mesh over this process's LOCAL devices: alignment batches
    shard across the slice this worker drives; cross-process work splitting
    happens at merge-tree granularity via the coordinator, not collectives."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.local_devices()), (axis,))


def global_mesh_sanity() -> float:
    """One collective over the GLOBAL mesh (all processes' devices): proves
    the shared jax.distributed runtime is live across the job axis. Returns
    the psum-reduced value (== number of global devices)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()), ("jobs",))
    x = jax.device_put(
        np.ones(len(jax.devices()), np.float32), NamedSharding(mesh, P("jobs"))
    )
    f = jax.jit(
        jax.shard_map(
            lambda v: jax.lax.psum(jnp.sum(v), "jobs") * jnp.ones(1, jnp.float32),
            mesh=mesh, in_specs=P("jobs"), out_specs=P("jobs"), check_vma=False,
        )
    )
    out = f(x)
    # the global result spans non-addressable devices: read this process's
    # own shard (the psum value is replicated into every device's shard)
    return float(np.asarray(out.addressable_shards[0].data)[0])


def distributed_build(records, args, coordinate_url: str, aligner=None):
    """Run the build with merge-tree nodes split across the cluster: claims
    and subgraph exchange over `coordinate_url` (tcp://HOST:PORT), alignment
    batches sharded over this process's local mesh."""
    from pangraph_tpu.build.build import build
    from pangraph_tpu.ops.batch_align import BatchAligner

    if aligner is None:
        aligner = BatchAligner(
            args.banded_params, args.extra_band_width, args.max_alignment_attempts,
            mesh=local_mesh(),
        )
    args.coordinate = coordinate_url
    return build(records, args, aligner=aligner)


def _synth_records(seed: int, n: int, L: int):
    """Deterministic tiny workload every worker regenerates identically."""
    from pangraph_tpu.io.fasta import FastaRecord

    ACGT = np.frombuffer(b"ACGT", np.uint8)
    rng = np.random.default_rng(seed)
    base = ACGT[rng.integers(0, 4, L)]
    accessory = ACGT[rng.integers(0, 4, max(150, L // 5))]  # present in half
    recs = []
    for i in range(n):
        g = base.copy()
        idx = rng.choice(L, L // 100, replace=False)
        g[idx] = ACGT[rng.integers(0, 4, len(idx))]
        g = list(g)
        if i % 2 == 0:
            g[L // 2 : L // 2] = list(accessory)
        p = int(rng.integers(100, L - 100))
        g[p:p] = list(ACGT[rng.integers(0, 4, 6)])
        recs.append(FastaRecord(seq_name=f"g{i}", desc=None, seq=np.array(g, np.uint8), index=i))
    return recs


def worker_main(argv=None) -> int:
    """One cluster worker: initialize jax.distributed, run the global-mesh
    sanity collective, then a coordinated build over the per-process local
    mesh; write {digest, blocks, global_devices, psum} JSON to --out."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True, help="jax.distributed coordinator HOST:PORT")
    ap.add_argument("--exchange", required=True, help="merge coordinator tcp://HOST:PORT")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--virtual-devices", type=int, default=0)
    ap.add_argument("--genomes", type=int, default=6)
    ap.add_argument("--length", type=int, default=900)
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)

    initialize(a.coordinator, a.num_processes, a.process_id, a.virtual_devices or None)
    import jax

    psum = global_mesh_sanity()

    from pangraph_tpu.align.params import AlignmentArgs, BuildArgs
    from pangraph_tpu.build.build import verify_roundtrip
    from pangraph_tpu.ops.batch_align import BatchAligner

    recs = _synth_records(seed=3, n=a.genomes, L=a.length)
    args = BuildArgs(circular=False, jobs=2, aln_args=AlignmentArgs())
    aligner = BatchAligner(
        args.banded_params, args.extra_band_width, args.max_alignment_attempts,
        mesh=local_mesh(),
    )
    # keep every alignment on the sharded device path (virtual CPU devices
    # run the kernel in interpret mode; shapes here are tiny)
    aligner.NATIVE_CELL_BUDGET = 0
    graph = distributed_build(recs, args, a.exchange, aligner=aligner)
    verify_roundtrip(graph, recs)
    import hashlib

    from pangraph_tpu.parallel.coordinator import TcpMergeCheckpointer

    digest = hashlib.blake2b(graph.to_json().encode(), digest_size=16).hexdigest()
    with open(a.out, "w") as f:
        json.dump(
            {
                "process_id": a.process_id,
                "digest": digest,
                "blocks": len(graph.blocks),
                "local_devices": len(jax.local_devices()),
                "global_devices": len(jax.devices()),
                "psum": psum,
                "merges_claimed": TcpMergeCheckpointer.CLAIMS_GRANTED,
            },
            f,
        )
    return 0


def _clean_env(virtual_devices: int) -> dict:
    """Worker env: pure-CPU jax (local clusters never open a GPU: one JAX
    process per card), repo on the path, virtual device count pinned."""
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parts = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join([repo] + parts)
    env["JAX_PLATFORMS"] = "cpu"
    kept = [
        t for t in env.get("XLA_FLAGS", "").split()
        if not t.startswith("--xla_force_host_platform_device_count")
    ]
    kept.append(f"--xla_force_host_platform_device_count={virtual_devices}")
    env["XLA_FLAGS"] = " ".join(kept)
    return env


def launch_local_cluster(
    n_processes: int = 2, virtual_devices: int = 4, genomes: int = 6, length: int = 900,
    timeout_s: float = 600.0, out_dir: str = None,
) -> list:
    """Spawn an n-process local cluster (one host, virtual CPU devices) and
    return the per-worker result dicts. Raises if any worker fails or the
    workers disagree on the final graph."""
    import socket
    import tempfile

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    coord = f"127.0.0.1:{free_port()}"
    exchange = f"tcp://127.0.0.1:{free_port()}"
    out_dir = out_dir or tempfile.mkdtemp(prefix="pangraph-dist-")
    env = _clean_env(virtual_devices)
    procs = []
    outs = []
    logs = []
    for pid in range(n_processes):
        out = os.path.join(out_dir, f"worker-{pid}.json")
        outs.append(out)
        # logs go to FILES, not pipes: workers are coupled through
        # collectives and coordinator waits, so a worker blocked on a full
        # pipe (the parent reads sequentially) would deadlock the cluster
        log_path = os.path.join(out_dir, f"worker-{pid}.log")
        logs.append(log_path)
        log_f = open(log_path, "w")
        procs.append(
            subprocess.Popen(
                [
                    sys.executable, "-m", "pangraph_tpu.parallel.distributed",
                    "--coordinator", coord, "--exchange", exchange,
                    "--num-processes", str(n_processes), "--process-id", str(pid),
                    "--virtual-devices", str(virtual_devices),
                    "--genomes", str(genomes), "--length", str(length),
                    "--out", out,
                ],
                env=env, stdout=log_f, stderr=subprocess.STDOUT,
            )
        )
        log_f.close()  # the child holds its own handle
    results = []
    try:
        for p, out, log_path in zip(procs, outs, logs):
            try:
                p.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise RuntimeError("distributed worker timed out")
            if p.returncode != 0:
                with open(log_path) as f:
                    tail = f.read()[-4000:]
                raise RuntimeError(f"worker failed (rc={p.returncode}):\n{tail}")
            with open(out) as f:
                results.append(json.load(f))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    digests = {r["digest"] for r in results}
    if len(digests) != 1:
        raise RuntimeError(f"workers disagree on the final graph: {results}")
    return results


if __name__ == "__main__":
    sys.exit(worker_main())
