"""Multi-chip execution: the production aligner sharded over a virtual
8-device CPU mesh must produce the same Edits as the single-device path
(SURVEY.md §4: mesh-size-parameterized tests on CPU-simulated meshes)."""
import numpy as np
import pytest

from pangraph_tpu.align.params import BandedAlignParams, BandParameters
from pangraph_tpu.ops.batch_align import AlignJob, BatchAligner

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _jobs(rng, n_jobs, n=300):
    jobs = []
    for _ in range(n_jobs):
        ref = ACGT[rng.integers(0, 4, n)]
        qry = ref.copy()
        idx = rng.choice(n, 10, replace=False)
        qry[idx] = ACGT[rng.integers(0, 4, 10)]
        jobs.append(AlignJob(ref, qry, BandParameters(0, 40)))
    return jobs


def test_mesh_sharded_align_matches_single_device():
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device CPU mesh (conftest sets it up)")
    from pangraph_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(5)
    jobs = _jobs(rng, 11)
    single = BatchAligner(BandedAlignParams(), 5, 4)
    sharded = BatchAligner(BandedAlignParams(), 5, 4, mesh=make_mesh(8))
    # force the device kernel: adaptive routing would otherwise send these
    # small jobs to the native host aligner on both sides, and the sharded
    # shard_map path would never execute
    single.NATIVE_CELL_BUDGET = 0
    sharded.NATIVE_CELL_BUDGET = 0
    e1 = single.align_many(jobs)
    e2 = sharded.align_many(jobs)
    for a, b, job in zip(e1, e2, jobs):
        assert a == b
        assert np.array_equal(a.apply(job.ref), job.qry)


def test_dryrun_multichip_entrypoint():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)
