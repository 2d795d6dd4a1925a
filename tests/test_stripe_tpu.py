"""Device round vs host aligner cross-validation: the batch aligner with
every job forced onto its device leg (on the CPU backend the lax spec of
the stripe contract serves it) must return the host aligner's edits."""
import numpy as np
import pytest

from pangraph_tpu.align.map_variations import map_variations
from pangraph_tpu.align.params import BandedAlignParams, BandParameters
from pangraph_tpu.graph.seq import as_seq, to_str
from pangraph_tpu.ops.batch_align import AlignJob, BatchAligner

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _device_aligner(**kw):
    aligner = BatchAligner(**kw)
    aligner.NATIVE_CELL_BUDGET = 0  # every job through the device round
    return aligner


def _mutated_pair(rng, L, sub_rate=0.02, n_indels=3, indel_max=8):
    ref = BASES[rng.integers(0, 4, L)]
    qry = ref.copy()
    n = int(L * sub_rate)
    pos = rng.choice(L, n, replace=False)
    qry[pos] = BASES[rng.integers(0, 4, n)]
    qry = list(qry)
    for _ in range(n_indels):
        p = int(rng.integers(0, len(qry)))
        if rng.random() < 0.5:
            del qry[p : p + int(rng.integers(1, indel_max))]
        else:
            qry[p:p] = list(BASES[rng.integers(0, 4, int(rng.integers(1, indel_max)))])
    return ref, np.array(qry, dtype=np.uint8)


def test_kernel_roundtrip_random():
    rng = np.random.default_rng(11)
    aligner = _device_aligner()
    jobs, refs, qrys = [], [], []
    for _ in range(12):
        L = int(rng.integers(80, 600))
        ref, qry = _mutated_pair(rng, L)
        jobs.append(AlignJob(ref, qry, BandParameters(0, 30)))
        refs.append(ref)
        qrys.append(qry)
    edits = aligner.align_many(jobs)
    for ref, qry, e in zip(refs, qrys, edits):
        e.sanity_check(len(ref))
        assert to_str(e.apply(ref)) == to_str(qry)


def test_kernel_matches_host_aligner():
    """Same tie-breaking — edits should be identical to the host path on
    typical cases."""
    rng = np.random.default_rng(5)
    aligner = _device_aligner()
    agree = 0
    total = 0
    for _ in range(10):
        L = int(rng.integers(100, 400))
        ref, qry = _mutated_pair(rng, L, sub_rate=0.01, n_indels=2)
        band = BandParameters(0, 25)
        [e_dev] = aligner.align_many([AlignJob(ref, qry, band)])
        e_host = map_variations(ref, qry, band, BandedAlignParams())
        # both must be exact roundtrips
        assert to_str(e_dev.apply(ref)) == to_str(qry)
        assert to_str(e_host.apply(ref)) == to_str(qry)
        total += 1
        if e_dev == e_host:
            agree += 1
    # same recurrence, same tie rules: every case is identical
    assert agree == total, f"only {agree}/{total} identical to host aligner"


def test_kernel_shifted_bands():
    rng = np.random.default_rng(21)
    aligner = _device_aligner()
    # leading insertion: query has 40 extra leading bases
    ref = BASES[rng.integers(0, 4, 300)]
    qry = np.concatenate([BASES[rng.integers(0, 4, 40)], ref.copy()])
    [e] = aligner.align_many([AlignJob(ref, qry, BandParameters(-40, 5))])
    assert to_str(e.apply(ref)) == to_str(qry)
    # leading deletion: mean shift positive
    ref2 = np.concatenate([BASES[rng.integers(0, 4, 40)], ref.copy()])
    [e2] = aligner.align_many([AlignJob(ref2, ref, BandParameters(40, 5))])
    assert to_str(e2.apply(ref2)) == to_str(ref)


def test_kernel_boundary_retry():
    rng = np.random.default_rng(33)
    ref = BASES[rng.integers(0, 4, 500)]
    # 60bp internal deletion but band width 2: must retry
    qry = np.concatenate([ref[:200], ref[260:]])
    aligner = _device_aligner(extra_band_width=0)
    [e] = aligner.align_many([AlignJob(ref, qry, BandParameters(0, 2))])
    assert to_str(e.apply(ref)) == to_str(qry)


def test_kernel_handles_n_and_iupac():
    ref = as_seq("ACGTACGTACGTACGTACGT")
    qry = as_seq("ACGTNCGTACRTACGTACGT")
    aligner = _device_aligner()
    [e] = aligner.align_many([AlignJob(ref, qry, BandParameters(0, 5))])
    assert to_str(e.apply(ref)) == to_str(qry)
