"""Parity tests for the stripe DP contract (ops/stripe_dp.py). The plain-lax
spec must produce, problem for problem, the host aligner's edits and
boundary flags (native/stripe.cpp, align/map_variations.py), which are
themselves pinned against the reference fixtures
(align_with_nextclade.rs:90-141). The CUDA kernel is held to the spec bit
for bit on the card (test_cuda_matches_spec, chip_smoke.py)."""
import numpy as np
import pytest

from pangraph_tpu.align.map_variations import map_variations
from pangraph_tpu.align.params import BandedAlignParams, BandParameters
from pangraph_tpu.graph.seq import IUPAC_MASK, as_seq
from pangraph_tpu.native import stripe_align_batch_native
from pangraph_tpu.ops.batch_align import _edit_from_rle_hostmatch
from pangraph_tpu.ops.stripe_dp import (
    META,
    OP_D,
    decode_packed,
    edit_from_events,
    fits_band,
    lanes_for,
    stripe_align_spec,
)
from pangraph_tpu.utils.synth import make_align_batch

ACGT = np.frombuffer(b"ACGT", np.uint8)
KINDS = ["identical", "subs", "mixed", "heavy"]


def mutate(ref, n_sub, n_ins, n_del, rng):
    q = list(ref)
    for _ in range(n_del):
        p = int(rng.integers(1, len(q) - 1))
        L = int(rng.integers(1, 6))
        del q[p : p + L]
    for _ in range(n_ins):
        p = int(rng.integers(1, len(q) - 1))
        L = int(rng.integers(1, 6))
        q[p:p] = list(ACGT[rng.integers(0, 4, L)])
    q = np.array(q, np.uint8)
    idx = rng.choice(len(q), min(n_sub, len(q)), replace=False)
    q[idx] = ACGT[rng.integers(0, 4, len(idx))]
    return q


def run_spec(pairs, R_cap, B, K=256):
    """Packed spec output for [(ref, qry, ms, W)] (one padding problem added)."""
    m = len(pairs) + 1
    ref = np.zeros((m, R_cap), np.uint8)
    qry = np.zeros((m, R_cap), np.uint8)
    ints = np.zeros((4, m), np.int32)
    for s, (r, q, ms, W) in enumerate(pairs):
        ref[s, : len(r)] = IUPAC_MASK[r]
        qry[s, : len(q)] = IUPAC_MASK[q]
        ints[:, s] = (len(r), len(q), ms, W)
    return np.asarray(stripe_align_spec(ref, qry, *ints, B=B, K=K))


def native_results(pairs):
    """(edit, boundary) per pair from the host C++ aligner at the same band."""
    out = stripe_align_batch_native(
        [p[0] for p in pairs], [p[1] for p in pairs],
        np.array([p[2] for p in pairs], np.int64), np.array([p[3] for p in pairs], np.int64),
        BandedAlignParams(), IUPAC_MASK, ops_cap=4096, subs_cap=8192,
    )
    res = []
    for s, (_r, q, _ms, _W) in enumerate(pairs):
        assert int(out["status"][s]) == 0
        ops, subs = out["ops"][s], out["subs"][s]
        e = _edit_from_rle_hostmatch(ops, len(ops), subs, len(subs), int(out["lead_ins"][s]), q)
        res.append((e, bool(out["boundary"][s])))
    return res


def assert_matches_host(pairs, R_cap, B, K=256):
    buf = run_spec(pairs, R_cap, B, K)
    for s, ((r, q, ms, W), (want, hb)) in enumerate(zip(pairs, native_results(pairs))):
        edit, ok, bnd = decode_packed(buf[s], K, r, q)
        assert ok, f"problem {s}: walk dead/overflow, meta={buf[s, :META]}"
        assert np.array_equal(edit.apply(r), q)
        assert edit == want, f"problem {s}: edits differ from the host aligner"
        assert bnd == hb, f"problem {s}: boundary flag differs"
    # the padding problem is inert and every unused event slot is zero
    assert not buf[-1].any()
    for s in range(len(pairs)):
        n = int(buf[s, 4])
        assert not buf[s, META + n : META + K].any() and not buf[s, META + K + n :].any()


@pytest.mark.parametrize("B", [128, 256, 512])
@pytest.mark.parametrize("kind", KINDS)
def test_v2_matches_host_aligner(kind, B):
    rng = np.random.default_rng([KINDS.index(kind), B])
    pairs = []
    for _ in range(4):
        n = int(rng.integers(150, 480))
        ref = ACGT[rng.integers(0, 4, n)]
        if kind == "identical":
            qry = ref.copy()
        elif kind == "subs":
            qry = mutate(ref, 10, 0, 0, rng)
        elif kind == "mixed":
            qry = mutate(ref, 5, 3, 3, rng)
        else:
            qry = mutate(ref, 15, 5, 5, rng)
        W = int(rng.integers(B // 4, (B - 1) // 2 + 1))
        pairs.append((ref, qry, 0, W))
    assert_matches_host(pairs, 512, B)
    # and with the numpy reference aligner
    for ref, qry, ms, W in pairs:
        buf = run_spec([(ref, qry, ms, W)], 512, B)
        edit, ok, _ = decode_packed(buf[0], 256, ref, qry)
        assert edit == map_variations(ref, qry, BandParameters(ms, W), BandedAlignParams(), 0)


def test_v2_terminal_gaps_and_shift():
    rng = np.random.default_rng(7)
    ref = ACGT[rng.integers(0, 4, 300)]
    pairs = [(as_seq(r), as_seq(q), 0, 40) for r, q in [(ref, ref[20:]), (ref, ref[:-25]), (ref[30:], ref), (ref[:-30], ref)]]
    qry = mutate(ref, 8, 2, 2, rng)
    pairs += [(ref, qry, ms, 40) for ms in (17, -13)]
    assert_matches_host(pairs, 512, 128)


def test_v2_multichunk():
    rng = np.random.default_rng(11)
    ref = ACGT[rng.integers(0, 4, 900)]
    qry = mutate(ref, 20, 4, 4, rng)
    assert_matches_host([(ref, qry, 0, 63)], 1024, 128)


def test_v2_non_power_of_two_tier_10240():
    """The 10240 R-cap tier (5 * 2048) holds ~9 kb pin-split pieces."""
    rng = np.random.default_rng(23)
    ref = ACGT[rng.integers(0, 4, 9000)]
    qry = mutate(ref, 90, 6, 6, rng)
    assert_matches_host([(ref, qry, 0, 63)], 10240, 128)


@pytest.mark.parametrize("W", [1, 2, 5, 12])
def test_v2_narrow_bands_hit_boundary_like_host(W):
    """Narrow bands against indels: boundary flags and band-capped edits
    must be the host aligner's."""
    rng = np.random.default_rng(W)
    pairs = []
    while len(pairs) < 6:
        ref = ACGT[rng.integers(0, 4, 300)]
        qry = mutate(ref, 6, 2, 2, rng)
        ms = int(rng.integers(-W, W + 1))
        if fits_band(len(ref), len(qry), ms, W):
            pairs.append((ref, qry, ms, W))
    assert_matches_host(pairs, 512, 128)


def test_v2_iupac_and_n():
    ref = as_seq("ACGTACGTACGTACNTACGTACGTAC")
    qry = as_seq("ACGTNCGTACRTACGTACGTWCGTAC")
    assert_matches_host([(ref, qry, 0, 5)], 512, 128)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_v2_batch_generator_pairs_match_host(seed):
    pairs, _arrays = make_align_batch(np.random.default_rng(seed), 6, 400, 512, 20)
    assert_matches_host(pairs, 512, 128)


@pytest.mark.parametrize(
    "rlen,qlen,ms,W,fits",
    [
        (100, 100, 0, 5, True),
        (100, 105, 0, 5, True),
        (100, 106, 0, 5, False),  # end corner outside the band
        (100, 100, 6, 5, False),  # origin outside the band
        (100, 95, -5, 5, False),
        (100, 110, -5, 5, True),
    ],
)
def test_fits_band(rlen, qlen, ms, W, fits):
    assert fits_band(rlen, qlen, ms, W) is fits


@pytest.mark.parametrize("W,B", [(0, 128), (63, 128), (64, 256), (127, 256), (500, 1024), (1023, 2048)])
def test_lanes_for_tiers(W, B):
    assert lanes_for(W) == B


def test_lanes_for_rejects_wider_bands():
    with pytest.raises(ValueError):
        lanes_for(1024)


def test_decode_merges_deletions_split_by_insertions():
    """A deletion run, an insertion, a deletion run (two OP_D events) is one
    Del, as the host aligner's insertion-strip semantics make it."""
    ref = as_seq("AAAACCCCGGGGTTTT")
    qry = as_seq("AAAAXGGGGTTTT")
    # walk order (descending row): D at row 6 (len 2), D at row 4 (len 2,
    # then one inserted char)
    rows = np.array([6, 4], np.int32)
    words = np.array([OP_D | (2 << 17), OP_D | (1 << 2) | (2 << 17)], np.int32)
    meta = np.zeros(4, np.int32)
    edit, ok = edit_from_events(rows, words, 2, meta, ref, qry)
    assert ok
    assert [(d.pos, d.len) for d in edit.dels] == [(4, 4)]
    assert np.array_equal(edit.apply(ref), qry)
