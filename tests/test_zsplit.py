"""Direct unit tests for the z-drop analog `_split_low_identity`
(VERDICT r2 weak #5: previously only exercised incidentally via build e2e).

The reference's minimap2 z-drops extension across unalignable regions
(minimap2-sys/minimap2/align.c), so e.g. an inversion inside a chain span
yields two separate hits whose gap becomes its own reverse-strand block.
Our banded extension has no z-drop; `_split_low_identity` re-creates the
behaviour by splitting an Edit at any ZSPLIT_WINDOW with substitution
density above ZSPLIT_MAX_SUBFRAC (an inversion is ~75% mismatch, far above
any plausible homology at asm-preset divergences <= 20%)."""
from __future__ import annotations

import numpy as np

from pangraph_tpu.align.mapper import (
    ZSPLIT_MAX_SUBFRAC,
    ZSPLIT_MIN_KEEP,
    ZSPLIT_WINDOW,
    _split_low_identity,
)
from pangraph_tpu.graph.edits import Del, Edit, Ins, Sub

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _mutate(ref: np.ndarray, positions) -> list:
    """Substitutions at `positions`, each to a different base."""
    return [Sub(int(p), "ACGT"[(int(np.searchsorted(ACGT, ref[p])) + 1) % 4]) for p in positions]


def test_low_divergence_edit_not_split():
    """~1% substitutions (normal homology) must pass through whole-span."""
    rng = np.random.default_rng(0)
    L = 2000
    ref = ACGT[rng.integers(0, 4, L)]
    subs = _mutate(ref, rng.choice(L, L // 100, replace=False))
    out = _split_low_identity(Edit(subs=subs, dels=[], inss=[]), L)
    assert out == [(0, L, Edit(subs=subs, dels=[], inss=[]), 0, None)]


def test_short_span_fast_path():
    """Spans shorter than 3 windows are never split (too little context)."""
    L = 3 * ZSPLIT_WINDOW - 1
    subs = [Sub(p, "A") for p in range(0, L, 2)]  # 50% divergent everywhere
    out = _split_low_identity(Edit(subs=subs, dels=[], inss=[]), L)
    assert len(out) == 1 and out[0][4] is None


def test_inversion_pile_splits_span():
    """A dense substitution pile (inversion signature) splits the span into
    the two flanking intervals, with sub positions rebased and query offsets
    exact (verified against Edit.apply as the oracle)."""
    rng = np.random.default_rng(1)
    L = 1000
    ref = ACGT[rng.integers(0, 4, L)]
    # 50% divergence in [400, 600): subs at every even position
    pile = list(range(400, 600, 2))
    flank = [50, 700]  # one real sub in each flank
    subs = _mutate(ref, sorted(pile + flank))
    edit = Edit(subs=subs, dels=[], inss=[])
    out = _split_low_identity(edit, L)
    assert len(out) == 2
    (a1, b1, e1, q1, ql1), (a2, b2, e2, q2, ql2) = out
    # a window [i, i+100) is bad when > 40 of its positions are subs, i.e. it
    # contains >= 41 even pile positions: i in [381, 518]
    # -> bad cover = [381, 618)
    assert (a1, b1) == (0, 381)
    assert (a2, b2) == (618, 1000)
    assert [s.pos for s in e1.subs] == [50]
    assert [s.pos for s in e2.subs] == [700 - 618]
    # no indels: query offset == ref offset, lengths match interval
    assert (q1, ql1) == (0, 381)
    assert (q2, ql2) == (618, 382)
    # oracle: the sub-edit applied to the ref interval reproduces exactly the
    # corresponding query slice of the full-span alignment
    qry = edit.apply(ref)
    for a, b, e, q0, qlen in out:
        assert np.array_equal(e.apply(ref[a:b]), qry[q0 : q0 + qlen])


def test_segments_below_min_keep_dropped():
    """Good runs shorter than ZSPLIT_MIN_KEEP (= one block) are dropped."""
    rng = np.random.default_rng(2)
    L = 900
    ref = ACGT[rng.integers(0, 4, L)]
    # two piles leaving a short good island between them
    pile = list(range(200, 400, 2)) + list(range(460, 660, 2))
    subs = _mutate(ref, sorted(set(pile)))
    out = _split_low_identity(Edit(subs=subs, dels=[], inss=[]), L)
    # bad covers ~[121, 479) and ~[381, 739) -> island [479, 381) empty; only
    # flanks survive, and both are >= MIN_KEEP
    assert all(b - a >= ZSPLIT_MIN_KEEP for a, b, *_ in out)
    assert len(out) == 2
    assert out[0][0] == 0 and out[1][1] == L


def test_query_offsets_with_indels():
    """Deletions/insertions before and inside kept intervals shift the query
    offset bookkeeping; Edit.apply is the oracle."""
    rng = np.random.default_rng(3)
    L = 1200
    ref = ACGT[rng.integers(0, 4, L)]
    pile = list(range(500, 700, 2))
    subs = _mutate(ref, pile)
    dels = [Del(100, 10), Del(800, 5)]  # one before the pile, one in flank 2
    inss = [Ins(50, "ACGT"), Ins(900, "TT")]
    edit = Edit(subs=subs, dels=dels, inss=inss)
    out = _split_low_identity(edit, L)
    assert len(out) == 2
    qry = edit.apply(ref)
    for a, b, e, q0, qlen in out:
        assert np.array_equal(e.apply(ref[a:b]), qry[q0 : q0 + qlen]), (a, b)


def test_constants_documented_invariants():
    """The detector threshold must sit between plausible homology (asm20 ~= 20%
    divergence) and an inversion's ~75% mismatch; the keep floor matches the
    reference's minimum block length (split_matches.rs indel_len_threshold)."""
    assert 0.20 < ZSPLIT_MAX_SUBFRAC < 0.75
    assert ZSPLIT_MIN_KEEP == 100
    assert ZSPLIT_WINDOW == 100


def test_anchor_split_stitched_alignment_applies_exactly():
    """Anchor-split chain alignment (mapper.CHAIN_SEG pieces) must stitch to
    an Edit that reproduces the query exactly — same oracle the roundtrip
    relies on — and match the whole-span alignment's cell-count reduction."""
    from pangraph_tpu.align import mapper as mp
    from pangraph_tpu.align.params import BandedAlignParams
    from pangraph_tpu.ops.batch_align import BatchAligner

    rng = np.random.default_rng(9)
    L = 300_000
    ref = ACGT[rng.integers(0, 4, L)]
    qry = list(ref)
    # ~0.5% subs + a few indels so the local diagonals drift
    for p in rng.choice(L - 200, 40, replace=False):
        q = int(p)
        if rng.random() < 0.5:
            del qry[q : q + int(rng.integers(1, 30))]
        else:
            qry[q:q] = list(ACGT[rng.integers(0, 4, int(rng.integers(1, 30)))])
    qry = np.array(qry, np.uint8)
    idx = rng.choice(len(qry), int(L * 0.005), replace=False)
    qry[idx] = ACGT[(np.searchsorted(ACGT, qry[idx]) + rng.integers(1, 4, len(idx))) % 4]

    params = mp.MapperParams()
    from pangraph_tpu.align.minimizer import sketch

    rmm = sketch(ref, params.k, params.w)
    qmm = sketch(qry, params.k, params.w)
    # anchors: exact shared minimizers, forward strand
    common, ri, qi = np.intersect1d(rmm.values, qmm.values, return_indices=True)
    cr = rmm.positions[ri]
    cq = qmm.positions[qi]
    order = np.argsort(cr)
    cr, cq = cr[order], cq[order]
    mono = np.concatenate(([True], np.diff(cq) > 0))
    cr, cq = cr[mono], cq[mono]
    job = mp._prepare_chain_job(
        ref, qry, None, "r", "q", len(ref), len(qry), cr, cq, 0, params
    )
    assert job.segments is not None and len(job.segments) >= 3
    # pieces' DP area must be far below the whole-span area
    span_cells = len(job.ref_seg) * (2 * job.band_width + 2)
    piece_cells = sum((r1 - r0) * (2 * bw + 2) for r0, r1, q0, q1, ms, bw in job.segments)
    assert piece_cells < span_cells
    al = BatchAligner(BandedAlignParams())
    (edit,) = mp._align_chain_jobs([job], BandedAlignParams(), al)
    assert np.array_equal(edit.apply(job.ref_seg), job.qry_seg)


def test_pin_split_realign_applies_exactly():
    """Pin-split re-alignment (jobsplit.split_by_prior): a long job split at
    indel-free pins of the prior edits must stitch to an Edit with
    edit.apply(ref) == qry, matching the whole-job alignment oracle."""
    from pangraph_tpu.align.jobsplit import split_by_prior
    from pangraph_tpu.align.params import BandedAlignParams, BandParameters
    from pangraph_tpu.graph.edits import Del as D, Edit as E, Ins as I
    from pangraph_tpu.ops.batch_align import AlignJob, BatchAligner

    rng = np.random.default_rng(17)
    L = 120_000
    old = ACGT[rng.integers(0, 4, L)]
    # maj: old -> ref (a few indels + subs); e: old -> qry
    maj = E(
        subs=_mutate(old, rng.choice(L, 60, replace=False)),
        dels=[D(10_000, 7), D(70_123, 3)],
        inss=[I(40_050, "ACGTAG")],
    )
    e = E(
        subs=_mutate(old, rng.choice(L, 300, replace=False)),
        dels=[D(25_777, 12), D(90_001, 2)],
        inss=[I(55_500, "TTGA"), I(110_200, "C")],
    )
    ref = maj.apply(old)
    qry = e.apply(old)
    segs = split_by_prior(maj, [e], L, len(ref), len(qry))
    assert segs is not None and len(segs) >= 5
    # boundaries tile both sequences exactly
    assert segs[0][0] == 0 and segs[-1][1] == len(ref)
    assert segs[0][2] == 0 and segs[-1][3] == len(qry)
    for a, b in zip(segs, segs[1:]):
        assert a[1] == b[0] and a[3] == b[2]
    # local bands are small (each piece holds at most a couple of indels)
    assert max(bw for *_, bw in segs) < 50
    al = BatchAligner(BandedAlignParams())
    (edit,) = al.align_many([AlignJob(ref, qry, BandParameters(0, 40), segments=segs)])
    assert np.array_equal(edit.apply(ref), qry)
    # and matches the unsplit alignment byte-for-byte on reconstruction
    (whole,) = al.align_many([AlignJob(ref, qry, BandParameters(0, 40))])
    assert np.array_equal(whole.apply(ref), qry)


def test_graph_invariant_across_pin_split_plans():
    """The split plan is an execution detail: the SAME graph (ids, blocks,
    edits) must come out whether re-alignment jobs are cut into 8 kb or
    16 kb pieces (r3 retune guard — a trajectory change here means the
    stitch or band plan altered alignments)."""
    import pangraph_tpu.align.jobsplit as js
    from pangraph_tpu.align.params import BuildArgs
    from pangraph_tpu.build.build import build, verify_roundtrip
    from pangraph_tpu.io.fasta import FastaRecord

    rng = np.random.default_rng(23)
    L = 40_000
    base = ACGT[rng.integers(0, 4, L)]
    recs = []
    for i in range(3):
        g = base.copy()
        idx = rng.choice(L, L // 150, replace=False)
        g[idx] = ACGT[rng.integers(0, 4, len(idx))]
        g = list(g)
        for _ in range(4):
            p = int(rng.integers(200, len(g) - 200))
            if rng.random() < 0.5:
                del g[p : p + int(rng.integers(1, 9))]
            else:
                g[p:p] = list(ACGT[rng.integers(0, 4, int(rng.integers(1, 9)))])
        recs.append(FastaRecord(seq_name=f"g{i}", desc=None, seq=np.array(g, np.uint8), index=i))

    args = BuildArgs(circular=False)
    old_defaults = js.split_by_prior.__defaults__
    graphs = []
    try:
        for seg in (8192, 16384):
            js.split_by_prior.__defaults__ = (seg, js.MARGIN, 12)
            g = build(recs, args)
            verify_roundtrip(g, recs)
            graphs.append(g)
    finally:
        js.split_by_prior.__defaults__ = old_defaults
    a, b = graphs
    assert sorted(a.blocks) == sorted(b.blocks)  # content-hashed ids
    for bid in a.blocks:
        assert np.array_equal(a.blocks[bid].consensus, b.blocks[bid].consensus)
        assert a.blocks[bid].alignments == b.blocks[bid].alignments


def test_zsplit_event_sweep_matches_dense_reference():
    """The O(n_subs) event-based bad-region construction in
    _split_low_identity must reproduce the dense per-position window scan
    exactly (intervals, sliced edits, query offsets/lengths)."""
    from pangraph_tpu.align.mapper import (
        ZSPLIT_MAX_SUBFRAC, ZSPLIT_MIN_KEEP, ZSPLIT_WINDOW, _split_low_identity,
    )
    from pangraph_tpu.graph.edits import Del, Edit, Ins, Sub

    def dense(edit, L):
        n_subs, w = len(edit.subs), ZSPLIT_WINDOW
        if L < 3 * w or n_subs < int(w * ZSPLIT_MAX_SUBFRAC):
            return [(0, L, edit, 0, None)]
        sub_pos = np.fromiter((s.pos for s in edit.subs), np.int64, n_subs)
        c = np.concatenate(([0], np.cumsum(np.bincount(sub_pos, minlength=L))))
        bad_start = (c[w:] - c[:-w]) > int(w * ZSPLIT_MAX_SUBFRAC)
        if not bad_start.any():
            return [(0, L, edit, 0, None)]
        mark = np.zeros(L + 1, np.int64)
        bs = np.flatnonzero(bad_start)
        np.add.at(mark, bs, 1)
        np.add.at(mark, bs + w, -1)
        good = ~(np.cumsum(mark[:L]) > 0)
        d = np.diff(good.astype(np.int8))
        starts = np.flatnonzero(d == 1) + 1
        ends = np.flatnonzero(d == -1) + 1
        if good[0]:
            starts = np.concatenate(([0], starts))
        if good[-1]:
            ends = np.concatenate((ends, [L]))
        del_mask = np.zeros(L + 1, np.int64)
        for dl in edit.dels:
            del_mask[dl.pos] += 1
            del_mask[min(dl.pos + dl.len, L)] -= 1
        del_cum = np.concatenate(([0], np.cumsum(np.cumsum(del_mask[:L]) > 0)))
        ins_at = np.zeros(L + 1, np.int64)
        for ins in edit.inss:
            ins_at[ins.pos] += len(ins.seq)
        ins_cum = np.concatenate(([0], np.cumsum(ins_at)))
        out = []
        for a, b in zip(starts, ends):
            a, b = int(a), int(b)
            if b - a < ZSPLIT_MIN_KEEP:
                continue
            subs = [Sub(s.pos - a, s.alt) for s in edit.subs if a <= s.pos < b]
            dels = []
            for dl in edit.dels:
                s0, e0 = max(dl.pos, a), min(dl.pos + dl.len, b)
                if e0 > s0:
                    dels.append(Del(s0 - a, e0 - s0))
            inss = [Ins(i.pos - a, i.seq) for i in edit.inss if a < i.pos < b]
            q0 = a - int(del_cum[a]) + int(ins_cum[a + 1])
            q_len = (b - a) - sum(d.len for d in dels) + sum(len(i.seq) for i in inss)
            out.append((a, b, Edit(subs=subs, dels=dels, inss=inss), q0, q_len))
        return out

    rng = np.random.default_rng(31)
    for trial in range(120):
        L = int(rng.integers(300, 6000))
        pos = set(rng.integers(0, L, int(rng.integers(0, L // 50 + 2))).tolist())
        for _ in range(int(rng.integers(0, 3))):
            c0 = int(rng.integers(0, max(1, L - 150)))
            pos |= set((c0 + rng.integers(0, 140, int(rng.integers(40, 90)))).tolist())
        subs = [Sub(int(p), "ACGT"[int(rng.integers(0, 4))]) for p in sorted(pos) if p < L]
        dels, at = [], 0
        while at < L - 20 and rng.random() < 0.6:
            p = at + int(rng.integers(1, 200))
            ln = int(rng.integers(1, 12))
            if p + ln >= L:
                break
            dels.append(Del(p, ln))
            at = p + ln + 1
        inss = [
            Ins(int(p), "ACGT"[: int(rng.integers(1, 5))])
            for p in sorted(set(rng.integers(0, L + 1, int(rng.integers(0, 6))).tolist()))
        ]
        e = Edit(subs=subs, dels=dels, inss=inss)
        got, want = _split_low_identity(e, L), dense(e, L)
        assert len(got) == len(want), trial
        for g, want_piece in zip(got, want):
            assert g[0] == want_piece[0] and g[1] == want_piece[1], trial
            assert g[2] == want_piece[2] and g[3] == want_piece[3] and g[4] == want_piece[4], trial
