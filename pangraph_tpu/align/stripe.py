"""Banded affine-gap pairwise alignment on a diagonal stripe.

Semantics follow the reference re-aligner exactly
(`align/nextclade/align/score_matrix.rs`, `backtrace.rs`, `band_2d.rs:36-54`):

- stripe band parameterized by (mean_shift, band_width); first stripe reaches
  the origin, last stripe reaches the end corner,
- affine gaps with zero extension cost by default (a gap of any length costs
  `penalty_gap_open`), free terminal gaps on both sequences,
- IUPAC-compatible characters score as matches; 'N' matches anything at
  score_match-1,
- gap placement prefers query-gap > ref-gap > match on score ties and extends
  open gaps on ties (left-aligned gaps),
- boundary contact is recorded per cell; a traceback that touches the band
  edge reports hit_boundary so the caller can retry with a doubled band
  (`align/align.rs:55-63`).

The row recurrence is reformulated so every row is a vectorized update: with
gap-extend == 0 the in-row (ref-gap) dependency collapses to a running prefix
maximum, G[j] = max(G[j-1], H[j-1] - open)  ==  cummax(NQ - open), which is an
associative scan. The same formulation drives the numpy implementation here and
the batched device contract in `pangraph_tpu.ops.stripe_dp`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pangraph_tpu.align.params import BandedAlignParams
from pangraph_tpu.graph.seq import GAP, IUPAC_MASK, as_seq

# traceback bits (score_matrix.rs:8-15)
MATCH = 1
REF_GAP_MATRIX = 2
QRY_GAP_MATRIX = 4
REF_GAP_EXTEND = 8
QRY_GAP_EXTEND = 16
BOUNDARY = 32

NO_ALIGN = -1_000_000_000

_N = ord("N")


def simple_stripes(mean_shift: int, band_width: int, ref_len: int, qry_len: int) -> np.ndarray:
    """Per-row [begin, end) stripe bounds (band_2d.rs:36-54)."""
    i = np.arange(ref_len + 1, dtype=np.int64)
    begin = np.clip(-mean_shift - band_width + i, 0, qry_len)
    end = np.clip(-mean_shift + band_width + i + 1, 1, qry_len + 1)
    begin[0] = 0
    end[ref_len] = qry_len + 1
    return np.stack([begin, end], axis=1)


@dataclass
class StripeAlignment:
    qry_aln: np.ndarray  # uint8 with GAP
    ref_aln: np.ndarray
    score: int
    hit_boundary: bool


def align_banded(
    ref: np.ndarray, qry: np.ndarray, mean_shift: int, band_width: int, params: BandedAlignParams
) -> StripeAlignment:
    """One banded alignment (numpy reference path; production batches go
    through the JAX kernel)."""
    ref = as_seq(ref)
    qry = as_seq(qry)
    stripes = simple_stripes(mean_shift, band_width, len(ref), len(qry))
    scores, paths = _score_matrix(ref, qry, stripes, params)
    return _backtrace(ref, qry, stripes, scores, paths)


def _score_matrix(ref, qry, stripes, p: BandedAlignParams):
    R, Q = len(ref), len(qry)
    open_ = p.penalty_gap_open
    ext = p.penalty_gap_extend
    la = p.left_align
    if ext != 0:
        raise NotImplementedError("prefix-max row recurrence requires penalty_gap_extend == 0")

    ref_mask = IUPAC_MASK[ref].astype(np.int32)
    qry_mask = IUPAC_MASK[qry].astype(np.int32)
    ref_unknown = ref == _N
    qry_unknown = qry == _N

    # full-width running arrays (Q+1), updated IN PLACE on the band window
    # only: stale values outside the previous stripe are never read (the
    # diag_ok/up_ok masks restrict reads to the previous stripe), so each row
    # costs O(band), not O(Q) — this keeps Mbp-scale fallback jobs feasible
    H_prev = np.full(Q + 1, NO_ALIGN, dtype=np.int64)
    qry_gaps = np.full(Q + 1, NO_ALIGN, dtype=np.int64)

    paths_rows = [None] * (R + 1)
    # only the final row's scores are consumed (backtrace reads scores[R]);
    # retaining every row held O(R*band) int64 alive for no reason
    scores_rows = [None] * (R + 1)

    # row 0 (score_matrix.rs:61-80): free (or penalized) leading query insertion
    b0, e0 = stripes[0]
    row0_path = np.full(e0 - b0, REF_GAP_EXTEND + REF_GAP_MATRIX, dtype=np.int8)
    row0_path[0] = 0
    row0_score = np.zeros(e0 - b0, dtype=np.int64)
    if not p.left_terminal_gaps_free:
        row0_score[1:] = -open_ - ext * np.arange(e0 - b0 - 1, dtype=np.int64)
    paths_rows[0] = row0_path
    scores_rows[0] = row0_score
    H_prev[b0:e0] = row0_score

    prev_b, prev_e = b0, e0
    pprev_e = 0  # stripes[ri-2].end; unused at ri=1 (guarded by qry_gaps==NO_ALIGN there)

    for ri in range(1, R + 1):
        b, e = stripes[ri]
        w = e - b
        j = np.arange(b, e, dtype=np.int64)  # absolute qpos
        path = np.zeros(w, dtype=np.int8)

        # ---- match scores: diagonal (ri-1, qpos-1) must be inside previous stripe
        diag_ok = (j - 1 >= prev_b) & (j - 1 < prev_e) & (j >= 1)
        diag = np.where(diag_ok, H_prev[np.maximum(j - 1, 0)], NO_ALIGN)
        unknown = ref_unknown[ri - 1] | np.where(j >= 1, qry_unknown[np.minimum(j - 1, Q - 1)], False)
        compat = (ref_mask[ri - 1] & np.where(j >= 1, qry_mask[np.minimum(j - 1, Q - 1)], 0)) > 0
        msub = np.where(unknown, p.score_match - 1, np.where(compat, p.score_match, -p.penalty_mismatch))
        M = np.where(diag_ok, diag + msub, NO_ALIGN)
        # boundary flag when diagonal move is unavailable (score_matrix.rs:129-131)
        path |= np.where(~diag_ok & (j >= 1) & (ri < R) & (j < Q), BOUNDARY, 0).astype(np.int8)

        # ---- query gap (vertical), needs cell above inside previous stripe
        up_ok = (j < prev_e) & (j >= 1)
        q_free = p.right_terminal_gaps_free & (j == Q)
        q_ext_val = np.where(q_free, qry_gaps[j], qry_gaps[j] - ext)
        q_open_val = np.where(q_free, H_prev[j], H_prev[j] - open_)
        # extension allowed positionally when qpos < stripes[ri-2].end
        q_ext_allowed = (q_ext_val >= q_open_val) & (j < pprev_e)
        QG = np.where(up_ok, np.where(q_ext_allowed, q_ext_val, q_open_val), NO_ALIGN)
        path |= np.where(up_ok & q_ext_allowed, QRY_GAP_EXTEND, 0).astype(np.int8)
        # update running vertical-gap scores (score_matrix.rs:183-189)
        qry_gaps[j] = np.where(up_ok, QG, NO_ALIGN)
        path |= np.where(~up_ok & (j >= 1) & (j < Q) & (ri < R), BOUNDARY, 0).astype(np.int8)

        # ---- first column of the matrix (qpos == 0): leading query deletion;
        # must participate in the prefix max as the previous-cell H value
        first_col = b == 0
        if first_col:
            if p.left_terminal_gaps_free:
                h0 = 0
            else:
                h0 = -open_ if ri == 1 else int(H_prev[0]) - ext
            M[0] = h0  # acts as the cell value for the in-row gap chain
            QG[0] = NO_ALIGN

        # NQ = best of match/qry-gap per cell (value only; tie order fixed below)
        NQ = np.maximum(M, QG)

        # ---- ref gap (horizontal) via prefix max: G[k] = max(G[k-1], H[k-1]-open)
        # with H = max(NQ, G); collapses to cummax(NQ - open) (free at last row)
        r_free = p.right_terminal_gaps_free and ri == R
        gap_cost = 0 if r_free else open_
        shifted = np.concatenate(([NO_ALIGN], NQ[:-1] - gap_cost))
        G = np.maximum.accumulate(shifted)
        # ref-gap not allowed at the first stripe cell
        G[0] = NO_ALIGN
        # boundary when the horizontal move is positionally unavailable
        path |= np.where((j == b) & (j >= 1) & (ri < R) & (j < Q), BOUNDARY, 0).astype(np.int8)
        # extension flag: ties prefer continuing an open gap (score_matrix.rs:149)
        prevG = np.concatenate(([NO_ALIGN], G[:-1]))
        Hm1 = np.maximum(NQ, G)  # H[j-1] values shifted below
        r_open_prev = np.concatenate(([NO_ALIGN], Hm1[:-1] - gap_cost))
        r_ext_flag = (prevG - ext >= r_open_prev) & (np.arange(w) > 1)
        path |= np.where((G > NO_ALIGN) & r_ext_flag, REF_GAP_EXTEND, 0).astype(np.int8)

        # ---- combine with reference tie order: match, then ref gap (>= wins),
        # then qry gap (>= wins) — score_matrix.rs:91-192
        best_mr = np.where(G > M - la, G, M)
        origin_mr = np.where(G > M - la, np.int8(REF_GAP_MATRIX), np.int8(MATCH))
        H = np.where(QG > best_mr - la, QG, best_mr)
        origin = np.where(QG > best_mr - la, np.int8(QRY_GAP_MATRIX), origin_mr)

        if first_col:
            H[0] = h0
            origin[0] = QRY_GAP_MATRIX
            path[0] = QRY_GAP_EXTEND
        path |= origin

        paths_rows[ri] = path
        if ri == R:
            scores_rows[ri] = H

        H_prev[b:e] = H
        pprev_e = prev_e
        prev_b, prev_e = b, e

    return scores_rows, paths_rows


def _backtrace(ref, qry, stripes, scores_rows, paths_rows) -> StripeAlignment:
    """Rebuild aligned uint8 strings from traceback bits (backtrace.rs:17-100)."""
    R, Q = len(ref), len(qry)
    r_pos, q_pos = R, Q
    aln_ref = []
    aln_qry = []
    current_matrix = 0
    hit_boundary = False
    while r_pos > 0 or q_pos > 0:
        b = stripes[r_pos][0]
        origin = int(paths_rows[r_pos][q_pos - b])
        if origin & BOUNDARY:
            hit_boundary = True
        if (origin & MATCH) and current_matrix == 0:
            q_pos -= 1
            r_pos -= 1
            aln_qry.append(qry[q_pos])
            aln_ref.append(ref[r_pos])
        elif ((origin & REF_GAP_MATRIX) and current_matrix == 0) or current_matrix == REF_GAP_MATRIX:
            q_pos -= 1
            aln_qry.append(qry[q_pos])
            aln_ref.append(GAP)
            current_matrix = REF_GAP_MATRIX if origin & REF_GAP_EXTEND else 0
        elif ((origin & QRY_GAP_MATRIX) and current_matrix == 0) or current_matrix == QRY_GAP_MATRIX:
            aln_qry.append(GAP)
            r_pos -= 1
            aln_ref.append(ref[r_pos])
            current_matrix = QRY_GAP_MATRIX if origin & QRY_GAP_EXTEND else 0
        else:
            raise RuntimeError(
                f"Backtrace dead end at r_pos={r_pos}, q_pos={q_pos}, origin={origin}, matrix={current_matrix}"
            )
    score = int(scores_rows[R][Q - stripes[R][0]])
    return StripeAlignment(
        qry_aln=np.array(aln_qry[::-1], dtype=np.uint8),
        ref_aln=np.array(aln_ref[::-1], dtype=np.uint8),
        score=score,
        hit_boundary=hit_boundary,
    )


def align_with_retries(ref, qry, mean_shift: int, band_width: int, params: BandedAlignParams) -> StripeAlignment:
    """Banded alignment with band doubling on boundary hits
    (align/align.rs:32-73)."""
    ref = as_seq(ref)
    qry = as_seq(qry)
    if len(qry) < params.min_length:
        raise ValueError(f"Sequence too short to align: {len(qry)} < {params.min_length}")
    bw = band_width
    attempt = 1
    aln = align_banded(ref, qry, mean_shift, bw, params)
    while aln.hit_boundary and attempt < params.max_alignment_attempts:
        bw = max(2 * bw, max(1, abs(mean_shift)))
        attempt += 1
        aln = align_banded(ref, qry, mean_shift, bw, params)
    return aln
