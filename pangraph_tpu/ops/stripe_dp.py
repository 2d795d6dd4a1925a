"""Banded stripe DP with run-jump traceback: the device contract.

One call aligns a batch of m problems. Inputs (all padded to the batch):

- ``ref`` [m, R_cap] uint8 and ``qry`` [m, Qcap] uint8: IUPAC 4-bit masks
  (graph/seq.py IUPAC_MASK), zero past each sequence's end;
- ``rlen``, ``qlen``, ``ms``, ``W`` [m] int32: lengths, mean shift and band
  half-width of each problem.

Output: one int32 buffer [m, 5 + 2K] per batch, ``meta`` (lead insertion,
dead, boundary, pending insertion) | ``n_events`` | ``rows`` [K] | ``words``
[K]. Unused event slots are zero. `edit_from_events` decodes a problem's
slice into an Edit on the host.

The recurrence is the host aligner's (native/stripe.cpp, align/stripe.py),
cell for cell: row i holds the query positions q in [i-ms-W, i-ms+W] clipped
to [0, Q], stored in band lanes k = q - i + ms + W of a B-lane record row
(B >= 2W+1; lanes above 2W are dead). With zero gap extension the in-row
(ref-gap) dependency is an exclusive prefix max, the diagonal predecessor is
the same lane of the previous row and the vertical one the next lane up.
Scoring: match 3, mismatch -1, 'N' 2, gap open 6, extend 0, free terminal
gaps, ties to query gap > ref gap > match, gaps extended on ties.

Each cell's int16 record packs its origin bits with the length of the
diagonal (MATCH) run ending at it (bits | min(run, 1023) << 6), so the
traceback jumps whole match runs and costs O(events + length/1023) steps.
Indel runs become events: a deletion run is one word OP_D | ins_after << 2 |
del_len << 17 at its lowest row, a match row with a trailing insertion run
one word OP_M | ins_len << 2.

Two implementations honour the contract: the CUDA kernel (ops/cuda/stripe.cu,
one warp per problem), which serves the device leg on the GPU, and
`stripe_align_spec` below in plain `jax.lax`, the executable specification
that CPU tests and the chip smoke compare the kernel against. `stripe_kernel`
picks one per platform.

The problems a band can express exactly as the host does are those whose
start and end corners sit inside the band (`fits_band`); other jobs stay on
the host aligner.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

MATCH = 1
REF_GAP = 2
QRY_GAP = 4
REF_EXT = 8
QRY_EXT = 16
BOUNDARY = 32

NO_ALIGN = -(1 << 29)  # native/stripe.cpp NOAL
SCORE_MATCH = 3
PENALTY_MISMATCH = 1
GAP_OPEN = 6
RUN_CAP = (1 << 10) - 1  # run counter shares an int16 record with 6 origin bits

OP_M = 1
OP_D = 2
META = 5  # meta[4] + n_events ahead of the event rows and words

LANE_TIERS = (128, 256, 512, 1024, 2048)  # B: 32 x lanes-per-thread of the CUDA warp


def lanes_for(W: int) -> int:
    """Smallest record width B that holds a band of half-width W."""
    for b in LANE_TIERS:
        if 2 * W + 1 <= b:
            return b
    raise ValueError(f"band half-width {W} exceeds the widest lane tier {LANE_TIERS[-1]}")


def fits_band(rlen: int, qlen: int, ms: int, W: int) -> bool:
    """True when the host aligner's stripes equal the band exactly: the
    origin (row 0 and the column-0 rows) and the end corner (row R reaching
    q = Q) lie inside [i-ms-W, i-ms+W]."""
    return abs(ms) <= W and abs(qlen - rlen + ms) <= W


def stripe_kernel(platform: str) -> str:
    """Which implementation of the contract runs on a JAX platform: the CUDA
    kernel on the GPU, the lax spec on the CPU (tests and virtual meshes;
    production on a CPU-only machine runs the host aligner instead)."""
    kinds = {"gpu": "cuda", "cpu": "spec"}
    if platform not in kinds:
        raise ValueError(f"no stripe DP kernel for platform {platform!r}")
    return kinds[platform]


def has_device_kernel(platform: str = None) -> bool:
    """True when the platform has a device kernel that can take DP work from
    the host aligner."""
    return stripe_kernel(platform or jax.default_backend()) == "cuda"


def stripe_align(platform: str = None):
    """The jitted stripe contract for a platform:
    fn(ref, qry, rlen, qlen, ms, W, *, B, K) -> packed [m, META + 2K]."""
    if stripe_kernel(platform or jax.default_backend()) == "cuda":
        from pangraph_tpu.ops.cuda import stripe_align_cuda

        return stripe_align_cuda
    return stripe_align_spec


# ----------------------------------------------------------- the lax spec


def _shift_down(x, fill):
    """y[k] = x[k+1] (the next lane up), last lane = fill."""
    return jnp.concatenate([x[:, 1:], jnp.full_like(x[:, :1], fill)], axis=1)


def _shift_up(x, fill):
    """y[k] = x[k-1], lane 0 = fill."""
    return jnp.concatenate([jnp.full_like(x[:, :1], fill), x[:, :-1]], axis=1)


def _dp_spec(ref, qry, rlen, qlen, ms, W, B: int):
    """Records [m, R_cap, B] int16 (row i at index i-1); rows past rlen are 0."""
    m, R_cap = ref.shape
    Qcap = qry.shape[1]
    k = jnp.arange(B, dtype=jnp.int32)[None, :]
    ms_, W_, rlen_, qlen_ = ms[:, None], W[:, None], rlen[:, None], qlen[:, None]
    top = 2 * W_
    lane_ok = k <= top
    q_row0 = k - ms_ - W_
    H0 = jnp.where(lane_ok & (q_row0 >= 0) & (q_row0 <= qlen_), 0, NO_ALIGN).astype(jnp.int32)
    QG0 = jnp.full((m, B), NO_ALIGN, jnp.int32)
    run0 = jnp.zeros((m, B), jnp.int32)
    refT = ref.T.astype(jnp.int32)  # [R_cap, m]: one row's ref masks per scan step

    def row(carry, xs):
        H_prev, QG_prev, run_prev = carry
        i, rm = xs
        rm = rm[:, None]
        q = i + k - ms_ - W_
        live = i <= rlen_
        in_m = lane_ok & (q >= 0) & (q <= qlen_) & live
        lo = jnp.maximum(i - ms_ - W_, 0)  # lowest query position of the row
        s = q - lo  # index within the host aligner's stripe
        qm = jnp.take_along_axis(qry, jnp.clip(q - 1, 0, Qcap - 1), axis=1).astype(jnp.int32)

        H_up = _shift_down(H_prev, NO_ALIGN)
        QG_up = _shift_down(QG_prev, NO_ALIGN)
        diag_ok = (q >= 1) & in_m
        up_ok = (k < top) & (q >= 1) & in_m
        interior = (q >= 1) & (q < qlen_) & (i < rlen_) & in_m

        unknown = (rm == 15) | (qm == 15)
        msub = jnp.where(unknown, SCORE_MATCH - 1, jnp.where((rm & qm) > 0, SCORE_MATCH, -PENALTY_MISMATCH))
        M = jnp.where(diag_ok, H_prev + msub, NO_ALIGN)
        path = jnp.where(~diag_ok & interior, BOUNDARY, 0)

        q_open = jnp.where(q == qlen_, H_up, H_up - GAP_OPEN)
        q_ext = (QG_up >= q_open) & (k < top - 1) & (i >= 2)
        QG = jnp.where(up_ok, jnp.where(q_ext, QG_up, q_open), NO_ALIGN)
        path = path | jnp.where(up_ok & q_ext, QRY_EXT, 0) | jnp.where(~up_ok & interior, BOUNDARY, 0)

        first = (q == 0) & in_m
        M = jnp.where(first, 0, M)
        NQ = jnp.maximum(M, QG)

        gap_cost = jnp.where(i == rlen_, 0, GAP_OPEN)
        P = jnp.where(in_m, NQ - gap_cost, NO_ALIGN)
        G = _shift_up(jax.lax.cummax(P, axis=1), NO_ALIGN)
        G = jnp.where((s == 0) | ~in_m, NO_ALIGN, jnp.maximum(G, NO_ALIGN))
        path = path | jnp.where((s == 0) & interior, BOUNDARY, 0)
        Hm1 = jnp.maximum(NQ, G)
        r_ext = (G > NO_ALIGN) & (s > 1) & (_shift_up(G, NO_ALIGN) >= _shift_up(Hm1, NO_ALIGN) - gap_cost)
        path = path | jnp.where(r_ext, REF_EXT, 0)

        rsel = G >= M
        best = jnp.where(rsel, G, M)
        origin = jnp.where(rsel, REF_GAP, MATCH)
        qsel = QG >= best
        H = jnp.where(qsel, QG, best)
        origin = jnp.where(qsel, QRY_GAP, origin)
        H = jnp.where(first, 0, H)
        path = jnp.where(first, QRY_EXT | QRY_GAP, path | origin)
        H = jnp.where(in_m, H, NO_ALIGN)
        path = jnp.where(in_m, path, 0)
        run = jnp.where(((path & MATCH) > 0) & in_m, run_prev + 1, 0)
        rec = (path | (jnp.minimum(run, RUN_CAP) << 6)).astype(jnp.int16)

        new = (
            jnp.where(live, H, H_prev),
            jnp.where(live, jnp.where(up_ok, QG, NO_ALIGN), QG_prev),
            jnp.where(live, run, run_prev),
        )
        return new, rec

    rows = jnp.arange(1, R_cap + 1, dtype=jnp.int32)
    _, recs = jax.lax.scan(row, (H0, QG0, run0), (rows, refT))
    return jnp.transpose(recs, (1, 0, 2))


def _walk_spec(recs, rlen, qlen, ms, W, K: int):
    """Run-jump traceback of every problem in lockstep -> packed buffer."""
    m, R_cap, B = recs.shape
    flat = recs.reshape(m, R_cap * B)
    p = jnp.arange(m)
    top = 2 * W
    z = jnp.zeros(m, jnp.int32)
    state = (rlen, qlen, z, z, z, z, z, z, z, jnp.zeros((m, K), jnp.int32), jnp.zeros((m, K), jnp.int32))

    def active(st):
        i, _q, _s, _ins, _dl, _ia, _cnt, dead, *_ = st
        return (i > 0) & (dead == 0)

    def body(st):
        i, q, s, ins, dl, ia, cnt, dead, bnd, ev_rows, ev_words = st
        act = active(st)
        k = q - i + ms + W
        in_band = act & (k >= 0) & (k <= top) & (q >= 0)
        idx = jnp.clip((i - 1) * B + k, 0, R_cap * B - 1)
        word = jnp.where(in_band, flat[p, idx].astype(jnp.int32), 0) & 0xFFFF
        bits = word & 63
        runv = word >> 6
        bnd = bnd | (act & ((bits & BOUNDARY) > 0)).astype(jnp.int32)

        take_m = (s == 0) & ((bits & MATCH) > 0)
        take_i = ((s == 0) & ((bits & REF_GAP) > 0) & ~take_m) | (s == REF_GAP)
        take_d = ((s == 0) & ((bits & QRY_GAP) > 0) & ~take_m & ~take_i) | (s == QRY_GAP)
        live = act & (bits != 0) & (take_m | take_i | take_d)
        dead = jnp.where(act & ~live, 1, dead)

        # a non-D move ends a pending deletion run (emitted at its lowest
        # row, the current i); an M move with a trailing insertion run emits
        # its own event. The two never coincide: dl > 0 implies ins == 0.
        emit_d = live & (take_m | take_i) & (dl > 0)
        emit_m = live & take_m & (ins > 0) & (dl == 0)
        emit = emit_d | emit_m
        row_e = jnp.where(emit_d, i, i - 1)
        word_e = jnp.where(emit_d, OP_D | (ia << 2) | (dl << 17), OP_M | (ins << 2))
        slot = jnp.minimum(cnt, K - 1)
        ev_rows = ev_rows.at[p, slot].set(jnp.where(emit, row_e, ev_rows[p, slot]))
        ev_words = ev_words.at[p, slot].set(jnp.where(emit, word_e, ev_words[p, slot]))
        cnt = cnt + emit.astype(jnp.int32)
        ia = jnp.where(live & take_d & (dl == 0), ins, jnp.where(emit_d, 0, ia))
        dl = jnp.where(live & take_d, dl + 1, jnp.where(emit_d, 0, dl))

        new_s = jnp.where(
            take_i,
            jnp.where((bits & REF_EXT) > 0, REF_GAP, 0),
            jnp.where(take_d, jnp.where((bits & QRY_EXT) > 0, QRY_GAP, 0), s),
        )
        # match-run jump over L diagonal cells. The jumped cells share lane k,
        # so they carry BOUNDARY exactly when k is a band edge and the cell
        # below the read one is interior.
        L = jnp.where(take_m, jnp.minimum(jnp.maximum(runv, 1), i), 0)
        edge = (k == 0) | (k == top)
        bnd = bnd | (live & take_m & (L >= 2) & edge & (q >= 2)).astype(jnp.int32)
        di = jnp.where(take_m, L, jnp.where(take_d, 1, 0))
        dq = jnp.where(take_m, L, jnp.where(take_i, 1, 0))
        i = jnp.where(live, i - di, i)
        q = jnp.where(live, q - dq, q)
        ins = jnp.where(live, jnp.where(take_i, ins + 1, jnp.where(take_m | take_d, 0, ins)), ins)
        s = jnp.where(live, new_s, s)
        return i, q, s, ins, dl, ia, cnt, dead, bnd, ev_rows, ev_words

    st = jax.lax.while_loop(lambda st: jnp.any(active(st)), body, state)
    i, q, _s, ins, dl, ia, cnt, dead, bnd, ev_rows, ev_words = st
    # a deletion run reaching row 0 is flushed once, at the end of the walk
    flush = (i == 0) & (dead == 0) & (dl > 0)
    slot = jnp.minimum(cnt, K - 1)
    ev_rows = ev_rows.at[p, slot].set(jnp.where(flush, 0, ev_rows[p, slot]))
    ev_words = ev_words.at[p, slot].set(jnp.where(flush, OP_D | (ia << 2) | (dl << 17), ev_words[p, slot]))
    cnt = cnt + flush.astype(jnp.int32)
    meta = jnp.stack([q, dead | (i > 0).astype(jnp.int32), bnd, ins, cnt], axis=1)
    return jnp.concatenate([meta, ev_rows, ev_words], axis=1)


@functools.partial(jax.jit, static_argnames=("B", "K"))
def stripe_align_spec(ref, qry, rlen, qlen, ms, W, *, B: int, K: int):
    """The contract in plain jax.lax: one scan step per DP row, one while
    step per traceback move of the batch."""
    recs = _dp_spec(ref, qry, rlen, qlen, ms, W, B)
    return _walk_spec(recs, rlen, qlen, ms, W, K)


# ------------------------------------------------------------- host decode


def edit_from_events(rows, words, n_events, meta, ref: np.ndarray, qry: np.ndarray):
    """Host decode: run-compressed event list -> Edit, fully vectorized.

    Conventions (edits.rs, map_variations.rs:70-73): Sub.pos / Del.pos are
    0-based reference positions; Ins.pos is the reference position *after*
    which the insertion sits. Event word layout: op in bits 0-1; insertion-run
    length in bits 2-16; deletion-run length in bits 17-31. An OP_D event at
    row x deletes ref[x .. x+del_len) and inserts ins_len query chars at
    position x+del_len; an OP_M event at row x is a diagonal move with ins_len
    chars inserted at x+1. Rows not covered by events are implicit diagonal
    moves (substitutions recovered by compare). Deletion runs separated only
    by insertions merge into one Del, as in the host aligner's
    insertion-strip semantics (ops/batch_align._edit_from_rle_hostmatch).
    Returns (edit, ok) — ok False when the walk died or events overflowed."""
    from pangraph_tpu.graph.edits import Del, Edit, Ins, Sub

    K = rows.shape[0]
    lead, dead, _bnd, pend_ins = int(meta[0]), int(meta[1]), int(meta[2]), int(meta[3])
    n = int(n_events)
    if dead or n > K:
        return None, False
    rlen, qlen = len(ref), len(qry)
    q0 = lead + pend_ins  # query chars consumed before any ref row

    if n == 0:
        if q0 + rlen != qlen:
            return None, False
        d = np.nonzero(ref != qry[q0:])[0]
        subs = [Sub(int(i), chr(int(qry[q0 + i]))) for i in d]
        inss = [Ins(0, bytes(qry[:q0]).decode())] if q0 else []
        return Edit(subs=subs, dels=[], inss=inss), True

    # events arrive in walk order (descending row); flip to forward order
    xs = rows[:n][::-1].astype(np.int64)
    ws = words[:n][::-1].astype(np.int64)
    ops = ws & 3
    ins_len = (ws >> 2) & 0x7FFF
    del_len = ws >> 17
    is_d = ops == OP_D
    dlen = np.where(is_d, del_len, 0)

    # deleted-row mask via run difference array; insertion chars attach after
    # the event's last consumed ref row (before ref position `attach`)
    dmark = np.zeros(rlen + 2, dtype=np.int64)
    np.add.at(dmark, xs[is_d], 1)
    np.add.at(dmark, xs[is_d] + dlen[is_d], -1)
    del_mask = np.cumsum(dmark[: rlen + 1]) > 0
    attach = np.where(is_d, xs + dlen, xs + 1)
    ins_at = np.zeros(rlen + 1, dtype=np.int64)
    np.add.at(ins_at, attach, ins_len)
    nd_excl = np.zeros(rlen + 1, dtype=np.int64)
    np.cumsum(del_mask[:rlen], out=nd_excl[1:])  # deletions strictly before i
    ins_cum = np.cumsum(ins_at)  # ins chars attached at indices <= i
    if q0 + (rlen - nd_excl[rlen]) + ins_cum[rlen] != qlen:
        return None, False

    # substitutions: every non-deleted ref position i aligns to query position
    # q0 + (#non-deleted ref < i) + (#ins chars attached at indices <= i)
    idx = np.arange(rlen, dtype=np.int64)
    q_of = q0 + (idx - nd_excl[:rlen]) + ins_cum[:rlen]
    mi = np.nonzero(~del_mask[:rlen])[0]
    dif = mi[ref[mi] != qry[q_of[mi]]]
    subs = [Sub(int(i), chr(int(qry[q_of[i]]))) for i in dif]

    dels = []
    for t in np.nonzero(is_d)[0]:
        x, L = int(xs[t]), int(dlen[t])
        if dels and dels[-1].end == x:
            dels[-1] = Del(dels[-1].pos, dels[-1].len + L)
        else:
            dels.append(Del(x, L))

    # insertions: event inserts qry[q_op : q_op+ins_len] at ref position
    # `attach`, where q_op = query consumed through the event's op
    inss = [Ins(0, bytes(qry[:q0]).decode())] if q0 else []
    it = np.nonzero(ins_len > 0)[0]
    if len(it):
        a_it = attach[it]
        q_op = q0 + (a_it - nd_excl[a_it]) + (ins_cum[a_it] - ins_len[it])
        for t, av, qs in zip(it, a_it, q_op):
            inss.append(Ins(int(av), bytes(qry[int(qs) : int(qs) + int(ins_len[t])]).decode()))
    return Edit(subs=subs, dels=dels, inss=inss), True


def decode_packed(buf: np.ndarray, K: int, ref: np.ndarray, qry: np.ndarray):
    """(edit, ok, boundary) from one problem's row of the packed buffer."""
    meta = buf[:4]
    edit, ok = edit_from_events(buf[META : META + K], buf[META + K : META + 2 * K], buf[4], meta, ref, qry)
    return edit, ok, bool(meta[2])
