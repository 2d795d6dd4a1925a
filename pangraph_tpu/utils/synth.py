"""Deterministic synthetic pangenome generators for benchmarks and tests.

Two models:

- ``make_synthetic``: one ancestor + per-descendant point mutations, short
  indels, segmental inversions and a circular rotation. Mutation-only: the
  built graph has core fraction ~1.0 and tens of blocks — useful for DP
  throughput scaling, NOT representative of real pangenome structure.

- ``make_accessory_pangenome``: adds a shared accessory-segment pool with
  per-genome presence/absence plus IS-like repeated elements, shaped after
  the reference's published E. coli pangenome statistics
  (docs/docs/tutorial/t02-pangraph-output-file.md:220-225,304 — 7.8 Mbp
  pangenome, 3.78 Mbp core genome, bimodal block-frequency distribution):
  at 10 x 4.6 Mbp it yields core fraction ~0.5 and >10^3 blocks, exercising
  the merge trajectory and graph bookkeeping at realistic block counts.
"""
from __future__ import annotations

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)

_COMP = np.zeros(256, np.uint8)
_COMP[ord("A")], _COMP[ord("C")], _COMP[ord("G")], _COMP[ord("T")] = (
    ord("T"), ord("G"), ord("C"), ord("A"),
)


def _mutate(g: np.ndarray, rng, sub_rate: float) -> np.ndarray:
    """Per-genome mutation model shared by both generators: ~sub_rate
    substitutions, ~1 short indel / 15 kb, 1-2 segmental inversions
    (reverse-complemented 3-10 kb windows), and a circular rotation."""
    length = len(g)
    n_sub = int(length * sub_rate)
    idx = rng.choice(length, n_sub, replace=False)
    g = g.copy()
    g[idx] = ACGT[(np.searchsorted(ACGT, g[idx]) + rng.integers(1, 4, n_sub)) % 4]
    gl = list(g)
    for _ in range(max(1, length // 15_000)):
        p = int(rng.integers(100, len(gl) - 100))
        L = int(rng.integers(1, 12))
        if rng.random() < 0.5:
            del gl[p : p + L]
        else:
            gl[p:p] = list(ACGT[rng.integers(0, 4, L)])
    g = np.array(gl, np.uint8)
    for _ in range(int(rng.integers(1, 3))):
        hi = min(10_000, len(g) // 3)
        if hi <= 3_000:
            break  # genome too short for a 3-10 kb inversion
        L = int(rng.integers(3_000, hi))
        p = int(rng.integers(0, len(g) - L))
        g[p : p + L] = _COMP[g[p : p + L]][::-1]
    return np.roll(g, int(rng.integers(0, len(g))))


def make_synthetic(n_genomes: int, length: int, seed: int = 0, sub_rate: float = 0.01):
    """Mutation-only synthetic pangenome: one ancestor, descendants with
    ~sub_rate substitutions, short indels, inversions, and a rotation each.
    Every pair is ~2*sub_rate divergent; the built graph is almost all core."""
    from pangraph_tpu.io.fasta import FastaRecord

    rng = np.random.default_rng(seed)
    ancestor = ACGT[rng.integers(0, 4, length)]
    return [
        FastaRecord(seq_name=f"synth_{gi}", desc="", seq=_mutate(ancestor, rng, sub_rate), index=gi)
        for gi in range(n_genomes)
    ]


def make_accessory_pangenome(
    n_genomes: int,
    genome_len: int,
    seed: int = 0,
    sub_rate: float = 0.005,
    n_seg: int = None,
    core_frac_of_genome: float = 0.72,
):
    """Accessory-genome synthetic pangenome (see module docstring).

    Structure per genome: a shared core (``core_frac_of_genome`` of the
    genome-length target) interleaved with accessory segments drawn from a
    shared pool. Each pool segment has a FIXED ancestral insertion locus
    (inherited — genomes sharing a segment share its flanks, so the builder
    can merge them) and a bimodal presence probability: ~25% of segments are
    near-core (p=0.8), the rest rare (p set so the expected accessory bp per
    genome fills the genome-length target). A few short IS-like elements
    recur at 2-4 loci each (duplicated blocks). Mutations via ``_mutate``.
    """
    from pangraph_tpu.io.fasta import FastaRecord

    rng = np.random.default_rng(seed)
    core_len = int(genome_len * core_frac_of_genome)
    acc_target = genome_len - core_len
    lo = max(300, min(1_000, genome_len // 500))
    hi = max(2 * lo, min(25_000, genome_len // 200))
    mean_seg = (np.exp(np.log(hi)) - np.exp(np.log(lo))) / max(np.log(hi) - np.log(lo), 1e-9)
    if n_seg is None:
        # pool sized so mean presence lands ~0.29 (bimodal: 0.8 / ~0.12),
        # capped so core pieces between loci average >= 2 kb
        n_seg = int(min(acc_target * 3.5 / mean_seg, core_len / 2_000))
        n_seg = max(12, n_seg)
    seg_lens = np.exp(rng.uniform(np.log(lo), np.log(hi), n_seg)).astype(int)
    common = rng.random(n_seg) < 0.25
    common_bp = int((seg_lens * common).sum())
    rare_bp = int((seg_lens * ~common).sum())
    p_common = 0.8
    p_rare = float(np.clip((acc_target - p_common * common_bp) / max(rare_bp, 1), 0.02, 0.6))
    pres_p = np.where(common, p_common, p_rare)
    loci = np.sort(rng.choice(core_len, n_seg, replace=False))
    seg_seqs = [ACGT[rng.integers(0, 4, L)] for L in seg_lens]
    # IS-like repeats: short elements inserted at several loci each
    n_rep = max(2, n_seg // 60)
    rep_seqs = [ACGT[rng.integers(0, 4, int(L))] for L in rng.integers(600, 1600, n_rep)]
    events = sorted(
        [(int(loci[i]), "seg", i, 0.0) for i in range(n_seg)]
        + [
            (int(rng.integers(0, core_len)), "rep", ri, 0.7)
            for ri in range(n_rep)
            for _ in range(int(rng.integers(2, 5)))
        ]
    )
    core = ACGT[rng.integers(0, 4, core_len)]
    records = []
    for gi in range(n_genomes):
        seg_present = rng.random(n_seg) < pres_p
        pieces = []
        prev = 0
        for pos, kind, idx, pp in events:
            pieces.append(core[prev:pos])
            prev = pos
            if kind == "seg":
                if seg_present[idx]:
                    pieces.append(seg_seqs[idx])
            elif rng.random() < pp:
                pieces.append(rep_seqs[idx])
        pieces.append(core[prev:])
        g = _mutate(np.concatenate(pieces), rng, sub_rate)
        records.append(FastaRecord(seq_name=f"acc_{gi}", desc="", seq=g, index=gi))
    return records


def make_align_batch(rng, m: int, L: int, R_cap: int, W: int, sub_rate: float = 0.01, n_indels: int = 4):
    """A batch of banded-DP problems for the stripe contract
    (ops/stripe_dp.py): m pairs of ~L bp with ~sub_rate substitutions and
    n_indels short indels each, every pair inside a band of half-width W.
    Returns (pairs, arrays): pairs = [(ref, qry, ms, W)] as uint8 ASCII,
    arrays = (ref, qry, rlen, qlen, ms, W) padded IUPAC masks for the call."""
    from pangraph_tpu.graph.seq import IUPAC_MASK
    from pangraph_tpu.ops.stripe_dp import fits_band

    pairs = []
    while len(pairs) < m:
        ref = ACGT[rng.integers(0, 4, L)]
        q = ref.copy()
        idx = rng.choice(L, int(L * sub_rate), replace=False)
        q[idx] = ACGT[rng.integers(0, 4, len(idx))]
        q = list(q)
        for _ in range(n_indels):
            p = int(rng.integers(1, len(q) - 1))
            n = int(rng.integers(1, 9))
            if rng.random() < 0.5:
                del q[p : p + n]
            else:
                q[p:p] = list(ACGT[rng.integers(0, 4, n)])
        qry = np.array(q, np.uint8)
        ms = int(rng.integers(-min(W, 3), min(W, 3) + 1))
        if fits_band(len(ref), len(qry), ms, W) and len(qry) < R_cap:
            pairs.append((ref, qry, ms, W))
    arrays = (
        np.zeros((m, R_cap), np.uint8), np.zeros((m, R_cap), np.uint8),
        np.zeros(m, np.int32), np.zeros(m, np.int32), np.zeros(m, np.int32), np.zeros(m, np.int32),
    )
    for s, (ref, qry, ms, w) in enumerate(pairs):
        arrays[0][s, : len(ref)] = IUPAC_MASK[ref]
        arrays[1][s, : len(qry)] = IUPAC_MASK[qry]
        arrays[2][s], arrays[3][s], arrays[4][s], arrays[5][s] = len(ref), len(qry), ms, w
    return pairs, arrays
