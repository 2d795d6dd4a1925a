#!/usr/bin/env python
"""Profile the chromosome-scale bench workload (4 x 2.5 Mbp) with phase
tracing + align-round stats, to localize the round-2 regression
(BENCH_r01 21.15 s -> BENCH_r02 57.99 s; VERDICT.md weak #1)."""
import os
import sys
import time

os.environ["PANGRAPH_TPU_TRACE"] = "1"
os.environ["PANGRAPH_TPU_ALIGN_STATS"] = "1"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from bench import make_synthetic  # noqa: E402

from pangraph_tpu.align.params import BuildArgs  # noqa: E402
from pangraph_tpu.build.build import build, verify_roundtrip  # noqa: E402
from pangraph_tpu.ops.batch_align import BatchAligner  # noqa: E402
from pangraph_tpu.utils import trace  # noqa: E402


def _watcher(period: float = 60.0):
    """Dump trace + align-round stats periodically so a hung/slow build is
    diagnosable without waiting for completion."""
    import threading

    def run():
        import time as _t

        while True:
            _t.sleep(period)
            print("==== periodic dump ====", flush=True)
            print(trace.summary(), flush=True)
            for kind, nj, cells, s, _bp in BatchAligner.STATS[-8:]:
                print(f"  {kind:24s} n={nj:5d} cells={cells / 1e6:10.1f}M t={s:7.3f}s", flush=True)

    threading.Thread(target=run, daemon=True).start()


def main():
    _watcher()
    n = int(os.environ.get("PROF_N", 4))
    L = int(os.environ.get("PROF_L", 2_500_000))
    scale = make_synthetic(n_genomes=n, length=L, seed=7, sub_rate=0.005)
    args = BuildArgs(circular=True, jobs=int(os.environ.get("PROF_JOBS", 2)))
    aligner = BatchAligner(
        args.banded_params, args.extra_band_width, args.max_alignment_attempts
    )
    t = time.time()
    g = build(scale, args, aligner=aligner)
    print(f"warmup_build_s={time.time() - t:.2f} blocks={len(g.blocks)}", flush=True)
    trace.reset()
    BatchAligner.STATS.clear()
    t = time.time()
    g = build(scale, args, aligner=aligner)
    dt = time.time() - t
    verify_roundtrip(g, scale)
    from pangraph_tpu.commands import graph_quality

    print(f"timed_build_s={dt:.2f} blocks={len(g.blocks)} roundtrip=exact", flush=True)
    print("quality:", graph_quality(g), flush=True)
    print(trace.summary())
    print("--- align rounds (kind, n_jobs, cells, seconds) ---")
    tot = {}
    for kind, nj, cells, s, bp in BatchAligner.STATS:
        base = kind.split("[")[0]
        a = tot.setdefault(base, [0, 0, 0.0, 0])
        a[0] += nj
        a[1] += cells
        a[2] += s
        a[3] += bp
        print(f"  {kind:24s} n={nj:5d} cells={cells / 1e6:10.1f}M t={s:7.3f}s")
    print("--- totals by kind ---")
    for k, (nj, cells, s, bp) in tot.items():
        print(f"  {k:10s} n={nj:5d} cells={cells / 1e6:10.1f}M bp={bp / 1e6:8.1f}M t={s:8.2f}s")


if __name__ == "__main__":
    main()
