#!/usr/bin/env python
"""Per-engine microbenchmarks for the alignment compute path.

Measures warm throughput of each engine on synthetic low-divergence pairs:

- native AVX-512 stripe aligner (DP + traceback, threaded across jobs)
- native rolling minimizer sketch
- the device stripe kernel (DP + run-jump walk, ops/stripe_dp.py), timed as
  warm calls ending in block_until_ready

Run on a GPU host: `python dev/kernel_bench.py [--json OUT.json]`. Where the
platform has no device kernel, the device rows are skipped.
"""
from __future__ import annotations

import json
import os
import sys
import time

# `python dev/kernel_bench.py` puts dev/ (not the repo root) on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)

RESULTS: dict = {"host": [], "device": []}


def _pairs(rng, n, L, div=0.02):
    refs, qrys = [], []
    for _ in range(n):
        ref = ACGT[rng.integers(0, 4, L)]
        q = ref.copy()
        idx = rng.choice(L, int(L * div), replace=False)
        q[idx] = ACGT[rng.integers(0, 4, len(idx))]
        refs.append(ref)
        qrys.append(q)
    return refs, qrys


def bench_native_stripe(rng):
    from pangraph_tpu.align.params import BandedAlignParams
    from pangraph_tpu.graph.seq import IUPAC_MASK
    from pangraph_tpu.native import get_lib, stripe_align_batch_native

    if get_lib() is None:
        print("native stripe: unavailable")
        return
    p = BandedAlignParams()
    for n, L, W in [(64, 2000, 16), (64, 8000, 16), (16, 20000, 32), (4, 120000, 64), (2, 120000, 512)]:
        refs, qrys = _pairs(rng, n, L)
        ms = np.zeros(n, np.int64)
        Wv = np.full(n, W, np.int64)
        # production-sized result caps (as ops/batch_align computes them):
        # the wrapper's 65k/262k defaults allocate ~300 MB of result buffers
        # for a 64-job batch and the memset dominates small-L timings
        caps = {"ops_cap": min(65536, 256 + L // 8), "subs_cap": min(262144, 256 + L // 4)}
        stripe_align_batch_native(refs[:1], qrys[:1], ms[:1], Wv[:1], p, IUPAC_MASK, **caps)
        t = time.time()
        out = stripe_align_batch_native(refs, qrys, ms, Wv, p, IUPAC_MASK, **caps)
        dt = time.time() - t
        cells = n * (L + 1) * (2 * W + 2)
        assert set(out["status"].tolist()) == {0}
        rate = cells / dt / 1e9
        RESULTS["host"].append({"kind": "stripe", "n": n, "L": L, "W": W, "gcells_per_s": round(rate, 3)})
        print(f"native stripe  n={n:3d} L={L:6d} W={W:3d}: {dt*1e3:7.1f} ms  {rate:5.2f} Gcells/s")


def bench_native_sketch(rng):
    from pangraph_tpu.graph.seq import TWOBIT
    from pangraph_tpu.native import get_lib, sketch_native

    if get_lib() is None:
        print("native sketch: unavailable")
        return
    for L, k, w in [(2_500_000, 19, 19), (2_500_000, 15, 100)]:
        seq = ACGT[rng.integers(0, 4, L)]
        sketch_native(seq[:1000], k, w, TWOBIT)
        t = time.time()
        vals, pos, strands = sketch_native(seq, k, w, TWOBIT)
        dt = time.time() - t
        print(f"native sketch  L={L} (k={k},w={w}): {dt*1e3:6.1f} ms  {L/dt/1e6:6.0f} Mbp/s  ({len(vals)} minimizers)")


def bench_device(rng):
    import jax

    from pangraph_tpu.ops.stripe_dp import stripe_align
    from pangraph_tpu.utils.synth import make_align_batch

    kernel = stripe_align()
    for m, R_cap, B, L, W in [
        (64, 10240, 128, 8000, 40),  # pin-split piece regime (production shape)
        (64, 16384, 128, 15000, 63),
        (32, 16384, 256, 15000, 127),
        (16, 16384, 512, 15000, 255),
        (8, 131072, 2048, 120000, 1023),
    ]:
        pairs, arrays = make_align_batch(rng, m, L, R_cap, W)
        args = [jax.device_put(a) for a in arrays]
        kernel(*args, B=B, K=1024).block_until_ready()  # compile
        t = time.perf_counter()
        for _ in range(3):
            kernel(*args, B=B, K=1024).block_until_ready()
        dev_s = (time.perf_counter() - t) / 3
        cells = sum(len(p[0]) for p in pairs) * (2 * W + 1)
        row = {"m": m, "B": B, "W": W, "L": L, "device_gcells_per_s": round(cells / dev_s / 1e9, 2)}
        RESULTS["device"].append(row)
        print(f"stripe kernel  m={m:3d} L={L:6d} B={B:4d} W={W:4d}: {dev_s*1e3:7.1f} ms/call  "
              f"{row['device_gcells_per_s']:6.2f} Gcells/s")


def main():
    out_json = None
    if "--json" in sys.argv:
        out_json = sys.argv[sys.argv.index("--json") + 1]
    rng = np.random.default_rng(0)
    bench_native_sketch(rng)
    bench_native_stripe(rng)
    import jax

    from pangraph_tpu.ops.stripe_dp import has_device_kernel

    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind}")
    if has_device_kernel():
        bench_device(rng)
    else:
        print("no device kernel on this platform: device rows skipped")
    if out_json:
        with open(out_json, "w") as f:
            json.dump({"platform": dev.platform, "device_kind": dev.device_kind, **RESULTS}, f, indent=1)
        print(f"wrote {out_json}")


if __name__ == "__main__":
    sys.exit(main())
