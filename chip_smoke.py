#!/usr/bin/env python
"""Chip smoke: proves that `build` runs its banded-DP device leg on one GPU.

    python chip_smoke.py           # one GPU: every phase below but the last
    python chip_smoke.py --four    # four GPUs: the sharded build only

Phases, all in this one process (one JAX process per card):

1. the device: JAX platform, device kind and count, and the card's name and
   power limit from nvidia-smi. Anything but a GPU is an error;
2. the stripe kernel compiled for the card at real widths (the pin-split
   probe shape, the 10240 tier at B=256, B=2048 on the 16384 tier), with
   memory_analysis(), compared bit for bit with the lax spec and edit for
   edit with the host C++ aligner;
3. the kernel against the same contract compiled by XLA from plain lax, at
   the probe shape and at the build's most frequent round shape;
4. a 12 x 120 kb build with every job forced onto the device leg and the same
   build on the host alone: the graph JSONs must be byte-identical;
5. the 10 x 4.6 Mbp accessory-genome build through `pangraph_tpu.cli.main`,
   with its wall time, graph quality and per-engine receipts. It fails unless
   the device served DP cells and no device walk died;
6. with --four: the 12 x 120 kb build on a 4-GPU mesh and on one GPU (both
   device-forced); the graphs must match and all four cards must have held
   memory.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return res.stdout.strip()


def timed(fn, reps: int) -> float:
    """Mean warm seconds per call, each ending in block_until_ready."""
    fn().block_until_ready()
    t = time.perf_counter()
    for _ in range(reps):
        fn().block_until_ready()
    return (time.perf_counter() - t) / reps


def native_edits(pairs):
    import numpy as np

    from pangraph_tpu.align.params import BandedAlignParams
    from pangraph_tpu.graph.seq import IUPAC_MASK
    from pangraph_tpu.native import stripe_align_batch_native
    from pangraph_tpu.ops.batch_align import _edit_from_rle_hostmatch

    out = stripe_align_batch_native(
        [p[0] for p in pairs], [p[1] for p in pairs],
        np.array([p[2] for p in pairs], np.int64), np.array([p[3] for p in pairs], np.int64),
        BandedAlignParams(), IUPAC_MASK, ops_cap=1 << 14, subs_cap=1 << 16,
    )
    res = []
    for s, (_r, q, _ms, _W) in enumerate(pairs):
        ops, subs = out["ops"][s], out["subs"][s]
        e = _edit_from_rle_hostmatch(ops, len(ops), subs, len(subs), int(out["lead_ins"][s]), q)
        res.append((int(out["status"][s]), e, bool(out["boundary"][s])))
    return res


def kernel_phase(K: int = 256) -> None:
    import jax
    import numpy as np

    from pangraph_tpu.ops import cuda
    from pangraph_tpu.ops.stripe_dp import decode_packed, stripe_align_spec
    from pangraph_tpu.utils.synth import make_align_batch

    t = time.perf_counter()
    cuda.register()
    so = cuda.library_path()
    print(f"[kernel] library {os.path.relpath(so, HERE)} ready in {time.perf_counter() - t:.1f} s", flush=True)
    for m, L, R_cap, B, W in [(64, 8000, 10240, 128, 40), (64, 9000, 10240, 256, 100), (8, 15000, 16384, 2048, 1000)]:
        pairs, arrays = make_align_batch(np.random.default_rng(R_cap + B), m, L, R_cap, W)
        dev = [jax.device_put(a) for a in arrays]
        ma = cuda._call.lower(*dev, B=B, K=K).compile().memory_analysis()
        got = np.asarray(cuda.stripe_align_cuda(*dev, B=B, K=K))
        want = np.asarray(stripe_align_spec(*dev, B=B, K=K))
        n_raw = int((got != want).any(axis=1).sum())
        n_host = 0
        for s, ((r, q, _ms, _w), (status, edit, hb)) in enumerate(zip(pairs, native_edits(pairs))):
            e, ok, bnd = decode_packed(got[s], K, r, q)
            n_host += int(status != 0 or not ok or e != edit or bnd != hb)
        print(
            f"[kernel] m={m} L={L} R_cap={R_cap} B={B} W={W}: raw mismatches vs lax spec {n_raw}/{m}, "
            f"edit mismatches vs host aligner {n_host}/{m}; memory_analysis: "
            f"argument {ma.argument_size_in_bytes} B, output {ma.output_size_in_bytes} B, "
            f"temp {ma.temp_size_in_bytes} B",
            flush=True,
        )
        if n_raw or n_host:
            raise AssertionError(f"kernel parity failed at m={m} R_cap={R_cap} B={B}")
        t_cuda = timed(lambda: cuda.stripe_align_cuda(*dev, B=B, K=K), 5)
        t_lax = timed(lambda: stripe_align_spec(*dev, B=B, K=K), 1)
        print(f"[kernel]   CUDA kernel {t_cuda * 1e3:.3f} ms, plain lax under XLA {t_lax * 1e3:.3f} ms", flush=True)


def timing(label: str, m: int, R_cap: int, B: int, K: int, card: str) -> None:
    import jax
    import numpy as np

    from pangraph_tpu.ops.cuda import stripe_align_cuda
    from pangraph_tpu.ops.stripe_dp import stripe_align_spec
    from pangraph_tpu.utils.synth import make_align_batch

    W = min((B - 1) // 2, 40 if B == 128 else (B - 1) // 4)
    pairs, arrays = make_align_batch(np.random.default_rng(1), m, int(R_cap * 0.8), R_cap, W)
    dev = [jax.device_put(a) for a in arrays]
    cells = int(sum(len(p[0]) for p in pairs)) * (2 * W + 1)
    t_cuda = timed(lambda: stripe_align_cuda(*dev, B=B, K=K), 10)
    t_lax = timed(lambda: stripe_align_spec(*dev, B=B, K=K), 2)
    print(
        f"[timing] {label} m={m} R_cap={R_cap} B={B} W={W} K={K} on {card}: CUDA kernel {t_cuda * 1e3:.3f} ms "
        f"({cells / t_cuda / 1e9:.2f} Gcells/s), plain lax under XLA {t_lax * 1e3:.3f} ms "
        f"({cells / t_lax / 1e9:.3f} Gcells/s), ratio {t_lax / t_cuda:.1f}x",
        flush=True,
    )


def build_cli(fa: str, out: str, *extra: str) -> float:
    from pangraph_tpu.cli import main as cli_main

    t = time.perf_counter()
    rc = cli_main(["build", fa, "-o", out, "-c", "-f", "--no-progress-bar", *extra])
    if rc != 0:
        raise AssertionError(f"build {fa} {' '.join(extra)} exited {rc}")
    return time.perf_counter() - t


def write_synthetic(path: str) -> str:
    from pangraph_tpu.io.fasta import write_fasta
    from pangraph_tpu.utils.synth import make_synthetic

    write_fasta(path, make_synthetic(n_genomes=12, length=120_000, seed=42))
    return path


def forced_device_identity(work: str) -> None:
    from pangraph_tpu.ops.batch_align import BatchAligner

    fa = write_synthetic(os.path.join(work, "synth12.fa"))
    budget = BatchAligner.NATIVE_CELL_BUDGET
    BatchAligner.reset_engine_stats()
    BatchAligner.NATIVE_CELL_BUDGET = 0  # every round on the device leg
    try:
        t_dev = build_cli(fa, os.path.join(work, "synth12.device.json"), "-j", "4")
    finally:
        BatchAligner.NATIVE_CELL_BUDGET = budget
    rep = BatchAligner.engine_report()
    t_host = build_cli(fa, os.path.join(work, "synth12.host.json"), "-j", "4", "--no-device")
    with open(os.path.join(work, "synth12.device.json"), "rb") as f:
        a = f.read()
    with open(os.path.join(work, "synth12.host.json"), "rb") as f:
        b = f.read()
    print(
        f"[identity] 12 x 120 kb: device-forced build {t_dev:.2f} s (device_cells_frac "
        f"{rep['device_cells_frac']}, outside_band {rep['outside_band']}, oversize {rep['oversize']}, "
        f"dead_walks {rep['dead_walks']}), host-only build {t_host:.2f} s; roundtrip exact in both; "
        f"graph JSON byte-identical: {a == b} ({len(a)} bytes)",
        flush=True,
    )
    if a != b:
        raise AssertionError("device-forced and host-only graphs differ")
    if not rep["device_cells_frac"]:
        raise AssertionError("the device-forced build ran no DP on the device")


def headline_build(work: str):
    from pangraph_tpu import native
    from pangraph_tpu.commands import graph_quality
    from pangraph_tpu.graph.graph import Pangraph
    from pangraph_tpu.io.fasta import write_fasta
    from pangraph_tpu.ops.batch_align import BatchAligner
    from pangraph_tpu.utils.synth import make_accessory_pangenome

    fa = os.path.join(work, "ecoli_class.fa")
    write_fasta(fa, make_accessory_pangenome(n_genomes=10, genome_len=4_600_000, seed=13))
    out = os.path.join(work, "ecoli_class.json")
    BatchAligner.reset_engine_stats()
    wall = build_cli(fa, out, "-j", "4")
    rep = BatchAligner.engine_report()
    q = graph_quality(Pangraph.from_file(out))
    simd = native.get_lib().stripe_simd_bits()
    print(
        f"[build] 10 x 4.6 Mbp: wall {wall:.2f} s, roundtrip exact, blocks {q['n_blocks']}, "
        f"core fraction {q['core_fraction']}, pangenome {q['pangenome_bp']} bp; host aligner "
        f"{'AVX-512' if simd == 512 else 'scalar'} on {os.cpu_count()} cores",
        flush=True,
    )
    print(f"[build] engine_report {json.dumps(rep)}", flush=True)
    if not rep["device_cells_frac"]:
        raise AssertionError("device_cells_frac is 0: the device served no DP cells")
    if rep["dead_walks"]:
        raise AssertionError(f"{rep['dead_walks']} device walks died")
    shapes = [(n, s) for s, n in BatchAligner.SHAPE_CALLS.items() if s[1] <= 16384]
    if shapes:
        n, (m, R_cap, B, K) = max(shapes)
        print(f"[build] most frequent round shape: m={m} R_cap={R_cap} B={B} K={K} ({n} calls)", flush=True)
        return m, R_cap, B, K
    return None


def four_gpus(work: str) -> None:
    import jax

    from pangraph_tpu.ops.batch_align import BatchAligner

    if len(jax.devices()) < 4:
        raise AssertionError(f"--four needs 4 GPUs, found {len(jax.devices())}")
    fa = write_synthetic(os.path.join(work, "synth12.fa"))
    BatchAligner.NATIVE_CELL_BUDGET = 0
    walls = {n: build_cli(fa, os.path.join(work, f"synth12.d{n}.json"), "-j", "4", "--devices", str(n)) for n in (1, 4)}
    blobs = {}
    for n in (1, 4):
        with open(os.path.join(work, f"synth12.d{n}.json"), "rb") as f:
            blobs[n] = f.read()
    peaks = [d.memory_stats()["peak_bytes_in_use"] for d in jax.devices()[:4]]
    print(
        f"[four] 12 x 120 kb device-forced: --devices 1 {walls[1]:.2f} s, --devices 4 {walls[4]:.2f} s; "
        f"graphs identical: {blobs[1] == blobs[4]}; peak_bytes_in_use per card {peaks}",
        flush=True,
    )
    if blobs[1] != blobs[4]:
        raise AssertionError("the 4-GPU graph differs from the 1-GPU graph")
    if not all(peaks):
        raise AssertionError("a card held no memory: the mesh did not use all four")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true", help="run only the 4-GPU sharded build")
    ap.add_argument("--work", default=os.path.join(HERE, ".smoke"), help="scratch directory (removed at exit)")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(HERE, "pangraph_tpu")):
        return fail("run this script from a checkout of the repository")
    sys.path.insert(0, HERE)
    import jax

    devs = jax.devices()
    dev = {"platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}
    if dev["platform"] != "gpu":
        return fail(f"no GPU: JAX platform is {dev['platform']!r}")
    card = card_line()
    print(f"[device] {dev['platform']} {dev['kind']} x{dev['count']}", flush=True)
    print(f"[device] nvidia-smi: {card}", flush=True)
    os.makedirs(args.work, exist_ok=True)
    try:
        if args.four:
            four_gpus(args.work)
        else:
            kernel_phase()
            timing("probe shape", 64, 10240, 128, 256, card)
            forced_device_identity(args.work)
            shape = headline_build(args.work)
            if shape is not None:
                timing("build round shape", *shape, card)
    except Exception as e:  # every phase failure fails the smoke
        import traceback

        traceback.print_exc()
        return fail(repr(e))
    finally:
        shutil.rmtree(args.work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
