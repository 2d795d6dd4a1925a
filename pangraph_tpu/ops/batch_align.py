"""Batched banded alignment driver: buckets jobs, routes them between the
host C++ aligner and the device stripe kernel, decodes on host, retries
boundary hits with doubled bands.

This is the production replacement for per-sequence `map_variations`: all
re-alignment jobs of a merge round (across every merge promise and
reconsensus realignment — reweave.rs:52 par_iter and pangraph_block.rs:295)
become one batch here.
"""
from __future__ import annotations

import collections
import functools
import logging
import os
import threading as _threading
from dataclasses import dataclass

import numpy as np

from pangraph_tpu.align.params import BandedAlignParams, BandParameters
from pangraph_tpu.graph.edits import Del, Edit, Ins, Sub
from pangraph_tpu.graph.seq import IUPAC_MASK, as_seq
from pangraph_tpu.ops.stripe_dp import (
    LANE_TIERS,
    decode_packed,
    fits_band,
    has_device_kernel,
    lanes_for,
    stripe_align,
)
from pangraph_tpu.utils import trace

log = logging.getLogger(__name__)


@functools.lru_cache(maxsize=1)
def device_memory_bytes() -> int:
    """Memory the first device lets this process allocate (memory_stats
    bytes_limit). The CPU backend reports none; it gets 16 GiB."""
    import jax

    stats = jax.devices()[0].memory_stats()
    return int(stats["bytes_limit"]) if stats and "bytes_limit" in stats else 16 << 30


@dataclass
class AlignJob:
    ref: np.ndarray  # uint8 sequence
    qry: np.ndarray
    band: BandParameters
    hint_events: int = 0  # expected indel event rows (sizes the event buffer)
    # pin-split plan [(r0, r1, q0, q1, ms, bw)] from align/jobsplit.py: the
    # job is aligned as independent pieces with local bands and the piece
    # edits stitched back (shift + concat). None = align whole.
    segments: list = None


def _edit_from_rle_hostmatch(ops, n_ops, subs, n_subs, lead_ins, qry) -> Edit:
    """Build an Edit from RLE ops with the host aligner's insertion-strip
    semantics (align/map_variations.edits_from_aligned_pair): deletion runs
    separated only by insertions merge into one Del, because stripping the
    ref-gap (insertion) columns makes them one contiguous query-gap run
    (insertions_strip.rs:47 + nuc_changes.rs:18)."""
    # bulk-convert via tolist(): per-element numpy scalar indexing is ~3x
    # slower and this runs for every job of every round (~1M subs / build)
    sp = subs[:n_subs, 0][::-1].tolist()
    sa = subs[:n_subs, 1][::-1].tolist()
    out_subs = [Sub(p, chr(a)) for p, a in zip(sp, sa)]
    dels, inss = [], []
    rpos = 0
    qpos = lead_ins
    if lead_ins:
        inss.append(Ins(0, bytes(qry[:lead_ins]).decode()))
    op_list = ops[:n_ops, :][::-1].tolist()
    for op, length in op_list:
        if op == 0:  # match
            rpos += length
            qpos += length
        elif op == 2:  # deletion in query
            if dels and dels[-1].end == rpos:
                dels[-1] = Del(dels[-1].pos, dels[-1].len + length)
            else:
                dels.append(Del(rpos, length))
            rpos += length
        else:  # insertion
            inss.append(Ins(rpos, bytes(qry[qpos : qpos + length]).decode()))
            qpos += length
    return Edit(subs=out_subs, dels=dels, inss=inss)


class _BrokerTicket:
    """One submission's slot in a coalesced device round."""

    __slots__ = ("ev", "out", "exc")

    def __init__(self):
        self.ev = _threading.Event()
        self.out = None
        self.exc = None

    def result(self):
        self.ev.wait()
        if self.exc is not None:
            raise self.exc
        return self.out


class BatchAligner:
    """Batched aligner: the host C++ aligner plus, where the platform has a
    device kernel, the stripe DP on the device (ops/stripe_dp.py).

    Each round's jobs are split between the two engines by their measured
    rates; the device leg of concurrent merge threads is coalesced by a
    round broker. With `mesh` set (a jax.sharding.Mesh over a 'jobs' axis)
    every device batch is sharded data-parallel across its devices with
    shard_map; the hot loop needs no collectives. `device=False` keeps every
    job on the host."""

    def __init__(
        self, params: BandedAlignParams = None, extra_band_width: int = 5, max_attempts: int = 4, mesh=None,
        device: bool = True,
    ):
        self.params = params or BandedAlignParams()
        self.extra = extra_band_width
        self.max_attempts = max_attempts
        self.mesh = mesh
        self.device = device
        self._sharded_cache = {}
        # warm-round throughput estimates (cells/s EMA) for the host/device split
        self._host_rate = None
        self._dev_rate = None
        # gated rounds since the device rate was last observable: a starved
        # device share must not pin routing host-side forever
        self._dev_starved = 0
        # gated-round probe period: starts at 8, doubles (to 64) each time a
        # probe slice confirms the device is still below the advantage bar
        self._probe_period = 8
        self._mem_lock = _threading.Condition()
        self._mem_outstanding = 0
        # cross-thread device round broker: concurrent merge threads' device
        # legs coalesce into ONE kernel round (more problems per call fill
        # more of the card); while a round is in flight, later submissions
        # queue for the next one
        self._broker_lock = _threading.Lock()
        self._broker_queue = []  # (jobs, widths, kbumps, ticket)
        self._broker_wake = _threading.Event()
        self._broker_running = False

    def align_many(self, jobs: list) -> list:
        """jobs: list of AlignJob (or (ref, qry, band) tuples). Returns Edits
        in job order. Jobs carrying a pin-split plan (AlignJob.segments) are
        expanded into per-piece jobs and their piece edits stitched back."""
        jobs = [j if isinstance(j, AlignJob) else AlignJob(*j) for j in jobs]
        if any(j.segments for j in jobs):
            flat = []
            plan = []
            for j in jobs:
                if j.segments:
                    entries = []
                    for r0, r1, q0, q1, ms, bw in j.segments:
                        entries.append((len(flat), r0))
                        flat.append(
                            AlignJob(
                                j.ref[r0:r1], j.qry[q0:q1], BandParameters(ms, bw),
                                max(4, j.hint_events // len(j.segments)),
                            )
                        )
                    plan.append(entries)
                else:
                    plan.append([(len(flat), 0)])
                    flat.append(j)
            flat_edits = self.align_many(flat)
            out = []
            for entries in plan:
                if len(entries) == 1 and entries[0][1] == 0:
                    out.append(flat_edits[entries[0][0]])
                    continue
                # single-pass stitch == repeated shift+concat (Edit.concat
                # semantics: insertions at one position merge left-first),
                # without the per-piece intermediate Edits and list copies
                subs, dels, inss = [], [], []
                ins_at = {}
                for slot, r0 in entries:
                    e = flat_edits[slot]
                    if r0:
                        subs.extend(Sub(s.pos + r0, s.alt) for s in e.subs)
                        dels.extend(Del(d.pos + r0, d.len) for d in e.dels)
                    else:
                        subs.extend(e.subs)
                        dels.extend(e.dels)
                    for i in e.inss:
                        p = max(i.pos + r0, 0)
                        k = ins_at.get(p)
                        if k is None:
                            ins_at[p] = len(inss)
                            inss.append(Ins(p, i.seq) if r0 else i)
                        else:
                            inss[k] = Ins(p, inss[k].seq + i.seq)
                out.append(Edit(subs=subs, dels=dels, inss=inss))
            return out
        n = len(jobs)
        results = [None] * n
        # working band width / event-capacity multiplier per job
        widths = [j.band.band_width + self.extra for j in jobs]
        kbumps = [1] * n
        pending = list(range(n))
        attempt = 1
        while pending:
            edits, boundary, overflow = self._run_round(
                [jobs[i] for i in pending], [widths[i] for i in pending], [kbumps[i] for i in pending]
            )
            next_pending = []
            max_w_kernel = (self.MAX_B - 1) // 2
            native_ready = self.NATIVE_CELL_BUDGET > 0 and self._native_lib() is not None
            for slot, idx in enumerate(pending):
                # the kernel clamps bands at max_w_kernel; the native host path
                # has no such cap, so widening past it is useful while the job
                # (at the doubled width) stays under the widen-area guard —
                # the analog of the reference's max_band_area (params.rs:152),
                # except we accept the band-capped alignment instead of
                # erroring out
                widen_cap = max_w_kernel
                if native_ready and self._job_cells(jobs[idx], 2 * widths[idx]) <= self.NATIVE_WIDEN_AREA:
                    widen_cap = self.NATIVE_MAX_W
                can_widen = boundary[slot] and widths[idx] < widen_cap
                retry = (can_widen or overflow[slot]) and attempt < self.max_attempts
                if retry:
                    if can_widen:
                        widths[idx] = max(2 * widths[idx], max(1, abs(jobs[idx].band.mean_shift)))
                    if overflow[slot]:
                        kbumps[idx] *= 4  # divergent pair: raise event capacity
                    next_pending.append(idx)
                elif edits[slot] is None:
                    # retries exhausted with an unusable device result
                    results[idx] = self._host_fallback(jobs[idx])
                else:
                    results[idx] = edits[slot]
            pending = next_pending
            attempt += 1
        return results

    # ------------------------------------------------------------------ impl
    # record-row tiers: R_cap ladder, so each (R_cap, B) shape compiles once.
    # 10240 sits between 4096 and 16384 for the dominant pin-split piece
    # regime (~8.2-8.7 kb incl. indel slack).
    R_TIERS = (4096, 10240, 16384, 65536, 131072, 262144, 524288, 1048576, 2097152, 4194304)
    # share of the device's memory (memory_stats bytes_limit) that DP records
    # of all in-flight rounds may hold; a job whose records alone exceed it
    # runs on the host
    RECORD_SHARE = 0.5
    # widest record row: bands beyond W = (MAX_B - 1) // 2 are clamped (and
    # routed host-ward while the widen gate allows)
    MAX_B = LANE_TIERS[-1]
    # problems per kernel call: one warp each
    MAX_BATCH = 2048

    # rounds whose total DP area is below this budget stay on the host: the
    # native aligner serves them while a device round would still be
    # launching and copying
    NATIVE_CELL_BUDGET = int(float(os.environ.get("PANGRAPH_TPU_NATIVE_BUDGET", 100e6)))
    NATIVE_MAX_W = 1 << 20
    # band-doubling stops once a retry would exceed this DP area (~10 s of
    # host compute); the band-capped alignment is accepted instead
    NATIVE_WIDEN_AREA = int(float(os.environ.get("PANGRAPH_TPU_NATIVE_WIDEN_AREA", 5e9)))
    # per-job traceback-paths budget for the native aligner (host RAM)
    NATIVE_PATHS_BYTES = 8 << 30
    _ENGINE_LOCK = _threading.Lock()
    # kernel calls per (m_pad, R_cap, B, K) shape; a shape not yet in it
    # compiles in its first round
    SHAPE_CALLS = collections.Counter()
    # per-engine DP-cell accounting (always on; integers are cheap):
    # engine -> [cells_total, warm_cells, warm_secs]. "warm" excludes rounds
    # that compiled a new kernel shape, so warm_gcells_per_s is a real
    # throughput, while cells_total answers "what fraction of DP ran where".
    ENGINE = {"host": [0, 0, 0.0], "device": [0, 0, 0.0]}
    # device-planner counts: jobs the device round handed to the host
    # (outside_band: corners outside the band or beyond the largest tier;
    # oversize: records beyond RECORD_SHARE) and walks that died on device
    # (retried like the host aligner's status 1)
    COUNTS = {"outside_band": 0, "oversize": 0, "dead_walks": 0}

    @classmethod
    def _engine_count(cls, engine: str, cells: int, warm_cells: int, warm_secs: float) -> None:
        with cls._ENGINE_LOCK:
            e = cls.ENGINE[engine]
            e[0] += cells
            e[1] += warm_cells
            e[2] += warm_secs

    @classmethod
    def _bump(cls, key: str, n: int = 1) -> None:
        with cls._ENGINE_LOCK:
            cls.COUNTS[key] += n

    @classmethod
    def engine_report(cls) -> dict:
        """Per-engine DP-cell fractions, warm throughput and planner counts."""
        out = {}
        for k, (c, wc, ws) in cls.ENGINE.items():
            out[k] = {
                "cells": int(c),
                "warm_cells": int(wc),
                "warm_secs": round(ws, 3),
                "warm_gcells_per_s": round(wc / ws / 1e9, 3) if ws > 0 else None,
            }
        tot = sum(v[0] for v in cls.ENGINE.values())
        out["device_cells_frac"] = round(cls.ENGINE["device"][0] / tot, 4) if tot else None
        out.update(cls.COUNTS)
        return out

    @classmethod
    def reset_engine_stats(cls) -> None:
        with cls._ENGINE_LOCK:
            for e in cls.ENGINE.values():
                e[0] = e[1] = 0
                e[2] = 0.0
            for k in cls.COUNTS:
                cls.COUNTS[k] = 0

    @staticmethod
    def _job_cells(job: AlignJob, W: int) -> int:
        rlen, qlen = len(job.ref), len(job.qry)
        return (rlen + 1) * min(2 * W + 2, qlen + 1)

    def _native_lib(self):
        from pangraph_tpu import native

        return native.get_lib()

    def uses_device(self) -> bool:
        """True when this aligner hands DP work to a device kernel."""
        return self.device and has_device_kernel()

    STATS = []  # (kind, n_jobs, cells, seconds, ref_bp) when PANGRAPH_TPU_ALIGN_STATS=1

    # rounds below this DP area are launch-dominated: not usable as
    # throughput observations for the host/device split
    RATE_MIN_CELLS = 50_000_000
    # mixed host+device routing must be PREDICTED to beat host-only by this
    # factor before the device gets a share
    MIXED_GUARANTEE = float(os.environ.get("PANGRAPH_TPU_MIXED_GUARANTEE", 0.85))
    # ...and the device rate must beat the host rate outright by this factor:
    # round barriers, decode and band-cap retries eat a split at break-even
    DEVICE_MIN_ADVANTAGE = float(os.environ.get("PANGRAPH_TPU_DEVICE_MIN_ADVANTAGE", 1.3))

    def _observe_rate(self, which: str, cells: int, secs: float) -> None:
        if cells < self.RATE_MIN_CELLS or secs <= 0:
            return
        obs = cells / secs
        attr = "_host_rate" if which == "host" else "_dev_rate"
        prev = getattr(self, attr)
        setattr(self, attr, obs if prev is None else 0.5 * prev + 0.5 * obs)
        if which == "dev":
            self._dev_starved = 0

    def _run_round(self, jobs: list, widths: list, kbumps: list = None):
        """Route each job of the round to host C++ or the device kernel.

        Smallest jobs fill a host budget (they ride along while the device
        round is in flight); jobs whose band exceeds the kernel's widest
        record row but fit the widen area are forced to host so retries make
        progress instead of re-running clamped."""
        n = len(jobs)
        kbumps = kbumps or [1] * n
        use_native = self.NATIVE_CELL_BUDGET > 0 and self._native_lib() is not None
        budget = self.NATIVE_CELL_BUDGET
        if use_native and not self.uses_device():
            budget = 1 << 62  # no device kernel here: the host serves every job
        t0 = 0.0
        stats = bool(os.environ.get("PANGRAPH_TPU_ALIGN_STATS"))
        if stats:
            import time as _time

            t0 = _time.time()
        if not use_native:
            out = self._run_round_device(jobs, widths, kbumps)
            if stats:
                cells = sum(self._job_cells(j, w) for j, w in zip(jobs, widths))
                self.STATS.append(("device", n, cells, _time.time() - t0, sum(len(j.ref) for j in jobs)))
            return out

        max_w_kernel = (self.MAX_B - 1) // 2
        cells = [self._job_cells(j, w) for j, w in zip(jobs, widths)]
        # rate-based split: once both engines have measured warm rates, the
        # device participates ONLY when its rate beats the host's by
        # DEVICE_MIN_ADVANTAGE and the modeled mixed wall beats host-only by
        # MIXED_GUARANTEE. Otherwise rounds run host-only, with an
        # exponentially backed-off probe slice so the device can re-earn its
        # share.
        if budget < (1 << 62) and self._host_rate and self._dev_rate:
            # the split that finishes both legs together gives the host
            # C*h/(d+h) cells; the predicted mixed wall is C/(d+h)
            C = sum(cells)
            h, d = self._host_rate, self._dev_rate
            host_only_wall = C / h
            mixed_wall = C / (d + h)
            if d >= self.DEVICE_MIN_ADVANTAGE * h and mixed_wall < host_only_wall * self.MIXED_GUARANTEE:
                self._probe_period = 8
                budget = max(budget, int(h * C / (d + h)))
                # a transient device slowdown can shrink the device share
                # below RATE_MIN_CELLS, after which _dev_rate is never
                # re-observed. After 8 such rounds, shrink the host share
                # once so the device gets a rate-measurable round.
                if C >= 2 * self.RATE_MIN_CELLS:
                    if C - budget < self.RATE_MIN_CELLS:
                        self._dev_starved += 1
                        if self._dev_starved >= 8:
                            budget = min(budget, C - self.RATE_MIN_CELLS)
                            self._dev_starved = 0
            else:
                # device predicted not to help this round: host-only. Every
                # _probe_period-th such round of measurable size gives the
                # device a rate-observation slice anyway; the period doubles
                # (to 64) while the device keeps failing the bar.
                self._dev_starved += 1
                if self._dev_starved >= self._probe_period and C >= 2 * self.RATE_MIN_CELLS:
                    # CAP the host budget so the device slice is at least
                    # RATE_MIN_CELLS, or the slice could never be observed
                    budget = C - self.RATE_MIN_CELLS
                    self._dev_starved = 0
                    self._probe_period = min(self._probe_period * 2, 64)
                else:
                    budget = 1 << 62
        native_set = set()
        acc = 0
        for i in sorted(range(n), key=lambda i: cells[i]):
            if acc + cells[i] > budget:
                break
            native_set.add(i)
            acc += cells[i]
        for i in range(n):
            # device would clamp this band; host is the only path that widens.
            # The gate must match align_many's widen predicate (NATIVE_WIDEN_AREA,
            # not the small launch budget), or jobs between the two thresholds
            # get widened, re-clamped on device, and burn max_attempts retrying
            # identical rounds.
            if widths[i] > max_w_kernel and cells[i] <= self.NATIVE_WIDEN_AREA:
                native_set.add(i)
        dev_idx = [i for i in range(n) if i not in native_set]
        nat_idx = [i for i in range(n) if i in native_set]

        edits = [None] * n
        boundary = [False] * n
        overflow = [False] * n
        import time as _t

        nat_cells = sum(cells[i] for i in nat_idx)

        def run_native():
            tn = _t.time()
            e, b, _ = self._run_round_native([jobs[i] for i in nat_idx], [widths[i] for i in nat_idx])
            self._observe_rate("host", nat_cells, _t.time() - tn)
            for s, i in enumerate(nat_idx):
                edits[i], boundary[i] = e[s], b[s]

        if dev_idx and nat_idx:
            # overlap: submit the device leg to the broker (it may coalesce
            # with sibling threads' legs into one kernel round), run the
            # host leg meanwhile, then collect
            tk = self._broker_submit(
                [jobs[i] for i in dev_idx], [widths[i] for i in dev_idx], [kbumps[i] for i in dev_idx]
            )
            run_native()
            e, b, o = tk.result()
            for s, i in enumerate(dev_idx):
                edits[i], boundary[i], overflow[i] = e[s], b[s], o[s]
        elif nat_idx:
            run_native()
        else:
            tk = self._broker_submit(list(jobs), list(widths), list(kbumps))
            e, b, o = tk.result()
            edits, boundary, overflow = list(e), list(b), list(o)
        if stats:
            self.STATS.append(
                (
                    f"mixed[n={len(nat_idx)},d={len(dev_idx)}]", n, sum(cells),
                    _time.time() - t0, sum(len(j.ref) for j in jobs),
                )
            )
        return edits, boundary, overflow

    # ------------------------------------------------- device round broker
    # Coalesces concurrent merge threads' device legs into one kernel round:
    # more problems per call (one warp each) fill more of the card, and rate
    # observations clear RATE_MIN_CELLS more often. While one combined round
    # is in flight, later submissions queue for the next (pipelining).
    BROKER_GATHER_S = float(os.environ.get("PANGRAPH_TPU_BROKER_GATHER", 0.008))

    def _broker_submit(self, d_jobs: list, d_widths: list, d_kbumps: list) -> _BrokerTicket:
        tk = _BrokerTicket()
        with self._broker_lock:
            self._broker_queue.append((d_jobs, d_widths, d_kbumps, tk))
            spawn = not self._broker_running
            if spawn:
                self._broker_running = True
            self._broker_wake.set()
        if spawn:
            _threading.Thread(target=self._broker_loop, daemon=True, name="device-broker").start()
        return tk

    def _broker_loop(self) -> None:
        import time as _t

        try:
            while True:
                with self._broker_lock:
                    batch = self._broker_queue
                    self._broker_queue = []
                    if not batch:
                        self._broker_wake.clear()
                if not batch:
                    # idle: linger briefly for the next round, then stand
                    # down (a later submit respawns the thread)
                    if not self._broker_wake.wait(2.0):
                        with self._broker_lock:
                            if not self._broker_queue:
                                self._broker_running = False
                                return
                    continue
                if len(batch) == 1:
                    # brief gather window: a sibling merge thread's round
                    # usually arrives within a few ms of the first
                    _t.sleep(self.BROKER_GATHER_S)
                    with self._broker_lock:
                        batch += self._broker_queue
                        self._broker_queue = []
                jobs, widths, kbumps, slices = [], [], [], []
                for jj, ww, kk, tk in batch:
                    slices.append((len(jobs), len(jj), tk))
                    jobs += jj
                    widths += ww
                    kbumps += kk
                warm_before = len(self.SHAPE_CALLS)
                t0 = _t.time()
                # the WHOLE per-batch path (dispatch, rate observation, and
                # result slicing) completes every ticket on any exception —
                # a ticket left unset would hang its merge thread forever
                # (tk.result() waits without a timeout)
                try:
                    e, b, o = self._run_round_device(jobs, widths, kbumps)
                    dt = _t.time() - t0
                    if len(self.SHAPE_CALLS) == warm_before:
                        cells = sum(self._job_cells(j, w) for j, w in zip(jobs, widths))
                        self._observe_rate("dev", cells, dt)
                    for s0, n, tk in slices:
                        tk.out = (e[s0 : s0 + n], b[s0 : s0 + n], o[s0 : s0 + n])
                except BaseException as ex:
                    for _s0, _n, tk in slices:
                        if tk.out is None:
                            tk.exc = ex
                finally:
                    for _s0, _n, tk in slices:
                        tk.ev.set()
        except BaseException:
            # never die with tickets (or the running flag) latched
            with self._broker_lock:
                self._broker_running = False
                queued = self._broker_queue
                self._broker_queue = []
            for *_, tk in queued:
                tk.exc = RuntimeError("device broker crashed")
                tk.ev.set()
            log.warning("device broker crashed; later rounds respawn it", exc_info=True)
            raise

    def _run_round_native(self, jobs: list, widths: list):
        """Host C++ round: banded stripe DP + traceback per job, threaded
        across host cores (native/stripe.cpp). Same stripe geometry and tie
        rules as the host aligner; edits match map_variations exactly."""
        from pangraph_tpu.native import stripe_align_batch_native

        import time as _t

        t_eng = _t.time()
        eng_cells = sum(self._job_cells(j, int(w)) for j, w in zip(jobs, widths))
        n = len(jobs)
        refs = [j.ref for j in jobs]
        qrys = [j.qry for j in jobs]
        ms = np.array([j.band.mean_shift for j in jobs], dtype=np.int64)
        W = np.array(widths, dtype=np.int64)
        max_len = max(max(len(j.ref), len(j.qry)) for j in jobs)
        ops_cap = min(65536, 256 + max_len // 8)
        subs_cap = min(262144, 256 + max_len // 4)
        # keep the flat output buffers bounded (~256 MB)
        while n * (ops_cap * 8 + subs_cap * 16) > 256 * 1024 * 1024 and ops_cap > 256:
            ops_cap //= 2
            subs_cap //= 2
        with trace.span("align.native"):
            out = stripe_align_batch_native(
                refs, qrys, ms, W, self.params, IUPAC_MASK,
                max_paths_bytes=self.NATIVE_PATHS_BYTES, ops_cap=ops_cap, subs_cap=subs_cap,
            )
        edits = [None] * n
        boundary = [False] * n
        for s in range(n):
            st = int(out["status"][s])
            if st == 0:
                boundary[s] = bool(out["boundary"][s])
                edits[s] = _edit_from_rle_hostmatch(
                    out["ops"][s], int(out["n_ops"][s]), out["subs"][s], int(out["n_subs"][s]),
                    int(out["lead_ins"][s]), jobs[s].qry,
                )
            elif st == 1:  # dead walk / out of band: widen and retry
                boundary[s] = True
            elif st == 2:  # output overflow: single-job retry with big caps
                single = stripe_align_batch_native(
                    [jobs[s].ref], [jobs[s].qry], ms[s : s + 1], W[s : s + 1],
                    self.params, IUPAC_MASK,
                    max_paths_bytes=self.NATIVE_PATHS_BYTES, ops_cap=1 << 20, subs_cap=1 << 21,
                )
                if single is not None and int(single["status"][0]) == 0:
                    boundary[s] = bool(single["boundary"][0])
                    edits[s] = _edit_from_rle_hostmatch(
                        single["ops"][0], int(single["n_ops"][0]), single["subs"][0],
                        int(single["n_subs"][0]), int(single["lead_ins"][0]), jobs[s].qry,
                    )
                elif single is not None and int(single["status"][0]) == 1:
                    boundary[s] = True
                else:
                    edits[s] = self._host_fallback(jobs[s], count=False)
            else:  # paths over budget: numpy fallback
                edits[s] = self._host_fallback(jobs[s], count=False)
        self._engine_count("host", eng_cells, eng_cells, _t.time() - t_eng)
        return edits, boundary, [False] * n

    def _record_budget(self) -> int:
        """Bytes of DP records all in-flight device rounds may hold."""
        return int(self.RECORD_SHARE * device_memory_bytes())

    def _plan_device(self, jobs: list, widths: list, kbumps: list):
        """Group the round's jobs into kernel calls. Returns (planned,
        host_idx): planned = [(job indices, W per job, m_pad, R_cap, B, K,
        record bytes)]; host_idx = jobs the band or the memory share cannot
        hold, which run on the host aligner."""
        max_w = (self.MAX_B - 1) // 2
        budget = self._record_budget()
        groups = {}
        host_idx = []
        Ws = {}
        for i, W in enumerate(widths):
            j = jobs[i]
            # clamp to the widest record row and accept the band-capped
            # alignment: still a valid edit path (the roundtrip oracle holds).
            # The reference errors out here instead once band area exceeds
            # max_band_area (params.rs:152).
            W = min(W, max_w)
            L = max(len(j.ref), len(j.qry))
            tier = next((t for t in self.R_TIERS if t >= L + 2), None)
            if tier is None or not fits_band(len(j.ref), len(j.qry), j.band.mean_shift, W):
                host_idx.append(i)
                self._bump("outside_band")
                continue
            B = lanes_for(W)
            if tier * B * 2 > budget:
                host_idx.append(i)
                self._bump("oversize")
                continue
            Ws[i] = W
            groups.setdefault((tier, B), []).append(i)

        gran = self.mesh.devices.size if self.mesh is not None else 1
        planned = []
        for (R_cap, B), idxs in sorted(groups.items()):
            per_problem = R_cap * B * 2  # int16 records
            M = min(self.MAX_BATCH, max(budget // per_problem, 1))
            M = max(M // gran * gran, gran)
            idxs = sorted(idxs, key=lambda i: -len(jobs[i].ref))
            for c0 in range(0, len(idxs), M):
                sub = idxs[c0 : c0 + M]
                # power-of-two batch sizes bound the number of distinct shapes
                m_pad = 8 * gran
                while m_pad < len(sub):
                    m_pad *= 2
                m_pad = min(m_pad, M)
                max_len = max(max(len(jobs[i].ref), len(jobs[i].qry)) for i in sub)
                max_hint = max(jobs[i].hint_events for i in sub)
                bump = max(kbumps[i] for i in sub)
                # events are indel RUNS, so the buffer scales with divergence,
                # not length; overflow triggers a retry with 4x capacity.
                # Power-of-four ladder to bound shape variety.
                K_need = max(64, 64 + max_len // 256, 2 * max_hint) * bump
                K = 64
                while K < K_need and K < 16384:
                    K *= 4
                planned.append((sub, [Ws[i] for i in sub], m_pad, R_cap, B, K, m_pad * per_problem))
        return planned, host_idx

    def _run_round_device(self, jobs: list, widths: list, kbumps: list):
        """Device round: the stripe DP and run-jump walk on the device, one
        fetch for every batch of the round, decode on the host. Jobs the
        planner keeps off the device run on host threads meanwhile."""
        import time as _t

        n = len(jobs)
        edits = [None] * n
        boundary = [False] * n
        overflow = [False] * n
        planned, host_idx = self._plan_device(jobs, widths, kbumps)
        fb_pool = fb_futs = None
        if host_idx:
            import concurrent.futures as _cf

            fb_pool = _cf.ThreadPoolExecutor(max_workers=2)
            fb_futs = {i: fb_pool.submit(self._host_fallback, jobs[i]) for i in host_idx}
        try:
            if planned:
                cold = any((m_pad, R_cap, B, K) not in self.SHAPE_CALLS for _, _, m_pad, R_cap, B, K, _ in planned)
                dev_cells = sum(
                    self._job_cells(jobs[i], W) for sub, Ws, *_ in planned for i, W in zip(sub, Ws)
                )
                t_dev = _t.time()
                self._run_planned(jobs, planned, edits, boundary, overflow)
                dt = _t.time() - t_dev
                self._engine_count("device", dev_cells, 0 if cold else dev_cells, 0.0 if cold else dt)
            if fb_futs:
                for i, f in fb_futs.items():
                    edits[i] = f.result()
        finally:
            if fb_pool is not None:
                fb_pool.shutdown(wait=True)
        return edits, boundary, overflow

    def _run_planned(self, jobs, planned, edits, boundary, overflow):
        import jax

        round_bytes = min(sum(p[-1] for p in planned), self._record_budget())
        self._mem_acquire(round_bytes)
        launched = []
        try:
            for sub, Ws, m_pad, R_cap, B, K, _bytes in planned:
                with trace.span("align.pack"):
                    ref_in = np.zeros((m_pad, R_cap), dtype=np.uint8)
                    qry_in = np.zeros((m_pad, R_cap), dtype=np.uint8)
                    rlen = np.zeros(m_pad, dtype=np.int32)
                    qlen = np.zeros(m_pad, dtype=np.int32)
                    msv = np.zeros(m_pad, dtype=np.int32)
                    Wv = np.zeros(m_pad, dtype=np.int32)
                    for s, i in enumerate(sub):
                        j = jobs[i]
                        ref_in[s, : len(j.ref)] = IUPAC_MASK[j.ref]
                        qry_in[s, : len(j.qry)] = IUPAC_MASK[j.qry]
                        rlen[s] = len(j.ref)
                        qlen[s] = len(j.qry)
                        msv[s] = j.band.mean_shift
                        Wv[s] = Ws[s]
                with trace.span("align.dispatch"):
                    out = self._kernel_call(B, K)(ref_in, qry_in, rlen, qlen, msv, Wv)
                launched.append((sub, K, out))
            with trace.span("align.fetch"):
                bufs = jax.device_get([o for _, _, o in launched])
        finally:
            self._mem_release(round_bytes)
        self.SHAPE_CALLS.update((m_pad, R_cap, B, K) for _, _, m_pad, R_cap, B, K, _ in planned)
        dead = 0
        with trace.span("align.decode"):
            for (sub, K, _), buf in zip(launched, bufs):
                for s, i in enumerate(sub):
                    j = jobs[i]
                    overflow[i] = int(buf[s, 4]) > K
                    if overflow[i]:
                        continue  # retried with a bigger event capacity
                    edit, ok, boundary[i] = decode_packed(buf[s], K, j.ref, j.qry)
                    if ok:
                        edits[i] = edit
                    else:
                        # dead walk: retried with a doubled band, as the host
                        # aligner does with its status 1
                        boundary[i] = True
                        dead += 1
        if dead:
            self._bump("dead_walks", dead)

    def _kernel_call(self, B: int, K: int):
        """fn(ref, qry, rlen, qlen, ms, W) -> packed results, for this
        platform's kernel, sharded over the mesh when there is one."""
        import functools

        kernel = functools.partial(stripe_align(), B=B, K=K)
        if self.mesh is None:
            return kernel
        fn = self._sharded_cache.get((B, K))
        if fn is None:
            import jax
            from jax.sharding import PartitionSpec as P

            jobs_p = P("jobs")
            fn = jax.jit(
                jax.shard_map(kernel, mesh=self.mesh, in_specs=(jobs_p,) * 6, out_specs=jobs_p, check_vma=False)
            )
            self._sharded_cache[(B, K)] = fn
        return fn

    def _mem_acquire(self, nbytes: int) -> None:
        """Bound the DP records of concurrent rounds (the parallel merge
        scheduler dispatches from several threads) to the record budget. One
        grant per round; a round never asks for more than the whole budget."""
        with self._mem_lock:
            while self._mem_outstanding > 0 and self._mem_outstanding + nbytes > self._record_budget():
                self._mem_lock.wait()
            self._mem_outstanding += nbytes

    def _mem_release(self, nbytes: int) -> None:
        with self._mem_lock:
            self._mem_outstanding -= nbytes
            self._mem_lock.notify_all()

    def _host_fallback(self, job: AlignJob, count: bool = True) -> Edit:
        import time as _t

        t_eng = _t.time()
        try:
            with trace.span("align.host_fallback"):
                edit = self._native_single(job)
                if edit is not None:
                    return edit
                from pangraph_tpu.align.map_variations import map_variations

                return map_variations(job.ref, job.qry, job.band, self.params, self.extra)
        finally:
            # count=False when the caller already accounted these cells
            # (_run_round_native's internal overflow/budget fallbacks)
            if count:
                cells = self._job_cells(job, job.band.band_width + self.extra)
                self._engine_count("host", cells, cells, _t.time() - t_eng)

    def _native_single(self, job: AlignJob) -> Edit:
        """Single-job native alignment with the host aligner's own retry loop
        (align/align.rs:55-63 semantics, as map_variations). Returns None if
        the native library is unavailable or the job exceeds its budgets —
        the numpy aligner is the last resort then."""
        if self._native_lib() is None:
            return None
        from pangraph_tpu.native import stripe_align_batch_native

        w = job.band.band_width + self.extra
        attempt = 1
        edit = None
        while True:
            out = stripe_align_batch_native(
                [job.ref], [job.qry],
                np.array([job.band.mean_shift]), np.array([w]),
                self.params, IUPAC_MASK,
                max_paths_bytes=self.NATIVE_PATHS_BYTES, ops_cap=1 << 20, subs_cap=1 << 21,
                n_threads=1,
            )
            if out is None:
                return None
            st = int(out["status"][0])
            hb = bool(out["boundary"][0])
            if st == 0:
                edit = _edit_from_rle_hostmatch(
                    out["ops"][0], int(out["n_ops"][0]), out["subs"][0], int(out["n_subs"][0]),
                    int(out["lead_ins"][0]), job.qry,
                )
            elif st != 1:
                return None  # overflow / paths over budget
            retry = st == 1 or (st == 0 and hb)
            if (
                retry
                and attempt < self.params.max_alignment_attempts
                and self._job_cells(job, 2 * w) <= self.NATIVE_WIDEN_AREA
            ):
                w = max(2 * w, max(1, abs(job.band.mean_shift)))
                attempt += 1
                continue
            return edit

    # callable interface used by MergePromise.solve / reconsensus
    def __call__(self, ref, seqs, bands) -> list:
        ref = as_seq(ref)
        return self.align_many([AlignJob(ref, as_seq(s), b) for s, b in zip(seqs, bands)])
