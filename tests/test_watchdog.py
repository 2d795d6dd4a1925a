"""Host/device routing tests (ops/batch_align.py): the rate-based split of
each round between the host aligner and the device kernel, its periodic
probe slice, the cross-thread round broker and the per-engine receipts. The
device engine is replaced by fakes, so these run on the CPU."""
from __future__ import annotations

import time

import numpy as np
import pytest

from pangraph_tpu.align.map_variations import map_variations
from pangraph_tpu.align.params import BandedAlignParams, BandParameters
from pangraph_tpu.ops.batch_align import AlignJob, BatchAligner

ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture
def with_device(monkeypatch):
    """Routing as on a platform with a device kernel."""
    monkeypatch.setattr(BatchAligner, "uses_device", lambda self: True)


def _jobs(n=6, L=400, seed=0):
    rng = np.random.default_rng(seed)
    jobs = []
    for _ in range(n):
        ref = ACGT[rng.integers(0, 4, L)]
        qry = ref.copy()
        idx = rng.choice(L, 6, replace=False)
        qry[idx] = ACGT[rng.integers(0, 4, 6)]
        jobs.append(AlignJob(ref, qry, BandParameters(0, 8)))
    return jobs


def test_adaptive_split_tracks_engine_rates(monkeypatch, with_device):
    """With warm rate estimates for both engines AND a device slope clearing
    DEVICE_MIN_ADVANTAGE, _run_round splits the round's DP cells so the
    overlapped pair finishes soonest (host share = hC/(d+h)); a device
    that is not genuinely faster than the host is gated to host-only
    (measured: the overlap benefit does not materialize at break-even)."""
    from pangraph_tpu import native

    if native.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    params = BandedAlignParams()
    al = BatchAligner(params)

    seen = {}

    def fake_device(self, jobs, widths, kbumps=None):
        seen["dev"] = len(jobs)
        return ([None] * len(jobs), [False] * len(jobs), [False] * len(jobs))

    real_native = BatchAligner._run_round_native

    def spy_native(self, jobs, widths):
        seen["host"] = len(jobs)
        return real_native(self, jobs, widths)

    monkeypatch.setattr(BatchAligner, "_run_round_device", fake_device)
    monkeypatch.setattr(BatchAligner, "_run_round_native", spy_native)

    jobs = _jobs(n=12, seed=3)
    cells_per_job = al._job_cells(jobs[0], jobs[0].band.band_width + al.extra)
    # force the round beyond the host budget so the split logic engages
    monkeypatch.setattr(al, "NATIVE_CELL_BUDGET", cells_per_job)

    # device 3x faster -> host keeps ~1/4 of the cells, device the rest
    al._host_rate = 1e9
    al._dev_rate = 3e9
    al._run_round(jobs, [j.band.band_width + al.extra for j in jobs])
    assert 2 <= seen["host"] <= 5
    assert seen["host"] + seen["dev"] == 12

    # break-even device (below DEVICE_MIN_ADVANTAGE) -> gated to host-only
    seen["dev"] = 0
    al._host_rate = 1e9
    al._dev_rate = 1e9
    al._run_round(jobs, [j.band.band_width + al.extra for j in jobs])
    assert seen["host"] == 12 and seen["dev"] == 0

    # EMA: small (launch-dominated) observations are ignored
    before = al._host_rate
    al._observe_rate("host", 1000, 0.5)
    assert al._host_rate == before
    al._observe_rate("host", BatchAligner.RATE_MIN_CELLS, 1.0)
    assert al._host_rate != before


def test_latency_gate_routes_host_only(monkeypatch, with_device):
    """Mixed routing must never be predicted to lose to host-only: a device
    whose rate does not clear DEVICE_MIN_ADVANTAGE over the host's gets no
    share, and the whole round runs on host (break-even device legs still
    cost their round barriers)."""
    from pangraph_tpu import native

    if native.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    params = BandedAlignParams()
    al = BatchAligner(params)

    seen = {"dev": 0}

    def fake_device(self, jobs, widths, kbumps=None):
        seen["dev"] += len(jobs)
        return ([None] * len(jobs), [False] * len(jobs), [False] * len(jobs))

    monkeypatch.setattr(BatchAligner, "_run_round_device", fake_device)
    jobs = _jobs(n=12, seed=3)
    cells_per_job = al._job_cells(jobs[0], jobs[0].band.band_width + al.extra)
    monkeypatch.setattr(al, "NATIVE_CELL_BUDGET", cells_per_job)
    # device at break-even rate -> gate closes
    al._host_rate = 1e9
    al._dev_rate = 1e9
    al._run_round(jobs, [j.band.band_width + al.extra for j in jobs])
    assert seen["dev"] == 0, "device dispatched on a round the gate should close"
    # the gated round still counts toward the periodic re-probe
    assert al._dev_starved == 1


def test_latency_gate_periodic_reprobe(monkeypatch, with_device):
    """After 8 consecutive gated rounds of measurable size, the device gets
    one rate-observation slice so a faster device can re-earn its share."""
    from pangraph_tpu import native

    if native.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    params = BandedAlignParams()
    al = BatchAligner(params)
    monkeypatch.setattr(BatchAligner, "RATE_MIN_CELLS", 10_000)

    seen = {"dev": 0}

    def fake_device(self, jobs, widths, kbumps=None):
        seen["dev"] += len(jobs)
        return ([None] * len(jobs), [False] * len(jobs), [False] * len(jobs))

    monkeypatch.setattr(BatchAligner, "_run_round_device", fake_device)
    jobs = _jobs(n=12, seed=3)
    cells_per_job = al._job_cells(jobs[0], jobs[0].band.band_width + al.extra)
    monkeypatch.setattr(al, "NATIVE_CELL_BUDGET", cells_per_job)
    al._host_rate = 1e9
    al._dev_rate = 1e9  # gate closed on merit
    al._dev_starved = 7  # 7 gated rounds already
    al._run_round(jobs, [j.band.band_width + al.extra for j in jobs])
    assert seen["dev"] > 0, "8th gated round must include a device probe slice"
    assert al._dev_starved == 0
    # the probe period backs off while the device keeps failing the bar...
    assert al._probe_period == 16
    # ...and resets once the device clears the advantage gate
    seen["dev"] = 0
    al._dev_rate = 5e9
    al._run_round(jobs, [j.band.band_width + al.extra for j in jobs])
    assert seen["dev"] > 0
    assert al._probe_period == 8


def test_broker_coalesces_concurrent_device_rounds(monkeypatch, with_device):
    """Two merge threads' device legs submitted concurrently must ride ONE
    combined kernel round (more problems per call fill more of the card),
    and each thread must get exactly its own results back."""
    from pangraph_tpu import native

    if native.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    params = BandedAlignParams()
    al = BatchAligner(params)
    monkeypatch.setattr(BatchAligner, "BROKER_GATHER_S", 0.3)
    monkeypatch.setattr(al, "NATIVE_CELL_BUDGET", 1)
    al._host_rate = 1e9
    al._dev_rate = 1e12  # device vastly faster: the gate stays open

    calls = []

    def fake_dispatch(self, jobs, widths, kbumps=None):
        calls.append(len(jobs))
        # "device" result = the host fallback, computed per job
        return (
            [map_variations(j.ref, j.qry, j.band, params, al.extra) for j in jobs],
            [False] * len(jobs),
            [False] * len(jobs),
        )

    monkeypatch.setattr(BatchAligner, "_run_round_device", fake_dispatch)
    jobs_a = _jobs(n=5, L=500, seed=31)
    jobs_b = _jobs(n=7, L=500, seed=32)
    import threading

    out = {}
    ths = [
        threading.Thread(target=lambda: out.__setitem__("a", al.align_many(jobs_a))),
        threading.Thread(target=lambda: out.__setitem__("b", al.align_many(jobs_b))),
    ]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=30)
    for key, js in (("a", jobs_a), ("b", jobs_b)):
        for j, e in zip(js, out[key]):
            assert e == map_variations(j.ref, j.qry, j.band, params, al.extra)
    # the two 5- and 7-job legs must have ridden one 12-job combined round
    assert 12 in calls, calls


def test_engine_report_counts_host_cells():
    """Per-engine DP-cell receipts: a host round must appear in the report
    with a nonzero cell count and a fraction complement of the device's."""
    from pangraph_tpu import native

    if native.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    params = BandedAlignParams()
    al = BatchAligner(params, device=False)  # host routing
    BatchAligner.reset_engine_stats()
    jobs = _jobs(n=4, seed=3)
    al.align_many(jobs)
    rep = BatchAligner.engine_report()
    assert rep["host"]["cells"] > 0
    assert rep["device"]["cells"] == 0
    assert rep["device_cells_frac"] == 0.0
    BatchAligner.reset_engine_stats()
