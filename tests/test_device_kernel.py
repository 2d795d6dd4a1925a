"""The device leg around the stripe kernel: kernel choice per platform, the
CUDA build path, the compile-cache placement, the device round's planning
(tiers, lanes, batch padding, the memory share) and its results against the
host aligner, and the chip smoke's refusal to run without a GPU."""
from __future__ import annotations

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from pangraph_tpu.align.params import AlignmentArgs, BandParameters, BuildArgs
from pangraph_tpu.ops import batch_align
from pangraph_tpu.ops.batch_align import AlignJob, BatchAligner
from pangraph_tpu.ops.stripe_dp import has_device_kernel, stripe_kernel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.mark.parametrize("platform,kind", [("gpu", "cuda"), ("cpu", "spec")])
def test_stripe_kernel_per_platform(platform, kind):
    assert stripe_kernel(platform) == kind
    assert has_device_kernel(platform) is (kind == "cuda")


@pytest.mark.parametrize("platform", ["tpu", "rocm", ""])
def test_stripe_kernel_unknown_platform_raises(platform):
    with pytest.raises(ValueError):
        stripe_kernel(platform)


def test_cuda_library_path_keyed_by_source_hash(tmp_path):
    from pangraph_tpu.ops import cuda

    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    p1 = cuda.library_path(str(src), str(tmp_path / "build"))
    assert p1 == cuda.library_path(str(src), str(tmp_path / "build"))  # stable
    src.write_text("// v2\n")
    p2 = cuda.library_path(str(src), str(tmp_path / "build"))
    assert p1 != p2
    name = os.path.basename(p2)
    assert str(os.getpid()) not in name and name.startswith("libstripe_") and name.endswith(".so")
    assert os.path.dirname(p2) == str(tmp_path / "build")


def test_cuda_build_dir_is_ignored_and_source_tracked():
    from pangraph_tpu.ops import cuda

    with open(os.path.join(REPO, ".gitignore")) as f:
        ignored = {line.strip() for line in f}
    rel = os.path.relpath(cuda.BUILD_DIR, REPO) + "/"
    assert rel in ignored
    assert os.path.dirname(cuda.library_path()) == cuda.BUILD_DIR
    assert os.path.exists(cuda.SOURCE)


def test_cuda_failed_build_raises(tmp_path, monkeypatch):
    from pangraph_tpu.ops import cuda

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no card' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(cuda, "nvcc", lambda: str(fake))
    src = tmp_path / "k.cu"
    src.write_text("// kernel\n")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cuda.build(str(src), str(tmp_path / "build"))
    assert not os.listdir(tmp_path / "build")  # no partial library left behind


@pytest.mark.parametrize("env_dir", [None, "custom-cache"])
def test_compile_cache_placement(tmp_path, env_dir):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    code = "import jax, pangraph_tpu; print(jax.config.jax_compilation_cache_dir)"
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, check=True)
    want = str(tmp_path / env_dir) if env_dir else os.path.join(REPO, ".jax_cache")
    assert out.stdout.strip() == want


def test_chip_smoke_refuses_the_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env, capture_output=True, text=True)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "no GPU" in res.stderr


def test_chip_smoke_refuses_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def _job(rng, L, W=20, ms=0, indel=0):
    ref = ACGT[rng.integers(0, 4, L)]
    qry = ref.copy()
    if indel:
        qry = np.concatenate([qry[: L // 2], qry[L // 2 + indel :]])
    return AlignJob(ref, qry, BandParameters(ms, W))


@pytest.fixture
def small_memory(monkeypatch):
    """A device with 64 MiB: the record share is 32 MiB."""
    monkeypatch.setattr(batch_align, "device_memory_bytes", lambda: 64 << 20)


def test_plan_groups_by_tier_and_lanes(small_memory):
    rng = np.random.default_rng(0)
    jobs = [_job(rng, 1000), _job(rng, 3000), _job(rng, 8000), _job(rng, 1000, W=100)]
    planned, host = BatchAligner()._plan_device(jobs, [j.band.band_width for j in jobs], [1] * 4)
    assert host == []
    shapes = sorted((R_cap, B, sub) for sub, _Ws, _m, R_cap, B, _K, _b in planned)
    assert shapes == [(4096, 128, [1, 0]), (4096, 256, [3]), (10240, 128, [2])]  # longest first
    for sub, Ws, m_pad, R_cap, B, K, nbytes in planned:
        assert Ws == [jobs[i].band.band_width for i in sub]  # the job's own W, not the tier's
        assert m_pad >= 8 and m_pad & (m_pad - 1) == 0
        assert nbytes == m_pad * R_cap * B * 2


def test_plan_splits_batches_to_the_memory_share(small_memory):
    rng = np.random.default_rng(1)
    jobs = [_job(rng, 8000) for _ in range(20)]
    planned, host = BatchAligner()._plan_device(jobs, [20] * 20, [1] * 20)
    # 32 MiB / (10240 rows x 128 lanes x 2 B) = 12 problems per call
    assert [len(p[0]) for p in planned] == [12, 8]
    assert all(p[2] <= 12 for p in planned)
    assert sorted(i for p in planned for i in p[0]) == list(range(20))


def test_plan_routes_oversize_and_outside_band_to_host(small_memory):
    rng = np.random.default_rng(2)
    BatchAligner.reset_engine_stats()
    jobs = [
        _job(rng, 60000),  # 65536 rows x 128 lanes x 2 B = 16 MiB: fits
        _job(rng, 200000),  # 262144-row tier: 64 MiB > share
        _job(rng, 2000, W=5, indel=40),  # end corner 40 bp outside the band
        _job(rng, 2000, W=5, ms=9),  # origin outside the band
    ]
    planned, host = BatchAligner()._plan_device(jobs, [j.band.band_width for j in jobs], [1] * 4)
    assert [p[0] for p in planned] == [[0]]
    assert host == [1, 2, 3]
    rep = BatchAligner.engine_report()
    assert rep["oversize"] == 1 and rep["outside_band"] == 2
    BatchAligner.reset_engine_stats()


def test_plan_pads_batches_to_the_mesh(small_memory):
    from pangraph_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(3)
    jobs = [_job(rng, 1000) for _ in range(5)]
    al = BatchAligner(mesh=make_mesh(4))
    planned, _ = al._plan_device(jobs, [20] * 5, [1] * 5)
    assert [p[2] % 4 for p in planned] == [0]


def test_plan_event_capacity_grows_with_retries(small_memory):
    rng = np.random.default_rng(4)
    jobs = [_job(rng, 1000)]
    al = BatchAligner()
    (p1,), _ = al._plan_device(jobs, [20], [1])
    (p4,), _ = al._plan_device(jobs, [20], [4])
    assert p4[5] == 4 * p1[5]


@pytest.mark.parametrize("seed", [5, 6])
def test_forced_device_build_identical_to_host(seed):
    """The build with every round on the device leg (the lax spec here) is
    byte-identical to the host-only build, as chip_smoke.py checks on the
    card with the CUDA kernel."""
    import json

    from pangraph_tpu.build.build import build
    from pangraph_tpu.utils.synth import make_synthetic

    recs = make_synthetic(n_genomes=4, length=3000, seed=seed)
    args = BuildArgs(circular=True, verify=True, aln_args=AlignmentArgs())
    dev = BatchAligner(args.banded_params, args.extra_band_width, args.max_alignment_attempts)
    dev.NATIVE_CELL_BUDGET = 0
    BatchAligner.reset_engine_stats()
    g_dev = build(recs, args, aligner=dev)
    assert BatchAligner.engine_report()["device"]["cells"] > 0
    host = BatchAligner(args.banded_params, args.extra_band_width, args.max_alignment_attempts, device=False)
    g_host = build(recs, args, aligner=host)
    assert json.dumps(g_dev.to_json_dict(), sort_keys=True) == json.dumps(g_host.to_json_dict(), sort_keys=True)
    BatchAligner.reset_engine_stats()


@pytest.mark.gpu
def test_cuda_matches_spec(gpu):
    """The CUDA kernel equals the lax spec bit for bit (on the card)."""
    import jax

    from pangraph_tpu.ops.cuda import stripe_align_cuda
    from pangraph_tpu.ops.stripe_dp import stripe_align_spec
    from pangraph_tpu.utils.synth import make_align_batch

    for m, L, R_cap, B, W in [(8, 400, 512, 128, 30), (4, 3000, 4096, 512, 200)]:
        _pairs, arrays = make_align_batch(np.random.default_rng(B), m, L, R_cap, W)
        dev = [jax.device_put(a) for a in arrays]
        got = np.asarray(stripe_align_cuda(*dev, B=B, K=256))
        want = np.asarray(stripe_align_spec(*dev, B=B, K=256))
        np.testing.assert_array_equal(got, want)
