"""Full production `build` on a device mesh: the graph built with alignment
batches sharded over {2, 8} virtual CPU devices must be identical to the
single-device build, and the roundtrip oracle must hold (VERDICT r1 #2/#3;
SURVEY.md §4 mesh-size-parameterized runs on CPU-simulated meshes)."""
from __future__ import annotations

import json

import numpy as np
import pytest

from pangraph_tpu.align.params import AlignmentArgs, BuildArgs
from pangraph_tpu.build.build import build
from pangraph_tpu.io.fasta import FastaRecord
from pangraph_tpu.ops.batch_align import BatchAligner

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _genomes(rng, n=5, L=1800):
    """Closely related genomes: ~1% substitutions, small indels, one
    inversion — enough structure for several merge rounds."""
    base = ACGT[rng.integers(0, 4, L)]
    recs = []
    for i in range(n):
        g = base.copy()
        idx = rng.choice(L, L // 100, replace=False)
        g[idx] = ACGT[rng.integers(0, 4, len(idx))]
        g = list(g)
        for _ in range(2):
            p = int(rng.integers(100, len(g) - 100))
            if rng.random() < 0.5:
                del g[p : p + int(rng.integers(2, 12))]
            else:
                g[p:p] = list(ACGT[rng.integers(0, 4, int(rng.integers(2, 12)))])
        if i == n - 1:  # one genome carries an inversion
            a, b = L // 3, L // 3 + 300
            comp = {65: 84, 84: 65, 67: 71, 71: 67}
            g[a:b] = [comp.get(int(c), int(c)) for c in g[a:b]][::-1]
        recs.append(FastaRecord(seq_name=f"g{i}", desc=None, seq=np.array(g, np.uint8), index=i))
    return recs


def _graph_json(graph) -> str:
    return json.dumps(graph.to_json_dict(), sort_keys=True)


def _build(recs, mesh=None):
    args = BuildArgs(circular=False, verify=True, aln_args=AlignmentArgs())
    aligner = BatchAligner(args.banded_params, args.extra_band_width, args.max_alignment_attempts, mesh=mesh)
    # force the device kernel: adaptive routing would otherwise send every
    # job to the native host aligner on the CPU test backend
    aligner.NATIVE_CELL_BUDGET = 0
    return build(recs, args, aligner=aligner)


@pytest.fixture(scope="module")
def single_device_graph():
    rng = np.random.default_rng(42)
    recs = _genomes(rng)
    return recs, _build(recs)


def test_mesh_build_identical_2dev(single_device_graph):
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs the virtual CPU mesh")
    from pangraph_tpu.parallel.mesh import make_mesh

    recs, g1 = single_device_graph
    g2 = _build(recs, mesh=make_mesh(2))
    assert _graph_json(g1) == _graph_json(g2)


def test_mesh_build_identical_8dev(single_device_graph):
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs the virtual CPU mesh")
    from pangraph_tpu.parallel.mesh import make_mesh

    recs, g1 = single_device_graph
    g8 = _build(recs, mesh=make_mesh(8))
    assert _graph_json(g1) == _graph_json(g8)
    # the build is verify=True (roundtrip oracle) but double-check one path
    from pangraph_tpu.graph.graph import reconstruct

    by_name = {r.seq_name: r.seq for r in recs}
    for name, _desc, seq in reconstruct(g8):
        assert np.array_equal(seq, by_name[name])


def test_cli_devices_flag(tmp_path):
    """--devices N builds through the CLI with a mesh-backed aligner."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs the virtual CPU mesh")
    from pangraph_tpu.cli import main
    from pangraph_tpu.io.fasta import write_fasta

    rng = np.random.default_rng(7)
    recs = _genomes(rng, n=3, L=900)
    fa = tmp_path / "in.fa"
    write_fasta(str(fa), recs)
    out = tmp_path / "g.json"
    rc = main(["build", str(fa), "-o", str(out), "--devices", "2", "--no-progress-bar", "-f"])
    assert rc == 0 and out.exists()
    rc = main(["build", str(fa), "-o", str(tmp_path / "g1.json"), "--devices", "99", "--no-progress-bar"])
    assert rc == 1  # more devices than available: clean one-line error
