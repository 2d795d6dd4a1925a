"""Error-handling contract: invalid inputs exit with one-line contextual
errors, never raw tracebacks (the reference wraps everything in eyre with
context at every layer, utils/global_init.rs:65-121, io/fasta.rs:265-287)."""
from __future__ import annotations

import numpy as np
import pytest

from pangraph_tpu.cli import main
from pangraph_tpu.io.fasta import FastaError, read_fasta


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def test_read_fasta_no_records(tmp_path):
    p = _write(tmp_path, "empty.fa", "")
    with pytest.raises(FastaError, match="no FASTA records"):
        read_fasta([p])


def test_read_fasta_lfs_stub(tmp_path):
    p = _write(
        tmp_path, "stub.fa",
        "version https://git-lfs.github.com/spec/v1\noid sha256:abcd\nsize 123\n",
    )
    with pytest.raises(FastaError, match="git-LFS pointer stub"):
        read_fasta([p])


def test_read_fasta_unreadable():
    with pytest.raises(FastaError, match="cannot read FASTA input"):
        read_fasta(["/nonexistent/nope.fa"])


def test_read_fasta_empty_record(tmp_path):
    p = _write(tmp_path, "emptyrec.fa", ">a\nACGT\n>b\n")
    with pytest.raises(FastaError, match="empty sequence"):
        read_fasta([p])


def test_read_fasta_bad_alphabet(tmp_path):
    p = _write(tmp_path, "bad.fa", ">a\nACGT!!\n")
    with pytest.raises(FastaError, match="invalid sequence"):
        read_fasta([p])


def test_cli_build_no_records_clean_error(tmp_path, capsys):
    p = _write(tmp_path, "empty.fa", "")
    rc = main(["build", str(p), "-o", str(tmp_path / "out.json"), "--no-device", "--no-progress-bar"])
    assert rc == 1
    err = capsys.readouterr().err
    assert err.startswith("error:") and "no FASTA records" in err


def test_cli_build_lfs_stub_clean_error(tmp_path, capsys):
    p = _write(
        tmp_path, "stub.fa",
        "version https://git-lfs.github.com/spec/v1\noid sha256:abcd\nsize 7\n",
    )
    rc = main(["build", str(p), "-o", str(tmp_path / "out.json"), "--no-device", "--no-progress-bar"])
    assert rc == 1
    assert "git-LFS pointer stub" in capsys.readouterr().err


def test_cli_build_guide_tree_mismatch_clean_error(tmp_path, capsys):
    fa = _write(tmp_path, "two.fa", ">a\nACGTACGTAA\n>b\nACGTACGTAC\n")
    nwk = _write(tmp_path, "t.nwk", "(a,c);")
    rc = main([
        "build", fa, "--guide-tree", nwk, "-o", str(tmp_path / "o.json"),
        "--no-device", "--no-progress-bar",
    ])
    assert rc == 1
    assert capsys.readouterr().err.startswith("error:")


def test_cli_build_single_record(tmp_path):
    """One input genome builds a singleton graph (no NJ crash)."""
    fa = _write(tmp_path, "one.fa", ">solo\n" + "ACGTACGTAA" * 30 + "\n")
    out = tmp_path / "o.json"
    rc = main(["build", fa, "-o", str(out), "--no-device", "--no-progress-bar"])
    assert rc == 0
    from pangraph_tpu.graph.graph import Pangraph

    g = Pangraph.from_file(str(out))
    assert len(g.paths) == 1 and len(g.blocks) == 1


def test_cli_export_missing_file_clean_error(capsys):
    rc = main(["export", "gfa", "/nonexistent/graph.json", "-o", "-"])
    assert rc == 1
    assert capsys.readouterr().err.startswith("error:")
