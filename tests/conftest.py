"""Test harness config: JAX on a virtual 8-device CPU mesh, so sharding
tests run without GPUs (see SURVEY.md §4). Tests that need the card carry
the `gpu` marker and the `gpu` fixture, which skips them elsewhere; run them
on the card with `JAX_PLATFORMS=cuda python -m pytest tests -m gpu`."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (xla_flags + " --xla_force_host_platform_device_count=8").strip()

import jax

import pathlib

import pytest

REFERENCE_DATA = pathlib.Path("/root/reference/data")


@pytest.fixture
def gpu():
    """Skips the test unless JAX runs on a GPU (decided at run time, never
    at import, so every xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run on the card")


@pytest.fixture(scope="session")
def test_graph_path():
    return REFERENCE_DATA / "test_graph.json"


@pytest.fixture(scope="session")
def plasmids_fasta_path():
    return REFERENCE_DATA / "russian_doll_plasmids.fa.gz"
