"""pangraph_tpu — a pangenome-graph framework in JAX.

A from-scratch rebuild of the capabilities of neherlab/pangraph (v1.3.0, Rust + C
minimap2):

- the graph data model (blocks / nodes / paths with per-genome edit sets) lives on
  host as compact numpy-backed structures (`pangraph_tpu.graph`),
- sketching, anchor chaining and banded affine-gap extension run in native
  C++ on the host (`pangraph_tpu.native`, `pangraph_tpu.align`); the banded DP
  also has a device kernel (`pangraph_tpu.ops`: CUDA through the XLA FFI on the
  GPU, with a plain-lax specification beside it),
- graph construction (guide tree, pairwise merge, reweave, reconsensus) is the
  host-side orchestration in `pangraph_tpu.build`, batching all per-node
  re-alignments of a merge step into single device calls,
- several GPUs shard those batches through `jax.sharding.Mesh`
  (`pangraph_tpu.parallel`).

Reference behavior is documented against the upstream's file:line in docstrings.
"""

__version__ = "0.1.0"

import os as _os

# the checkout root: a fixed compile-cache path (the path is part of the key)
_CHECKOUT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def jax_cache_dir() -> str:
    """Where XLA's persistent compilation cache lives: JAX_COMPILATION_CACHE_DIR
    when set (JAX reads it itself), `<checkout>/.jax_cache` otherwise."""
    return _os.environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(_CHECKOUT, ".jax_cache")


def _setup_jax_compilation_cache():
    """Persistent XLA compilation cache: each (batch, R_cap, B, K) shape of
    the device round compiles once per machine."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return  # JAX follows the variable; set nothing in code
    import jax

    jax.config.update("jax_compilation_cache_dir", jax_cache_dir())


_setup_jax_compilation_cache()

from pangraph_tpu.graph.graph import Pangraph
from pangraph_tpu.graph.edits import Edit, Sub, Del, Ins

__all__ = ["Pangraph", "Edit", "Sub", "Del", "Ins", "__version__"]
