"""CUDA kernels called through the XLA FFI.

`stripe.cu` is compiled with nvcc for sm_90a at first use into `build/`
beside it (listed in .gitignore), under a name keyed by a hash of the source
and the compile command, so a changed source rebuilds and concurrent builders
never see a partial library. A failed build raises: on a GPU machine there is
no silent fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import jax
import jax.numpy as jnp

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "stripe.cu")
BUILD_DIR = os.path.join(_HERE, "build")
TARGET = "pangraph_stripe_align"
_LOCK = threading.Lock()
_REGISTERED = False


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the stripe kernel")
    return found


NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")


def compile_command(src: str, out: str) -> list:
    return [nvcc(), *NVCC_FLAGS, "-I", jax.ffi.include_dir(), "-o", out, src]


def library_path(src: str = SOURCE, build_dir: str = BUILD_DIR) -> str:
    """Final path of the built library: the build directory plus a hash of
    the source and the compile flags (no pid, no time)."""
    h = hashlib.blake2b(digest_size=8)
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(build_dir, f"libstripe_{h.hexdigest()}.so")


def build(src: str = SOURCE, build_dir: str = BUILD_DIR) -> str:
    """Compile the kernel library unless a build of this source exists."""
    so = library_path(src, build_dir)
    if os.path.exists(so):
        return so
    os.makedirs(build_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        res = subprocess.run(compile_command(src, tmp), capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed building {src}:\n{res.stderr[-4000:]}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def register() -> None:
    """Build (once per source) and register the FFI target for CUDA."""
    global _REGISTERED
    with _LOCK:
        if _REGISTERED:
            return
        lib = ctypes.cdll.LoadLibrary(build())
        jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(lib.PangraphStripeAlign), platform="CUDA")
        _REGISTERED = True


@functools.partial(jax.jit, static_argnames=("B", "K"))
def _call(ref, qry, rlen, qlen, ms, W, *, B: int, K: int):
    from pangraph_tpu.ops.stripe_dp import META

    m, R_cap = ref.shape
    out, _records = jax.ffi.ffi_call(
        TARGET,
        (
            jax.ShapeDtypeStruct((m, META + 2 * K), jnp.int32),
            jax.ShapeDtypeStruct((m, R_cap, B), jnp.int16),  # DP records: scratch
        ),
    )(ref, qry, rlen, qlen, ms, W)
    return out


def stripe_align_cuda(ref, qry, rlen, qlen, ms, W, *, B: int, K: int):
    """The stripe contract (ops/stripe_dp.py) on the GPU: packed [m, META + 2K]."""
    register()
    return _call(ref, qry, rlen, qlen, ms, W, B=B, K=K)
