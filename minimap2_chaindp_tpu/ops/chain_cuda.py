"""The chaining-DP CUDA kernel (native/cuda/chain_dp.cu) as a JAX operation.

The shared library is compiled with nvcc from the repository's source on
first use, into build/cuda/ under the checkout (listed in .gitignore; the
file name carries a hash of the source and flags, so an edited kernel is
rebuilt), then registered with XLA through the foreign function interface.
Kernel design and contract: the .cu file and ops/chain_batch.py.

  python -m minimap2_chaindp_tpu.ops.chain_cuda    # build only
"""
from __future__ import annotations

import functools
import hashlib
import os
import subprocess

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SRC = os.path.join(ROOT, "native", "cuda", "chain_dp.cu")
BUILD_DIR = os.path.join(ROOT, "build", "cuda")
TARGET = "mm2_chain_dp"
NVCC = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                    "nvcc")
# sm_90a: Hopper; -fmad=false keeps trunc(f32(dd) * w1) a plain IEEE
# product (no contraction), as the exactness contract requires
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]
MODES = {(False, False): 0, (False, True): 1, (True, False): 2,
         (True, True): 2}


def library_path() -> str:
    """Build the kernel library if it is missing; return its path."""
    import jax.ffi
    with open(SRC, "rb") as fh:
        tag = hashlib.sha256(fh.read() + " ".join(FLAGS).encode())
    path = os.path.join(BUILD_DIR, f"libmm2_chain_dp_{tag.hexdigest()[:12]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    subprocess.run([NVCC, *FLAGS, "-I", jax.ffi.include_dir(), "-o", tmp,
                    SRC], check=True)
    os.replace(tmp, path)
    return path


@functools.lru_cache(maxsize=None)
def register() -> str:
    """Load the library and register its handler for the CUDA platform
    (once per process)."""
    import ctypes

    import jax.ffi
    lib = ctypes.CDLL(library_path())
    jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(lib.Mm2ChainDp),
                                platform="CUDA")
    return TARGET


def chain_scores_cuda(xhi, rpos, qpos, span, sid, stw, nn, w1, exc, *,
                      max_n, max_dist_x, max_dist_y, bw, max_skip, is_cdna,
                      many_segs):
    """ops/chain_batch.chain_scores_batch on the CUDA kernel."""
    import jax
    import jax.numpy as jnp
    R = rpos.shape[0]
    mat = jax.ShapeDtypeStruct((R, max_n), jnp.int32)
    call = jax.ffi.ffi_call(
        register(), (mat, mat, jax.ShapeDtypeStruct((R,), jnp.int32)))
    i32 = lambda a: jnp.asarray(a, jnp.int32)
    return call(i32(xhi), i32(rpos), i32(qpos), i32(span), i32(sid), i32(stw),
                i32(nn), jnp.asarray(w1, jnp.float32), i32(exc),
                max_dist_x=np.int32(max_dist_x),
                max_dist_y=np.int32(max_dist_y), bw=np.int32(bw),
                max_skip=np.int32(max_skip),
                mode=np.int32(MODES[(bool(is_cdna), bool(many_segs))]))


if __name__ == "__main__":
    print(library_path())
