"""Batched chaining-DP score pass: the device half of the reference's FPGA
chaining offload (fpga_chaindp.c / chain.c mm_chain_dp_fpga).

`chain_scores_batch` scores a padded batch of reads and returns, per read,
f[] and p[] (int32) and a flag; v[] and the compact offload arrays are
rebuilt on the host (O(n) bookkeeping). One function picks the
implementation from the platform JAX runs on (`chain_impl`):

  * gpu — the CUDA kernel (ops/chain_cuda.py, native/cuda/chain_dp.cu):
    one warp per read, the whole anchor loop in one launch
  * cpu — the plain jnp/lax version (ops/chain_jax.chain_scores_batch_xla),
    which is also the reference the kernel is checked against

Both follow one contract:

  * gap cost c_lin = trunc(dd * .01 * avg_qspan) is EXACT: the device
    computes a float32 candidate trunc(f32(dd) * w1) (IEEE round-to-nearest,
    no contraction); the host verifies that candidate against the
    C-double-exact value for EVERY dd < TBL and ships the (rare) mismatches
    as an explicit exception list the device patches by equality compare —
    reads with too many exceptions fall back to the host. Beyond the table
    c_lin provably exceeds c_log so min(c_lin, c_log) = c_log
  * max_skip semantics: the whole window is scanned, and a read is FLAGGED
    when some anchor's best predecessor comes after more than max_skip
    valid candidates in the reference's descending scan — only then can the
    reference's stamp-driven early break change f/p (see ops/chain_jax.py)
  * flagged reads are recomputed exactly on the host (the reference's own
    err_flag software-fallback pattern, map.c:933-944)

Inputs are (R, max_n) int32 anchor fields plus per-read nn (R,) anchor
counts, w1 (R,) f32 gap-cost slopes and exc (R, 2 * N_EXC) exception
pairs; stw (R, max_n) holds the precomputed max_dist_x window starts.
"""
from __future__ import annotations

import functools

import numpy as np

NEG_INF = -0x40000000
TBL = 2048    # c_lin exactness domain; requires bw < TBL
N_EXC = 2     # c_lin exception slots per read (slope search removes most)


_D64 = None


@functools.lru_cache(maxsize=8192)
def _slope_exc_cached(avg_bits: bytes):
    global _D64
    if _D64 is None:
        _D64 = (np.arange(TBL, dtype=np.float64),
                np.arange(TBL, dtype=np.float32))
    d, df32 = _D64
    avg = np.float64(np.frombuffer(avg_bits, np.float32)[0])
    exact = (d * 0.01 * avg).astype(np.int64)  # C double semantics
    # search the f32 slope whose device-side trunc(f32(dd)*w) matches the
    # C double result on the most dd values; neighbors of the nearest f32
    # usually reach zero mismatches
    w0 = np.float32(np.float64(0.01) * avg)
    best_w, bad = w0, None
    for w in (w0, np.nextafter(w0, np.float32(0), dtype=np.float32),
              np.nextafter(w0, np.float32(1e9), dtype=np.float32)):
        b = np.nonzero((df32 * w).astype(np.int64) != exact)[0]
        if bad is None or len(b) < len(bad):
            best_w, bad = w, b
        if len(b) == 0:
            break
    if len(bad) > N_EXC:
        return best_w, None
    return best_w, tuple((int(dd), int(exact[dd])) for dd in bad)


def clin_slope_exc(avg_qspan_f32):
    """f32 gap-cost slope + exception pairs making the device's
    trunc(f32(dd) * w1) equal the C-double trunc(dd * 0.01 * avg) for every
    dd < TBL (the exactness contract in the module docstring). Returns
    (w1, ((dd, exact), ...)) or (w1, None) when more than N_EXC mismatches
    remain — such reads take the host path."""
    return _slope_exc_cached(np.float32(avg_qspan_f32).tobytes())


def chain_impl(platform: str):
    """The chaining implementation for a JAX platform: the CUDA kernel on
    `gpu`, the plain jnp/lax version on `cpu`; any other platform is an
    error (there is no interpret mode and no silent substitute)."""
    if platform == "gpu":
        from .chain_cuda import chain_scores_cuda
        return chain_scores_cuda
    if platform == "cpu":
        from .chain_jax import chain_scores_batch_xla
        return chain_scores_batch_xla
    raise ValueError(f"no chaining implementation for platform {platform!r}")


def chain_scores_batch(xhi, rpos, qpos, span, sid, stw, nn, w1, exc, *,
                       max_n, max_dist_x, max_dist_y, bw, max_skip, is_cdna,
                       many_segs):
    """Batched chaining score pass (see the module docstring for the
    contract), jitted once per static configuration on JAX's default
    backend; callers that trace it inside their own jit inline it."""
    # exact-c_lin domain: pen_same's dd is bounded by the same-seg band
    # (dd <= bw) in genomic mode, and by dq <= max_dist_y in cdna mode
    # (chain.c:65-78); beyond TBL only the log penalty survives the min
    if (max_dist_y if is_cdna else bw) >= TBL:
        raise ValueError("same-seg gap-cost domain >= TBL uses the host path")
    if max_n > 1 << 16:
        raise ValueError("predecessor indices must fit 16 bits")
    return _jitted()(xhi, rpos, qpos, span, sid, stw, nn, w1, exc,
                     max_n=max_n, max_dist_x=max_dist_x,
                     max_dist_y=max_dist_y, bw=bw, max_skip=max_skip,
                     is_cdna=bool(is_cdna), many_segs=bool(many_segs))


@functools.lru_cache(maxsize=None)
def _jitted():
    import jax

    def run(*args, **kw):
        return chain_impl(jax.default_backend())(*args, **kw)
    return jax.jit(run, static_argnames=(
        "max_n", "max_dist_x", "max_dist_y", "bw", "max_skip", "is_cdna",
        "many_segs"))


def pad_rows(n_reads: int, floor: int = 8) -> int:
    """Padded batch rows: the next power of two at or above `floor`, so
    the set of compiled shapes stays small."""
    rp = floor
    while rp < n_reads:
        rp *= 2
    return rp


def pack_reads(reads, max_n: int, max_dist_x: int):
    """Pack per-read component dicts into (R, max_n) arrays plus per-read
    counts, f32 gap-cost slopes, exception lists, and the precomputed
    max_dist_x window starts (the reference's sliding st, chain.c:58).
    Returns (packed, nn, w1, exc, host_flag) where host_flag marks reads
    whose exception list overflowed (must take the host path)."""
    R = pad_rows(len(reads))
    out = {k: np.zeros((R, max_n), dtype=np.int32)
           for k in ("xhi", "rpos", "qpos", "span", "sid", "stw")}
    out["xhi"][:] = -1
    nn = np.zeros(R, dtype=np.int32)
    w1 = np.zeros(R, dtype=np.float32)
    exc = np.full((R, 2 * N_EXC), -1, dtype=np.int32)
    host_flag = np.zeros(R, dtype=bool)
    for r, rd in enumerate(reads):
        n = len(rd["rpos"])
        for k in ("xhi", "rpos", "qpos", "span", "sid"):
            out[k][r, :n] = rd[k]
        nn[r] = n
        if n == 0:
            continue
        # window start: first j with x[j] >= x[i] - max_dist_x on the
        # reconstructed unsigned 64-bit a[].x sort key (chain.c:58), FUSED
        # with the first same-xhi index: within [stw, i) every candidate
        # then has xh == xi AND dr <= max_dist_x by construction, so the
        # single-segment scorer tests only j >= stw (and windows stop at
        # strand/rid boundaries instead of scanning cross-strand anchors)
        key = ((rd["xhi"].astype(np.int64) & 0xFFFFFFFF).astype(np.uint64)
               << np.uint64(32)) | rd["rpos"].astype(np.uint64)
        dd = np.uint64(max_dist_x)
        target = np.where(key >= dd, key - dd, np.uint64(0))
        sx = np.searchsorted(key, key & ~np.uint64(0xFFFFFFFF), side="left")
        out["stw"][r, :n] = np.maximum(
            np.searchsorted(key, target, side="left"), sx).astype(np.int32)
        avg = np.float32(rd["avg_qspan"])
        assert avg >= 1.6, "tiny avg_qspan breaks the c_log shortcut"
        best_w, excl = clin_slope_exc(avg)
        if excl is None:
            host_flag[r] = True
            continue
        w1[r] = best_w
        for k, (dd, val) in enumerate(excl):
            exc[r, 2 * k] = dd
            exc[r, 2 * k + 1] = val
    return out, nn, w1, exc, host_flag
