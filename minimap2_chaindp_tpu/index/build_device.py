"""Device-side index CSR construction: the O(n log n) minimizer pair sort
runs on the device (jax.lax.sort over split-u32 key halves), the cheap O(n)
run-boundary pass stays on the host.

The reference builds its index with a 56-thread kt_pipeline sort
(index.c:394 radix_sort_64 per bucket, run.sh:3); the device analog is one
sort over the whole (key, value) pair stream — for GRCh38-class inputs
(~500M pairs) a single large-array sort at device-memory bandwidth.
Opt-in (MM2TPU_DEVICE_INDEX=1 or build_index(device=True)): whether it
beats the native host path once the pair stream's H2D/D2H is counted is
not measured, so the default stays on the host.

Output is BIT-IDENTICAL to the host CSR: u64 sort order == lexicographic
(biased-int32 hi, lo) order, and equal (key, value) pairs are
interchangeable, so keys/starts/values match np.lexsort exactly.
"""
from __future__ import annotations

import numpy as np

_B32 = np.uint32(0x80000000)


def _split_biased(u64: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """u64 -> (hi, lo) int32 whose SIGNED lexicographic order equals the
    unsigned u64 order (both halves XOR the sign bit, bit-pattern view)."""
    u = u64.astype(np.uint64, copy=False)
    hi = ((u >> np.uint64(32)).astype(np.uint32) ^ _B32).view(np.int32)
    lo = ((u & np.uint64(0xFFFFFFFF)).astype(np.uint32) ^ _B32).view(np.int32)
    return hi, lo


def _unbias_join(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    h = (np.ascontiguousarray(hi).view(np.uint32) ^ _B32).astype(np.uint64)
    l = (np.ascontiguousarray(lo).view(np.uint32) ^ _B32).astype(np.uint64)
    return (h << np.uint64(32)) | l


def build_csr_device(mvs: list[np.ndarray]):
    """Sorted CSR tables (keys, starts, values) from per-contig minimizer
    arrays, with the pair sort on the accelerator. Returns None when jax
    is unavailable (caller falls back to the host path)."""
    try:
        import jax
        import jax.numpy as jnp
    except Exception:
        return None
    mv = np.concatenate(mvs, axis=0) if mvs \
        else np.empty((0, 2), dtype=np.uint64)
    if len(mv) == 0:
        return (np.empty(0, np.uint64), np.zeros(1, np.int64),
                np.empty(0, np.uint64))
    key = np.ascontiguousarray(mv[:, 0] >> np.uint64(8))
    val = np.ascontiguousarray(mv[:, 1])
    khi, klo = _split_biased(key)
    vhi, vlo = _split_biased(val)

    @jax.jit
    def _sort(khi, klo, vhi, vlo):
        return jax.lax.sort((khi, klo, vhi, vlo), num_keys=4,
                            is_stable=False)

    khi_s, klo_s, vhi_s, vlo_s = (np.asarray(a)
                                  for a in _sort(khi, klo, vhi, vlo))
    key_s = _unbias_join(khi_s, klo_s)
    val_s = _unbias_join(vhi_s, vlo_s)
    neq = np.empty(len(key_s), dtype=bool)
    neq[0] = True
    np.not_equal(key_s[1:], key_s[:-1], out=neq[1:])
    starts = np.flatnonzero(neq)
    keys = key_s[starts]
    starts = np.concatenate([starts, [len(val_s)]]).astype(np.int64)
    return keys, starts, val_s
