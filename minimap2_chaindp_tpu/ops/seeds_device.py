"""Device-batched seed-hit collection — the device replacement for
the reference's FPGA seed-collect offload (collect_seed_hits, map.c:187-236,
device tables index.c:603-720).

The sorted minimizer table lives on device as split int32 key halves (biased
so signed compares give unsigned order), with a CSR starts array and split
values.  For a padded batch of reads' query minimizers this stage does:

  * lexicographic binary search over the split keys (mm_idx_get)
  * occurrence counting and mid_occ masking (map.c:119-141)
  * CSR expansion of every (match, occurrence) into anchor slots, capped at
    CAP per read (overflow reads fall back to the host, the err_flag way)
  * anchor synthesis with strand flip and tandem/self flags (map.c:216-229)
  * a stable multi-key sort by anchor.x (= radix_sort_128x, map.c:233)

Everything is plain jnp/XLA (gather/searchsorted/sort), left to XLA's own
GPU code; the hand-written kernel budget stays on the chaining pass.
Validated bit-exactly against ops/seeds.collect_seed_hits.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C

BIAS = np.int64(0x80000000)   # maps u32 order onto i32 order


def split_u64(v: np.ndarray):
    """u64 -> (hi, lo) int32 with the *hi/lo bias* applied so that signed
    (hi, lo) lexicographic order equals unsigned u64 order."""
    hi = ((v >> np.uint64(32)).astype(np.int64) - BIAS).astype(np.int32)
    lo = ((v & np.uint64(0xFFFFFFFF)).astype(np.int64) - BIAS).astype(np.int32)
    return hi, lo


def _index_fingerprint(mi, with_keys: bool):
    """Content fingerprint for the device-table cache: a fresh process
    re-loads the same .mm2i per run (mmap, new array objects), and at
    genome scale re-uploading the tables costs seconds per run —
    sentinel values make the reuse safe without hashing gigabytes."""
    nk, nv = len(mi.keys), len(mi.values)
    if nk == 0:
        return None
    return (with_keys, nk, nv, int(mi.keys[0]), int(mi.keys[-1]),
            int(mi.keys[nk // 2]), int(mi.values[0]), int(mi.values[-1]),
            int(mi.starts[nk // 2]))


_DEVICE_INDEX_CACHE: dict = {}


def device_index_cached(mi, with_keys: bool = True):
    """Process-level DeviceIndex reuse keyed by content fingerprint (at
    most 2 live entries — an old genome's tables free when evicted)."""
    fp = _index_fingerprint(mi, with_keys)
    if fp is None:
        return DeviceIndex(mi, with_keys=with_keys)
    dx = _DEVICE_INDEX_CACHE.get(fp)
    if dx is None:
        dx = DeviceIndex(mi, with_keys=with_keys)
        if len(_DEVICE_INDEX_CACHE) >= 2:
            _DEVICE_INDEX_CACHE.pop(next(iter(_DEVICE_INDEX_CACHE)))
        _DEVICE_INDEX_CACHE[fp] = dx
    return dx


class DeviceIndex:
    """Device-resident flat index tables (the analog of the fork's B/H/V/P
    FPGA images, index.c:603-720)."""

    def __init__(self, mi, with_keys: bool = True):
        # with_keys=False skips the split-key tables: the H2D-slim flow
        # (_collect_dev_pos) ships host-computed CSR positions instead of
        # keys, so only starts/vhi/vlo need to live in HBM (~40% less
        # upload for a real genome)
        if with_keys:
            khi, klo = split_u64(mi.keys)
            self.khi = jnp.asarray(khi)
            self.klo = jnp.asarray(klo)
        else:
            self.khi = self.klo = None
        self.starts = jnp.asarray(mi.starts.astype(np.int32))
        vhi = (mi.values >> np.uint64(32)).astype(np.int64).astype(np.int32)
        vlo = (mi.values & np.uint64(0xFFFFFFFF)).astype(np.int64) \
            .astype(np.int32)
        self.vhi = jnp.asarray(vhi)
        self.vlo = jnp.asarray(vlo)
        self.n_keys = len(mi.keys)


@functools.partial(jax.jit, static_argnames=("cap", "axis_name"))
def _collect_dev(khi, klo, starts, vhi, vlo, qhi, qlo, qvalid, qpos, qspan,
                 qseg, qtandem, max_occ, qlen_sum, *, cap, axis_name=None):
    """The batched device stage. q* inputs are (R, M); returns per-read padded
    anchor component arrays (R, cap) sorted by x, plus cnt/over masks.

    With `axis_name` set (inside shard_map), the index tables are one shard
    of a key-range-sharded CSR: every key's occurrence list lives on exactly
    one shard, so per-query counts and per-slot anchor components combine
    across shards with a psum (all-reduce over the index axis) — the all-to-all seed
    routing design for >chip-HBM genomes (all-to-all seed routing, in gather form)."""
    R, M = qhi.shape
    K = khi.shape[0]

    # lexicographic binary search (searchsorted-left over split keys)
    def bs_step(_, state):
        lo, hi = state
        mid = (lo + hi) >> 1
        mh = jnp.take(khi, mid)
        ml = jnp.take(klo, mid)
        less = (mh < qhi) | ((mh == qhi) & (ml < qlo))
        return jnp.where(less, mid + 1, lo), jnp.where(less, hi, mid)

    n_iter = max(int(np.ceil(np.log2(max(K, 2)))) + 1, 1)
    lo0 = jnp.zeros((R, M), jnp.int32)
    hi0 = jnp.full((R, M), K, jnp.int32)
    pos, _ = jax.lax.fori_loop(0, n_iter, bs_step, (lo0, hi0))
    pos_c = jnp.minimum(pos, max(K - 1, 0))
    found = qvalid & (jnp.take(khi, pos_c) == qhi) \
        & (jnp.take(klo, pos_c) == qlo) & (K > 0)
    cnt = jnp.where(found, jnp.take(starts, pos_c + 1)
                    - jnp.take(starts, pos_c), 0)
    over = found & (cnt >= max_occ)
    keep = found & ~over
    occ = jnp.where(keep, cnt, 0)
    if axis_name is not None:
        # each query key is owned by exactly one shard: psum = gather
        occ = jax.lax.psum(occ, axis_name)
        cnt_out = jax.lax.psum(cnt, axis_name)
        over_out = jax.lax.psum(over.astype(jnp.int32), axis_name) > 0
    else:
        cnt_out, over_out = cnt, over

    # CSR expansion: slot s of a read belongs to the match whose cumulative
    # occurrence range contains s
    cum = jnp.cumsum(occ, axis=1)
    total = cum[:, -1]
    slot = jnp.arange(cap, dtype=jnp.int32)[None, :]
    midx = jax.vmap(lambda c, s: jnp.searchsorted(c, s, side="right"))(
        cum, jnp.broadcast_to(slot, (R, cap)))
    midx_c = jnp.minimum(midx, M - 1)
    cum_prev = jnp.where(midx_c > 0,
                         jnp.take_along_axis(cum, jnp.maximum(midx_c - 1, 0),
                                             axis=1), 0)
    within = slot - cum_prev
    live = slot < total[:, None]
    vidx = jnp.take_along_axis(jnp.take(starts, pos_c), midx_c, axis=1) \
        + within
    vidx = jnp.clip(vidx, 0, vhi.shape[0] - 1)
    sign = jnp.int32(-0x80000000)
    rid = jnp.take(vhi, vidx)
    rlo = jnp.take(vlo, vidx)   # raw low-32 bit pattern (pos<<1|strand)
    rpos = (rlo >> 1) & 0x7FFFFFFF
    rstrand = rlo & 1

    qp = jnp.take_along_axis(qpos, midx_c, axis=1)
    qsp = jnp.take_along_axis(qspan, midx_c, axis=1)
    sid = jnp.take_along_axis(qseg, midx_c, axis=1)
    tnd = jnp.take_along_axis(qtandem, midx_c, axis=1)
    fwd = rstrand == (qp & 1)

    # anchor encoding (map.c:216-229); xhi carries rev in the sign bit,
    # exactly like ops/chain_jax.split_anchors
    xhi = jnp.where(fwd, rid, rid ^ sign)
    xlo = rpos
    qpos_out = jnp.where(fwd, qp >> 1, qlen_sum - ((qp >> 1) + 1 - qsp) - 1)
    yhi = qsp | jnp.where(tnd != 0, C.MM_SEED_TANDEM >> 32, 0) \
        | (sid << (C.MM_SEED_SEG_SHIFT - 32))
    ylo = qpos_out

    if axis_name is not None:
        # a slot's values are real only on the shard owning its match;
        # zero elsewhere, then psum-combine the disjoint contributions
        own = jnp.take_along_axis(keep, midx_c, axis=1) & live
        xhi, xlo, yhi, ylo = (
            jax.lax.psum(jnp.where(own, v, 0), axis_name)
            for v in (xhi, xlo, yhi, ylo))

    # stable sort by x == (xhi unsigned, xlo): bias xhi for signed compare
    pad = ~live
    sk_hi = jnp.where(pad, jnp.int32(0x7FFFFFFF), xhi ^ sign)
    sk_lo = xlo
    sk_hi, sk_lo, xhi, xlo, yhi, ylo = jax.lax.sort(
        (sk_hi, sk_lo, xhi, xlo, yhi, ylo), dimension=1, num_keys=2,
        is_stable=True)
    return xhi, xlo, yhi, ylo, total, cnt_out, over_out


def _collect_dev_pos(starts, vhi, vlo, qposidx, qpos, qspan,
                     qseg, qtandem, max_occ, qlen_sum, *, cap):
    """H2D-slim single-chip collect: the HOST ships each query minimizer's
    CSR key position (searchsorted result, -1 when absent — it computes
    them anyway for the pre-dispatch stats, device_flow.host_seed_stats)
    instead of the 8-byte split key, so the device skips the lexicographic
    binary search and the key tables' H2D role entirely. Expansion, anchor
    encoding and the stable x-sort are identical to _collect_dev; the host
    and device CSR copies are the same table, so positions agree by
    construction. Single-chip only — the mesh step keeps key shipping (its
    per-shard tables make positions shard-relative)."""
    R, M = qposidx.shape
    found = qposidx >= 0
    pos_c = jnp.maximum(qposidx, 0)
    cnt = jnp.where(found, jnp.take(starts, pos_c + 1)
                    - jnp.take(starts, pos_c), 0)
    over = found & (cnt >= max_occ)
    keep = found & ~over
    occ = jnp.where(keep, cnt, 0)

    cum = jnp.cumsum(occ, axis=1)
    total = cum[:, -1]
    slot = jnp.arange(cap, dtype=jnp.int32)[None, :]
    midx = jax.vmap(lambda c, s: jnp.searchsorted(c, s, side="right"))(
        cum, jnp.broadcast_to(slot, (R, cap)))
    midx_c = jnp.minimum(midx, M - 1)
    cum_prev = jnp.where(midx_c > 0,
                         jnp.take_along_axis(cum, jnp.maximum(midx_c - 1, 0),
                                             axis=1), 0)
    within = slot - cum_prev
    live = slot < total[:, None]
    vidx = jnp.take_along_axis(jnp.take(starts, pos_c), midx_c, axis=1) \
        + within
    vidx = jnp.clip(vidx, 0, vhi.shape[0] - 1)
    sign = jnp.int32(-0x80000000)
    rid = jnp.take(vhi, vidx)
    rlo = jnp.take(vlo, vidx)
    rpos = (rlo >> 1) & 0x7FFFFFFF
    rstrand = rlo & 1

    qp = jnp.take_along_axis(qpos, midx_c, axis=1).astype(jnp.int32)
    qsp = jnp.take_along_axis(qspan, midx_c, axis=1)
    sid = jnp.take_along_axis(qseg, midx_c, axis=1)
    tnd = jnp.take_along_axis(qtandem, midx_c, axis=1)
    fwd = rstrand == (qp & 1)

    xhi = jnp.where(fwd, rid, rid ^ sign)
    xlo = rpos
    qpos_out = jnp.where(fwd, qp >> 1, qlen_sum - ((qp >> 1) + 1 - qsp) - 1)
    yhi = qsp | jnp.where(tnd != 0, C.MM_SEED_TANDEM >> 32, 0) \
        | (sid << (C.MM_SEED_SEG_SHIFT - 32))
    ylo = qpos_out

    pad = ~live
    sk_hi = jnp.where(pad, jnp.int32(0x7FFFFFFF), xhi ^ sign)
    sk_lo = xlo
    sk_hi, sk_lo, xhi, xlo, yhi, ylo = jax.lax.sort(
        (sk_hi, sk_lo, xhi, xlo, yhi, ylo), dimension=1, num_keys=2,
        is_stable=True)
    return xhi, xlo, yhi, ylo, total, cnt, over


def shard_index_tables(mi, n_shards: int):
    """Split the CSR index into `n_shards` equal-padded key-range shards for
    an index-sharded mesh axis (>chip-HBM genomes). Every key's occurrence
    list lives entirely on one shard (the psum-combine disjointness
    invariant); shard cuts balance cumulative VALUE volume, so the per-shard
    padding Vp is ~V/n_shards plus at most one key's list (shard_map needs
    equal block shapes — a single key hotter than V/n_shards sets the
    floor). Returns stacked arrays shaped (n_shards*Kp,) keys /
    (n_shards*(Kp+1),) starts / (n_shards*Vp,) values, ready to device_put
    with PartitionSpec("index")."""
    K = len(mi.keys)
    khi_g, klo_g = split_u64(mi.keys)
    vhi_g = (mi.values >> np.uint64(32)).astype(np.int64).astype(np.int32)
    vlo_g = (mi.values & np.uint64(0xFFFFFFFF)).astype(np.int64) \
        .astype(np.int32)
    # cut by cumulative VALUE volume, not key count: occurrence-skewed
    # genomes would otherwise pad every shard's value table to the hottest
    # shard's size (the structure exists because values exceed one HBM)
    V = len(mi.values)
    targets = [(s * V) // n_shards for s in range(n_shards + 1)]
    cuts = [int(np.searchsorted(mi.starts, t, side="left"))
            for t in targets]
    cuts[0], cuts[-1] = 0, K
    for s in range(1, n_shards):  # keep cuts monotone on tiny indexes
        cuts[s] = min(max(cuts[s], cuts[s - 1]), K)
    Kp = max(max(cuts[s + 1] - cuts[s] for s in range(n_shards)), 1)
    khi = np.full((n_shards, Kp), 0x7FFFFFFF, np.int32)
    klo = np.full((n_shards, Kp), 0x7FFFFFFF, np.int32)
    Vp = max(max(int(mi.starts[cuts[s + 1]] - mi.starts[cuts[s]])
                 for s in range(n_shards)), 1)
    starts = np.zeros((n_shards, Kp + 1), np.int32)
    vhi = np.zeros((n_shards, Vp), np.int32)
    vlo = np.zeros((n_shards, Vp), np.int32)
    for s in range(n_shards):
        k0, k1 = cuts[s], cuts[s + 1]
        n = k1 - k0
        khi[s, :n] = khi_g[k0:k1]
        klo[s, :n] = klo_g[k0:k1]
        v0, v1 = int(mi.starts[k0]), int(mi.starts[k1])
        # local CSR: rebased starts; sentinel keys repeat the end offset so
        # their counts are 0 (a query colliding with the sentinel is harmless)
        starts[s, :n + 1] = mi.starts[k0:k1 + 1] - v0
        starts[s, n + 1:] = v1 - v0
        vhi[s, :v1 - v0] = vhi_g[v0:v1]
        vlo[s, :v1 - v0] = vlo_g[v0:v1]
    return (khi.reshape(-1), klo.reshape(-1), starts.reshape(-1),
            vhi.reshape(-1), vlo.reshape(-1), Kp, Vp, cuts)


class DeviceSeedCollector:
    """Batched device seed collection with host assembly of SeedHits."""

    def __init__(self, mi, cap: int = 8192, m_bucket: tuple = (256, 1024, 4096)):
        self.mi = mi
        self.dx = DeviceIndex(mi)
        self.cap = cap
        self.m_bucket = m_bucket

    def collect_batch(self, mvs: list, max_occ: int, qlen_sums: list):
        """mvs: per-read minimizer arrays ((n,2) u64). Returns a list of
        SeedHits-or-None (None = host fallback needed)."""
        from .seeds import SeedHits
        out = [None] * len(mvs)
        by_m: dict[int, list[int]] = {}
        for i, mv in enumerate(mvs):
            b = next((b for b in self.m_bucket if len(mv) <= b), None)
            if b is not None and len(mv) > 0:
                by_m.setdefault(b, []).append(i)
        for m, idxs in sorted(by_m.items()):
            R = (len(idxs) + 7) // 8 * 8
            Rp = 8
            while Rp < R:
                Rp *= 2
            R = Rp  # pow2: bounded set of compiled shapes
            qhi = np.full((R, m), 0x7FFFFFFF, np.int32)
            qlo = np.zeros((R, m), np.int32)
            qvalid = np.zeros((R, m), bool)
            qpos = np.zeros((R, m), np.int32)
            qspan = np.zeros((R, m), np.int32)
            qseg = np.zeros((R, m), np.int32)
            qtnd = np.zeros((R, m), np.int32)
            qls = np.zeros((R, 1), np.int32)
            for r, i in enumerate(idxs):
                mv = mvs[i]
                n = len(mv)
                key = mv[:, 0] >> np.uint64(8)
                hi, lo = split_u64(key)
                qhi[r, :n] = hi
                qlo[r, :n] = lo
                qvalid[r, :n] = True
                qpos[r, :n] = (mv[:, 1] & np.uint64(0xFFFFFFFF)).astype(np.int64)
                qspan[r, :n] = (mv[:, 0] & np.uint64(0xFF)).astype(np.int64)
                qseg[r, :n] = ((mv[:, 1] >> np.uint64(32))).astype(np.int64)
                if n > 1:
                    same = key[1:] == key[:-1]
                    qtnd[r, :n - 1] |= same
                    qtnd[r, 1:n] |= same
                qls[r, 0] = qlen_sums[i]
            res = _collect_dev(self.dx.khi, self.dx.klo, self.dx.starts,
                               self.dx.vhi, self.dx.vlo,
                               jnp.asarray(qhi), jnp.asarray(qlo),
                               jnp.asarray(qvalid), jnp.asarray(qpos),
                               jnp.asarray(qspan), jnp.asarray(qseg),
                               jnp.asarray(qtnd), jnp.int32(max_occ),
                               jnp.asarray(qls), cap=self.cap)
            xhi, xlo, yhi, ylo, total, cnt, over = (np.asarray(v) for v in res)
            for r, i in enumerate(idxs):
                if total[r] > self.cap:
                    continue  # overflow -> host fallback
                mv = mvs[i]
                n = len(mv)
                t = int(total[r])
                x = (xhi[r, :t].astype(np.int64) & 0xFFFFFFFF).astype(np.uint64) \
                    << np.uint64(32) | xlo[r, :t].astype(np.uint64)
                y = (yhi[r, :t].astype(np.int64) & 0xFFFFFFFF).astype(np.uint64) \
                    << np.uint64(32) | ylo[r, :t].astype(np.uint64)
                anchors = np.stack([x, y], axis=1)
                ov = over[r, :n]
                from .seeds import mini_pos_of
                out[i] = SeedHits(anchors, _rep_len(mv, ov),
                                  mini_pos_of(mv, ~ov))
        return out


def _rep_len(mv, over):
    """Repetitive-region length from over-occurring minimizers (map.c:119-141)."""
    q_pos = (mv[:, 1] & np.uint64(0xFFFFFFFF)).astype(np.int64)
    q_span = (mv[:, 0] & np.uint64(0xFF)).astype(np.int64)
    rep_len = 0
    rep_st = rep_en = 0
    for i in np.nonzero(over)[0]:
        en = (q_pos[i] >> 1) + 1
        st = en - q_span[i]
        if st > rep_en:
            rep_len += rep_en - rep_st
            rep_st, rep_en = st, en
        else:
            rep_en = en
    rep_len += rep_en - rep_st
    return int(rep_len)
