"""Multi-chip mapping step: sharded seed lookup + data-parallel chaining.

The "model" being sharded is the mapping pipeline itself:
  * "data" axis: read batches are data-parallel (the reference's kt_for over
    fragments, SURVEY.md §2 parallelism #2)
  * "index" axis: the sorted minimizer table is sharded across chips for
    genomes larger than one chip's HBM; per-shard lookups are combined with a
    psum over the index axis (all-to-all seed routing in gather form).
    With index_shards=1 this reduces to the replicated-index fast path with
    no hot-path collectives.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import chain_batch as CB


def make_sharded_collect_step(mesh: Mesh, *, cap: int):
    """Build the jitted sharded-index seed-collect step (>chip-HBM genomes).

    The CSR minimizer index is key-range-sharded over the "index" axis
    (ops/seeds_device.shard_index_tables); query minimizer batches are
    data-parallel over "data". Each index shard looks up its own key range
    and the disjoint per-slot anchor contributions combine with psums — no
    shard ever holds the whole index. Output anchors are
    data-sharded and identical to the single-chip device collector's.
    """
    from ..ops.seeds_device import _collect_dev
    dspec, ispec = P("data"), P("index")

    def step(khi, klo, starts, vhi, vlo, qhi, qlo, qvalid, qpos, qspan,
             qseg, qtnd, max_occ, qls):
        return _collect_dev(khi, klo, starts, vhi, vlo, qhi, qlo, qvalid,
                            qpos, qspan, qseg, qtnd, max_occ, qls,
                            cap=cap, axis_name="index")

    return jax.jit(shard_map(
        step, mesh=mesh,
        in_specs=(ispec, ispec, ispec, ispec, ispec,
                  dspec, dspec, dspec, dspec, dspec, dspec, dspec,
                  P(), dspec),
        out_specs=(dspec,) * 7,
        check_vma=False,
    ))


def make_sharded_flow_step(mesh: Mesh, *, cap: int, max_dist_x: int,
                           max_dist_y: int, bw: int, max_skip: int,
                           score_bound: int, ship_anchors: bool = True):
    """Multi-chip fused mapping step: sharded-index seed collection with
    CAPACITY-BOUNDED hit routing, then the data-parallel window + chaining
    stages of the single-chip flow (models/device_flow.flow_tail).

    Collective design (replaces the dense anchor psum of the r1 demo):
      1. ONE psum of per-minimizer occurrence COUNTS (R_local x M int32 —
         kilobytes) gives every shard the exact global anchor-slot base of
         each minimizer (keys partition across shards, so each count has
         exactly one owner).
      2. Each shard expands ITS OWN hits into a compact (R_local,
         cap/n_index) buffer tagged with global slot ids; the host sizes
         that buffer from the real per-shard hit counts and falls back on
         overflow, so the all_gather that routes hits to the data owner
         moves only actual anchors — collective volume is bounded by the
         true anchor count, never the padded capacity (all-to-all seed
         routing, in gather form).
      3. One 3-key stable sort ((biased xhi, rpos, global slot)) rebuilds
         the exact single-device anchor order, so output is byte-identical
         to the single-chip flow; windows + chaining then run with ZERO
         collectives on the data axis.
    """
    from .device_flow import SIGN, derive_queries, flow_tail
    dspec, ispec = P("data"), P("index")
    n_index = mesh.shape["index"]
    cap_shard = cap // n_index
    assert cap_shard * n_index == cap and cap_shard >= 1

    def step(khi, klo, starts, vhi, vlo, qhi, qlo, qpos, qspan8, nmv,
             max_occ, qls, nn, w1, exc):
        qvalid, qspan, qtnd, qseg = derive_queries(qhi, qlo, qspan8, nmv)
        R, M = qhi.shape
        K = khi.shape[0]

        def bs_step(_, state):
            lo, hi = state
            mid = (lo + hi) >> 1
            mh = jnp.take(khi, mid)
            ml = jnp.take(klo, mid)
            less = (mh < qhi) | ((mh == qhi) & (ml < qlo))
            return jnp.where(less, mid + 1, lo), jnp.where(less, hi, mid)

        n_iter = int(np.ceil(np.log2(max(K, 2)))) + 1
        pos, _ = jax.lax.fori_loop(
            0, n_iter, bs_step, (jnp.zeros((R, M), jnp.int32),
                                 jnp.full((R, M), K, jnp.int32)))
        pos_c = jnp.minimum(pos, max(K - 1, 0))
        found = qvalid & (jnp.take(khi, pos_c) == qhi) \
            & (jnp.take(klo, pos_c) == qlo)
        cnt = jnp.where(found, jnp.take(starts, pos_c + 1)
                        - jnp.take(starts, pos_c), 0)
        keep = found & (cnt < max_occ)
        occ_l = jnp.where(keep, cnt, 0)
        # collective 1: count psum (each minimizer owned by one shard)
        occ_g = jax.lax.psum(occ_l, "index")
        cum_g = jnp.cumsum(occ_g, axis=1)
        base_m = cum_g - occ_g
        total = cum_g[:, -1]

        # compact local expansion into cap_shard slots + global slot ids
        cum_l = jnp.cumsum(occ_l, axis=1)
        total_l = cum_l[:, -1]
        slot = jnp.arange(cap_shard, dtype=jnp.int32)[None, :]
        midx = jax.vmap(lambda c, s: jnp.searchsorted(c, s, side="right"))(
            cum_l, jnp.broadcast_to(slot, (R, cap_shard)))
        midx_c = jnp.minimum(midx, M - 1)
        cum_prev = jnp.where(
            midx_c > 0,
            jnp.take_along_axis(cum_l, jnp.maximum(midx_c - 1, 0), axis=1),
            0)
        within = slot - cum_prev
        live_l = slot < total_l[:, None]
        vidx = jnp.take_along_axis(jnp.take(starts, pos_c), midx_c,
                                   axis=1) + within
        vidx = jnp.clip(vidx, 0, vhi.shape[0] - 1)
        rid = jnp.take(vhi, vidx)
        rlo = jnp.take(vlo, vidx)
        rpos = (rlo >> 1) & 0x7FFFFFFF
        rstrand = rlo & 1
        qp = jnp.take_along_axis(qpos, midx_c, axis=1)
        qsp = jnp.take_along_axis(qspan, midx_c, axis=1)
        sid = jnp.take_along_axis(qseg, midx_c, axis=1)
        tnd = jnp.take_along_axis(qtnd, midx_c, axis=1)
        fwd = rstrand == (qp & 1)
        xhi = jnp.where(fwd, rid, rid ^ SIGN)
        xlo = rpos
        ylo = jnp.where(fwd, qp >> 1, qls - ((qp >> 1) + 1 - qsp) - 1)
        from .. import constants as C
        yhi = qsp | jnp.where(tnd != 0, C.MM_SEED_TANDEM >> 32, 0) \
            | (sid << (C.MM_SEED_SEG_SHIFT - 32))
        gslot = jnp.take_along_axis(base_m, midx_c, axis=1) + within
        gslot = jnp.where(live_l, gslot, jnp.int32(0x7FFFFFFF))

        # collective 2: capacity-bounded hit routing (compact all_gather)
        def ag(x):
            g = jax.lax.all_gather(x, "index", axis=0)  # (n_i, R, S)
            return jnp.moveaxis(g, 0, 1).reshape(R, cap)

        gs, xh2, xl2, yh2, yl2 = (ag(v)
                                  for v in (gslot, xhi, xlo, yhi, ylo))
        # one 3-key stable sort rebuilds the exact single-device order:
        # (biased xhi, rpos) is _collect_dev's x sort; the global slot id
        # reproduces its stable pre-sort (expansion) order on ties and
        # pushes pads (huge keys) to the tail
        pad = gs == 0x7FFFFFFF
        skh = jnp.where(pad, jnp.int32(0x7FFFFFFF), xh2 ^ SIGN)
        skl = jnp.where(pad, jnp.int32(0x7FFFFFFF), xl2)
        _, _, _, xh2, xl2, yh2, yl2 = jax.lax.sort(
            (skh, skl, gs, xh2, xl2, yh2, yl2), dimension=1, num_keys=3,
            is_stable=True)
        return flow_tail(
            xh2, xl2, yh2, yl2, total, nn, w1, exc, cap=cap,
            max_dist_x=max_dist_x, max_dist_y=max_dist_y, bw=bw,
            max_skip=max_skip, score_bound=score_bound,
            ship_anchors=ship_anchors)

    return jax.jit(shard_map(
        step, mesh=mesh,
        in_specs=(ispec, ispec, ispec, ispec, ispec,
                  dspec, dspec, dspec, dspec, dspec, P(), dspec,
                  dspec, dspec, dspec),
        out_specs=(dspec,) * (7 if ship_anchors else 3),
        check_vma=False,
    ))


def make_sharded_map_step(mesh: Mesh, *, max_n: int, max_dist: int, bw: int,
                          max_skip: int):
    """Build the jitted multi-chip mapping compute step.

    Inputs (global shapes):
      qkeys   (R, M) int32   — per-read query minimizer keys  [data-sharded]
      xhi/rpos/qpos/span/sid (R, max_n) int32 — anchors       [data-sharded]
      nn      (R,) int32     — per-read anchor counts          [data-sharded]
      w1 (R,) / exc (R, 2*N_EXC) — gap-cost slope + exceptions [data-sharded]
      keys    (K,) int32     — sorted index keys               [index-sharded]
    Returns f, p, flag (data-sharded) and occ (R, M) total occurrence counts
    across all index shards (psum over "index").
    """
    dspec = P("data")
    ispec = P("index")

    def step(qkeys, xhi, rpos, qpos, span, sid, stw, nn, w1, exc, keys):
        # sharded-index seed lookup: local binary search + psum over shards
        pos = jnp.searchsorted(keys, qkeys)
        pos_c = jnp.minimum(pos, keys.shape[0] - 1)
        hit = (keys[pos_c] == qkeys).astype(jnp.int32)
        occ = jax.lax.psum(hit, "index")

        f, p, flag = CB.chain_scores_batch(
            xhi, rpos, qpos, span, sid, stw, nn, w1, exc, max_n=max_n,
            max_dist_x=max_dist, max_dist_y=max_dist, bw=bw,
            max_skip=max_skip, is_cdna=False, many_segs=False)
        # cross-shard summary
        total_flagged = jax.lax.psum(jnp.sum(flag), "data")
        return f, p, flag, occ, total_flagged

    return jax.jit(shard_map(
        step, mesh=mesh,
        in_specs=(dspec, dspec, dspec, dspec, dspec, dspec, dspec, dspec, dspec, dspec, ispec),
        out_specs=(dspec, dspec, dspec, dspec, P()),
        check_vma=False,
    ))
