"""Chaining DP on device — exact vectorized formulation (JAX).

The reference inner loop (chain.c:246-284) is a banded predecessor scan with an
order-dependent `max_skip` early break driven by an iteration-local stamp array
t[] (SURVEY.md §7 "hard parts"). This module reformulates one outer iteration i
as pure vector ops, bit-exactly:

  * window mask      — anchors sorted by x; the 64-bit distance window reduces
                       to (hi32 equal) & (rpos_i - rpos_j <= max_dist_x)
  * gap cost         — c_lin = trunc(dd * .01 * avg_qspan) is gathered from a
                       host-precomputed table (exact C double semantics; for
                       dd beyond the table c_lin provably exceeds c_log, so
                       min(c_lin, c_log) = c_log); ilog2 via float32 exponent
  * stamp array t[]  — t[j]==i  ⟺  some valid j' > j in this window has
                       p[j'] == j; computed with one scatter per iteration
  * max_skip break   — the clamped skip counter is a running sum minus its
                       running min (descending-j scan order); the break
                       truncates only the tail, so optimistic prefix values
                       are exact for every position before the break
  * f/p tie-breaking — strictly-greater running max in descending-j order
                       picks the LARGEST j among score ties

The per-read outer loop stays sequential (lax.fori_loop), parallelism comes
from vector lanes + batching reads. Output (f, p, v) feeds the unchanged host
bottom half (ops/chain.py chain_backtrack + compact construction, which this
module reconstructs from f/p/v exactly as chain.c:286-316 does).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from .chain import Chains, chain_backtrack, compact_from_fpv

NEG_INF = -0x40000000


def clin_table(avg_qspan_f32: float, max_dd: int) -> np.ndarray:
    """T[d] = (int)(d * .01 * avg_qspan), exact C double arithmetic (host)."""
    d = np.arange(max_dd + 1, dtype=np.float64)
    return (d * 0.01 * np.float64(np.float32(avg_qspan_f32))).astype(np.int32)


def ilog2_i32(v: jnp.ndarray) -> jnp.ndarray:
    """floor(log2(v)) for 1 <= v < 2^24 via the float32 exponent."""
    f = v.astype(jnp.float32)
    return (jax.lax.bitcast_convert_type(f, jnp.int32) >> 23) - 127


@partial(jax.jit, static_argnames=("n_max", "is_cdna", "many_segs"))
def chain_scores(xhi, rpos, qpos, span, sid, n, max_dist_x, max_dist_y, bw,
                 max_skip, clin, n_max, is_cdna: bool, many_segs: bool):
    """Exact f/p/v arrays for one read's sorted anchors (padded to n_max)."""
    idx = jnp.arange(n_max, dtype=jnp.int32)

    def body(i, state):
        f, p, v = state
        ri = rpos[i]
        qi = qpos[i]
        q_span = span[i]
        sidi = sid[i]
        before = idx < i
        window = before & (xhi == xhi[i]) & (ri - rpos <= max_dist_x)
        dr = ri - rpos
        dq = qi - qpos
        same = sid == sidi
        dd = jnp.abs(dr - dq)
        valid = window
        valid &= ~((same & (dr == 0)) | (dq <= 0))
        valid &= ~((same & (dq > max_dist_y)) | (dq > max_dist_x))
        valid &= ~(same & (dd > bw))
        if many_segs and not is_cdna:
            valid &= ~(same & (dr > max_dist_y))

        min_d = jnp.minimum(dq, dr)
        sc = jnp.minimum(min_d, q_span)
        log_dd = jnp.where(dd > 0, ilog2_i32(jnp.maximum(dd, 1)), 0)
        c_lin = jnp.where(dd < clin.shape[0], clin[jnp.minimum(dd, clin.shape[0] - 1)],
                          jnp.int32(0x3FFFFFFF))
        if is_cdna:
            pen_other = jnp.minimum(c_lin, log_dd)
            pen_same_fwd = c_lin + (log_dd >> 1)
            sc_adj = jnp.where(~same & (dr == 0), sc + 1,
                               jnp.where((dr > dq) | ~same, sc - pen_other,
                                         sc - pen_same_fwd))
        else:
            # same-seg pairs use the linear+log cost; different-seg pairs use
            # the is_cdna-style min cost (chain.c:265-272)
            pen_same = c_lin + (log_dd >> 1)
            pen_other = jnp.minimum(c_lin, log_dd)
            sc_adj = jnp.where(same, sc - pen_same,
                               jnp.where(dr == 0, sc + 1, sc - pen_other))
        sc_tot = sc_adj + f

        # iteration-local stamps: t[j]==i iff some valid j' (> j) has p[j']==j
        stamp_src = jnp.where(valid & (p >= 0), p, n_max + 1)
        stamped = jnp.zeros(n_max + 2, dtype=bool).at[stamp_src].set(
            True, mode="drop")[:n_max]

        # descending-j scan: flip to scan order
        sc_rev = jnp.where(valid, sc_tot, NEG_INF)[::-1]
        valid_rev = valid[::-1]
        stamped_rev = stamped[::-1]
        run_max = jax.lax.associative_scan(jnp.maximum, sc_rev)
        prev_max = jnp.concatenate([jnp.full((1,), q_span, dtype=sc_rev.dtype),
                                    jnp.maximum(run_max, q_span)[:-1]])
        improve = valid_rev & (sc_rev > prev_max)
        delta = jnp.where(improve, -1,
                          jnp.where(valid_rev & stamped_rev, 1, 0))
        ps = jnp.cumsum(delta)
        run_min = jnp.minimum(jax.lax.associative_scan(jnp.minimum, ps), 0)
        n_skip = ps - run_min
        broke = valid_rev & ~improve & stamped_rev & (n_skip > max_skip)
        # visited = strictly before the first break position (scan order)
        first_break = jnp.argmax(broke)
        has_break = jnp.any(broke)
        pos = jnp.arange(n_max, dtype=jnp.int32)
        visited = jnp.where(has_break, pos < first_break, True)

        sc_vis = jnp.where(visited & valid_rev, sc_rev, NEG_INF)
        max_f_rev = jnp.max(sc_vis)
        max_f = jnp.maximum(max_f_rev, q_span)
        # first scan position achieving the max (ties -> largest original j)
        arg = jnp.argmax(sc_vis)
        max_j = jnp.where(max_f_rev > q_span, n_max - 1 - arg, -1)

        f = f.at[i].set(max_f)
        p = p.at[i].set(max_j)
        vmj = jnp.where(max_j >= 0, v[jnp.maximum(max_j, 0)], NEG_INF)
        v = v.at[i].set(jnp.where((max_j >= 0) & (vmj > max_f), vmj, max_f))
        return f, p, v

    f0 = jnp.zeros(n_max, dtype=jnp.int32)
    p0 = jnp.full(n_max, -1, dtype=jnp.int32)
    v0 = jnp.zeros(n_max, dtype=jnp.int32)
    f, p, v = jax.lax.fori_loop(0, n, body, (f0, p0, v0))
    return f, p, v


# candidate columns scored per step of the batched plain version
WIN = 256


@partial(jax.jit, static_argnames=("max_n", "max_dist_x", "max_dist_y",
                                   "bw", "max_skip", "is_cdna", "many_segs"))
def chain_scores_batch_xla(xhi, rpos, qpos, span, sid, stw, nn, w1, exc, *,
                           max_n, max_dist_x, max_dist_y, bw, max_skip,
                           is_cdna, many_segs):
    """Plain jnp/lax version of ops/chain_batch.chain_scores_batch: the
    same inputs and (f, p, flag) contract, vectorized over the reads of the
    batch and over WIN predecessor candidates per step.

    Anchors run in order (f[i] needs every earlier f[j]); for anchor i the
    window [stw, i) is scanned newest-first in WIN-wide steps until every
    read's window is exhausted. Per read it keeps the best score (ties go
    to the larger j, which the reference's descending scan reaches first),
    its index, and how many valid candidates the descending scan meets
    before it; the read is flagged when that count exceeds max_skip for an
    anchor with a predecessor (ops/chain_batch.py: only then can the
    reference's early break change f/p)."""
    from .chain_batch import N_EXC, TBL
    R = rpos.shape[0]
    W = min(WIN, max_n)
    single_seg = not is_cdna and not many_segs
    mdy_x = min(max_dist_y, max_dist_x)
    # W leading pad columns: a step's slice never starts below column 0
    padw = lambda a: jnp.pad(a, ((0, 0), (W, 0)))
    xp, rp, qp, sp = padw(xhi), padw(rpos), padw(qpos), padw(sid)
    kk = jnp.arange(W, dtype=jnp.int32)[None, :]
    w1c = w1[:, None]
    excs = [(exc[:, 2 * k:2 * k + 1], exc[:, 2 * k + 1:2 * k + 2])
            for k in range(N_EXC)]
    cut = lambda a, s: jax.lax.dynamic_slice_in_dim(a, s, W, axis=1)

    def anchor(i, state):
        fp, p, flag = state
        col = lambda a: jax.lax.dynamic_slice_in_dim(a, i, 1, axis=1)
        xi, ri, qi, qs, si = (col(a) for a in (xhi, rpos, qpos, span, sid))
        st = col(stw)[:, 0]
        act = i < nn
        steps = jnp.max(jnp.where(act, (i - st + W - 1) // W, 0))

        def step(c, carry):
            best, best_j, snap, tot = carry
            s = i - c * W            # padded column of j = i - (c+1)W
            j = s - W + kk
            rj, qj, fj = cut(rp, s), cut(qp, s), cut(fp, s)
            dr = ri - rj
            dq = qi - qj
            dd = jnp.abs(dr - dq)
            valid = (j >= st[:, None]) & (j < i) & act[:, None]
            if single_seg:
                valid &= (dr != 0) \
                    & ((dq - 1).astype(jnp.uint32) < jnp.uint32(mdy_x)) \
                    & (dd <= bw)
            else:
                same = cut(sp, s) == si
                valid &= (cut(xp, s) == xi) & (dr <= max_dist_x)
                valid &= ~((same & (dr == 0)) | (dq <= 0))
                valid &= ~((same & (dq > max_dist_y)) | (dq > max_dist_x))
                valid &= ~(same & (dd > bw))
                if many_segs and not is_cdna:
                    valid &= ~(same & (dr > max_dist_y))
            sc = jnp.minimum(jnp.minimum(dq, dr), qs)
            ddf = dd.astype(jnp.float32)
            c_lin = (ddf * w1c).astype(jnp.int32)
            for dd_k, cl_k in excs:
                c_lin = jnp.where(dd == dd_k, cl_k, c_lin)
            log_dd = (jax.lax.bitcast_convert_type(
                jnp.maximum(ddf, 1.0), jnp.int32) >> 23) - 127
            pen_same = c_lin + (log_dd >> 1)
            if single_seg:
                sc = sc - pen_same
            else:
                pen_other = jnp.where(dd >= TBL, log_dd,
                                      jnp.minimum(c_lin, log_dd))
                if is_cdna:
                    sc = jnp.where(~same & (dr == 0), sc + 1,
                                   jnp.where((dr > dq) | ~same,
                                             sc - pen_other, sc - pen_same))
                else:
                    sc = jnp.where(same, sc - pen_same,
                                   jnp.where(dr == 0, sc + 1,
                                             sc - pen_other))
            scv = jnp.where(valid, sc + fj, NEG_INF)
            cmax = jnp.max(scv, axis=1)
            ck = W - 1 - jnp.argmax(scv[:, ::-1], axis=1)   # largest j
            before = jnp.sum(valid & (kk > ck[:, None]), axis=1)
            imp = cmax > best
            return (jnp.where(imp, cmax, best),
                    jnp.where(imp, s - W + ck, best_j),
                    jnp.where(imp, tot + before, snap),
                    tot + jnp.sum(valid, axis=1))

        z = jnp.zeros(R, jnp.int32)
        best, best_j, snap, _ = jax.lax.fori_loop(
            0, steps, step, (jnp.full(R, NEG_INF, jnp.int32), z - 1, z, z))
        qs = qs[:, 0]
        have = act & (best > qs)
        f_i = jnp.where(act, jnp.maximum(best, qs), 0)
        p_i = jnp.where(have, best_j, -1)
        fp = jax.lax.dynamic_update_slice_in_dim(fp, f_i[:, None], W + i,
                                                 axis=1)
        p = jax.lax.dynamic_update_slice_in_dim(p, p_i[:, None], i, axis=1)
        return fp, p, flag | (have & (snap > max_skip)).astype(jnp.int32)

    state = (jnp.zeros((R, W + max_n), jnp.int32),
             jnp.full((R, max_n), -1, jnp.int32), jnp.zeros(R, jnp.int32))
    fp, p, flag = jax.lax.fori_loop(0, jnp.max(nn, initial=0), anchor, state)
    return fp[:, W:], p, flag


def split_anchors(anchors: np.ndarray):
    """64-bit (x, y) anchors -> int32 component arrays."""
    x, y = anchors[:, 0], anchors[:, 1]
    xhi = (x >> np.uint64(32)).astype(np.int64).astype(np.int32)
    rpos = (x & np.uint64(0xFFFFFFFF)).astype(np.int64).astype(np.int32)
    qpos = (y & np.uint64(0xFFFFFFFF)).astype(np.int64).astype(np.int32)
    span = ((y >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int32)
    sid = ((y & np.uint64(C.MM_SEED_SEG_MASK)) >> np.uint64(C.MM_SEED_SEG_SHIFT)).astype(np.int32)
    return xhi, rpos, qpos, span, sid


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def chain_dp_device(max_dist_x: int, max_dist_y: int, bw: int, max_skip: int,
                    min_cnt: int, min_sc: int, is_cdna: bool, n_segs: int,
                    anchors: np.ndarray) -> Chains:
    """Drop-in replacement for ops.chain.chain_dp with the score pass on device."""
    n = len(anchors)
    if n == 0:
        return Chains(np.empty((0, 2), dtype=np.uint64), np.empty(0, dtype=np.uint64))
    xhi, rpos, qpos, span, sid = split_anchors(anchors)
    avg_qspan = np.float32(span.sum()) / np.float32(n)  # f32 division, chain.c:47
    tbl = clin_table(float(avg_qspan), max(bw + 1, 1024))
    n_max = round_up(n, 256)
    pad = n_max - n
    pad_i32 = lambda a, fill: np.pad(a, (0, pad), constant_values=fill)
    f, p, v = chain_scores(
        jnp.asarray(pad_i32(xhi, -1)), jnp.asarray(pad_i32(rpos, 0)),
        jnp.asarray(pad_i32(qpos, 0)), jnp.asarray(pad_i32(span, 0)),
        jnp.asarray(pad_i32(sid, 0)), n,
        max_dist_x, max_dist_y, bw, max_skip, jnp.asarray(tbl),
        n_max, bool(is_cdna), n_segs > 1)
    f = np.asarray(f)[:n]
    p = np.asarray(p)[:n]
    v = np.asarray(v)[:n]
    cx, cy, cf, cp = compact_from_fpv(anchors, f, p, v, min_sc)
    return chain_backtrack(cx, cy, cf, cp, min_cnt, min_sc)
