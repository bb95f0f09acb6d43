"""Affine-gap extension DP — exact host golden model of the ksw2 kernels.

Implements the anti-diagonal ("rotated") difference DP of the reference's
ksw2_extd2_sse.c bit-exactly in NumPy int8 arithmetic, including:
  * the Suzuki-Kasahara difference recurrence on (u, v, x, y, x2, y2)
    (ksw2_extd2_sse.c:30-58), with int8 wrap-around semantics
  * 16-lane alignment of the computed band and the resulting stale-lane
    behavior (ksw2_extd2_sse.c:139, 158-181) — required for bit-identity
  * band boundary conditions incl. the long_thres/long_diff first-column
    seeding (ksw2_extd2_sse.c:94-97, 141-155)
  * left/right gap alignment backtrack-byte conventions (:220-314)
  * exact max via the int32 H row with the reference's lane-of-4 tie-breaking
    (:315-358), and the approximate-max greedy path (:359-375)
  * Z-drop (ksw2.h:160-176) and CIGAR backtrack (ksw2.h:119-151)

Also ksw_ll_i16, the striped local SW used by inversion rescue
(ksw2_ll_sse.c:80-147), with its exact end-position tie-breaking.

This is the golden model the native SIMD batch (native/ksw2_extd2.cc) is
validated against, and the host path for odd-shaped problems.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

KSW_NEG_INF = -0x40000000

KSW_EZ_SCORE_ONLY = 0x01
KSW_EZ_RIGHT = 0x02
KSW_EZ_GENERIC_SC = 0x04
KSW_EZ_APPROX_MAX = 0x08
KSW_EZ_APPROX_DROP = 0x10
KSW_EZ_EXTZ_ONLY = 0x40
KSW_EZ_REV_CIGAR = 0x80
KSW_EZ_SPLICE_FOR = 0x100
KSW_EZ_SPLICE_REV = 0x200
KSW_EZ_SPLICE_FLANK = 0x400


@dataclass
class Ez:
    """Mirror of ksw_extz_t (reference ksw2.h:23-32)."""
    max: int = 0
    zdropped: int = 0
    max_q: int = -1
    max_t: int = -1
    mqe: int = KSW_NEG_INF
    mqe_t: int = -1
    mte: int = KSW_NEG_INF
    mte_q: int = -1
    score: int = KSW_NEG_INF
    reach_end: int = 0
    cigar: list[int] = field(default_factory=list)

    @property
    def n_cigar(self) -> int:
        return len(self.cigar)


def gen_simple_mat(m: int, a: int, b: int) -> np.ndarray:
    """Match/mismatch matrix with wildcard last row/col (reference align.c:9-21)."""
    a, b = abs(a), -abs(b)
    mat = np.zeros((m, m), dtype=np.int8)
    for i in range(m - 1):
        for j in range(m - 1):
            mat[i, j] = a if i == j else b
        mat[i, m - 1] = 0
    mat[m - 1, :] = 0
    return mat.reshape(-1)


def _push_cigar(cigar: list[int], op: int, length: int) -> None:
    if not cigar or op != (cigar[-1] & 0xF):
        cigar.append(length << 4 | op)
    else:
        cigar[-1] += length << 4


def _backtrack_rot(p: np.ndarray, off: list[int], off_end: list[int], n_col: int,
                   i0: int, j0: int, is_rev: bool, min_intron_len: int = 0) -> list[int]:
    """Rotated backtrack (reference ksw_backtrack, ksw2.h:119-151)."""
    cigar: list[int] = []
    i, j, state = i0, j0, 0
    while i >= 0 and j >= 0:
        r = i + j
        force_state = -1
        if i < off[r]:
            force_state = 2
        if off_end is not None and i > off_end[r]:
            force_state = 1
        tmp = int(p[r * n_col + i - off[r]]) if force_state < 0 else 0
        if state == 0:
            state = tmp & 7
        elif not (tmp >> (state + 2) & 1):
            state = 0
        if state == 0:
            state = tmp & 7
        if force_state >= 0:
            state = force_state
        if state == 0:
            _push_cigar(cigar, 0, 1)
            i -= 1
            j -= 1
        elif state == 1 or (state == 3 and min_intron_len <= 0):
            _push_cigar(cigar, 2, 1)
            i -= 1
        elif state == 3 and min_intron_len > 0:
            _push_cigar(cigar, 3, 1)
            i -= 1
        else:
            _push_cigar(cigar, 1, 1)
            j -= 1
    if i >= 0:
        _push_cigar(cigar, 3 if (min_intron_len > 0 and i >= min_intron_len) else 2, i + 1)
    if j >= 0:
        _push_cigar(cigar, 1, j + 1)
    if not is_rev:
        cigar.reverse()
    return cigar


def _apply_zdrop(ez: Ez, H: int, r: int, t: int, zdrop: int, e: int) -> bool:
    """reference ksw_apply_zdrop (ksw2.h:160-176), rotated form."""
    if H > ez.max:
        ez.max, ez.max_t, ez.max_q = H, t, r - t
    elif t >= ez.max_t and r - t >= ez.max_q:
        tl, ql = t - ez.max_t, (r - t) - ez.max_q
        l = abs(tl - ql)
        if zdrop >= 0 and ez.max - H > zdrop + l * e:
            ez.zdropped = 1
            return True
    return False


def extd2(qseq: np.ndarray, tseq: np.ndarray, mat: np.ndarray, q: int, e: int,
          q2: int, e2: int, w: int, zdrop: int, end_bonus: int, flag: int,
          m: int = 5) -> Ez:
    """Dual affine-gap extension (reference ksw_extd2_sse, bit-exact emulation)."""
    ez = Ez()
    qlen, tlen = len(qseq), len(tseq)
    if m <= 1 or qlen <= 0 or tlen <= 0:
        return ez
    if q2 + e2 < q + e:
        q, q2 = q2, q
        e, e2 = e2, e
    with_cigar = not (flag & KSW_EZ_SCORE_ONLY)
    approx_max = bool(flag & KSW_EZ_APPROX_MAX)
    mat0 = int(mat[0])
    sc_mch, sc_mis, sc_N = np.int8(mat[0]), np.int8(mat[1]), np.int8(-e2)

    if w < 0:
        w = max(tlen, qlen)
    wl = wr = w
    tlen16 = (tlen + 15) // 16 * 16
    n_col = min(qlen, tlen)
    n_col = ((min(n_col, w + 1) + 15) // 16 + 1) * 16  # bytes per p row
    max_sc, min_sc = int(mat.max()), int(mat.min())
    if -min_sc > 2 * (q + e):
        return ez

    if e != e2:
        long_thres = (q2 - q) // (e - e2) - 1
    else:
        long_thres = 0
    if q2 + e2 + long_thres * e2 > q + e + long_thres * e:
        long_thres += 1
    long_diff = long_thres * (e - e2) - (q2 - q) - e2

    i8 = np.int8
    u = np.full(tlen16, -q - e, dtype=i8)
    v = np.full(tlen16, -q - e, dtype=i8)
    x = np.full(tlen16, -q - e, dtype=i8)
    y = np.full(tlen16, -q - e, dtype=i8)
    x2 = np.full(tlen16, -q2 - e2, dtype=i8)
    y2 = np.full(tlen16, -q2 - e2, dtype=i8)
    s = np.zeros(tlen16 + 16, dtype=i8)  # scores; stale across rows (kcalloc)
    H = np.full(tlen16, KSW_NEG_INF, dtype=np.int64) if not approx_max else None
    H0 = 0
    last_H0_t = 0
    # padded sequences for unaligned 16-byte block loads
    sf = np.zeros(tlen16 + 16, dtype=np.uint8)
    sf[:tlen] = tseq
    qr = np.zeros(qlen + 16 * 2 + tlen16, dtype=np.uint8)  # qr[t]=query[qlen-1-t], 0-padded
    qr[:qlen] = qseq[::-1]

    if with_cigar:
        p = np.zeros((qlen + tlen - 1) * n_col, dtype=np.uint8)
        off = [0] * (qlen + tlen - 1)
        off_end = [0] * (qlen + tlen - 1)
    else:
        p, off, off_end = None, None, None

    right = bool(flag & KSW_EZ_RIGHT)
    generic_sc = bool(flag & KSW_EZ_GENERIC_SC)
    matq = mat.reshape(m, m)

    last_st = last_en = -1
    qe_, qe2_ = np.int8(q + e), np.int8(q2 + e2)
    q_, q2_ = np.int8(q), np.int8(q2)

    for r in range(qlen + tlen - 1):
        st, en = 0, tlen - 1
        if st < r - qlen + 1:
            st = r - qlen + 1
        if en > r:
            en = r
        if st < (r - wr + 1) >> 1:
            st = (r - wr + 1) >> 1
        if en > (r + wl) >> 1:
            en = (r + wl) >> 1
        if st > en:
            ez.zdropped = 1
            break
        st0, en0 = st, en
        st = st // 16 * 16
        en = (en + 16) // 16 * 16 - 1
        # boundary conditions
        if st > 0:
            if last_st <= st - 1 <= last_en:
                x1, x21, v1 = int(x[st - 1]), int(x2[st - 1]), int(v[st - 1])
            else:
                x1, x21, v1 = -q - e, -q2 - e2, -q - e
        else:
            x1, x21 = -q - e, -q2 - e2
            v1 = (-q - e if r == 0 else
                  -e if r < long_thres else
                  long_diff if r == long_thres else -e2)
        if en >= r:
            y[r] = -q - e
            y2[r] = -q2 - e2
            u[r] = (-q - e if r == 0 else
                    -e if r < long_thres else
                    long_diff if r == long_thres else -e2)
        # scores, written in 16-wide blocks from st0 (stale outside!)
        qrr_base = qlen - 1 - r
        if not generic_sc:
            for t0 in range(st0, en0 + 1, 16):
                sq = sf[t0:t0 + 16]
                stq = qr[qrr_base + t0:qrr_base + t0 + 16]
                mask = (sq == m - 1) | (stq == m - 1)
                blk = np.where(sq == stq, sc_mch, sc_mis)
                s[t0:t0 + 16] = np.where(mask, sc_N, blk)
        else:
            for t in range(st0, en0 + 1):
                s[t] = matq[sf[t], qr[qrr_base + t]]
        # core anti-diagonal update over aligned [st, en]
        sl = slice(st, en + 1)
        z = s[sl].copy()
        ut = u[sl].copy()
        vt = v[sl].copy()
        xt1 = np.empty(en - st + 1, dtype=i8)
        xt1[0] = x1
        xt1[1:] = x[st:en]
        x2t1 = np.empty(en - st + 1, dtype=i8)
        x2t1[0] = x21
        x2t1[1:] = x2[st:en]
        vt1 = np.empty(en - st + 1, dtype=i8)
        vt1[0] = v1
        vt1[1:] = v[st:en]
        a = xt1 + vt1
        b = y[sl] + ut
        a2 = x2t1 + vt1
        b2 = y2[sl] + ut
        if with_cigar:
            if not right:  # left-align gaps: later states win only if strictly greater
                d = np.where(a > z, np.uint8(1), np.uint8(0))
                z = np.maximum(z, a)
                d = np.where(b > z, np.uint8(2), d)
                z = np.maximum(z, b)
                d = np.where(a2 > z, np.uint8(3), d)
                z = np.maximum(z, a2)
                d = np.where(b2 > z, np.uint8(4), d)
                z = np.maximum(z, b2)
            else:  # right-align: ties go to the later state
                d = np.where(z > a, np.uint8(0), np.uint8(1))
                z = np.maximum(z, a)
                d = np.where(z > b, d, np.uint8(2))
                z = np.maximum(z, b)
                d = np.where(z > a2, d, np.uint8(3))
                z = np.maximum(z, a2)
                d = np.where(z > b2, d, np.uint8(4))
                z = np.maximum(z, b2)
            z = np.minimum(z, np.int8(mat0))
        else:
            z = np.maximum(z, a)
            z = np.maximum(z, b)
            z = np.maximum(z, a2)
            z = np.maximum(z, b2)
            z = np.minimum(z, np.int8(mat0))
            d = None
        u[sl] = z - vt1
        v[sl] = z - ut
        tmp = z - q_
        a = a - tmp
        b = b - tmp
        tmp2 = z - q2_
        a2 = a2 - tmp2
        b2 = b2 - tmp2
        if with_cigar:
            if not right:
                x[sl] = np.where(a > 0, a, np.int8(0)) - qe_
                d |= np.where(a > 0, np.uint8(0x08), np.uint8(0))
                y[sl] = np.where(b > 0, b, np.int8(0)) - qe_
                d |= np.where(b > 0, np.uint8(0x10), np.uint8(0))
                x2[sl] = np.where(a2 > 0, a2, np.int8(0)) - qe2_
                d |= np.where(a2 > 0, np.uint8(0x20), np.uint8(0))
                y2[sl] = np.where(b2 > 0, b2, np.int8(0)) - qe2_
                d |= np.where(b2 > 0, np.uint8(0x40), np.uint8(0))
            else:
                x[sl] = np.where(a >= 0, a, np.int8(0)) - qe_
                d |= np.where(a >= 0, np.uint8(0x08), np.uint8(0))
                y[sl] = np.where(b >= 0, b, np.int8(0)) - qe_
                d |= np.where(b >= 0, np.uint8(0x10), np.uint8(0))
                x2[sl] = np.where(a2 >= 0, a2, np.int8(0)) - qe2_
                d |= np.where(a2 >= 0, np.uint8(0x20), np.uint8(0))
                y2[sl] = np.where(b2 >= 0, b2, np.int8(0)) - qe2_
                d |= np.where(b2 >= 0, np.uint8(0x40), np.uint8(0))
            p[r * n_col:r * n_col + en - st + 1] = d
            off[r], off_end[r] = st, en
        else:
            x[sl] = np.where(a > 0, a, np.int8(0)) - qe_
            y[sl] = np.where(b > 0, b, np.int8(0)) - qe_
            x2[sl] = np.where(a2 > 0, a2, np.int8(0)) - qe2_
            y2[sl] = np.where(b2 > 0, b2, np.int8(0)) - qe2_

        if not approx_max:
            if r > 0:
                if en0 > 0:
                    H[en0] = H[en0 - 1] + int(u[en0])
                else:
                    H[en0] = H[en0] + int(v[en0])
                max_H, max_t = int(H[en0]), en0
                en1 = st0 + (en0 - st0) // 4 * 4
                if en1 > st0:
                    Hblk = H[st0:en1] + v[st0:en1].astype(np.int64)
                    H[st0:en1] = Hblk
                    Hblk = Hblk.reshape(-1, 4)
                    for lane in range(4):
                        col = Hblk[:, lane]
                        cmax = int(col.max())
                        if cmax > max_H:
                            max_H = cmax
                            max_t = st0 + 4 * int(np.argmax(col)) + lane
                for t in range(en1, en0):
                    H[t] += int(v[t])
                    if H[t] > max_H:
                        max_H, max_t = int(H[t]), t
            else:
                H[0] = int(v[0]) - (q + e)
                max_H, max_t = int(H[0]), 0
            if en0 == tlen - 1 and H[en0] > ez.mte:
                ez.mte, ez.mte_q = int(H[en0]), r - en
            if r - st0 == qlen - 1 and H[st0] > ez.mqe:
                ez.mqe, ez.mqe_t = int(H[st0]), st0
            if _apply_zdrop(ez, max_H, r, max_t, zdrop, e2):
                break
            if r == qlen + tlen - 2 and en0 == tlen - 1:
                ez.score = int(H[tlen - 1])
        else:
            if r > 0:
                if st0 <= last_H0_t <= en0 and st0 <= last_H0_t + 1 <= en0:
                    d0 = int(v[last_H0_t])
                    d1 = int(u[last_H0_t + 1])
                    if d0 > d1:
                        H0 += d0
                    else:
                        H0 += d1
                        last_H0_t += 1
                elif st0 <= last_H0_t <= en0:
                    H0 += int(v[last_H0_t])
                else:
                    last_H0_t += 1
                    H0 += int(u[last_H0_t])
            else:
                H0 = int(v[0]) - (q + e)
                last_H0_t = 0
            if (flag & KSW_EZ_APPROX_DROP) and _apply_zdrop(ez, H0, r, last_H0_t, zdrop, e2):
                break
            if r == qlen + tlen - 2 and en0 == tlen - 1:
                ez.score = H0
        last_st, last_en = st, en

    if with_cigar:
        rev_cigar = bool(flag & KSW_EZ_REV_CIGAR)
        if not ez.zdropped and not (flag & KSW_EZ_EXTZ_ONLY):
            ez.cigar = _backtrack_rot(p, off, off_end, n_col, tlen - 1, qlen - 1, rev_cigar)
        elif not ez.zdropped and (flag & KSW_EZ_EXTZ_ONLY) and ez.mqe + end_bonus > ez.max:
            ez.reach_end = 1
            ez.cigar = _backtrack_rot(p, off, off_end, n_col, ez.mqe_t, qlen - 1, rev_cigar)
        elif ez.max_t >= 0 and ez.max_q >= 0:
            ez.cigar = _backtrack_rot(p, off, off_end, n_col, ez.max_t, ez.max_q, rev_cigar)
    return ez


def ksw_ll(qseq: np.ndarray, tseq: np.ndarray, mat: np.ndarray, gapo: int,
           gape: int, m: int = 5) -> tuple[int, int, int]:
    """Striped local SW score + end coords (reference ksw_ll_i16, ksw2_ll_sse.c:80-147).

    Returns (score, qe, te) with the reference's exact end-position tie rules:
    te = LAST target row achieving the max; qe = position whose striped-layout
    index is LAST among cells equal to the max in that row.
    """
    qlen, tlen = len(qseq), len(tseq)
    if qlen == 0 or tlen == 0:
        return 0, -1, -1
    slen = (qlen + 7) // 8
    qlen8 = slen * 8  # striped layout includes score-0 phantom positions
    gapoe = gapo + gape
    matq = mat.reshape(m, m).astype(np.int64)
    prof = np.zeros((m, qlen8), dtype=np.int64)
    prof[:, :qlen] = matq[:, qseq]
    Hprev = np.zeros(qlen8, dtype=np.int64)
    E = np.zeros(qlen8, dtype=np.int64)
    gmax, te = 0, -1
    Hmax = Hprev.copy()
    jj = np.arange(qlen8, dtype=np.int64)
    for i in range(tlen):
        sc = prof[tseq[i]]
        diag = np.concatenate([[0], Hprev[:-1]]) + sc
        h0 = np.maximum(diag, E)
        # exact F: opening only from h0 (gapoe >= gape makes F-from-F dominated)
        tvals = h0 - gapoe + jj * gape
        fmax = np.maximum.accumulate(tvals)
        F = np.empty(qlen8, dtype=np.int64)
        F[0] = 0
        F[1:] = fmax[:-1] - (jj[1:] - 1) * gape
        np.maximum(F, 0, out=F)
        h = np.maximum(h0, F)
        np.maximum(h, 0, out=h)
        E = np.maximum(E - gape, h - gapoe)
        np.maximum(E, 0, out=E)
        imax = int(h.max())
        if imax >= gmax:
            gmax, te = imax, i
            Hmax = h
        Hprev = h
    # qe: the cell whose striped-layout scan index is LAST among cells == gmax
    eq = np.nonzero(Hmax == gmax)[0]
    if len(eq) == 0:
        return gmax, -1, te
    stripe_i = (eq % slen) * 8 + eq // slen
    qe = int(eq[np.argmax(stripe_i)])
    return gmax, qe, te


def decode_cigar(ops, n_ops, fin_i, fin_j, is_rev, min_intron_len=0):
    """Run-length encode backtrack step codes (0 = M, 1 = D, 2/4 = I,
    3 = N with splice or D without) into a CIGAR, with the tail and
    reverse conventions of ksw_backtrack (ksw2.h:137-150); vectorized —
    walks are thousands of steps per job."""
    if n_ops:
        from ..native import decode_cigar_native
        res = decode_cigar_native(ops, n_ops, fin_i, fin_j, is_rev,
                                  min_intron_len)
        if res is not None:
            return res
    cigar: list[int] = []
    if n_ops:
        st = ops[:n_ops].astype(np.int64)
        # ksw2.h:137-143 state machine: 0 -> M; 1 (and 3 without splice)
        # -> D; 3 with splice -> N; everything ELSE (2 = insertion, 4 =
        # second-affine long-gap insertion) -> I. State 4 only occurs in
        # dual-affine extd2 (splice has no second gap profile).
        op = np.where(st == 0, 0,
                      np.where((st == 2) | (st == 4), 1,
                               np.where(st == 1, 2,
                                        3 if min_intron_len > 0 else 2)))
        cut = np.nonzero(np.diff(op))[0] + 1
        starts = np.concatenate([[0], cut])
        ends = np.concatenate([cut, [n_ops]])
        cigar = list(((ends - starts) << 4 | op[starts]).astype(np.int64))
        cigar = [int(v) for v in cigar]
    if fin_i >= 0:
        _push_cigar(cigar, 3 if (min_intron_len > 0
                                 and fin_i >= min_intron_len) else 2,
                    fin_i + 1)
    if fin_j >= 0:
        _push_cigar(cigar, 1, fin_j + 1)
    if not is_rev:
        cigar.reverse()
    return cigar
