"""Fuzz the epilogue ports against the REAL reference functions: hit.c/pe.c
compiled into .golden/libhit_oracle.so (golden/hit_test.c shim). Covers the
float32 arithmetic chains and the in-place compaction aliasing that pure
e2e byte-diffs only hit on rare inputs."""
import ctypes
import os

import numpy as np
import pytest

from conftest import ref_input

from minimap2_chaindp_tpu.hits import Region, Extra, set_mapq, select_sub
from minimap2_chaindp_tpu.pe import select_sub_multi

ORACLE = "/root/repo/.golden/libhit_oracle.so"
pytestmark = pytest.mark.skipif(not os.path.exists(ORACLE),
                                reason="oracle lib not built")


def _lib():
    lib = ctypes.CDLL(ORACLE)
    vp = ctypes.c_void_p
    lib.hit_oracle_set_mapq.restype = None
    lib.hit_oracle_set_mapq.argtypes = [vp, vp, ctypes.c_int64] \
        + [ctypes.c_int64] * 4 + [vp]
    lib.hit_oracle_select_sub.restype = ctypes.c_int64
    lib.hit_oracle_select_sub.argtypes = [vp, vp, ctypes.c_int64,
                                          ctypes.c_double, ctypes.c_int64,
                                          ctypes.c_int64, vp]
    lib.hit_oracle_select_sub_multi.restype = ctypes.c_int64
    lib.hit_oracle_select_sub_multi.argtypes = [
        vp, vp, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, vp, vp]
    return lib


def _ptr(a):
    return a.__array_interface__["data"][0]


def _mk_regs(rng, n, with_p=True, pe=False, qlens=(150, 150)):
    """Random region set with a consistent parent structure."""
    regs, rows, auxs = [], np.zeros((n, 15), np.int64), \
        np.zeros((n, 4), np.int64)
    n_pri = 0
    for i in range(n):
        primary = i == 0 or (rng.random() < 0.4 and n_pri < 4)
        parent = i if primary else int(rng.integers(0, i))
        # children point at an EARLIER index; redirect to its parent slot's
        # primary like set_parent does
        if not primary:
            parent = regs[parent].parent
        score = int(rng.integers(20, 30000))
        qs = int(rng.integers(0, qlens[0] + qlens[1] - 20)) if pe \
            else int(rng.integers(0, 800))
        qe = qs + int(rng.integers(20, 200))
        rs = int(rng.integers(0, 100000))
        r = Region(id=i, cnt=int(rng.integers(2, 200)),
                   rid=int(rng.integers(0, 3)), score=score,
                   qs=qs, qe=qe, rs=rs, re=rs + int(rng.integers(20, 500)),
                   parent=parent,
                   subsc=int(rng.integers(0, score + 1)),
                   mlen=int(rng.integers(10, 20000)),
                   n_sub=int(rng.integers(0, 40)),
                   score0=score, rev=int(rng.integers(0, 2)))
        r.blen = r.mlen + int(rng.integers(0, 10000))
        if with_p:
            dp_max = int(rng.integers(1, 40000))
            r.p = Extra(dp_max=dp_max,
                        dp_max2=int(rng.integers(0, dp_max + 1)))
        if primary:
            n_pri += 1
        regs.append(r)
        rows[i] = [r.id, r.cnt, r.rid, r.score, r.qs, r.qe, r.rs, r.re,
                   r.parent, r.subsc, r.mlen, r.blen, r.n_sub, r.score0,
                   r.as_]
        auxs[i] = [r.p.dp_max if r.p else 0, r.p.dp_max2 if r.p else 0,
                   1 if r.p else 0, r.rev]
    return regs, rows, auxs


def test_set_mapq_vs_oracle():
    lib = _lib()
    rng = np.random.default_rng(0)
    for it in range(3000):
        n = int(rng.integers(1, 6))
        regs, rows, auxs = _mk_regs(rng, n, with_p=bool(rng.integers(0, 2)))
        min_sc = int(rng.integers(10, 60))
        match_sc = int(rng.integers(1, 4))
        rep_len = int(rng.integers(0, 2000))
        is_sr = bool(rng.integers(0, 2))
        out = np.zeros(n, np.int64)
        lib.hit_oracle_set_mapq(_ptr(rows), _ptr(auxs), n, min_sc,
                                match_sc, rep_len, 1 if is_sr else 0,
                                _ptr(out))
        set_mapq(regs, min_sc, match_sc, rep_len, is_sr)
        got = [r.mapq for r in regs]
        assert got == out.tolist(), (it, got, out.tolist())


def test_select_sub_vs_oracle():
    lib = _lib()
    rng = np.random.default_rng(1)
    for it in range(3000):
        n = int(rng.integers(1, 10))
        regs, rows, auxs = _mk_regs(rng, n)
        pri_ratio = float(rng.choice([0.8, 0.6, 0.15, 0.5]))
        min_diff = int(rng.integers(0, 50))
        best_n = int(rng.integers(1, 6))
        out = np.zeros(n, np.int64)
        k = lib.hit_oracle_select_sub(_ptr(rows), _ptr(auxs), n,
                                      pri_ratio, min_diff, best_n, _ptr(out))
        kept = select_sub(regs, pri_ratio, min_diff, best_n)
        # compare the ORIGINAL ids of survivors (sync_regs renumbers;
        # the oracle shim reports pre-sync ids the same way via r.id...
        # after mm_sync_regs ids are renumbered identically on both sides)
        assert [r.id for r in kept] == out[:k].tolist(), it


def test_select_sub_multi_vs_oracle():
    lib = _lib()
    rng = np.random.default_rng(2)
    qlens = [151, 149]
    for it in range(3000):
        n = int(rng.integers(1, 10))
        regs, rows, auxs = _mk_regs(rng, n, pe=True, qlens=qlens)
        pri_ratio = float(rng.choice([0.8, 0.6, 0.15]))
        pri1, pri2 = 0.2, 0.7
        max_gap_ref = int(rng.integers(100, 5000))
        min_diff = int(rng.integers(0, 50))
        best_n = int(rng.integers(1, 6))
        out = np.zeros(n, np.int64)
        ql64 = np.array(qlens, np.int64)
        k = lib.hit_oracle_select_sub_multi(
            _ptr(rows), _ptr(auxs), n, pri_ratio, pri1, pri2, max_gap_ref,
            min_diff, best_n, 2, _ptr(ql64), _ptr(out))
        kept = select_sub_multi(regs, pri_ratio, pri1, pri2, max_gap_ref,
                                min_diff, best_n, 2, qlens)
        assert [r.id for r in kept] == out[:k].tolist(), it


def test_set_parent_vs_oracle():
    lib = _lib()
    vp = ctypes.c_void_p
    lib.hit_oracle_set_parent.restype = None
    lib.hit_oracle_set_parent.argtypes = [vp, vp, ctypes.c_int64,
                                          ctypes.c_double, ctypes.c_int64,
                                          vp, vp]
    from minimap2_chaindp_tpu.hits import set_parent
    rng = np.random.default_rng(3)
    for it in range(3000):
        n = int(rng.integers(1, 10))
        regs, rows, auxs = _mk_regs(rng, n)
        # set_parent expects score-descending order (gen_regs output)
        regs.sort(key=lambda r: -r.score)
        for i, r in enumerate(regs):
            r.parent = 0
            r.subsc = 0
            rows[i] = [r.id, r.cnt, r.rid, r.score, r.qs, r.qe, r.rs,
                       r.re, 0, 0, r.mlen, r.blen, r.n_sub, r.score0,
                       r.as_]
            auxs[i] = [r.p.dp_max if r.p else 0, r.p.dp_max2 if r.p else 0,
                       1 if r.p else 0, r.rev]
        mask_level = float(rng.choice([0.5, 0.3, 0.9]))
        sub_diff = int(rng.integers(0, 20))
        op = np.zeros(n, np.int64)
        osub = np.zeros(n, np.int64)
        lib.hit_oracle_set_parent(_ptr(rows), _ptr(auxs), n, mask_level,
                                  sub_diff, _ptr(op), _ptr(osub))
        set_parent(regs, mask_level, sub_diff)
        assert [r.parent for r in regs] == op.tolist(), it
        assert [r.subsc for r in regs] == osub.tolist(), it


def test_pair_vs_oracle():
    lib = _lib()
    vp = ctypes.c_void_p
    lib.hit_oracle_pair.restype = None
    lib.hit_oracle_pair.argtypes = [vp, vp, ctypes.c_int64,
                                    vp, vp, ctypes.c_int64] \
        + [ctypes.c_int64] * 4 + [vp, vp, vp, vp, vp]
    from minimap2_chaindp_tpu.pe import pair
    rng = np.random.default_rng(4)
    qlens = [151, 149]
    for it in range(2000):
        sides = []
        for s in range(2):
            n = int(rng.integers(1, 5))
            regs, rows, _ = _mk_regs(rng, n)
            auxs6 = np.zeros((n, 6), np.int64)
            for i, r in enumerate(regs):
                r.hash = int(rng.integers(0, 1 << 32))
                r.mapq = int(rng.integers(0, 61))
                r.rev = int(rng.integers(0, 2))
                # keep coordinates tight so FR pairs actually form
                r.rid = int(rng.integers(0, 2))
                r.rs = int(rng.integers(0, 3000))
                r.re = r.rs + int(rng.integers(50, 400))
                rows[i] = [r.id, r.cnt, r.rid, r.score, r.qs, r.qe,
                           r.rs, r.re, r.parent, r.subsc, r.mlen, r.blen,
                           r.n_sub, r.score0, r.as_]
                auxs6[i] = [r.p.dp_max, r.p.dp_max2, 1, r.rev, r.hash,
                            r.mapq]
            sides.append((regs, rows, auxs6))
        (regs0, rows0, a0), (regs1, rows1, a1) = sides
        max_gap_ref = int(rng.integers(200, 2000))
        pe_bonus = int(rng.integers(0, 50))
        sub_diff = int(rng.integers(0, 20))
        match_sc = int(rng.integers(1, 4))
        n0, n1 = len(regs0), len(regs1)
        om0, of0 = np.zeros(n0, np.int64), np.zeros(n0, np.int64)
        om1, of1 = np.zeros(n1, np.int64), np.zeros(n1, np.int64)
        ql64 = np.array(qlens, np.int64)
        lib.hit_oracle_pair(_ptr(rows0), _ptr(a0), n0, _ptr(rows1),
                            _ptr(a1), n1, max_gap_ref, pe_bonus, sub_diff,
                            match_sc, _ptr(ql64), _ptr(om0), _ptr(of0),
                            _ptr(om1), _ptr(of1))
        pair(max_gap_ref, pe_bonus, sub_diff, match_sc, qlens,
             [regs0, regs1])
        assert [r.mapq for r in regs0] == om0.tolist(), it
        assert [r.proper_frag for r in regs0] == of0.tolist(), it
        assert [r.mapq for r in regs1] == om1.tolist(), it
        assert [r.proper_frag for r in regs1] == of1.tolist(), it


def _mk_chains(rng, n_chains, qlen=2000):
    """Synthetic sorted anchors grouped into chains + the u array."""
    anchors, u = [], []
    rpos = int(rng.integers(100, 1000))
    for _ in range(n_chains):
        cnt = int(rng.integers(1, 12))
        score = int(rng.integers(30, 2000))
        rev = int(rng.integers(0, 2))
        rid = int(rng.integers(0, 3))
        qpos = int(rng.integers(14, qlen - 20))
        for _ in range(cnt):
            span = int(rng.integers(10, 20))
            x = (rev << 63) | (rid << 32) | rpos
            y = (span << 32) | qpos
            anchors.append((x, y))
            rpos += int(rng.integers(5, 60))
            qpos = min(qpos + int(rng.integers(5, 60)), qlen - 1)
        u.append((score << 32) | cnt)
        rpos += int(rng.integers(100, 400))
    a = np.array(anchors, dtype=np.uint64)
    return np.array(u, dtype=np.uint64), a


def test_gen_regs_vs_oracle():
    lib = _lib()
    vp = ctypes.c_void_p
    lib.hit_oracle_gen_regs.restype = ctypes.c_int64
    lib.hit_oracle_gen_regs.argtypes = [ctypes.c_uint64, ctypes.c_int64,
                                        ctypes.c_int64, vp, vp,
                                        ctypes.c_int64, vp]
    from minimap2_chaindp_tpu.hits import gen_regs
    rng = np.random.default_rng(5)
    for it in range(1500):
        n_chains = int(rng.integers(1, 8))
        qlen = 2000
        u, a = _mk_chains(rng, n_chains, qlen)
        hash_ = int(rng.integers(0, 1 << 32))
        out = np.zeros((len(u), 10), np.int64)
        k = lib.hit_oracle_gen_regs(hash_, qlen, len(u), _ptr(u), _ptr(a),
                                    len(a), _ptr(out))
        regs = gen_regs(hash_, qlen, u, a)
        assert len(regs) == k
        got = [[r.score, r.cnt, r.as_, r.rid, r.rev, r.qs, r.qe, r.rs,
                r.re, r.hash] for r in regs]
        assert got == out[:k].tolist(), it


def test_join_long_vs_oracle():
    lib = _lib()
    vp = ctypes.c_void_p
    lib.hit_oracle_join_long.restype = ctypes.c_int64
    lib.hit_oracle_join_long.argtypes = [vp, vp, ctypes.c_int64, vp,
                                         ctypes.c_int64] \
        + [ctypes.c_int64] * 7 + [ctypes.c_double, vp]
    from minimap2_chaindp_tpu.hits import gen_regs, set_parent, join_long

    class Opt:
        pass

    rng = np.random.default_rng(6)
    n_join = 0
    for it in range(1500):
        qlen = 5000
        if it % 2:
            # join-friendly shape: same rid/strand colinear chains with
            # moderate gaps so the join conditions actually fire
            anchors, u = [], []
            rpos = int(rng.integers(100, 500))
            qpos = int(rng.integers(14, 400))
            for _ in range(int(rng.integers(2, 5))):
                cnt = int(rng.integers(2, 8))
                score = int(rng.integers(200, 2000))
                for _ in range(cnt):
                    span = int(rng.integers(10, 20))
                    anchors.append(((0 << 63) | rpos, (span << 32) | qpos))
                    rpos += int(rng.integers(20, 120))
                    qpos = min(qpos + int(rng.integers(20, 120)), qlen - 1)
                u.append((score << 32) | cnt)
                gap = int(rng.integers(50, 2500))
                rpos += gap
                qpos = min(qpos + gap + int(rng.integers(-40, 40)), qlen - 1)
            u = np.array(u, dtype=np.uint64)
            a = np.array(anchors, dtype=np.uint64)
        else:
            u, a = _mk_chains(rng, int(rng.integers(2, 6)), qlen)
        hash_ = int(rng.integers(0, 1 << 32))
        regs = gen_regs(hash_, qlen, u, a.copy())
        set_parent(regs, 0.5, 6)
        opt = Opt()
        opt.max_join_long = int(rng.integers(500, 30000))
        opt.max_join_short = int(rng.integers(100, 3000))
        opt.min_join_flank_sc = int(rng.integers(10, 1500))
        opt.min_cnt = int(rng.integers(1, 3))
        opt.min_chain_score = int(rng.integers(10, 40))
        opt.min_dp_max = int(rng.integers(10, 60))
        opt.max_clip_ratio = 1.0
        rows = np.zeros((len(regs), 15), np.int64)
        auxs = np.zeros((len(regs), 4), np.int64)
        for i, r in enumerate(regs):
            rows[i] = [r.id, r.cnt, r.rid, r.score, r.qs, r.qe, r.rs, r.re,
                       r.parent, r.subsc, r.mlen, r.blen, r.n_sub, r.score0,
                       r.as_]
            auxs[i] = [0, 0, 0, r.rev]
        out = np.zeros((len(regs), 6), np.int64)
        k = lib.hit_oracle_join_long(
            _ptr(rows), _ptr(auxs), len(regs), _ptr(a.copy()), len(a), qlen,
            opt.max_join_long, opt.max_join_short, opt.min_join_flank_sc,
            opt.min_cnt, opt.min_chain_score, opt.min_dp_max,
            opt.max_clip_ratio, _ptr(out))
        kept = join_long(regs, opt, qlen, a)
        got = [[r.id, r.score, r.cnt, r.parent, r.qs, r.qe] for r in kept]
        if len(got) != len(regs):
            n_join += 1
        assert len(got) == k, it
        assert got == out[:k].tolist(), it
    assert n_join > 20, f"joins rarely fired ({n_join}) - weak fuzz"


def _native_lib():
    from minimap2_chaindp_tpu.native import load_ksw
    lib = load_ksw()
    if lib is None:
        return None
    vp = ctypes.c_void_p
    lib.mm2tpu_test_set_mapq.restype = None
    lib.mm2tpu_test_set_mapq.argtypes = [vp, vp, ctypes.c_int64] \
        + [ctypes.c_int64] * 4 + [vp]
    lib.mm2tpu_test_select_sub.restype = ctypes.c_int64
    lib.mm2tpu_test_select_sub.argtypes = [vp, vp, ctypes.c_int64,
                                           ctypes.c_double, ctypes.c_int64,
                                           ctypes.c_int64, vp]
    lib.mm2tpu_test_select_sub_multi.restype = ctypes.c_int64
    lib.mm2tpu_test_select_sub_multi.argtypes = [
        vp, vp, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, vp, vp]
    return lib


def test_native_epilogue_vs_oracle():
    """Three-way: the NATIVE C ports (align_driver.cc) against the real
    reference functions on the same fuzz inputs."""
    nat = _native_lib()
    if nat is None:
        pytest.skip("native lib unavailable")
    lib = _lib()
    lib.hit_oracle_set_parent.restype = None
    vp = ctypes.c_void_p
    rng = np.random.default_rng(7)
    for it in range(2500):
        n = int(rng.integers(1, 10))
        regs, rows, auxs = _mk_regs(rng, n)
        # set_mapq
        min_sc = int(rng.integers(10, 60))
        match_sc = int(rng.integers(1, 4))
        rep_len = int(rng.integers(0, 2000))
        is_sr = int(rng.integers(0, 2))
        want = np.zeros(n, np.int64)
        got = np.zeros(n, np.int64)
        lib.hit_oracle_set_mapq(_ptr(rows), _ptr(auxs), n, min_sc,
                                match_sc, rep_len, is_sr, _ptr(want))
        nat.mm2tpu_test_set_mapq(_ptr(rows), _ptr(auxs), n, min_sc,
                                 match_sc, rep_len, is_sr, _ptr(got))
        assert got.tolist() == want.tolist(), ("mapq", it)
        # select_sub
        pri_ratio = float(rng.choice([0.8, 0.6, 0.15, 0.5]))
        min_diff = int(rng.integers(0, 50))
        best_n = int(rng.integers(1, 6))
        w2 = np.zeros(n, np.int64)
        g2 = np.zeros(n, np.int64)
        kw = lib.hit_oracle_select_sub(_ptr(rows), _ptr(auxs), n, pri_ratio,
                                       min_diff, best_n, _ptr(w2))
        kg = nat.mm2tpu_test_select_sub(_ptr(rows), _ptr(auxs), n,
                                        pri_ratio, min_diff, best_n,
                                        _ptr(g2))
        assert g2[:kg].tolist() == w2[:kw].tolist(), ("sub", it)
        # select_sub_multi
        ql64 = np.array([151, 149], np.int64)
        w3 = np.zeros(n, np.int64)
        g3 = np.zeros(n, np.int64)
        mgr = int(rng.integers(100, 5000))
        kw3 = lib.hit_oracle_select_sub_multi(
            _ptr(rows), _ptr(auxs), n, pri_ratio, 0.2, 0.7, mgr, min_diff,
            best_n, 2, _ptr(ql64), _ptr(w3))
        kg3 = nat.mm2tpu_test_select_sub_multi(
            _ptr(rows), _ptr(auxs), n, pri_ratio, 0.2, 0.7, mgr, min_diff,
            best_n, 2, _ptr(ql64), _ptr(g3))
        assert g3[:kg3].tolist() == w3[:kw3].tolist(), ("multi", it)


def test_est_err_vs_oracle():
    """div estimates on REAL pipeline data (simulated reads through
    seed/chain/regions) bit-equal to the reference mm_est_err."""
    import struct
    import sys
    sys.path.insert(0, os.path.dirname(__file__))
    lib = _lib()
    vp = ctypes.c_void_p
    lib.hit_oracle_est_err.restype = None
    lib.hit_oracle_est_err.argtypes = [vp, vp, ctypes.c_int64, vp,
                                       ctypes.c_int64, vp, ctypes.c_int64,
                                       vp, ctypes.c_int64, ctypes.c_int64,
                                       vp]
    from test_mapeval_accuracy import simulate
    from minimap2_chaindp_tpu.io.fastx import read_fastx, SeqRecord
    from minimap2_chaindp_tpu.options import set_opt
    from minimap2_chaindp_tpu import constants as C
    from minimap2_chaindp_tpu.index.build import build_index
    from minimap2_chaindp_tpu.models.pipeline import (chain_post, host_chain,
                                                      seed_unit)
    from minimap2_chaindp_tpu.hits import gen_regs
    from minimap2_chaindp_tpu.esterr import est_err

    refs = list(read_fastx(ref_input("MT-human.fa")))
    io_, mo = set_opt("map-ont")
    mi = build_index([r.name for r in refs], [r.seq for r in refs],
                     io_.w, io_.k, io_.flag, io_.bucket_bits)
    mo.update(mi)
    reads = simulate(refs[0].seq, 150, 1200, 0.12, seed=9)
    rid_lens = np.array([s.length for s in mi.seqs], np.int64)
    n_cmp = 0
    for name, seq in reads:
        info = seed_unit(mi, mo, [SeqRecord(name, seq, None)])
        if info.sh is None or not len(info.sh.anchors):
            continue
        ch = host_chain(mo, info, 1)
        if ch is None or not len(ch.u):
            continue
        a = ch.anchors.copy()
        regs = gen_regs(info.hash_, info.qlen_sum, ch.u, a)
        regs = chain_post(mo, info.gap_ref, mi, info.qlen_sum, 1,
                          info.qlens, regs, a)
        if not regs:
            continue
        mini_pos = np.ascontiguousarray(info.sh.mini_pos, np.uint64)
        rows = np.zeros((len(regs), 15), np.int64)
        auxs = np.zeros((len(regs), 4), np.int64)
        for i, r in enumerate(regs):
            rows[i] = [r.id, r.cnt, r.rid, r.score, r.qs, r.qe, r.rs, r.re,
                       r.parent, r.subsc, r.mlen, r.blen, r.n_sub,
                       r.score0, r.as_]
            auxs[i] = [0, 0, 0, r.rev]
        out = np.zeros(len(regs), np.int64)
        lib.hit_oracle_est_err(_ptr(rows), _ptr(auxs), len(regs),
                               _ptr(np.ascontiguousarray(a)), len(a),
                               _ptr(mini_pos), len(mini_pos),
                               _ptr(rid_lens), len(rid_lens),
                               info.qlen_sum, _ptr(out))
        est_err(mi, info.qlen_sum, regs, a, info.sh.mini_pos)
        for i, r in enumerate(regs):
            want = struct.unpack("<f", struct.pack("<I", out[i]
                                                   & 0xFFFFFFFF))[0]
            got = np.float32(r.div)
            assert (np.isnan(want) and np.isnan(got)) or got == np.float32(
                want), (name, i, got, want)
            n_cmp += 1
    assert n_cmp > 100


def test_sketch_vs_oracle():
    """The sketcher (native fast path + Python golden) against the real
    mm_sketch across random sequences, k/w/HPC combos, and N runs."""
    lib = _lib()
    vp = ctypes.c_void_p
    lib.hit_oracle_sketch.restype = ctypes.c_int64
    lib.hit_oracle_sketch.argtypes = [ctypes.c_char_p] \
        + [ctypes.c_int64] * 5 + [vp, ctypes.c_int64]
    from minimap2_chaindp_tpu.index.sketch import sketch
    rng = np.random.default_rng(8)
    bases = np.array(list("ACGTN"))
    for it in range(400):
        L = int(rng.integers(20, 800))
        probs = [0.24, 0.24, 0.24, 0.24, 0.04] if it % 3 else \
            [0.45, 0.45, 0.04, 0.03, 0.03]  # low-complexity mode
        seq = "".join(rng.choice(bases, L, p=probs))
        k = int(rng.integers(4, 29))
        w = int(rng.integers(1, 32))
        is_hpc = int(rng.integers(0, 2))
        rid = int(rng.integers(0, 1 << 20))
        cap = 8 * L + 64
        out = np.zeros(cap, np.uint64)
        nw = lib.hit_oracle_sketch(seq.encode(), L, w, k, rid, is_hpc,
                                   _ptr(out), cap)
        want = out[:2 * nw].reshape(-1, 2)
        got = sketch(seq, w, k, rid, bool(is_hpc))
        assert np.array_equal(got, want), (it, k, w, is_hpc, L)
