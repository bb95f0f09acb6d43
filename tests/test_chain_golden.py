"""End-to-end validation of sketch → index → seed-collect → chain → gen_regs
against chain dumps captured from the reference binary (--print-seeds CN lines,
reference map.c:864-868)."""
import os

import numpy as np
import pytest

from conftest import GOLDEN_DIR, ref_input
from minimap2_chaindp_tpu import constants as C
from minimap2_chaindp_tpu.options import IndexOptions, MapOptions, set_opt
from minimap2_chaindp_tpu.io.fastx import read_fastx
from minimap2_chaindp_tpu.index.build import build_index
from minimap2_chaindp_tpu.ops.seeds import collect_minimizers, collect_seed_hits
from minimap2_chaindp_tpu.ops.chain import chain_dp
from minimap2_chaindp_tpu.hits import gen_regs


def run_to_chains(ref_fa, query_fa, qname_filter=None):
    io, mo = set_opt(None)
    refs = list(read_fastx(ref_fa))
    mi = build_index([r.name for r in refs], [r.seq for r in refs],
                     io.w, io.k, io.flag, io.bucket_bits)
    mo.update(mi)
    out = {}
    for q in read_fastx(query_fa):
        if qname_filter and q.name != qname_filter:
            continue
        mv = collect_minimizers(mo, mi, [q.seq])
        hits = collect_seed_hits(mi, mo.flag, mo.mid_occ, mv, q.name, len(q.seq))
        gap_qry = mo.max_gap
        gap_ref = mo.max_gap  # max_gap_ref<0 and max_frag_len=0 (map.c:357-366)
        ch = chain_dp(gap_ref, gap_qry, mo.bw, mo.max_chain_skip, mo.min_cnt,
                      mo.min_chain_score, False, 1, hits.anchors)
        hash_ = C.qname_hash(q.name, len(q.seq), mo.seed)
        regs = gen_regs(hash_, len(q.seq), ch.u, ch.anchors)
        out[q.name] = (mi, regs, ch.anchors)
    return out


def cn_lines(mi, regs, a):
    lines = []
    for j, r in enumerate(regs):
        for i in range(r.as_, r.as_ + r.cnt):
            rid = int((a[i, 0] << np.uint64(1)) >> np.uint64(33))
            rpos = int(np.int32(np.uint32(a[i, 0])))
            strand = "+-"[int(a[i, 0] >> np.uint64(63))]
            qpos = int(np.int32(np.uint32(a[i, 1])))
            span = int((a[i, 1] >> np.uint64(32)) & np.uint64(0xFF))
            if i == r.as_:
                gap = 0
            else:
                gap = (qpos - int(np.int32(np.uint32(a[i - 1, 1])))) - \
                      (rpos - int(np.int32(np.uint32(a[i - 1, 0]))))
            lines.append(f"CN\t{j}\t{mi.seqs[rid].name}\t{rpos}\t{strand}\t{qpos}\t{span}\t{gap}")
    return lines


def check_against(golden_file, ref_fa, query_fa, qname=None):
    with open(os.path.join(GOLDEN_DIR, golden_file)) as f:
        golden = [l.rstrip("\n") for l in f if l.startswith("CN")]
    out = run_to_chains(ref_input(ref_fa),
                        ref_input(query_fa), qname)
    mine = []
    for name in out:
        mi, regs, a = out[name]
        mine.extend(cn_lines(mi, regs, a))
    assert mine == golden


def test_mt_chains():
    check_against("mt.chains.txt", "MT-human.fa", "MT-orang.fa")


def test_inv_read1_chains():
    check_against("inv.read1.chains.txt", "t-inv.fa", "q-inv.fa", "read1")


def test_inv_read2_chains():
    check_against("inv.read2.chains.txt", "t-inv.fa", "q-inv.fa", "read2")
