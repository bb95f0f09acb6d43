"""Validate the device (JAX) chaining formulation against the exact host model."""
import numpy as np
import pytest

from conftest import ref_input
from minimap2_chaindp_tpu.options import set_opt
from minimap2_chaindp_tpu.io.fastx import read_fastx
from minimap2_chaindp_tpu.index.build import build_index
from minimap2_chaindp_tpu.ops.seeds import collect_minimizers, collect_seed_hits
from minimap2_chaindp_tpu.ops.chain import chain_dp
from minimap2_chaindp_tpu.ops.chain_jax import chain_dp_device


def anchors_for(ref_fa, query_fa, preset=None):
    io, mo = set_opt(preset)
    refs = list(read_fastx(ref_input(ref_fa)))
    mi = build_index([r.name for r in refs], [r.seq for r in refs],
                     io.w, io.k, io.flag, io.bucket_bits)
    mo.update(mi)
    out = []
    for q in read_fastx(ref_input(query_fa)):
        mv = collect_minimizers(mo, mi, [q.seq])
        sh = collect_seed_hits(mi, mo.flag, mo.mid_occ, mv, q.name, len(q.seq))
        out.append((sh.anchors, mo))
    return out


def check_equal(anchors, mo, is_cdna=False, n_segs=1):
    args = (mo.max_gap, mo.max_gap, mo.bw, mo.max_chain_skip,
            mo.min_cnt, mo.min_chain_score, is_cdna, n_segs, anchors)
    host = chain_dp(*args)
    dev = chain_dp_device(*args)
    assert np.array_equal(host.u, dev.u)
    assert np.array_equal(host.anchors, dev.anchors)


def test_chain_jax_mt():
    for anchors, mo in anchors_for("MT-human.fa", "MT-orang.fa"):
        check_equal(anchors, mo)


def test_chain_jax_inv():
    for anchors, mo in anchors_for("t-inv.fa", "q-inv.fa"):
        check_equal(anchors, mo)


def test_chain_jax_seeded(seeded):
    """Seeded genome and reads (conftest): per-read JAX scan vs the host
    golden model."""
    mi, mo = seeded.index(None)
    n = 0
    for q in list(read_fastx(seeded.reads))[:6]:
        mv = collect_minimizers(mo, mi, [q.seq])
        sh = collect_seed_hits(mi, mo.flag, mo.mid_occ, mv, q.name,
                               len(q.seq))
        if len(sh.anchors):
            check_equal(sh.anchors, mo)
            n += 1
    assert n >= 4


def test_chain_jax_random():
    # synthetic anchors with heavy ties/tandem structure to stress the
    # max_skip stamp automaton
    rng = np.random.default_rng(0)
    _, mo = set_opt(None)
    for trial in range(6):
        n = int(rng.integers(50, 800))
        rp = np.sort(rng.integers(0, 4000, n))
        qp = np.maximum(rp + rng.integers(-300, 300, n), 0)
        span = rng.integers(13, 20, n)
        x = rp.astype(np.uint64)  # single rid, fwd strand
        y = span.astype(np.uint64) << np.uint64(32) | qp.astype(np.uint64)
        anchors = np.stack([x, y], axis=1)
        order = np.argsort(anchors[:, 0], kind="stable")
        anchors = anchors[order]
        check_equal(anchors, mo)
