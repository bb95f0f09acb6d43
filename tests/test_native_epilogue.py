"""Native C++ chain epilogue must match the Python golden model exactly."""
import numpy as np
import pytest

from conftest import ref_input
from minimap2_chaindp_tpu import native
from minimap2_chaindp_tpu.options import set_opt
from minimap2_chaindp_tpu.io.fastx import read_fastx
from minimap2_chaindp_tpu.index.build import build_index
from minimap2_chaindp_tpu.ops.seeds import collect_minimizers, collect_seed_hits
from minimap2_chaindp_tpu.ops.chain import chain_dp, chain_backtrack
from minimap2_chaindp_tpu.ops.chain_jax import (chain_scores, clin_table,
                                                compact_from_fpv, round_up,
                                                split_anchors)

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native toolchain unavailable")


def fp_for(anchors, mo):
    import jax.numpy as jnp
    n = len(anchors)
    xhi, rpos, qpos, span, sid = split_anchors(anchors)
    avg = np.float32(span.sum() / n)
    tbl = clin_table(float(avg), max(mo.bw + 1, 1024))
    n_max = round_up(n, 256)
    pad = n_max - n
    pi = lambda x, fl=0: np.pad(x, (0, pad), constant_values=fl)
    f, p, v = chain_scores(jnp.asarray(pi(xhi, -1)), jnp.asarray(pi(rpos)),
                           jnp.asarray(pi(qpos)), jnp.asarray(pi(span)),
                           jnp.asarray(pi(sid)), n, mo.max_gap, mo.max_gap,
                           mo.bw, mo.max_chain_skip, jnp.asarray(tbl),
                           n_max, False, False)
    return np.asarray(f)[:n], np.asarray(p)[:n], np.asarray(v)[:n]


def _check_bottom(anchors, mo):
    f, p, v = fp_for(anchors, mo)
    cx, cy, cf, cp = compact_from_fpv(anchors, f, p, v, mo.min_chain_score)
    py = chain_backtrack(cx, cy, cf, cp, mo.min_cnt, mo.min_chain_score)
    nat = native.chain_bottom_native(anchors, f, p, mo.min_cnt,
                                     mo.min_chain_score)
    assert np.array_equal(py.u, nat.u)
    assert np.array_equal(py.anchors, nat.anchors)


def test_native_matches_python_seeded(seeded):
    """Seeded genome and reads (conftest): native bottom half vs the
    Python compact + backtrack on the same f/p/v."""
    mi, mo = seeded.index(None)
    n = 0
    for q in list(read_fastx(seeded.reads))[:8]:
        mv = collect_minimizers(mo, mi, [q.seq])
        sh = collect_seed_hits(mi, mo.flag, mo.mid_occ, mv, q.name,
                               len(q.seq))
        if len(sh.anchors):
            _check_bottom(sh.anchors, mo)
            n += 1
    assert n >= 6


def test_native_matches_python():
    io, mo = set_opt(None)
    refs = list(read_fastx(ref_input("MT-human.fa")))
    mi = build_index([r.name for r in refs], [r.seq for r in refs],
                     io.w, io.k, io.flag, io.bucket_bits)
    mo.update(mi)
    qs = list(read_fastx(ref_input("MT-orang.fa")))
    qs += list(read_fastx(ref_input("q-inv.fa")))
    mi2 = build_index(["t"], [next(read_fastx(ref_input("t-inv.fa"))).seq],
                      io.w, io.k, io.flag, io.bucket_bits)
    for q, midx in [(qs[0], mi), (qs[1], mi2), (qs[2], mi2)]:
        mv = collect_minimizers(mo, midx, [q.seq])
        sh = collect_seed_hits(midx, mo.flag, mo.mid_occ, mv, q.name, len(q.seq))
        f, p, v = fp_for(sh.anchors, mo)
        # python path
        cx, cy, cf, cp = compact_from_fpv(sh.anchors, f, p, v, mo.min_chain_score)
        py = chain_backtrack(cx, cy, cf, cp, mo.min_cnt, mo.min_chain_score)
        # native path
        nat = native.chain_bottom_native(sh.anchors, f, p, mo.min_cnt,
                                         mo.min_chain_score)
        assert np.array_equal(py.u, nat.u)
        assert np.array_equal(py.anchors, nat.anchors)
