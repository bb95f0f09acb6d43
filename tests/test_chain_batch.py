"""The batched chaining pass (ops/chain_batch.py): the plain jnp/lax version
against the exact host model (ops/chain.py) in all three variants, the
(f, p, flag) contract, the implementation chooser, the wrapper's padding
and shapes, and the compile-cache placement. The CUDA kernel's parity
tests are marked `gpu` and run on the card (chip_smoke.py phase 2)."""
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest

from minimap2_chaindp_tpu.ops import chain_batch as CB
from minimap2_chaindp_tpu.ops.chain import chain_fpv
from minimap2_chaindp_tpu.ops.chain_jax import split_anchors
from minimap2_chaindp_tpu.options import set_opt
from minimap2_chaindp_tpu.utils.synth import synth_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_SKIP = 1 << 30


def synth_anchors(rng, n, seg_split=None, big_gaps=False):
    rp = np.sort(rng.integers(0, 60000 if big_gaps else 3000, n))
    qp = np.maximum(rp // (30 if big_gaps else 1)
                    + rng.integers(-200, 200, n), 0)
    span = rng.integers(13, 20, n)
    y = span.astype(np.uint64) << np.uint64(32) | qp.astype(np.uint64)
    if seg_split is not None:
        seg = (np.arange(n) >= seg_split).astype(np.uint64)
        y |= seg << np.uint64(48)
    anchors = np.stack([rp.astype(np.uint64), y], axis=1)
    return anchors[np.argsort(anchors[:, 0], kind="stable")]


def pack(batch, max_dist_x, max_n=None):
    reads = []
    for a in batch:
        xhi, rpos, qpos, span, sid = split_anchors(a)
        reads.append(dict(xhi=xhi, rpos=rpos, qpos=qpos, span=span, sid=sid,
                          avg_qspan=np.float32(span.sum())
                          / np.float32(max(len(a), 1))))
    if max_n is None:
        max_n = (max(len(a) for a in batch) + 127) // 128 * 128
    return CB.pack_reads(reads, max_n, max_dist_x), max_n


def run_plain(batch, gq, gr, bw, max_skip, is_cdna=False, many_segs=False):
    (packed, nn, w1, exc, host_flag), max_n = pack(batch, gr)
    assert not host_flag.any()
    f, p, flag = CB.chain_scores_batch(
        *(packed[k] for k in ("xhi", "rpos", "qpos", "span", "sid", "stw")),
        nn, w1, exc, max_n=max_n, max_dist_x=gr, max_dist_y=gq, bw=bw,
        max_skip=max_skip, is_cdna=is_cdna, many_segs=many_segs)
    return np.asarray(f), np.asarray(p), np.asarray(flag)


def check_contract(batch, gq, gr, bw, max_skip, is_cdna=False, n_segs=1):
    """Unflagged reads: f/p bit-equal to the reference scan WITH its
    max_skip break; flagged reads: a superset of the reads where that
    break changes f/p. Returns the number of flagged reads."""
    f, p, flag = run_plain(batch, gq, gr, bw, max_skip, is_cdna, n_segs > 1)
    for r, a in enumerate(batch):
        n = len(a)
        rf, rp, _ = chain_fpv(gr, gq, bw, max_skip, is_cdna, n_segs, a)
        ff, fp, _ = chain_fpv(gr, gq, bw, NO_SKIP, is_cdna, n_segs, a)
        if (rf, rp) != (ff, fp):
            assert flag[r], f"read {r}: the break changed f/p, not flagged"
        if not flag[r]:
            assert list(f[r, :n]) == rf, f"read {r} f"
            assert list(p[r, :n]) == rp, f"read {r} p"
        # padding slots: f = 0, p = -1
        assert not f[r, n:].any() and (p[r, n:] == -1).all()
    return int(flag.sum())


@pytest.mark.parametrize("seed", [1, 2])
def test_plain_chain_single_seg(seed):
    rng = np.random.default_rng(seed)
    _, mo = set_opt(None)
    batch = [synth_anchors(rng, int(rng.integers(20, 300)))
             for _ in range(6)]
    check_contract(batch, mo.max_gap, mo.max_gap, mo.bw, mo.max_chain_skip)


def test_plain_chain_cdna():
    """is_cdna (splice) scoring rules: large ref gaps, max_dist_y < TBL."""
    rng = np.random.default_rng(3)
    _, mo = set_opt("splice")
    batch = [synth_anchors(rng, int(rng.integers(30, 250)), big_gaps=True)
             for _ in range(6)]
    check_contract(batch, 2000, 200000, mo.bw, mo.max_chain_skip,
                   is_cdna=True)


def test_plain_chain_many_segs():
    """many_segs (paired-end) rule: same-seg dr > max_dist_y invalid."""
    rng = np.random.default_rng(4)
    _, mo = set_opt("sr")
    batch = []
    for _ in range(6):
        n = int(rng.integers(30, 200))
        batch.append(synth_anchors(rng, n, seg_split=n // 2))
    check_contract(batch, 600, 800, mo.bw, mo.max_chain_skip, n_segs=2)


def test_plain_chain_flags_superset():
    """A tiny max_skip makes the reference's break bite: those reads must
    all be flagged, and every unflagged read still matches exactly."""
    batch = synth_batch(8, 400, seed=5)
    n_flagged = check_contract(batch, 5000, 5000, 500, 1)
    assert n_flagged > 0


def test_plain_chain_seeded_reads(seeded):
    """Anchors of simulated reads against the seeded genome (real seed
    structure: repeats, both strands, several contigs)."""
    from minimap2_chaindp_tpu.io.fastx import read_fastx
    from minimap2_chaindp_tpu.ops.seeds import (collect_minimizers,
                                                collect_seed_hits)
    mi, mo = seeded.index(None)
    batch = []
    for q in list(read_fastx(seeded.reads))[:12]:
        mv = collect_minimizers(mo, mi, [q.seq])
        sh = collect_seed_hits(mi, mo.flag, mo.mid_occ, mv, q.name,
                               len(q.seq))
        if len(sh.anchors):
            batch.append(sh.anchors)
    assert len(batch) >= 8
    check_contract(batch, mo.max_gap, mo.max_gap, mo.bw, mo.max_chain_skip)


def test_chain_impl_choice():
    """cpu -> the plain version, gpu -> the CUDA kernel, anything else ->
    an error; no implementation takes an interpret flag."""
    from minimap2_chaindp_tpu.ops.chain_cuda import chain_scores_cuda
    from minimap2_chaindp_tpu.ops.chain_jax import chain_scores_batch_xla
    assert CB.chain_impl("cpu") is chain_scores_batch_xla
    assert CB.chain_impl("gpu") is chain_scores_cuda
    for plat in ("rocm", "METAL", ""):
        with pytest.raises(ValueError):
            CB.chain_impl(plat)
    for fn in (CB.chain_scores_batch, chain_scores_cuda):
        assert "interpret" not in inspect.signature(fn).parameters
    assert "interpret" not in inspect.signature(
        chain_scores_batch_xla).parameters


def test_chain_scores_batch_rejects_out_of_domain():
    """Gap-cost domains beyond the exact table and predecessor indices
    beyond 16 bits are refused (those reads take the host path)."""
    (packed, nn, w1, exc, _), max_n = pack(
        [synth_anchors(np.random.default_rng(0), 50)], 500)
    args = [packed[k] for k in ("xhi", "rpos", "qpos", "span", "sid", "stw")]
    kw = dict(max_dist_x=500, max_dist_y=500, max_skip=25, many_segs=False)
    with pytest.raises(ValueError):
        CB.chain_scores_batch(*args, nn, w1, exc, max_n=max_n, bw=CB.TBL,
                              is_cdna=False, **kw)
    with pytest.raises(ValueError):
        CB.chain_scores_batch(*args, nn, w1, exc, max_n=max_n, bw=100,
                              is_cdna=True, **{**kw, "max_dist_y": CB.TBL})
    with pytest.raises(ValueError):
        CB.chain_scores_batch(*args, nn, w1, exc, max_n=(1 << 16) + 128,
                              bw=100, is_cdna=False, **kw)


def test_pack_reads_padding_and_shapes():
    """Rows pad to a power of two (floor 8); per-read side arrays are
    (R,) and (R, 2 * N_EXC); padded rows come back as f = 0, p = -1,
    flag = 0; stw is the reference's sliding window start (chain.c:58)."""
    assert [CB.pad_rows(n) for n in (0, 1, 8, 9, 17, 64)] == \
        [8, 8, 8, 16, 32, 64]
    rng = np.random.default_rng(7)
    batch = [synth_anchors(rng, n) for n in (40, 130, 7, 90, 60)]
    (packed, nn, w1, exc, host_flag), max_n = pack(batch, 500)
    assert max_n == 256
    assert packed["rpos"].shape == (8, 256)
    assert nn.shape == (8,) and list(nn[:5]) == [40, 130, 7, 90, 60]
    assert w1.shape == (8,) and exc.shape == (8, 2 * CB.N_EXC)
    assert host_flag.shape == (8,) and not host_flag.any()
    for r, a in enumerate(batch):
        x = [int(v) for v in a[:, 0]]
        st = 0
        for i in range(len(a)):
            while st < i and x[i] - x[st] > 500:
                st += 1
            assert packed["stw"][r, i] == st
    f, p, flag = run_plain(batch, 500, 500, 500, 25)
    assert f.shape == (8, 256) and p.shape == (8, 256) and flag.shape == (8,)
    assert not f[5:].any() and (p[5:] == -1).all() and not flag[5:].any()


def test_flow_buckets_are_kernel_shapes():
    """The fused flow's capacity buckets fit the CUDA kernel's per-warp
    shared-memory row (int32 f[] of max_n entries within 48 KB) and the
    predecessor packing (max_n <= 65536), and split evenly over any
    power-of-two index axis of the mesh."""
    from minimap2_chaindp_tpu.models.device_flow import CAP_BUCKETS
    for cap in CAP_BUCKETS:
        assert cap * 4 <= 48 * 1024 and cap <= 1 << 16
        assert cap & (cap - 1) == 0


def _cache_dir_in_child(env_extra):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_extra)
    code = ("from minimap2_chaindp_tpu.utils.compile_cache import "
            "enable_persistent_cache\nenable_persistent_cache()\n"
            "import jax\nprint(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_default_inside_checkout():
    from minimap2_chaindp_tpu.utils.compile_cache import CACHE_DIR
    assert CACHE_DIR == os.path.join(ROOT, "build", "xla_cache")
    assert _cache_dir_in_child({}) == CACHE_DIR


def test_compile_cache_honours_env(tmp_path):
    d = str(tmp_path / "jcc")
    assert _cache_dir_in_child({"JAX_COMPILATION_CACHE_DIR": d}) == d


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["single", "many_segs", "cdna"])
def test_cuda_kernel_matches_plain(gpu_backend, variant):
    """On the card: the CUDA kernel's f, p and flag equal the plain
    version's bit for bit (chip_smoke.py phase 2 runs the full sweep)."""
    from minimap2_chaindp_tpu.ops.chain_jax import chain_scores_batch_xla
    rng = np.random.default_rng(11)
    if variant == "single":
        batch, gq, gr, cdna, many = synth_batch(64, 1000, seed=2), 5000, \
            5000, False, False
    elif variant == "many_segs":
        batch = []
        for _ in range(64):
            n = int(rng.integers(30, 400))
            batch.append(synth_anchors(rng, n, seg_split=n // 2))
        gq, gr, cdna, many = 600, 800, False, True
    else:
        batch = [synth_anchors(rng, int(rng.integers(30, 400)),
                               big_gaps=True) for _ in range(64)]
        gq, gr, cdna, many = 2000, 200000, True, False
    (packed, nn, w1, exc, _), max_n = pack(batch, gr)
    args = [packed[k] for k in ("xhi", "rpos", "qpos", "span", "sid", "stw")]
    kw = dict(max_n=max_n, max_dist_x=gr, max_dist_y=gq, bw=500,
              max_skip=25, is_cdna=cdna, many_segs=many)
    got = CB.chain_scores_batch(*args, nn, w1, exc, **kw)
    want = chain_scores_batch_xla(*args, nn, w1, exc, **kw)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))
