"""Device seed collection must be bit-identical to the host golden model
(anchors, order, flags, rep_len, mini_pos)."""
import numpy as np

from conftest import ref_input
from minimap2_chaindp_tpu.options import set_opt
from minimap2_chaindp_tpu.io.fastx import read_fastx
from minimap2_chaindp_tpu.index.build import build_index
from minimap2_chaindp_tpu.ops.seeds import collect_minimizers, collect_seed_hits
from minimap2_chaindp_tpu.ops.seeds_device import DeviceSeedCollector


def check_pair(ref_path, q_path, preset=None):
    io, mo = set_opt(preset)
    refs = list(read_fastx(ref_path))
    mi = build_index([r.name for r in refs], [r.seq for r in refs],
                     io.w, io.k, io.flag, io.bucket_bits)
    mo.update(mi)
    queries = list(read_fastx(q_path))
    mvs, qlens = [], []
    for q in queries:
        mvs.append(collect_minimizers(mo, mi, [q.seq]))
        qlens.append(len(q.seq))
    dc = DeviceSeedCollector(mi)
    got = dc.collect_batch(mvs, mo.mid_occ, qlens)
    n_dev = 0
    for q, mv, g, ql in zip(queries, mvs, got, qlens):
        want = collect_seed_hits(mi, mo.flag, mo.mid_occ, mv, q.name, ql)
        if g is None:
            continue
        n_dev += 1
        assert np.array_equal(g.anchors, want.anchors), q.name
        assert g.rep_len == want.rep_len
        assert np.array_equal(g.mini_pos, want.mini_pos)
    assert n_dev > 0


def test_seeds_device_mt(seeded):
    check_pair(seeded.ref, seeded.reads)


def test_seeds_device_inv():
    check_pair(ref_input("t-inv.fa"), ref_input("q-inv.fa"))


def test_seeds_device_hpc(seeded):
    check_pair(seeded.ref, seeded.reads, preset="map-pb")


def test_seeds_device_self_map(seeded):
    # the reads against themselves: lots of exact multi-occurrence hits
    check_pair(seeded.reads, seeded.reads)


def test_seeds_sharded_index_collect(seeded):
    """Sharded-index seed collection (ops/seeds_device.shard_index_tables +
    models/device_pipeline.make_sharded_collect_step) on a 2x4 virtual mesh
    is bit-identical to the single-chip device collector: every key lives on
    one index shard and the padded anchor slots combine by psum."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from minimap2_chaindp_tpu.ops.seeds_device import (
        _collect_dev, DeviceIndex, shard_index_tables, split_u64)
    from minimap2_chaindp_tpu.models.device_pipeline import \
        make_sharded_collect_step

    mi, mo = seeded.index(None)
    R, M, CAP = 8, 4096, 8192
    queries = list(read_fastx(seeded.reads))[:R]
    mvs = [collect_minimizers(mo, mi, [q.seq]) for q in queries]

    qhi = np.full((R, M), 0x7FFFFFFF, np.int32)
    qlo = np.zeros((R, M), np.int32)
    qvalid = np.zeros((R, M), bool)
    qpos = np.zeros((R, M), np.int32)
    qspan = np.zeros((R, M), np.int32)
    qseg = np.zeros((R, M), np.int32)
    qtnd = np.zeros((R, M), np.int32)
    qls = np.zeros((R, 1), np.int32)
    for r, (q, mv) in enumerate(zip(queries, mvs)):
        n = len(mv)
        key = mv[:, 0] >> np.uint64(8)
        hi, lo = split_u64(key)
        qhi[r, :n], qlo[r, :n], qvalid[r, :n] = hi, lo, True
        qpos[r, :n] = (mv[:, 1] & np.uint64(0xFFFFFFFF)).astype(np.int64)
        qspan[r, :n] = (mv[:, 0] & np.uint64(0xFF)).astype(np.int64)
        if n > 1:
            same = key[1:] == key[:-1]
            qtnd[r, :n - 1] |= same
            qtnd[r, 1:n] |= same
        qls[r, 0] = len(q.seq)

    dx = DeviceIndex(mi)
    want = [np.asarray(v) for v in _collect_dev(
        dx.khi, dx.klo, dx.starts, dx.vhi, dx.vlo,
        jnp.asarray(qhi), jnp.asarray(qlo), jnp.asarray(qvalid),
        jnp.asarray(qpos), jnp.asarray(qspan), jnp.asarray(qseg),
        jnp.asarray(qtnd), jnp.int32(mo.mid_occ), jnp.asarray(qls),
        cap=CAP)]

    n_index = 4
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                ("data", "index"))
    khi, klo, starts, vhi, vlo, kp, vp, _cuts = shard_index_tables(mi, n_index)
    step = make_sharded_collect_step(mesh, cap=CAP)
    got = [np.asarray(v) for v in step(
        jnp.asarray(khi), jnp.asarray(klo), jnp.asarray(starts),
        jnp.asarray(vhi), jnp.asarray(vlo),
        jnp.asarray(qhi), jnp.asarray(qlo), jnp.asarray(qvalid),
        jnp.asarray(qpos), jnp.asarray(qspan), jnp.asarray(qseg),
        jnp.asarray(qtnd), jnp.int32(mo.mid_occ), jnp.asarray(qls))]
    # padding slots beyond each read's total hold unconsumed garbage on the
    # single-chip path (clamped gathers) and zeros on the sharded path —
    # compare the live region plus the full total/cnt/over arrays
    total = want[4]
    assert np.array_equal(total, got[4]), "total"
    for nm, w, g in zip(["cnt", "over"], want[5:], got[5:]):
        assert np.array_equal(w, g), nm
    for nm, w, g in zip(["xhi", "xlo", "yhi", "ylo"], want[:4], got[:4]):
        for r in range(len(total)):
            t = int(total[r])
            assert np.array_equal(w[r, :t], g[r, :t]), (nm, r)
    assert int(total[0]) > 0  # real anchors flowed through


def test_shard_index_volume_balancing():
    """Shard cuts balance value volume: a hot key range doesn't multiply
    the padded per-shard value table (Vp ~ V/n + one key's list)."""
    from minimap2_chaindp_tpu.index.build import MinimizerIndex
    from minimap2_chaindp_tpu.ops.seeds_device import shard_index_tables
    rng = np.random.default_rng(0)
    mi = MinimizerIndex(k=15, w=10, flag=0)
    K = 4000
    mi.keys = np.sort(rng.choice(1 << 40, K, replace=False).astype(np.uint64))
    cnt = np.ones(K, np.int64)
    cnt[100:200] = 50  # hot key range
    mi.starts = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int64)
    mi.values = np.arange(mi.starts[-1], dtype=np.uint64)
    *_, Vp, _cuts = shard_index_tables(mi, 4)
    V = int(mi.starts[-1])
    assert Vp <= V // 4 + int(cnt.max()) + 64
