"""Fused device-resident mapping flow: seed collect -> window precompute ->
chaining DP in ONE jitted device step per read bucket.

This is the reference's always-offload design: the fork ships EVERY
read's seed collection + chaining to the accelerator as one task packet
(map.c:423-445, fpga_chaindp.c:83-170) and the host keeps sketching,
backtrack, alignment and text.  Here the anchors stay resident in device
memory between the collect and chain stages — one H2D (padded query
minimizers) and one D2H (f/p + flag, or anchors too) per bucket, instead of
the two extra anchor round trips the staged path pays.

Host-side pre-dispatch statistics make the flow synchronization-free: a
vectorized searchsorted over the HOST copy of the CSR index gives every
read's exact anchor count, span sum (avg_qspan needs C-double slope math for
the gap-cost exactness contract), rep_len and mini_pos WITHOUT expanding
anchors, so bucket routing, overflow fallback and the w1/exc kernel inputs
are all known before dispatch and nothing waits on the device mid-flow.

Per-read fallbacks (the reference's err_flag pattern, map.c:933-944):
anchor-count overflow, gap-cost exception overflow and the kernel's
skip-flag route the read to the exact host path. A device error or a
stall is not a per-read condition: it ends the run with the error.
"""
from __future__ import annotations

import functools

import numpy as np

from .. import constants as C
from ..ops import chain_batch as CB
from ..ops.chain import Chains, chain_backtrack, compact_from_fpv
from ..ops.seeds import SeedHits

# (minimizer-count, anchor-capacity) buckets: pow2 so the compiled-shape
# set stays bounded; a read takes the smallest bucket that fits both counts,
# so padding (bytes moved, candidates scored) stays within 2x.
M_BUCKETS = (256, 1024, 2048, 4096)
CAP_BUCKETS = (512, 1024, 2048, 4096, 8192)
SIGN = np.int32(-0x80000000)
_WARM_SHAPES: set = set()   # shared across DeviceFlow instances (see init)


def host_seed_stats(mi, mv: np.ndarray, max_occ: int):
    """Exact per-read anchor count, anchor span sum, over-occurrence mask,
    and per-minimizer (key position, kept occurrence) arrays from the host
    CSR tables, without expanding anchors (mirrors _collect_dev's masking,
    map.c:119-141). pos/occ feed the mesh dispatcher's per-shard counts."""
    key = mv[:, 0] >> np.uint64(8)
    nk = len(mi.keys)
    if nk == 0:
        z = np.zeros(len(mv), np.int64)
        return 0, 0, np.zeros(len(mv), bool), z, z
    from ..native import key_lookup_batch
    pos = key_lookup_batch(mi.keys, key)   # prefix-directory path (r5):
    if pos is None:                        # genome-scale searchsorted was
        pos = np.searchsorted(mi.keys, key)   # the same key-search wall
    pos_c = np.minimum(pos, nk - 1)
    found = mi.keys[pos_c] == key
    cnt = np.where(found,
                   (mi.starts[pos_c + 1] - mi.starts[pos_c]).astype(np.int64),
                   0)
    over = found & (cnt >= max_occ)
    occ = np.where(found & ~over, cnt, 0)
    span = (mv[:, 0] & np.uint64(0xFF)).astype(np.int64)
    return int(occ.sum()), int((span * occ).sum()), over, pos_c, occ


def derive_queries(qhi, qlo, qspan8, nmv):
    """H2D slimming: qvalid/qseg/qtnd are DERIVED on device instead of
    shipped (valid = slot < count; tandem = neighbor key equality, matching
    the host packer's same-key marking; seg = 0 for the single-segment
    flow), and spans ride as uint8 — HPC spans reach 255
    (sketch.c:111). Traced helper shared by the single-chip flow and the
    sharded mesh step."""
    import jax.numpy as jnp
    Rq, M = qhi.shape
    mslot = jnp.arange(M, dtype=jnp.int32)[None, :]
    qvalid = mslot < nmv
    qspan = qspan8.astype(jnp.int32)
    same_r = qvalid[:, 1:] & (qhi[:, 1:] == qhi[:, :-1]) \
        & (qlo[:, 1:] == qlo[:, :-1])
    z1 = jnp.zeros((Rq, 1), bool)
    qtnd = (jnp.concatenate([same_r, z1], axis=1)
            | jnp.concatenate([z1, same_r], axis=1)).astype(jnp.int32)
    qseg = jnp.zeros((Rq, M), jnp.int32)
    return qvalid, qspan, qtnd, qseg


def derive_queries_pos(qposidx):
    """Tandem marking for the H2D-slim flow: adjacent minimizers share a key
    iff they share a CSR position (both present; -1 marks absent/pad slots,
    which produce no anchors so their own flags are never read)."""
    import jax.numpy as jnp
    Rq, M = qposidx.shape
    same_r = (qposidx[:, 1:] >= 0) & (qposidx[:, 1:] == qposidx[:, :-1])
    z1 = jnp.zeros((Rq, 1), bool)
    qtnd = (jnp.concatenate([same_r, z1], axis=1)
            | jnp.concatenate([z1, same_r], axis=1)).astype(jnp.int32)
    qseg = jnp.zeros((Rq, M), jnp.int32)
    return qtnd, qseg


def flow_tail(xhi, xlo, yhi, ylo, total, nn, w1, exc, *, cap, max_dist_x,
              max_dist_y, bw, max_skip, score_bound, ship_anchors=True):
    """Post-collect device stages (traced helper shared with the mesh
    step): pad masking, fused window starts, the chaining kernel, and the
    D2H dtype slimming.

    ship_anchors=False drops the anchor arrays from the output — the host
    re-derives them from its own CSR copy (the same native collect the
    staged path uses; device order is asserted identical), so the reply
    shrinks to f/p/flag: 4 bytes per anchor instead of 18."""
    import jax.numpy as jnp
    R = xhi.shape[0]
    slot = jnp.arange(cap, dtype=jnp.int32)[None, :]
    live = slot < total[:, None]
    # padding invariants of the chaining pass: rpos = qpos = 0 at pads
    rpos = jnp.where(live, xlo, 0)
    qpos_a = jnp.where(live, ylo, 0)
    span_a = jnp.where(live, yhi & 0xFF, 0)
    # fused window starts on device (pack_reads' stw semantics): first
    # j with key >= max(key_i - max_dist_x, first same-xhi key) on the
    # (biased xhi, rpos) sort order; padded queries land past `total`
    skh = jnp.where(live, xhi ^ SIGN, jnp.int32(0x7FFFFFFF))
    skl = jnp.where(live, xlo, jnp.int32(0x7FFFFFFF))
    # same-x start dominates whenever rpos_i - max_dist_x borrows, so
    # the fused target is simply (skh_i, max(rpos_i - max_dist_x, 0))
    t_lo = jnp.maximum(skl - max_dist_x, 0)
    lo = jnp.zeros((R, cap), jnp.int32)
    hi = jnp.full((R, cap), cap, jnp.int32)
    for _ in range(int(np.ceil(np.log2(cap))) + 1):
        mid = (lo + hi) >> 1
        mh = jnp.take_along_axis(skh, mid, axis=1)
        ml = jnp.take_along_axis(skl, mid, axis=1)
        less = (mh < skh) | ((mh == skh) & (ml < t_lo))
        lo = jnp.where(less, mid + 1, lo)
        hi = jnp.where(less, hi, mid)
    stw = lo
    f, p, flag = CB.chain_scores_batch(
        xhi, rpos, qpos_a, span_a, jnp.zeros_like(rpos), stw, nn, w1, exc,
        max_n=cap, max_dist_x=max_dist_x, max_dist_y=max_dist_y, bw=bw,
        max_skip=max_skip, is_cdna=False, many_segs=False)
    # D2H slimming: f fits 15 bits whenever the caller's score bound
    # does, p < cap <= 32768, and single-seg yhi is span|tandem <= 1279 —
    # ship them as int16; xhi/xlo/ylo keep full width
    narrow = score_bound < 32512 and cap <= 32768
    if narrow:
        f = f.astype(jnp.int16)
        p = p.astype(jnp.int16)
        yhi = yhi.astype(jnp.int16)
    if not ship_anchors:
        return f, p, flag
    return xhi, xlo, yhi, ylo, f, p, flag


@functools.lru_cache(maxsize=None)
def _jit_flow():
    # module-level cache: the jitted step is INDEX-INDEPENDENT (CSR
    # tables ride as call arguments), so every DeviceFlow/runtime in the
    # process shares one jit wrapper and its traced/compiled executables
    import jax
    import jax.numpy as jnp
    from ..ops.seeds_device import _collect_dev_pos

    @functools.partial(
        jax.jit, static_argnames=("cap", "max_dist_x", "max_dist_y", "bw",
                                  "max_skip", "score_bound", "ship_anchors"))
    def flow(starts, vhi, vlo, qposidx, qpos, qspan8,
             max_occ, qls, nn, w1, exc, *, cap, max_dist_x,
             max_dist_y, bw, max_skip, score_bound, ship_anchors):
        qtnd, qseg = derive_queries_pos(qposidx)
        xhi, xlo, yhi, ylo, total, _cnt, _over = _collect_dev_pos(
            starts, vhi, vlo, qposidx, qpos, qspan8.astype(jnp.int32),
            qseg, qtnd, max_occ, qls, cap=cap)
        return flow_tail(
            xhi, xlo, yhi, ylo, total, nn, w1, exc, cap=cap,
            max_dist_x=max_dist_x, max_dist_y=max_dist_y, bw=bw,
            max_skip=max_skip, score_bound=score_bound,
            ship_anchors=ship_anchors)

    return flow


class DeviceFlow:
    """Per-runtime dispatcher for the fused collect+chain device step.

    With `mesh` set (a jax Mesh with "data" and "index" axes), the flow
    runs the sharded multi-chip step instead (device_pipeline.
    make_sharded_flow_step): the CSR index is key-range-sharded across the
    "index" axis — for genomes larger than one chip's HBM — read batches
    are data-parallel, and outputs stay byte-identical to single-chip."""

    def __init__(self, mi, opt, guarded: bool = True, mesh=None,
                 ship_anchors: bool | None = None, cap_floor: int = 0):
        import os
        self.mi = mi
        self.opt = opt
        # guarded: device sections run on the device-owner thread with a
        # stall timeout (utils/device_guard); the CPU backend runs direct
        self.guarded = guarded
        self.mesh = mesh
        # D2H slimming: by default the host re-derives anchors from its own
        # CSR (see flow_tail) and the reply carries only f/p/flag.
        # MM2TPU_FLOW_SHIP_ANCHORS=1 ships them instead. The steal lane
        # passes ship_anchors=True explicitly: its economics are
        # host-CPU-denominated (models/steal.py), and shipping trades
        # ~0.2 ms/read of host re-collection CPU for transfer bytes whose
        # wait overlaps the host lane.
        # The mesh step slims too (r3): its 3-key sort ((biased xhi, rpos,
        # global slot id)) provably rebuilds the host expansion order — the
        # global slot id IS the host expansion index (minimizer-slot-major,
        # CSR-occurrence-minor, over-occurrence keys excluded from the
        # count psum), and keys never split across shards
        # (ops/seeds_device.shard_index_tables cuts at key boundaries), so
        # equal-(x) anchors tie-break identically to the host's stable
        # radix sort by x (map.c:233). Byte-identity of the slim mesh flow
        # is asserted by tests/test_mesh_e2e.py.
        if ship_anchors is None:
            ship_anchors = os.environ.get(
                "MM2TPU_FLOW_SHIP_ANCHORS", "0") == "1"
        self.ship_anchors = ship_anchors
        # steal mode quantizes the compiled-shape space (see runtime
        # _get_flow): capacity buckets floored to `cap_floor` — a cold
        # shape's compile stalls the pipeline behind the chunk that hit it
        self.cap_floor = cap_floor
        # static keys already compiled this process — MODULE-level (r5):
        # the jit wrapper is shared across runtimes (_jit_flow lru_cache),
        # so a shape one runtime compiled is warm for every later one;
        # a per-instance set made each fresh runtime's first chunk look
        # cold, which the steal controller would skip measuring
        self._warm = _WARM_SHAPES
        if mesh is None:
            from ..ops.seeds_device import device_index_cached
            self.dx = device_index_cached(mi, with_keys=False)
            self._flow = _jit_flow()
        else:
            import jax
            from jax.sharding import NamedSharding, PartitionSpec as P
            from ..ops.seeds_device import shard_index_tables
            self.n_index = int(mesh.shape["index"])
            self.n_data = int(mesh.shape["data"])
            (khi, klo, starts, vhi, vlo, _kp, _vp,
             cuts) = shard_index_tables(mi, self.n_index)
            isp = NamedSharding(mesh, P("index"))
            self._tables = tuple(jax.device_put(a, isp)
                                 for a in (khi, klo, starts, vhi, vlo))
            self._cuts = np.asarray(cuts, dtype=np.int64)  # key-pos ranges
            self._steps = {}

    def _mesh_step(self, cap, gq, gr, score_bound):
        key = (cap, gq, gr, score_bound)
        fn = self._steps.get(key)
        if fn is None:
            from .device_pipeline import make_sharded_flow_step
            fn = make_sharded_flow_step(
                self.mesh, cap=cap, max_dist_x=gr, max_dist_y=gq,
                bw=self.opt.bw, max_skip=self.opt.max_chain_skip,
                score_bound=score_bound, ship_anchors=self.ship_anchors)
            self._steps[key] = fn
        return fn

    def mode_ok(self) -> bool:
        """Whole-run eligibility: single-segment genomic chaining with the
        gap-cost table domain (the staged/host paths cover the rest)."""
        o = self.opt
        bad = (C.MM_F_NO_DIAG | C.MM_F_FOR_ONLY | C.MM_F_REV_ONLY
               | C.MM_F_SPLICE)
        return not (o.flag & bad) and o.bw < CB.TBL

    def run(self, units, timers) -> tuple[dict[int, Chains], bool]:
        """Run eligible units through the fused device step.

        `units` is the runtime's list of (segs, UnitInfo); eligible units get
        info.sh filled (anchors from the device, host-computed rep_len /
        mini_pos) and an entry in the returned {unit_index: Chains} dict.
        Ineligible or fallback units are left untouched for the staged path.
        Returns (results, cold): cold is True when this call paid any
        cold-shape compile (the caller's controller must not measure it).
        """
        import jax.numpy as jnp
        from ..utils.device_guard import device_call

        opt, mi = self.opt, self.mi
        results: dict[int, Chains] = {}
        stats: dict[int, tuple] = {}
        by_bucket: dict[tuple, list[int]] = {}
        mesh = self.mesh
        # whether THIS call paid any cold-shape compile (the share
        # controller must not measure compile time as lane throughput —
        # that was retiring healthy lanes at the first flow-on sub-round).
        # A local returned to the caller, NOT an instance attribute: the
        # flow is shared by map_stream's two pipeline threads and an
        # attribute reset at the next run()'s start would race the read.
        run_cold = False
        for k, (segs, info) in enumerate(units):
            if len(info.segs) != 1 or info.mv is None or len(info.mv) == 0:
                continue
            mb = next((m for m in M_BUCKETS if len(info.mv) <= m), None)
            if mb is None:
                timers.count("flow_overflow")   # minimizer overflow
                continue
            n, span_sum, over, pos, occ = host_seed_stats(mi, info.mv,
                                                          opt.mid_occ)
            cb = next((c for c in CAP_BUCKETS
                       if n <= c and self.cap_floor <= c), None)
            stats[k] = (n, span_sum, over, pos, occ)
            if n == 0:
                # assemble the empty SeedHits host-side; no device work
                info.sh = self._seedhits(info.mv, over,
                                         np.empty((0, 2), np.uint64))
                results[k] = Chains(np.empty((0, 2), np.uint64),
                                    np.empty(0, np.uint64))
                continue
            if cb is None:
                timers.count("flow_overflow")
                continue  # anchor overflow -> staged/host path
            if mesh is not None:
                # capacity-bounded routing: every shard's compact hit
                # buffer (cap/n_index slots) must fit this read's actual
                # per-shard hit count — bump the bucket or fall back
                sh_id = np.searchsorted(self._cuts[1:-1], pos,
                                        side="right")
                per_shard = np.bincount(sh_id, weights=occ,
                                        minlength=self.n_index)
                need = int(per_shard.max()) * self.n_index
                cb = next((c for c in CAP_BUCKETS
                           if n <= c and need <= c), None)
                if cb is None:
                    continue  # shard-skewed read -> host path
            avg = np.float32(span_sum) / np.float32(n)
            if avg < 1.6:  # c_log shortcut domain (ops/chain_batch)
                continue
            w1, excl = CB.clin_slope_exc(avg)
            if excl is None:
                continue  # exception overflow -> host path
            # NB: gap_qry varies per qlen_sum under MM_F_SR (map.c:357), so
            # sr reads forced through the flow compile one step per
            # distinct read length. Acceptable: the shipped config routes
            # sr reads to the native fast path (native_chain_max), and the
            # CPU tests that do force sr here compile in ms.
            key = (mb, cb, info.gap_qry, info.gap_ref)
            by_bucket.setdefault(key, []).append((k, w1, excl))

        staged = []
        for (mb, cb, gq, gr), entries in sorted(by_bucket.items()):
            idxs = [k for k, _, _ in entries]
            R = CB.pad_rows(len(idxs),
                            8 if mesh is None else max(8, 8 * self.n_data))
            if self.cap_floor:
                # steal-mode shape quantization: an uneven bucket split
                # (e.g. a 16-read chunk splitting 11/5 across minimizer
                # buckets) must not mint an R=8 shape outside the
                # {16,64} ladder — every new shape is a cold compile
                # stalling the pipeline behind its chunk
                R = max(R, 16)
            max_qlen = max(units[k][1].qlen_sum for k, _, _ in entries)
            # H2D slimming (single-chip): ship each minimizer's CSR key
            # position (int32, -1 = absent/pad) instead of the 8-byte split
            # key — the host computed them in host_seed_stats anyway — and
            # qpos as int16 when every read's positions fit (jit
            # specializes on dtype, so no extra static arg)
            slim = mesh is None
            qposidx = np.full((R, mb), -1, np.int32)
            qhi = None if slim else np.full((R, mb), 0x7FFFFFFF, np.int32)
            qlo = None if slim else np.zeros((R, mb), np.int32)
            qp_dt = np.int16 if slim and 2 * max_qlen + 1 <= 32767 \
                else np.int32
            qpos = np.zeros((R, mb), qp_dt)
            qspan8 = np.zeros((R, mb), np.uint8)  # UNSIGNED: HPC spans reach
            #   255 (sketch.c:111 kmer_span < 256); int8 would wrap >=128
            nmva = np.zeros((R, 1), np.int32)
            qls = np.zeros((R, 1), np.int32)
            nn = np.zeros(R, np.int32)
            w1a = np.zeros(R, np.float32)
            exca = np.full((R, 2 * CB.N_EXC), -1, np.int32)
            from ..ops.seeds_device import split_u64
            for r, (k, w1, excl) in enumerate(entries):
                info = units[k][1]
                mv = info.mv
                nmv = len(mv)
                if slim:
                    _n, _ss, over_k, pos_k, occ_k = stats[k]
                    found_k = (occ_k > 0) | over_k
                    qposidx[r, :nmv] = np.where(found_k, pos_k, -1)
                else:
                    key64 = mv[:, 0] >> np.uint64(8)
                    hi_, lo_ = split_u64(key64)
                    qhi[r, :nmv] = hi_
                    qlo[r, :nmv] = lo_
                qpos[r, :nmv] = (mv[:, 1]
                                 & np.uint64(0xFFFFFFFF)).astype(np.int64)
                qspan8[r, :nmv] = (mv[:, 0]
                                   & np.uint64(0xFF)).astype(np.int64)
                nmva[r, 0] = nmv
                qls[r, 0] = info.qlen_sum
                nn[r] = stats[k][0]
                w1a[r] = w1
                for j, (dd, val) in enumerate(excl):
                    exca[r, 2 * j] = dd
                    exca[r, 2 * j + 1] = val
            # score_bound is a STATIC selector of the int16 D2H slimming
            # — quantize it to two values so compiled shapes stay bounded
            score_bound = 32511 if max_qlen + 512 <= 32511 else (1 << 30)

            def _dispatch(qhi=qhi, qlo=qlo, qposidx=qposidx, qpos=qpos,
                          qspan8=qspan8, nmva=nmva, qls=qls, nn=nn,
                          w1a=w1a, exca=exca, cb=cb, gq=gq, gr=gr,
                          score_bound=score_bound):
                if mesh is not None:
                    fn = self._mesh_step(cb, gq, gr, score_bound)
                    return fn(*self._tables,
                              qhi, qlo, qpos, qspan8, nmva,
                              jnp.int32(opt.mid_occ), qls, nn, w1a, exca)
                dev = self.dx
                return self._flow(
                    dev.starts, dev.vhi, dev.vlo,
                    jnp.asarray(qposidx), jnp.asarray(qpos),
                    jnp.asarray(qspan8),
                    jnp.int32(opt.mid_occ), jnp.asarray(qls),
                    jnp.asarray(nn), jnp.asarray(w1a), jnp.asarray(exca),
                    cap=cb, max_dist_x=gr, max_dist_y=gq, bw=opt.bw,
                    max_skip=opt.max_chain_skip, score_bound=score_bound,
                    ship_anchors=self.ship_anchors)

            # cold static keys get the compile budget (the persistent
            # XLA cache makes every later process hot)
            warm_key = (R, mb, cb, gq, gr, score_bound, qpos.dtype.str)
            if warm_key not in self._warm:
                run_cold = True
            tmo = self._timeout(warm_key in self._warm) if self.guarded \
                else None
            with timers.time("kernel"):
                out = device_call(_dispatch, tmo)
            # the fetch inherits the dispatch budget: on async backends a
            # cold dispatch returns before compile+exec complete, so the
            # compile cost lands on the blocking fetch — and the shape is
            # only marked warm AFTER that fetch succeeds (marking it here
            # would hand a concurrent same-shape dispatch the short warm
            # timeout while the cold compile still occupies the owner
            # thread, spuriously banning the device)
            staged.append((entries, out, tmo, warm_key))

        from ..native import chain_bottom_native
        from ..ops.seeds import collect_seed_hits
        # host-side anchor re-derivation overlaps the device execution of
        # the staged dispatches (nothing below has blocked on the device yet)
        host_sh: dict[int, SeedHits] = {}
        if not self.ship_anchors:
            with timers.time("seed"):
                for entries, _out, _tmo, _wk in staged:
                    for k, _, _ in entries:
                        info = units[k][1]
                        host_sh[k] = collect_seed_hits(
                            mi, opt.flag, opt.mid_occ, info.mv, None,
                            info.qlen_sum)

        def _keep_host_sh(ks):
            # fallback reads still keep the host-derived SeedHits computed
            # above (identical to what runtime._seed_hits would recompute:
            # qname only matters under MM_F_NO_DIAG, which mode_ok
            # excludes) — the host recompute then only redoes chaining
            for k in ks:
                if k in host_sh and units[k][1].sh is None:
                    units[k][1].sh = host_sh[k]

        for entries, out, tmo, warm_key in staged:
            with timers.time("kernel"):
                arrs = device_call(
                    lambda out=out: [np.asarray(v) for v in out], tmo)
            self._warm.add(warm_key)
            if self.ship_anchors:
                xhi, xlo, yhi, ylo, f, p, flag = arrs
            else:
                f, p, flag = arrs
            f = f.astype(np.int32, copy=False)   # undo int16 D2H slimming
            p = p.astype(np.int32, copy=False)
            with timers.time("bottom"):
                if self.ship_anchors:
                    # u64 anchor assembly, one vectorized pass per bucket
                    ax = ((xhi.astype(np.int64) & 0xFFFFFFFF)
                          .astype(np.uint64)
                          << np.uint64(32)) | xlo.astype(np.uint64)
                    ay = ((yhi.astype(np.int64) & 0xFFFFFFFF)
                          .astype(np.uint64)
                          << np.uint64(32)) | ylo.astype(np.uint64)
                for r, (k, _, _) in enumerate(entries):
                    info = units[k][1]
                    n, _span_sum, over = stats[k][:3]
                    if flag[r]:
                        timers.count("fallback")
                        _keep_host_sh([k])
                        continue  # skip-divergence -> exact host recompute
                    if self.ship_anchors:
                        anchors = np.stack([ax[r, :n], ay[r, :n]], axis=1)
                        info.sh = self._seedhits(info.mv, over, anchors)
                    else:
                        sh = host_sh[k]
                        anchors = sh.anchors
                        if len(anchors) != n:  # should be impossible —
                            timers.count("fallback")     # err_flag pattern
                            continue
                        info.sh = sh
                    ch = chain_bottom_native(anchors, f[r, :n], p[r, :n],
                                             opt.min_cnt,
                                             opt.min_chain_score)
                    if ch is None:  # no native lib: exact Python bottom
                        v = _v_from_fp(f[r, :n], p[r, :n])
                        cx, cy, cf, cp = compact_from_fpv(
                            anchors, f[r, :n], p[r, :n], v,
                            opt.min_chain_score)
                        ch = chain_backtrack(cx, cy, cf, cp, opt.min_cnt,
                                             opt.min_chain_score)
                    results[k] = ch
                    timers.count("device_reads")
        return results, run_cold

    def _seedhits(self, mv, over, anchors) -> SeedHits:
        from ..ops.seeds import mini_pos_of
        from ..ops.seeds_device import _rep_len
        return SeedHits(anchors, _rep_len(mv, over), mini_pos_of(mv, ~over))

    def _timeout(self, warm: bool = True):
        from ..utils.device_guard import COMPILE_TIMEOUT_S, DEFAULT_TIMEOUT_S
        return DEFAULT_TIMEOUT_S if warm else max(COMPILE_TIMEOUT_S,
                                                  DEFAULT_TIMEOUT_S)


def _v_from_fp(f: np.ndarray, p: np.ndarray) -> np.ndarray:
    v = np.zeros(len(f), dtype=np.int64)
    for i in range(len(f)):
        pi = p[i]
        v[i] = v[pi] if pi >= 0 and v[pi] > f[i] else f[i]
    return v
