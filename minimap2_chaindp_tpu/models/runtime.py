"""Device runtime: batched GPU mapping with host epilogue.

The analog of the reference's asynchronous FPGA offload runtime
(map.c worker_pipeline / fpga_chaindp.c queues): fragments are collected into
padded anchor batches bucketed by size, the Pallas chaining kernel scores a
whole batch in one device call, flagged reads (skip-heuristic divergence or
gap-cost exceptions overflow) are recomputed exactly on the host — the
reference's own err_flag fallback pattern (map.c:933-944) — and the per-read
epilogue (backtrack, regions, alignment, output) runs on the host.

Output is bit-identical to the host pipeline (asserted by tests)."""
from __future__ import annotations

import numpy as np

from .. import constants as C
from ..ops.chain import Chains, chain_backtrack, compact_from_fpv
from ..ops.chain_jax import split_anchors
from ..utils.timers import Timers

BUCKETS = (256, 512, 1024, 2048, 4096, 8192)

# in-process link-probe cache: {"mbps": float, "t": epoch}. The persisted
# twin (with the learned share and retirement verdicts) lives in
# utils/link_state.py.
_PROBE_MEM: dict = {}


class _ChunkView:
    """Per-fragment view into a chunked host-lane future (the batched
    native call returns the whole chunk's line lists)."""
    __slots__ = ("fut", "j")

    def __init__(self, fut, j):
        self.fut, self.j = fut, j

    def result(self):
        return self.fut.result()[self.j]


def _done_gen():
    """Placeholder wave generator for units the native chains-finish path
    already emitted text for (their region result is never read)."""
    return []
    yield  # unreachable — marks this function as a generator


class DeviceRuntime:
    """Maps fragments in device-sized batches; output order == input order."""

    def __init__(self, mi, opt, min_batch: int = 64,
                 device_seeds: bool | None = None, n_threads: int = 1,
                 mesh_shape: tuple[int, int] | None = None):
        # mesh_shape = (data, index): run the fused flow as the sharded
        # multi-chip step over a jax Mesh (index key-range-sharded for
        # >HBM genomes, reads data-parallel); byte-identical output
        self.mesh_shape = mesh_shape
        self.mi = mi
        self.opt = opt
        self.min_batch = min_batch
        # staged device seed collection is bit-exact; it stays opt-in
        # (parity + tests) — the fused flow collects on the device anyway
        if device_seeds is None:
            import os
            device_seeds = os.environ.get("MM2TPU_DEVICE_SEEDS", "0") == "1"
        self.device_seeds = device_seeds
        # staged-path crossover: reads at or below this anchor count chain
        # on the native host scan, bigger ones in the batched device pass.
        # 0 = everything device-eligible.
        import os as _os
        self.native_chain_max = int(_os.environ.get(
            "MM2TPU_NATIVE_CHAIN_MAX", "2048"))
        self.timers = Timers()
        from ..utils.compile_cache import enable_persistent_cache
        enable_persistent_cache()
        import jax
        self._jax = jax
        # CPU backend (tests): device sections run direct, no stall guard,
        # no link calibration and no persisted routing state
        self._on_cpu = jax.default_backend() == "cpu"
        from .batch_align import AlignExecutor
        self._align_exec = AlignExecutor(opt)
        self._seed_collector = None
        import threading
        self._seed_lock = threading.Lock()  # map_stream runs 2 batches
        from ..utils.device_guard import DEFAULT_TIMEOUT_S
        self._dev_timeout = DEFAULT_TIMEOUT_S
        # fused device-resident collect+chain flow (the reference's
        # always-offload shape, map.c:423-445). MM2TPU_DEVICE_FLOW=1/0
        # forces it; unset, a startup link measurement decides (see
        # _calibrate): the flow engages when D2H bandwidth clears
        # MM2TPU_FLOW_MIN_MBPS.
        flow_env = _os.environ.get("MM2TPU_DEVICE_FLOW", "")
        if mesh_shape is not None:
            from .device_flow import CAP_BUCKETS
            ni = mesh_shape[1]
            if ni < 1 or CAP_BUCKETS[0] % ni != 0:
                # shard_map needs equal blocks: every capacity bucket must
                # split evenly across the index axis (they are powers of
                # two, so any pow2 axis <= the smallest bucket works)
                raise SystemExit(
                    f"--mesh {mesh_shape[0]}x{ni}: the index axis must "
                    f"divide the {CAP_BUCKETS[0]}-slot capacity buckets — "
                    "use a power of two")
            self.device_flow = True   # explicit --mesh overrides the probe
            self.link_mbps = None
        elif flow_env in ("0", "1"):
            self.device_flow = flow_env == "1"
            self.link_mbps = None
        else:
            self.device_flow, self.link_mbps = self._calibrate()
        self._flow = None
        self._flow_lock = threading.Lock()
        # device/host whole-read split (map_batch's two concurrent lanes):
        # MM2TPU_FLOW_SHARE fixes the device fraction; forced flow or
        # --mesh pins it to 1.0 (pure device); calibrated mode starts at
        # 0.5 and the controller rebalances per batch
        self._flow_forced = flow_env == "1" or mesh_shape is not None
        share_env = _os.environ.get("MM2TPU_FLOW_SHARE", "")
        self._share_fixed = share_env != "" or self._flow_forced
        if share_env:
            self._flow_share = float(share_env)
        elif self._flow_forced:
            self._flow_share = 1.0
        else:
            # seed the split from the measured link: device-lane cost/read
            # ~ 20 KB over the link + ~0.5 ms dispatch share; host-lane
            # ~2.5 ms/read native map. The risk is asymmetric — a too-LOW
            # share just leaves reads on the full-rate host lane (combined
            # still ≥ host-only) while a too-HIGH share makes the device
            # lane the batch straggler — so seed at half the estimate and
            # let the sub-round controller converge it from measured
            # per-lane rates. A share learned by a previous runtime (this
            # process or a recent one — utils/link_state) overrides the
            # seed per workload key in _adopt_state.
            mbps = self.link_mbps or 8.0
            dev_ms = 0.02 / max(mbps, 0.1) * 1000.0 + 0.5
            self._flow_share = min(
                0.3, max(0.05, 2.5 / (2.5 + dev_ms) * 0.5))
        self._lane_ex = None
        self._draining = True   # map_stream clears it while batches flow
        self._lowshare_strikes = 0
        # sub-round share controller state (guarded by _ctrl_lock: two
        # map_stream pipeline threads may finish batches concurrently)
        self._ctrl_lock = threading.Lock()
        self._ctrl_updates = 0
        self._ctrl_stable = False
        self._ctrl_last_persist = 0.0
        self._wkey = None          # workload key the learned share is for
        self._retired = False      # device lane retired by the controller
        self._probe_chose_off = (mesh_shape is None and flow_env == ""
                                 and not self.device_flow)
        self._fast_ok_c = None
        self._host = None
        # -t worker pool for the host-side fast path (kt_for over
        # fragments, kthread.c:125): used when the calibrated routing
        # sends reads to the one-call native driver
        self.n_threads = max(1, int(n_threads))
        self._pool = None
        if self.n_threads > 1:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=max(1, self.n_threads - 1),
                thread_name_prefix="mm2tpu-worker")
        self._lane_lock = threading.Lock()

    def map_stream(self, batches, rg_id: str = ""):
        """Map a stream of read batches through a 2-deep threaded pipeline
        (the reference's kt_pipeline step overlap, map.c:637): batch k+1's
        host work (sketch, packing, epilogue) interleaves with batch k's
        device waits, which release the GIL while blocking on kernel
        results. Yields each batch's per-fragment output lines in order."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        # steal-lane hint: while more batches are still coming, a device
        # straggler at one batch's join overlaps the next batch's host
        # mapping, so the steal loop may pull work right up to the tail;
        # once the input is exhausted the final batches re-apply the
        # conservative join-tail reserve (models/steal.py)
        self._draining = False
        try:
            with ThreadPoolExecutor(max_workers=2) as ex:
                futs = deque()
                for batch in batches:
                    futs.append(ex.submit(self.map_batch, batch, rg_id))
                    if len(futs) >= 2:
                        yield futs.popleft().result()
                self._draining = True
                while futs:
                    yield futs.popleft().result()
        finally:
            self._draining = True

    def map_batch(self, frags, rg_id: str = "") -> list[list[str]]:
        """Map a batch of fragments; returns per-fragment output lines.
        Handles every preset: chaining and extension run in batched device
        kernels; ineligible units take exact host fallbacks.

        When the device/host share is adaptive (calibrated mode), a large
        batch is processed in sub-rounds so the split controller converges
        WITHIN a single -K batch from each sub-round's measured per-lane
        rates: the calibration seed only estimates the host lane's per-read
        cost, and a mis-seeded share on a one-batch run would otherwise
        leave one lane idle at the tail (the combined two-lane rate beats
        host-only exactly when both lanes finish together). Sub-rounds
        start small (64 fragments) so a mis-split exposes few reads, and
        grow once the controller is stable so per-dispatch overhead
        amortizes. When the link measurement rejected the flow (or the
        controller retired the lane), the batch delegates to the
        HostRuntime path outright — structurally identical to --device
        host."""
        if self._host_delegate_ok():
            return self._host_rt().map_batch(frags, rg_id)
        chunk = 64
        if (not self._share_fixed and self.device_flow
                and len(frags) >= 2 * chunk and self._fast_ok()):
            # work-stealing lanes (default; VERDICT r4 #1): the device
            # lane PULLS bounded chunks from a shared queue instead of
            # being assigned a share, so a slow lane contributes its
            # marginal reads instead of striking out and retiring.
            # MM2TPU_STEAL=0 restores the r4 share controller (kept for
            # A/B measurement); conftest's MM2TPU_NATIVE_CHAIN_MAX=0
            # (no host fast lane) also falls back to it.
            import os as _os3
            if (_os3.environ.get("MM2TPU_STEAL", "1") == "1"
                    and self.native_chain_max > 0):
                from .steal import run_steal_batch
                return run_steal_batch(self, frags, rg_id)
            self._adopt_state(frags)
            out: list[list[str]] = []
            st = 0
            while st < len(frags):
                if self._host_delegate_ok():  # retired mid-batch
                    out.extend(self._host_rt().map_batch(frags[st:], rg_id))
                    return out
                out.extend(self._map_batch1(frags[st:st + chunk], rg_id))
                st += chunk
                if self._ctrl_stable:
                    chunk = min(2 * chunk, 512)
            return out
        return self._map_batch1(frags, rg_id)

    def _fast_ok(self) -> bool:
        """Whether the host lane (one-call native driver) exists for this
        run's mode — the sub-round controller needs both lanes (ADVICE r2:
        chunking without a host lane pays join barriers for nothing)."""
        if self._fast_ok_c is None:
            from ..native import map_unit_ok
            self._fast_ok_c = bool(map_unit_ok(self.opt, self.mi)) \
                and not self.device_seeds
        return self._fast_ok_c

    def _host_delegate_ok(self) -> bool:
        """Delegate whole batches to the HostRuntime path when no device
        lane can pay: the link measurement said no (calibrated off) or the
        controller retired the lane. Env-forced MM2TPU_DEVICE_FLOW=0 keeps
        the staged device-chaining path (tests exercise it explicitly)."""
        if self.mesh_shape is not None or self.device_seeds:
            return False
        return (self._retired or self._probe_chose_off) \
            and not self.device_flow

    def _host_rt(self):
        """Lazily build the delegate HostRuntime sharing this runtime's
        timers and -t pool (output identity between the two runtimes is
        asserted by tests/test_host_runtime.py)."""
        if self._host is None:
            from .host_runtime import HostRuntime
            h = HostRuntime(self.mi, self.opt, n_threads=1)
            h.n_threads = self.n_threads
            h._pool = self._pool
            h.timers = self.timers
            self._host = h
        return self._host

    def _adopt_state(self, frags) -> None:
        """Adopt the persisted share/retirement for this workload key (a
        read-length bucket — a 1 kb and a 10 kb workload have very
        different device-lane costs, ADVICE r2). A retirement verdict is
        honored within its TTL unless the current probed link is 2x
        better than the link it was issued on (the parole path)."""
        lens = [len(s.seq) for f in frags[:64] for s in f.segs]
        if not lens:
            return
        wkey = f"rl{int(np.log2(max(float(np.mean(lens)), 64.0)))}"
        if wkey == self._wkey:
            return
        with self._ctrl_lock:
            if wkey == self._wkey:
                return
            self._wkey = wkey
            if self._on_cpu:
                return  # CPU tests: no link, no persisted verdicts
            from ..utils import link_state
            st = link_state.load()
            ent = st.get(f"share:{wkey}")
            if link_state.fresh(ent, link_state.PROBE_TTL_S):
                self._flow_share = float(ent["share"])
                self._ctrl_updates = 1  # a learned seed, not an estimate
            rent = st.get(f"retired:{wkey}")
            if link_state.fresh(rent, link_state.RETIRE_TTL_S):
                parole = (self.link_mbps and rent.get("mbps")
                          and self.link_mbps > 2.0 * float(rent["mbps"]))
                if not parole:
                    self.device_flow = False
                    self._retired = True
                    self.timers.count("flow_lane_retired_persisted")

    def _map_batch1(self, frags, rg_id: str = "") -> list[list[str]]:
        opt, mi = self.opt, self.mi
        from .batch_align import run_scheduler
        from .pipeline import (finish_unit_gen, format_frag, prepare_frag,
                               seed_unit)

        from ..native import (map_frag_pe_native, map_unit_ok,
                              map_unit_text_native)
        import time as _time
        # short single-segment reads take the one-call native path (below
        # the measured chain crossover they would route to host native
        # chaining + extension anyway); long reads keep the device kernels.
        # ~5.3 bp per minimizer (w=10 average spacing) maps the anchor
        # crossover to a query-length bound.
        flow = self._get_flow()
        fast_ok = map_unit_ok(opt, mi) and not self.device_seeds
        fast_qlen_max = self.native_chain_max * 5
        # the qlen cap exists to route mid-size reads to the DEVICE lane —
        # it must not strand reads on the ~30x staged Python path when no
        # device lane can actually take them: with the flow ineligible for
        # this mode (e.g. splice) every read goes native, and reads beyond
        # the flow/chain capacity buckets (~8192 anchors ≈ 43 kb) take the
        # native path too (native_chain_max=0 still disables the fast path
        # outright — tests and staged-coverage runs rely on that).
        from .device_flow import CAP_BUCKETS, M_BUCKETS
        # the flow's minimizer bucket (~qlen/5.3 entries) binds before its
        # anchor capacity at occ ~1
        dev_qlen_max = min(M_BUCKETS[-1], CAP_BUCKETS[-1]) * 5
        if self.native_chain_max > 0 and flow is None:
            fast_qlen_max = float("inf")
        # two concurrent whole-read lanes (the fork's send-task thread +
        # 56 host worker threads shape, fpga_chaindp.c:83 + run.sh:3): the
        # HOST lane maps its fragments through the one-call native driver
        # on executor threads WHILE the DEVICE lane's fused-flow
        # dispatches wait on the device — both sides release the GIL. The
        # share controller rebalances per batch so both lanes finish
        # together. MM2TPU_DEVICE_FLOW=1 forces share=1 (pure device).
        if flow is None:
            dev_fids: set = set()
        elif not fast_ok or self._flow_share >= 1.0:
            dev_fids = set(range(len(frags)))
        else:
            # distribute the device share over flow-ABSORBABLE fragments
            # only (single-segment, within the flow's buckets): a
            # positional split assigned oversized/multi-seg fragments to
            # the device lane, where the flow rejected them onto the ~30x
            # staged path instead of the native fast path they deserve
            share = self._flow_share
            cand = [i for i, fr in enumerate(frags)
                    if len(fr.segs) == 1
                    and len(fr.segs[0].seq) <= dev_qlen_max]
            dev_fids = {cand[i] for i in range(len(cand))
                        if int((i + 1) * share) > int(i * share)}
        def _fast_eligible(fi, frag):
            if not fast_ok or fi in dev_fids or len(frag.segs) > 2:
                return False
            qlen = sum(len(s.seq) for s in frag.segs)
            if qlen <= fast_qlen_max:
                return True
            # oversized for every device bucket: native is the only lane
            # that maps it at full speed
            return (self.native_chain_max > 0 and flow is not None
                    and qlen > dev_qlen_max)

        def _fast_one(frag):
            if len(frag.segs) == 1:
                return map_unit_text_native(mi, opt, frag.segs[0], rg_id)
            return map_frag_pe_native(mi, opt, frag.segs, rg_id)

        t_batch0 = _time.perf_counter()
        host_futs: dict[int, object] = {}
        host_last_t = [t_batch0]

        def _fast_timed(frag):
            r = _fast_one(frag)
            host_last_t[0] = _time.perf_counter()
            return r

        if fast_ok:
            # kt_for over fragments (kthread.c:125): the native calls
            # release the GIL, so workers scale across cores and overlap
            # the device lane's waits. Single-seg
            # fragments go in CHUNKED batched native calls (the whole
            # per-read loop in C — see native.map_batch_text_native);
            # chunks keep the lane-rate timestamps fine-grained enough
            # for the share controller.
            ex = self._pool or self._get_lane_ex()
            from ..native import map_batch_text_native
            se_elig = []
            for fi, frag in enumerate(frags):
                if _fast_eligible(fi, frag):
                    if len(frag.segs) == 1:
                        se_elig.append(fi)
                    else:
                        host_futs[fi] = ex.submit(_fast_timed, frag)

            def _fast_chunk(idxs):
                res = map_batch_text_native(
                    mi, opt, [frags[i].segs[0] for i in idxs], rg_id)
                if res is None:  # e.g. ava: per-read path has rank ctx
                    res = [_fast_one(frags[i]) for i in idxs]
                host_last_t[0] = _time.perf_counter()
                return res

            CH = 24
            for st in range(0, len(se_elig), CH):
                idxs = se_elig[st:st + CH]
                fut = ex.submit(_fast_chunk, idxs)
                for j, fi in enumerate(idxs):
                    host_futs[fi] = _ChunkView(fut, j)

        frag_meta = []
        units = []
        fast_lines: list = []
        with self.timers.time("seed"):
            for fi, frag in enumerate(frags):
                if fi in host_futs:
                    fast_lines.append(None)  # resolved in the epilogue
                    frag_meta.append(None)
                    continue
                fast_lines.append(None)
                work, flipped, us = prepare_frag(opt, frag.segs)
                start = len(units)
                for u in us:
                    units.append((u, seed_unit(mi, opt, u,
                                               collect_hits=False)))
                frag_meta.append((frag.segs, work, flipped,
                                  slice(start, len(units))))

        flow_chains: dict[int, Chains] = {}
        flow_cold = False
        if flow is not None:
            # device sections serialize on the device-owner thread
            # (utils/device_guard), so two map_stream batches interleave
            # safely: this batch's device waits overlap the other's host work
            flow_chains, flow_cold = flow.run(units, self.timers)

        # native finish from device chains: flow-handled single-segment
        # fragments run the post-chain half (regions -> align -> mapq ->
        # text) in ONE native call — the fork's FPGA->result_thread handoff
        # (fpga_chaindp.c:228, map.c:933-1015) — bypassing the staged
        # Python align stage entirely
        done_units: set[int] = set()
        if flow_chains and map_unit_ok(opt, mi):
            from ..native import map_unit_text_chains_native
            with self.timers.time("align"):
                for fi, meta in enumerate(frag_meta):
                    if meta is None:
                        continue
                    segs, work, flipped, sl = meta
                    k = sl.start
                    if (len(segs) != 1 or sl.stop - sl.start != 1
                            or k not in flow_chains):
                        continue
                    info = units[k][1]
                    if info.sh is None:
                        continue
                    lines_f = map_unit_text_chains_native(
                        mi, opt, segs[0], rg_id, flow_chains[k],
                        info.sh.rep_len, info.sh.mini_pos)
                    if lines_f is not None:
                        fast_lines[fi] = lines_f
                        frag_meta[fi] = None
                        done_units.add(k)
                        self.timers.count("native_finish")

        with self.timers.time("seed"):
            self._seed_hits(units)

        chains = self._chain_batch(units, flow_chains)

        with self.timers.time("align"):
            gens = [_done_gen() if k in done_units else finish_unit_gen(
                        mi, opt, info, ch)
                    for k, ((u, info), ch) in enumerate(zip(units, chains))]
            regss_per_unit = run_scheduler(gens, self._align_exec)
        t_dev_done = _time.perf_counter()

        lines: list[list[str]] = []
        with self.timers.time("epilogue"):
            from .pipeline import map_fragment_output
            for fi in range(len(frags)):
                if fi in host_futs:
                    res = host_futs[fi].result()
                    if res is None:
                        # rare contract fallback: exact synchronous host map
                        res = map_fragment_output(mi, opt, frags[fi].segs,
                                                  rg_id)
                        self.timers.count("host_fallback_frag")
                    else:
                        self.timers.count("fast_native")
                    lines.append(res)
                    continue
                if fast_lines[fi] is not None:
                    lines.append(fast_lines[fi])
                    continue
                segs, work, flipped, sl = frag_meta[fi]
                regss = [r for unit_regs in regss_per_unit[sl]
                         for r in unit_regs]
                lines.append(format_frag(mi, opt, segs, work, flipped,
                                         regss, rg_id))

        # share controller: set the device/host whole-read split from the
        # two lanes' MEASURED throughputs this sub-round (reads/s measured
        # from batch start; device lane time includes its device waits and
        # any CPU it took from the host lane, which is the point — the
        # split that makes both lanes finish together is
        # dev_rate/(dev_rate+host_rate)). Guarded by _ctrl_lock: two
        # map_stream pipeline threads can finish batches concurrently.
        if host_futs and dev_fids and not self._share_fixed:
            if flow_cold:
                # this sub-round paid one-off compile/cache-load time —
                # measuring it as lane throughput could retire a healthy
                # lane. Skip the update; the next sub-round measures the
                # warm lane.
                self.timers.count("ctrl_warmup_skip")
            else:
                self._ctrl_update(len(dev_fids),
                                  max(t_dev_done - t_batch0, 1e-6),
                                  len(host_futs),
                                  max(host_last_t[0] - t_batch0, 1e-6))
        return lines

    def _ctrl_update(self, n_dev: int, t_dev: float,
                     n_host: int, t_host: float) -> None:
        """One controller step from a sub-round's measured per-lane work:
        the split that makes both lanes finish together is
        dev_rate/(dev_rate+host_rate). The CONTRACT check is separate and
        direct: the combined rate (all reads over the sub-round wall,
        including the device straggler's tail) must not drop below what
        the host lane alone sustained — a device lane whose fixed
        per-dispatch round trip eats more than its reads are worth fails
        this even when the finish-together split looks nonzero (a
        per-sub-round round trip the split formula cannot see)."""
        host_rate = n_host / t_host
        target = (n_dev / t_dev) / (n_dev / t_dev + host_rate)
        combined = (n_dev + n_host) / max(t_dev, t_host)
        with self._ctrl_lock:
            # heavier first step: the seed is only an estimate, the
            # first sub-round's measurement overrides it
            w = 0.6 if self._ctrl_updates == 0 else 0.35
            self._ctrl_stable = abs(target - self._flow_share) < 0.10
            self._flow_share = min(0.95, max(
                0.02, (1.0 - w) * self._flow_share + w * target))
            self._ctrl_updates += 1
            # two consecutive failing sub-rounds retire the lane for this
            # runtime AND persist the verdict (TTL'd; a 2x-better probed
            # link paroles it — see _adopt_state). Failing = the lane's
            # split is ~nothing, or it dragged combined throughput below
            # the host lane's own measured rate.
            if target < 0.05 or combined < host_rate * 0.97:
                self._lowshare_strikes += 1
            else:
                self._lowshare_strikes = 0
            retire = self._lowshare_strikes >= 2
            if retire:
                self.device_flow = False
                self._retired = True
                self.timers.count("flow_lane_retired")
            import time as _t
            now = _t.time()
            if self._wkey and not self._on_cpu \
                    and (retire or now - self._ctrl_last_persist > 1.0):
                self._ctrl_last_persist = now
                from ..utils import link_state
                upd = {f"share:{self._wkey}": {
                    "share": round(self._flow_share, 4),
                    "mbps": self.link_mbps, "t": now}}
                if retire:
                    upd[f"retired:{self._wkey}"] = {
                        "mbps": self.link_mbps, "t": now}
                link_state.save(upd)

    def _get_lane_ex(self):
        """Single-worker executor for the host whole-read lane when no -t
        pool exists (the native driver releases the GIL, so the lane
        overlaps the device lane's waits)."""
        if self._lane_ex is None:
            with self._lane_lock:
                if self._lane_ex is None:
                    from concurrent.futures import ThreadPoolExecutor
                    self._lane_ex = ThreadPoolExecutor(
                        max_workers=1, thread_name_prefix="mm2tpu-hostlane")
        return self._lane_ex

    def _calibrate(self):
        """Startup link measurement: device D2H bandwidth picks the routing
        (the flow engages when it clears MM2TPU_FLOW_MIN_MBPS). The CPU
        backend (tests) always enables the flow — there is no link. The
        chosen values are reported in the [calibrate] line.

        The result is cached in-process and persisted with a TTL
        (utils/link_state), so later runtimes skip the measurement. It
        runs in this process, on the device-owner thread: no second
        process ever opens the device."""
        if self._on_cpu:
            return True, None
        import os
        import time
        min_mbps = float(os.environ.get("MM2TPU_FLOW_MIN_MBPS", "4"))
        from ..utils import link_state
        if link_state.fresh(_PROBE_MEM, link_state.PROBE_TTL_S
                            if _PROBE_MEM else 0):
            mbps = float(_PROBE_MEM["mbps"])
            return mbps >= min_mbps, mbps
        ent = link_state.load().get("probe")
        if isinstance(ent, dict) and link_state.fresh(
                ent, link_state.PROBE_TTL_S) and not ent.get("fail"):
            _PROBE_MEM.update(ent)
            mbps = float(ent["mbps"])
            return mbps >= min_mbps, mbps
        from ..utils.device_guard import device_call
        mbps = device_call(_measure_d2h_mbps, self._dev_timeout)
        ent = {"mbps": round(mbps, 2), "t": time.time()}
        _PROBE_MEM.clear()
        _PROBE_MEM.update(ent)
        link_state.save({"probe": ent})
        return mbps >= min_mbps, mbps

    def _get_flow(self):
        """Lazily build the fused collect+chain device flow (device_flow.py)
        when enabled and the run's mode is eligible."""
        if not self.device_flow:
            return None
        if self._flow is None:
            with self._flow_lock:
                if self._flow is None:
                    from .device_flow import DeviceFlow
                    mesh = None
                    if self.mesh_shape is not None:
                        from jax.sharding import Mesh
                        nd, ni = self.mesh_shape
                        avail = self._jax.devices()
                        if len(avail) < nd * ni:
                            raise SystemExit(
                                f"--mesh {nd}x{ni} needs {nd * ni} devices; "
                                f"found {len(avail)} on platform "
                                f"'{avail[0].platform}' (for a virtual CPU "
                                f"mesh run with JAX_PLATFORMS=cpu)")
                        devs = np.asarray(avail[:nd * ni]).reshape(nd, ni)
                        mesh = Mesh(devs, ("data", "index"))
                    import os as _os4
                    ship = None   # env decides (default: slim D2H)
                    floor = 0
                    steal_on = (mesh is None and not self._share_fixed
                                and _os4.environ.get("MM2TPU_STEAL",
                                                     "1") == "1"
                                and self.native_chain_max > 0)
                    if steal_on and _os4.environ.get(
                            "MM2TPU_FLOW_SHIP_ANCHORS", "") != "0":
                        # steal mode: the lane's economics are host-CPU-
                        # denominated — ship anchors from the device and
                        # skip the ~0.2 ms/read host re-collection
                        ship = True
                    if steal_on:
                        # quantize compiled shapes: {16,64}-row chunks x
                        # one floored capacity, so a warm pass can cover
                        # the whole space and no timed chunk hits a cold
                        # compile
                        floor = int(_os4.environ.get(
                            "MM2TPU_STEAL_CAP_FLOOR", "4096"))
                    self._flow = DeviceFlow(self.mi, self.opt,
                                            guarded=not self._on_cpu,
                                            mesh=mesh, ship_anchors=ship,
                                            cap_floor=floor)
        return self._flow if self._flow.mode_ok() else None

    def _seed_hits(self, units) -> None:
        """Fill UnitInfo.sh: batched device seed collection for eligible
        units (self/dual skipping and strand-only modes stay host — they
        need name-rank compares, map.c:146-185)."""
        opt, mi = self.opt, self.mi
        from ..ops.seeds import collect_seed_hits
        todo = [k for k, (segs, info) in enumerate(units)
                if info.mv is not None and len(info.mv) and info.sh is None]
        dev_ok = self.device_seeds \
            and not (opt.flag & (C.MM_F_NO_DIAG | C.MM_F_FOR_ONLY
                                 | C.MM_F_REV_ONLY))
        got = [None] * len(units)
        if dev_ok and todo:
            from ..utils.device_guard import device_call

            def _collect():
                with self._seed_lock:
                    if self._seed_collector is None:
                        from ..ops.seeds_device import DeviceSeedCollector
                        self._seed_collector = DeviceSeedCollector(mi)
                return self._seed_collector.collect_batch(
                    [units[k][1].mv for k in todo], opt.mid_occ,
                    [units[k][1].qlen_sum for k in todo])
            res = device_call(
                _collect, None if self._on_cpu else self._dev_timeout)
            for k, sh in zip(todo, res):
                got[k] = sh
        for k in todo:
            segs, info = units[k]
            if got[k] is not None:
                info.sh = got[k]
                self.timers.count("device_seed")
            else:
                info.sh = collect_seed_hits(mi, opt.flag, opt.mid_occ,
                                            info.mv, segs[0].name,
                                            info.qlen_sum)
                self.timers.count("host_seed")

    def _chain_batch(self, pending, precomputed=None) -> list[Chains]:
        """Score all units' chains, batched on device by (size bucket,
        gap bounds, many_segs). `pending` is a list of (segs, UnitInfo);
        `precomputed` carries Chains the fused device flow already made."""
        from ..ops import chain_batch as CB
        from .pipeline import host_chain
        opt = self.opt
        is_cdna = bool(opt.flag & C.MM_F_SPLICE)
        results: dict[int, Chains] = dict(precomputed or {})
        by_bucket: dict[tuple, list[int]] = {}
        host_idx: list[int] = []
        for k, (segs, info) in enumerate(pending):
            if k in results:
                continue
            if info.sh is None:
                results[k] = None
                continue
            n = len(info.sh.anchors)
            if n == 0:
                results[k] = Chains(np.empty((0, 2), np.uint64),
                                    np.empty(0, np.uint64))
                continue
            b = next((b for b in BUCKETS if n <= b), None)
            # oversized reads, or same-seg gap-cost domains beyond the exact
            # table (bw genomic / max_dist_y cdna), take the host path; so do
            # small reads below the measured native-chain crossover
            clin_dom = info.gap_qry if is_cdna else opt.bw
            if b is None or clin_dom >= CB.TBL or n <= self.native_chain_max:
                host_idx.append(k)
            else:
                key = (b, info.gap_qry, info.gap_ref, len(segs) > 1)
                by_bucket.setdefault(key, []).append(k)

        # dispatch every bucket's kernel before blocking on any result, so
        # the device runs bucket k+1 while the host reads back / backtracks
        # bucket k.  All device sections run through the guarded owner
        # thread (utils/device_guard.py); a stall or a device error ends
        # the run with that error.
        from ..utils.device_guard import device_call
        tmo = None if self._on_cpu else self._dev_timeout
        staged = []
        for (b, gq, gr, many), idxs in sorted(by_bucket.items()):
            reads = []
            for k in idxs:
                a = pending[k][1].sh.anchors
                xhi, rpos, qpos, span, sid = split_anchors(a)
                reads.append(dict(xhi=xhi, rpos=rpos, qpos=qpos, span=span,
                                  sid=sid,
                                  avg_qspan=np.float32(span.sum()) / np.float32(len(a))))
            with self.timers.time("pack"):
                packed, nn, w1, exc, host_flag = CB.pack_reads(reads, b, gr)
            with self.timers.time("kernel"):
                f, p, flag = device_call(lambda: CB.chain_scores_batch(
                    *(packed[x] for x in ("xhi", "rpos", "qpos", "span",
                                          "sid", "stw")),
                    nn, w1, exc, max_n=b, max_dist_x=gr, max_dist_y=gq,
                    bw=opt.bw, max_skip=opt.max_chain_skip,
                    is_cdna=is_cdna, many_segs=many), tmo)
            staged.append((idxs, host_flag, f, p, flag))
        for idxs, host_flag, f, p, flag in staged:
            with self.timers.time("kernel"):
                f, p, flag = device_call(
                    lambda f=f, p=p, flag=flag:
                        (np.asarray(f), np.asarray(p), np.asarray(flag)),
                    tmo)
            with self.timers.time("bottom"):
                from ..native import chain_bottom_native
                for r, k in enumerate(idxs):
                    if host_flag[r] or flag[r]:
                        host_idx.append(k)
                        self.timers.count("fallback")
                        continue
                    a = pending[k][1].sh.anchors
                    n = len(a)
                    ch = chain_bottom_native(a, f[r, :n], p[r, :n],
                                             opt.min_cnt,
                                             opt.min_chain_score)
                    if ch is None:  # no native toolchain: exact Python path
                        v = _v_from_fp(f[r, :n], p[r, :n])
                        cx, cy, cf, cp = compact_from_fpv(
                            a, f[r, :n], p[r, :n], v, opt.min_chain_score)
                        ch = chain_backtrack(cx, cy, cf, cp, opt.min_cnt,
                                             opt.min_chain_score)
                    results[k] = ch
                    self.timers.count("device_reads")

        with self.timers.time("host_fallback"):
            for k in host_idx:
                segs, info = pending[k]
                results[k] = host_chain(opt, info, len(segs))
        return [results[k] for k in range(len(pending))]


def _measure_d2h_mbps() -> float:
    """Device-to-host bandwidth in MB/s: two timed fetches of a 4 MB
    device array, the slower one kept (the first transfer after an upload
    can ride a burst that over-states the sustained rate)."""
    import time

    import jax
    import jax.numpy as jnp
    x = jax.block_until_ready(jnp.arange(1 << 20, dtype=jnp.int32))
    np.asarray(x[:16])          # warm the transfer path
    worst = None
    for k in range(2):
        y = jax.block_until_ready(x + k)
        t0 = time.perf_counter()
        np.asarray(y)
        dt = time.perf_counter() - t0
        worst = dt if worst is None else max(worst, dt)
    return 4.0 / max(worst, 1e-9)


from .device_flow import _v_from_fp  # noqa: E402 — shared exact fallback
