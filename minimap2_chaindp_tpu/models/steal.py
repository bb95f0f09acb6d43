"""Work-stealing two-lane batch mapper (VERDICT r4 #1).

The reference answers heterogeneous worker speed with work-stealing
(kthread.c:59-143): a slow worker contributes exactly what it finishes
and never holds work hostage.  This module applies that shape to the
host/device split the r4 share controller managed by static fractions:
one shared work list per batch, consumed from the FRONT by the HOST
lane (whole-read batched native driver on the calling thread) and from
the BACK by the DEVICE lane (fused collect+chain flow + native
chains-finish on a deprioritized worker thread).  The device lane pulls
a bounded chunk only when enough work remains to keep the host lane
busy past the chunk's expected completion (the join-tail rule), so the
batch never waits on a straggling device chunk longer than the chunk
saved.  A starved-but-functional lane therefore contributes exactly the
reads it completes — combined >= host-alone by construction — instead
of being retired to zero on two strikes (models/runtime.py r4).

CPU economics (VERDICT r4 #3): every device-mapped read costs host-side
CPU — sketch + pre-dispatch seed stats + packing + anchor re-derivation
+ native finish on the worker thread, plus dispatch marshalling/polling
on the device-owner thread (utils/device_guard.owner_cpu_s) — and that
CPU is taken from the host lane.  The loop MEASURES
both lanes' per-read cost (thread CPU for the device lane, wall for the
CPU-bound host lane) and PAUSES pulling when a device read costs more
than MM2TPU_STEAL_GUARD (default 0.9) of a native host read; a paused
lane re-probes one chunk every MM2TPU_STEAL_PROBE_S seconds instead of
retiring, so a regime recovery is harvested within seconds.  The
measured decomposition is exported via timers counters
(steal_cpu_{prep,flowhost,dispatch,finish}_ms) for PERF.md.

Reference analogs: always-offload task posture map.c:423-445; worker
loop fpga_chaindp.c:83-170.  Output is byte-identical to the host path
(tests/test_steal.py): each read is mapped by exactly one lane and both
lanes' per-read output is the same native text contract.  A device
error or stall in the lane ends the batch with that error (it is re-raised
on the calling thread once the host lane stops).
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque

HOST_CH = 24                    # host-lane batched-native chunk
DEV_CH = int(os.environ.get("MM2TPU_STEAL_DEV_CH", "16"))
# adaptive upper bound: a device chunk's fixed cost (dispatch RTT +
# per-bucket kernel launch) amortizes over its reads, so a warm
# profitable lane jumps straight to this cap. The ladder is {DEV_CH,
# DEV_CH_MAX} — exactly two pulled sizes — because every distinct chunk
# size is a distinct padded row count, i.e. a distinct compiled step
# shape, and a cold shape's compile stalls the whole pipeline behind the
# chunk
DEV_CH_MAX = int(os.environ.get("MM2TPU_STEAL_DEV_CH_MAX", "64"))
GUARD = float(os.environ.get("MM2TPU_STEAL_GUARD", "0.9"))
PROBE_S = float(os.environ.get("MM2TPU_STEAL_PROBE_S", "20"))
# EMA weight for per-chunk cost updates: heavy enough that one probe
# chunk meaningfully refreshes a stale verdict
_ALPHA = 0.4


class StealState:
    """Per-runtime lane-economics state; survives across batches so later
    batches start from measured costs, not estimates."""

    def __init__(self):
        self.dev_cpu_per_read = None    # EMA, seconds of host CPU / read
        self.host_per_read = None       # EMA, seconds wall (~CPU) / read
        self.host_best = None           # best observed, slow upward decay
        self.host_best_t = 0.0          # decay is per SECOND, not per chunk
        self.chunk_wall_ema = float(
            os.environ.get("MM2TPU_STEAL_CHUNK_EST_S", "4.0"))
        self.dev_ch = DEV_CH            # adaptive chunk size
        self.paused_at = None           # monotonic time the guard paused
        self.adopted = False            # persisted verdict consumed
        self.wkey = None


def _ema(prev, x):
    if prev is None:
        return x
    if x < prev / 3.0 or x > prev * 3.0:
        return x   # regime change (code/load shift): re-learn, don't crawl
    return (1.0 - _ALPHA) * prev + _ALPHA * x


def _unprofitable(st: StealState) -> bool:
    if st.dev_cpu_per_read is None or st.host_per_read is None:
        return False
    # reference cost = what a host-mapped read SHOULD cost, not what it
    # costs while the lane itself contends for the core: the running
    # EMA inflates under lane pressure, which let a marginally-losing
    # lane keep stealing. host_best decays upward 2% per update so real
    # slowdowns still raise the bar eventually.
    ref = st.host_per_read
    if st.host_best is not None:
        ref = min(ref, st.host_best * 1.2)
    return st.dev_cpu_per_read > GUARD * ref


def _wkey(rt, frags) -> str | None:
    import numpy as np
    lens = [len(s.seq) for f in frags[:64] for s in f.segs]
    if not lens:
        return None
    # index scale is part of the workload: the lane's savings per read
    # are collect+chain, which grow ~50x from a 16 kb reference to 3 Gbp
    # while its costs stay flat — one verdict must not span both
    nk = max(len(rt.mi.keys), 10)
    return (f"rl{int(np.log2(max(float(np.mean(lens)), 64.0)))}"
            f"_nk{int(np.log10(nk))}")


def _adopt_persisted(rt, st: StealState, frags) -> None:
    """Seed the economics from a TTL'd persisted verdict for this
    workload key: a run that measured the lane unprofitable seconds ago
    starts paused (but still probing — never retired).  A measured link
    2x better than the verdict's paroles it, like the share path."""
    if st.adopted or rt._on_cpu:
        st.adopted = True
        return
    st.adopted = True
    st.wkey = _wkey(rt, frags)
    if st.wkey is None:
        return
    from ..utils import link_state
    ent = link_state.load().get(f"steal:{st.wkey}")
    if not link_state.fresh(ent, link_state.RETIRE_TTL_S):
        return
    parole = (rt.link_mbps and ent.get("mbps")
              and rt.link_mbps > 2.0 * float(ent["mbps"]))
    if parole:
        return
    st.dev_cpu_per_read = float(ent["dev_cpu_ms"]) / 1000.0
    st.host_per_read = float(ent["host_ms"]) / 1000.0
    if _unprofitable(st):
        st.paused_at = time.monotonic()
        rt.timers.count("steal_adopted_paused")


def _persist(rt, st: StealState) -> None:
    if rt._on_cpu or st.wkey is None \
            or st.dev_cpu_per_read is None or st.host_per_read is None:
        return
    from ..utils import link_state
    link_state.save({f"steal:{st.wkey}": {
        "dev_cpu_ms": round(st.dev_cpu_per_read * 1000.0, 3),
        "host_ms": round(st.host_per_read * 1000.0, 3),
        "mbps": rt.link_mbps, "t": time.time()}})


def _host_map_frag(rt, fr, rg_id):
    """Exact per-fragment host mapping for the shapes the batched driver
    does not take (PE pairs, rare contract fallbacks, >2-seg frags)."""
    from ..native import map_frag_pe_native, map_unit_text_native
    r = None
    if len(fr.segs) == 1:
        r = map_unit_text_native(rt.mi, rt.opt, fr.segs[0], rg_id)
    elif len(fr.segs) == 2:
        r = map_frag_pe_native(rt.mi, rt.opt, fr.segs, rg_id)
    if r is None:
        from .pipeline import map_fragment_output
        r = map_fragment_output(rt.mi, rt.opt, fr.segs, rg_id)
        rt.timers.count("host_fallback_frag")
    return r


def _host_map_chunk(rt, frags, idxs, rg_id) -> dict:
    """One host-lane chunk: single-segment reads through the one-call
    batched native driver (whole per-read loop in C, GIL released);
    everything else per-fragment."""
    from ..native import map_batch_text_native
    out = {}
    se = [i for i in idxs if len(frags[i].segs) == 1]
    if se:
        res = map_batch_text_native(
            rt.mi, rt.opt, [frags[i].segs[0] for i in se], rg_id)
        if res is not None:
            for i, lines in zip(se, res):
                out[i] = lines
            rt.timers.count("fast_native", len(se))
            se = []
    for i in idxs:
        if i not in out:
            out[i] = _host_map_frag(rt, frags[i], rg_id)
    return out


def _dev_map_chunk(rt, frags, idxs, rg_id):
    """One device-lane chunk: prepare + sketch, fused collect+chain on
    the device (DeviceFlow), then the native post-chain finish
    (regions -> align -> mapq -> text in one C call).  Reads the flow
    rejects (overflow, skip-flag, empty) take the full native host map
    — exact either way.  Returns ({index: lines}, cold)."""
    from .pipeline import prepare_frag, seed_unit
    from ..native import map_unit_text_chains_native, map_unit_text_native
    from ..utils.device_guard import owner_cpu_s
    tt = time.thread_time
    t0 = tt()
    units, order = [], []
    for i in idxs:
        work, flipped, us = prepare_frag(rt.opt, frags[i].segs)
        units.append((us[0], seed_unit(rt.mi, rt.opt, us[0],
                                       collect_hits=False)))
        order.append(i)
    t1 = tt()
    o0 = owner_cpu_s()
    flow = rt._get_flow()
    chains, cold = flow.run(units, rt.timers) if flow is not None \
        else ({}, False)
    t2 = tt()
    o1 = owner_cpu_s()
    out = {}
    for k, i in enumerate(order):
        info = units[k][1]
        ch = chains.get(k)
        lines = None
        if ch is not None and info.sh is not None:
            lines = map_unit_text_chains_native(
                rt.mi, rt.opt, frags[i].segs[0], rg_id, ch,
                info.sh.rep_len, info.sh.mini_pos)
            if lines is not None:
                rt.timers.count("native_finish")
        if lines is None:
            lines = map_unit_text_native(rt.mi, rt.opt, frags[i].segs[0],
                                         rg_id)
            if lines is None:
                from .pipeline import map_fragment_output
                lines = map_fragment_output(rt.mi, rt.opt, frags[i].segs,
                                            rg_id)
            rt.timers.count("steal_dev_fallback")
        out[i] = lines
    t3 = tt()
    # measured decomposition of the lane's host-side CPU (VERDICT r4 #3)
    rt.timers.count("steal_cpu_prep_ms", int((t1 - t0) * 1000))
    rt.timers.count("steal_cpu_flowhost_ms", int((t2 - t1) * 1000))
    rt.timers.count("steal_cpu_dispatch_ms", int((o1 - o0) * 1000))
    rt.timers.count("steal_cpu_finish_ms", int((t3 - t2) * 1000))
    return out, cold


def _dev_loop(rt, st: StealState, frags, rg_id, q_any, lock, results,
              stop: threading.Event):
    from ..utils.device_guard import (COMPILE_TIMEOUT_S, device_call,
                                      set_owner_nice)
    # priority follows measured profitability: an unproven or losing lane
    # yields the core to the host lane (nice +10 on both this worker and
    # the device-owner thread); once the economics say a stolen read
    # costs LESS host CPU than mapping it natively, the lane competes at
    # equal priority — its CPU share (and so its steal rate) then rises
    # exactly where rising pays. Restored to deprioritized on exit.
    base_nice = 10
    try:
        base_nice = int(os.environ.get("MM2TPU_DEVICE_NICE", "10"))
    except Exception:
        pass
    my_tid = threading.get_native_id()
    cur = [None]

    def _lane_nice(n):
        if cur[0] == n:
            return
        cur[0] = n
        try:
            os.setpriority(os.PRIO_PROCESS, my_tid, n)
        except Exception:
            pass
        set_owner_nice(n)

    _lane_nice(base_nice)
    # flow construction happens HERE, not on the host-lane thread: at
    # genome scale it uploads GB-class index tables, and under
    # device_call a stalled upload fails the batch instead of wedging it
    flow = rt._get_flow() if rt._on_cpu else device_call(
        rt._get_flow, max(COMPILE_TIMEOUT_S, 600.0))
    if flow is None:
        return
    try:
        _dev_loop_body(rt, st, frags, rg_id, q_any, lock, results, stop,
                       _lane_nice, base_nice)
    finally:
        set_owner_nice(base_nice)   # the owner thread outlives this batch


def _dev_loop_body(rt, st, frags, rg_id, q_any, lock, results, stop,
                   _lane_nice, base_nice):
    from ..utils.device_guard import owner_cpu_s

    def _apply_nice():
        measured = (st.dev_cpu_per_read is not None
                    and st.host_per_read is not None)
        _lane_nice(0 if measured and not _unprofitable(st) else base_nice)

    _apply_nice()
    while not stop.is_set():
        probing = False
        if _unprofitable(st):
            if st.paused_at is None:
                st.paused_at = time.monotonic()
                rt.timers.count("steal_paused")
            if time.monotonic() - st.paused_at < PROBE_S:
                if stop.wait(0.25):
                    return
                continue
            # probe due: attempt ONE pull; the timer re-arms only after
            # a pull actually happens, so a drained-queue rejection lets
            # the NEXT batch's worker probe immediately
            probing = True
            rt.timers.count("steal_probe")
        # join-tail rule: on the stream's FINAL batch (or a standalone
        # map_batch) pull only if the host lane has more work left than
        # this chunk is expected to take, so the run never ends waiting
        # on a device straggler longer than the chunk saved.  Mid-stream
        # the join is free — map_stream runs two batches concurrently,
        # so batch k's join overlaps batch k+1's host mapping — and the
        # reserve only needs to keep THIS batch's host lane from a bare
        # queue for an instant.
        host_rate = (1.0 / st.host_per_read) if st.host_per_read else 600.0
        ch = st.dev_ch
        if getattr(rt, "_draining", True):
            reserve = max(2 * ch, int(st.chunk_wall_ema * host_rate))
        else:
            reserve = 2 * ch
        with lock:
            if len(q_any) < ch + reserve:
                return
            idxs = [q_any.pop() for _ in range(ch)]
        if probing:
            st.paused_at = time.monotonic()   # re-arm on an actual pull
        t0w = time.monotonic()
        t0c = time.thread_time()
        o0 = owner_cpu_s()
        out, cold = _dev_map_chunk(rt, frags, idxs, rg_id)
        cpu = (time.thread_time() - t0c) + (owner_cpu_s() - o0)
        wall = time.monotonic() - t0w
        with lock:
            results.update(out)
        rt.timers.count("steal_device_reads", len(out))
        rt.timers.count("steal_chunks")
        rt.timers.count("steal_cpu_ms", int(cpu * 1000))
        # amortize the chunk's fixed cost (dispatch RTT + per-bucket
        # launch): a not-yet-unprofitable lane jumps to the DEV_CH_MAX
        # rung — on COLD chunks too, so the shape-warm pass actually
        # touches the big-chunk shapes (gating growth on warmth left
        # R=64 shapes cold until a TIMED run hit their compile stall)
        if not _unprofitable(st) and st.dev_ch < DEV_CH_MAX:
            st.dev_ch = DEV_CH_MAX   # two-size ladder (see DEV_CH_MAX)
        if cold:
            continue             # compile/cache-load time is not lane cost
        st.dev_cpu_per_read = _ema(st.dev_cpu_per_read, cpu / len(idxs))
        st.chunk_wall_ema = 0.7 * st.chunk_wall_ema + 0.3 * wall
        if st.paused_at is not None and not _unprofitable(st):
            st.paused_at = None
            rt.timers.count("steal_resumed")
        _apply_nice()


def run_steal_batch(rt, frags, rg_id: str = "") -> list[list[str]]:
    """Map one batch through the two stealing lanes; output order ==
    input order, byte-identical to the host path."""
    st = getattr(rt, "_steal_state", None)
    if st is None:
        st = rt._steal_state = StealState()
    _adopt_persisted(rt, st, frags)
    from .device_flow import CAP_BUCKETS, M_BUCKETS
    dev_qlen_max = min(M_BUCKETS[-1], CAP_BUCKETS[-1]) * 5
    q_any: deque = deque()       # either lane may take these
    q_host: deque = deque()      # host-only: PE, oversized, multi-seg
    for i, fr in enumerate(frags):
        if len(fr.segs) == 1 and len(fr.segs[0].seq) <= dev_qlen_max:
            q_any.append(i)
        else:
            q_host.append(i)
    lock = threading.Lock()
    results: dict[int, list] = {}
    stop = threading.Event()
    err: list = []
    worker = None
    # flow eligibility (and at genome scale its table upload) resolve on
    # the worker thread — the host lane must never block on them
    def _lane():
        try:
            _dev_loop(rt, st, frags, rg_id, q_any, lock, results, stop)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            err.append(e)
            stop.set()

    if rt.device_flow:
        worker = threading.Thread(target=_lane, daemon=True,
                                  name="mm2tpu-steal")
        worker.start()
    try:
        while not err:
            with lock:
                src = q_host if q_host else q_any
                idxs = [src.popleft()
                        for _ in range(min(HOST_CH, len(src)))]
            if not idxs:
                break
            t0 = time.monotonic()
            out = _host_map_chunk(rt, frags, idxs, rg_id)
            now = time.monotonic()
            r = (now - t0) / len(idxs)
            st.host_per_read = _ema(st.host_per_read, r)
            if st.host_best is None:
                st.host_best = r
            else:
                # fast-down/slow-up estimate of the host lane's
                # UNCONTENDED per-read cost: 2%/SECOND upward decay
                # (per-chunk decay eroded the bar to the contended level
                # within a second at ~20 chunks/s), and a partial step
                # down (a raw min latched single scheduler-burst chunks
                # and under-read the true cost by 2x, spuriously pausing
                # a profitable lane in the 3 Gbp capture)
                grow = 1.02 ** min(max(now - st.host_best_t, 0.0), 60.0)
                hb = st.host_best * grow
                st.host_best = 0.7 * hb + 0.3 * r if r < hb else hb
            st.host_best_t = now
            with lock:
                results.update(out)
    finally:
        stop.set()
        if worker is not None:
            worker.join()        # bounded: at most one chunk in flight
    if err:
        raise err[0]
    _persist(rt, st)
    out_lines = []
    for i in range(len(frags)):
        r = results.get(i)
        if r is None:            # unreachable by construction; exact path
            r = _host_map_frag(rt, frags[i], rg_id)
        out_lines.append(r)
    return out_lines
