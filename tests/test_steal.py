"""Work-stealing two-lane mapper (models/steal.py, VERDICT r4 #1):
byte-identity with the host path, actual stealing, the economics guard's
pause/probe posture, and device failures ending the batch."""
import os

import numpy as np
import pytest

from minimap2_chaindp_tpu import constants as C
from minimap2_chaindp_tpu.io.fastx import Frag
from minimap2_chaindp_tpu.models.pipeline import map_fragment_output
from minimap2_chaindp_tpu.models.runtime import DeviceRuntime

BASES = "ACGT"


class _Seg:
    def __init__(self, name, seq):
        self.name, self.seq = name, seq
        self.qual = None
        self.comment = None


def _sim_reads(ref_seq, n, read_len, err, seed):
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(n):
        st = int(rng.integers(0, len(ref_seq) - read_len))
        out = []
        for c in ref_seq[st:st + read_len]:
            r = rng.random()
            if r < err * 0.6:
                out.append(BASES[int(rng.integers(0, 4))])
            elif r < err * 0.8:
                pass
            else:
                out.append(c)
        s = "".join(out)
        if rng.random() < 0.5:
            s = s[::-1].translate(str.maketrans("ACGT", "TGCA"))
        reads.append(_Seg(f"r{i}", s))
    return reads


@pytest.fixture(scope="module")
def mt_index(seeded):
    """Default-preset index of the seeded genome, plus its first contig."""
    mi, mo = seeded.index(None)
    mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR
    return mi, mo, seeded.contig(0)


def _steal_runtime(mt_index, monkeypatch):
    mi, mo, _ = mt_index
    monkeypatch.setenv("MM2TPU_NATIVE_CHAIN_MAX", "2048")
    monkeypatch.setenv("MM2TPU_STEAL", "1")
    rt = DeviceRuntime(mi, mo)
    assert rt.native_chain_max == 2048
    rt._draining = False   # mid-stream posture: generous pull reserve
    return rt


def _frags(mt_index, n=160, pe_every=13):
    """Simulated single-seg frags with some 2-seg (host-only) mixed in."""
    _, _, ref_seq = mt_index
    reads = _sim_reads(ref_seq, n, 700, 0.08, seed=3)
    frags = []
    i = 0
    while i < len(reads):
        if i % pe_every == pe_every - 1 and i + 1 < len(reads):
            frags.append(Frag([reads[i], reads[i + 1]]))
            i += 2
        else:
            frags.append(Frag([reads[i]]))
            i += 1
    return frags


def test_steal_identity_and_stealing(mt_index, monkeypatch):
    """Steal-mode output is byte-identical to the exact host path, and
    the device lane actually pulled and completed reads."""
    mi, mo, _ = mt_index
    rt = _steal_runtime(mt_index, monkeypatch)
    from minimap2_chaindp_tpu.models import steal
    monkeypatch.setattr(steal, "DEV_CH", 8)
    frags = _frags(mt_index)
    rt._get_flow()   # pre-build: this tiny batch drains in ~100 ms, and
    # the worker's lazy flow construction (prod: overlapped with 20 s of
    # host mapping) would otherwise start after the queue is empty
    got = rt.map_batch(frags)
    want = [map_fragment_output(mi, mo, f.segs) for f in frags]
    assert got == want
    c = rt.timers.counters
    assert c.get("steal_device_reads", 0) > 0, c
    assert c.get("steal_chunks", 0) > 0
    # the decomposition counters exist for every processed chunk
    assert "steal_cpu_prep_ms" in c and "steal_cpu_finish_ms" in c


def test_steal_guard_pauses_and_probes(mt_index, monkeypatch):
    """An unprofitable lane pauses (no pulls) while the probe timer is
    armed, and probes exactly when it expires — never retires."""
    mi, mo, _ = mt_index
    from minimap2_chaindp_tpu.models import steal
    rt = _steal_runtime(mt_index, monkeypatch)
    st = rt._steal_state = steal.StealState()
    st.adopted = True
    st.dev_cpu_per_read = 1.0     # 1 s of CPU per device read
    st.host_per_read = 0.001      # vs 1 ms per host read
    monkeypatch.setattr(steal, "PROBE_S", 3600.0)
    frags = _frags(mt_index, n=140, pe_every=10**9)
    got = rt.map_batch(frags)
    want = [map_fragment_output(mi, mo, f.segs) for f in frags]
    assert got == want
    c = rt.timers.counters
    assert c.get("steal_device_reads", 0) == 0
    assert c.get("steal_paused", 0) >= 1
    # probe timer at zero: the paused lane probes (pulls) again
    rt2 = _steal_runtime(mt_index, monkeypatch)
    st2 = rt2._steal_state = steal.StealState()
    st2.adopted = True
    st2.dev_cpu_per_read = 1.0
    st2.host_per_read = 0.001
    monkeypatch.setattr(steal, "PROBE_S", 0.0)
    monkeypatch.setattr(steal, "DEV_CH", 8)
    got2 = rt2.map_batch(frags)
    assert got2 == want
    assert rt2.timers.counters.get("steal_probe", 0) >= 1
    assert rt2.timers.counters.get("steal_device_reads", 0) > 0


def test_steal_stall_hands_work_back(mt_index, monkeypatch):
    """A device-lane failure mid-batch stops the host lane and ends the
    batch with that error: no read is silently remapped on the host."""
    from minimap2_chaindp_tpu.models import steal
    rt = _steal_runtime(mt_index, monkeypatch)
    rt._steal_state = steal.StealState()
    rt._steal_state.adopted = True

    def _boom(*a, **k):
        raise RuntimeError("synthetic device failure")

    monkeypatch.setattr(steal, "_dev_map_chunk", _boom)
    frags = _frags(mt_index, n=140)
    with pytest.raises(RuntimeError, match="synthetic device failure"):
        rt.map_batch(frags)
    assert rt.timers.counters.get("steal_device_reads", 0) == 0


def test_steal_final_batch_reserve(mt_index, monkeypatch):
    """In draining (final-batch) posture with a pessimistic chunk-wall
    estimate, the device lane leaves the tail to the host lane — the
    join-tail rule — and output stays exact."""
    mi, mo, _ = mt_index
    from minimap2_chaindp_tpu.models import steal
    rt = _steal_runtime(mt_index, monkeypatch)
    rt._draining = True
    st = rt._steal_state = steal.StealState()
    st.adopted = True
    st.chunk_wall_ema = 10_000.0    # any pull would strand the join
    st.host_per_read = 0.001
    frags = _frags(mt_index, n=140, pe_every=10**9)
    got = rt.map_batch(frags)
    want = [map_fragment_output(mi, mo, f.segs) for f in frags]
    assert got == want
    assert rt.timers.counters.get("steal_device_reads", 0) == 0


def test_guard_host_best_semantics():
    """The profitability bar references the host lane's best-observed
    (uncontended) cost, not the contention-inflated EMA; burst minima
    step the estimate down partially rather than latching."""
    from minimap2_chaindp_tpu.models import steal
    st = steal.StealState()
    # no dev measurement yet: never unprofitable
    st.host_per_read = 0.002
    assert not steal._unprofitable(st)
    # lane 2.15 ms vs inflated EMA 2.4 ms but uncontended best 1.7 ms:
    # must read UNPROFITABLE (the full-bench MT case)
    st.dev_cpu_per_read = 0.00215
    st.host_per_read = 0.0024
    st.host_best = 0.0017
    assert steal._unprofitable(st)
    # without host_best the inflated EMA would have let it steal
    st.host_best = None
    assert not steal._unprofitable(st)
    # genome case: lane 3.2 ms vs host ~5.5 -> profitable either way
    st.dev_cpu_per_read = 0.0032
    st.host_per_read = 0.0055
    st.host_best = 0.0046
    assert not steal._unprofitable(st)
