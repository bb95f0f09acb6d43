"""Two-lane share controller + persisted link state (contract: the
calibrated device route never loses to host-only — the controller must
converge from measured rates, retire a losing lane, persist the verdict,
and parole it when the link recovers)."""
import time

import pytest

from minimap2_chaindp_tpu import constants as C
from minimap2_chaindp_tpu.io.fastx import Frag
from minimap2_chaindp_tpu.models.runtime import DeviceRuntime
from minimap2_chaindp_tpu.utils import link_state


@pytest.fixture
def state_file(tmp_path, monkeypatch):
    p = tmp_path / "link_state.json"
    monkeypatch.setenv("MM2TPU_STATE_FILE", str(p))
    return p


@pytest.fixture
def _runtime(seeded):
    def make():
        mi, mo = seeded.index(None)
        mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR
        return mi, mo
    return make


def test_state_roundtrip_and_ttl(state_file):
    link_state.save({"probe": {"mbps": 12.5, "t": time.time()}})
    st = link_state.load()
    assert st["probe"]["mbps"] == 12.5
    assert link_state.fresh(st["probe"], 90)
    assert not link_state.fresh(st["probe"], -1)
    stale = {"mbps": 3.0, "t": time.time() - 1e6}
    assert not link_state.fresh(stale, 90)
    # corruption tolerated
    state_file.write_text("{torn")
    assert link_state.load() == {}


def test_state_disabled_by_empty_env(monkeypatch, tmp_path):
    monkeypatch.setenv("MM2TPU_STATE_FILE", "")
    link_state.save({"probe": {"mbps": 1.0, "t": time.time()}})
    assert link_state.load() == {}


def test_adopt_persisted_share_and_retirement(state_file, _runtime, seeded):
    mi, mo = _runtime()
    frags = seeded.frags()
    # persisted learned share for this workload's read-length bucket
    import numpy as np
    lens = [len(s.seq) for f in frags[:64] for s in f.segs]
    wkey = f"rl{int(np.log2(max(float(np.mean(lens)), 64.0)))}"
    link_state.save({f"share:{wkey}": {"share": 0.42, "mbps": 20.0,
                                       "t": time.time()}})
    rt = DeviceRuntime(mi, mo)
    rt._on_cpu = False    # exercise the real adoption path
    rt.link_mbps = 20.0
    rt._adopt_state(frags)
    assert rt._flow_share == pytest.approx(0.42)
    assert rt.device_flow

    # a fresh retirement verdict on a similar link turns the lane off
    link_state.save({f"retired:{wkey}": {"mbps": 20.0, "t": time.time()}})
    rt2 = DeviceRuntime(mi, mo)
    rt2._on_cpu = False
    rt2.link_mbps = 20.0
    rt2._adopt_state(frags)
    assert rt2._retired and not rt2.device_flow

    # parole: a 2x-better probed link ignores the stale verdict
    rt3 = DeviceRuntime(mi, mo)
    rt3._on_cpu = False
    rt3.link_mbps = 50.0
    rt3._adopt_state(frags)
    assert not rt3._retired and rt3.device_flow

    # an EXPIRED retirement is ignored even on the same link
    link_state.save({f"retired:{wkey}": {
        "mbps": 20.0, "t": time.time() - link_state.RETIRE_TTL_S - 1}})
    rt4 = DeviceRuntime(mi, mo)
    rt4._on_cpu = False
    rt4.link_mbps = 20.0
    rt4._adopt_state(frags)
    assert not rt4._retired and rt4.device_flow


def test_host_delegation_when_probe_rejects(state_file, _runtime, seeded):
    """A runtime whose link measurement said no must route batches through the
    HostRuntime path (structural parity with --device host) and still
    produce identical output."""
    from minimap2_chaindp_tpu.models.pipeline import map_fragment_output
    mi, mo = _runtime()
    frags = seeded.frags()
    rt = DeviceRuntime(mi, mo)
    rt.device_flow = False
    rt._probe_chose_off = True
    assert rt._host_delegate_ok()
    lines = [l for ls in rt.map_batch(frags) for l in ls]
    assert rt._host is not None          # the delegate actually ran
    host_lines = []
    for f in frags:
        host_lines.extend(map_fragment_output(mi, mo, f.segs))
    assert lines == host_lines
    # env-forced flow-off keeps the staged device path (no delegation)
    rt2 = DeviceRuntime(mi, mo)
    rt2.device_flow = False              # as if MM2TPU_DEVICE_FLOW=0
    assert not rt2._host_delegate_ok()


def test_calibrate_measures_link_in_process(state_file, _runtime,
                                             monkeypatch):
    """Off the CPU backend the startup calibration measures the link in
    this process (no child opens the device), persists the figure, and a
    later runtime reuses it without measuring again."""
    from minimap2_chaindp_tpu.models import runtime as R
    calls = []

    def _fake_measure():
        calls.append(1)
        return 123.0

    monkeypatch.setattr(R, "_measure_d2h_mbps", _fake_measure)
    monkeypatch.setenv("MM2TPU_FLOW_MIN_MBPS", "50")
    R._PROBE_MEM.clear()
    mi, mo = _runtime()
    rt = DeviceRuntime(mi, mo)
    rt._on_cpu = False
    assert rt._calibrate() == (True, 123.0)
    assert calls == [1]
    assert link_state.load()["probe"]["mbps"] == 123.0
    rt2 = DeviceRuntime(mi, mo)
    rt2._on_cpu = False
    monkeypatch.setenv("MM2TPU_FLOW_MIN_MBPS", "500")
    assert rt2._calibrate() == (False, 123.0)   # cached figure, new bar
    assert calls == [1]
    R._PROBE_MEM.clear()


def test_oversized_reads_take_fast_path(state_file, monkeypatch, _runtime,
                                        seeded):
    """Reads beyond the flow's buckets (~21 kb) must ride the native fast
    path in device mode, not strand on the staged Python align — and the
    adaptive device share must never claim them (they are not
    flow-absorbable)."""
    import numpy as np
    from minimap2_chaindp_tpu.native import map_unit_ok
    monkeypatch.setenv("MM2TPU_NATIVE_CHAIN_MAX", "2048")
    mi, mo = _runtime()
    if not map_unit_ok(mo, mi):
        pytest.skip("no native lib")
    rng = np.random.default_rng(8)
    from minimap2_chaindp_tpu.io.fastx import SeqRecord
    ref = seeded.contig(0)
    # a 50 kb read
    frags = [Frag([SeqRecord("big", ref[100_000:150_000])])]
    # plus normal fast-path reads
    for i in range(4):
        st = int(rng.integers(0, len(ref) - 1000))
        frags.append(Frag([SeqRecord(f"s{i}", ref[st:st + 1000])]))
    rt = DeviceRuntime(mi, mo)
    rt._flow_share = 0.9          # aggressive device share
    out = rt.map_batch(frags)
    assert rt.timers.counters.get("fast_native", 0) >= 1
    # identity with the host pipeline
    from minimap2_chaindp_tpu.models.pipeline import map_fragment_output
    host = [map_fragment_output(mi, mo, f.segs) for f in frags]
    assert [l for ls in out for l in ls] == [l for ls in host for l in ls]


def test_controller_converges_and_retires(state_file, _runtime):
    """Drive the real controller: (a) measured rates override the seed and
    converge toward dev_rate/(dev+host); (b) two consecutive ~zero-target
    sub-rounds retire the lane and persist the verdict for the workload
    key; (c) a winning lane is never retired."""
    mi, mo = _runtime()
    rt = DeviceRuntime(mi, mo)
    rt._on_cpu = False
    rt._wkey = "rl10"
    rt.link_mbps = 3.0
    rt._flow_share = 0.5  # badly mis-seeded

    # healthy lanes: dev maps 32 reads in 0.1 s, host 32 in 0.3 s ->
    # target 0.75; the share must move toward it and never strike
    for _ in range(4):
        rt._ctrl_update(32, 0.1, 32, 0.3)
    assert 0.6 < rt._flow_share <= 0.95
    assert rt._lowshare_strikes == 0 and rt.device_flow
    assert link_state.fresh(link_state.load().get("share:rl10"), 90)

    # losing lane: dev maps 2 reads in 4 s while host does 62 in 0.1 s
    rt._ctrl_update(2, 4.0, 62, 0.1)
    assert rt.device_flow and rt._lowshare_strikes == 1  # one strike only
    rt._ctrl_update(2, 4.0, 62, 0.1)
    assert rt._retired and not rt.device_flow
    assert link_state.fresh(link_state.load().get("retired:rl10"),
                            link_state.RETIRE_TTL_S)
    # the delegate path now takes over whole batches
    assert rt._host_delegate_ok()
