"""Mesh failure posture: a stalled or banned device under `--mesh` ends
the run with the stall (DeviceStall), instead of mapping on the host in
its place.  Runs over the virtual 8-device CPU mesh (conftest)."""
import os

import pytest

from minimap2_chaindp_tpu import constants as C
from minimap2_chaindp_tpu.models.runtime import DeviceRuntime
from minimap2_chaindp_tpu.utils import device_guard as dg


def _setup(seeded):
    mi, mo = seeded.index(None)
    mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR
    return mi, mo, seeded.frags(16)


def test_mesh_stall_falls_back_to_host(seeded, monkeypatch):
    """Every device dispatch of the sharded mesh flow stalls -> the batch
    ends with the stall; no read is mapped on the host in its place."""
    mi, mo, frags = _setup(seeded)

    def _always_stall(fn, timeout_s):
        raise dg.DeviceStall("injected mesh stall")

    monkeypatch.setattr(dg, "device_call", _always_stall)
    rt = DeviceRuntime(mi, mo, mesh_shape=(4, 2))
    with pytest.raises(dg.DeviceStall, match="injected mesh stall"):
        rt.map_batch(frags)
    c = rt.timers.counters
    assert c.get("device_reads", 0) == 0
    assert c.get("host_fallback_frag", 0) == 0


def test_mesh_banned_device_fails_fast(seeded, monkeypatch):
    """With the device already marked bad (wedge detector) and the runtime
    on the GUARDED path (as on the GPU — the CPU backend bypasses the
    guard), a mesh run's first dispatch raises DeviceStall at once: zero
    device reads, and no timeout is waited out."""
    import time

    mi, mo, frags = _setup(seeded)
    monkeypatch.setattr(dg, "_bad", True)
    rt = DeviceRuntime(mi, mo, mesh_shape=(4, 2))
    rt._on_cpu = False   # the guarded (timed) dispatch path
    t0 = time.perf_counter()
    with pytest.raises(dg.DeviceStall):
        rt.map_batch(frags)
    dt = time.perf_counter() - t0
    assert rt.timers.counters.get("device_reads", 0) == 0
    assert dt < rt._dev_timeout  # failed fast, no timeout waits
