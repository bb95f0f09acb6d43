"""Multi-chip mesh mapping, end to end: the sharded flow step (count psum
+ capacity-bounded hit all-gather + data-parallel chaining) must produce
byte-identical output to the single-chip flow, to the host path and to the
pinned reference golden, running over the virtual 8-device CPU mesh
(conftest)."""
import os
import subprocess
import sys

import numpy as np

from conftest import GOLDEN_DIR, ref_input

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(args, env_extra=None):
    env = dict(os.environ)
    env.update(env_extra or {})
    out = subprocess.run(
        [sys.executable, "-m", "minimap2_chaindp_tpu.cli", *args],
        capture_output=True, text=True, cwd=ROOT, env=env, check=True)
    return [l for l in out.stdout.split("\n") if not l.startswith("@PG")]


def test_mesh_mt_sam_golden():
    """MT pair over --mesh 4x2 == pinned reference golden, byte for byte."""
    got = _cli(["-a", "--device", "gpu", "--mesh", "4x2",
                ref_input("MT-human.fa"), ref_input("MT-orang.fa")])
    with open(os.path.join(GOLDEN_DIR, "mt.sam")) as f:
        want = [l for l in f.read().split("\n") if not l.startswith("@PG")]
    assert got == want


def test_mesh_seeded_matches_host(seeded):
    """Seeded genome and reads over --mesh 2x4 (index key-range-sharded 4
    ways) == --device host, byte for byte, through the CLI."""
    got = _cli(["-ax", "map-pb", "--device", "gpu", "--mesh", "2x4",
                seeded.ref, seeded.reads])
    want = _cli(["-ax", "map-pb", "--device", "host", seeded.ref,
                 seeded.reads])
    assert sum(1 for l in want if l and not l.startswith("@")) >= 48
    assert got == want


def test_mesh_matches_single_chip_flow(seeded):
    """Sharded flow vs single-chip flow on simulated reads (both through
    DeviceFlow.run on the CPU backend): identical Chains and SeedHits."""
    from minimap2_chaindp_tpu.models.pipeline import seed_unit
    from minimap2_chaindp_tpu.models.device_flow import DeviceFlow
    from minimap2_chaindp_tpu.utils.timers import Timers
    import jax
    from jax.sharding import Mesh

    mi, mo = seeded.index("map-ont")
    rng = np.random.default_rng(9)
    ref = seeded.contig(0)
    comp = str.maketrans("ACGT", "TGCA")
    reads = []
    for i in range(24):
        st = int(rng.integers(0, len(ref) - 900))
        s = "".join(c if rng.random() > 0.1
                    else "ACGT"[int(rng.integers(0, 4))]
                    for c in ref[st:st + 900])
        if rng.random() < 0.5:
            s = s[::-1].translate(comp)
        reads.append((f"m{i}", s))

    class Rec:
        def __init__(self, name, seq):
            self.name, self.seq, self.qual, self.comment = name, seq, None, None

    def run_flow(mesh):
        units = [([Rec(n, s)], seed_unit(mi, mo, [Rec(n, s)],
                                         collect_hits=False))
                 for n, s in reads]
        flow = DeviceFlow(mi, mo, guarded=False, mesh=mesh)
        res, _cold = flow.run(units, Timers())
        return units, res

    u1, r1 = run_flow(None)
    devs = np.asarray(jax.devices()[:8]).reshape(4, 2)
    u2, r2 = run_flow(Mesh(devs, ("data", "index")))
    assert set(r1.keys()) == set(r2.keys())
    assert len(r1) >= 20  # nearly all reads flow-handled
    for k in r1:
        a, b = r1[k], r2[k]
        assert np.array_equal(a.anchors, b.anchors), f"unit {k} anchors"
        assert np.array_equal(a.u, b.u), f"unit {k} chain scores"
        sh1, sh2 = u1[k][1].sh, u2[k][1].sh
        assert np.array_equal(sh1.anchors, sh2.anchors)
        assert sh1.rep_len == sh2.rep_len
        assert np.array_equal(sh1.mini_pos, sh2.mini_pos)
