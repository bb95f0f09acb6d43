import os
import sys

# Tests run on a virtual 8-device CPU mesh so multi-device sharding paths
# are exercised without a GPU; tests that need the card are marked `gpu`
# and run on it through chip_smoke.py (README "Tests").
os.environ["JAX_PLATFORMS"] = "cpu"
# jax may already be imported (it latches env vars at import), so also
# override through jax.config before first backend use.
import jax  # noqa: E402
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Device-runtime tests validate the DEVICE chaining path; disable the
# native-chain crossover routing so small test reads still exercise it
# (the native paths are covered by the host-pipeline golden tests and the
# dedicated native parity tests).
os.environ.setdefault("MM2TPU_NATIVE_CHAIN_MAX", "0")

# Hermetic tests: never read/write the persisted link/controller state a
# device run may have left (utils/link_state) — a stale retirement
# verdict must not steer CPU-backend routing.
os.environ["MM2TPU_STATE_FILE"] = ""

# the reference checkout's own test inputs (MT-human.fa, ...): the pinned
# goldens in tests/golden/ were made from them; tests that need them skip
# where the checkout is absent
REF_TEST_DIR = "/root/reference/test"
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def ref_input(name: str) -> str:
    """Path of a reference-checkout test input; skips the calling test
    (or module-scoped fixture) when the file is not on this machine."""
    import pytest
    path = os.path.join(REF_TEST_DIR, name)
    if not os.path.exists(path):
        pytest.skip(f"reference test input {name} is not on this machine")
    return path

# Build the compiled-reference oracles on demand so a fresh checkout runs the
# full oracle-backed suites instead of skipping them (each oracle module's
# skipif evaluates at import time, after this). A failed build (no reference
# tree / toolchain) leaves the artifacts absent and those suites skip; the
# failure is cached in a marker file so later sessions do not silently
# re-pay the build timeout (ADVICE r4) — delete .golden/.build_failed to
# retry after fixing the toolchain.
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FAIL_MARK = os.path.join(_ROOT, ".golden", ".build_failed")
if (not os.path.exists(os.path.join(_ROOT, ".golden", "minimap2_ref"))
        and not os.path.exists(_FAIL_MARK)
        and os.path.isdir("/root/reference")):
    import subprocess
    print("[conftest] building compiled-reference oracles (one-off)...",
          file=sys.stderr)
    try:
        subprocess.run(
            ["bash", os.path.join(_ROOT, "golden", "build_reference.sh")],
            capture_output=True, timeout=600)
    except Exception:
        pass
    if not os.path.exists(os.path.join(_ROOT, ".golden", "minimap2_ref")):
        print("[conftest] oracle build FAILED; oracle-backed suites will "
              f"skip (rm {_FAIL_MARK} to retry)", file=sys.stderr)
        os.makedirs(os.path.dirname(_FAIL_MARK), exist_ok=True)
        open(_FAIL_MARK, "w").close()

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long suites the default smoke tier skips — run with "
        "MM2TPU_FULL=1 or -m slow")
    config.addinivalue_line(
        "markers",
        "gpu: needs the GPU (CUDA kernels have no CPU mode); skips "
        "elsewhere — chip_smoke.py runs them on the card")


def pytest_collection_modifyitems(config, items):
    """Two test tiers (SURVEY §4 test strategy): the default smoke tier
    (<2 min) runs every byte-identity-critical suite; the slow tier adds
    the long ones. Select the full run with MM2TPU_FULL=1 or an explicit
    -m expression."""
    if os.environ.get("MM2TPU_FULL") == "1" or config.getoption("-m"):
        return
    skip = pytest.mark.skip(
        reason="slow tier (MM2TPU_FULL=1 or -m slow to run)")
    for it in items:
        if "slow" in it.keywords:
            it.add_marker(skip)


@pytest.fixture
def gpu_backend():
    """Skip unless JAX's default backend is a GPU (decided at run time, in
    the test, so every worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs the GPU: run through chip_smoke.py on the card")


class Seeded:
    """A small repeat-seeded genome and simulated reads, written from fixed
    seeds (tools/genome_scale.py), for tests that compare two of this
    repo's own paths (batch vs per-read, device vs host, mesh vs host,
    steal vs host)."""

    def __init__(self, d):
        sys.path.insert(0, os.path.join(_ROOT, "tools"))
        import genome_scale as G
        self.dir = str(d)
        self.ref = os.path.join(self.dir, "genome.fa")
        self.reads = os.path.join(self.dir, "reads.fa")
        G.make_genome(self.ref, n_contigs=2, contig_len=1_000_000, seed=11)
        G.simulate(self.ref, self.reads, 48, 2500, 0.10, seed=12)
        self._idx = {}

    def index(self, preset=None):
        """(mi, mo) for the genome under `preset`, built once per preset."""
        from minimap2_chaindp_tpu.index.build import build_index
        from minimap2_chaindp_tpu.io.fastx import read_fastx
        from minimap2_chaindp_tpu.options import set_opt
        if preset not in self._idx:
            io, mo = set_opt(preset)
            refs = list(read_fastx(self.ref))
            self._idx[preset] = (refs, build_index(
                [r.name for r in refs], [r.seq for r in refs],
                io.w, io.k, io.flag, io.bucket_bits))
        refs, mi = self._idx[preset]
        _, mo = set_opt(preset)
        mo.update(mi)
        return mi, mo

    def unique_index(self, preset=None):
        """(mi, mo, seq) for one repeat-free random 200 kb contig made from
        the same seed: construction-truth tests need unique placements."""
        import numpy as np
        from minimap2_chaindp_tpu.index.build import build_index
        from minimap2_chaindp_tpu.options import set_opt
        key = ("unique", preset)
        if key not in self._idx:
            rng = np.random.default_rng(13)
            seq = np.frombuffer(b"ACGT", np.uint8)[
                rng.integers(0, 4, 200_000)].tobytes().decode()
            io, _ = set_opt(preset)
            self._idx[key] = (seq, build_index(
                ["uniq"], [seq], io.w, io.k, io.flag, io.bucket_bits))
        seq, mi = self._idx[key]
        _, mo = set_opt(preset)
        mo.update(mi)
        return mi, mo, seq

    def contig(self, k=0) -> str:
        from minimap2_chaindp_tpu.io.fastx import read_fastx
        return list(read_fastx(self.ref))[k].seq

    def frags(self, n=None):
        from minimap2_chaindp_tpu.io.fastx import Frag, read_fastx
        return [Frag([q]) for q in read_fastx(self.reads)][:n]


@pytest.fixture(scope="session")
def seeded(tmp_path_factory):
    return Seeded(tmp_path_factory.mktemp("seeded"))
