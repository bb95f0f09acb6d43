"""HostRuntime (batched host mapping, models/host_runtime.py) must produce
byte-identical output to the per-fragment host pipeline — the same identity
the device runtime asserts, here for the no-device wave-batched path."""
import pytest

from conftest import ref_input
from minimap2_chaindp_tpu import constants as C
from minimap2_chaindp_tpu.options import set_opt
from minimap2_chaindp_tpu.io.fastx import Frag, read_fastx
from minimap2_chaindp_tpu.index.build import build_index
from minimap2_chaindp_tpu.models.host_runtime import HostRuntime
from minimap2_chaindp_tpu.models.pipeline import map_fragment_output


def _build(ref_fa, preset=None, extra_flags=0):
    io, mo = set_opt(preset)
    mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR | extra_flags
    refs = list(read_fastx(ref_input(ref_fa)))
    mi = build_index([r.name for r in refs], [r.seq for r in refs],
                     io.w, io.k, io.flag, io.bucket_bits)
    mo.update(mi)
    return mi, mo


def _identity(mi, mo, frags):
    rt = HostRuntime(mi, mo)
    batched = rt.map_batch(frags)
    serial = [map_fragment_output(mi, mo, f.segs) for f in frags]
    assert batched == serial


@pytest.mark.parametrize("preset", [None, "map-pb", "map-ont"])
def test_seeded_identity(seeded, preset):
    """Seeded genome and reads (conftest) under three presets."""
    mi, mo = seeded.index(preset)
    mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR
    _identity(mi, mo, seeded.frags())


def test_mt_identity():
    mi, mo = _build("MT-human.fa")
    frags = [Frag([q]) for q in
             read_fastx(ref_input("MT-orang.fa"))]
    _identity(mi, mo, frags)


def test_inv_identity():
    mi, mo = _build("t-inv.fa")
    frags = [Frag([q]) for q in
             read_fastx(ref_input("q-inv.fa"))]
    _identity(mi, mo, frags)


def test_map_stream_order():
    mi, mo = _build("t2.fa")
    qs = list(read_fastx(ref_input("q2.fa")))
    frags = [Frag([q]) for q in qs]
    rt = HostRuntime(mi, mo)
    batches = [frags, frags]
    out = list(rt.map_stream(iter(batches)))
    assert len(out) == 2 and out[0] == out[1]
    assert out[0] == [map_fragment_output(mi, mo, f.segs) for f in frags]
