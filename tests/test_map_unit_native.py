"""Differential tests for the one-call native per-read map path
(native/align_driver.cc mm2tpu_map_unit_text): byte-identical output vs
the staged Python pipeline (the golden model) on simulated reads, across
output modes, case-masking, and quality strings."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

from minimap2_chaindp_tpu import constants as C
from minimap2_chaindp_tpu import native
from minimap2_chaindp_tpu.index.build import build_index
from minimap2_chaindp_tpu.io.fastx import Frag, read_fastx
from minimap2_chaindp_tpu.models.host_runtime import HostRuntime
from minimap2_chaindp_tpu.options import set_opt

BASES = "ACGT"


def _simulate(ref_seq, n, read_len, err, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        st = int(rng.integers(0, len(ref_seq) - read_len))
        seq = []
        for ch in ref_seq[st:st + read_len]:
            r = rng.random()
            if r < err * 0.6:
                seq.append(BASES[int(rng.integers(0, 4))])
            elif r < err * 0.8:
                pass
            elif r < err:
                seq.append(ch)
                seq.append(BASES[int(rng.integers(0, 4))])
            else:
                seq.append(ch)
        s = "".join(seq)
        if rng.random() < 0.5:
            s = s[::-1].translate(str.maketrans("ACGT", "TGCA"))
        if i % 5 == 1:
            s = s.lower()
        out.append((f"r{i}", s))
    return out


@pytest.fixture(scope="module")
def mt_index(seeded):
    """map-ont index of the seeded genome (conftest), plus its contigs."""
    mi, _ = seeded.index("map-ont")
    return list(read_fastx(seeded.ref)), mi


@pytest.mark.parametrize("out_flags", [
    C.MM_F_CIGAR | C.MM_F_OUT_SAM,
    C.MM_F_CIGAR,                                    # PAF + cg implied off
    C.MM_F_CIGAR | C.MM_F_OUT_CG,
    C.MM_F_CIGAR | C.MM_F_OUT_SAM | C.MM_F_OUT_CS,
    C.MM_F_CIGAR | C.MM_F_OUT_MD,
    0,                                               # PAF, no alignment
])
def test_fast_path_matches_python(mt_index, out_flags, monkeypatch):
    if native.load_ksw() is None:
        pytest.skip("native lib unavailable")
    refs, mi = mt_index
    _, mo = set_opt("map-ont")
    mo.flag |= out_flags
    mo.update(mi)
    reads = _simulate(refs[0].seq, 25, 800, 0.12, seed=3)
    frags = [Frag([type(refs[0])(n, s)]) for n, s in reads]

    rt = HostRuntime(mi, mo)
    fast = rt.map_batch(frags)
    assert rt.timers.counters.get("fast_native", 0) > 0

    monkeypatch.setenv("MM2TPU_NATIVE_SKELETON", "0")
    rt2 = HostRuntime(mi, mo)
    slow = rt2.map_batch(frags)
    assert fast == slow


def test_fast_path_fastq_qual(mt_index, monkeypatch):
    if native.load_ksw() is None:
        pytest.skip("native lib unavailable")
    refs, mi = mt_index
    _, mo = set_opt("map-ont")
    mo.flag |= C.MM_F_CIGAR | C.MM_F_OUT_SAM | C.MM_F_COPY_COMMENT
    mo.update(mi)
    reads = _simulate(refs[0].seq, 12, 600, 0.1, seed=9)
    frags = []
    for n, s in reads:
        qual = "".join(chr(33 + (j * 3) % 40) for j in range(len(s)))
        frags.append(Frag([type(refs[0])(n, s, qual, "xx:Z:comment")]))

    rt = HostRuntime(mi, mo)
    fast = rt.map_batch(frags)
    monkeypatch.setenv("MM2TPU_NATIVE_SKELETON", "0")
    slow = HostRuntime(mi, mo).map_batch(frags)
    assert fast == slow


@pytest.mark.parametrize("sam", [True, False])
def test_fast_path_paired_end(mt_index, sam, monkeypatch):
    """2-segment native path (mm2tpu_map_frag_pe) vs the Python pipeline."""
    if native.load_ksw() is None:
        pytest.skip("native lib unavailable")
    refs, mi = mt_index
    rng = np.random.default_rng(17)
    seq = refs[0].seq
    rc = lambda s: s[::-1].translate(str.maketrans("ACGT", "TGCA"))
    frags = []
    for i in range(30):
        st = int(rng.integers(0, len(seq) - 500))
        frag = seq[st:st + int(rng.integers(250, 500))]
        r1 = frag[:120]
        r2 = rc(frag)[:120]
        frags.append(Frag([type(refs[0])(f"q{i}/1", r1, "I" * len(r1)),
                           type(refs[0])(f"q{i}/2", r2, "I" * len(r2))]))
    from minimap2_chaindp_tpu.options import set_opt as so
    _, mo = so("sr")
    mi_sr = mi
    io_, _ = so("sr")
    refs2, _ = mt_index
    mi_sr = build_index([r.name for r in refs2], [r.seq for r in refs2],
                        io_.w, io_.k, io_.flag, io_.bucket_bits)
    mo.flag |= C.MM_F_CIGAR | (C.MM_F_OUT_SAM if sam else 0)
    mo.update(mi_sr)
    rt = HostRuntime(mi_sr, mo)
    fast = rt.map_batch(frags)
    assert rt.timers.counters.get("fast_native", 0) == len(frags)
    monkeypatch.setenv("MM2TPU_NATIVE_SKELETON", "0")
    slow = HostRuntime(mi_sr, mo).map_batch(frags)
    assert fast == slow


def test_fast_path_region_mode(mt_index):
    """map_unit (region mode, the mappy path) agrees with map_frag."""
    if native.load_ksw() is None:
        pytest.skip("native lib unavailable")
    import os as _os
    refs, mi = mt_index
    _, mo = set_opt("map-ont")
    mo.flag |= C.MM_F_CIGAR
    mo.update(mi)
    reads = _simulate(refs[0].seq, 10, 700, 0.1, seed=5)
    from minimap2_chaindp_tpu.models.pipeline import map_frag
    from minimap2_chaindp_tpu.io.fastx import SeqRecord
    for n, s in reads:
        fast = map_frag(mi, mo, [SeqRecord(n, s)])
        _os.environ["MM2TPU_NATIVE_SKELETON"] = "0"
        try:
            slow = map_frag(mi, mo, [SeqRecord(n, s)])
        finally:
            del _os.environ["MM2TPU_NATIVE_SKELETON"]
        assert len(fast) == len(slow)
        for fr, sr_ in zip(fast, slow):
            for a, b in zip(fr, sr_):
                assert (a.qs, a.qe, a.rs, a.re, a.mapq, a.score,
                        a.blen, a.mlen, a.div) == \
                       (b.qs, b.qe, b.rs, b.re, b.mapq, b.score,
                        b.blen, b.mlen, b.div)
                pa = a.p.cigar if a.p else None
                pb = b.p.cigar if b.p else None
                assert pa == pb


def test_large_reference_consistency(monkeypatch):
    """References beyond the fork's 2 Mbp-contig limit (SURVEY §2): the
    stock 64-bit anchor encoding must keep working; fast path == Python."""
    if native.load_ksw() is None:
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(11)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    seq = bases[rng.integers(0, 4, 3_000_000)].tobytes().decode()
    io_, mo = set_opt("map-ont")
    mo.flag |= C.MM_F_CIGAR | C.MM_F_OUT_SAM
    mi = build_index(["big"], [seq], io_.w, io_.k, io_.flag, io_.bucket_bits)
    mo.update(mi)
    from minimap2_chaindp_tpu.io.fastx import SeqRecord
    reads = []
    for i in range(8):
        st = int(rng.integers(0, len(seq) - 5000))
        s = list(seq[st:st + 5000])
        for j in range(0, len(s), 17):
            s[j] = "ACGT"[int(rng.integers(0, 4))]
        reads.append(Frag([SeqRecord(f"big{i}", "".join(s))]))
    rt = HostRuntime(mi, mo)
    fast = rt.map_batch(reads)
    assert rt.timers.counters.get("fast_native", 0) == len(reads)
    # at least one hit lands beyond the fork's 2^21 coordinate limit
    pos = [int(l.split("\t")[3]) for lines in fast for l in lines
           if not l.split("\t")[2] == "*"]
    assert pos and max(pos) > 2_097_152
    monkeypatch.setenv("MM2TPU_NATIVE_SKELETON", "0")
    slow = HostRuntime(mi, mo).map_batch(reads)
    assert fast == slow


def test_fast_path_paired_end_sdust(mt_index, monkeypatch):
    """PE -T masking on the native path replays the reference's
    post-offset quirk (map.c:94-96) — byte-equal to the Python pipeline."""
    if native.load_ksw() is None:
        pytest.skip("native lib unavailable")
    refs, mi = mt_index
    rng = np.random.default_rng(23)
    seq = refs[0].seq
    rc = lambda s: s[::-1].translate(str.maketrans("ACGT", "TGCA"))
    frags = []
    for i in range(24):
        st = int(rng.integers(0, len(seq) - 500))
        frag = seq[st:st + int(rng.integers(250, 500))]
        r1, r2 = frag[:130], rc(frag)[:130]
        if i % 3 == 0:  # inject low-complexity runs so the mask fires
            r1 = r1[:40] + "A" * 40 + r1[80:]
        if i % 4 == 0:
            r2 = r2[:50] + "AT" * 25 + r2[100:]
        frags.append(Frag([type(refs[0])(f"q{i}/1", r1, "I" * len(r1)),
                           type(refs[0])(f"q{i}/2", r2, "I" * len(r2))]))
    from minimap2_chaindp_tpu.options import set_opt as so
    io_, mo = so("sr")
    mi_sr = build_index([r.name for r in refs], [r.seq for r in refs],
                        io_.w, io_.k, io_.flag, io_.bucket_bits)
    mo.flag |= C.MM_F_CIGAR | C.MM_F_OUT_SAM
    mo.sdust_thres = 20
    mo.update(mi_sr)
    rt = HostRuntime(mi_sr, mo)
    fast = rt.map_batch(frags)
    assert rt.timers.counters.get("fast_native", 0) == len(frags)
    monkeypatch.setenv("MM2TPU_NATIVE_SKELETON", "0")
    slow = HostRuntime(mi_sr, mo).map_batch(frags)
    assert fast == slow


def test_fast_path_paired_end_splice(monkeypatch):
    """Splice PE on the native path (two-round strand selection, cdna
    chaining, noncan signal costs per segment) vs the Python pipeline."""
    if native.load_ksw() is None:
        pytest.skip("native lib unavailable")
    import os as _os
    from minimap2_chaindp_tpu.io.fastx import read_fastx
    from minimap2_chaindp_tpu.options import set_opt as so
    data = _os.path.join(_os.path.dirname(__file__), "data")
    genome = list(read_fastx(_os.path.join(data, "splice_genome.fa")))
    cdnas = list(read_fastx(_os.path.join(data, "splice_cdna.fa")))
    rc = lambda s: s[::-1].translate(str.maketrans("ACGT", "TGCA"))
    frags = []
    for r in cdnas:
        if len(r.seq) < 260:
            continue
        a, b = r.seq[:150], rc(r.seq[-150:])
        frags.append(Frag([type(r)(f"{r.name}/1", a, "I" * len(a)),
                           type(r)(f"{r.name}/2", b, "I" * len(b))]))
    assert frags
    io_, mo = so("splice")
    mi = build_index([g.name for g in genome], [g.seq for g in genome],
                     io_.w, io_.k, io_.flag, io_.bucket_bits)
    mo.flag |= C.MM_F_CIGAR | C.MM_F_OUT_SAM
    mo.update(mi)
    rt = HostRuntime(mi, mo)
    fast = rt.map_batch(frags)
    assert rt.timers.counters.get("fast_native", 0) == len(frags)
    monkeypatch.setenv("MM2TPU_NATIVE_SKELETON", "0")
    slow = HostRuntime(mi, mo).map_batch(frags)
    assert fast == slow
    assert any("ts:A:" in line for batch in fast for line in batch)


@pytest.mark.parametrize("out_flags", [
    C.MM_F_CIGAR | C.MM_F_OUT_SAM,
    C.MM_F_CIGAR,                                    # PAF + cg
    C.MM_F_CIGAR | C.MM_F_OUT_SAM | C.MM_F_OUT_CS,
])
def test_finish_from_chains_matches_full_map(mt_index, out_flags):
    """The device-offload text path (mm2tpu_map_unit_text_chains: native
    post-chain half fed PRECOMPUTED chains, the fork's FPGA->result_thread
    handoff) must byte-match the full one-call native map on the same
    reads — including reads with zero chains (unmapped records)."""
    if native.load_ksw() is None:
        pytest.skip("native lib unavailable")
    from minimap2_chaindp_tpu.io.fastx import SeqRecord
    from minimap2_chaindp_tpu.models.pipeline import host_chain, seed_unit
    refs, mi = mt_index
    _, mo = set_opt("map-ont")
    mo.flag |= out_flags
    mo.update(mi)
    reads = _simulate(refs[0].seq, 20, 900, 0.12, seed=17)
    reads.append(("empty_chain", "ACGT" * 30))      # no anchors -> unmapped
    n_checked = 0
    for name, seq in reads:
        rec = SeqRecord(name, seq, None, None)
        full = native.map_unit_text_native(mi, mo, rec)
        info = seed_unit(mi, mo, [rec], collect_hits=True)
        ch = host_chain(mo, info, 1)
        fin = native.map_unit_text_chains_native(
            mi, mo, rec, "", ch, info.sh.rep_len, info.sh.mini_pos)
        assert fin == full, name
        n_checked += 1
    assert n_checked == len(reads)
