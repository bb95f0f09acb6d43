"""Device runtime (CPU backend: the plain chaining pass) must produce output
bit-identical to the host pipeline."""
import os

import numpy as np
import pytest

from conftest import ref_input
from minimap2_chaindp_tpu import constants as C
from minimap2_chaindp_tpu.options import set_opt
from minimap2_chaindp_tpu.io.fastx import read_fastx, read_frags, Frag
from minimap2_chaindp_tpu.index.build import build_index
from minimap2_chaindp_tpu.models.pipeline import map_fragment_output
from minimap2_chaindp_tpu.models.runtime import DeviceRuntime

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _host_lines(mi, mo, frags):
    out = []
    for f in frags:
        out.extend(map_fragment_output(mi, mo, f.segs))
    return out


@pytest.mark.parametrize("preset,flags", [
    (None, C.MM_F_OUT_SAM | C.MM_F_CIGAR),
    ("map-pb", C.MM_F_OUT_SAM | C.MM_F_CIGAR),
    (None, C.MM_F_OUT_CG | C.MM_F_CIGAR),
])
def test_device_runtime_matches_host(seeded, preset, flags):
    """Seeded genome + simulated reads through the device runtime."""
    mi, mo = seeded.index(preset)
    mo.flag |= flags
    frags = seeded.frags()
    rt = DeviceRuntime(mi, mo)
    dev_lines = [l for ls in rt.map_batch(frags) for l in ls]
    assert dev_lines == _host_lines(mi, mo, frags)
    assert rt.timers.counters.get("device_reads", 0) > 0


@pytest.mark.parametrize("ref_fa,q_fa", [("MT-human.fa", "MT-orang.fa"),
                                         ("t-inv.fa", "q-inv.fa")])
def test_device_runtime_matches_host_reference_inputs(ref_fa, q_fa):
    io, mo = set_opt(None)
    mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR
    refs = list(read_fastx(ref_input(ref_fa)))
    mi = build_index([r.name for r in refs], [r.seq for r in refs],
                     io.w, io.k, io.flag, io.bucket_bits)
    mo.update(mi)
    frags = [Frag([q]) for q in read_fastx(ref_input(q_fa))]
    rt = DeviceRuntime(mi, mo)
    dev_lines = [l for ls in rt.map_batch(frags) for l in ls]
    assert dev_lines == _host_lines(mi, mo, frags)


def _run_device_vs_host(preset, ref_fa, query_fas, flags):
    io, mo = set_opt(preset)
    mo.flag |= flags
    refs = list(read_fastx(ref_fa))
    mi = build_index([r.name for r in refs], [r.seq for r in refs],
                     io.w, io.k, io.flag, io.bucket_bits)
    mo.update(mi)
    frag_mode = len(query_fas) > 1
    frags = [f for b in read_frags(query_fas, mo.mini_batch_size, frag_mode)
             for f in b]
    rt = DeviceRuntime(mi, mo)
    dev = [l for ls in rt.map_batch(frags) for l in ls]
    assert dev == _host_lines(mi, mo, frags)
    return rt


def test_device_runtime_splice():
    """Splice preset through the device runtime: is_cdna chaining on the
    device, exts2 extension on the host; identical to the host pipeline."""
    rt = _run_device_vs_host(
        "splice", os.path.join(DATA, "splice_genome.fa"),
        [os.path.join(DATA, "splice_cdna.fa")],
        C.MM_F_OUT_SAM | C.MM_F_CIGAR)
    assert rt.timers.counters.get("device_reads", 0) > 0


def test_device_runtime_paired_end(seeded, tmp_path):
    """sr paired-end over the seeded genome (multi-seg units, many_segs
    chaining on the device, PE pairing)."""
    ref = seeded.contig(0)
    rng = np.random.default_rng(3)
    comp = str.maketrans("ACGT", "TGCA")
    r1p, r2p = tmp_path / "p_1.fq", tmp_path / "p_2.fq"
    with open(r1p, "w") as f1, open(r2p, "w") as f2:
        for i in range(24):
            ins = int(rng.integers(300, 600))
            st = int(rng.integers(0, len(ref) - ins))
            r1 = ref[st:st + 150]
            r2 = ref[st + ins - 150:st + ins][::-1].translate(comp)
            f1.write(f"@p{i}\n{r1}\n+\n{'I' * 150}\n")
            f2.write(f"@p{i}\n{r2}\n+\n{'I' * 150}\n")
    rt = _run_device_vs_host("sr", seeded.ref, [str(r1p), str(r2p)],
                             C.MM_F_OUT_SAM | C.MM_F_CIGAR)
    assert rt.timers.counters.get("device_reads", 0) > 0


def test_calibrated_default_matches_host(seeded, monkeypatch):
    """No forcing variable (the CLI's default route): the CPU backend
    engages the flow without any link measurement, and the output stays
    identical to the host pipeline."""
    monkeypatch.delenv("MM2TPU_DEVICE_FLOW", raising=False)
    mi, mo = seeded.index(None)
    mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR
    frags = seeded.frags()
    rt = DeviceRuntime(mi, mo)
    assert rt.device_flow is True and rt.link_mbps is None
    dev = [l for ls in rt.map_batch(frags) for l in ls]
    assert dev == _host_lines(mi, mo, frags)


def test_runtime_spawns_no_process(seeded, monkeypatch):
    """One process per card: no runtime path starts a child process (the
    first process that opens the card reserves most of its memory)."""
    import subprocess
    monkeypatch.delenv("MM2TPU_DEVICE_FLOW", raising=False)
    spawned = []

    def _no_popen(*a, **kw):
        spawned.append(a)
        raise AssertionError("the runtime started a process")

    monkeypatch.setattr(subprocess, "Popen", _no_popen)
    mi, mo = seeded.index(None)
    mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR
    rt = DeviceRuntime(mi, mo)
    out = list(rt.map_stream(iter([seeded.frags(16), seeded.frags(8)])))
    assert [len(b) for b in out] == [16, 8]
    assert spawned == []


def test_device_flow_hpc_spans_over_127():
    """HPC minimizer spans reach 255 (reference sketch.c:111 emits any
    kmer_span < 256); the flow ships spans as ONE byte, which must be
    unsigned — an int8 wrap at >=128 silently corrupted reverse-strand
    anchor coordinates while every count-based guard still passed."""
    rng = np.random.default_rng(5)
    # run lengths 2-9 make spans STRADDLE 128 (32 below / 60 above here):
    # a uniform wrap (every span >= 128) only shifts all reverse-strand
    # ylo by the same -256, which chaining is invariant to — the mix is
    # what makes the corruption *relative* and output-visible
    bases = rng.integers(0, 4, 600)
    ref_seq = "".join("ACGT"[b] * int(rng.integers(2, 10)) for b in bases)
    io, mo = set_opt("map-pb")      # HPC preset
    mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR
    from minimap2_chaindp_tpu.index.sketch import sketch
    mv = sketch(ref_seq, io.w, io.k, 0, bool(io.flag & 1))
    spans = (np.asarray([x for x, _ in mv], dtype=np.uint64)
             & np.uint64(0xFF)).astype(int)
    assert (spans >= 128).any()     # the construction really triggers it
    mi = build_index(["hpc_ref"], [ref_seq], io.w, io.k, io.flag,
                     io.bucket_bits)
    mo.update(mi)
    # forward + revcomp queries (the wrap corrupted ylo on reverse strand)
    q_fwd = ref_seq[500:3000]
    q_rev = q_fwd[::-1].translate(str.maketrans("ACGT", "TGCA"))
    from minimap2_chaindp_tpu.io.fastx import SeqRecord
    frags = [Frag([SeqRecord("qf", q_fwd)]), Frag([SeqRecord("qr", q_rev)])]
    rt = DeviceRuntime(mi, mo)
    dev = [l for ls in rt.map_batch(frags) for l in ls]
    assert dev == _host_lines(mi, mo, frags)
    assert rt.timers.counters.get("device_reads", 0) > 0
