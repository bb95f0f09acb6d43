"""Preset breadth: map-pb (HPC minimizers), ava-ont (all-vs-all overlap),
sr single-end and paired-end — byte-identical to the reference binary."""
import os

import pytest

from conftest import GOLDEN_DIR, ref_input
from minimap2_chaindp_tpu import constants as C
from minimap2_chaindp_tpu.options import set_opt
from minimap2_chaindp_tpu.io.fastx import read_fastx, read_frags
from minimap2_chaindp_tpu.io.output import write_sam_hdr
from minimap2_chaindp_tpu.index.build import build_index
from minimap2_chaindp_tpu.models.pipeline import map_fragment_output

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def run(preset, ref_fa, query_fas, extra_flags):
    io, mo = set_opt(preset)
    mo.flag |= extra_flags
    refs = list(read_fastx(ref_fa))
    mi = build_index([r.name for r in refs], [r.seq for r in refs],
                     io.w, io.k, io.flag, io.bucket_bits)
    mo.update(mi)
    lines = []
    if mo.flag & C.MM_F_OUT_SAM:
        lines.extend(write_sam_hdr(mi, None, "2.10-r761", None).split("\n"))
    frag_mode = len(query_fas) > 1 or bool(mo.flag & C.MM_F_FRAG_MODE)
    for batch in read_frags(query_fas, mo.mini_batch_size, frag_mode):
        for frag in batch:
            lines.extend(map_fragment_output(mi, mo, frag.segs))
    return lines


def compare(golden_file, preset, ref_fa, query_fas, extra_flags):
    with open(os.path.join(GOLDEN_DIR, golden_file)) as f:
        golden = [l.rstrip("\n") for l in f if not l.startswith("@PG")]
    mine = [l for l in run(preset, ref_fa, query_fas, extra_flags)
            if not l.startswith("@PG")]
    assert len(mine) == len(golden), f"{len(mine)} != {len(golden)} lines"
    for i, (m, g) in enumerate(zip(mine, golden)):
        assert m == g, f"line {i} differs:\nmine={m[:300]}\ngold={g[:300]}"


SAM = C.MM_F_OUT_SAM | C.MM_F_CIGAR
PAF_CG = C.MM_F_OUT_CG | C.MM_F_CIGAR


def test_mappb_sam():
    compare("mt.mappb.sam", "map-pb", ref_input("MT-human.fa"),
            [ref_input("MT-orang.fa")], SAM)


def test_mappb_paf():
    compare("mt.mappb.paf", "map-pb", ref_input("MT-human.fa"),
            [ref_input("MT-orang.fa")], PAF_CG)


def test_ava_ont():
    compare("qinv.ava.paf", "ava-ont", ref_input("q-inv.fa"),
            [ref_input("q-inv.fa")], 0)


def test_sr_single_end():
    compare("se.sr.sam", "sr", ref_input("MT-human.fa"),
            [os.path.join(DATA, "pe_1.fq")], SAM)


def test_sr_paired_end_paf():
    compare("pe.sr.paf", "sr", ref_input("MT-human.fa"),
            [os.path.join(DATA, "pe_1.fq"), os.path.join(DATA, "pe_2.fq")], 0)


def test_sr_paired_end_sam():
    compare("pe.sr.sam", "sr", ref_input("MT-human.fa"),
            [os.path.join(DATA, "pe_1.fq"), os.path.join(DATA, "pe_2.fq")], SAM)


def test_splice_sam():
    compare("splice.sam", "splice", os.path.join(DATA, "splice_genome.fa"),
            [os.path.join(DATA, "splice_cdna.fa")], SAM)


def test_splice_paf():
    compare("splice.paf", "splice", os.path.join(DATA, "splice_genome.fa"),
            [os.path.join(DATA, "splice_cdna.fa")], PAF_CG)


def test_sdust_T20_sam():
    """-T 20 low-complexity minimizer masking changes seeds; still byte-identical."""
    io, mo = set_opt("map-ont")
    mo.flag |= SAM
    mo.sdust_thres = 20
    refs = list(read_fastx(ref_input("MT-human.fa")))
    mi = build_index([r.name for r in refs], [r.seq for r in refs],
                     io.w, io.k, io.flag, io.bucket_bits)
    mo.update(mi)
    lines = write_sam_hdr(mi, None, "2.10-r761", None).split("\n")
    for batch in read_frags([ref_input("MT-orang.fa")],
                            mo.mini_batch_size, False):
        for frag in batch:
            lines.extend(map_fragment_output(mi, mo, frag.segs))
    with open(os.path.join(GOLDEN_DIR, "mt.T20.sam")) as f:
        golden = [l.rstrip("\n") for l in f if not l.startswith("@PG")]
    mine = [l for l in lines if l and not l.startswith("@PG")]
    assert mine == golden


def test_asm20_sam():
    compare("mt.asm20.sam", "asm20", ref_input("MT-human.fa"),
            [ref_input("MT-orang.fa")], SAM)


def test_asm5_no_hits():
    """asm5 (<5% divergence) finds nothing on the ~13%-divergent MT pair —
    matching the reference's empty PAF."""
    lines = run("asm5", ref_input("MT-human.fa"),
                [ref_input("MT-orang.fa")], PAF_CG)
    assert lines == []
