"""End-to-end SAM/PAF byte-identity against the reference binary's output
(@PG header line normalized away — it embeds the command line)."""
import os

import pytest

from conftest import GOLDEN_DIR, ref_input
from minimap2_chaindp_tpu import constants as C
from minimap2_chaindp_tpu.options import set_opt
from minimap2_chaindp_tpu.io.fastx import read_fastx
from minimap2_chaindp_tpu.io.output import write_sam_hdr
from minimap2_chaindp_tpu.index.build import build_index
from minimap2_chaindp_tpu.models.pipeline import map_fragment_output


def run_pipeline(ref_fa, query_fa, flags):
    io, mo = set_opt(None)
    mo.flag |= flags
    refs = list(read_fastx(ref_input(ref_fa)))
    mi = build_index([r.name for r in refs], [r.seq for r in refs],
                     io.w, io.k, io.flag, io.bucket_bits)
    mo.update(mi)
    lines = []
    if flags & C.MM_F_OUT_SAM:
        lines.extend(write_sam_hdr(mi, None, "2.10-r761", None).split("\n"))
    for q in read_fastx(ref_input(query_fa)):
        lines.extend(map_fragment_output(mi, mo, [q]))
    return lines


def load_golden(name):
    with open(os.path.join(GOLDEN_DIR, name)) as f:
        return [l.rstrip("\n") for l in f if not l.startswith("@PG")]


def compare(golden_file, ref_fa, query_fa, flags):
    golden = load_golden(golden_file)
    mine = [l for l in run_pipeline(ref_fa, query_fa, flags) if not l.startswith("@PG")]
    assert len(mine) == len(golden), \
        f"line count {len(mine)} != {len(golden)}\nmine={mine[:3]}\ngold={golden[:3]}"
    for i, (m, g) in enumerate(zip(mine, golden)):
        assert m == g, f"line {i} differs:\nmine={m[:400]}\ngold={g[:400]}"


SAM_FLAGS = C.MM_F_OUT_SAM | C.MM_F_CIGAR
PAF_CG_FLAGS = C.MM_F_OUT_CG | C.MM_F_CIGAR


def test_t2_sam():
    compare("t2.sam", "t2.fa", "q2.fa", SAM_FLAGS)


def test_mt_sam():
    compare("mt.sam", "MT-human.fa", "MT-orang.fa", SAM_FLAGS)


def test_mt_paf_cigar():
    compare("mt.paf", "MT-human.fa", "MT-orang.fa", PAF_CG_FLAGS)


def test_mt_paf_nocigar():
    compare("mt.nocig.paf", "MT-human.fa", "MT-orang.fa", 0)


def test_inv_sam():
    compare("inv.sam", "t-inv.fa", "q-inv.fa", SAM_FLAGS)
