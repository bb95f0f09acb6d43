"""Simulation-based accuracy regression (the reference's mapeval strategy,
SURVEY.md §4.5): simulate reads with pbsim-style truth names from MT-human,
map them with the pipeline, and evaluate with our own paftools mapeval."""
import io
import os
import sys

import numpy as np

from conftest import ref_input
from minimap2_chaindp_tpu import constants as C
from minimap2_chaindp_tpu.options import set_opt
from minimap2_chaindp_tpu.io.fastx import read_fastx
from minimap2_chaindp_tpu.index.build import build_index
from minimap2_chaindp_tpu.models.pipeline import map_fragment_output
from minimap2_chaindp_tpu.io.fastx import Frag
from minimap2_chaindp_tpu.tools import paftools as pt

BASES = "ACGT"


def simulate(ref_seq, n, read_len, err, seed):
    """pbsim-style reads: name = orig!chr!st!en!strand."""
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(n):
        st = int(rng.integers(0, len(ref_seq) - read_len))
        en = st + read_len
        seq = list(ref_seq[st:en])
        out = []
        for c in seq:
            r = rng.random()
            if r < err * 0.6:
                out.append(BASES[int(rng.integers(0, 4))])
            elif r < err * 0.8:
                pass  # deletion
            elif r < err:
                out.append(c)
                out.append(BASES[int(rng.integers(0, 4))])
            else:
                out.append(c)
        strand = "+" if rng.random() < 0.5 else "-"
        s = "".join(out)
        if strand == "-":
            s = s[::-1].translate(str.maketrans("ACGT", "TGCA"))
        reads.append((f"S1_{i}!MT_human!{st}!{en}!{strand}", s))
    return reads


def test_mapeval_simulated_accuracy(tmp_path):
    refs = list(read_fastx(ref_input("MT-human.fa")))
    io_, mo = set_opt("map-ont")
    mo.flag |= C.MM_F_OUT_CG | C.MM_F_CIGAR
    mi = build_index([r.name for r in refs], [r.seq for r in refs],
                     io_.w, io_.k, io_.flag, io_.bucket_bits)
    mo.update(mi)
    reads = simulate(refs[0].seq, 60, 1000, 0.10, seed=7)
    paf = []
    for name, seq in reads:
        rec = type(refs[0])(name, seq)
        paf.extend(map_fragment_output(mi, mo, [rec]))
    p = tmp_path / "sim.paf"
    p.write_text("\n".join(paf) + "\n")

    out, err_ = io.StringIO(), io.StringIO()
    so, se = sys.stdout, sys.stderr
    sys.stdout, sys.stderr = out, err_
    try:
        pt.main(["mapeval", str(p)])
    finally:
        sys.stdout, sys.stderr = so, se
    rows = [l.split("\t") for l in out.getvalue().splitlines()]
    # cumulative line: Q q_out sum_tot sum_err err_frac total
    last = rows[-1]
    assert last[0] == "Q"
    total, errs = int(last[5]), round(float(last[4]) * int(last[5]))
    assert total == 60          # every read mapped
    assert errs == 0            # and mapped to the right place
    # mapq-60 bucket holds the vast majority
    assert int(rows[0][1]) == 60 and int(rows[0][2]) >= 55
