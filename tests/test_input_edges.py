"""Input-space edge regimes the bundled fixtures don't reach: soft-masked
(lowercase) FASTA and IUPAC ambiguity codes. The reference maps both
through seq_nt4_table (case-insensitive; every ambiguity code -> 4, i.e.
N) while emitting SEQ as-given (format.c:226 reads the raw bytes)."""
import os
import random

from conftest import GOLDEN_DIR, ref_input
from minimap2_chaindp_tpu import constants as C
from minimap2_chaindp_tpu.options import set_opt
from minimap2_chaindp_tpu.io.fastx import SeqRecord, read_fastx
from minimap2_chaindp_tpu.index.build import build_index
from minimap2_chaindp_tpu.models.pipeline import map_fragment_output


def _map_one(query: SeqRecord):
    io, mo = set_opt(None)
    mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR
    refs = list(read_fastx(ref_input("MT-human.fa")))
    mi = build_index([r.name for r in refs], [r.seq for r in refs],
                     io.w, io.k, io.flag, io.bucket_bits)
    mo.update(mi)
    return map_fragment_output(mi, mo, [query])


def _golden_mt_records():
    with open(os.path.join(GOLDEN_DIR, "mt.sam")) as f:
        return [l.rstrip("\n") for l in f
                if not l.startswith("@")]


def test_lowercase_query_matches_golden_modulo_seq_case():
    """Soft-masked input: mapping identical to the uppercase golden; the
    SAM SEQ column carries the original (lower) case, like the
    reference's raw-byte emission."""
    q = next(iter(read_fastx(ref_input("MT-orang.fa"))))
    lines = _map_one(SeqRecord(q.name, q.seq.lower()))
    got = [l.split("\t") for l in lines]
    want = [l.split("\t") for l in _golden_mt_records()]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[9] == w[9].lower()          # SEQ as-given
        assert g[:9] + g[10:] == w[:9] + w[10:]


def test_iupac_codes_map_like_n():
    """Every IUPAC ambiguity code is seq_nt4 code 4 — positionally
    indistinguishable from N; only SEQ (and the MD/cs tags, which
    re-fetch query bytes) may differ."""
    q = next(iter(read_fastx(ref_input("MT-orang.fa"))))
    random.seed(3)
    pos = sorted(random.sample(range(len(q.seq)), 200))
    iupac = "RYSWKMBDHV"
    s_i, s_n = list(q.seq), list(q.seq)
    for i, p in enumerate(pos):
        s_i[p] = iupac[i % len(iupac)]
        s_n[p] = "N"
    la = _map_one(SeqRecord(q.name, "".join(s_i)))
    lb = _map_one(SeqRecord(q.name, "".join(s_n)))
    assert len(la) == len(lb)

    def strip(line):
        t = line.split("\t")
        return [f for f in t[:9] + t[10:]
                if not f.startswith(("MD:Z", "cs:Z"))]

    for a, b in zip(la, lb):
        assert strip(a) == strip(b)


def test_many_output_lines_native_retry(tmp_path):
    """A read with more output records than the native text buffers'
    initial 258 line slots (-N 300 on a tandem repeat): the grow-retry
    loop must enlarge line_off alongside text_buf — the native driver
    returns the same -2 for either overflow, and a fixed line_off made
    the loop spin forever while text_buf quadrupled toward OOM."""
    import subprocess
    import sys as _sys
    import numpy as np
    rng = np.random.default_rng(7)
    unit = "".join("ACGT"[b] for b in rng.integers(0, 4, 100))
    ref = tmp_path / "tandem.fa"
    qry = tmp_path / "q.fa"
    ref.write_text(f">tand\n{unit * 300}\n")
    qry.write_text(f">q1\n{unit * 3}\n")
    out = subprocess.run(
        [_sys.executable, "-m", "minimap2_chaindp_tpu.cli", "-a",
         "-N", "300", "-p", "0.1", "--device", "host",
         str(ref), str(qry)],
        capture_output=True, text=True, timeout=300, cwd="/root/repo")
    assert out.returncode == 0, out.stderr[-500:]
    recs = [l for l in out.stdout.splitlines() if not l.startswith("@")]
    assert len(recs) > 258          # past the old fixed line_off capacity
    assert "fast_native=1" in out.stderr   # rode the native text path


def test_md_tag_on_spliced_alignment():
    """MD must advance its reference offset over N ops: a stale offset
    made every MD run after the first intron compare against intron
    bases (dense phantom mismatches). The reference cannot emit MD for
    splice at all (format.c:190 asserts op<=2); emitting the correct tag
    is the useful superset. Native and python writers must agree, and
    the match/mismatch/deletion spans must sum to the CIGAR's M total."""
    import re
    import subprocess
    import sys as _sys

    def run(env_extra):
        env = dict(os.environ, **env_extra)
        out = subprocess.run(
            [_sys.executable, "-m", "minimap2_chaindp_tpu.cli", "-ax",
             "splice", "-a", "--MD", "--device", "host",
             "tests/data/splice_genome.fa", "tests/data/splice_cdna.fa"],
            capture_output=True, text=True, timeout=300, cwd="/root/repo",
            env=env)
        assert out.returncode == 0, out.stderr[-300:]
        return [l for l in out.stdout.splitlines() if not l.startswith("@")]

    nat = run({})
    py = run({"MM2TPU_NATIVE_SKELETON": "0"})
    assert nat == py
    for line in nat:
        f = line.split("\t")
        cig = f[5]
        md = next(x[5:] for x in f[11:] if x.startswith("MD:Z:"))
        m_total = sum(int(n) for n, op in
                      re.findall(r"(\d+)([MIDNSH])", cig) if op == "M")
        md_total = sum(int(n) for n in re.findall(r"\d+", md)) \
            + len(re.findall(r"(?<!\^)[A-Z]", md.replace("^", "^ "))) \
            - sum(len(d) for d in re.findall(r"\^([A-Z]+)", md))
        # runs + substituted bases cover exactly the M columns
        assert md_total == m_total, (cig, md)
