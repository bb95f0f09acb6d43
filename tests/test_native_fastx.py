"""The native (C++) FASTX reader must parse identically to the pure-Python
parser on FASTA, multi-line FASTA, FASTQ, gzip, and U->T conversion."""
import gzip
import os

import pytest

from conftest import ref_input
from minimap2_chaindp_tpu.io import native_fastx
from minimap2_chaindp_tpu.io.fastx import _read_fastx_py, read_fastx

pytestmark = pytest.mark.skipif(not native_fastx.available(),
                                reason="native reader not built")


def same(path):
    a = [(r.name, r.seq, r.qual, r.comment) for r in _read_fastx_py(path)]
    b = list(native_fastx.read_fastx_native(path, block_bases=100))
    assert a == b, f"mismatch on {path}"
    return a


def test_reference_fastas():
    for fa in ("MT-human.fa", "MT-orang.fa", "q-inv.fa", "t-inv.fa",
               "t2.fa", "q2.fa"):
        recs = same(ref_input(fa))
        assert recs


def test_fastq_and_comments(tmp_path):
    fq = tmp_path / "t.fq"
    fq.write_text("@r1 some comment here\nACGUACGU\n+\nIIIIIIII\n"
                  "@r2\nacgu\n+junk\n!!!!\n")
    recs = same(str(fq))
    assert recs[0] == ("r1", "ACGTACGT", "IIIIIIII", "some comment here")
    assert recs[1] == ("r2", "acgt", "!!!!", None)


def test_multiline_fasta_gzip(tmp_path):
    fa = tmp_path / "t.fa.gz"
    with gzip.open(fa, "wt") as f:
        f.write(">s1 desc\nACGT\nACGT\nAC\n>s2\nTTTT\n")
    recs = same(str(fa))
    assert recs[0] == ("s1", "ACGTACGTAC", None, "desc")
    assert recs[1] == ("s2", "TTTT", None, None)


def test_pipeline_uses_native(tmp_path):
    # read_fastx dispatches to the native reader and yields SeqRecords
    fa = tmp_path / "t.fa"
    fa.write_text(">a\nACGT\n")
    recs = list(read_fastx(str(fa)))
    assert recs[0].name == "a" and recs[0].seq == "ACGT"


def _both_parsers(path):
    from minimap2_chaindp_tpu.io import native_fastx
    from minimap2_chaindp_tpu.io.fastx import _read_fastx_py
    nat = [(n, s, q, c) for n, s, q, c
           in native_fastx.read_fastx_native(path)]
    py = [(r.name, r.seq, r.qual, r.comment) for r in _read_fastx_py(path)]
    return nat, py


def test_wrapped_fastq_kseq_semantics(tmp_path):
    """Multi-line FASTQ (kseq.h:201-223): sequence lines accumulate until
    a line-start '+', quality lines until the sequence length is covered
    — previously both parsers assumed 4-line records and silently
    corrupted wrapped files."""
    p = tmp_path / "w.fq"
    p.write_text("@r1 c1\nACGT\nACGT\n+\nIIII\nJJJJ\n"
                 "@r2\nTTTT\n+r2\nKKKK\n")
    nat, py = _both_parsers(str(p))
    want = [("r1", "ACGTACGT", "IIIIJJJJ", "c1"),
            ("r2", "TTTT", "KKKK", None)]
    assert nat == want and py == want


def test_crlf_fastq_python_fallback(tmp_path):
    """CRLF files must parse identically on both backends (the python
    fallback previously kept the '\\r' in sequences and quals)."""
    p = tmp_path / "crlf.fq"
    p.write_bytes(b"@r1\r\nACGTACGT\r\n+\r\nIIIIIIII\r\n")
    nat, py = _both_parsers(str(p))
    want = [("r1", "ACGTACGT", "IIIIIIII", None)]
    assert nat == want and py == want


def test_midline_gt_is_sequence(tmp_path):
    """'>' at a non-line-start position is sequence data, not a record
    delimiter (kseq checks delimiters only at line starts)."""
    p = tmp_path / "gt.fa"
    p.write_text(">r1\nACGT>XY\nGGGG\n>r2\nTTTT\n")
    nat, py = _both_parsers(str(p))
    want = [("r1", "ACGT>XYGGGG", None, None), ("r2", "TTTT", None, None)]
    assert nat == want and py == want


def test_malformed_qual_stops_stream(tmp_path):
    """A quality whose length mismatches its sequence ends the stream
    (kseq's -2, which the reference's read loop treats as end-of-input)
    instead of desynchronizing the parser."""
    p = tmp_path / "bad.fq"
    p.write_text("@ok\nACGT\n+\nIIII\n@bad\nACGTACGT\n+\nIIII\n"
                 "@next\nTTTT\n+\nJJJJ\n")
    nat, py = _both_parsers(str(p))
    want = [("ok", "ACGT", "IIII", None)]
    assert nat == want and py == want


def test_unequal_pe_files_skip_extras(tmp_path, capfd):
    """mm_bseq_read_frag2 (bseq.c:131-140): interleaving stops at the
    first EOF; extra records are skipped with a warning, never mapped
    single-end."""
    from minimap2_chaindp_tpu.io.fastx import read_frags
    p1 = tmp_path / "r1.fa"
    p2 = tmp_path / "r2.fa"
    p1.write_text(">a/1\nACGT\n>b/1\nGGGG\n")
    p2.write_text(">a/2\nTTTT\n")
    frags = [f for b in read_frags([str(p1), str(p2)], 10**9, False)
             for f in b]
    assert len(frags) == 1 and len(frags[0].segs) == 2
    assert "different number of records" in capfd.readouterr().err


def test_pair_suffix_any_digit():
    """mm_qname_len strips '/' + ANY digit (bseq.h:35), not just /1-/2."""
    from minimap2_chaindp_tpu.io.fastx import qname_same, strip_pair_suffix
    assert strip_pair_suffix("frag/3") == "frag"
    assert strip_pair_suffix("frag/0") == "frag"
    assert strip_pair_suffix("x/9") == "x"     # len 3 boundary
    assert strip_pair_suffix("/9") == "/9"     # too short
    assert qname_same("frag/3", "frag/4")
