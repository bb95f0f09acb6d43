"""Library API (mappy-compatible) and CLI end-to-end checks."""
import os
import subprocess
import sys

import pytest

from conftest import GOLDEN_DIR, ref_input


def test_mappy_api():
    import minimap2_chaindp_tpu.mappy as mp
    a = mp.Aligner(ref_input("MT-human.fa"))
    assert a and a.n_seq == 1 and a.seq_names == ["MT_human"]
    q = next(mp.fastx_read(ref_input("MT-orang.fa")))
    hits = list(a.map(q[1], name="MT_orang"))
    assert len(hits) == 1
    h = hits[0]
    assert h.ctg == "MT_human" and h.strand == 1 and h.is_primary
    assert h.mapq == 60
    # coordinates match the golden PAF line
    with open(os.path.join(GOLDEN_DIR, "mt.paf")) as f:
        cols = f.readline().split("\t")
    assert (h.q_st, h.q_en, h.r_st, h.r_en) == tuple(map(int, (cols[2], cols[3], cols[7], cols[8])))
    assert h.NM == int(cols[12].split(":")[-1])
    # seq fetch
    s = a.seq("MT_human", 0, 10)
    assert len(s) == 10


def test_index_roundtrip(tmp_path):
    import minimap2_chaindp_tpu.mappy as mp
    idx = str(tmp_path / "mt.mm2i")
    a1 = mp.Aligner(ref_input("MT-human.fa"), fn_idx_out=idx)
    a2 = mp.Aligner(idx)
    q = next(mp.fastx_read(ref_input("MT-orang.fa")))
    h1 = next(a1.map(q[1], name="MT_orang"))
    h2 = next(a2.map(q[1], name="MT_orang"))
    assert str(h1) == str(h2)


def test_index_mmap_load(tmp_path):
    """The default mmap'd .mm2i load (index/serialize.py load_index,
    VERDICT r3 #5) is array-identical to the eager load, maps identically
    through mappy, and fails loud on truncation in both modes."""
    import numpy as np

    import minimap2_chaindp_tpu.mappy as mp
    from minimap2_chaindp_tpu.index.serialize import load_index
    idx = str(tmp_path / "mt.mm2i")
    mp.Aligner(ref_input("MT-human.fa"), fn_idx_out=idx)
    mm, eager = load_index(idx, mmap=True), load_index(idx, mmap=False)
    assert isinstance(mm.keys, np.memmap)
    for tbl in ("S", "keys", "starts", "values"):
        assert np.array_equal(getattr(mm, tbl), getattr(eager, tbl)), tbl
    q = next(mp.fastx_read(ref_input("MT-orang.fa")))
    h = next(mp.Aligner(idx).map(q[1], name="MT_orang"))  # mmap default
    assert h.mapq == 60
    trunc = str(tmp_path / "trunc.mm2i")
    with open(idx, "rb") as f:
        raw = f.read()
    with open(trunc, "wb") as f:
        f.write(raw[:-64])
    for mode in (True, False):
        with pytest.raises(ValueError, match="truncated"):
            load_index(trunc, mmap=mode)


def test_cli_sam_golden():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "minimap2_chaindp_tpu.cli", "-a", "--device", "host",
         ref_input("MT-human.fa"),
         ref_input("MT-orang.fa")],
        capture_output=True, text=True, check=True, cwd="/root/repo", env=env)
    mine = [l for l in out.stdout.rstrip("\n").split("\n")
            if not l.startswith("@PG")]
    with open(os.path.join(GOLDEN_DIR, "mt.sam")) as f:
        golden = [l.rstrip("\n") for l in f if not l.startswith("@PG")]
    assert mine == golden


@pytest.mark.parametrize("mode,golden", [
    (["-c"], "qinv.I5k.paf"),
    (["-a"], "qinv.I5k.sam"),
])
def test_cli_multipart_index(mode, golden):
    """-I splits the index into parts, each mapped in turn with its own SAM
    header (reference main.c:133-275); byte-identical to the reference."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    qinv = ref_input("q-inv.fa")
    out = subprocess.run(
        [sys.executable, "-m", "minimap2_chaindp_tpu.cli", *mode,
         "--device", "host", "-I", "5k", qinv, qinv],
        capture_output=True, text=True, check=True, cwd="/root/repo", env=env)
    mine = [l for l in out.stdout.rstrip("\n").split("\n")
            if not l.startswith("@PG")]
    with open(os.path.join(GOLDEN_DIR, golden)) as f:
        want = [l.rstrip("\n") for l in f if not l.startswith("@PG")]
    assert mine == want


REF_BIN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".golden", "minimap2_ref")
_needs_oracle = pytest.mark.skipif(
    not os.path.exists(REF_BIN),
    reason="compiled reference oracle unavailable (golden/build_reference.sh)")


@_needs_oracle
def test_mappy_cs_md():
    """Aligner.map(cs=True, MD=True) populates the cs/MD strings like the
    reference mappy (mappy.pyx:118-135), matching the PAF tag values."""
    import minimap2_chaindp_tpu.mappy as mp
    a = mp.Aligner(ref_input("MT-human.fa"))
    q = next(mp.fastx_read(ref_input("MT-orang.fa")))
    h = next(a.map(q[1], cs=True, MD=True))
    # cross-check against the reference binary (one flag per run — the
    # reference's PAF writer emits only one of cs/MD at a time)
    import subprocess

    def ref_tag(flag, name):
        r = subprocess.run(
            ["/root/repo/.golden/minimap2_ref", "-c", flag, "-t", "12",
             ref_input("MT-human.fa"),
             ref_input("MT-orang.fa")],
            capture_output=True, text=True, check=True)
        tags = dict(t.split(":", 2)[::2] for t in r.stdout.split("\t")[12:])
        return tags[name].strip()

    assert h.cs == ref_tag("--cs", "cs")
    assert h.MD == ref_tag("--MD", "MD")
    h2 = next(a.map(q[1]))
    assert h2.cs == "" and h2.MD == ""


@_needs_oracle
def test_cli_flag_parity_X_and_M(tmp_path):
    """-X expands to -D -P --no-long-join --dual=no (main.c:336) and -M sets
    mask_level; both byte-identical to the reference binary."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    qinv = ref_input("q-inv.fa")
    ref = subprocess.run(["/root/repo/.golden/minimap2_ref", "-X", "-c",
                          "-t", "12", qinv, qinv],
                         capture_output=True, text=True, check=True)
    out = subprocess.run(
        [sys.executable, "-m", "minimap2_chaindp_tpu.cli", "-X", "-c",
         "--device", "host", qinv, qinv],
        capture_output=True, text=True, check=True, cwd="/root/repo", env=env)
    assert out.stdout == ref.stdout


def test_cli_bare_cs_does_not_eat_positionals():
    """getopt_long optional_argument semantics: a bare --cs must not consume
    the following target path (main.c:42-82 '--cs' optional arg)."""
    from minimap2_chaindp_tpu.cli import build_parser
    import minimap2_chaindp_tpu.cli as cli_mod
    argv = ["-c", "--cs", "t.fa", "q.fa"]
    argv = ["--cs=short" if a == "--cs" else a for a in argv]  # main()'s rewrite
    ns = build_parser().parse_args(argv)
    assert ns.cs == "short"
    assert ns.target == "t.fa" and ns.query == ["q.fa"]
    ns2 = build_parser().parse_args(["--cs=long", "t.fa", "q.fa"])
    assert ns2.cs == "long" and ns2.target == "t.fa"


def test_cli_print_seeds_dump():
    """--print-seeds QR/QM/CN stderr dump is byte-identical to the reference
    (fixture pinned from `minimap2_ref --print-seeds -t 12` whose CN lines
    come from map.c:864-868)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "minimap2_chaindp_tpu.cli", "--print-seeds",
         "-a", ref_input("MT-human.fa"),
         ref_input("MT-orang.fa")],
        capture_output=True, text=True, check=True, cwd="/root/repo", env=env)
    mine = [l for l in out.stderr.split("\n")
            if l.startswith(("QR\t", "QM\t", "CN\t"))]
    with open(os.path.join(GOLDEN_DIR, "mt.print_seeds.txt")) as f:
        golden = [l.rstrip("\n") for l in f]
    assert mine == golden
    assert any(l.startswith("MT_orang\t") for l in out.stdout.split("\n"))


def test_cli_print_aln_seq_dump():
    """--print-aln-seq DP-problem dump (align.c:222-228) matches the
    reference fixture on the inversion pair."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "minimap2_chaindp_tpu.cli", "--print-aln-seq",
         "-a", ref_input("t-inv.fa"),
         ref_input("q-inv.fa")],
        capture_output=True, text=True, check=True, cwd="/root/repo", env=env)
    lines = out.stderr.split("\n")
    mine = []
    for i, l in enumerate(lines):
        if l.startswith("===>"):
            mine.extend(lines[i:i + 4])  # header, tseq, qseq, score/cigar
    with open(os.path.join(GOLDEN_DIR, "inv.print_aln_seq.txt")) as f:
        golden = [l.rstrip("\n") for l in f]
    assert mine == golden


def test_cli_long_option_aliases():
    """The reference's long-option spellings (main.c:42-82) parse."""
    from minimap2_chaindp_tpu.cli import build_parser
    ns = build_parser().parse_args(
        ["--sam", "--min-count", "3", "--min-chain-score", "40",
         "--min-dp-score", "80", "--no-self", "--all-chain",
         "--cost-non-gt-ag", "9", "--mb-size", "100M", "t.fa", "q.fa"])
    assert ns.sam and ns.no_diag and ns.all_chains
    assert ns.min_cnt == 3 and ns.min_chain_score == 40
    assert ns.min_dp_max == 80 and ns.noncan == 9
    assert ns.mini_batch == "100M"


def test_mmi_roundtrip_multi_occ():
    """Stock .mmi (MMI\\2, index.c:785-874) dump/load round-trips the CSR
    exactly, including multi-occurrence p[] lists and the packed 4-bit S."""
    import numpy as np
    from minimap2_chaindp_tpu.index.build import build_index
    from minimap2_chaindp_tpu.index.serialize import dump_mmi, load_mmi_parts
    import tempfile
    rng = np.random.default_rng(7)
    unit = "".join("ACGT"[i] for i in rng.integers(0, 4, 500))
    seq = unit * 6 + "".join("ACGT"[i] for i in rng.integers(0, 4, 3000))
    mi = build_index(["rep"], [seq], 10, 15, 0, 14)
    assert (np.diff(mi.starts) > 1).any()
    with tempfile.NamedTemporaryFile(suffix=".mmi") as tf:
        dump_mmi(mi, tf.file)
        dump_mmi(mi, tf.file)  # multi-part stream
        tf.file.flush()
        parts = list(load_mmi_parts(tf.name))
    assert len(parts) == 2
    for m2 in parts:
        assert (m2.k, m2.w, m2.b, m2.flag) == (mi.k, mi.w, mi.b, mi.flag)
        assert np.array_equal(m2.keys, mi.keys)
        assert np.array_equal(m2.starts, mi.starts)
        assert np.array_equal(m2.values, mi.values)
        assert np.array_equal(m2.S, mi.S)


def test_cli_map_from_mmi(tmp_path):
    """-d foo.mmi writes the stock format; mapping from it is byte-identical
    to mapping from the FASTA."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    mmi = str(tmp_path / "mt.mmi")
    subprocess.run(
        [sys.executable, "-m", "minimap2_chaindp_tpu.cli", "-d", mmi,
         ref_input("MT-human.fa")],
        capture_output=True, check=True, cwd="/root/repo", env=env)
    a = subprocess.run(
        [sys.executable, "-m", "minimap2_chaindp_tpu.cli", "-a",
         "--device", "host", mmi, ref_input("MT-orang.fa")],
        capture_output=True, text=True, check=True, cwd="/root/repo", env=env)
    with open(os.path.join(GOLDEN_DIR, "mt.sam")) as f:
        golden = [l.rstrip("\n") for l in f if not l.startswith("@PG")]
    mine = [l for l in a.stdout.rstrip("\n").split("\n")
            if not l.startswith("@PG")]
    assert mine == golden


def test_mappy_mmi_roundtrip():
    """Aligner accepts stock .mmi input and fn_idx_out=*.mmi (mappy.pyx:103);
    hits from the loaded index match the FASTA-built index."""
    from minimap2_chaindp_tpu import mappy
    import tempfile
    with tempfile.TemporaryDirectory() as td:
        mmi = os.path.join(td, "mt.mmi")
        a = mappy.Aligner(ref_input("MT-human.fa"),
                          preset="map-ont", fn_idx_out=mmi)
        b = mappy.Aligner(mmi, preset="map-ont")
        q = next(mappy.fastx_read(
            ref_input("MT-orang.fa")))[1]
        ha = [str(h) for h in a.map(q)]
        hb = [str(h) for h in b.map(q)]
    assert ha and ha == hb


def test_cli_prebuilt_noseq_guard(tmp_path):
    """Mapping with CIGAR from a prebuilt index that lacks sequences gives
    the reference's clean error (main.c:214), not a crash."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    mmi = str(tmp_path / "noseq.mmi")
    subprocess.run(
        [sys.executable, "-m", "minimap2_chaindp_tpu.cli", "--idx-no-seq",
         "-d", mmi, ref_input("MT-human.fa")],
        capture_output=True, check=True, cwd="/root/repo", env=env)
    r = subprocess.run(
        [sys.executable, "-m", "minimap2_chaindp_tpu.cli", "-a", mmi,
         ref_input("MT-orang.fa")],
        capture_output=True, text=True, cwd="/root/repo", env=env)
    assert r.returncode == 1
    assert "doesn't contain sequences" in r.stderr


def test_cli_mmi_hpc_roundtrip(tmp_path):
    """A map-pb (HPC) index survives the .mmi round trip: the MM_I_HPC flag
    rides the header and mapping from the loaded index is byte-identical."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    mmi = str(tmp_path / "hpc.mmi")
    subprocess.run(
        [sys.executable, "-m", "minimap2_chaindp_tpu.cli", "-x", "map-pb",
         "-d", mmi, ref_input("MT-human.fa")],
        capture_output=True, check=True, cwd="/root/repo", env=env)
    a = subprocess.run(
        [sys.executable, "-m", "minimap2_chaindp_tpu.cli", "-ax", "map-pb",
         "--device", "host", mmi, ref_input("MT-orang.fa")],
        capture_output=True, text=True, check=True, cwd="/root/repo", env=env)
    b = subprocess.run(
        [sys.executable, "-m", "minimap2_chaindp_tpu.cli", "-ax", "map-pb",
         "--device", "host", ref_input("MT-human.fa"),
         ref_input("MT-orang.fa")],
        capture_output=True, text=True, check=True, cwd="/root/repo", env=env)
    strip = lambda t: [l for l in t.rstrip("\n").split("\n")
                       if not l.startswith("@PG")]
    assert strip(a.stdout) == strip(b.stdout)
    from minimap2_chaindp_tpu.index.serialize import load_mmi_parts
    mi, = load_mmi_parts(mmi)
    assert mi.flag & 0x1  # MM_I_HPC preserved


def test_cli_stdin_query():
    """Queries from stdin via '-' (reference gzdopen(0) path, bseq.c:38),
    plain and gzipped, match the file-path output."""
    import gzip as _gz
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    base = subprocess.run(
        [sys.executable, "-m", "minimap2_chaindp_tpu.cli", "-a",
         "--device", "host", ref_input("MT-human.fa"),
         ref_input("MT-orang.fa")],
        capture_output=True, text=True, check=True, cwd="/root/repo", env=env)
    raw = open(ref_input("MT-orang.fa"), "rb").read()
    for payload in (raw, _gz.compress(raw)):
        out = subprocess.run(
            [sys.executable, "-m", "minimap2_chaindp_tpu.cli", "-a",
             "--device", "host", ref_input("MT-human.fa"),
             "-"],
            input=payload, capture_output=True, check=True,
            cwd="/root/repo", env=env)
        strip = lambda t: [l for l in t.split("\n")
                           if not l.startswith("@PG")]
        assert strip(out.stdout.decode()) == strip(base.stdout)


def test_device_index_build_bit_identical():
    """index/build_device.py: the accelerator pair-sort CSR build must
    produce bit-identical keys/starts/values to the native host build
    (multi-contig, shared minimizers across contigs)."""
    from minimap2_chaindp_tpu.index.build import build_index
    from minimap2_chaindp_tpu.io.fastx import read_fastx
    import numpy as np
    refs = list(read_fastx(ref_input("MT-human.fa")))
    refs += list(read_fastx(ref_input("MT-orang.fa")))
    names = [r.name for r in refs]
    seqs = [r.seq for r in refs]
    host = build_index(names, seqs, 10, 15, 0, 14, device=False)
    dev = build_index(names, seqs, 10, 15, 0, 14, device=True)
    assert np.array_equal(host.keys, dev.keys)
    assert np.array_equal(host.starts, dev.starts)
    assert np.array_equal(host.values, dev.values)
    # HPC sketch variant too
    host_h = build_index(names, seqs, 5, 19, 1, 14, device=False)
    dev_h = build_index(names, seqs, 5, 19, 1, 14, device=True)
    assert np.array_equal(host_h.values, dev_h.values)
    assert np.array_equal(host_h.keys, dev_h.keys)


def test_mm2i_no_seq_roundtrip(tmp_path):
    """MM_I_NO_SEQ indexes carry no S section: dump must skip it and load
    must not consume the key tables as sequence bytes (previously a
    NO_SEQ .mm2i was unloadable or silently misparsed)."""
    import numpy as np
    from minimap2_chaindp_tpu.options import set_opt
    from minimap2_chaindp_tpu.index.build import build_index
    from minimap2_chaindp_tpu.index.serialize import dump_index, load_index
    io, mo = set_opt(None)
    io.flag |= 0x2                      # MM_I_NO_SEQ
    mi = build_index(["c1", "c2"],
                     ["ACGTACGTAC" * 50, "TTGGCCAATT" * 40],
                     io.w, io.k, io.flag, io.bucket_bits)
    p = tmp_path / "noseq.mm2i"
    dump_index(mi, str(p))
    m2 = load_index(str(p))
    assert (m2.keys == mi.keys).all() and (m2.values == mi.values).all()
    assert (m2.starts == mi.starts).all()
    assert [s.length for s in m2.seqs] == [s.length for s in mi.seqs]
    assert len(m2.S) == 0


def test_mm2i_truncated_fails_loud(tmp_path):
    """A .mm2i truncated mid-section must raise, not silently load short
    tables that would produce wrong mappings."""
    import pytest as _pytest
    from minimap2_chaindp_tpu.options import set_opt
    from minimap2_chaindp_tpu.index.build import build_index
    from minimap2_chaindp_tpu.index.serialize import dump_index, load_index
    io, mo = set_opt(None)
    mi = build_index(["c"], ["ACGTACGTAC" * 60], io.w, io.k, io.flag,
                     io.bucket_bits)
    p = tmp_path / "t.mm2i"
    dump_index(mi, str(p))
    raw = p.read_bytes()
    p.write_bytes(raw[:len(raw) - 16])
    with _pytest.raises(ValueError, match="truncated"):
        load_index(str(p))


def test_mm2i_contig_over_2gb_header(tmp_path):
    """Contig lengths are unsigned 32-bit like stock .mmi (<= 4 Gbp):
    a >2^31 bp contig's length must survive dump/load (previously the
    signed pack raised struct.error)."""
    from minimap2_chaindp_tpu.index.build import MinimizerIndex, RefSeq
    from minimap2_chaindp_tpu.index.serialize import dump_index, load_index
    import numpy as np
    mi = MinimizerIndex(k=15, w=10, flag=0x2, b=14)   # NO_SEQ: no S bytes
    mi.seqs.append(RefSeq(name="huge", offset=0, length=3_000_000_000))
    mi.keys = np.array([123], dtype=np.uint64)
    mi.starts = np.array([0, 1], dtype=np.int64)
    mi.values = np.array([7], dtype=np.uint64)
    p = tmp_path / "huge.mm2i"
    dump_index(mi, str(p))
    m2 = load_index(str(p))
    assert m2.seqs[0].length == 3_000_000_000


def test_mappy_paired_end_mm_map_aux():
    """Aligner.map(seq, seq2) follows mm_map_aux (cmappy.h:74): seq2 is
    reverse-complemented, the pair maps as ONE 2-segment fragment, and
    seg-1 hits get rev flipped back — a proper FR pair comes out read1 +
    / read2 - with joint pairing applied (previously seq2 was mapped
    as-given, so proper pairs could never form)."""
    from minimap2_chaindp_tpu import mappy as mp
    from minimap2_chaindp_tpu import constants as C
    a = mp.Aligner(ref_input("MT-human.fa"), preset="sr")
    r1 = a.seq("MT_human", 2000, 2100)
    r2 = C.revcomp_str(a.seq("MT_human", 2200, 2300))
    hits = sorted(a.map(r1, r2), key=lambda h: h.read_num)
    assert [h.read_num for h in hits] == [1, 2]
    assert hits[0].strand == 1 and hits[0].r_st == 2000
    assert hits[1].strand == -1 and hits[1].r_st == 2200
    assert all(h.is_primary and h.mapq == 60 for h in hits)


def test_mappy_seq_bounds():
    """Aligner.seq mirrors mappy_fetch_seq's guards: unknown name, start
    past the contig, empty range, and (reference-UB) negative start all
    return None; end is clamped (previously a negative start leaked the
    PRECEDING contig's bases)."""
    from minimap2_chaindp_tpu import mappy as mp
    a = mp.Aligner(ref_input("MT-human.fa"), preset="sr")
    ln = a._mi.seqs[0].length
    assert a.seq("nope") is None
    assert a.seq("MT_human", -3, 5) is None
    assert a.seq("MT_human", ln, ln + 5) is None
    assert a.seq("MT_human", 5, 2) is None
    assert len(a.seq("MT_human", ln - 10, ln + 100)) == 10   # clamped
    assert a.seq("MT_human", 0, 4) == "GATC"[:0] + a.seq("MT_human")[:4]


def test_mappy_scoring_rejects_sc_ambi():
    """v2.10 has no sc_ambi; a 7-tuple must fail loud, not silently
    ignore the user's N-base score."""
    import pytest as _pytest
    from minimap2_chaindp_tpu import mappy as mp
    with _pytest.raises(NotImplementedError):
        mp.Aligner("/root/reference/test/MT-human.fa", preset="sr",
                   scoring=(2, 4, 4, 2, 24, 1, 1))


def test_cli_option_parity_fixes():
    """Reference option semantics (main.c): yes_or_no works BOTH ways,
    preset aliases apply before per-option overrides, and -g/-F/-r accept
    mm_parse_num's k/m/g suffixes with +.499 rounding."""
    from minimap2_chaindp_tpu.cli import build_parser, apply_args, _si
    from minimap2_chaindp_tpu.options import set_opt
    from minimap2_chaindp_tpu import constants as C
    # mm_parse_num semantics (main.c:84-93)
    assert _si("0.7g") == 700_000_000     # rounds, not truncates
    assert _si("2k") == 2000 and _si("1m") == 1_000_000
    assert _si("1q") == 1                 # trailing junk ignored
    # --secondary=yes clears the sr preset's NO_PRINT_2ND (main.c:376)
    ns = build_parser().parse_args(
        ["-x", "sr", "--secondary", "yes", "t", "q"])
    io, mo = set_opt("sr")
    apply_args(ns, io, mo)
    assert not (mo.flag & C.MM_F_NO_PRINT_2ND)
    # --frag=no clears FRAG_MODE (main.c:374)
    ns = build_parser().parse_args(["-x", "sr", "--frag", "no", "t", "q"])
    io, mo = set_opt("sr")
    apply_args(ns, io, mo)
    assert not (mo.flag & C.MM_F_FRAG_MODE)
    # -r with a unit suffix
    ns = build_parser().parse_args(["-r", "2k", "t", "q"])
    io, mo = set_opt(None)
    apply_args(ns, io, mo)
    assert mo.bw == 2000


def test_cli_sr_alias_applies_before_overrides(tmp_path):
    """`--sr -A 5` keeps the user's match score: the preset alias is a
    BASE, like -x (previously it ran last and reset a=2)."""
    import subprocess
    import sys as _sys
    out = subprocess.run(
        [_sys.executable, "-c", """
import sys
sys.path.insert(0, "/root/repo")
from minimap2_chaindp_tpu.cli import build_parser, apply_args
from minimap2_chaindp_tpu.options import set_opt
ns = build_parser().parse_args(["--sr", "-A", "5", "t", "q"])
io, mo = set_opt(None)
set_opt("sr", io, mo)
apply_args(ns, io, mo)
assert mo.a == 5, mo.a
print("ok")
"""], capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "ok", out.stderr[-300:]
