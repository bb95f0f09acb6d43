"""Batched native mapping drivers (mm2tpu_map_batch_text /
mm2tpu_map_batch_pe_text): per-read/per-pair output must be IDENTICAL to
the per-read native path (same C core, so any drift is a marshalling bug),
including fallback entries, empty reads, non-ASCII names (hash-parity
fallback) and the buffer-grow protocol."""
import numpy as np
import pytest

from minimap2_chaindp_tpu import constants as C
from minimap2_chaindp_tpu.options import set_opt


class R:
    def __init__(self, name, seq, qual=None, comment=None):
        self.name, self.seq, self.qual, self.comment = (name, seq, qual,
                                                        comment)


@pytest.fixture(scope="module")
def mt(seeded):
    """map-ont index of the seeded genome, plus its first contig."""
    mi, mo = seeded.index("map-ont")
    mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR
    return mi, mo, seeded.contig(0)


def _sim(seq, n, length, err, seed, prefix="b"):
    rng = np.random.default_rng(seed)
    comp = str.maketrans("ACGT", "TGCA")
    out = []
    for i in range(n):
        st = int(rng.integers(0, len(seq) - length))
        s = "".join(c if rng.random() > err
                    else "ACGT"[int(rng.integers(0, 4))]
                    for c in seq[st:st + length])
        if rng.random() < 0.5:
            s = s[::-1].translate(comp)
        out.append(R(f"{prefix}{i}", s, qual="I" * len(s)))
    return out


def test_batch_se_matches_per_read(mt):
    from minimap2_chaindp_tpu.native import (map_batch_text_native,
                                             map_unit_ok,
                                             map_unit_text_native)
    mi, mo, seq = mt
    if not map_unit_ok(mo, mi):
        pytest.skip("native driver unavailable")
    recs = _sim(seq, 40, 1000, 0.1, 3)
    recs.insert(5, R("empty", ""))                 # qlen 0 -> None entry
    recs.insert(9, R("née7", recs[0].seq))    # non-ASCII -> fallback
    got = map_batch_text_native(mi, mo, recs, "")
    assert got is not None and len(got) == len(recs)
    for rec, lines in zip(recs, got):
        want = map_unit_text_native(mi, mo, rec, "")
        if lines is None:
            # the batch may only decline reads the per-read path also
            # declines OR the documented parity fallbacks (empty,
            # non-ASCII name)
            assert want is None or rec.name == "née7" or not rec.seq
            continue
        assert lines == want, rec.name


def test_batch_pe_matches_per_pair(mt):
    from minimap2_chaindp_tpu.native import (map_batch_pe_native,
                                             map_frag_pe_native,
                                             map_unit_ok)
    import copy
    io_, mo = set_opt("sr")
    mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR
    mi, _, seq = mt
    mo.update(mi)
    if not map_unit_ok(mo, mi):
        pytest.skip("native driver unavailable")
    rng = np.random.default_rng(11)
    comp = str.maketrans("ACGT", "TGCA")
    pairs = []
    for i in range(30):
        ins = int(rng.integers(300, 700))
        st = int(rng.integers(0, len(seq) - ins))
        r1 = seq[st:st + 150]
        r2 = seq[st + ins - 150:st + ins][::-1].translate(comp)
        pairs.append((R(f"pp{i}/1", r1, "I" * 150),
                      R(f"pp{i}/2", r2, "I" * 150)))
    got = map_batch_pe_native(mi, mo, pairs, "")
    assert got is not None and len(got) == len(pairs)
    n_ok = 0
    for segs, lines in zip(pairs, got):
        want = map_frag_pe_native(mi, mo, list(segs), "")
        if lines is None:
            assert want is None
            continue
        assert lines == want, segs[0].name
        n_ok += 1
    assert n_ok >= 25    # nearly all pairs take the native path


def test_batch_grow_protocol(mt):
    """A read whose output overflows the initial text/line buffers must
    come back complete after the grow-and-rerun loop, identical to the
    per-read path (which grows its own buffers)."""
    from minimap2_chaindp_tpu.native import (map_batch_text_native,
                                             map_unit_ok,
                                             map_unit_text_native)
    io_, mo = set_opt("map-ont")
    mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR
    mo.best_n = 300          # -N 300: secondaries multiply output lines
    mo.pri_ratio = 0.0       # keep everything
    mi, _, seq = mt
    mo.update(mi)
    if not map_unit_ok(mo, mi):
        pytest.skip("native driver unavailable")
    # tandem-repeat read: many near-equal mappings -> many output lines
    unit = seq[3000:3400]
    rec = R("tandem", unit * 3)
    recs = [rec] * 8
    got = map_batch_text_native(mi, mo, recs, "")
    assert got is not None
    want = map_unit_text_native(mi, mo, rec, "")
    for lines in got:
        assert lines == want
