"""Paired-end ground truth by construction (VERDICT r2 #8).

The sr-PE golden fixtures come from the repo's own patched oracle build
(the fork's pe.c has 3 documented bugs), which makes them circular as
evidence. These tests need no oracle at all: reads are SIMULATED with known
positions, orientations and insert sizes, and the SAM output is checked
against that construction — FR orientation, mate fields, TLEN sign/value,
proper-pair flagging, and position accuracy (reference semantics:
mm_pair pe.c:76-171 proper-pair search, FLAG rules format.c:330-400)."""
import os

import numpy as np
import pytest

from minimap2_chaindp_tpu import constants as C
from minimap2_chaindp_tpu.io.fastx import Frag, SeqRecord

COMP = str.maketrans("ACGT", "TGCA")


def _revcomp(s):
    return s[::-1].translate(COMP)


def _mutate(rng, s, err):
    out = []
    for c in s:
        r = rng.random()
        if r < err:
            out.append("ACGT"[int(rng.integers(0, 4))])
        else:
            out.append(c)
    return "".join(out)


def simulate_pairs(ref, n, read_len=100, insert_lo=250, insert_hi=450,
                   err=0.005, seed=77):
    """FR pairs: read1 forward at st, read2 = revcomp of the insert's far
    end. Returns (frags, truth) where truth[i] = (st1, st2, insert)."""
    rng = np.random.default_rng(seed)
    frags, truth = [], []
    for i in range(n):
        ins = int(rng.integers(insert_lo, insert_hi))
        st = int(rng.integers(0, len(ref) - ins))
        r1 = _mutate(rng, ref[st:st + read_len], err)
        st2 = st + ins - read_len
        r2 = _mutate(rng, _revcomp(ref[st2:st2 + read_len]), err)
        q = "I" * read_len
        frags.append(Frag([SeqRecord(f"p{i}", r1, q),
                           SeqRecord(f"p{i}", r2, q)]))
        truth.append((st, st2, ins))
    return frags, truth


@pytest.fixture(scope="module")
def sr_setup(seeded):
    """sr index of a repeat-free seeded contig, plus its sequence."""
    mi, mo, seq = seeded.unique_index("sr")
    mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR
    return mi, mo, seq


def _map_pairs(mi, mo, frags):
    from minimap2_chaindp_tpu.models.host_runtime import HostRuntime
    rt = HostRuntime(mi, mo)
    recs = []
    for lines in rt.map_batch(frags):
        recs.append([l.split("\t") for l in lines
                     if l and not l.startswith("@")])
    return recs


def test_pe_proper_pairs_by_construction(sr_setup):
    mi, mo, ref = sr_setup
    frags, truth = simulate_pairs(ref, 80)
    recs = _map_pairs(mi, mo, frags)
    n_proper = 0
    for fi, rows in enumerate(recs):
        st1, st2, ins = truth[fi]
        prim = [t for t in rows if not (int(t[1]) & 0x900)]
        assert len(prim) == 2, f"pair {fi}: {len(prim)} primary records"
        a = next(t for t in prim if int(t[1]) & 0x40)   # first in pair
        b = next(t for t in prim if int(t[1]) & 0x80)   # second in pair
        fa, fb = int(a[1]), int(b[1])
        assert fa & 0x1 and fb & 0x1                    # paired flag
        if not (fa & 0x2):
            continue                                     # not proper: below
        n_proper += 1
        assert fb & 0x2
        # FR orientation by construction: read1 fwd, read2 rev
        assert not fa & 0x10 and fa & 0x20
        assert fb & 0x10 and not fb & 0x20
        # positions within a CIGAR-clip tolerance of the construction
        assert abs(int(a[3]) - 1 - st1) <= 8
        assert abs(int(b[3]) - 1 - st2) <= 8
        # mate fields cross-reference each other
        assert a[6] == "=" and b[6] == "="
        assert abs(int(a[7]) - int(b[3])) <= 0
        assert abs(int(b[7]) - int(a[3])) <= 0
        # TLEN: read1 leftmost => positive ~insert; read2 negative
        assert abs(int(a[8]) - ins) <= 16
        assert int(a[8]) == -int(b[8])
    # near-error-free unique reads: the vast majority must pair properly
    assert n_proper >= 72, f"only {n_proper}/80 proper pairs"


def test_pe_orientation_rejected(sr_setup):
    """FF pairs (both forward) violate the FR proper-pair model: they must
    map but NOT be flagged proper (pe.c:117-140 requires opposite dirs)."""
    mi, mo, ref = sr_setup
    rng = np.random.default_rng(3)
    frags = []
    for i in range(20):
        st = int(rng.integers(0, len(ref) - 400))
        r1 = _mutate(rng, ref[st:st + 100], 0.005)
        r2 = _mutate(rng, ref[st + 300:st + 400], 0.005)  # forward, not rc
        q = "I" * 100
        frags.append(Frag([SeqRecord(f"ff{i}", r1, q),
                           SeqRecord(f"ff{i}", r2, q)]))
    recs = _map_pairs(mi, mo, frags)
    n_mapped = n_proper = 0
    for rows in recs:
        prim = [t for t in rows if not (int(t[1]) & 0x900)]
        for t in prim:
            if not int(t[1]) & 0x4:
                n_mapped += 1
            if int(t[1]) & 0x2:
                n_proper += 1
    assert n_mapped >= 30          # they do map individually
    assert n_proper == 0           # but never as proper FR pairs


def test_pe_distant_mates_not_proper(sr_setup):
    """Mates separated far beyond max_gap_ref must not be proper-paired
    (pe.c:102 bounds the joint span)."""
    mi, mo, ref = sr_setup
    rng = np.random.default_rng(9)
    frags = []
    for i in range(10):
        st1 = int(rng.integers(0, 1500))
        st2 = int(rng.integers(13000, len(ref) - 120))
        r1 = _mutate(rng, ref[st1:st1 + 100], 0.005)
        r2 = _mutate(rng, _revcomp(ref[st2:st2 + 100]), 0.005)
        q = "I" * 100
        frags.append(Frag([SeqRecord(f"d{i}", r1, q),
                           SeqRecord(f"d{i}", r2, q)]))
    recs = _map_pairs(mi, mo, frags)
    for rows in recs:
        for t in rows:
            if not (int(t[1]) & 0x900):
                assert not int(t[1]) & 0x2


def test_pe_truth_matches_device_runtime(sr_setup):
    """The PE construction-truth must hold identically through the device
    runtime path (not just HostRuntime)."""
    from minimap2_chaindp_tpu.models.runtime import DeviceRuntime
    mi, mo, ref = sr_setup
    frags, _ = simulate_pairs(ref, 24, seed=13)
    host = _map_pairs(mi, mo, frags)
    rt = DeviceRuntime(mi, mo)
    dev = []
    for lines in rt.map_batch(frags):
        dev.append([l.split("\t") for l in lines
                    if l and not l.startswith("@")])
    assert dev == host
