"""Validate the SDUST masker against the reference sdust binary
(reference sdust.c built with _SDUST_MAIN), and the -T minimizer-masking hook
against reference mm_dust_minier semantics."""
import os
import subprocess

import numpy as np
import pytest

from conftest import ref_input
from minimap2_chaindp_tpu.sdust import sdust, dust_mask_minimizers

REF_BIN = "/root/repo/.golden/sdust_ref"

pytestmark = pytest.mark.skipif(not os.path.exists(REF_BIN),
                                reason="reference sdust binary not built")


def ref_sdust(seqs, T=20, W=64):
    fa = "\n".join(f">s{i}\n{s}" for i, s in enumerate(seqs)) + "\n"
    out = subprocess.run([REF_BIN, "-t", str(T), "-w", str(W), "/dev/stdin"],
                         input=fa, capture_output=True, text=True, check=True)
    res = {f"s{i}": [] for i in range(len(seqs))}
    for line in out.stdout.splitlines():
        name, s, e = line.split("\t")
        res[name].append((int(s), int(e)))
    return [res[f"s{i}"] for i in range(len(seqs))]


def rand_seqs(seed, n, lo=50, hi=2000, low_complexity=True):
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(n):
        parts = []
        total = int(rng.integers(lo, hi))
        while sum(len(p) for p in parts) < total:
            kind = rng.random()
            if not low_complexity or kind < 0.4:
                parts.append("".join("ACGT"[b] for b in rng.integers(0, 4, int(rng.integers(20, 200)))))
            elif kind < 0.6:  # homopolymer
                parts.append("ACGT"[int(rng.integers(0, 4))] * int(rng.integers(5, 60)))
            elif kind < 0.8:  # tandem repeat of a short unit
                unit = "".join("ACGT"[b] for b in rng.integers(0, 4, int(rng.integers(2, 8))))
                parts.append(unit * int(rng.integers(3, 20)))
            else:             # N runs
                parts.append("N" * int(rng.integers(1, 30)))
        seqs.append("".join(parts)[:total])
    return seqs


def test_sdust_random_low_complexity():
    seqs = rand_seqs(0, 40)
    ref = ref_sdust(seqs)
    for s, want in zip(seqs, ref):
        assert sdust(s) == want


def test_sdust_nondefault_params():
    seqs = rand_seqs(1, 20)
    for T, W in ((15, 32), (28, 128), (20, 64)):
        ref = ref_sdust(seqs, T, W)
        for s, want in zip(seqs, ref):
            assert sdust(s, T, W) == want


def test_sdust_pure_random_mostly_clean():
    seqs = rand_seqs(2, 20, low_complexity=False)
    ref = ref_sdust(seqs)
    for s, want in zip(seqs, ref):
        assert sdust(s) == want


def test_sdust_on_reference_test_fasta():
    from minimap2_chaindp_tpu.io.fastx import read_fastx
    recs = list(read_fastx(ref_input("MT-orang.fa")))
    seqs = [r.seq for r in recs]
    ref = ref_sdust(seqs)
    for s, want in zip(seqs, ref):
        assert sdust(s) == want


def test_dust_mask_minimizers_drops_lcr_minimizers():
    """-T hook: minimizers >50% inside masked regions are removed, in order."""
    from minimap2_chaindp_tpu.index.sketch import sketch
    seq = ("".join("ACGT"[b] for b in np.random.default_rng(7).integers(0, 4, 400))
           + "AT" * 60
           + "".join("ACGT"[b] for b in np.random.default_rng(8).integers(0, 4, 400)))
    mv = sketch(seq, w=10, k=15, rid=0, is_hpc=False)
    kept = dust_mask_minimizers(mv, seq, 20)
    assert 0 < len(kept) < len(mv)
    # every kept minimizer overlaps masked regions by at most span/2
    dregs = sdust(seq, 20, 64)
    span = (kept[:, 0] & 0xFF).astype(np.int64)
    qpos = ((kept[:, 1] & 0xFFFFFFFF) >> 1).astype(np.int64)
    s, e = qpos - (span - 1), qpos + 1
    for i in range(len(kept)):
        ov = sum(max(0, min(int(e[i]), de) - max(int(s[i]), ds)) for ds, de in dregs)
        assert ov <= int(span[i]) >> 1
    # and every dropped one exceeds span/2 (so the filter is exact both ways)
    kept_set = {tuple(r) for r in kept.tolist()}
    for row in mv.tolist():
        if tuple(row) in kept_set:
            continue
        sp = row[0] & 0xFF
        qp = (row[1] & 0xFFFFFFFF) >> 1
        ss, ee = qp - (sp - 1), qp + 1
        ov = sum(max(0, min(ee, de) - max(ss, ds)) for ds, de in dregs)
        assert ov > sp >> 1
