#!/usr/bin/env python
"""Randomized differential sweep vs the reference binary.

Generates fresh-seed workloads (simulated reads in several shapes) and
byte-compares this framework's output with `.golden/minimap2_ref` across
presets and output modes. Exit code 0 = every case byte-identical
(modulo the @PG header line, which embeds the command line).

  python tools/diff_sweep.py [--seed N] [--quick]

The reference binary must exist (bash golden/build_reference.sh).
"""
import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_BIN = os.path.join(ROOT, ".golden", "minimap2_ref")
# paired-end cases need the PE-bug-fixed reference build (the fork's own PE
# path segfaults; see golden/README.md and golden/build_reference_fix.sh)
REF_FIX_BIN = os.path.join(ROOT, ".golden", "minimap2_fix")
REF_FA = "/root/reference/test/MT-human.fa"
BASES = "ACGT"


def simulate(ref_seq, n, read_len, err, rng):
    reads = []
    for i in range(n):
        st = int(rng.integers(0, len(ref_seq) - read_len))
        out = []
        for c in ref_seq[st:st + read_len]:
            r = rng.random()
            if r < err * 0.6:
                out.append(BASES[int(rng.integers(0, 4))])
            elif r < err * 0.8:
                pass
            elif r < err:
                out.append(c)
                out.append(BASES[int(rng.integers(0, 4))])
            else:
                out.append(c)
        s = "".join(out)
        if rng.random() < 0.5:
            s = s[::-1].translate(str.maketrans("ACGT", "TGCA"))
        reads.append((f"r{i}", s))
    return reads


def mutate(seq, err, rng):
    out = []
    for c in seq:
        r = rng.random()
        if r < err * 0.6:
            out.append(BASES[int(rng.integers(0, 4))])
        elif r < err * 0.8:
            pass
        elif r < err:
            out.append(c)
            out.append(BASES[int(rng.integers(0, 4))])
        else:
            out.append(c)
    return "".join(out)


def simulate_pairs(ref_seq, n, read_len, frag_len, err, rng):
    """FR-oriented read pairs (same name in both files, pe.c pairing)."""
    r1, r2 = [], []
    comp = str.maketrans("ACGT", "TGCA")
    for i in range(n):
        fl = int(rng.integers(frag_len - 100, frag_len + 100))
        st = int(rng.integers(0, len(ref_seq) - fl))
        frag = ref_seq[st:st + fl]
        a = mutate(frag[:read_len], err, rng)
        b = mutate(frag[-read_len:], err, rng)[::-1].translate(comp)
        r1.append((f"p{i}", a))
        r2.append((f"p{i}", b))
    return r1, r2


def simulate_spliced(ref_seq, n, n_exons, exon_len, intron_len, err, rng):
    """cDNA-like reads spliced out of a patched copy of the reference:
    a few fixed gene loci are chosen, and every skipped intron's donor /
    acceptor dinucleotides are set to canonical GT..AG in the returned
    reference copy, so the exts2 splice-signal scoring path (donor/acceptor
    arrays + two-round strand selection) is genuinely exercised. Both
    binaries map against the same patched reference, so the differential
    stays valid. Returns (patched_ref, reads)."""
    comp = str.maketrans("ACGT", "TGCA")
    seq = list(ref_seq)
    span = n_exons * exon_len + (n_exons - 1) * intron_len
    n_loci = max(1, min(4, len(ref_seq) // (span + 200)))
    starts = []
    for li in range(n_loci):
        st = li * (span + 200) + int(rng.integers(0, 100))
        starts.append(st)
        pos = st
        for _ in range(n_exons - 1):
            pos += exon_len
            seq[pos:pos + 2] = "GT"                            # donor
            seq[pos + intron_len - 2:pos + intron_len] = "AG"  # acceptor
            pos += intron_len
    patched = "".join(seq)
    reads = []
    for i in range(n):
        st = starts[int(rng.integers(0, n_loci))]
        parts, pos = [], st
        for _ in range(n_exons):
            parts.append(patched[pos:pos + exon_len])
            pos += exon_len + intron_len
        s = mutate("".join(parts), err, rng)
        if rng.random() < 0.5:
            s = s[::-1].translate(comp)
        reads.append((f"sp{i}", s))
    return patched, reads


def write_fa(path, reads, lcr_every=0):
    with open(path, "w") as f:
        for i, (n, s) in enumerate(reads):
            if lcr_every and i % lcr_every == 0:
                k = len(s) // 2
                s = s[:k] + "AT" * 25 + s[k:]
            f.write(f">{n}\n{s}\n")


def run_case(label, args, ref_bin=REF_BIN, device="host", extra=()):
    env = dict(os.environ)
    if "--mesh" in extra:
        # the virtual mesh needs the CPU platform regardless of what the
        # caller's environment selects (the CLI provisions the devices)
        env["JAX_PLATFORMS"] = "cpu"
    elif device != "host":
        env.pop("JAX_PLATFORMS", None)  # module default pins cpu for host runs
    ours = subprocess.run(
        [sys.executable, "-m", "minimap2_chaindp_tpu.cli", "--device",
         device, *extra, *args], capture_output=True, text=True, cwd=ROOT,
        env=env)
    # watchdogged oracle run: the fork's result-thread race wedges the
    # binary intermittently on 1 core — a hang must become a labeled
    # datum, not a silently blocked sweep (VERDICT r3 #7)
    from tools.refbin import run_ref
    ref = run_ref([ref_bin, "-t", "12", *args], timeout_s=180.0, retries=2,
                  text=True)
    if ref.proc is None:
        print(f"HANG [{label}] (oracle wedged {ref.hangs}x; no verdict)")
        return None
    strip = lambda t: [l for l in t.split("\n") if not l.startswith("@PG")]
    ok = ours.returncode == 0 and ref.returncode == 0 \
        and strip(ours.stdout) == strip(ref.stdout)
    n_rec = sum(1 for l in ours.stdout.split("\n")
                if l and not l.startswith("@"))
    tag = "OK  " if ok else "DIFF"
    note = f", oracle retried after {ref.hangs} hang(s)" if ref.hangs else ""
    print(f"{tag} [{label}] ({n_rec} records{note})")
    return ok


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--gpu", action="store_true",
                    help="also run a case through the full GPU device "
                         "runtime (needs an attached GPU)")
    ns = ap.parse_args()
    seed = ns.seed if ns.seed is not None else int.from_bytes(
        os.urandom(4), "little")
    print(f"seed={seed}")
    rng = np.random.default_rng(seed)
    if not os.path.exists(REF_BIN):
        print("reference binary missing: bash golden/build_reference.sh",
              file=sys.stderr)
        return 2

    from minimap2_chaindp_tpu.io.fastx import read_fastx
    ref_seq = next(read_fastx(REF_FA)).seq
    scale = 1 if ns.quick else 4
    d = "/tmp/diff_sweep"
    os.makedirs(d, exist_ok=True)
    write_fa(f"{d}/ont.fa", simulate(ref_seq, 50 * scale, 1000, 0.10, rng))
    write_fa(f"{d}/pb.fa", simulate(ref_seq, 12 * scale, 5000, 0.12, rng))
    write_fa(f"{d}/lcr.fa", simulate(ref_seq, 50 * scale, 1000, 0.08, rng),
             lcr_every=3)
    write_fa(f"{d}/ava.fa", simulate(ref_seq, 15 * scale, 3000, 0.10, rng))
    p1, p2 = simulate_pairs(ref_seq, 40 * scale, 100, 400, 0.01, rng)
    write_fa(f"{d}/pe1.fa", p1)
    write_fa(f"{d}/pe2.fa", p2)
    splice_ref, cdna = simulate_spliced(ref_seq, 6 * scale, 3, 300, 800,
                                        0.03, rng)
    write_fa(f"{d}/splice_ref.fa", [("MT_splice", splice_ref)])
    write_fa(f"{d}/cdna.fa", cdna)

    if not os.path.exists(REF_FIX_BIN):
        subprocess.run(["bash", os.path.join(ROOT, "golden",
                                             "build_reference_fix.sh")],
                       check=True, capture_output=True)
    cases = [
        ("sr PE SAM", ["-ax", "sr", REF_FA, f"{d}/pe1.fa", f"{d}/pe2.fa"],
         REF_FIX_BIN),
        ("sr SE PAF", ["-cx", "sr", REF_FA, f"{d}/pe1.fa"]),
        ("map-ont SAM", ["-a", REF_FA, f"{d}/ont.fa"]),
        ("map-ont PAF+cs+MD", ["-c", "--cs=long", "--MD", REF_FA,
                               f"{d}/ont.fa"]),
        ("map-pb HPC", ["-ax", "map-pb", REF_FA, f"{d}/pb.fa"]),
        ("-T20 masking", ["-a", "-T20", REF_FA, f"{d}/lcr.fa"]),
        ("ava-ont", ["-cx", "ava-ont", f"{d}/ava.fa", f"{d}/ava.fa"]),
        ("splice", ["-ax", "splice", "/root/reference/test/t-inv.fa",
                    "/root/reference/test/q-inv.fa"]),
        ("splice cDNA SAM", ["-ax", "splice", f"{d}/splice_ref.fa",
                             f"{d}/cdna.fa"]),
        ("asm5 -Y", ["-ax", "asm5", "-Y", REF_FA, f"{d}/pb.fa"]),
    ]
    # multi-chip mesh mapping on the virtual CPU mesh (sharded index +
    # capacity-bounded seed routing) vs the reference binary
    cases.append(("map-ont SAM (4x2 mesh)",
                  ["-a", REF_FA, f"{d}/ont.fa"], REF_BIN, "gpu",
                  ("--mesh", "4x2")))
    if ns.gpu:
        cases.append(("map-ont SAM (GPU device runtime)",
                      ["-a", REF_FA, f"{d}/ont.fa"], REF_BIN, "gpu"))
    got = [run_case(*c) for c in cases]
    fails = sum(g is False for g in got)
    hangs = sum(g is None for g in got)
    note = f" ({hangs} no-verdict: oracle wedged)" if hangs else ""
    print(f"{len(cases) - fails - hangs}/{len(cases)} cases "
          f"byte-identical{note}")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
