#!/usr/bin/env python
"""End-to-end mapping throughput bench: simulated ~1 kb ONT-like reads vs
MT-human, `-a` SAM output, this framework vs the reference binary on the
same host.

Usage:
  python tools/e2e_bench.py [--reads N] [--device gpu|host] [--profile]
  python tools/e2e_bench.py --ref          # time the reference binary only

The read simulator matches tests/test_mapeval_accuracy.py (10% error,
pbsim-style names) so accuracy can be cross-checked with paftools mapeval.
"""
import argparse
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
BASES = "ACGT"
REF_FA = "/root/reference/test/MT-human.fa"
REF_BIN = os.path.join(ROOT, ".golden", "minimap2_ref")


def simulate(ref_seq, n, read_len, err, seed):
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(n):
        st = int(rng.integers(0, len(ref_seq) - read_len))
        en = st + read_len
        out = []
        for c in ref_seq[st:en]:
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
        strand = "+" if rng.random() < 0.5 else "-"
        s = "".join(out)
        if strand == "-":
            s = s[::-1].translate(str.maketrans("ACGT", "TGCA"))
        reads.append((f"S1_{i}!MT_human!{st}!{en}!{strand}", s))
    return reads


def write_reads(path, reads):
    with open(path, "w") as f:
        for name, seq in reads:
            f.write(f">{name}\n{seq}\n")


def main():
    global REF_FA
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=400)
    ap.add_argument("--len", dest="read_len", type=int, default=1000)
    ap.add_argument("--device", default="host",
                    choices=["host", "gpu", "pair", "refpair"])
    ap.add_argument("--preset", default="map-ont",
                    help="preset for BOTH lanes (e.g. sr for the "
                         "reference's Illumina headline regime)")
    ap.add_argument("--err", type=float, default=0.10,
                    help="simulated per-base error rate (use ~0.005 "
                         "for Illumina-like sr reads)")
    ap.add_argument("--ref", action="store_true", help="reference binary only")
    ap.add_argument("--both", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--steady", type=int, default=0, metavar="N",
                    help="in-process steady-state timing: 1 warmup + N "
                         "timed repeats, best reported")
    ap.add_argument("--batch", type=int, default=400)
    ap.add_argument("--repeat", type=int, default=2,
                    help="timed repeats (first run includes warmup)")
    ap.add_argument("--ref-fa", default=REF_FA,
                    help="reference FASTA (e.g. the genome_scale 50 Mb "
                         "genome); reads are simulated from ALL contigs")
    ap.add_argument("--index", default=None,
                    help="map against this prebuilt index (.mm2i) instead "
                         "of re-building from --ref-fa every run")
    args = ap.parse_args()
    if args.device in ("pair", "refpair") and not args.steady:
        ap.error(f"--device {args.device} requires --steady N (paired runs "
                 "are an in-process steady-state mode)")

    from minimap2_chaindp_tpu.io.fastx import read_fastx
    refs = list(read_fastx(args.ref_fa))
    rng = np.random.default_rng(11)
    if len(refs) == 1:
        reads = simulate(refs[0].seq, args.reads, args.read_len, args.err,
                         seed=7)
    else:
        reads = []
        per = [int(rng.integers(0, len(refs))) for _ in range(args.reads)]
        for ci in sorted(set(per)):
            n_c = per.count(ci)
            sub = simulate(refs[ci].seq, n_c, args.read_len, args.err,
                           seed=7 + ci)
            reads.extend((f"{nm}!{refs[ci].name}", sq) for nm, sq in sub)
    qpath = "/tmp/e2e_bench_reads.fa"
    write_reads(qpath, reads)
    REF_FA = args.index or args.ref_fa

    from tools.refbin import run_ref

    def ref_once(timeout_s=240.0):
        """One watchdogged reference-binary run: (wall_s | None, hangs).
        The fork's result-thread race wedges it intermittently on this
        1-core host, so a hang becomes a labeled datum, never a stall."""
        r = run_ref([REF_BIN, "-ax", args.preset, "-t", "4", REF_FA, qpath],
                    timeout_s=timeout_s, retries=2,
                    stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        return (r.dt if r.ok else None), r.hangs

    if args.ref or args.both:
        # warm once, then time
        hangs, dt = 0, None
        for it in range(2):
            dt, h = ref_once()
            hangs += h
            if dt is None:
                break
        if dt is not None:
            print(f"reference: {args.reads / dt:8.1f} reads/s  ({dt:.2f}s)"
                  f"  ref_hangs: {hangs}")
        else:
            print(f"reference: WEDGED  ref_hangs: {hangs}")
        if not args.both:
            return

    env_cmd = [sys.executable, "-m", "minimap2_chaindp_tpu.cli",
               "-ax", args.preset, "-K", str(args.batch * args.read_len),
               "--device", args.device, REF_FA, qpath]

    def timed_cli_run(dev):
        """One in-process cli.main() mapping run, SAM to a scratch file,
        wall time returned; stdout restored even if the run raises."""
        from minimap2_chaindp_tpu import cli
        sys.argv = ["mm2tpu", "-ax", args.preset,
                    "-K", str(args.batch * args.read_len),
                    "--device", dev, REF_FA, qpath]
        old = sys.stdout
        try:
            with open("/tmp/e2e_bench.sam", "w") as out:
                sys.stdout = out
                t0 = time.perf_counter()
                cli.main()
                return time.perf_counter() - t0
        finally:
            sys.stdout = old

    if args.steady and args.device == "refpair":
        # PAIRED steady-state framework-host vs REFERENCE BINARY, runs
        # interleaved so the 1-core host's ~20% scheduler bursts hit both
        # lanes under near-identical machine state (same rationale as
        # `pair`). The framework lane runs in-process (startup excluded,
        # run 0 = warmup); the binary lane is a subprocess, so its exec +
        # index-build cost stays in its time — the same deal its own users
        # get — and it runs under the hang watchdog (the fork's
        # result-thread race wedges intermittently on 1 core). Emits
        # runN[host]/runN[ref], steady[...], refpair_ratio_median (ref
        # time / host time; >1 means the framework is faster) and
        # ref_hangs.
        best = {"host": None, "ref": None}
        ratios = []
        hangs = 0
        for it in range(args.steady + 1):
            order = ("host", "ref") if it % 2 == 0 else ("ref", "host")
            pair = {}
            for dev in order:
                if dev == "host":
                    dt = timed_cli_run("host")
                else:
                    dt, h = ref_once()
                    hangs += h
                if dt is None:
                    print(f"run{it}[ref]: WEDGED", file=sys.stderr)
                    continue
                if it > 0:
                    b = best[dev]
                    best[dev] = dt if b is None else min(b, dt)
                    pair[dev] = dt
                print(f"run{it}[{dev}]: {args.reads / dt:8.1f} reads/s"
                      f"  ({dt:.2f}s)", file=sys.stderr)
            if len(pair) == 2:
                ratios.append(pair["ref"] / pair["host"])
        for dev in ("host", "ref"):
            if best[dev] is not None:
                print(f"steady[{dev}]: {args.reads / best[dev]:8.1f} reads/s"
                      f"  ({best[dev]:.2f}s)")
        if ratios:
            ratios.sort()
            print(f"refpair_ratio_median: {ratios[len(ratios) // 2]:.3f}")
        print(f"ref_hangs: {hangs}")
        return

    if args.steady and args.device == "pair":
        # PAIRED steady-state timing: host and gpu runs INTERLEAVED
        # run-by-run in one process (pair order alternating), so machine
        # drift hits both lanes alike. Emits runN[dev] and steady[dev]
        # lines.
        best = {"host": None, "gpu": None}
        ratios = []
        for it in range(args.steady + 1):
            order = ("host", "gpu") if it % 2 == 0 else ("gpu", "host")
            pair = {}
            for dev in order:
                dt = timed_cli_run(dev)
                if it > 0:  # iteration 0 is both lanes' warmup
                    b = best[dev]
                    best[dev] = dt if b is None else min(b, dt)
                    pair[dev] = dt
                print(f"run{it}[{dev}]: {args.reads / dt:8.1f} reads/s"
                      f"  ({dt:.2f}s)", file=sys.stderr)
                if dev == "gpu":
                    # flow telemetry for THIS run (bench.py's engaged-
                    # regime fields parse it): device_reads>0 == the
                    # device lane actually carried reads
                    from minimap2_chaindp_tpu import cli as _cli
                    c = _cli.LAST_RUN_COUNTERS
                    print(f"flow{it}[gpu]: "
                          f"device_reads={c.get('device_reads', 0)} "
                          f"retired={c.get('flow_lane_retired', 0)} "
                          f"retired_persisted="
                          f"{c.get('flow_lane_retired_persisted', 0)}",
                          file=sys.stderr)
                    # steal-lane telemetry (models/steal.py): reads the
                    # device lane completed, its measured host-CPU cost,
                    # and the guard's pause/probe activity
                    print(f"steal{it}[gpu]: "
                          f"steal_reads={c.get('steal_device_reads', 0)} "
                          f"steal_chunks={c.get('steal_chunks', 0)} "
                          f"steal_cpu_ms={c.get('steal_cpu_ms', 0)} "
                          f"steal_prep_ms="
                          f"{c.get('steal_cpu_prep_ms', 0)} "
                          f"steal_flowhost_ms="
                          f"{c.get('steal_cpu_flowhost_ms', 0)} "
                          f"steal_dispatch_ms="
                          f"{c.get('steal_cpu_dispatch_ms', 0)} "
                          f"steal_finish_ms="
                          f"{c.get('steal_cpu_finish_ms', 0)} "
                          f"steal_paused={c.get('steal_paused', 0)} "
                          f"steal_probe={c.get('steal_probe', 0)}",
                          file=sys.stderr)
            if len(pair) == 2:
                # ADJACENT-run ratio: the two runs sit ~1 s apart and share
                # machine state, unlike best-of-N
                ratios.append(pair["host"] / pair["gpu"])
        for dev in ("host", "gpu"):
            print(f"steady[{dev}]: {args.reads / best[dev]:8.1f} reads/s"
                  f"  ({best[dev]:.2f}s)")
        if ratios:
            ratios.sort()
            print(f"paired_ratio_median: {ratios[len(ratios) // 2]:.3f}")
        return

    if args.steady:
        # steady-state in-process timing: one warmup run (pays index build,
        # native-lib load, XLA compiles, device-link calibration) then
        # `--steady` timed repeats, best taken — symmetric across
        # --device host/gpu.
        best = None
        for it in range(args.steady + 1):
            dt = timed_cli_run(args.device)
            if it > 0:  # run 0 is warmup
                best = dt if best is None else min(best, dt)
            print(f"run{it}: {args.reads / dt:8.1f} reads/s  ({dt:.2f}s)",
                  file=sys.stderr)
        print(f"steady: {args.reads / best:8.1f} reads/s  ({best:.2f}s)")
        return

    if args.profile:
        import cProfile
        import pstats
        sys.argv = ["mm2tpu", "-ax", args.preset,
                    "-K", str(args.batch * args.read_len),
                    "--device", args.device, REF_FA, qpath]
        from minimap2_chaindp_tpu import cli
        out = open("/tmp/e2e_bench.sam", "w")
        old = sys.stdout
        sys.stdout = out
        pr = cProfile.Profile()
        t0 = time.perf_counter()
        pr.enable()
        cli.main()
        pr.disable()
        dt = time.perf_counter() - t0
        sys.stdout = old
        out.close()
        print(f"profiled: {args.reads / dt:8.1f} reads/s  ({dt:.2f}s)")
        st = pstats.Stats(pr)
        st.sort_stats("cumulative").print_stats(35)
        return

    best = None
    for it in range(args.repeat):
        t0 = time.perf_counter()
        subprocess.run(env_cmd, stdout=subprocess.DEVNULL,
                       stderr=subprocess.DEVNULL, check=True)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
        print(f"mm2tpu[{args.device}] run{it}: {args.reads / dt:8.1f} reads/s"
              f"  ({dt:.2f}s incl. startup)")


if __name__ == "__main__":
    main()
