#!/usr/bin/env python
"""On-card smoke test of the mapping path (one NVIDIA GPU; four with
--four-cards).

Drives the main path the way a user does — `mm2tpu -ax map-pb` with the
minimizer index resident on the device — at a deployment-sized input made
from --seed, and checks every result against the host path:

  1. environment: JAX must report platform `gpu`; prints the card's name
     and power limit (nvidia-smi), the JAX version and the host's cores,
     and builds the CUDA chaining kernel (set-up time).
  2. kernel parity: the chaining kernel at every capacity bucket of
     models/device_flow.CAP_BUCKETS, R reads each, in its three variants
     (single-segment, many_segs, is_cdna), on synthetic anchors plus
     anchors of reads against the seeded genome. f, p and the flag must
     equal the plain jnp/lax version (run on the card) bit for bit; every
     unflagged read's chains must equal the host golden model's
     (ops/chain.py, native port), and the flagged reads must include
     every read whose chains the golden model's max_skip break changes.
  3. end to end: a repeat-seeded genome (tools/genome_scale.make_genome,
     --genome-mb), its HPC index built with -t <cores> and cached under
     build/smoke/, simulated 10 kb reads at 10-15% error, mapped through
     the CLI with MM2TPU_DEVICE_FLOW=1 and with --device host: the SAMs
     must be byte-identical apart from @PG, device_reads > 0.
  4. default route: --device gpu with no forcing variable; SAM identical
     to the host's; prints the reads each lane carried.

--four-cards runs only `--mesh 4x1` and `--mesh 1x4` on the phase-3 genome
and reads, each compared with --device host, and prints every card's
bytes in use.

Everything runs in this one process (one JAX client per card). The last
stdout line is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
It is printed only when every phase passed; any failure exits non-zero.

Usage:
  python chip_smoke.py [--seed 7] [--genome-mb 1000] [--reads 2000]
                       [--four-cards]
"""
import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SMOKE_DIR = os.path.join(ROOT, "build", "smoke")
DEFAULTS = {"genome_mb": 1000, "reads": 2000, "read_len": 10000,
            "parity_reads": 256}


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------- phase 1

def phase_environment(n_cards: int):
    import jax
    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"JAX reports platform {devs[0].platform!r}, not a GPU")
    check(len(devs) >= n_cards, f"{n_cards} GPUs needed, {len(devs)} found")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    for line in smi.stdout.strip().splitlines()[:max(n_cards, 1)]:
        log(f"[env] card: {line.strip()}")
    check(smi.returncode == 0, "nvidia-smi failed")
    log(f"[env] jax {jax.__version__}, {len(devs)} x {devs[0].device_kind}, "
        f"host cores {os.cpu_count()}")
    from minimap2_chaindp_tpu.ops import chain_cuda
    t0 = time.perf_counter()
    path = chain_cuda.library_path()
    log(f"[env] chaining kernel library {os.path.relpath(path, ROOT)} "
        f"ready in {time.perf_counter() - t0:.1f}s (set-up)")
    return devs


# ---------------------------------------------------------- shared inputs

def data_setup(args):
    """Genome, HPC index and reads, cached under build/smoke/ keyed by seed
    and size (set-up time, reported)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import genome_scale as G
    os.makedirs(SMOKE_DIR, exist_ok=True)
    tag = f"s{args.seed}_{args.genome_mb}mb"
    genome = os.path.join(SMOKE_DIR, f"genome_{tag}.fa")
    index = os.path.join(SMOKE_DIR, f"genome_{tag}.pb.mm2i")
    reads = os.path.join(SMOKE_DIR,
                         f"reads_{tag}_{args.reads}x{args.read_len}.fa")
    n_contigs = max(1, args.genome_mb // 2)
    if not os.path.exists(genome):
        t0 = time.perf_counter()
        G.make_genome(genome + ".tmp", n_contigs=n_contigs,
                      contig_len=2_000_000, seed=args.seed)
        os.replace(genome + ".tmp", genome)
        log(f"[setup] genome {n_contigs} x 2 Mb made in "
            f"{time.perf_counter() - t0:.1f}s")
    if not os.path.exists(index):
        t0 = time.perf_counter()
        rc, _ = run_cli(["-x", "map-pb", "-t", str(os.cpu_count()),
                         "-d", index + ".tmp", genome])
        check(rc == 0, "index build failed")
        os.replace(index + ".tmp", index)
        log(f"[setup] HPC index built with -t {os.cpu_count()} in "
            f"{time.perf_counter() - t0:.1f}s "
            f"({os.path.getsize(index) / 1e9:.2f} GB)")
    if not os.path.exists(reads):
        t0 = time.perf_counter()
        G.simulate(genome, reads + ".tmp", args.reads, args.read_len,
                   (0.10, 0.15), seed=args.seed + 1, hpc_style=True)
        os.replace(reads + ".tmp", reads)
        log(f"[setup] {args.reads} x {args.read_len} bp reads at 10-15% "
            f"error simulated in {time.perf_counter() - t0:.1f}s")
    return genome, index, reads


def run_cli(argv, env=None, out_path=None):
    """One in-process CLI run (this process keeps the only JAX client of
    the card). Returns (exit code, counters); SAM goes to out_path."""
    from minimap2_chaindp_tpu import cli
    saved = {}
    for k, v in (env or {}).items():
        saved[k] = os.environ.get(k)
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    sink = open(out_path or os.devnull, "w")
    try:
        with contextlib.redirect_stdout(sink):
            rc = cli.main(argv)
    finally:
        sink.close()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return rc, dict(cli.LAST_RUN_COUNTERS)


def sam_body(path):
    with open(path) as f:
        return [l for l in f.read().split("\n") if not l.startswith("@PG")]


def map_route(name, argv, env, out_path, n_reads):
    t0 = time.perf_counter()
    rc, counters = run_cli(argv, env, out_path)
    dt = time.perf_counter() - t0
    check(rc == 0, f"{name}: the CLI exited {rc}")
    log(f"[e2e] {name}: {n_reads / dt:.1f} reads/s ({dt:.1f}s wall, "
        f"first run of the process: compiles included; information, not "
        f"a claim)")
    return counters


# ---------------------------------------------------------------- phase 2

def genome_anchors(index, reads, n_max):
    """Host-collected anchors of the first reads against the seeded index
    (the anchors the device flow chains)."""
    from minimap2_chaindp_tpu.index.serialize import load_index
    from minimap2_chaindp_tpu.io.fastx import read_fastx
    from minimap2_chaindp_tpu.ops.seeds import (collect_minimizers,
                                                collect_seed_hits)
    from minimap2_chaindp_tpu.options import set_opt
    mi = load_index(index, mmap=True)
    _, mo = set_opt("map-pb")
    mo.update(mi)
    out = []
    for q in read_fastx(reads):
        mv = collect_minimizers(mo, mi, [q.seq])
        sh = collect_seed_hits(mi, mo.flag, mo.mid_occ, mv, q.name,
                               len(q.seq))
        if len(sh.anchors):
            out.append(sh.anchors)
        if len(out) >= n_max:
            break
    return out


def _as_many_segs(a):
    """Mark the anchors of the query's second half as segment 1 (a
    paired-end-like fragment); x order is unchanged."""
    import numpy as np
    from minimap2_chaindp_tpu import constants as C
    q = (a[:, 1] & np.uint64(0xFFFFFFFF)).astype(np.int64)
    seg = (q > np.median(q)).astype(np.uint64)
    b = a.copy()
    b[:, 1] |= seg << np.uint64(C.MM_SEED_SEG_SHIFT)
    return b


def phase_kernel(args, index, reads):
    import numpy as np
    import jax
    from concurrent.futures import ThreadPoolExecutor
    from minimap2_chaindp_tpu import native
    from minimap2_chaindp_tpu.models.device_flow import CAP_BUCKETS
    from minimap2_chaindp_tpu.ops import chain_batch as CB
    from minimap2_chaindp_tpu.ops.chain import chain_fpv
    from minimap2_chaindp_tpu.ops.chain_jax import (chain_scores_batch_xla,
                                                    split_anchors)
    from minimap2_chaindp_tpu.utils.synth import synth_read_anchors

    t0 = time.perf_counter()
    real = genome_anchors(index, reads, 400)
    log(f"[kernel] {len(real)} genome reads' anchors collected "
        f"({time.perf_counter() - t0:.1f}s)")
    variants = (("single", 5000, 5000, 500, False, False),
                ("many_segs", 800, 600, 100, False, True),
                ("cdna", 200000, 2000, 200, True, False))
    rng = np.random.default_rng(args.seed)
    pool = ThreadPoolExecutor(max_workers=os.cpu_count())
    R = args.parity_reads
    total = flagged = 0
    for cap in CAP_BUCKETS:
        fit = [a for a in real if cap // 2 < len(a) <= cap] if cap > 512 \
            else [a for a in real if len(a) <= cap]
        base = fit[:R // 2]
        while len(base) < R:
            n = int(rng.integers(max(cap // 2, 16), cap + 1))
            base.append(synth_read_anchors(rng, n))
        for name, gr, gq, bw, cdna, many in variants:
            batch = [_as_many_segs(a) for a in base] if many else base
            reads_ = []
            for a in batch:
                xhi, rpos, qpos, span, sid = split_anchors(a)
                reads_.append(dict(xhi=xhi, rpos=rpos, qpos=qpos, span=span,
                                   sid=sid, avg_qspan=np.float32(span.sum())
                                   / np.float32(len(a))))
            packed, nn, w1, exc, host_flag = CB.pack_reads(reads_, cap, gr)
            ins = [jax.device_put(packed[k]) for k in
                   ("xhi", "rpos", "qpos", "span", "sid", "stw")]
            ins += [jax.device_put(x) for x in (nn, w1, exc)]
            kw = dict(max_n=cap, max_dist_x=gr, max_dist_y=gq, bw=bw,
                      max_skip=25, is_cdna=cdna, many_segs=many)
            f, p, fl = (np.asarray(x) for x in
                        CB.chain_scores_batch(*ins, **kw))
            f2, p2, fl2 = (np.asarray(x) for x in
                           chain_scores_batch_xla(*ins, **kw))
            check(np.array_equal(fl, fl2),
                  f"cap {cap} {name}: kernel flags != plain version's")
            ok = ~fl.astype(bool)
            check(np.array_equal(f[ok], f2[ok]) and
                  np.array_equal(p[ok], p2[ok]),
                  f"cap {cap} {name}: kernel f/p != plain version's")
            n_segs = 2 if many else 1

            def golden(r):
                a = batch[r]
                n = len(a)
                want = native.chain_dp_native(gr, gq, bw, 25, 3, 40, cdna,
                                              n_segs, a)
                full = native.chain_dp_native(gr, gq, bw, 1 << 30, 3, 40,
                                              cdna, n_segs, a)
                got = native.chain_bottom_native(a, f[r, :n], p[r, :n], 3,
                                                 40)
                same = (np.array_equal(want.u, got.u)
                        and np.array_equal(want.anchors, got.anchors))
                broke = not (np.array_equal(want.u, full.u)
                             and np.array_equal(want.anchors, full.anchors))
                return same, broke

            res = list(pool.map(golden, range(len(batch))))
            for r, (same, broke) in enumerate(res):
                if host_flag[r]:
                    continue    # gap-cost exception overflow: host path
                if broke:
                    check(fl[r], f"cap {cap} {name} read {r}: the golden "
                          "model's break changes chains but it is unflagged")
                if not fl[r]:
                    check(same, f"cap {cap} {name} read {r}: chains differ "
                          "from the host golden model")
            if cap == CAP_BUCKETS[0]:
                # exact f/p against the Python golden scan on a few reads
                for r in range(4):
                    a = batch[r]
                    n = len(a)
                    rf, rp, _ = chain_fpv(gr, gq, bw, 25, cdna, n_segs, a)
                    if not fl[r]:
                        check(list(f[r, :n]) == rf and list(p[r, :n]) == rp,
                              f"{name} read {r}: f/p != ops/chain.py")
            nf = int(fl[:len(batch)].sum())
            total += len(batch)
            flagged += nf
            log(f"[kernel] cap {cap:5d} {name:9s}: {len(batch)} reads "
                f"({len(fit[:R // 2])} genome + synthetic), 0 mismatches, "
                f"{nf} flagged")
    pool.shutdown()
    log(f"[kernel] parity OK: {total} reads, flagged share "
        f"{flagged / max(total, 1):.4f}")


# ---------------------------------------------------------- phases 3 and 4

def phase_end_to_end(args, index, reads, host_sam):
    import jax
    dev_sam = os.path.join(SMOKE_DIR, "device.sam")
    c = map_route("device route (MM2TPU_DEVICE_FLOW=1)",
                  ["-ax", "map-pb", "-t", str(os.cpu_count()), index, reads],
                  {"MM2TPU_DEVICE_FLOW": "1"}, dev_sam, args.reads)
    body = sam_body(dev_sam)
    check(body == sam_body(host_sam),
          "device SAM differs from the host SAM")
    n_rec = sum(1 for l in body if l and not l.startswith("@"))
    stats = jax.devices()[0].memory_stats() or {}
    log(f"[e2e] device SAM byte-identical to --device host ({n_rec} "
        f"records); device_reads={c.get('device_reads', 0)} "
        f"flagged_fallback={c.get('fallback', 0)} "
        f"anchor_overflow={c.get('flow_overflow', 0)} "
        f"stall_fallback={c.get('stall_fallback', 0)} "
        f"device_bytes_in_use={stats.get('bytes_in_use')}")
    check(c.get("device_reads", 0) > 0, "no read was chained on the device")
    check(c.get("stall_fallback", 0) == 0, "stall fallback")


def phase_default_route(args, index, reads, host_sam):
    out = os.path.join(SMOKE_DIR, "default.sam")
    c = map_route("default route (--device gpu)",
                  ["-ax", "map-pb", "--device", "gpu", "-t",
                   str(os.cpu_count()), index, reads],
                  {"MM2TPU_DEVICE_FLOW": None}, out, args.reads)
    check(sam_body(out) == sam_body(host_sam),
          "default-route SAM differs from the host SAM")
    lanes = {k: c.get(k, 0) for k in ("steal_device_reads", "fast_native",
                                      "device_reads", "native_finish",
                                      "steal_dev_fallback")}
    log("[default] SAM byte-identical to --device host; lanes: "
        + " ".join(f"{k}={v}" for k, v in lanes.items()))


def host_route(args, index, reads):
    host_sam = os.path.join(SMOKE_DIR, "host.sam")
    map_route("host route (--device host)",
              ["-ax", "map-pb", "--device", "host", "-t",
               str(os.cpu_count()), index, reads], {}, host_sam, args.reads)
    return host_sam


def four_cards(args, index, reads, host_sam):
    import jax
    # index-sharded first: a card's peak then shows its quarter of the
    # tables before the replicated run raises it to the whole index
    for mesh in ("1x4", "4x1"):
        out = os.path.join(SMOKE_DIR, f"mesh{mesh}.sam")
        c = map_route(f"--mesh {mesh}",
                      ["-ax", "map-pb", "--device", "gpu", "--mesh", mesh,
                       "-t", str(os.cpu_count()), index, reads],
                      {}, out, args.reads)
        check(sam_body(out) == sam_body(host_sam),
              f"--mesh {mesh} SAM differs from the host SAM")
        stats = [d.memory_stats() or {} for d in jax.devices()[:4]]
        log(f"[mesh {mesh}] SAM byte-identical to --device host; "
            f"device_reads={c.get('device_reads', 0)}; per card "
            f"peak_bytes_in_use "
            f"{[m.get('peak_bytes_in_use') for m in stats]}, bytes_in_use "
            f"after the run {[m.get('bytes_in_use') for m in stats]}")
        check(c.get("device_reads", 0) > 0, f"--mesh {mesh}: no device read")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--genome-mb", type=int, default=DEFAULTS["genome_mb"])
    ap.add_argument("--reads", type=int, default=DEFAULTS["reads"])
    ap.add_argument("--read-len", type=int, default=DEFAULTS["read_len"])
    ap.add_argument("--parity-reads", type=int,
                    default=DEFAULTS["parity_reads"])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only --mesh 4x1 and --mesh 1x4 and their host "
                         "comparison, on four cards")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    try:
        import minimap2_chaindp_tpu  # noqa: F401
    except ImportError as e:
        print(f"[smoke] FAIL: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    cuts = [f"{k}={getattr(args, k)} (default {v})"
            for k, v in DEFAULTS.items() if getattr(args, k) != v]
    n_cards = 4 if args.four_cards else 1
    t_start = time.perf_counter()
    try:
        devs = phase_environment(n_cards)
        log(f"[env] cuts: {', '.join(cuts) if cuts else 'none'}")
        genome, index, reads = data_setup(args)
        if args.four_cards:
            host_sam = host_route(args, index, reads)
            four_cards(args, index, reads, host_sam)
        else:
            t0 = time.perf_counter()
            phase_kernel(args, index, reads)
            log(f"[kernel] phase time {time.perf_counter() - t0:.1f}s")
            host_sam = host_route(args, index, reads)
            phase_end_to_end(args, index, reads, host_sam)
            phase_default_route(args, index, reads, host_sam)
    except SmokeFailure as e:
        print(f"[smoke] FAIL: {e}", file=sys.stderr)
        return 1
    log(f"[smoke] all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
