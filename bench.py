#!/usr/bin/env python
"""Headline benchmark: chaining-DP throughput (anchors/s) of the batched
chaining pass on the attached GPU vs the reference's single-core chain.c
(mm_chain_dp_fpga). A run that finds no GPU fails; it prints no number.

Prints ONE JSON line:
  {"metric": "chaindp_anchors_per_s", "value": N, "unit": "anchors/s",
   "vs_baseline": N / single_core_reference_anchors_per_s, ...}
"""
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

# 8192 reads per dispatch: a large batch amortizes the per-call dispatch
# cost so the metric tracks the device
N_READS = int(os.environ.get("MM2TPU_BENCH_READS", "8192"))
ANCHORS_PER_READ = 1024
MAX_DIST = 5000
BW = 500
MAX_SKIP = 25
MIN_SC = 40


def baseline_anchors_per_s(reads):
    """Single-core reference chain.c throughput via the golden build.

    Stabilized (VERDICT r4 #4): each repeat loops the 64-read workload
    for a FIXED >=3 s work budget (chain_bench.c argv[6]) so the 1-core
    host's scheduler bursts average out — the old single ~40 ms pass
    swung the round-headline denominator 1.26M -> 2.43M anchors/s
    between rounds. Returns (best, {min, median, max, n}) or None."""
    root = os.path.dirname(os.path.abspath(__file__))
    bench = os.path.join(root, ".golden", "chain_bench")
    src = os.path.join(root, "golden", "chain_bench.c")
    if (not os.path.exists(bench)
            or os.path.getmtime(bench) < os.path.getmtime(src)):
        try:
            subprocess.run(["bash", os.path.join(root, "golden", "build_reference.sh")],
                           check=True, capture_output=True)
            subprocess.run(
                ["gcc", "-O2", "-std=gnu99", "-DHAVE_KALLOC", "-I/root/reference",
                 src,
                 os.path.join(root, ".golden", "chain.o"),
                 os.path.join(root, ".golden", "kalloc.o"),
                 os.path.join(root, ".golden", "misc.o"),
                 "-o", bench, "-lm", "-lz", "-lpthread"],
                check=True, capture_output=True)
        except Exception:
            return None
    sub = reads[:64]
    lines = [str(len(sub))]
    for a in sub:
        lines.append(str(len(a)))
        lines.extend(f"{int(x):x} {int(y):x}" for x, y in a)
    budget_s = float(os.environ.get("MM2TPU_BASELINE_BUDGET_S", "3"))
    rates = []
    for _ in range(3):
        out = subprocess.run(
            [bench, str(MAX_DIST), str(MAX_DIST), str(BW), str(MAX_SKIP),
             str(MIN_SC), str(budget_s)],
            input="\n".join(lines), capture_output=True, text=True,
            check=True)
        total, secs = out.stdout.split()
        rates.append(int(total) / float(secs))
    rates.sort()
    spread = {"min": round(rates[0], 1),
              "median": round(rates[len(rates) // 2], 1),
              "max": round(rates[-1], 1), "n": len(rates),
              "budget_s": budget_s}
    return rates[-1], spread


def _e2e_fields():
    """BASELINE.md scaling row: same-session end-to-end reads/s at 1 chip /
    1 host (400 x 10 kb map-ont SAM) for the host fast path, the calibrated
    --device gpu route, and the reference binary — each bounded so a hang
    can never block the JSON line. In-process steady-state timing (one
    warmup run paying index build / XLA compiles / link calibration, then
    three timed repeats, best taken) like the PERF.md tables — symmetric
    across devices, run as TWO alternating sessions per lane with pooled
    distributions so machine drift cannot favor whichever lane runs
    later. Each route also records its per-repeat distribution
    (min/median/max) and the gpu route records the link probe's own
    bandwidth + chosen routing, so the JSON self-describes the regime the
    numbers were captured in (VERDICT r2: best-case reporting)."""
    root = os.path.dirname(os.path.abspath(__file__))
    bench = os.path.join(root, "tools", "e2e_bench.py")
    fields = {}

    TAG = {"host": "e2e_reads_per_s_host",
           "gpu": "e2e_reads_per_s_gpu_calibrated"}

    def pair_session():
        """ONE e2e_bench process interleaving host/gpu runs run-by-run
        (alternating pair order): the 1-core host's bursty scheduler was
        measured swinging SAME-MODE sessions 526-690 reads/s, so separate
        per-lane sessions compare lottery tickets, not lanes. Pairing puts
        both lanes under near-identical machine state seconds apart.
        400 reads => ~0.8 s/repeat so scheduler noise does not dominate."""
        try:
            out = subprocess.run(
                [sys.executable, bench, "--reads", "400", "--len", "10000",
                 "--device", "pair", "--steady", "6"],
                capture_output=True, text=True, timeout=720, cwd=root)
            for line in out.stdout.splitlines():
                for dev, tag in TAG.items():
                    pat = f"steady[{dev}]:"
                    if pat in line:
                        fields[tag] = float(line.split(pat)[1].split()[0])
                if "paired_ratio_median:" in line:
                    # median of adjacent host/gpu run-time ratios (>= 1.0
                    # means the gpu route is at least as fast under the
                    # same machine state) — the contract statistic; the
                    # per-lane bests above still carry burst luck
                    fields["e2e_gpu_vs_host_paired_ratio"] = float(
                        line.split(":")[1])
            rates = {dev: [] for dev in TAG}
            for line in out.stderr.splitlines():
                if line.startswith("run") and "reads/s" in line:
                    if line.startswith("run0"):
                        continue   # both lanes' warmup iteration
                    for dev in TAG:
                        if f"[{dev}]" in line:
                            rates[dev].append(
                                float(line.split(":")[1].split()[0]))
                if line.startswith("[calibrate]"):
                    # "[calibrate] d2h=XMB/s device_flow=on flow_share=Y"
                    for tok in line.split():
                        if tok.startswith("d2h="):
                            fields["link_mbps"] = float(
                                tok[4:].replace("MB/s", ""))
                        elif tok.startswith("device_flow="):
                            fields["link_flow"] = tok.split("=")[1]
                        elif tok.startswith("flow_share="):
                            fields["link_flow_share"] = float(
                                tok.split("=")[1])
            for dev, tag in TAG.items():
                srt = sorted(rates[dev])
                if srt:
                    fields[tag + "_runs"] = {
                        "min": srt[0], "median": srt[len(srt) // 2],
                        "max": srt[-1], "n": len(srt)}
        except Exception:
            pass
        for tag in TAG.values():
            fields.setdefault(tag, None)

    def one(tag, args, pat, tmo):
        try:
            out = subprocess.run(
                [sys.executable, bench, "--reads", "400", "--len", "10000",
                 *args], capture_output=True, text=True, timeout=tmo,
                cwd=root)
            for line in out.stdout.splitlines():
                if pat in line:
                    fields[tag] = float(line.split(pat)[1].split()[0])
        except Exception:
            pass
        fields.setdefault(tag, None)

    pair_session()
    one("e2e_reads_per_s_reference_binary", ["--ref"], "reference:", 300)
    return fields


def _refpair_fields(tag, extra_args, timeout):
    """One paired framework-vs-reference-binary capture (e2e_bench
    --device refpair: lanes interleaved run-by-run so the 1-core host's
    scheduler bursts hit both alike; the binary runs under the hang
    watchdog). Fields are prefixed with `tag`; ratio > 1 means the
    framework is faster."""
    root = os.path.dirname(os.path.abspath(__file__))
    bench = os.path.join(root, "tools", "e2e_bench.py")
    fields = {}
    try:
        out = subprocess.run(
            [sys.executable, bench, *extra_args,
             "--device", "refpair", "--steady", "4"],
            capture_output=True, text=True, timeout=timeout, cwd=root)
        for line in out.stdout.splitlines():
            if "steady[host]:" in line:
                fields[f"{tag}_reads_per_s_host"] = float(
                    line.split("steady[host]:")[1].split()[0])
            elif "steady[ref]:" in line:
                fields[f"{tag}_reads_per_s_reference_binary"] = float(
                    line.split("steady[ref]:")[1].split()[0])
            elif "refpair_ratio_median:" in line:
                fields[f"{tag}_host_vs_ref_paired_ratio"] = float(
                    line.split(":")[1])
            elif "ref_hangs:" in line:
                fields[f"{tag}_ref_hangs"] = int(line.split(":")[1])
    except Exception:
        pass
    for suffix in ("reads_per_s_host", "reads_per_s_reference_binary",
                   "host_vs_ref_paired_ratio"):
        fields.setdefault(f"{tag}_{suffix}", None)
    return fields


def _e2e_sr150_fields():
    """Illumina-regime row: the reference's own headline is short reads
    ("three times as fast" than BWA-MEM, README.md:67-68; sr preset
    options.c:124) — 150 bp / 0.5% error under -ax sr."""
    return _refpair_fields("e2e_sr150",
                           ["--reads", "8000", "--len", "150",
                            "--err", "0.005", "--preset", "sr"], 600)


def _e2e_1kb_fields():
    """Short-read regime row (VERDICT r3 #2): 1 kb ONT-like reads."""
    return _refpair_fields("e2e_1kb",
                           ["--reads", "2000", "--len", "1000"], 900)


def _e2e_engaged_fields():
    """Engaged-regime capture: a long paired host/gpu session with the
    run's flow and steal-lane telemetry recorded."""
    root = os.path.dirname(os.path.abspath(__file__))
    bench = os.path.join(root, "tools", "e2e_bench.py")
    n_reads = int(os.environ.get("MM2TPU_BENCH_ENGAGED_READS", "12000"))
    fields = {"e2e_engaged_reads": n_reads}
    try:
        # one link measurement serves the whole capture
        env = {**os.environ}
        env.setdefault("MM2TPU_PROBE_TTL_S", "900")
        out = subprocess.run(
            [sys.executable, bench, "--reads", str(n_reads),
             "--len", "10000", "--device", "pair", "--steady", "3"],
            capture_output=True, text=True, timeout=1800, cwd=root,
            env=env)
        for line in out.stdout.splitlines():
            if "steady[host]:" in line:
                fields["e2e_engaged_reads_per_s_host"] = float(
                    line.split("steady[host]:")[1].split()[0])
            elif "steady[gpu]:" in line:
                fields["e2e_engaged_reads_per_s_gpu"] = float(
                    line.split("steady[gpu]:")[1].split()[0])
            elif "paired_ratio_median:" in line:
                fields["e2e_engaged_paired_ratio"] = float(
                    line.split(":")[1])
        flow = {"device_reads": 0, "retired": 0, "retired_persisted": 0}
        steal = {}
        for line in out.stderr.splitlines():
            if line.startswith("flow") and "[gpu]:" in line:
                for tok in line.split()[1:]:
                    k, v = tok.split("=")
                    if k in ("retired", "retired_persisted"):
                        flow[k] += int(v)
                    elif k in flow:
                        flow[k] = max(flow[k], int(v))
            elif line.startswith("steal") and "[gpu]:" in line:
                # keep the run with the most stolen reads (counters are
                # per-run; the best-engaged run describes the lane)
                toks = dict(t.split("=") for t in line.split()[1:])
                if int(toks.get("steal_reads", 0)) >= steal.get(
                        "steal_reads", -1):
                    steal = {k: int(v) for k, v in toks.items()}
            elif line.startswith("[calibrate]"):
                for tok in line.split():
                    if tok.startswith("d2h="):
                        fields["e2e_engaged_link_mbps"] = float(
                            tok[4:].replace("MB/s", ""))
                    elif tok.startswith("device_flow="):
                        fields["e2e_engaged_link_flow"] = tok.split("=")[1]
                    elif tok.startswith("flow_share="):
                        fields["e2e_engaged_flow_share"] = float(
                            tok.split("=")[1])
        fields["e2e_engaged_device_reads_best_run"] = flow["device_reads"]
        fields["e2e_engaged_retirements"] = (flow["retired"]
                                             + flow["retired_persisted"])
        # steal-lane journey (r5): reads the work-stealing device lane
        # completed in its best run, its measured host-CPU cost per read
        # (the r4 "dispatch prep is asserted, never measured" gap), and
        # the economics guard's activity
        if steal:
            n = steal.get("steal_reads", 0)
            fields["e2e_engaged_steal_reads_best_run"] = n
            fields["e2e_engaged_steal_cpu_ms_per_read"] = (
                round(steal.get("steal_cpu_ms", 0) / n, 2) if n else None)
            fields["e2e_engaged_steal_cpu_split_ms"] = {
                k.replace("steal_", "").replace("_ms", ""):
                    steal.get(k, 0)
                for k in ("steal_prep_ms", "steal_flowhost_ms",
                          "steal_dispatch_ms", "steal_finish_ms")}
            fields["e2e_engaged_steal_paused"] = steal.get(
                "steal_paused", 0)
            fields["e2e_engaged_steal_probes"] = steal.get(
                "steal_probe", 0)
    except Exception:
        pass
    for tag in ("e2e_engaged_reads_per_s_host", "e2e_engaged_reads_per_s_gpu",
                "e2e_engaged_paired_ratio"):
        fields.setdefault(tag, None)
    return fields


def _e2e_genome_engaged_fields():
    """Genome-scale engaged capture (r5): the steal lane's economics are
    index-scale-dependent — at 3 Gbp map-pb (the fork's own flagship
    regime, run.sh:3) a stolen read saves 3.2 ms of host collect+chain
    CPU and costs ~3.2 ms total, so the lane PAYS where the MT capture's
    correctly pauses. Runs only when the 3 Gbp assets from the r5 session
    exist on this machine (tools/hpc_study.py + an .mm2i dump rebuild
    them); skips cleanly otherwise. Protocol identical to the MT engaged
    pair (steal telemetry per run, paired ratio as the contract stat)."""
    root = os.path.dirname(os.path.abspath(__file__))
    ref = "/tmp/genome_scale/genome3000.fa"
    idx = "/tmp/genome_scale/pb3000.mm2i"
    fields = {}
    if not (os.path.exists(ref) and os.path.exists(idx)):
        return {"e2e_genome_engaged": "skipped (no 3 Gbp assets on host)"}
    bench = os.path.join(root, "tools", "e2e_bench.py")
    try:
        env = {**os.environ}
        env.setdefault("MM2TPU_PROBE_TTL_S", "1800")
        out = subprocess.run(
            [sys.executable, bench, "--ref-fa", ref, "--index", idx,
             "--preset", "map-pb", "--reads", "4000", "--len", "10000",
             "--device", "pair", "--steady", "3"],
            capture_output=True, text=True, timeout=2400, cwd=root,
            env=env)
        for line in out.stdout.splitlines():
            if "steady[host]:" in line:
                fields["e2e_genome_engaged_reads_per_s_host"] = float(
                    line.split("steady[host]:")[1].split()[0])
            elif "steady[gpu]:" in line:
                fields["e2e_genome_engaged_reads_per_s_gpu"] = float(
                    line.split("steady[gpu]:")[1].split()[0])
            elif "paired_ratio_median:" in line:
                fields["e2e_genome_engaged_paired_ratio"] = float(
                    line.split(":")[1])
        best = {}
        for line in out.stderr.splitlines():
            if line.startswith("steal") and "[gpu]:" in line:
                toks = dict(t.split("=") for t in line.split()[1:])
                if int(toks.get("steal_reads", 0)) >= int(
                        best.get("steal_reads", -1)):
                    best = toks
        if best:
            n = int(best.get("steal_reads", 0))
            fields["e2e_genome_engaged_steal_reads_best_run"] = n
            fields["e2e_genome_engaged_steal_frac"] = round(n / 4000.0, 3)
            fields["e2e_genome_engaged_steal_cpu_ms_per_read"] = (
                round(int(best.get("steal_cpu_ms", 0)) / n, 2) if n
                else None)
    except Exception:
        pass
    for tag in ("e2e_genome_engaged_reads_per_s_host",
                "e2e_genome_engaged_reads_per_s_gpu",
                "e2e_genome_engaged_paired_ratio"):
        fields.setdefault(tag, None)
    return fields


def main():
    """Driver entry: run the device measurement in a child process with a
    timeout; a child that fails or finds no GPU fails the bench."""
    per_try_s = float(os.environ.get("MM2TPU_BENCH_TIMEOUT_S", "600"))
    rec = None
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child"],
        capture_output=True, text=True, timeout=per_try_s)
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            break
    if rec is None:
        sys.stderr.write(out.stderr[-4000:])
        raise SystemExit("bench: the device measurement failed")
    if os.environ.get("MM2TPU_BENCH_E2E", "1") == "1":
        rec.update(_e2e_fields())
        rec.update(_e2e_1kb_fields())
        rec.update(_e2e_sr150_fields())
    if os.environ.get("MM2TPU_BENCH_ENGAGED", "1") == "1":
        rec.update(_e2e_engaged_fields())
        rec.update(_e2e_genome_engaged_fields())
    rec.update(_drift_fields(rec))
    print(json.dumps(rec))


def _drift_fields(rec):
    """Self-describing drift posture (VERDICT r4 #8): absolute reads/s
    fields on this shared 1-core host swing 2-3x round-to-round with
    machine load (host 688->559, reference 361->193 across r3->r4 with no
    code change) — only the *_paired_ratio fields and the on-chip kernel
    anchors/s carry cross-round signal. Also a warn-only tripwire: compare
    this run's ratio/kernel fields against the newest BENCH_r*.json."""
    import glob
    import re
    fields = {"drift_note": (
        "absolute *_reads_per_s_* fields are machine-drifting on this "
        "shared 1-core host (2-3x swings round-to-round); compare rounds "
        "via *_paired_ratio fields and the kernel anchors/s only")}
    warns = []
    try:
        root = os.path.dirname(os.path.abspath(__file__))
        benches = sorted(
            glob.glob(os.path.join(root, "BENCH_r*.json")),
            key=lambda p: int(re.search(r"_r(\d+)", p).group(1)))
        if benches:
            prev_path = benches[-1]
            with open(prev_path) as f:
                prev = json.load(f)
            fields["drift_baseline_round"] = os.path.basename(prev_path)
            v0, v1 = prev.get("value"), rec.get("value")
            # only compare like with like: both on-device kernel numbers
            both_dev = all("native host path" not in str(
                r.get("device", "")) and "unreachable" not in str(
                r.get("device", "")) for r in (prev, rec))
            if both_dev and v0 and v1 and v1 < 0.8 * v0:
                warns.append(f"kernel anchors/s {v1:.3g} < 80% of "
                             f"{os.path.basename(prev_path)}'s {v0:.3g}")
            for k in sorted(set(prev) & set(rec)):
                if not k.endswith("paired_ratio"):
                    continue
                r0, r1 = prev.get(k), rec.get(k)
                if (isinstance(r0, (int, float))
                        and isinstance(r1, (int, float))
                        and r1 < r0 - 0.05):
                    warns.append(f"{k} {r1:.3f} < {r0:.3f} - 0.05")
    except Exception:
        pass
    fields["regression_warnings"] = warns
    return fields


def main_device():
    from minimap2_chaindp_tpu.utils.compile_cache import \
        enable_persistent_cache
    enable_persistent_cache()
    import jax
    from minimap2_chaindp_tpu.utils.synth import synth_batch
    from minimap2_chaindp_tpu.ops.chain_jax import split_anchors
    from minimap2_chaindp_tpu.ops import chain_batch as CB

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: no GPU (JAX platform {dev.platform})")

    max_n = (ANCHORS_PER_READ + 127) // 128 * 128

    def pack(seed):
        anchors = synth_batch(N_READS, ANCHORS_PER_READ, seed=seed)
        reads = []
        for a in anchors:
            xhi, rpos, qpos, span, sid = split_anchors(a)
            reads.append(dict(xhi=xhi, rpos=rpos, qpos=qpos, span=span, sid=sid,
                              avg_qspan=np.float32(span.sum()) / np.float32(len(a))))
        packed, nn, w1, exc, host_flag = CB.pack_reads(reads, max_n, MAX_DIST)
        args = [jax.device_put(packed[k])
                for k in ("xhi", "rpos", "qpos", "span", "sid", "stw")]
        args += [jax.device_put(nn), jax.device_put(w1), jax.device_put(exc)]
        jax.block_until_ready(args)  # materialize host->device before timing
        return anchors, args

    def dispatch(args):
        return CB.chain_scores_batch(*args, max_n=max_n, max_dist_x=MAX_DIST,
                    max_dist_y=MAX_DIST, bw=BW, max_skip=MAX_SKIP,
                    is_cdna=False, many_segs=False)

    n_iter = 3
    batches = [pack(s) for s in range(n_iter + 1)]
    jax.block_until_ready(dispatch(batches[0][1]))  # warmup/compile
    # pipelined dispatch — the runtime's production shape (DeviceFlow and
    # _chain_batch stage every bucket's dispatch before blocking on any
    # result); best of 2 timed pipelines
    total_anchors = N_READS * ANCHORS_PER_READ * n_iter
    value, flagged = 0.0, 0
    for _rep in range(2):
        t0 = time.perf_counter()
        outs = [dispatch(batches[it + 1][1]) for it in range(n_iter)]
        flagged = sum(int(np.asarray(flag).sum()) for _f, _p, flag in outs)
        t1 = time.perf_counter()
        value = max(value, total_anchors / (t1 - t0))

    bl = baseline_anchors_per_s(batches[0][0])
    base, spread = bl if bl else (None, None)
    rec = {
        "metric": "chaindp_anchors_per_s",
        "value": round(value, 1),
        "unit": "anchors/s",
        "vs_baseline": round(value / base, 3) if base else None,
        "baseline_single_core_c": round(base, 1) if base else None,
        "baseline_spread": spread,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "reads": N_READS,
        "anchors_per_read": ANCHORS_PER_READ,
        "fallback_flagged_reads": flagged,
    }
    print(json.dumps(rec))


if __name__ == "__main__":
    if "--child" in sys.argv:
        main_device()
    else:
        main()
