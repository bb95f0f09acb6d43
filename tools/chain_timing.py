#!/usr/bin/env python
"""Time the chaining implementations on the GPU: the CUDA kernel
(ops/chain_cuda.py) against the plain jnp/lax version that XLA compiles
(ops/chain_jax.chain_scores_batch_xla), both on the card.

  --bench  the bench shape: 8192 reads x 1024 synthetic anchors,
           max_dist 5000, bw 500; warm calls timed in turns (kernel,
           plain, plain, kernel, ...), outputs checked equal.
  --e2e    end to end: the smoke test's genome, index and reads
           (chip_smoke.py data set-up, cached under build/smoke/) mapped
           with MM2TPU_DEVICE_FLOW=1 through the CLI, once with each
           implementation behind ops/chain_batch.chain_impl; one untimed
           warm run each, then timed runs in turns; SAMs checked equal.

Everything runs in this one process. Prints the card's name and power
limit first; every number is a wall-clock time on the card named there.

Usage:
  python tools/chain_timing.py --bench --e2e [--genome-mb 1000]
      [--reads 2000] [--seed 7] [--reps 2]
"""
import argparse
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def bench_shape(reps: int) -> None:
    import jax
    import numpy as np
    from minimap2_chaindp_tpu.ops import chain_batch as CB
    from minimap2_chaindp_tpu.ops.chain_jax import (chain_scores_batch_xla,
                                                    split_anchors)
    from minimap2_chaindp_tpu.utils.synth import synth_batch
    n_reads, n_anchors = 8192, 1024
    reads = []
    for a in synth_batch(n_reads, n_anchors, seed=0):
        xhi, rpos, qpos, span, sid = split_anchors(a)
        reads.append(dict(xhi=xhi, rpos=rpos, qpos=qpos, span=span, sid=sid,
                          avg_qspan=np.float32(span.sum())
                          / np.float32(len(a))))
    packed, nn, w1, exc, _ = CB.pack_reads(reads, n_anchors, 5000)
    ins = [jax.device_put(packed[k]) for k in
           ("xhi", "rpos", "qpos", "span", "sid", "stw")]
    ins += [jax.device_put(x) for x in (nn, w1, exc)]
    kw = dict(max_n=n_anchors, max_dist_x=5000, max_dist_y=5000, bw=500,
              max_skip=25, is_cdna=False, many_segs=False)
    kernel = lambda *a: CB.chain_scores_batch(*a, **kw)
    plain = lambda *a: chain_scores_batch_xla(*a, **kw)
    impls = {"kernel": kernel, "plain": plain}
    outs = {}
    for name, fn in impls.items():
        t0 = time.perf_counter()
        outs[name] = [np.asarray(x) for x in jax.block_until_ready(fn(*ins))]
        print(f"[bench] {name}: first call (compile + run) "
              f"{time.perf_counter() - t0:.2f}s", flush=True)
    same = all(np.array_equal(a, b)
               for a, b in zip(outs["kernel"], outs["plain"]))
    print(f"[bench] kernel and plain outputs equal: {same}; flagged "
          f"{int(outs['kernel'][2].sum())} of {n_reads}", flush=True)
    times = {k: [] for k in impls}
    order = ["kernel", "plain", "plain", "kernel"] * reps
    for name in order:
        t0 = time.perf_counter()
        jax.block_until_ready(impls[name](*ins))
        times[name].append(time.perf_counter() - t0)
    for name, ts in times.items():
        med = statistics.median(ts)
        print(f"[bench] {name}: median {med * 1e3:.2f} ms per call over "
              f"{len(ts)} calls (min {min(ts) * 1e3:.2f}, max "
              f"{max(ts) * 1e3:.2f}); {n_reads * n_anchors / med:.4g} "
              f"anchors/s", flush=True)
    if not same:
        raise SystemExit("kernel and plain outputs differ")


def end_to_end(args) -> None:
    import chip_smoke as S
    from minimap2_chaindp_tpu.ops import chain_batch as CB
    from minimap2_chaindp_tpu.ops.chain_jax import chain_scores_batch_xla
    from minimap2_chaindp_tpu.models import device_flow as DF
    genome, index, reads = S.data_setup(args)
    impls = {"kernel": CB.chain_impl,
             "plain": lambda platform: chain_scores_batch_xla}
    # one jit wrapper per implementation for the fused flow and the
    # chaining pass, so neither reuses the other's traces
    flows, passes = {}, {}
    make_flow, make_pass = DF._jit_flow.__wrapped__, CB._jitted.__wrapped__

    def use(name):
        CB.chain_impl = impls[name]
        flows.setdefault(name, make_flow())
        passes.setdefault(name, make_pass())
        DF._jit_flow = lambda: flows[name]
        CB._jitted = lambda: passes[name]

    sams = {}
    times = {"kernel": [], "plain": []}
    order = ["kernel", "plain"] + ["kernel", "plain", "plain", "kernel"] \
        * args.reps
    for k, name in enumerate(order):
        use(name)
        out = os.path.join(S.SMOKE_DIR, f"timing_{name}.sam")
        t0 = time.perf_counter()
        rc, c = S.run_cli(["-ax", "map-pb", "-t", str(os.cpu_count()),
                           index, reads], {"MM2TPU_DEVICE_FLOW": "1"}, out)
        dt = time.perf_counter() - t0
        if rc != 0:
            raise SystemExit(f"{name} run failed")
        sams.setdefault(name, S.sam_body(out))
        warm = k < 2
        if not warm:
            times[name].append(dt)
        print(f"[e2e] {name}{' (warm-up)' if warm else ''}: {dt:.2f}s, "
              f"{args.reads / dt:.1f} reads/s, device_reads="
              f"{c.get('device_reads', 0)}", flush=True)
    use("kernel")
    for name, ts in times.items():
        med = statistics.median(ts)
        print(f"[e2e] {name}: median {med:.2f}s = {args.reads / med:.1f} "
              f"reads/s over {len(ts)} runs", flush=True)
    if sams["kernel"] != sams["plain"]:
        raise SystemExit("kernel and plain SAMs differ")
    print("[e2e] kernel and plain SAMs identical", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bench", action="store_true")
    ap.add_argument("--e2e", action="store_true")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--genome-mb", type=int, default=1000)
    ap.add_argument("--reads", type=int, default=2000)
    ap.add_argument("--read-len", type=int, default=10000)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU (JAX platform {dev.platform})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"[env] card: {smi.stdout.strip().splitlines()[0]}; jax "
          f"{jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}",
          flush=True)
    if args.bench:
        bench_shape(args.reps)
    if args.e2e:
        end_to_end(args)


if __name__ == "__main__":
    main()
