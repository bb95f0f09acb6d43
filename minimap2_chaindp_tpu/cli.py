"""minimap2-compatible command-line interface.

Mirrors the reference's option surface (main.c:42-82 long options, :319-428
option loop) so reference users can switch without changing invocations:

  mm2tpu [options] target.fa query.fa [query2.fa] > out.{paf,sam}
"""
from __future__ import annotations

import argparse
import os
import sys

from . import constants as C
from .options import IndexOptions, MapOptions, set_opt, check_opt

# flow telemetry of the most recent _main() mapping run (see bottom of
# _main): counters dict, for in-process bench drivers
LAST_RUN_COUNTERS: dict = {}
from .io.fastx import read_fastx, read_frags
from .io.output import write_sam_hdr, parse_rg_id
from .index.build import build_index

VERSION = "0.1.0 (minimap2 2.10-r761 compatible)"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mm2tpu", add_help=True,
        description="GPU-accelerated minimap2-compatible long/short-read "
                    "aligner")
    a = p.add_argument
    # indexing
    a("-H", dest="hpc", action="store_true", help="use homopolymer-compressed k-mer")
    a("-k", type=int, default=None, help="k-mer size")
    a("-w", type=int, default=None, help="minimizer window size")
    a("-I", dest="batch_size", default=None, help="split index for every ~NUM bases")
    a("-d", dest="dump_index", default=None, help="dump index to file")
    # mapping
    a("-f", dest="mid_occ_frac", type=float, default=None)
    a("-g", dest="max_gap", default=None)   # _si: k/m/g ok
    a("-G", dest="max_intron_len", default=None)
    a("-F", dest="max_frag_len", default=None)
    a("-r", dest="bw", default=None)
    a("-n", "--min-count", dest="min_cnt", type=int, default=None)
    a("-m", "--min-chain-score", dest="min_chain_score", type=int,
      default=None)
    a("-X", dest="ava", action="store_true", help="skip self and dual mappings")
    a("-D", "--no-self", dest="no_diag", action="store_true",
      help="skip self mappings")
    a("-P", "--all-chain", dest="all_chains", action="store_true",
      help="retain all chains")
    a("-M", dest="mask_level", type=float, default=None)
    a("-C", "--cost-non-gt-ag", dest="noncan", type=int, default=None,
      help="cost of non-canonical splicing sites")
    a("-Y", dest="softclip2", action="store_true",
      help="use soft clipping for supplementary alignments")
    a("-y", dest="copy_comment", action="store_true")
    a("-v", dest="verbose", type=int, default=None)
    a("-2", dest="io_threads2", action="store_true",
      help="use two IO threads (always on: pipeline prefetching)")
    a("-V", action="version", version=VERSION)
    a("--bucket-bits", type=int, default=None)
    a("--seed", type=int, default=None)
    a("--mask-level", dest="mask_level2", type=float, default=None)
    a("--max-chain-skip", type=int, default=None)
    a("--min-dp-len", type=int, default=None)
    a("--end-bonus", type=int, default=None)
    a("--no-pairing", action="store_true")
    a("--splice-flank", default=None, choices=["yes", "no"])
    a("--idx-no-seq", action="store_true")
    a("--end-seed-pen", type=int, default=None)
    a("--dual", default=None, choices=["yes", "no"])
    a("--max-clip-ratio", type=float, default=None)
    a("--min-occ-floor", type=int, default=None)
    a("--no-kalloc", action="store_true", help="(accepted for compatibility)")
    a("--heap-sort", default=None, help="(accepted for compatibility)")
    a("--print-qname", action="store_true")
    a("--print-seeds", action="store_true",
      help="debug: dump per-chain anchors (CN lines) to stderr")
    a("--print-aln-seq", action="store_true",
      help="debug: dump each DP problem's sequences to stderr")
    a("-T", dest="sdust_thres", type=int, default=None,
      help="SDUST threshold; 0 to disable low-complexity minimizer masking")
    a("-p", dest="pri_ratio", type=float, default=None)
    a("-N", dest="best_n", type=int, default=None)
    # alignment
    a("-A", dest="match", type=int, default=None)
    a("-B", dest="mismatch", type=int, default=None)
    a("-O", dest="gap_open", default=None)
    a("-E", dest="gap_ext", default=None)
    a("-z", dest="zdrop", default=None)
    a("-s", "--min-dp-score", dest="min_dp_max", type=int, default=None)
    a("-u", dest="splice_strand", default=None)
    # io
    a("-a", "--sam", dest="sam", action="store_true", help="output SAM")
    a("-c", dest="cigar", action="store_true", help="output CIGAR in PAF")
    a("-Q", dest="no_qual", action="store_true")
    a("-L", dest="long_cigar", action="store_true")
    a("-R", dest="rg", default=None, help="SAM read group line")
    a("-t", dest="threads", type=int, default=3)
    a("-K", "--mb-size", dest="mini_batch", default=None)
    a("-x", dest="preset", default=None)
    a("--cs", dest="cs", nargs="?", const="short", default=None)
    a("--MD", dest="md", action="store_true")
    a("--for-only", action="store_true")
    a("--rev-only", action="store_true")
    a("--secondary", default=None, choices=["yes", "no", "y", "n"])
    a("--frag", default=None, choices=["yes", "no", "y", "n"])
    a("--sr", action="store_true")
    a("--splice", action="store_true")
    a("--no-long-join", action="store_true")
    a("--max-intron-len", dest="max_intron_len2", default=None)
    a("--soft-clipped", dest="softclip", action="store_true")
    a("--device", default="auto", choices=["auto", "host", "gpu"],
      help="compute path: host only, the GPU (seed collection and "
           "chaining on the device; fails without one), or auto (the GPU "
           "when JAX has one, else the host)")
    a("--mesh", default=None, metavar="DATAxINDEX",
      help="multi-device mesh, e.g. 4x1: reads data-parallel over DATA "
           "devices, index key-range-sharded over INDEX devices (genomes "
           "larger than one device's memory); output stays "
           "byte-identical")
    a("--version", action="version", version=VERSION)
    a("target")
    a("query", nargs="*")
    return p


def _run_debug_sequential(mi, mo, ns, rg_id, out, part_no, is_multi,
                          argv_disp) -> None:
    """--print-seeds / --print-aln-seq: single-threaded per-fragment mapping
    so the stderr dumps interleave deterministically (reference forces
    n_threads=1, main.c:358/361). QR/QM lines per map.c:606/449."""
    from .models.pipeline import map_fragment_output
    from .utils import mlog
    if (mo.flag & C.MM_F_OUT_SAM) and part_no == 1:
        if is_multi:
            print("[WARNING] For a multi-part index, no @SQ lines will "
                  "be outputted.", file=sys.stderr)
        print(write_sam_hdr(None if is_multi else mi, ns.rg, "2.10-r761",
                            "mm2tpu " + " ".join(argv_disp)), file=out)
    frag_mode = len(ns.query) > 1 or bool(mo.flag & C.MM_F_FRAG_MODE)
    for batch in read_frags(ns.query, mo.mini_batch_size, frag_mode):
        for frag in batch:
            s0 = frag.segs[0]
            print(f"QR\t{s0.name}\t0\t{len(s0.seq)}", file=sys.stderr)
            # QM follows the front half, before any result dump (map.c:449)
            qlen_sum = sum(len(s.seq) for s in frag.segs)
            print(f"QM\t{s0.name}\t{qlen_sum}\tcap=0,nCore=0,largest=0",
                  file=sys.stderr)
            lines = map_fragment_output(mi, mo, frag.segs, rg_id)
            for line in lines:
                print(line, file=out)
        mlog.mlog("worker_pipeline",
                  f"mapped {sum(len(f.segs) for f in batch)} sequences")


def _si(v) -> int:
    """Reference mm_parse_num (main.c:84-93): strtod's leading number, one
    optional k/m/g suffix, trailing junk ignored, rounded via +.499."""
    if v is None:
        return 0
    import re as _re
    s = str(v)
    m = _re.match(r"\s*[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?", s)
    if not m:
        return 0
    x = float(m.group(0))
    rest = s[m.end():]
    if rest[:1] in ("g", "G"):
        x *= 1e9
    elif rest[:1] in ("m", "M"):
        x *= 1e6
    elif rest[:1] in ("k", "K"):
        x *= 1e3
    return int(x + .499)


def apply_args(ns, io: IndexOptions, mo: MapOptions) -> None:
    if ns.hpc:
        io.flag |= C.MM_I_HPC
    if ns.k is not None:
        io.k = ns.k
    if ns.w is not None:
        io.w = ns.w
    if ns.batch_size is not None:
        io.batch_size = _si(ns.batch_size)
    if ns.mid_occ_frac is not None:
        mo.mid_occ_frac = ns.mid_occ_frac
    if ns.max_gap is not None:
        mo.max_gap = _si(ns.max_gap)
    if ns.max_frag_len is not None:
        mo.max_frag_len = _si(ns.max_frag_len)
    if ns.bw is not None:
        mo.bw = _si(ns.bw)
    if ns.min_cnt is not None:
        mo.min_cnt = ns.min_cnt
    if ns.min_chain_score is not None:
        mo.min_chain_score = ns.min_chain_score
    if ns.ava:  # -X = -D -P --no-long-join --dual=no (main.c:336)
        mo.flag |= (C.MM_F_ALL_CHAINS | C.MM_F_NO_DIAG | C.MM_F_NO_DUAL
                    | C.MM_F_NO_LJOIN)
    if ns.no_diag:
        mo.flag |= C.MM_F_NO_DIAG
    if ns.all_chains:
        mo.flag |= C.MM_F_ALL_CHAINS
    for v in (ns.mask_level, ns.mask_level2):
        if v is not None:
            mo.mask_level = v
    if ns.noncan is not None:
        mo.noncan = ns.noncan
    if ns.softclip2:
        mo.flag |= C.MM_F_SOFTCLIP
    if ns.copy_comment:
        mo.flag |= C.MM_F_COPY_COMMENT
    if ns.bucket_bits is not None:
        io.bucket_bits = ns.bucket_bits
    if ns.seed is not None:
        mo.seed = ns.seed
    if ns.max_chain_skip is not None:
        mo.max_chain_skip = ns.max_chain_skip
    if ns.min_dp_len is not None:
        mo.min_ksw_len = ns.min_dp_len
    if ns.end_bonus is not None:
        mo.end_bonus = ns.end_bonus
    if ns.no_pairing:
        mo.flag |= C.MM_F_INDEPEND_SEG
    if ns.splice_flank == "yes":
        mo.flag |= C.MM_F_SPLICE_FLANK
    elif ns.splice_flank == "no":
        mo.flag &= ~C.MM_F_SPLICE_FLANK
    if ns.idx_no_seq:
        io.flag |= C.MM_I_NO_SEQ
    if ns.end_seed_pen is not None:
        mo.anchor_ext_shift = ns.end_seed_pen
    if ns.dual == "no":
        mo.flag |= C.MM_F_NO_DUAL
    elif ns.dual == "yes":
        mo.flag &= ~C.MM_F_NO_DUAL
    if ns.max_clip_ratio is not None:
        mo.max_clip_ratio = ns.max_clip_ratio
    if ns.min_occ_floor is not None:
        mo.min_mid_occ = ns.min_occ_floor
    if ns.splice_strand is not None:
        u = ns.splice_strand
        if u == "b":
            mo.flag |= C.MM_F_SPLICE_FOR | C.MM_F_SPLICE_REV
        elif u == "f":
            mo.flag = (mo.flag | C.MM_F_SPLICE_FOR) & ~C.MM_F_SPLICE_REV
        elif u == "r":
            mo.flag = (mo.flag | C.MM_F_SPLICE_REV) & ~C.MM_F_SPLICE_FOR
        elif u == "n":
            mo.flag &= ~(C.MM_F_SPLICE_FOR | C.MM_F_SPLICE_REV)
        else:
            raise SystemExit("[ERROR] unrecognized cDNA direction")
    if ns.sdust_thres is not None:
        mo.sdust_thres = ns.sdust_thres
    if ns.pri_ratio is not None:
        mo.pri_ratio = ns.pri_ratio
    if ns.best_n is not None:
        mo.best_n = ns.best_n
    if ns.match is not None:
        mo.a = ns.match
    if ns.mismatch is not None:
        mo.b = ns.mismatch
    if ns.gap_open is not None:
        parts = str(ns.gap_open).split(",")
        mo.q = int(parts[0])
        if len(parts) > 1:
            mo.q2 = int(parts[1])
    if ns.gap_ext is not None:
        parts = str(ns.gap_ext).split(",")
        mo.e = int(parts[0])
        if len(parts) > 1:
            mo.e2 = int(parts[1])
    if ns.zdrop is not None:
        parts = str(ns.zdrop).split(",")
        mo.zdrop = int(parts[0])
        if len(parts) > 1:
            mo.zdrop_inv = int(parts[1])
    if ns.min_dp_max is not None:
        mo.min_dp_max = ns.min_dp_max
    if ns.sam:
        mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR
    if ns.cigar:
        mo.flag |= C.MM_F_OUT_CG | C.MM_F_CIGAR
    if ns.no_qual:
        mo.flag |= C.MM_F_NO_QUAL
    if ns.long_cigar:
        mo.flag |= C.MM_F_LONG_CIGAR
    if ns.cs is not None:
        mo.flag |= C.MM_F_OUT_CS | C.MM_F_CIGAR
        if ns.cs == "long":
            mo.flag |= C.MM_F_OUT_CS_LONG
    if ns.md:
        mo.flag |= C.MM_F_OUT_MD | C.MM_F_CIGAR
    if ns.for_only:
        mo.flag |= C.MM_F_FOR_ONLY
    if ns.rev_only:
        mo.flag |= C.MM_F_REV_ONLY
    if ns.secondary in ("no", "n"):       # yes_or_no both ways
        mo.flag |= C.MM_F_NO_PRINT_2ND     # (main.c:95-106)
    elif ns.secondary in ("yes", "y"):
        mo.flag &= ~C.MM_F_NO_PRINT_2ND
    if ns.frag in ("yes", "y"):
        mo.flag |= C.MM_F_FRAG_MODE
    elif ns.frag in ("no", "n"):
        mo.flag &= ~C.MM_F_FRAG_MODE
    if ns.no_long_join:
        mo.flag |= C.MM_F_NO_LJOIN
    if ns.softclip:
        mo.flag |= C.MM_F_SOFTCLIP
    if ns.mini_batch is not None:
        mo.mini_batch_size = _si(ns.mini_batch)
    for v in (ns.max_intron_len, ns.max_intron_len2):
        if v is not None:
            mo.max_intron_len(_si(v))


def device_platform(want_device: bool):
    """The JAX platform the device runtime may use, or None for the host
    path. A GPU is always admitted; the CPU backend only when
    JAX_PLATFORMS=cpu is set explicitly (tests). Raises SystemExit when
    the device was asked for (`want_device`) and none is usable; plain
    auto mode says on stderr that it maps on the host."""
    try:
        import jax
        plat = jax.default_backend()
    except Exception as e:   # noqa: BLE001 — reported below
        plat, err = None, f"JAX failed to start: {e}"
    else:
        err = f"JAX found no GPU (backend: {plat})"
    explicit_cpu = os.environ.get("JAX_PLATFORMS", "") == "cpu"
    if plat == "gpu" or (plat == "cpu" and explicit_cpu and want_device):
        return plat
    if want_device:
        raise SystemExit(f"[ERROR] the device was requested but {err}")
    print(f"[mm2tpu] {err}; mapping on the host path", file=sys.stderr)
    return None


def main(argv=None) -> int:
    try:
        return _main(argv)
    except BrokenPipeError:
        # downstream consumer closed the pipe (e.g. `| head`): exit quietly
        # like the reference's EOF/write checks (misc.c:124-132)
        import os
        try:
            os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        except OSError:
            pass
        return 1


def _main(argv=None) -> int:
    from .utils.compile_cache import enable_persistent_cache
    enable_persistent_cache()
    from .utils import mlog
    mlog.reset_timer()
    if argv is None:
        argv = sys.argv[1:]
    argv_disp = list(argv)
    # getopt_long optional_argument semantics: a bare --cs must NOT consume
    # the next token (only --cs=long attaches a value); argparse's nargs="?"
    # would swallow the reference FASTA otherwise
    argv = ["--cs=short" if a == "--cs" else a for a in argv]
    ns = build_parser().parse_args(argv)

    # honor JAX_PLATFORMS even when jax was imported before this point
    # (it latches env vars at import), and provision enough virtual CPU
    # devices for an explicit --mesh — both before first backend use
    import os as _os
    _plat = _os.environ.get("JAX_PLATFORMS")
    if _plat or ns.mesh:
        try:
            import jax as _jax
            if _plat:
                _jax.config.update("jax_platforms", _plat)
            if ns.mesh and (_plat or "").startswith("cpu"):
                d_, i_ = ns.mesh.lower().split("x")
                _jax.config.update("jax_num_cpu_devices",
                                   max(int(d_) * int(i_), 1))
        except Exception:
            pass
    if ns.mesh:
        import re as _re_m
        if not _re_m.fullmatch(r"\d+x\d+", ns.mesh.lower()):
            print(f"[ERROR] --mesh expects DATAxINDEX (e.g. 4x2), got "
                  f"'{ns.mesh}'", file=sys.stderr)
            return 1
    # the reference CLI runs at mm_verbose=3 unless -v overrides (main.c:304)
    mlog.set_verbose(3 if ns.verbose is None else ns.verbose)
    io, mo = set_opt(None)
    if ns.preset:
        try:
            set_opt(ns.preset, io, mo)
        except ValueError:
            # reference main.c:312: clean error + exit, no traceback
            print(f"[ERROR] unknown preset '{ns.preset}'", file=sys.stderr)
            return 1
    # --sr / --splice are preset aliases: like -x they apply BEFORE the
    # per-option overrides (previously they ran LAST and clobbered user
    # scoring, e.g. `--sr -A 5` silently reset a=2)
    if ns.sr:
        set_opt("sr", io, mo)
    if ns.splice:
        set_opt("splice", io, mo)
    apply_args(ns, io, mo)
    check_opt(io, mo)
    if (mo.flag & C.MM_F_CIGAR) and (io.flag & C.MM_I_NO_SEQ):
        print("[ERROR] the index was built without sequences; "
              "base-level alignment is disabled (main.c:214)",
              file=sys.stderr)
        return 1
    if not ns.query and not ns.dump_index:
        print("[ERROR] missing input: please specify a query file or -d",
              file=sys.stderr)
        return 1

    from .index.serialize import (dump_index, is_mm2tpu_index, is_mmi_index,
                                  load_index, load_mmi_parts)

    def index_parts():
        """Yield index parts: prebuilt single-part, or FASTA split every
        ~batch_size bases (the reference's -I multi-part indexing,
        index.c:459, mm_idx_reader_read index.c:921)."""
        if is_mmi_index(ns.target):
            # stock minimap2 .mmi (MMI\2), possibly multi-part
            for j, mi in enumerate(load_mmi_parts(ns.target)):
                if j == 0 and (mi.k != io.k or mi.w != io.w):
                    print(f"[WARNING] Indexing parameters (-k {mi.k} "
                          f"-w {mi.w}) overriding command line",
                          file=sys.stderr)
                yield mi
            return
        if is_mm2tpu_index(ns.target):
            mi = load_index(ns.target)
            if mi.k != io.k or mi.w != io.w:
                print(f"[WARNING] Indexing parameters (-k {mi.k} -w {mi.w}) "
                      "overriding command line", file=sys.stderr)
            yield mi
            return
        # encode each contig to nt4 as it is read (and let the ASCII
        # string free immediately): at genome scale the raw strings are
        # ~1 byte/base, so holding them all alongside the build's nt4
        # buffer doubled the front half of the build's footprint;
        # build_index additionally consumes these per-contig arrays as it
        # copies them into its concatenated buffer
        from .constants import seq_to_nt4
        part_names, part_seqs, plen = [], [], 0
        for r in read_fastx(ns.target):
            part_names.append(r.name)
            part_seqs.append(seq_to_nt4(r.seq))
            plen += len(part_seqs[-1])
            if plen >= io.batch_size:
                yield build_index(part_names, part_seqs,
                                  io.w, io.k, io.flag, io.bucket_bits,
                                  n_threads=ns.threads)
                part_names, part_seqs, plen = [], [], 0
        if part_names:
            yield build_index(part_names, part_seqs,
                              io.w, io.k, io.flag, io.bucket_bits,
                              n_threads=ns.threads)

    # the device is REQUESTED by --device gpu, --mesh or a forced flow:
    # then a missing GPU, a failed init or a device error ends the run with
    # the error (checked before the index build). Plain auto mode maps on
    # the host only when JAX has no GPU backend.
    plat = None
    if ns.query and ns.device != "host" and not (
            ns.print_seeds or ns.print_aln_seq):
        want_device = ns.device == "gpu" or bool(ns.mesh) \
            or os.environ.get("MM2TPU_DEVICE_FLOW") == "1"
        plat = device_platform(want_device)

    from .utils.prefetch import prefetch

    out = sys.stdout
    rg_id = parse_rg_id(ns.rg)
    # build index part k+1 while part k maps (reference main.c:133-275)
    parts = prefetch(index_parts(), depth=1)
    dump_mmi_fp = None
    dump_mmi_streaming = bool(ns.dump_index
                              and ns.dump_index.endswith(".mmi"))
    if dump_mmi_streaming:
        pass  # opened lazily at the first part, so a failed build/read
        # never truncates an existing index file
    elif ns.dump_index:  # .mm2i dumps are single-part: peek 2 parts,
        import itertools       # NOT list(parts) — a 3 Gbp genome under a
        head = list(itertools.islice(parts, 2))   # small -I would build
        if len(head) > 1:      # and hold EVERY part before erroring
            print("[ERROR] the index dump does not support multi-part "
                  "indexes; raise -I (or dump stock format via a .mmi "
                  "extension)", file=sys.stderr)
            return 1
        parts = iter(head)
    # one-part lookahead: the SAM header is written once, with @SQ lines
    # only when the index is single-part (reference main.c:224-231) — the
    # same part double-buffering the reference's read_task_thread keeps
    cur = next(parts, None) if not isinstance(parts, list) else \
        (parts[0] if parts else None)
    if isinstance(parts, list):
        parts = iter(parts[1:])
    part_no = 0
    while cur is not None:
        mi = cur
        cur = next(parts, None)
        part_no += 1
        if (mo.flag & C.MM_F_CIGAR) and (mi.flag & C.MM_I_NO_SEQ):
            # post-load re-check: a prebuilt index may lack sequences even
            # when the command line didn't say --idx-no-seq (main.c:214)
            print("[ERROR] the prebuilt index doesn't contain sequences.",
                  file=sys.stderr)
            return 1
        mlog.mlog("main", f"loaded/built the index for {mi.n_seq} "
                  "target sequence(s)")
        if ns.query:
            mo.update(mi)
            mlog.mlog("mm_mapopt_update", f"mid_occ = {mo.mid_occ}")
        if mlog.verbose >= 3:
            # index stats at -v 3+ (reference mm_idx_stat, index.c:240-265)
            st = mi.stat()
            n = st["distinct_minimizers"]
            sum_occ = n * st["avg_occurrences"]
            mlog.mlog_plain(
                "mm_idx_stat", f"kmer size: {mi.k}; skip: {mi.w}; "
                f"is_hpc: {1 if mi.is_hpc else 0}; #seq: {mi.n_seq}")
            mlog.mlog(
                "mm_idx_stat", f"distinct minimizers: {n} "
                f"({100.0 * st['singleton_frac']:.2f}% are singletons); "
                f"average occurrences: {st['avg_occurrences']:.3f}; "
                f"average spacing: "
                f"{(st['total_bases'] / sum_occ) if sum_occ else 0.0:.3f}")
        if ns.dump_index:
            if dump_mmi_streaming:
                from .index.serialize import dump_mmi
                if dump_mmi_fp is None:
                    dump_mmi_fp = open(ns.dump_index, "wb")
                dump_mmi(mi, dump_mmi_fp)
            else:
                dump_index(mi, ns.dump_index)
            if not ns.query:
                if cur is None:
                    if dump_mmi_fp is not None:
                        dump_mmi_fp.close()
                    # index-build-only runs still get the closing
                    # Version/CMD/Real-time stderr footer (main.c prints
                    # it on every exit path)
                    mlog.banner("2.10-r761", argv_disp)
                    return 0
                continue

        # debug dump modes force the single-threaded sequential host
        # pipeline (reference main.c:358/361 forces n_threads=1)
        dbg = 0
        if ns.print_seeds:
            dbg |= C.MM_DBG_PRINT_QNAME | C.MM_DBG_PRINT_SEED
        if ns.print_aln_seq:
            dbg |= C.MM_DBG_PRINT_QNAME | C.MM_DBG_PRINT_ALN_SEQ
        if dbg:
            mlog.set_dbg(dbg)
            mo.native_skeleton = False  # dumps live in the Python models
            _run_debug_sequential(mi, mo, ns, rg_id, out, part_no,
                                  cur is not None, argv_disp)
            continue

        if plat is not None:
            from .models.runtime import DeviceRuntime
            mesh_shape = None
            if ns.mesh:
                d_, i_ = ns.mesh.lower().split("x")
                mesh_shape = (int(d_), int(i_))
            runtime = DeviceRuntime(mi, mo, n_threads=ns.threads,
                                    mesh_shape=mesh_shape)
        else:
            from .models.host_runtime import HostRuntime
            runtime = HostRuntime(mi, mo, n_threads=ns.threads)

        if (mo.flag & C.MM_F_OUT_SAM) and part_no == 1:
            cmdline = "mm2tpu " + " ".join(argv_disp)
            is_multi = cur is not None
            if is_multi:
                print("[WARNING] For a multi-part index, no @SQ lines will "
                      "be outputted.", file=sys.stderr)
            print(write_sam_hdr(None if is_multi else mi, ns.rg,
                                "2.10-r761", cmdline), file=out)
        frag_mode = len(ns.query) > 1 or bool(mo.flag & C.MM_F_FRAG_MODE)
        # stage read batch k+1 while batch k maps (kt_pipeline step overlap)
        batches = prefetch(read_frags(ns.query, mo.mini_batch_size,
                                      frag_mode), depth=2)
        if ns.print_qname:  # MM_DBG_PRINT_QNAME (main.c:47, map.c:606)
            def _announce(bs):
                for b in bs:
                    for frag in b:
                        s0 = frag.segs[0]
                        print(f"QR\t{s0.name}\t0\t{len(s0.seq)}",
                              file=sys.stderr)
                    yield b
            batches = _announce(batches)
        from collections import deque
        stash: deque = deque()

        def _tee(bs):
            for b in bs:
                stash.append(b)
                yield b

        # threaded 2-batch pipeline (device or host runtime): batch k+1
        # maps while batch k's results are awaited / its text is written
        for batch_lines in runtime.map_stream(_tee(batches), rg_id):
            # one buffered write per batch, not one print per record: at
            # 50k+ records/s (sr batch driver) per-line print() is a
            # measurable tax
            flat = [line for lines in batch_lines for line in lines]
            if flat:
                flat.append("")          # trailing newline
                out.write("\n".join(flat))
            b = stash.popleft()
            mlog.mlog("worker_pipeline",
                      f"mapped {sum(len(f.segs) for f in b)} sequences")
        # per-stage telemetry at exit, like the reference's perf
        # counters (main.c:629-663); the calibration line records the
        # startup link measurement and the routing it chose
        if getattr(runtime, "link_mbps", None) is not None:
            import sys as _sys
            share = getattr(runtime, "_flow_share", None)
            share_s = (f" flow_share={share:.2f}"
                       if runtime.device_flow and share is not None else "")
            print(f"[calibrate] d2h={runtime.link_mbps}MB/s "
                  f"device_flow={'on' if runtime.device_flow else 'off'}"
                  f"{share_s}",
                  file=_sys.stderr)
        runtime.timers.report()
        # in-process drivers (tools/e2e_bench.py) read the last run's flow
        # telemetry here — counters survive after the runtime is dropped
        global LAST_RUN_COUNTERS
        LAST_RUN_COUNTERS = dict(runtime.timers.counters)
    if dump_mmi_fp is not None:
        dump_mmi_fp.close()
    mlog.banner("2.10-r761", argv_disp)
    return 0


def _exit(code: int):
    """Exit that tolerates a wedged device call.

    If the device-owner thread is stuck inside a stalled jax/PJRT call
    (utils/device_guard marked the device bad), normal interpreter
    teardown unwinds the wedged C++ frame and glibc aborts ("FATAL:
    exception not rethrown", SIGABRT).  Flush and hard-exit instead, with
    the run's own exit status."""
    from .utils import device_guard
    if device_guard.device_bad():
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)
    sys.exit(code)


def console_main():  # console_scripts entry point
    _exit(main())


if __name__ == "__main__":
    console_main()
