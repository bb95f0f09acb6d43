"""Minimizer index as flat sorted tables (CSR layout).

Replaces the reference's per-bucket khash (index.c:340-416) with one global
sorted-key table + CSR offsets, the design SURVEY.md §7.3 calls for: lookup is a
batched binary search (np.searchsorted host-side, jnp.searchsorted device-side)
instead of hashing.  Semantics preserved from the reference:
  * key = minimizer.x >> 8 (span dropped), runs of equal keys become one entry
    (index.c:352-358)
  * per-key occurrence list sorted by value y = rid<<32 | pos<<1 | strand
    ascending (index.c:394 radix_sort_64 "sort by position")
  * values keep the STOCK 64-bit encoding, not the fork's 21/21/21-bit pack
    (which caps refs at 2^21 bp — see SURVEY.md §2 "Index build")
  * 4-bit packed reference sequence S for getseq (index.c:480-505, mmpriv.h:29-30)
  * occurrence-count quantile for mid_occ (mm_idx_cal_max_occ, index.c:307-328)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from ..constants import SEQ_NT4_TABLE
from .sketch import sketch


@dataclass
class RefSeq:
    name: str
    offset: int  # offset into the packed S array
    length: int


@dataclass
class MinimizerIndex:
    k: int
    w: int
    flag: int  # MM_I_* flags
    b: int = 14  # kept for reporting parity; CSR layout has no buckets
    seqs: list[RefSeq] = field(default_factory=list)
    S: np.ndarray = field(default_factory=lambda: np.empty(0, dtype=np.uint8))  # 4-bit codes, 1/byte host-side
    # CSR tables
    keys: np.ndarray = field(default_factory=lambda: np.empty(0, dtype=np.uint64))
    starts: np.ndarray = field(default_factory=lambda: np.zeros(1, dtype=np.int64))
    values: np.ndarray = field(default_factory=lambda: np.empty(0, dtype=np.uint64))
    # lexicographic rank of each rid among target names (for ava-mode dual/diag
    # skipping, reference index.c:560-592 rname_rid/rever_rid)
    name_rank: np.ndarray = field(default_factory=lambda: np.empty(0, dtype=np.int64))
    sorted_names: list[str] = field(default_factory=list)

    @property
    def n_seq(self) -> int:
        return len(self.seqs)

    @property
    def is_hpc(self) -> bool:
        return bool(self.flag & 1)

    def get(self, minier: int) -> np.ndarray:
        """Occurrence list for one minimizer key (x>>8); reference mm_idx_get index.c:221."""
        i = int(np.searchsorted(self.keys, np.uint64(minier)))
        if i >= len(self.keys) or self.keys[i] != np.uint64(minier):
            return self.values[0:0]
        return self.values[self.starts[i]:self.starts[i + 1]]

    def getseq(self, rid: int, st: int, en: int) -> np.ndarray:
        """nt4 codes of reference rid in [st, en); reference mm_idx_getseq index.c:295."""
        s = self.seqs[rid]
        en = min(en, s.length)
        return self.S[s.offset + st:s.offset + en]

    def cal_max_occ(self, f: float) -> int:
        """Occurrence-count quantile threshold (reference index.c:307-328)."""
        if f <= 0.0 or len(self.keys) == 0:
            return np.iinfo(np.int32).max
        cnt = np.diff(self.starts).astype(np.uint32)
        kk = int((1.0 - f) * len(cnt))
        return int(np.partition(cnt, kk)[kk]) + 1

    def name2id(self, name: str) -> int:
        """rid of a contig name (reference mm_idx_name2id: hash lookup).
        The map is built lazily and invalidated when seqs grows, so every
        call after the first is O(1) instead of a linear scan (mappy's
        Aligner.seq calls this per fetch)."""
        m = getattr(self, "_name2id", None)
        if m is None or getattr(self, "_name2id_n", -1) != len(self.seqs):
            m = {}
            for i, s in enumerate(self.seqs):
                m.setdefault(s.name, i)   # duplicates: first wins, like
            object.__setattr__(self, "_name2id", m)       # the old scan
            object.__setattr__(self, "_name2id_n", len(self.seqs))
        return m.get(name, -1)

    def stat(self) -> dict:
        cnt = np.diff(self.starts)
        return {
            "distinct_minimizers": int(len(self.keys)),
            "singleton_frac": float(np.mean(cnt == 1)) if len(cnt) else 0.0,
            "avg_occurrences": float(np.mean(cnt)) if len(cnt) else 0.0,
            "total_bases": sum(s.length for s in self.seqs),
        }


def build_index(names: Sequence[str],
                seq_strs: "Sequence[str | np.ndarray]", w: int, k: int,
                flag: int = 0, bucket_bits: int = 14,
                n_threads: int = 1,
                device: bool | None = None) -> MinimizerIndex:
    """Build the CSR minimizer index from reference sequences.

    `seq_strs` entries may be ASCII strings or already-nt4-encoded uint8
    arrays. CONSUME SEMANTICS (ADVICE r4): when `seq_strs` is a mutable
    list, ndarray entries are set to None as each is copied into the
    concatenated buffer — streaming callers rely on this so per-contig
    chunks and the full genome buffer never coexist. Pass a tuple (or
    keep your own references) if you need the arrays afterwards.

    n_threads > 1 fans the per-contig native sketching across a worker
    pool (the reference's kt_pipeline step-1 parallelism, index.c:506-517;
    the native call releases the GIL). Output is order-stable: chunks are
    contiguous rid ranges reassembled in rid order.

    device=True (or MM2TPU_DEVICE_INDEX=1) runs the minimizer pair sort —
    the O(n log n) heart of the build — on the accelerator
    (index/build_device.py); bit-identical CSR, for co-located chips."""
    mi = MinimizerIndex(k=k, w=w, flag=flag, b=bucket_bits)
    no_seq = bool(flag & 2)  # MM_I_NO_SEQ: skip the 4-bit reference pack
    total = sum(len(s) for s in seq_strs)
    cat = np.empty(total, dtype=np.uint8)
    offs = np.zeros(len(seq_strs) + 1, dtype=np.int64)
    off = 0
    consume = isinstance(seq_strs, list)
    for rid, (name, s) in enumerate(zip(names, seq_strs)):
        if isinstance(s, np.ndarray):
            # already nt4-encoded (streaming callers encode per contig as
            # they read, so full ASCII strings never accumulate); entries
            # of a mutable list are released once copied into `cat`, so
            # the chunks and the concatenated buffer never coexist in full
            codes = s
        else:
            codes = SEQ_NT4_TABLE[np.frombuffer(s.encode(), dtype=np.uint8)]
        # the reference packs ambiguous bases as a pseudo-random 0-3 code
        # (index.c:497 uses lrand48 when c>=4); we keep 4 host-side and mask at
        # alignment time instead, which matches ksw2 behavior for N bases.
        cat[off:off + len(codes)] = codes
        if consume and isinstance(s, np.ndarray):
            seq_strs[rid] = None
        mi.seqs.append(RefSeq(name=name, offset=off, length=len(codes)))
        off += len(codes)
        offs[rid + 1] = off
    mi.S = cat if not no_seq else np.empty(0, dtype=np.uint8)
    import os as _os
    if device is None:
        device = _os.environ.get("MM2TPU_DEVICE_INDEX", "0") == "1"
    # one native call sketches every contig from the already-encoded buffer
    from ..native import CsrBuilder, sketch_batch_cat_native
    from ..utils.mlog import mlog
    n_seqs = len(seq_strs)
    # streaming build (VERDICT r3 weak #5): per-contig minimizer chunks
    # feed the native sorted-block accumulator and are freed immediately,
    # so the build never holds the full pair set twice; the device-sort
    # path and the no-native golden path keep the accumulate-then-build
    # shape
    if device:
        acc = None
    else:
        spill = None   # None -> MM2TPU_BUILD_SPILL decides in create()
        if _os.environ.get("MM2TPU_BUILD_SPILL", "") == "":
            # auto spill (VERDICT r4 #7): bound the build's block memory
            # once the estimated sorted-pair volume alone crosses
            # MM2TPU_SPILL_AUTO_GB (pairs are 16 B, minimizer density
            # ~2/(w+1) per base — sketch.c window math); measured at
            # 3 Gbp: −8.2 GB peak for the same wall time (PERF.md)
            est_gb = total * 2.0 / (w + 1) * 16 / 2**30
            auto_gb = float(_os.environ.get("MM2TPU_SPILL_AUTO_GB", "6"))
            spill = est_gb > auto_gb
            if spill:
                mlog("mm_idx_gen",
                     f"spill build auto-enabled (~{est_gb:.1f} GB of "
                     "minimizer blocks; MM2TPU_BUILD_SPILL=0 forces RAM)")
        acc = CsrBuilder.create(spill=spill)
    mvs: list | None = []
    try:
        if n_threads > 1 and n_seqs > 1:
            from concurrent.futures import ThreadPoolExecutor
            nch = min(n_threads, n_seqs)
            cuts = [round(i * n_seqs / nch) for i in range(nch + 1)]

            def _chunk(i):
                a, b = cuts[i], cuts[i + 1]
                part = sketch_batch_cat_native(
                    cat, offs[a:b + 1], np.arange(a, b), w, k,
                    bool(flag & 1))
                if part is not None and acc is not None:
                    for m in part:   # csr_add locks internally
                        acc.add(m)
                    return []
                return part
            with ThreadPoolExecutor(max_workers=nch) as ex:
                parts = list(ex.map(_chunk, range(nch)))
            mvs = None if any(p is None for p in parts) \
                else [m for p in parts for m in p]
        else:
            # contig-group granularity so each sorted block stays modest
            # and chunks free as the stream advances
            GRP = 32
            mvs = []
            for a in range(0, n_seqs, GRP):
                b = min(a + GRP, n_seqs)
                part = sketch_batch_cat_native(
                    cat, offs[a:b + 1], np.arange(a, b), w, k,
                    bool(flag & 1))
                if part is None:
                    mvs = None
                    break
                if acc is not None:
                    for m in part:
                        acc.add(m)
                else:
                    mvs.extend(part)
        if mvs is None:  # no native lib: per-contig golden-model sketch
            if acc is not None:
                acc.abort()
                acc = None
            # sketch from the nt4 buffer, not seq_strs — streaming callers'
            # entries are consumed (None) once copied into `cat`
            mvs = [sketch(cat[offs[rid]:offs[rid + 1]], w, k, rid,
                          bool(flag & 1))
                   for rid in range(n_seqs) if offs[rid + 1] > offs[rid]]
        else:
            mvs = [m for m in mvs if len(m)]
        mlog("mm_idx_gen", "collected minimizers")
        csr = None
        if acc is not None:
            csr = acc.finish()
            acc = None
        elif device:
            from .build_device import build_csr_device
            csr = build_csr_device(mvs)
        if csr is None:
            from ..native import build_csr_native
            csr = build_csr_native(mvs)
    finally:
        if acc is not None:
            acc.abort()
    if csr is not None:
        # one native pass: split key/val + pair sort + run-start unique
        # (index.c:349, 394) without the numpy concat/shift/nonzero copies
        mi.keys, mi.starts, mi.values = csr
    else:
        mv = np.concatenate(mvs, axis=0) if mvs \
            else np.empty((0, 2), dtype=np.uint64)
        if len(mv):
            key = np.ascontiguousarray(mv[:, 0] >> np.uint64(8))
            val = np.ascontiguousarray(mv[:, 1])
            order = np.lexsort((val, key))
            key, val = key[order], val[order]
            neq = np.empty(len(key), dtype=bool)
            neq[0] = True
            np.not_equal(key[1:], key[:-1], out=neq[1:])
            starts = np.flatnonzero(neq)
            mi.keys = key[starts]
            mi.starts = np.concatenate([starts, [len(val)]]).astype(np.int64)
            mi.values = val
    mlog("mm_idx_gen", "sorted minimizers")
    # lexicographic name ranks (ava-mode ordering, index.c:560-592)
    from .serialize import set_name_tables
    set_name_tables(mi, list(names))
    return mi
