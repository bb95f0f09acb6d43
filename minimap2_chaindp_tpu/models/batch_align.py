"""Cross-read batched alignment: schedule many reads' extension-job waves
into shared batched calls.

The reference runs each region's ksw2 calls sequentially inside its result
threads (map.c:816-898 -> align.c). Here every read's align_skeleton runs
as a generator (align.align_skeleton_gen) that yields waves of extension
jobs whose inputs depend only on the chain anchors; the scheduler gathers
the current wave of EVERY in-flight read, runs it as one batched native
SIMD call (native/ksw2_extd2.cc, the reference's own CPU placement of
ksw2), and resumes the generators with result thunks. Jobs outside the
native batch's domain (the single-affine extz path) run on the host NumPy
model lazily, so output stays byte-identical either way."""
from __future__ import annotations

from .. import constants as C
from ..ops import ksw2 as K
from ..align import _host_thunk

# jobs longer than this (query + target bases) skip the native batch and
# run on the host model
NATIVE_MAX = 100000


class AlignExecutor:
    """Executes extension-job waves: one batched native SIMD call for the
    dual-affine (extd2) or splice (exts2) jobs, lazy host NumPy for the
    rest."""

    def __init__(self, opt):
        import threading
        self.opt = opt
        self.mat = K.gen_simple_mat(5, opt.a, opt.b)
        self.splice = bool(opt.flag & C.MM_F_SPLICE)
        self.n_host = 0
        self.n_native = 0
        self._stat_lock = threading.Lock()  # two map_stream batch threads

    def run(self, jobs) -> list:
        thunks: list = [None] * len(jobs)
        # one native SIMD batch call (exts2 for splice scoring, extd2
        # otherwise; the single-affine q==q2,e==e2 case has no native
        # batch kernel)
        if self.splice:
            from ..native import exts2_batch_native as nat_fn
            nat_args = (self.opt.q, self.opt.e, self.opt.q2,
                        self.opt.noncan)
        elif not (self.opt.q == self.opt.q2 and self.opt.e == self.opt.e2):
            from ..native import extd2_batch_native as nat_fn
            nat_args = (self.opt.q, self.opt.e, self.opt.q2, self.opt.e2)
        else:
            nat_fn = None
        if nat_fn is not None:
            nat = [i for i, j in enumerate(jobs)
                   if len(j["qseq"]) + len(j["tseq"]) <= NATIVE_MAX]
            res = nat_fn([jobs[i] for i in nat], self.mat, *nat_args) \
                if nat else None
            if res is not None:
                for i, ez in zip(nat, res):
                    thunks[i] = (lambda v=ez: v)
                with self._stat_lock:
                    self.n_native += len(nat)
        n_host = 0
        for i, j in enumerate(jobs):
            if thunks[i] is None:
                thunks[i] = _host_thunk(self.opt, self.mat, j)
                n_host += 1
        if n_host:
            with self._stat_lock:
                self.n_host += n_host
        return thunks


def run_scheduler(gens: list, executor) -> list:
    """Drive many wave-yielding generators to completion, executing the
    union of their current waves in one executor call per round.
    Returns each generator's StopIteration value, in order."""
    results = [None] * len(gens)
    live: dict[int, tuple] = {}
    for idx, g in enumerate(gens):
        try:
            live[idx] = (g, next(g))
        except StopIteration as e:
            results[idx] = e.value
    while live:
        all_jobs: list = []
        spans: dict[int, tuple[int, int]] = {}
        for idx, (g, wave) in live.items():
            spans[idx] = (len(all_jobs), len(wave))
            all_jobs.extend(wave)
        thunks = executor.run(all_jobs)
        nxt: dict[int, tuple] = {}
        for idx, (g, wave) in live.items():
            off, ln = spans[idx]
            try:
                nxt[idx] = (g, g.send(thunks[off:off + ln]))
            except StopIteration as e:
                results[idx] = e.value
        live = nxt
    return results
