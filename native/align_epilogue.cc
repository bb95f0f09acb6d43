// Native host epilogue for the alignment stage.
//
// These are the per-region CIGAR/anchor scan loops that run on the host
// after the device kernels — the equivalents of the reference's
// mm_test_zdrop (align.c:46-88), mm_update_extra (align.c:148-193),
// mm_est_err's anchor/minimizer merge (esterr.c:16-64), and the fuzzy
// mlen/blen accumulation (hit.c:8-21). Python drives the control flow and
// keeps all float32 math (divergence log) so output stays bit-identical;
// C++ does the integer scans, which dominate host time at large batch
// sizes. C ABI via ctypes (no pybind11 in this image).
#include <cstdint>
#include <cmath>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <atomic>
#include <ctime>
#include <mutex>
#include <vector>

extern "C" {

// ---- mm_test_zdrop scan (align.c:46-73): returns max_zdrop; writes the
// t/q break coordinates into pos[4] = {t_st, t_en, q_st, q_en}.
int64_t mm2tpu_zdrop_scan(
    const uint8_t* qseq, const uint8_t* tseq,
    const uint32_t* cigar, int64_t n_cigar,
    const int8_t* mat /*25*/, int32_t q, int32_t e, int32_t* pos)
{
    int64_t score = 0, maxv = -(1LL << 31), max_zdrop = 0;
    int64_t i = 0, j = 0, max_i = -1, max_j = -1;
    pos[0] = pos[1] = pos[2] = pos[3] = -1;
    auto upd = [&](int64_t ci, int64_t cj) {
        if (score < maxv) {
            int64_t li = ci - max_i, lj = cj - max_j;
            int64_t diff = li > lj ? li - lj : lj - li;
            int64_t z = maxv - score - diff * e;
            if (z > max_zdrop) {
                max_zdrop = z;
                pos[0] = (int32_t)max_i; pos[1] = (int32_t)(ci + 1);
                pos[2] = (int32_t)max_j; pos[3] = (int32_t)(cj + 1);
            }
        } else {
            maxv = score; max_i = ci; max_j = cj;
        }
    };
    for (int64_t k = 0; k < n_cigar; ++k) {
        uint32_t c = cigar[k];
        int op = c & 0xF;
        int64_t len = c >> 4;
        if (op == 0) {
            for (int64_t l = 0; l < len; ++l) {
                score += mat[tseq[i + l] * 5 + qseq[j + l]];
                upd(i + l, j + l);
            }
            i += len; j += len;
        } else if (op == 1 || op == 2 || op == 3) {
            score -= q + e * len;
            if (op == 1) j += len; else i += len;
            upd(i, j);
        }
    }
    return max_zdrop;
}

// ---- mm_update_extra scan (align.c:155-192), after fix_cigar: running
// clamped score, blen/mlen/n_ambi accumulation.  out[5] =
// {blen, mlen, n_ambi, dp_max, ok(toff/qoff==expected)}.
void mm2tpu_update_extra_scan(
    const uint8_t* qseq, const uint8_t* tseq,
    const uint32_t* cigar, int64_t n_cigar,
    const int8_t* mat /*25*/, int32_t q, int32_t e,
    int64_t exp_qoff, int64_t exp_toff, int64_t* out)
{
    int64_t blen = 0, mlen = 0, n_ambi_tot = 0;
    int64_t toff = 0, qoff = 0, s = 0, maxv = 0;
    for (int64_t k = 0; k < n_cigar; ++k) {
        uint32_t c = cigar[k];
        int op = c & 0xF;
        int64_t len = c >> 4;
        if (op == 0) {
            int64_t n_ambi = 0, n_diff = 0;
            for (int64_t l = 0; l < len; ++l) {
                uint8_t ct = tseq[toff + l], cq = qseq[qoff + l];
                if (ct > 3 || cq > 3) ++n_ambi;
                else if (ct != cq) ++n_diff;
                s += mat[ct * 5 + cq];
                if (s < 0) s = 0;
                else if (s > maxv) maxv = s;
            }
            blen += len - n_ambi;
            mlen += len - (n_ambi + n_diff);
            n_ambi_tot += n_ambi;
            toff += len; qoff += len;
        } else if (op == 1) {
            int64_t n_ambi = 0;
            for (int64_t l = 0; l < len; ++l)
                if (qseq[qoff + l] > 3) ++n_ambi;
            blen += len - n_ambi; n_ambi_tot += n_ambi;
            s -= q + e * len; if (s < 0) s = 0;
            qoff += len;
        } else if (op == 2) {
            int64_t n_ambi = 0;
            for (int64_t l = 0; l < len; ++l)
                if (tseq[toff + l] > 3) ++n_ambi;
            blen += len - n_ambi; n_ambi_tot += n_ambi;
            s -= q + e * len; if (s < 0) s = 0;
            toff += len;
        } else if (op == 3) {
            toff += len;
        }
    }
    out[0] = blen; out[1] = mlen; out[2] = n_ambi_tot; out[3] = maxv;
    out[4] = (qoff == exp_qoff && toff == exp_toff) ? 1 : 0;
}

static inline int64_t qpos_of(int64_t qlen, uint64_t ax, uint64_t ay)
{
    int64_t x = (int32_t)(ay & 0xFFFFFFFFu);
    int64_t q_span = (ay >> 32) & 0xFF;
    if (ax >> 63) x = qlen - 1 - (x + 1 - q_span);
    return x;
}

// ---- mm_est_err per-region merge (esterr.c:16-47): counts the chain's
// anchors whose query positions appear in the sorted minimizer-position
// list.  Returns 1 and fills out[3] = {st_found_en, n_match, n_tot_base}
// when the first anchor's position is present, else 0 (div stays -1).
// The float32 log arithmetic stays in Python (bit-exact dv:f output).
int32_t mm2tpu_est_err_merge(
    const uint64_t* ax, const uint64_t* ay, int64_t as, int64_t cnt,
    int32_t rev, int64_t qlen, const int64_t* mp_lo, int64_t n_mp,
    int64_t* out)
{
    if (cnt <= 0) return 0;
    int64_t k0 = rev ? as + cnt - 1 : as;
    int64_t x = qpos_of(qlen, ax[k0], ay[k0]);
    // lower_bound
    int64_t lo = 0, hi = n_mp;
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (mp_lo[mid] < x) lo = mid + 1; else hi = mid;
    }
    int64_t st = lo;
    if (st >= n_mp || mp_lo[st] != x) return 0;
    int64_t en = st, n_match = 1, k = 1, j = st + 1;
    while (j < n_mp && k < cnt) {
        int64_t ki = rev ? as + cnt - 1 - k : as + k;
        x = qpos_of(qlen, ax[ki], ay[ki]);
        if (x == mp_lo[j]) { ++k; en = j; ++n_match; }
        ++j;
    }
    out[0] = en - st + 1;   // n_tot before the end-window bumps
    out[1] = n_match;
    return 1;
}

// ---- fuzzy mlen/blen from anchor gaps (hit.c:8-21). a is the interleaved
// (n, 2) anchor array (x, y rows). out[2] = {mlen, blen}.
void mm2tpu_cal_fuzzy_len(
    const uint64_t* a, int64_t as, int64_t cnt, int64_t* out)
{
    int64_t mlen = 0, blen = 0;
    if (cnt > 0) {
        mlen = blen = (int64_t)((a[2 * as + 1] >> 32) & 0xFF);
        for (int64_t i = as + 1; i < as + cnt; ++i) {
            uint64_t x = a[2 * i], y = a[2 * i + 1];
            uint64_t xp = a[2 * (i - 1)], yp = a[2 * (i - 1) + 1];
            int64_t span = (int64_t)((y >> 32) & 0xFF);
            int64_t tl = (int64_t)(uint32_t)x - (int64_t)(uint32_t)xp;
            int64_t ql = (int64_t)(uint32_t)y - (int64_t)(uint32_t)yp;
            blen += tl > ql ? tl : ql;
            mlen += (tl > span && ql > span) ? span : (tl < ql ? tl : ql);
        }
    }
    out[0] = mlen; out[1] = blen;
}

// ---- mm_fix_bad_ends (align.c:317-351): trim sloppy chain ends.
// a is the interleaved (n, 2) anchor array. out[2] = {as, cnt}.
void mm2tpu_fix_bad_ends(
    const uint64_t* a, int64_t r_as, int64_t r_cnt, int64_t r_mlen,
    int64_t bw, int64_t min_match, int64_t* out)
{
    int64_t as = r_as, cnt = r_cnt;
    if (r_cnt < 3) { out[0] = as; out[1] = cnt; return; }
    auto span = [&](int64_t i) { return (int64_t)((a[2*i+1] >> 32) & 0xFF); };
    auto xi = [&](int64_t i) { return (int64_t)(int32_t)(uint32_t)a[2*i]; };
    auto yi = [&](int64_t i) { return (int64_t)(int32_t)(uint32_t)a[2*i+1]; };
    const uint64_t LJ = 1ULL << 40;  // MM_SEED_LONG_JOIN
    int64_t m, l;
    m = l = span(r_as);
    for (int64_t i = r_as + 1; i < r_as + r_cnt - 1; ++i) {
        int64_t q_span = span(i);
        if (a[2*i+1] & LJ) break;
        int64_t lr = xi(i) - xi(i-1), lq = yi(i) - yi(i-1);
        int64_t mn = lr < lq ? lr : lq, mx = lr > lq ? lr : lq;
        if (mx - mn > (l >> 1)) as = i;
        l += mn;
        m += mn < q_span ? mn : q_span;
        if (l >= bw << 1 || (m >= min_match && m >= bw) || m >= (r_mlen >> 1))
            break;
    }
    cnt = r_as + r_cnt - as;
    m = l = span(r_as + r_cnt - 1);
    for (int64_t i = r_as + r_cnt - 2; i > as; --i) {
        int64_t q_span = span(i + 1);
        if (a[2*(i+1)+1] & LJ) break;
        int64_t lr = xi(i+1) - xi(i), lq = yi(i+1) - yi(i);
        int64_t mn = lr < lq ? lr : lq, mx = lr > lq ? lr : lq;
        if (mx - mn > (l >> 1)) cnt = i + 1 - as;
        l += mn;
        m += mn < q_span ? mn : q_span;
        if (l >= bw << 1 || (m >= min_match && m >= bw) || m >= (r_mlen >> 1))
            break;
    }
    out[0] = as; out[1] = cnt;
}

// ---- RLE of backtrack step codes into a CIGAR, with the
// ksw_backtrack tail/reverse conventions (ksw2.h:137-150); mirrors
// ops/ksw2.decode_cigar.  out needs capacity n_ops + 2.
int64_t mm2tpu_decode_cigar(
    const int8_t* ops, int64_t n_ops, int64_t fin_i, int64_t fin_j,
    int32_t is_rev, int32_t min_intron_len, uint32_t* out)
{
    int64_t n = 0;
    auto push = [&](int op, int64_t len) {
        if (n && (int)(out[n-1] & 0xF) == op) out[n-1] += (uint32_t)(len << 4);
        else out[n++] = (uint32_t)(len << 4 | op);
    };
    auto op_of = [&](int st) {
        // ksw2.h:137-143: 0 -> M; 1 (and 3 sans splice) -> D; 3 with
        // splice -> N; else (2 and the dual-affine long-gap state 4) -> I
        return st == 0 ? 0 : (st == 2 || st == 4) ? 1 : st == 1 ? 2
             : (min_intron_len > 0 ? 3 : 2);
    };
    for (int64_t k = 0; k < n_ops; ) {
        int op = op_of(ops[k]);
        int64_t k2 = k + 1;
        while (k2 < n_ops && op_of(ops[k2]) == op) ++k2;
        push(op, k2 - k);
        k = k2;
    }
    if (fin_i >= 0)
        push((min_intron_len > 0 && fin_i >= min_intron_len) ? 3 : 2,
             fin_i + 1);
    if (fin_j >= 0) push(1, fin_j + 1);
    if (!is_rev) std::reverse(out, out + n);
    return n;
}

// ---- gap-fill cut enumeration (align.c:560-608 outer loop structure):
// walks the region's anchors once and records every anchor where the
// reference's fill loop would cut a ksw job — i == cnt1-1, LONG_JOIN, or
// both gap spans >= min_ksw_len since the last cut.  Non-HPC coordinates
// (adj = low32 - (k>>1)); a is the interleaved (n, 2) anchor array.
// Returns the number of cuts; out_* need capacity cnt1.
int64_t mm2tpu_enum_fill_cuts(
    const uint64_t* a, int64_t as1, int64_t cnt1, int64_t kh,
    int64_t min_ksw_len, int64_t rs, int64_t qs,
    int32_t* out_i, int32_t* out_re, int32_t* out_qe, uint8_t* out_lj)
{
    const uint64_t IGN_TAN = (1ULL << 41) | (1ULL << 42);
    const uint64_t LJ = 1ULL << 40;
    int64_t n = 0, rs_c = rs, qs_c = qs;
    for (int64_t i = 1; i < cnt1; ++i) {
        uint64_t ay = a[2 * (as1 + i) + 1];
        if ((ay & IGN_TAN) && i != cnt1 - 1) continue;
        int64_t re_c = (int64_t)(int32_t)(uint32_t)a[2 * (as1 + i)] - kh;
        int64_t qe_c = (int64_t)(int32_t)(uint32_t)ay - kh;
        if (i == cnt1 - 1 || (ay & LJ) ||
            (qe_c - qs_c >= min_ksw_len && re_c - rs_c >= min_ksw_len)) {
            out_i[n] = (int32_t)i;
            out_re[n] = (int32_t)re_c;
            out_qe[n] = (int32_t)qe_c;
            out_lj[n] = (ay & LJ) ? 1 : 0;
            ++n;
            rs_c = re_c; qs_c = qe_c;
        }
    }
    return n;
}

// ---- HPC variant of the cut enumeration: coordinates go through the
// homopolymer-aware adjust (align.c:254-269 mm_adjust_minier) — walk the
// query back to the run start, walk the target back through the
// homopolymer ending at the anchor.  qseq is the region's strand of the
// encoded query; S_rid points at the target sequence (S + seq offset).
// A chain never changes strand or rid, so both are per-region constants.
int64_t mm2tpu_enum_fill_cuts_hpc(
    const uint64_t* a, int64_t as1, int64_t cnt1,
    const uint8_t* qseq, const uint8_t* S_rid,
    int64_t min_ksw_len, int64_t rs, int64_t qs,
    int32_t* out_i, int32_t* out_re, int32_t* out_qe, uint8_t* out_lj)
{
    const uint64_t IGN_TAN = (1ULL << 41) | (1ULL << 42);
    const uint64_t LJ = 1ULL << 40;
    int64_t n = 0, rs_c = rs, qs_c = qs;
    for (int64_t i = 1; i < cnt1; ++i) {
        uint64_t ay = a[2 * (as1 + i) + 1];
        if ((ay & IGN_TAN) && i != cnt1 - 1) continue;
        int64_t x = (int64_t)(int32_t)(uint32_t)a[2 * (as1 + i)];
        int64_t q = (int64_t)(int32_t)(uint32_t)ay;
        uint8_t c = qseq[q];
        int64_t j = q - 1;
        while (j > 0 && qseq[j] == c) --j;
        int64_t qe_c = j + 1;
        c = S_rid[x];
        j = x - 1;
        while (j >= 0 && S_rid[j] == c) --j;
        int64_t re_c = x + 1 - (x - j);
        if (i == cnt1 - 1 || (ay & LJ) ||
            (qe_c - qs_c >= min_ksw_len && re_c - rs_c >= min_ksw_len)) {
            out_i[n] = (int32_t)i;
            out_re[n] = (int32_t)re_c;
            out_qe[n] = (int32_t)qe_c;
            out_lj[n] = (ay & LJ) ? 1 : 0;
            ++n;
            rs_c = re_c; qs_c = qe_c;
        }
    }
    return n;
}

// ---- seed-hit collection (map.c:112-236 collect_matches/collect_seed_hits)
// over the CSR index tables (keys/starts/values), non-ava path only (the
// NO_DIAG name-compare modes stay in Python).  Handle pattern: the first
// call computes everything and returns sizes; _take copies out and frees.
struct Mm2tpuCollectOut {
    std::vector<std::pair<uint64_t, uint64_t>> rows;  // (x, y) anchors
    std::vector<uint64_t> mini_pos;
};

// ---- key-lookup prefix directory (r5).  At genome scale a per-minimizer
// binary search over the full key table (184M keys at 3 Gbp = 27 random
// DRAM+TLB misses each) dominated the whole mapping path: the PROF'd
// collect stage measured 9.9-27.3 ms/read of an 11.9-30.1 ms total.
// Minimizer keys are invertible-hash outputs (sketch.c hash64), i.e.
// uniform over the 2k-bit key domain, so a radix directory over the top
// D bits narrows every lookup to a ~dozen-key range: dir[p] = first
// index whose key's top bits >= p.  One linear build pass per index
// (cached per (keys*, n_keys) with value sentinels, a handful of live
// indexes per process), then each lookup costs ~2 cache misses.

struct KeyDir {
    const uint64_t* keys;
    int64_t n_keys;
    uint64_t s0, s1, s2;        // sentinel values: first/middle/last key
    int shift;
    int64_t np;                 // directory buckets (2^D)
    std::vector<int32_t> dir;   // np + 1 entries
};

static std::mutex g_dir_mu;
static std::vector<KeyDir*> g_dirs;

static const KeyDir* keydir_get(const uint64_t* keys, int64_t n_keys)
{
    if (n_keys < (1 << 20) || n_keys >= (1LL << 31))
        return nullptr;   // small index: plain search beats the build
    std::lock_guard<std::mutex> g(g_dir_mu);
    for (auto* d : g_dirs)
        if (d->n_keys == n_keys
            && d->s0 == keys[0] && d->s1 == keys[n_keys / 2]
            && d->s2 == keys[n_keys - 1]) {
            // content match: the directory depends only on key VALUES,
            // so a re-mmap of the same index (new pointer every run —
            // rebuilding cost ~2 s/run at 3 Gbp) reuses it
            d->keys = keys;
            return d;
        }
    int D = 0;
    while ((1LL << (D + 1)) <= n_keys / 8 && D + 1 <= 25) ++D;
    uint64_t maxk = keys[n_keys - 1];
    int kb = 64 - __builtin_clzll(maxk | 1);
    int shift = kb > D ? kb - D : 0;
    auto* d = new KeyDir();
    d->keys = keys;
    d->n_keys = n_keys;
    d->s0 = keys[0];
    d->s1 = keys[n_keys / 2];
    d->s2 = keys[n_keys - 1];
    d->shift = shift;
    d->np = 1LL << D;
    d->dir.resize((size_t)d->np + 1);
    int64_t p_cur = 0;
    d->dir[0] = 0;
    for (int64_t i = 0; i < n_keys; ++i) {
        int64_t p = (int64_t)(keys[i] >> shift);
        while (p_cur < p) d->dir[(size_t)++p_cur] = (int32_t)i;
    }
    while (p_cur < d->np) d->dir[(size_t)++p_cur] = (int32_t)n_keys;
    if (g_dirs.size() >= 8) {       // bound the cache: drop the oldest
        delete g_dirs.front();
        g_dirs.erase(g_dirs.begin());
    }
    g_dirs.push_back(d);
    return d;
}

static inline int64_t key_lower_bound(const uint64_t* keys, int64_t n_keys,
                                      const KeyDir* d, uint64_t key)
{
    int64_t lo = 0, hi = n_keys;
    if (d) {
        uint64_t p = key >> d->shift;
        if (p >= (uint64_t)d->np) return n_keys;   // key > every index key
        lo = d->dir[(size_t)p];
        hi = d->dir[(size_t)p + 1];
    }
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (keys[mid] < key) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// collect sub-stage counters (MM2TPU_PROF=1): 0 = key lookup ns,
// 1 = occurrence expand + sort ns — the split that pinned the r5
// genome-scale collect cost to the key search.
static std::atomic<int64_t> g_coll_ns[2];
static int g_coll_prof = -1;
static inline bool coll_prof_on()
{
    if (g_coll_prof < 0) {
        const char* e = getenv("MM2TPU_PROF");
        g_coll_prof = (e && *e == '1') ? 1 : 0;
    }
    return g_coll_prof == 1;
}
static inline int64_t coll_now()
{
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec * 1000000000LL + ts.tv_nsec;
}

// Batched lower_bound over the key table through the prefix directory:
// host_seed_stats' np.searchsorted at genome scale pays the same
// whole-table key-search wall the collect stage did (~27 random misses
// per query); the directory cuts it to ~2. Same semantics as
// numpy searchsorted side='left'.
extern "C" void mm2tpu_key_lookup_batch(
    const uint64_t* keys, int64_t n_keys,
    const uint64_t* qk, int64_t n, int64_t* out_pos)
{
    const KeyDir* d = keydir_get(keys, n_keys);
    for (int64_t i = 0; i < n; ++i)
        out_pos[i] = key_lower_bound(keys, n_keys, d, qk[i]);
}

extern "C" void mm2tpu_collect_prof_read(int64_t* out2)
{
    out2[0] = g_coll_ns[0].load();
    out2[1] = g_coll_ns[1].load();
}
extern "C" void mm2tpu_collect_prof_reset()
{
    g_coll_ns[0] = 0;
    g_coll_ns[1] = 0;
}

// Extended collect with the ava-mode self/dual skipping (map.c:146-185):
// cmp(qname, target) is derived from lexicographic name ranks — q_exact is
// the query's exact rank among target names (or -1), q_ins its insertion
// rank; diag_flags bit0 = MM_F_NO_DIAG, bit1 = MM_F_NO_DUAL.
void* mm2tpu_collect_seeds_ava(
    const uint64_t* mv, int64_t n_mv,
    const uint64_t* keys, int64_t n_keys,
    const int64_t* starts, const uint64_t* values,
    int64_t max_occ, int64_t qlen_sum, int32_t skip_mode,
    const int64_t* name_rank, int64_t q_exact, int64_t q_ins,
    int32_t diag_flags,
    int64_t* out_sizes /*3: n_anchors, n_mini, rep_len*/)
{
    auto cmp_t = [&](int64_t rid) -> int {
        int64_t tr = name_rank[rid];
        if (q_exact >= 0)
            return tr == q_exact ? 0 : (tr < q_exact ? 1 : -1);
        return tr < q_ins ? 1 : -1;
    };
    auto* res = new Mm2tpuCollectOut();
    int64_t rep_len = 0, rep_st = 0, rep_en = 0;
    const KeyDir* kdir = keydir_get(keys, n_keys);
    const bool cprof = coll_prof_on();
    int64_t t_mark = cprof ? coll_now() : 0;
    // Block-pipelined gather (r5): the loop's memory traffic is random
    // single-element reads of three giant tables (dir/keys, starts,
    // values) — serially dependent per minimizer, so each costs a full
    // DRAM round trip.  Processing B minimizers per block with prefetch
    // between phases puts ~B misses in flight at once (memory-level
    // parallelism); per-minimizer ORDER of all emitted rows/mini_pos and
    // the rep_len merge is unchanged, so output is bit-identical.
    constexpr int64_t BLK = 16;
    int64_t lo_a[BLK];
    int64_t cnt_a[BLK];
    bool fnd_a[BLK];
    for (int64_t base = 0; base < n_mv; base += BLK) {
        int64_t nb = n_mv - base < BLK ? n_mv - base : BLK;
        if (kdir) {   // phase 0: directory rows for the whole block
            for (int64_t j = 0; j < nb; ++j) {
                uint64_t p = (mv[2 * (base + j)] >> 8) >> kdir->shift;
                if (p < (uint64_t)kdir->np)
                    __builtin_prefetch(&kdir->dir[(size_t)p]);
            }
        }
        // phase 1: narrowed searches; prefetch each hit's starts entry
        for (int64_t j = 0; j < nb; ++j) {
            uint64_t key = mv[2 * (base + j)] >> 8;
            int64_t lo = key_lower_bound(keys, n_keys, kdir, key);
            bool found = lo < n_keys && keys[lo] == key;
            lo_a[j] = lo;
            fnd_a[j] = found;
            if (found) __builtin_prefetch(&starts[lo]);
        }
        // phase 2: counts; prefetch each kept occurrence range
        for (int64_t j = 0; j < nb; ++j) {
            int64_t cnt = fnd_a[j] ? starts[lo_a[j] + 1] - starts[lo_a[j]]
                                   : 0;
            cnt_a[j] = cnt;
            if (cnt > 0 && cnt < max_occ) {
                const uint64_t* v = &values[starts[lo_a[j]]];
                __builtin_prefetch(v);
                if (cnt > 8) __builtin_prefetch(v + 8);
            }
        }
        if (cprof) {
            int64_t t2 = coll_now();
            g_coll_ns[0] += t2 - t_mark;
            t_mark = t2;
        }
        // phase 3: expand, exactly the original per-minimizer body
        for (int64_t j = 0; j < nb; ++j) {
            int64_t i = base + j;
            uint64_t x = mv[2*i], y = mv[2*i+1];
            uint64_t key = x >> 8;
            int64_t q_span = (int64_t)(x & 0xFF);
            int64_t q_pos = (int64_t)(uint32_t)y;
            uint64_t seg = y >> 32;
            int64_t lo = lo_a[j], cnt = cnt_a[j];
            bool found = fnd_a[j];
            if (cnt >= max_occ) {  // over-occurring: rep_len merge
                int64_t en = (q_pos >> 1) + 1, st = en - q_span;
                if (st > rep_en) { rep_len += rep_en - rep_st; rep_st = st; rep_en = en; }
                else rep_en = en;
                continue;
            }
            res->mini_pos.push_back((uint64_t)(q_pos >> 1)
                                    | ((uint64_t)q_span << 32));
            if (!found) continue;
            bool tnd = (i > 0 && (mv[2*(i-1)] >> 8) == key)
                    || (i + 1 < n_mv && (mv[2*(i+1)] >> 8) == key);
            uint64_t yflags = (seg << 48) | (tnd ? (1ULL << 42) : 0);
            for (int64_t o = 0; o < cnt; ++o) {
                uint64_t r = values[starts[lo] + o];
                int fwd = (int)(r & 1) == (int)(q_pos & 1);
                uint64_t self_flag = 0;
                if (diag_flags & 1) {  // ava self/dual skipping
                    int64_t rid = (int64_t)(r >> 32);
                    int64_t rpos = (int64_t)((uint32_t)r >> 1);
                    int c = cmp_t(rid);
                    if (c == 0 && rpos == (q_pos >> 1)) continue;  // diag
                    if (c == 0 && fwd) self_flag = 1ULL << 43;  // SEED_SELF
                    if ((diag_flags & 2) && c > 0) continue;       // dual
                }
                if ((skip_mode & 2) && fwd) continue;   // MM_F_REV_ONLY
                if ((skip_mode & 1) && !fwd) continue;  // MM_F_FOR_ONLY
                uint64_t ax = ((uint64_t)(fwd ? 0 : 1) << 63)
                            | ((r >> 32) << 32) | ((uint32_t)r >> 1);
                int64_t qpo = fwd ? (q_pos >> 1)
                                  : qlen_sum - ((q_pos >> 1) + 1 - q_span) - 1;
                uint64_t ay = ((uint64_t)q_span << 32) | (uint64_t)qpo
                            | yflags | self_flag;
                res->rows.emplace_back(ax, ay);
            }
        }
        if (cprof) {   // per-block: phases 0-2 -> slot 0, phase 3 -> 1
            int64_t t2 = coll_now();
            g_coll_ns[1] += t2 - t_mark;
            t_mark = t2;
        }
    }
    rep_len += rep_en - rep_st;
    // radix_sort_128x by x (map.c:233) — stable on equal x
    std::stable_sort(res->rows.begin(), res->rows.end(),
                     [](const std::pair<uint64_t, uint64_t>& a,
                        const std::pair<uint64_t, uint64_t>& b) {
                         return a.first < b.first;
                     });
    if (cprof) g_coll_ns[1] += coll_now() - t_mark;
    out_sizes[0] = (int64_t)res->rows.size();
    out_sizes[1] = (int64_t)res->mini_pos.size();
    out_sizes[2] = rep_len;
    return res;
}

void* mm2tpu_collect_seeds(
    const uint64_t* mv, int64_t n_mv,
    const uint64_t* keys, int64_t n_keys,
    const int64_t* starts, const uint64_t* values,
    int64_t max_occ, int64_t qlen_sum, int32_t skip_mode,
    int64_t* out_sizes)
{
    return mm2tpu_collect_seeds_ava(mv, n_mv, keys, n_keys, starts, values,
                                    max_occ, qlen_sum, skip_mode,
                                    nullptr, -1, 0, 0, out_sizes);
}

// ---- fused mm_fix_cigar + mm_update_extra (align.c:90-146 + 148-193).
// cigar is modified in place (shrunk); coords[4] = {qs, qe, rs, re} are
// updated by the leading-I/D strip.  out[6] =
// {n_cigar_new, blen, mlen, n_ambi_added, dp_max, ok}.
void mm2tpu_fix_update_extra(
    const uint8_t* qseq, const uint8_t* tseq,
    uint32_t* cigar, int64_t n_cigar,
    const int8_t* mat /*25*/, int32_t q, int32_t e, int32_t rev,
    int64_t* coords, int64_t* out)
{
    int64_t qs = coords[0], qe = coords[1], rs = coords[2], re = coords[3];
    int64_t qshift = 0, tshift = 0;
    // fix_cigar: indel left-shift against the preceding M run
    if (n_cigar > 1) {
        bool shrink = false;
        int64_t toff = 0, qoff = 0;
        for (int64_t k = 0; k < n_cigar; ++k) {
            int op = cigar[k] & 0xF;
            int64_t len = cigar[k] >> 4;
            if (len == 0) shrink = true;
            if (op == 0) {
                toff += len; qoff += len;
            } else if (op == 1 || op == 2) {
                if (k > 0 && k < n_cigar - 1 &&
                    (cigar[k-1] & 0xF) == 0 && (cigar[k+1] & 0xF) == 0) {
                    int64_t prev = cigar[k-1] >> 4, l = 0;
                    if (op == 1) {
                        while (l < prev &&
                               qseq[qoff - 1 - l] == qseq[qoff + len - 1 - l])
                            ++l;
                    } else {
                        while (l < prev &&
                               tseq[toff - 1 - l] == tseq[toff + len - 1 - l])
                            ++l;
                    }
                    if (l > 0) {
                        cigar[k-1] -= (uint32_t)(l << 4);
                        cigar[k+1] += (uint32_t)(l << 4);
                        qoff -= l; toff -= l;
                    }
                    if (l == prev) shrink = true;
                }
                if (op == 1) qoff += len; else toff += len;
            } else if (op == 3) {
                toff += len;
            }
        }
        if (qoff != qe - qs || toff != re - rs) { out[5] = 0; return; }
        if (shrink) {
            int64_t m = 0;
            for (int64_t k = 0; k < n_cigar; ++k) {
                if ((cigar[k] >> 4) == 0) continue;
                if (m > 0 && (cigar[m-1] & 0xF) == (int)(cigar[k] & 0xF))
                    cigar[m-1] += (cigar[k] >> 4) << 4;
                else
                    cigar[m++] = cigar[k];
            }
            n_cigar = m;
        }
        if (n_cigar > 0) {
            int op0 = cigar[0] & 0xF;
            int64_t l0 = cigar[0] >> 4;
            if (op0 == 1) {
                if (rev) qe -= l0; else qs += l0;
                qshift = l0;
                memmove(cigar, cigar + 1, (--n_cigar) * 4);
            } else if (op0 == 2) {
                rs += l0;
                tshift = l0;
                memmove(cigar, cigar + 1, (--n_cigar) * 4);
            }
        }
    }
    coords[0] = qs; coords[1] = qe; coords[2] = rs; coords[3] = re;
    // update_extra scan on the shifted sequences
    const uint8_t* qp = qseq + qshift;
    const uint8_t* tp = tseq + tshift;
    int64_t blen = 0, mlen = 0, n_ambi_tot = 0;
    int64_t toff = 0, qoff = 0, s = 0, maxv = 0;
    for (int64_t k = 0; k < n_cigar; ++k) {
        int op = cigar[k] & 0xF;
        int64_t len = cigar[k] >> 4;
        if (op == 0) {
            int64_t n_ambi = 0, n_diff = 0;
            for (int64_t l = 0; l < len; ++l) {
                uint8_t ct = tp[toff + l], cq = qp[qoff + l];
                if (ct > 3 || cq > 3) ++n_ambi;
                else if (ct != cq) ++n_diff;
                s += mat[ct * 5 + cq];
                if (s < 0) s = 0; else if (s > maxv) maxv = s;
            }
            blen += len - n_ambi;
            mlen += len - (n_ambi + n_diff);
            n_ambi_tot += n_ambi;
            toff += len; qoff += len;
        } else if (op == 1 || op == 2) {
            const uint8_t* sp = (op == 1) ? qp + qoff : tp + toff;
            int64_t n_ambi = 0;
            for (int64_t l = 0; l < len; ++l)
                if (sp[l] > 3) ++n_ambi;
            blen += len - n_ambi;
            n_ambi_tot += n_ambi;
            s -= q + e * len;
            if (s < 0) s = 0;
            if (op == 1) qoff += len; else toff += len;
        } else if (op == 3) {
            toff += len;
        }
    }
    out[0] = n_cigar; out[1] = blen; out[2] = mlen; out[3] = n_ambi_tot;
    out[4] = maxv;
    out[5] = (qoff == qe - qs && toff == re - rs) ? 1 : 0;
}

// glibc logf, exposed so the Python golden models compute the same
// float32 logarithm as the native paths (1-ulp differences vs numpy's
// float32 log otherwise leak into dv:f and mapq rounding).
float mm2tpu_logf(float x) { return logf(x); }

// ---- CIGAR-to-ASCII ("123M4I..."), ops MIDN (+SH handled by the caller).
// buf must hold >= 11*n_cigar bytes; returns the byte count written.
int64_t mm2tpu_cigar_str(const uint32_t* cigar, int64_t n_cigar, char* buf)
{
    static const char OPS[] = "MIDNSH";
    char* p = buf;
    for (int64_t k = 0; k < n_cigar; ++k) {
        uint32_t len = cigar[k] >> 4;
        char tmp[10];
        int t = 0;
        do { tmp[t++] = (char)('0' + len % 10); len /= 10; } while (len);
        while (t) *p++ = tmp[--t];
        *p++ = OPS[cigar[k] & 0xF];
    }
    return p - buf;
}

void mm2tpu_collect_take(void* h, uint64_t* anchors, uint64_t* mini)
{
    auto* res = (Mm2tpuCollectOut*)h;
    for (size_t i = 0; i < res->rows.size(); ++i) {
        anchors[2*i] = res->rows[i].first;
        anchors[2*i+1] = res->rows[i].second;
    }
    if (!res->mini_pos.empty())
        memcpy(mini, res->mini_pos.data(), res->mini_pos.size() * 8);
    delete res;
}

}  // extern "C"
