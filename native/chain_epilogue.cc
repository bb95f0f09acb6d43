// Native host epilogue for the chaining stage.
//
// The device chaining pass returns per-anchor (f, p) score/predecessor arrays; this
// module does the per-read O(n) bookkeeping that follows — the equivalents of
// the reference's compact-array construction (chain.c:286-316) and bottom-half
// backtrack (mm_chain_dp_bottom, chain.c:329-431) — in C++ instead of Python,
// because it runs once per read on the host side of the device boundary.
// Exposed with a C ABI and loaded via ctypes (no pybind11 in this image).
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Build the compact offload arrays from f/p (v derived internally) and run
// the bottom half. Outputs are written into caller-provided buffers sized n*2
// (worst case new_i <= 2n is impossible: new_i <= n entries appended at most
// twice... each anchor appended at most once as itself and once as a
// predecessor => new_i <= 2n).
//
// Returns n_u (number of chains); *out_n_v = total anchors across chains.
// out_a: (n_v, 2) uint64 chain anchors; out_u: (n_u) uint64 score<<32|cnt.
int64_t mm2tpu_chain_bottom(
    int64_t n, const uint64_t* ax, const uint64_t* ay, const int32_t* f,
    const int32_t* p, int32_t min_cnt, int32_t min_sc,
    uint64_t* out_a, uint64_t* out_u, int64_t* out_n_v)
{
    if (n <= 0) { *out_n_v = 0; return 0; }
    // ---- compact construction (chain.c:286-316), v[] computed on the fly ----
    std::vector<int64_t> fpga_id(n, -1);
    std::vector<int32_t> v(n);
    std::vector<uint64_t> cx, cy;
    std::vector<int32_t> cf;
    std::vector<int64_t> cp;
    cx.reserve(n * 2); cy.reserve(n * 2); cf.reserve(n * 2); cp.reserve(n * 2);
    for (int64_t i = 0; i < n; ++i) {
        int64_t max_j = p[i];
        v[i] = (max_j >= 0 && v[max_j] > f[i]) ? v[max_j] : f[i];
        if (max_j >= 0 && fpga_id[max_j] == -1) {
            cx.push_back(ax[max_j]);
            cy.push_back(ay[max_j]);
            cf.push_back(f[max_j]);
            cp.push_back((int64_t)(-1) << 2 | (v[max_j] >= min_sc ? 1 : 0)
                         | ((f[max_j] < v[max_j] ? 1 : 0) << 1));
            fpga_id[max_j] = (int64_t)cp.size() - 1;
        }
        bool alive = v[i] >= min_sc;
        if (alive || max_j >= 0) {
            cx.push_back(ax[i]);
            cy.push_back(ay[i]);
            cf.push_back(f[i]);
            int64_t pred = max_j >= 0 ? fpga_id[max_j] : -1;
            cp.push_back(pred << 2 | (alive ? 1 : 0)
                         | ((f[i] < v[i] ? 1 : 0) << 1));
            fpga_id[i] = (int64_t)cp.size() - 1;
        }
    }
    const int64_t new_i = (int64_t)cp.size();
    if (new_i == 0) { *out_n_v = 0; return 0; }

    // ---- bottom half (chain.c:329-431) ----
    std::vector<uint8_t> t(new_i, 0);
    for (int64_t i = 0; i < new_i; ++i)
        if (cp[i] >= 0) t[cp[i] >> 2] = 1;
    std::vector<uint64_t> u;
    for (int64_t i = 0; i < new_i; ++i) {
        if ((cp[i] & 1) && t[i] == 0) {
            int64_t j = i;
            while (j >= 0 && (cp[j] & 2)) j = cp[j] >> 2;
            if (j < 0) j = i;
            u.push_back((uint64_t)(uint32_t)cf[j] << 32 | (uint64_t)j);
        }
    }
    if (u.empty()) { *out_n_v = 0; return 0; }
    std::sort(u.begin(), u.end());
    std::reverse(u.begin(), u.end());

    std::fill(t.begin(), t.end(), 0);
    std::vector<int64_t> v_idx;
    v_idx.reserve(new_i);
    std::vector<uint64_t> out_chains;
    int64_t n_v = 0;
    for (uint64_t ui : u) {
        int64_t n_v0 = n_v;
        int64_t j = (int64_t)(uint32_t)ui;
        for (;;) {
            v_idx.push_back(j);
            ++n_v;
            t[j] = 1;
            j = cp[j] >> 2;
            if (!(j >= 0 && t[j] == 0)) break;
        }
        bool added = false;
        if (j < 0) {
            if (n_v - n_v0 >= min_cnt) {
                out_chains.push_back((ui >> 32 << 32) | (uint64_t)(n_v - n_v0));
                added = true;
            }
        } else if ((int64_t)(ui >> 32) - cf[j] >= min_sc) {
            if (n_v - n_v0 >= min_cnt) {
                out_chains.push_back((uint64_t)((ui >> 32) - (uint64_t)cf[j]) << 32
                                     | (uint64_t)(n_v - n_v0));
                added = true;
            }
        }
        if (!added) {
            n_v = n_v0;
            v_idx.resize(n_v0);
        }
    }
    const int64_t n_u = (int64_t)out_chains.size();
    if (n_u == 0) { *out_n_v = 0; return 0; }

    // emit per-chain anchors in forward order
    std::vector<uint64_t> bx(n_v), by(n_v);
    int64_t k = 0;
    for (uint64_t uc : out_chains) {
        int64_t ni = (int64_t)(uint32_t)uc;
        for (int64_t jj = 0; jj < ni; ++jj) {
            int64_t src = v_idx[k + ni - 1 - jj];
            bx[k + jj] = cx[src];
            by[k + jj] = cy[src];
        }
        k += ni;
    }

    // sort chains by first-anchor x, stable (chain.c:410-426)
    std::vector<int64_t> order(n_u), offs(n_u);
    k = 0;
    for (int64_t i = 0; i < n_u; ++i) {
        order[i] = i;
        offs[i] = k;
        k += (int64_t)(uint32_t)out_chains[i];
    }
    std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
        return bx[offs[a]] < bx[offs[b]];
    });
    k = 0;
    for (int64_t oi = 0; oi < n_u; ++oi) {
        int64_t j = order[oi];
        int64_t ni = (int64_t)(uint32_t)out_chains[j];
        out_u[oi] = out_chains[j];
        for (int64_t jj = 0; jj < ni; ++jj) {
            out_a[(k + jj) * 2] = bx[offs[j] + jj];
            out_a[(k + jj) * 2 + 1] = by[offs[j] + jj];
        }
        k += ni;
    }
    *out_n_v = n_v;
    return n_u;
}

// Full chaining DP: the banded predecessor scan (reference mm_chain_dp /
// mm_chain_dp_fpga top half, chain.c:246-316) followed by the compact +
// bottom half above.  This is the exact host path — used for err_flag
// fallbacks, oversized reads, and hosts without a device — porting the
// golden model ops/chain.py:chain_dp loop for loop (float32 avg_qspan,
// full-width ilog2, max_skip stamp heuristic, uint64 cross-strand
// distances).
int64_t mm2tpu_chain_dp(
    int64_t n, const uint64_t* ax, const uint64_t* ay,
    int64_t max_dist_x, int64_t max_dist_y, int64_t bw, int64_t max_skip,
    int32_t min_cnt, int32_t min_sc, int32_t is_cdna, int32_t n_segs,
    uint64_t* out_a, uint64_t* out_u, int64_t* out_n_v)
{
    if (n <= 0) { *out_n_v = 0; return 0; }
    std::vector<int32_t> f(n), p(n);
    std::vector<int64_t> t(n, 0), v(n);
    std::vector<int64_t> qpos(n), seg(n);
    std::vector<int32_t> span(n);
    int64_t sum_span = 0;
    for (int64_t i = 0; i < n; ++i) {
        qpos[i] = (int64_t)(uint32_t)ay[i];
        span[i] = (int32_t)((ay[i] >> 32) & 0xFF);
        seg[i] = (int64_t)((ay[i] >> 48) & 0xFF);
        sum_span += span[i];
    }
    const float avg_qspan_f = (float)sum_span / n;  // f32 division, chain.c:47
    const double avg_qspan = (double)avg_qspan_f;

    int64_t st = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint64_t ri = ax[i];
        int64_t qi = qpos[i], sidi = seg[i];
        int64_t q_span = span[i];
        int64_t max_f = q_span, max_j = -1, n_skip = 0;
        while (st < i && ri - ax[st] > (uint64_t)max_dist_x) ++st;
        for (int64_t j = i - 1; j >= st; --j) {
            uint64_t dr = ri - ax[j];
            int64_t dq = qi - qpos[j];
            int64_t sidj = seg[j];
            if ((sidi == sidj && dr == 0) || dq <= 0) continue;
            if ((sidi == sidj && dq > max_dist_y) || dq > max_dist_x)
                continue;
            uint64_t dd = dr > (uint64_t)dq ? dr - (uint64_t)dq
                                            : (uint64_t)dq - dr;
            if (sidi == sidj && dd > (uint64_t)bw) continue;
            if (n_segs > 1 && !is_cdna && sidi == sidj
                && dr > (uint64_t)max_dist_y) continue;
            int64_t min_d = (uint64_t)dq < dr ? dq : (int64_t)dr;
            int64_t sc = min_d > q_span ? q_span : min_d;
            int64_t log_dd = dd ? 63 - __builtin_clzll(dd) : 0;
            if (is_cdna || sidi != sidj) {
                double cl = (double)dd * .01 * avg_qspan;
                int64_t c_lin = cl >= 9.0e18 ? INT64_MAX : (int64_t)cl;
                int64_t c_log = log_dd;
                if (sidi != sidj && dr == 0) sc += 1;
                else if (dr > (uint64_t)dq || sidi != sidj)
                    sc -= c_lin < c_log ? c_lin : c_log;
                else sc -= c_lin + (c_log >> 1);
            } else {
                sc -= (int64_t)((double)dd * .01 * avg_qspan)
                    + (log_dd >> 1);
            }
            sc += f[j];
            if (sc > max_f) {
                max_f = sc; max_j = j;
                if (n_skip > 0) --n_skip;
            } else if (t[j] == i) {
                if (++n_skip > max_skip) break;
            }
            if (p[j] >= 0) t[p[j]] = i;
        }
        f[i] = (int32_t)max_f;
        p[i] = (int32_t)max_j;
        v[i] = (max_j >= 0 && v[max_j] > max_f) ? v[max_j] : max_f;
    }
    return mm2tpu_chain_bottom(n, ax, ay, f.data(), p.data(), min_cnt,
                               min_sc, out_a, out_u, out_n_v);
}

}  // extern "C"
