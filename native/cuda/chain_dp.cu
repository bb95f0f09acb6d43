// Chaining-DP score pass for NVIDIA Hopper, called from JAX through the
// foreign function interface (ops/chain_cuda.py builds and registers it).
//
// Same inputs and (f, p, flag) contract as ops/chain_jax.chain_scores_batch_xla
// and ops/chain_batch.py. One warp maps one read: the anchor loop runs in
// order inside the kernel (f[i] needs every earlier f[j]), so a read's whole
// DP is one launch. For anchor i the 32 lanes score 32 predecessor
// candidates at a time, newest first, over the window [stw[i], i); f[] of
// the read lives in shared memory. Each lane keeps its best candidate as a
// packed (score, j) key, so the warp's argmax with the reference's tie rule
// (larger j wins, chain.c's descending scan reaches it first) is one
// 64-bit max reduction. The number of valid candidates scanned before the
// winner (the max_skip flag, see ops/chain_batch.py) comes from ballot +
// popc of the lanes below it.
//
// The one float operation, trunc(f32(dd) * w1), is written with the
// round-to-nearest intrinsics and the file is built with -fmad=false, so
// it matches the plain version bit for bit.
#include <cstdint>
#include <climits>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kNegInf = -0x40000000;
constexpr int kTbl = 2048;
constexpr int kNExc = 2;
constexpr unsigned kFull = 0xffffffffu;
// shared memory a block may use without an opt-in
constexpr int kSmemBytes = 48 * 1024;

enum Mode { kSingleSeg = 0, kManySegs = 1, kCdna = 2 };

__device__ __forceinline__ int ilog2_f32(int dd) {
  // floor(log2(max(dd, 1))) through the float32 exponent, as the plain
  // version computes it
  float d = fmaxf(__int2float_rn(dd), 1.0f);
  return (__float_as_int(d) >> 23) - 127;
}

template <int MODE>
__global__ void chain_dp_kernel(
    const int32_t* __restrict__ xhi, const int32_t* __restrict__ rpos,
    const int32_t* __restrict__ qpos, const int32_t* __restrict__ span,
    const int32_t* __restrict__ sid, const int32_t* __restrict__ stw,
    const int32_t* __restrict__ nn, const float* __restrict__ w1,
    const int32_t* __restrict__ exc, int32_t* __restrict__ f_out,
    int32_t* __restrict__ p_out, int32_t* __restrict__ flag_out, int n_reads,
    int max_n, int max_dist_x, int max_dist_y, int bw, int max_skip) {
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * (blockDim.x >> 5) + warp;
  if (r >= n_reads) return;  // the whole warp leaves together
  int32_t* fs = smem + warp * max_n;
  const size_t off = static_cast<size_t>(r) * max_n;
  const int32_t* X = xhi + off;
  const int32_t* RP = rpos + off;
  const int32_t* QP = qpos + off;
  const int32_t* SP = span + off;
  const int32_t* SD = sid + off;
  const int32_t* ST = stw + off;
  int32_t* F = f_out + off;
  int32_t* P = p_out + off;
  const int n = nn[r];
  const float w = w1[r];
  int exc_d[kNExc], exc_v[kNExc];
  for (int k = 0; k < kNExc; ++k) {
    exc_d[k] = exc[r * 2 * kNExc + 2 * k];
    exc_v[k] = exc[r * 2 * kNExc + 2 * k + 1];
  }
  const int mdy_x = min(max_dist_y, max_dist_x);
  const unsigned lanes_below = (1u << lane) - 1u;

  for (int i = n + lane; i < max_n; i += 32) {
    F[i] = 0;
    P[i] = -1;
  }
  int flagged = 0;
  for (int i = 0; i < n; ++i) {
    const int ri = RP[i], qi = QP[i], qs = SP[i], st = ST[i];
    const int xi = MODE == kSingleSeg ? 0 : X[i];
    const int si = MODE == kSingleSeg ? 0 : SD[i];
    long long best = LLONG_MIN;  // packed (score, j); larger is better
    int best_sc = kNegInf, best_j = -1, snap = 0, tot = 0;
    for (int top = i - 1; top >= st; top -= 32) {
      const int j = top - lane;
      bool valid = j >= st;
      int sc = 0;
      if (valid) {
        const int dr = ri - RP[j];
        const int dq = qi - QP[j];
        const int dd = dr > dq ? dr - dq : dq - dr;
        bool same = true;
        if (MODE == kSingleSeg) {
          valid = dr != 0 && static_cast<unsigned>(dq - 1) <
                                 static_cast<unsigned>(mdy_x) &&
                  dd <= bw;
        } else {
          same = SD[j] == si;
          valid = X[j] == xi && dr <= max_dist_x;
          valid = valid && !((same && dr == 0) || dq <= 0);
          valid = valid && !((same && dq > max_dist_y) || dq > max_dist_x);
          valid = valid && !(same && dd > bw);
          if (MODE == kManySegs) valid = valid && !(same && dr > max_dist_y);
        }
        if (valid) {
          sc = min(min(dq, dr), qs);
          int c_lin = __float2int_rz(__fmul_rn(__int2float_rn(dd), w));
          for (int k = 0; k < kNExc; ++k)
            if (dd == exc_d[k]) c_lin = exc_v[k];
          const int log_dd = ilog2_f32(dd);
          const int pen_same = c_lin + (log_dd >> 1);
          if (MODE == kSingleSeg) {
            sc -= pen_same;
          } else {
            const int pen_other = dd >= kTbl ? log_dd : min(c_lin, log_dd);
            if (MODE == kCdna) {
              if (!same && dr == 0)
                sc += 1;
              else if (dr > dq || !same)
                sc -= pen_other;
              else
                sc -= pen_same;
            } else {
              if (same)
                sc -= pen_same;
              else if (dr == 0)
                sc += 1;
              else
                sc -= pen_other;
            }
          }
          sc += fs[j];
        }
      }
      const unsigned ball = __ballot_sync(kFull, valid);
      if (valid) {
        const long long key = static_cast<long long>(sc) * 4294967296LL + j;
        if (key > best) {
          best = key;
          best_sc = sc;
          best_j = j;
          snap = tot + __popc(ball & lanes_below);
        }
      }
      tot += __popc(ball);
    }
    long long wbest = best;
    for (int o = 16; o > 0; o >>= 1)
      wbest = max(wbest, __shfl_xor_sync(kFull, wbest, o));
    const int src = __ffs(__ballot_sync(kFull, best == wbest)) - 1;
    best_sc = __shfl_sync(kFull, best_sc, src);
    best_j = __shfl_sync(kFull, best_j, src);
    snap = __shfl_sync(kFull, snap, src);
    const bool have = wbest != LLONG_MIN && best_sc > qs;
    if (lane == 0) {
      const int f_i = have ? best_sc : qs;
      fs[i] = f_i;
      F[i] = f_i;
      P[i] = have ? best_j : -1;
    }
    if (have && snap > max_skip) flagged = 1;
    __syncwarp();  // fs[i] is read by the next anchors' lanes
  }
  if (lane == 0) flag_out[r] = flagged;
}

}  // namespace

ffi::Error ChainDpImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> xhi,
                       ffi::Buffer<ffi::S32> rpos, ffi::Buffer<ffi::S32> qpos,
                       ffi::Buffer<ffi::S32> span, ffi::Buffer<ffi::S32> sid,
                       ffi::Buffer<ffi::S32> stw, ffi::Buffer<ffi::S32> nn,
                       ffi::Buffer<ffi::F32> w1, ffi::Buffer<ffi::S32> exc,
                       int32_t max_dist_x, int32_t max_dist_y, int32_t bw,
                       int32_t max_skip, int32_t mode,
                       ffi::ResultBuffer<ffi::S32> f,
                       ffi::ResultBuffer<ffi::S32> p,
                       ffi::ResultBuffer<ffi::S32> flag) {
  auto dims = rpos.dimensions();
  if (dims.size() != 2)
    return ffi::Error::InvalidArgument("anchor arrays must be (R, max_n)");
  const int n_reads = static_cast<int>(dims[0]);
  const int max_n = static_cast<int>(dims[1]);
  if (exc.element_count() != static_cast<size_t>(n_reads) * 2 * kNExc)
    return ffi::Error::InvalidArgument("exc must be (R, 2 * N_EXC)");
  const int row_bytes = max_n * static_cast<int>(sizeof(int32_t));
  if (row_bytes > kSmemBytes)
    return ffi::Error::InvalidArgument("max_n too large for shared memory");
  int warps = 1;
  while (warps < 4 && 2 * warps * row_bytes <= kSmemBytes) warps *= 2;
  if (n_reads == 0) return ffi::Error::Success();
  const dim3 grid((n_reads + warps - 1) / warps);
  const dim3 block(32 * warps);
  const size_t smem = static_cast<size_t>(warps) * row_bytes;
#define MM2_LAUNCH(M)                                                        \
  chain_dp_kernel<M><<<grid, block, smem, stream>>>(                         \
      xhi.typed_data(), rpos.typed_data(), qpos.typed_data(),                \
      span.typed_data(), sid.typed_data(), stw.typed_data(), nn.typed_data(), \
      w1.typed_data(), exc.typed_data(), f->typed_data(), p->typed_data(),   \
      flag->typed_data(), n_reads, max_n, max_dist_x, max_dist_y, bw,        \
      max_skip)
  switch (mode) {
    case kSingleSeg: MM2_LAUNCH(kSingleSeg); break;
    case kManySegs: MM2_LAUNCH(kManySegs); break;
    case kCdna: MM2_LAUNCH(kCdna); break;
    default: return ffi::Error::InvalidArgument("unknown chaining mode");
  }
#undef MM2_LAUNCH
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(Mm2ChainDp, ChainDpImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()  // xhi
                                  .Arg<ffi::Buffer<ffi::S32>>()  // rpos
                                  .Arg<ffi::Buffer<ffi::S32>>()  // qpos
                                  .Arg<ffi::Buffer<ffi::S32>>()  // span
                                  .Arg<ffi::Buffer<ffi::S32>>()  // sid
                                  .Arg<ffi::Buffer<ffi::S32>>()  // stw
                                  .Arg<ffi::Buffer<ffi::S32>>()  // nn
                                  .Arg<ffi::Buffer<ffi::F32>>()  // w1
                                  .Arg<ffi::Buffer<ffi::S32>>()  // exc
                                  .Attr<int32_t>("max_dist_x")
                                  .Attr<int32_t>("max_dist_y")
                                  .Attr<int32_t>("bw")
                                  .Attr<int32_t>("max_skip")
                                  .Attr<int32_t>("mode")
                                  .Ret<ffi::Buffer<ffi::S32>>()  // f
                                  .Ret<ffi::Buffer<ffi::S32>>()  // p
                                  .Ret<ffi::Buffer<ffi::S32>>()  // flag
);
