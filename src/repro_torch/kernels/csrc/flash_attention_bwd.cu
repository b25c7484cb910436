// Causal / sliding-window flash-attention backward, float32, for sm_90a.
//
// Replaces: the gradient that the JAX package takes of its jnp attention
// inside jax.value_and_grad (src/repro/launch/train.py, make_train_step;
// RunConfig.attn_impl = "chunked"). The JAX package has no backward
// Pallas kernel; its forward is src/repro/kernels/flash_attention.py,
// flash_attention, whose CUDA counterpart is flash_attention.cu. The port's
// training runs every attention layer's gradient through this file.
//
// Computes, for q (B,H,S,D), k (B,Hk,S,D), v (B,Hk,S,Dv), the forward's
// output o (B,H,S,Dv) and its gradient dO:
//   P  = softmax(scale Q K^T) under the causal / window mask,
//   dV = P^T dO,  dS = P o (dO V^T - rowsum(dO o O)),
//   dQ = dS K scale,  dK = dS^T Q scale,
// with dK and dV summed over each kv head's group of H / Hk query heads.
//
// Bound on the H100: operations. The five products over the band cost
// 2 * (3 D + 2 Dv) flops a (query, key) pair: at gemma3-1b's global layer
// (B=4, H=4, Hk=1, S=1024, D=256) 21.5 GFLOP, 0.32 ms at the 67 TFLOP/s
// CUDA-core f32 rate, against 25 MB of inputs and outputs (0.008 ms at
// 3.35 TB/s).
//
// Design: right, deterministic and simple first; SIMT f32 with f32 sums.
// Three kernels, 256 threads a block, 32-row query and 32-key tiles in
// shared memory (rows padded by one float, so the 8 rows a warp reads at
// one column fall on 8 banks), head dims zero-filled to HD in
// {64, 128, 256}:
//   1. flash_bwd_prep, one block per (b, h, query tile): each row's
//      log-sum-exp over its band (an online max and sum; 8 lanes a row,
//      merged by xor shuffles) and delta = rowsum(dO o O).
//   2. flash_bwd_dkdv, one block per (b, kv head, key tile): K and V stay
//      in shared memory; the block loops over the group's query heads and
//      the query tiles of the band, recomputes p = exp(s - lse), and
//      accumulates dK and dV in registers (a thread owns one column of
//      32 / (256 / HD) keys). At HD = 256 the K, V, Q and dO tiles take
//      131,584 bytes and P and dS 8,448: one block an SM.
//   3. flash_bwd_dq, one block per (b, h, query tile): loops over the key
//      tiles of the band; dQ accumulates in registers.
// No atomics: every output element is written once by one thread, and
// every sum runs in a fixed order, so two launches give the same bits.
// Rows and keys past S are zero-filled and masked (any S), kv head
// h / (H / Hk) is read in place (GQA), Dv may differ from D, and every
// tensor is read and written through its batch, head and sequence strides
// with a unit last stride (the wrapper checks). Left for a later version:
// tensor cores (3xTF32 mma.sync, as the forward), and one pass for dQ,
// dK and dV.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxD = 256;
constexpr int kThreads = 256;
constexpr int kBQ = 32;  // query rows a tile
constexpr int kBK = 32;  // keys a tile
constexpr int kLdS = kBK + 1;  // row stride of the P and dS tiles

enum { kQ = 0, kK, kV, kO, kDO, kDQ, kDK, kDV, kTensors };

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  float* dq;
  float* dk;
  float* dv;
  float* lse;    // (B, H, S), contiguous
  float* delta;  // (B, H, S), contiguous
  int H, group, S, D, Dv;
  long long st[kTensors][3];  // batch, head and sequence strides
  float scale;
  int causal;
  int window;  // <= 0: no window
};

__device__ __forceinline__ bool allowed(const Params& p, int i, int j) {
  return i < p.S && j < p.S && (!p.causal || j <= i) &&
         (p.window <= 0 || i - j < p.window);
}

// Keys [key_begin(q0), key_end(q1)) hold every key that rows [q0, q1) see.
__device__ __forceinline__ int key_begin(const Params& p, int q0) {
  return p.window > 0 ? max(0, q0 - p.window + 1) : 0;
}
__device__ __forceinline__ int key_end(const Params& p, int q1) {
  return p.causal ? q1 : p.S;
}
// Rows [row_begin(k0), row_end(k1)) hold every row that sees keys [k0, k1).
__device__ __forceinline__ int row_begin(const Params& p, int k0) {
  return p.causal ? k0 : 0;
}
__device__ __forceinline__ int row_end(const Params& p, int k1) {
  return p.window > 0 ? min(p.S, k1 - 1 + p.window) : p.S;
}

__device__ __forceinline__ const float* at(const Params& p, const float* t,
                                           int which, int b, int h) {
  return t + b * p.st[which][0] + h * p.st[which][1];
}

// Rows [r0, r0 + 32) of a (S, n) slice with row stride ss into a
// [32][HD + 1] tile; rows past S and columns past n are zero.
template <int HD>
__device__ __forceinline__ void load_tile(float* tile, const float* base,
                                          long long ss, int r0, int S,
                                          int n) {
  for (int e = threadIdx.x; e < 32 * HD; e += kThreads) {
    const int r = e / HD, c = e - r * HD, row = r0 + r;
    tile[r * (HD + 1) + c] = (row < S && c < n) ? base[row * ss + c] : 0.f;
  }
}

// out[m] = sum_d A[r][d] * B[c0 + 8 m][d] for m < 4, over [32][HD + 1]
// tiles, d in order.
template <int HD>
__device__ __forceinline__ void dots(const float* A, const float* B, int r,
                                     int c0, float out[4]) {
  const float* a = A + r * (HD + 1);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    const float x = a[d];
#pragma unroll
    for (int m = 0; m < 4; ++m)
      acc[m] = fmaf(x, B[(c0 + 8 * m) * (HD + 1) + d], acc[m]);
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) out[m] = acc[m];
}

// Each row's log-sum-exp over its band and delta = rowsum(dO o O). Thread
// t reads row t / 8 of the tile and keys t % 8 + 8 m.
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_prep(Params p) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * (HD + 1);
  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int q0 = blockIdx.y * kBQ, q1 = min(q0 + kBQ, p.S);
  const int t = threadIdx.x, r = t >> 3, c0 = t & 7, i = q0 + r;
  const float* k = at(p, p.k, kK, b, h / p.group);
  load_tile<HD>(Qs, at(p, p.q, kQ, b, h), p.st[kQ][2], q0, p.S, p.D);
  float m = -INFINITY, l = 0.f;
  for (int k0 = key_begin(p, q0); k0 < key_end(p, q1); k0 += kBK) {
    __syncthreads();
    load_tile<HD>(Ks, k, p.st[kK][2], k0, p.S, p.D);
    __syncthreads();
    float s[4];
    dots<HD>(Qs, Ks, r, c0, s);
#pragma unroll
    for (int mm = 0; mm < 4; ++mm) {
      if (!allowed(p, i, k0 + c0 + 8 * mm)) continue;
      const float x = s[mm] * p.scale;
      if (x > m) {
        l = l * expf(m - x) + 1.f;
        m = x;
      } else {
        l += expf(x - m);
      }
    }
  }
  // merge the 8 lanes of a row (one warp holds 4 rows); max and + commute,
  // so every lane ends with the same bits
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    const float mx = fmaxf(m, m2);
    l = mx == -INFINITY ? 0.f : l * expf(m - mx) + l2 * expf(m2 - mx);
    m = mx;
  }
  float dl = 0.f;
  if (i < p.S) {
    const float* o = at(p, p.o, kO, b, h) + i * p.st[kO][2];
    const float* g = at(p, p.dout, kDO, b, h) + i * p.st[kDO][2];
    for (int d = c0; d < p.Dv; d += 8) dl = fmaf(g[d], o[d], dl);
  }
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    dl += __shfl_xor_sync(0xffffffffu, dl, off);
  if (c0 == 0 && i < p.S) {
    const long long row = static_cast<long long>(bh) * p.S + i;
    p.lse[row] = m + logf(l);
    p.delta[row] = dl;
  }
}

// p and dS of the tile's (row r, key c0 + 8 m) pairs into Ps and dSs
// (Ps may be null); rowv holds the tile's lse, then its delta.
template <int HD>
__device__ __forceinline__ void p_and_ds(const Params& p, const float* Qs,
                                         const float* Ks, const float* dOs,
                                         const float* Vs, const float* rowv,
                                         int q0, int k0, float* Ps,
                                         float* dSs) {
  const int t = threadIdx.x, r = t >> 3, c0 = t & 7;
  float s[4], dp[4];
  dots<HD>(Qs, Ks, r, c0, s);
  dots<HD>(dOs, Vs, r, c0, dp);
#pragma unroll
  for (int mm = 0; mm < 4; ++mm) {
    const int c = c0 + 8 * mm;
    const float pr =
        allowed(p, q0 + r, k0 + c) ? expf(s[mm] * p.scale - rowv[r]) : 0.f;
    if (Ps) Ps[r * kLdS + c] = pr;
    dSs[r * kLdS + c] = pr * (dp[mm] - rowv[kBQ + r]);
  }
}

// Rows [q0, q0 + 32) of lse and delta into rowv.
__device__ __forceinline__ void load_rows(const Params& p, float* rowv,
                                          long long bh, int q0) {
  const int t = threadIdx.x;
  if (t < kBQ) {
    const int i = q0 + t;
    rowv[t] = i < p.S ? p.lse[bh * p.S + i] : 0.f;
    rowv[kBQ + t] = i < p.S ? p.delta[bh * p.S + i] : 0.f;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv(Params p) {
  constexpr int kLd = HD + 1;
  constexpr int G = kThreads / HD;  // key groups: 1, 2 or 4
  constexpr int NJ = kBK / G;       // keys a thread
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBK * kLd;
  float* Qs = Vs + kBK * kLd;
  float* dOs = Qs + kBQ * kLd;
  float* Ps = dOs + kBQ * kLd;
  float* dSs = Ps + kBQ * kLdS;
  float* rowv = dSs + kBQ * kLdS;
  const int Hk = p.H / p.group;
  const int b = blockIdx.x / Hk, hk = blockIdx.x - b * Hk;
  const int k0 = blockIdx.y * kBK, k1 = min(k0 + kBK, p.S);
  const int t = threadIdx.x, col = t % HD, kg = t / HD;
  load_tile<HD>(Ks, at(p, p.k, kK, b, hk), p.st[kK][2], k0, p.S, p.D);
  load_tile<HD>(Vs, at(p, p.v, kV, b, hk), p.st[kV][2], k0, p.S, p.Dv);
  float acc_k[NJ], acc_v[NJ];
#pragma unroll
  for (int n = 0; n < NJ; ++n) acc_k[n] = acc_v[n] = 0.f;
  for (int gi = 0; gi < p.group; ++gi) {
    const int h = hk * p.group + gi;
    const float* q = at(p, p.q, kQ, b, h);
    const float* g = at(p, p.dout, kDO, b, h);
    const long long bh = static_cast<long long>(b) * p.H + h;
    for (int q0 = row_begin(p, k0); q0 < row_end(p, k1); q0 += kBQ) {
      __syncthreads();
      load_tile<HD>(Qs, q, p.st[kQ][2], q0, p.S, p.D);
      load_tile<HD>(dOs, g, p.st[kDO][2], q0, p.S, p.Dv);
      load_rows(p, rowv, bh, q0);
      __syncthreads();
      p_and_ds<HD>(p, Qs, Ks, dOs, Vs, rowv, q0, k0, Ps, dSs);
      __syncthreads();
      for (int rr = 0; rr < kBQ; ++rr) {
        const float qd = Qs[rr * kLd + col], gd = dOs[rr * kLd + col];
#pragma unroll
        for (int n = 0; n < NJ; ++n) {
          const int j = kg + G * n;
          acc_v[n] = fmaf(Ps[rr * kLdS + j], gd, acc_v[n]);
          acc_k[n] = fmaf(dSs[rr * kLdS + j], qd, acc_k[n]);
        }
      }
    }
  }
  float* dk = p.dk + b * p.st[kDK][0] + hk * p.st[kDK][1];
  float* dv = p.dv + b * p.st[kDV][0] + hk * p.st[kDV][1];
#pragma unroll
  for (int n = 0; n < NJ; ++n) {
    const int j = k0 + kg + G * n;
    if (j >= p.S) continue;
    if (col < p.D) dk[j * p.st[kDK][2] + col] = acc_k[n] * p.scale;
    if (col < p.Dv) dv[j * p.st[kDV][2] + col] = acc_v[n];
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(Params p) {
  constexpr int kLd = HD + 1;
  constexpr int G = kThreads / HD;  // row groups: 1, 2 or 4
  constexpr int NI = kBQ / G;       // rows a thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kBQ * kLd;
  float* Ks = dOs + kBQ * kLd;
  float* Vs = Ks + kBK * kLd;
  float* dSs = Vs + kBK * kLd;
  float* rowv = dSs + kBQ * kLdS;
  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int q0 = blockIdx.y * kBQ, q1 = min(q0 + kBQ, p.S);
  const int t = threadIdx.x, col = t % HD, rg = t / HD;
  const float* k = at(p, p.k, kK, b, h / p.group);
  const float* v = at(p, p.v, kV, b, h / p.group);
  load_tile<HD>(Qs, at(p, p.q, kQ, b, h), p.st[kQ][2], q0, p.S, p.D);
  load_tile<HD>(dOs, at(p, p.dout, kDO, b, h), p.st[kDO][2], q0, p.S, p.Dv);
  load_rows(p, rowv, bh, q0);
  float acc[NI];
#pragma unroll
  for (int n = 0; n < NI; ++n) acc[n] = 0.f;
  for (int k0 = key_begin(p, q0); k0 < key_end(p, q1); k0 += kBK) {
    __syncthreads();
    load_tile<HD>(Ks, k, p.st[kK][2], k0, p.S, p.D);
    load_tile<HD>(Vs, v, p.st[kV][2], k0, p.S, p.Dv);
    __syncthreads();
    p_and_ds<HD>(p, Qs, Ks, dOs, Vs, rowv, q0, k0, nullptr, dSs);
    __syncthreads();
    for (int c = 0; c < kBK; ++c) {
      const float kd = Ks[c * kLd + col];
#pragma unroll
      for (int n = 0; n < NI; ++n)
        acc[n] = fmaf(dSs[(rg + G * n) * kLdS + c], kd, acc[n]);
    }
  }
  float* dq = p.dq + b * p.st[kDQ][0] + h * p.st[kDQ][1];
#pragma unroll
  for (int n = 0; n < NI; ++n) {
    const int i = q0 + rg + G * n;
    if (i < p.S && col < p.D) dq[i * p.st[kDQ][2] + col] = acc[n] * p.scale;
  }
}

// Bytes of dynamic shared memory of each kernel.
template <int HD>
struct Smem {
  static constexpr size_t kTile = sizeof(float) * 32 * (HD + 1);
  static constexpr size_t kPS = sizeof(float) * kBQ * kLdS;
  static constexpr size_t kRows = sizeof(float) * 2 * kBQ;
  static constexpr size_t kPrep = 2 * kTile;
  static constexpr size_t kDkdv = 4 * kTile + 2 * kPS + kRows;
  static constexpr size_t kDq = 4 * kTile + kPS + kRows;
};

int launch_one(void (*kernel)(Params), size_t smem, dim3 grid,
               const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch(const Params& p, int B, int Hk, cudaStream_t stream) {
  const int q_tiles = (p.S + kBQ - 1) / kBQ, k_tiles = (p.S + kBK - 1) / kBK;
  int err = launch_one(flash_bwd_prep<HD>, Smem<HD>::kPrep,
                       dim3(B * p.H, q_tiles), p, stream);
  if (err) return err;
  err = launch_one(flash_bwd_dkdv<HD>, Smem<HD>::kDkdv, dim3(B * Hk, k_tiles),
                   p, stream);
  if (err) return err;
  return launch_one(flash_bwd_dq<HD>, Smem<HD>::kDq, dim3(B * p.H, q_tiles),
                    p, stream);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B,H,S,D), k (B,Hk,S,D), v (B,Hk,S,Dv), o and dout (B,H,S,Dv) in; dq,
// dk, dv (shaped as q, k, v) out; lse and delta (B,H,S) contiguous float32
// scratch. strides: 24 batch/head/sequence strides in elements, three each
// for q, k, v, o, dout, dq, dk, dv; every last stride is 1. window <= 0:
// no window. Returns a cudaError_t.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, void* dq, void* dk,
                        void* dv, void* lse, void* delta, int B, int H,
                        int Hk, int S, int D, int Dv,
                        const long long* strides, float scale, int causal,
                        int window, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (Hk <= 0 || H % Hk || D <= 0 || D > kMaxD || Dv <= 0 || Dv > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<const float*>(o);
  p.dout = static_cast<const float*>(dout);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.lse = static_cast<float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.H = H;
  p.group = H / Hk;
  p.S = S;
  p.D = D;
  p.Dv = Dv;
  for (int i = 0; i < kTensors; ++i)
    for (int j = 0; j < 3; ++j) p.st[i][j] = strides[3 * i + j];
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hd = D > Dv ? D : Dv;
  if (hd <= 64) return launch<64>(p, B, Hk, st);
  if (hd <= 128) return launch<128>(p, B, Hk, st);
  return launch<256>(p, B, Hk, st);
}

}  // extern "C"
