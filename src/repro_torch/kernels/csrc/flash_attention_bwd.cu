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
// output o (B,H,S,Dv), its log-sum-exp lse (B,H,S) and the gradient dO:
//   P  = softmax(scale Q K^T) under the causal / window mask,
//   dV = P^T dO,  dS = P o (dO V^T - rowsum(dO o O)),
//   dQ = dS K scale,  dK = dS^T Q scale,
// with dK and dV summed over each kv head's group of H / Hk query heads.
// lse is the forward kernel's (flash_fwd_tf32 with an lse buffer): each
// row's log2 sum_j 2^(s_ij scale log2 e), so P = 2^(s scale log2 e - lse)
// with no pass over Q K^T to rebuild it.
//
// Bound on the H100: operations. The five products over the band cost
// 2 * (3 D + 2 Dv) flops a (query, key) pair: at gemma3-1b's global layer
// (B=4, H=4, Hk=1, S=1024, D=256) 21.5 GFLOP, 0.130 ms at the 3xTF32 rate
// (494.7 / 3 TFLOP/s), against 25 MB of inputs and outputs (0.008 ms at
// 3.35 TB/s). This file runs seven: S and dP are computed once for dK and
// dV and again for dQ.
//
// Design: every product on tensor cores in 3xTF32 (tf32_mma.cuh: each f32
// operand split into TF32 big + small, three mma.sync m16n8k8 a product,
// about f32 accuracy; one TF32 product misses the 1e-4 tolerance). Blocks
// of 8 warps, 32-key and 32-query tiles in shared memory, head dims
// zero-filled to HD in {64, 128, 256}; rows of Q, K, V and dO tiles are
// padded by 8 floats, of P and dS tiles by 4, so that every fragment read
// of a warp falls on 32 banks. Tiles are copied with 4-byte cp.async (any
// alignment, so no layout rule beyond a unit last stride), and the tiles a
// block walks are double-buffered: the next one copies while this one
// computes. S and dP run as four independent mma chains a warp (two
// tiles, even and odd steps). Four kernels on one stream:
//   1. flash_bwd_delta, one warp a row: delta = rowsum(dO o O). Bytes.
//   2. flash_bwd_dkdv, one block per (b, query head, key tile): K and V
//      stay in shared memory; the block walks the query tiles of the band
//      and computes S^T = K Q^T and dP^T = V dO^T (one 16x8 C tile a warp
//      each), P^T = 2^(S^T scale log2 e - lse) and dS^T = P^T o (dP^T -
//      delta) into shared memory, then dV += P^T dO and dK += dS^T Q, the
//      32 x HD sums in mma C fragments in registers (at HD = 256, 8 tiles
//      of 16x8 a warp for each: 64 floats a thread). The grid's y is the
//      key tile, so the tiles that the causal band gives most rows start
//      first; at gemma3-1b's shape it is 512 blocks whose longest walks 32
//      query tiles (a kv-head grid would be 128 blocks walking up to 128).
//      Smem: 65,024 bytes at HD = 64, 114,176 at 128, 212,480 at 256 (one
//      block an SM).
//   3. flash_bwd_dkdv_sum, one block per (b, kv head, key): where a kv
//      head serves a group of G > 1 query heads, step 2 writes
//      per-query-head partials of dK and dV to f32 scratch (B,H,S,D) and
//      (B,H,S,Dv), and this pass adds each group's G partials in head
//      order and applies scale to dK. Bytes. With G = 1 step 2 writes dK
//      and dV directly and this pass does not run.
//   4. flash_bwd_dq, one block per (b, query head, query tile): Q, dO and
//      the rows' lse and delta stay in shared memory; the block walks the
//      key tiles of the band, computes S, dP and dS the same way, and dQ
//      += dS K. The grid's y runs backwards, so the tiles that see most
//      keys start first. Smem: 60,160 bytes at HD = 64, 109,312 at 128,
//      207,616 at 256.
// No atomics: every output and scratch element is written once by one
// thread, and every sum runs in a fixed order, so two launches give the
// same bits. Rows and keys past S are zero-filled and masked (any S), kv
// head h / (H / Hk) is read in place (GQA), Dv may differ from D, and
// every tensor is read and written through its batch, head and sequence
// strides with a unit last stride (the wrapper checks).
// Left for later: wgmma with TMA-fed tiles and a producer warp (at HD =
// 256 the kernels sit near 10 % of the 3xTF32 bound, and neither a third
// fewer operand splits, S and dP on separate warps, nor 16 warps a block
// moved them); splitting the tiles that stay in shared memory (K, V; Q,
// dO) once instead of on every use, which needs the smem the double
// buffers take; and bf16 inputs with f32 sums.

#include <cuda_runtime.h>
#include <math.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kMaxD = 256;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 32;  // query rows a tile
constexpr int kBK = 32;  // keys a tile (the same: tiles share one layout)
constexpr int kLdP = 32 + 4;  // row stride of the P and dS tiles
constexpr float kLog2e = 1.4426950408889634f;

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
  const float* lse;  // (B, H, S), contiguous, log2 domain
  float* delta;      // (B, H, S), contiguous
  float* dkp;        // (B, H, S, D) contiguous partials, or null (G = 1)
  float* dvp;        // (B, H, S, Dv) contiguous partials, or null
  int B, H, group, S, D, Dv;
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

// Shared-memory layout, in floats: 32-row tiles of Q, K, V, dO with rows
// of HD + 8 (the two that a block streams, double-buffered: 6 tiles), a
// 32 x 32 tile of P and one of dS with rows of kLdP, and the streamed
// rows' lse and delta (double-buffered).
template <int HD>
struct Tiles {
  static constexpr int kLd = HD + 8;
  static constexpr int kTile = kBQ * kLd;
  static constexpr int kPS = kBQ * kLdP;
  static constexpr int kRows = 2 * kBQ;
  static constexpr size_t kDkdv =
      sizeof(float) * (6 * kTile + 2 * kPS + 2 * kRows);
  static constexpr size_t kDq =
      sizeof(float) * (6 * kTile + kPS + kRows);
};

// 4 bytes global -> shared without a register, zero-filled when !ok: any
// alignment of the source works.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Starts copying rows [r0, r0 + 32) of a (S, n) slice with row stride ss
// into a [32][HD + 8] tile; rows past S and columns past n become zero.
template <int HD>
__device__ __forceinline__ void load_tile(float* tile, const float* base,
                                          long long ss, int r0, int S,
                                          int n) {
#pragma unroll 8
  for (int e = threadIdx.x; e < 32 * HD; e += kThreads) {
    const int r = e / HD, c = e % HD, row = r0 + r;
    const bool ok = row < S && c < n;
    cp_async4(tile + r * (HD + 8) + c, ok ? base + row * ss + c : base, ok);
  }
}

// Starts copying rows [q0, q0 + 32) of lse and delta into rowv.
__device__ __forceinline__ void load_rows(const Params& p, float* rowv,
                                          long long bh, int q0) {
  const int t = threadIdx.x;
  if (t < kBQ) {
    const int i = q0 + t;
    const long long at_i = bh * p.S + min(i, p.S - 1);
    cp_async4(rowv + t, p.lse + at_i, i < p.S);
    cp_async4(rowv + kBQ + t, p.delta + at_i, i < p.S);
  }
}

// One m16n8k8 step of c += A B^T where both are row-major tiles with row
// stride LD over the inner index: a at the lane's A row g, b at its B row
// g, both at column 2t of the step. The inner index runs permuted within
// the step's 8 (fragment index t reads column 2t, t + 4 reads 2t + 1), the
// same for both operands, so each fragment is one float2 read.
template <int LD>
__device__ __forceinline__ void nt_step(float (&c)[4], const float* a,
                                        const float* b) {
  const float2 x = *reinterpret_cast<const float2*>(a);           // row g
  const float2 y = *reinterpret_cast<const float2*>(a + 8 * LD);  // g + 8
  const float2 z = *reinterpret_cast<const float2*>(b);
  uint32_t a_big[4], a_small[4], b_big[2], b_small[2];
  split_tf32(x.x, a_big[0], a_small[0]);
  split_tf32(y.x, a_big[1], a_small[1]);
  split_tf32(x.y, a_big[2], a_small[2]);
  split_tf32(y.y, a_big[3], a_small[3]);
  split_tf32(z.x, b_big[0], b_small[0]);
  split_tf32(z.y, b_big[1], b_small[1]);
  mma_3xtf32(c, a_big, a_small, b_big, b_small);
}

// Two 16x8 tiles over the HD inner columns of [32][HD + 8] tiles: c0 =
// A0 B0^T and c1 = A1 B1^T (S with Q, K and dP with dO, V, or their
// transposes). Each sum runs as two chains of mma, the even and the odd
// steps of 8, added at the end: four independent chains a warp.
template <int HD>
__device__ __forceinline__ void mma_nt2(float (&c0)[4], const float* a0,
                                        const float* b0, float (&c1)[4],
                                        const float* a1, const float* b1) {
  float e0[4] = {0.f, 0.f, 0.f, 0.f}, o0[4] = {0.f, 0.f, 0.f, 0.f};
  float e1[4] = {0.f, 0.f, 0.f, 0.f}, o1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
  for (int kc = 0; kc < HD / 8; kc += 2) {
    nt_step<HD + 8>(e0, a0 + kc * 8, b0 + kc * 8);
    nt_step<HD + 8>(e1, a1 + kc * 8, b1 + kc * 8);
    nt_step<HD + 8>(o0, a0 + kc * 8 + 8, b0 + kc * 8 + 8);
    nt_step<HD + 8>(o1, a1 + kc * 8 + 8, b1 + kc * 8 + 8);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c0[i] = e0[i] + o0[i];
    c1[i] = e1[i] + o1[i];
  }
}

// c[j] += A B for j < NT: A is 16 rows of a [32][kLdP] P or dS tile over
// its 32 columns, a at the lane's (row g, column t); B is a [32][HD + 8]
// tile, b at the lane's (row t, column g) of n-tile 0, n-tile j 8j columns
// on. Natural inner order: A's reads (g, t) and (g, t + 4) fall on 32
// banks with rows of 36, B's (t, g) and (t + 4, g) with rows of HD + 8.
template <int NT, int LD>
__device__ __forceinline__ void mma_nn(float (&c)[NT][4], const float* a,
                                       const float* b) {
#pragma unroll
  for (int kc = 0; kc < kBQ / 8; ++kc) {
    const float* ak = a + kc * 8;
    uint32_t a_big[4], a_small[4];
    split_tf32(ak[0], a_big[0], a_small[0]);
    split_tf32(ak[8 * kLdP], a_big[1], a_small[1]);
    split_tf32(ak[4], a_big[2], a_small[2]);
    split_tf32(ak[8 * kLdP + 4], a_big[3], a_small[3]);
    const float* bk = b + kc * 8 * LD;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t b_big[2], b_small[2];
      split_tf32(bk[j * 8], b_big[0], b_small[0]);
      split_tf32(bk[4 * LD + j * 8], b_big[1], b_small[1]);
      mma_3xtf32(c[j], a_big, a_small, b_big, b_small);
    }
  }
}

// delta = rowsum(dO o O), one warp a row, lanes over the columns in a
// fixed order and a butterfly sum.
__global__ void __launch_bounds__(kThreads) flash_bwd_delta(Params p) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(p.B) * p.H * p.S) return;
  const int bh = static_cast<int>(row / p.S), i = static_cast<int>(row % p.S);
  const int b = bh / p.H, h = bh - b * p.H;
  const float* o = at(p, p.o, kO, b, h) + i * p.st[kO][2];
  const float* g = at(p, p.dout, kDO, b, h) + i * p.st[kDO][2];
  float dl = 0.f;
  for (int d = lane; d < p.Dv; d += 32) dl += g[d] * o[d];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    dl += __shfl_xor_sync(0xffffffffu, dl, off);
  if (lane == 0) p.delta[row] = dl;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkdv(Params p) {
  using T = Tiles<HD>;
  constexpr int kLd = T::kLd;
  constexpr int NT = HD / 32;  // 16x8 C tiles a warp of dK, and of dV
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + T::kTile;
  float* Qs = Vs + T::kTile;    // two buffers
  float* dOs = Qs + 2 * T::kTile;  // two buffers
  float* Pt = dOs + 2 * T::kTile;  // P^T: [key][query]
  float* dSt = Pt + T::kPS;        // dS^T
  float* rowv = dSt + T::kPS;  // the query tile's lse, then its delta; two
  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int hk = h / p.group;
  const int k0 = blockIdx.y * kBK, k1 = min(k0 + kBK, p.S);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  // S^T and dP^T: keys 16 mb.., queries 8 nb..; dK and dV: keys 16 mb..,
  // columns n0 + 8 j
  const int mb = warp / 4, nb = warp % 4, n0 = nb * (HD / 4);
  const float scale2 = p.scale * kLog2e;
  const float* q = at(p, p.q, kQ, b, h);
  const float* dout = at(p, p.dout, kDO, b, h);
  const int r_lo = row_begin(p, k0), r_hi = row_end(p, k1);
  // the K and V tiles and the first query tile; the next query tile
  // copies while this one computes
  load_tile<HD>(Ks, at(p, p.k, kK, b, hk), p.st[kK][2], k0, p.S, p.D);
  load_tile<HD>(Vs, at(p, p.v, kV, b, hk), p.st[kV][2], k0, p.S, p.Dv);
  load_tile<HD>(Qs, q, p.st[kQ][2], r_lo, p.S, p.D);
  load_tile<HD>(dOs, dout, p.st[kDO][2], r_lo, p.S, p.Dv);
  load_rows(p, rowv, bh, r_lo);
  cp_async_commit();
  const float* k_a = Ks + (16 * mb + g) * kLd + 2 * tq;
  const float* v_a = Vs + (16 * mb + g) * kLd + 2 * tq;
  const float* p_a = Pt + (16 * mb + g) * kLdP + tq;
  const float* ds_a = dSt + (16 * mb + g) * kLdP + tq;
  float acc_k[NT][4], acc_v[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc_k[j][i] = acc_v[j][i] = 0.f;
  for (int q0 = r_lo, buf = 0; q0 < r_hi; q0 += kBQ, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this tile is in; every warp is done with the last
    if (q0 + kBQ < r_hi) {
      const int nxt = buf ^ 1;
      load_tile<HD>(Qs + nxt * T::kTile, q, p.st[kQ][2], q0 + kBQ, p.S, p.D);
      load_tile<HD>(dOs + nxt * T::kTile, dout, p.st[kDO][2], q0 + kBQ, p.S,
                    p.Dv);
      load_rows(p, rowv + nxt * T::kRows, bh, q0 + kBQ);
    }
    cp_async_commit();
    const float* Qb = Qs + buf * T::kTile;
    const float* dOb = dOs + buf * T::kTile;
    const float* rows = rowv + buf * T::kRows;
    float s[4], dp[4];
    mma_nt2<HD>(s, k_a, Qb + (8 * nb + g) * kLd + 2 * tq, dp, v_a,
                dOb + (8 * nb + g) * kLd + 2 * tq);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 16 * mb + g + 8 * (i / 2);  // key in the tile
      const int c = 8 * nb + 2 * tq + i % 2;    // query in the tile
      const float pr = allowed(p, q0 + c, k0 + r)
                           ? exp2f(s[i] * scale2 - rows[c])
                           : 0.f;
      Pt[r * kLdP + c] = pr;
      dSt[r * kLdP + c] = pr * (dp[i] - rows[kBQ + c]);
    }
    __syncthreads();
    mma_nn<NT, kLd>(acc_v, p_a, dOb + tq * kLd + n0 + g);
    mma_nn<NT, kLd>(acc_k, ds_a, Qb + tq * kLd + n0 + g);
  }
  // G = 1: dK (scaled) and dV into place; G > 1: this query head's partials
  const bool direct = p.dkp == nullptr;
  const long long bhl = bh;
  float* dk = direct ? p.dk + b * p.st[kDK][0] + hk * p.st[kDK][1]
                     : p.dkp + bhl * p.S * p.D;
  float* dv = direct ? p.dv + b * p.st[kDV][0] + hk * p.st[kDV][1]
                     : p.dvp + bhl * p.S * p.Dv;
  const long long dk_ss = direct ? p.st[kDK][2] : p.D;
  const long long dv_ss = direct ? p.st[kDV][2] : p.Dv;
  const float k_scale = direct ? p.scale : 1.f;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + 16 * mb + g + 8 * (i / 2);
      const int col = n0 + 8 * j + 2 * tq + i % 2;
      if (key >= p.S) continue;
      if (col < p.D) dk[key * dk_ss + col] = acc_k[j][i] * k_scale;
      if (col < p.Dv) dv[key * dv_ss + col] = acc_v[j][i];
    }
}

// dK and dV of kv head hk, key j: the sum of its group's G partials in
// head order; dK times scale.
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_sum(Params p) {
  const int Hk = p.H / p.group;
  const int bhk = blockIdx.x / p.S, j = blockIdx.x - bhk * p.S;
  const int b = bhk / Hk, hk = bhk - b * Hk;
  const long long first = static_cast<long long>(bhk) * p.group * p.S + j;
  const long long head = p.S;  // rows between two heads' partials
  const float* kp = p.dkp + first * p.D;
  const float* vp = p.dvp + first * p.Dv;
  float* dk = p.dk + b * p.st[kDK][0] + hk * p.st[kDK][1] + j * p.st[kDK][2];
  float* dv = p.dv + b * p.st[kDV][0] + hk * p.st[kDV][1] + j * p.st[kDV][2];
  for (int c = threadIdx.x; c < p.D; c += kThreads) {
    float acc = 0.f;
    for (int gi = 0; gi < p.group; ++gi) acc += kp[gi * head * p.D + c];
    dk[c] = acc * p.scale;
  }
  for (int c = threadIdx.x; c < p.Dv; c += kThreads) {
    float acc = 0.f;
    for (int gi = 0; gi < p.group; ++gi) acc += vp[gi * head * p.Dv + c];
    dv[c] = acc;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq(Params p) {
  using T = Tiles<HD>;
  constexpr int kLd = T::kLd;
  constexpr int NT = HD / 32;  // 16x8 C tiles a warp of dQ
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + T::kTile;
  float* Ks = dOs + T::kTile;      // two buffers
  float* Vs = Ks + 2 * T::kTile;   // two buffers
  float* dSs = Vs + 2 * T::kTile;  // dS: [query][key]
  float* rowv = dSs + T::kPS;  // the query tile's lse, then its delta
  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int hk = h / p.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ, q1 = min(q0 + kBQ, p.S);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  // S and dP: queries 16 mb.., keys 8 nb..; dQ: queries 16 mb.., columns
  // n0 + 8 j
  const int mb = warp / 4, nb = warp % 4, n0 = nb * (HD / 4);
  const float scale2 = p.scale * kLog2e;
  const float* k = at(p, p.k, kK, b, hk);
  const float* v = at(p, p.v, kV, b, hk);
  const int c_lo = key_begin(p, q0), c_hi = key_end(p, q1);
  // Q, dO, their rows' lse and delta, and the first key tile; the next
  // key tile copies while this one computes
  load_tile<HD>(Qs, at(p, p.q, kQ, b, h), p.st[kQ][2], q0, p.S, p.D);
  load_tile<HD>(dOs, at(p, p.dout, kDO, b, h), p.st[kDO][2], q0, p.S, p.Dv);
  load_rows(p, rowv, bh, q0);
  load_tile<HD>(Ks, k, p.st[kK][2], c_lo, p.S, p.D);
  load_tile<HD>(Vs, v, p.st[kV][2], c_lo, p.S, p.Dv);
  cp_async_commit();
  const float* q_a = Qs + (16 * mb + g) * kLd + 2 * tq;
  const float* do_a = dOs + (16 * mb + g) * kLd + 2 * tq;
  const float* ds_a = dSs + (16 * mb + g) * kLdP + tq;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  for (int k0 = c_lo, buf = 0; k0 < c_hi; k0 += kBK, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this tile is in; every warp is done with the last
    if (k0 + kBK < c_hi) {
      const int nxt = buf ^ 1;
      load_tile<HD>(Ks + nxt * T::kTile, k, p.st[kK][2], k0 + kBK, p.S, p.D);
      load_tile<HD>(Vs + nxt * T::kTile, v, p.st[kV][2], k0 + kBK, p.S,
                    p.Dv);
    }
    cp_async_commit();
    const float* Kb = Ks + buf * T::kTile;
    const float* Vb = Vs + buf * T::kTile;
    float s[4], dp[4];
    mma_nt2<HD>(s, q_a, Kb + (8 * nb + g) * kLd + 2 * tq, dp, do_a,
                Vb + (8 * nb + g) * kLd + 2 * tq);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 16 * mb + g + 8 * (i / 2);  // query in the tile
      const int c = 8 * nb + 2 * tq + i % 2;    // key in the tile
      const float pr = allowed(p, q0 + r, k0 + c)
                           ? exp2f(s[i] * scale2 - rowv[r])
                           : 0.f;
      dSs[r * kLdP + c] = pr * (dp[i] - rowv[kBQ + r]);
    }
    __syncthreads();
    mma_nn<NT, kLd>(acc, ds_a, Kb + tq * kLd + n0 + g);
  }
  float* dq = p.dq + b * p.st[kDQ][0] + h * p.st[kDQ][1];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 16 * mb + g + 8 * (i / 2);
      const int col = n0 + 8 * j + 2 * tq + i % 2;
      if (row < p.S && col < p.D)
        dq[row * p.st[kDQ][2] + col] = acc[j][i] * p.scale;
    }
}

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
int launch(const Params& p, cudaStream_t stream) {
  const int q_tiles = (p.S + kBQ - 1) / kBQ, k_tiles = (p.S + kBK - 1) / kBK;
  const long long rows = static_cast<long long>(p.B) * p.H * p.S;
  int err = launch_one(flash_bwd_delta, 0,
                       dim3(static_cast<unsigned>((rows + kWarps - 1) /
                                                  kWarps)),
                       p, stream);
  if (err) return err;
  err = launch_one(flash_bwd_dkdv<HD>, Tiles<HD>::kDkdv,
                   dim3(p.B * p.H, k_tiles), p, stream);
  if (err) return err;
  if (p.dkp != nullptr) {
    err = launch_one(flash_bwd_dkdv_sum, 0,
                     dim3(p.B * (p.H / p.group) * p.S), p, stream);
    if (err) return err;
  }
  return launch_one(flash_bwd_dq<HD>, Tiles<HD>::kDq,
                    dim3(p.B * p.H, q_tiles), p, stream);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B,H,S,D), k (B,Hk,S,D), v (B,Hk,S,Dv), o and dout (B,H,S,Dv) in; dq,
// dk, dv (shaped as q, k, v) out; lse (B,H,S) contiguous float32 in, the
// forward's log2-domain log-sum-exp; delta (B,H,S) contiguous float32
// scratch; dkp (B,H,S,D) and dvp (B,H,S,Dv) contiguous float32 scratch
// where H > Hk, else ignored (may be null). strides: 24 batch/head/sequence
// strides in elements, three each for q, k, v, o, dout, dq, dk, dv; every
// last stride is 1. window <= 0: no window. Returns a cudaError_t.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, void* dq, void* dk,
                        void* dv, const void* lse, void* delta, void* dkp,
                        void* dvp, int B, int H, int Hk, int S, int D,
                        int Dv, const long long* strides, float scale,
                        int causal, int window, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (Hk <= 0 || H % Hk || D <= 0 || D > kMaxD || Dv <= 0 || Dv > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  if (H > Hk && (dkp == nullptr || dvp == nullptr))
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
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dkp = H > Hk ? static_cast<float*>(dkp) : nullptr;
  p.dvp = H > Hk ? static_cast<float*>(dvp) : nullptr;
  p.B = B;
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
  if (hd <= 64) return launch<64>(p, st);
  if (hd <= 128) return launch<128>(p, st);
  return launch<256>(p, st);
}

}  // extern "C"
