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
// 3.35 TB/s). This file runs those five products and no others: dS goes
// to device memory once, where the dQ pass reads it, instead of S and dP
// being computed a second time for dQ.
//
// Design: every product is wgmma.mma_async m64nNk8 tf32 in 3xTF32 (small *
// big + big * small, then + big * big; hopper.cuh). tf32 wgmma reads A and
// B K-major only, and three of the five products contract over the rows
// that TMA brings (queries or keys), so every A operand comes from
// registers, loaded from the landed tile in whatever order the product
// needs and split there (big = x with its 13 low mantissa bits cleared,
// small = x - big rounded to TF32), and every B operand is a K-major tile
// in shared memory that is an exact TF32 value: K and V split once by a
// pre-pass, P^T and dS^T split when they are written. Five kernels on one
// stream:
//   1. flash_bwd_delta, one warp a row: delta = rowsum(dO o O). Bytes.
//   2. flash_bwd_prep_kv: K and V split once into big and small halves,
//      (B, Hk, 2, S, D8) and (B, Hk, 2, S, Dv8) with D8, Dv8 the widths
//      rounded up to 8, and K's halves transposed, (B, Hk, 2, D, ld) with
//      ld = S rounded up to 8 (a 32 x 32 tile through shared memory); the
//      halves' k index (columns; K^T's keys) permuted within each 8 as the
//      A fragments read theirs (kpos), so that a lane loads its two k
//      values of a fragment as one float2. Bytes: 7 x those of K and V.
//   3. flash_bwd_dkdv: blocks of 384 threads over work items (b, query
//      head, key tile of BK keys), the longest walks of the causal band
//      first: up to HD = 128 persistent, a block an SM taking items in
//      turn; at HD = 160 and 256 a block an item, which the card deals to
//      SMs as they free up (its items are unequal, and a static deal
//      measured slower). The first thread of the producer warpgroup loads
//      an item's K and V halves by TMA (kv_full; kv_empty once the item's
//      last S and dP have read them), then streams the 64-row query tiles
//      of the band (aligned to 64) through a ring of ST stages that runs on
//      across items: Q and dO as they lie in q and dout (4-D tensor maps
//      over the views' strides), each 32-column atom on full and empty
//      mbarriers of its own, so that an atom reloads as soon as its last
//      reader is done and S starts on the first atom while the rest lands.
//      Two consumer warpgroups share each query tile:
//        warpgroup 0: S = Q K^T (A: Q's rows, B: K's halves), P = 2^(S
//          scale log2 e - lse), masked, written to shared memory as P^T's
//          big and small halves (keys x queries); then dK^T += Q^T dS (A:
//          Q's columns, read down the tile; B: dS^T's halves), D rows;
//        warpgroup 1: dP = dO V^T, then, once P is written, dS = (P big +
//          P small) o (dP - delta) into dS^T's halves and, as f32, into the
//          dS scratch (B, H, S, ld) in device memory; then dV^T += dO^T P,
//          Dv rows.
//      Four named barriers order the two (P written, dS written, P read,
//      dS read); warpgroup 0 frees Q's atoms and warpgroup 1 dO's once
//      their fragments are in registers. setmaxnreg gives the producer 24
//      registers and the consumers 240. dK^T and dV^T stay in registers
//      (D and Dv over 64, rounded up, m64nBK accumulators: m_tiles) and
//      are written at the end of each item: G = 1 into dk and dv (dK
//      times scale), G > 1 as per-query-head partials (B, H, S, D) and
//      (B, H, S, Dv).
//   4. flash_bwd_dkdv_sum (G > 1 only), one block per (b, kv head, key):
//      the group's G partials in head order, dK times scale. Bytes.
//   5. flash_bwd_dq: dQ = dS K scale, a product over the band's keys, one
//      block of 384 threads per (b, query head, 128-row query tile), the
//      tiles with most keys first. The producer streams 32-key chunks of
//      dS (128 x 32) and of K^T's halves (D x 32) by TMA through a ring of
//      ST stages; each consumer warpgroup takes 64 rows, loads dS as its A
//      fragments (zero outside the band, so dS entries that step 3 did not
//      write are never read) and runs dQ in 64-wide n-tiles (the last 32
//      wide where D rounded up to 32 is not a multiple of 64), one
//      m64n64 accumulator a thread for each; the fragments of the next chunk load
//      while the last chunk's products run, in two register sets named at
//      compile time (the loop is unrolled by two).
// Tiles, widths and budgets (f32 tiles in 32-column atoms as TMA writes
// them with 128-byte swizzle; shared memory of step 3 = K and V halves 4
// BK HD 4 bytes + ST stages of Q and dO 2 x 64 HD 4 + P^T and dS^T halves
// 4 x BK 64 4):
//   HD = max(D, Dv) <= 64:  BK = 64, ST = 2: 192 KiB; dQ ring of 4 stages
//     of 32 KiB;
//   HD <= 128: BK = 32, ST = 2: 224 KiB; dQ 4 stages of 48 KiB;
//   D = Dv = 160 (stablelm-12b): HD = 160, five atoms, BK = 32, ST = 1:
//     192 KiB (80 of K and V halves, 80 of Q and dO, 32 of P^T and dS^T),
//     so that S and dP run m64n32k8 as at 128; dK^T and dV^T in three m64
//     tiles, the last with 32 real rows; dQ 4 stages of 56 KiB, its
//     n-tiles 64, 64 and 32 wide (192-wide tiles, 16-key tiles with two
//     stages, persistent blocks and 3 dQ stages measured slower);
//   other HD <= 256: BK = 16, ST = 1: 208 KiB (one Q and dO stage: 128 KiB
//     of the 227); dQ 2 stages of 80 KiB.
// Registers of a consumer thread: BK / 2 for S or dP, ((D + 63) / 64) BK /
// 2 for dK^T (HD = 256: 32), 64 for two sets of A fragments; dQ: 128 at D
// = 256. ptxas reports every instantiation at the 168 registers it
// launches with and no spills; none of the compile-time widths' products
// is serialized or has a warpgroup.arrive injected (pin).
// The products run at these widths: S D deep and dP Dv deep rounded up to
// the k-step of 8, dK^T and dV^T D and Dv rows rounded up to 64, dQ D
// wide rounded up to 32 (flash_attention.bwd_product_widths).
// No atomics: every output and scratch element is written once by one
// thread, and every sum runs in a fixed order, so two launches give the
// same bits. Rows and keys past S read as zero (TMA) and are masked (any
// S), kv head h / (H / Hk) is read in place (GQA), Dv may differ from D
// (multiples of 4), and q and dout are read through their strides by TMA:
// 16-byte aligned pointers and batch, head and sequence strides (the
// wrapper checks, and ops copies a dout that breaks the rule).
// What bounds it (tools/flash_bwd_stages.py: variant builds of this file
// timed on the H100 at gemma3-1b's and stablelm-12b's shapes): not the
// streaming of Q and dO from L2 (taking it out saves 1-4 % of step 3);
// taking out the products and the A fragments that feed them saves 42 %
// at HD = 256 and 28 % at D = 160. At HD = 256 the key tile is 16 keys,
// so every product of step 3 is m64n16k8; the rest of the time is the
// warpgroups' handoffs, the P and dS passes (dS written to device memory:
// 512 MiB a call at stablelm-12b's shape) and tile waits.
// Left for later: a wider key tile at HD = 256 (the shared memory holds
// one Q and dO stage beside 16 keys of K and V halves); overlapping the
// two warpgroups' softmax and dS passes with the other's products (they
// wait on each other once a step); dQ fused into step 3 in a fixed key
// order, which would drop the dS round trip through device memory (at
// most 1 GiB a launch: the wrapper runs a larger problem in slabs of
// batches or kv-head groups); the pre-pass's 7 x the bytes of K and V
// (0.19 ms of MLA's 2 ms).

#include <cuda_runtime.h>
#include <math.h>

#include <cstdio>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kMaxD = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 384;  // the producer warpgroup, then two consumers
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 24 * 128 + 240 * 256 <= 65,536

// what the last failed call failed at, for the wrapper's message
char g_failure[256] = "";

// Returns err after noting `what` where it is an error.
int noted(int err, const char* what) {
  if (err) snprintf(g_failure, sizeof g_failure, "%s", what);
  return err;
}

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
  float* kv;         // (B, Hk, 2, S, D8): K's big and small halves
  float* vv;         // (B, Hk, 2, S, Dv8)
  float* kt;         // (B, Hk, 2, D, ld): K^T's halves
  float* ds;         // (B, H, S, ld): dS
  float* dkp;        // (B, H, S, D) contiguous partials, or null (G = 1)
  float* dvp;        // (B, H, S, Dv) contiguous partials, or null
  int B, H, group, S, D, Dv, ld;
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

__device__ __forceinline__ float lds(const unsigned char* sm, uint32_t off) {
  return *reinterpret_cast<const float*>(sm + off);
}
__device__ __forceinline__ void sts(unsigned char* sm, uint32_t off,
                                    uint32_t x) {
  *reinterpret_cast<uint32_t*>(sm + off) = x;
}

// The halves of an A fragment's split, pinned where they are made: a split
// that the compiler sinks under the wgmma_fence that follows it makes
// ptxas inject a warpgroup.arrive before the product that reads it (C7519)
__device__ __forceinline__ void pin(uint32_t (&big)[4],
                                    uint32_t (&small)[4]) {
  fence_regs(big);
  fence_regs(small);
}

// delta = rowsum(dO o O), one warp a row, lanes over the columns in a
// fixed order and a butterfly sum.
__global__ void __launch_bounds__(256) flash_bwd_delta(Params p) {
  const long long row =
      static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
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

// K and V of keys [k0, k0 + 32) of one (b, kv head) split into big and
// small halves (blockIdx.z 0: K, 1: V; hopper.cuh's split_keys), their
// columns padded with zeros to a multiple of 8 and permuted within each 8
// (kpos); K's halves also transposed, its keys permuted within each 8 and
// zero from S to ld. 256 threads.
__global__ void __launch_bounds__(256) flash_bwd_prep_kv(Params p) {
  __shared__ float tile[32][33];
  const int Hk = p.H / p.group;
  const int k0 = blockIdx.x * 32, bhk = blockIdx.y;
  const int b = bhk / Hk, hk = bhk - b * Hk;
  if (blockIdx.z == 0)
    split_keys(at(p, p.k, kK, b, hk), p.st[kK][2], p.S, p.D, k0,
               p.kv + 2ll * bhk * p.S * ((p.D + 7) & ~7),
               p.kt + 2ll * bhk * p.D * p.ld, p.ld, tile);
  else
    split_keys(at(p, p.v, kV, b, hk), p.st[kV][2], p.S, p.Dv, k0,
               p.vv + 2ll * bhk * p.S * ((p.Dv + 7) & ~7), nullptr, p.ld,
               tile);
}

// dK and dV of kv head hk, key j: the sum of its group's G partials in
// head order; dK times scale.
__global__ void __launch_bounds__(256) flash_bwd_dkdv_sum(Params p) {
  const int Hk = p.H / p.group;
  const int bhk = blockIdx.x / p.S, j = blockIdx.x - bhk * p.S;
  const int b = bhk / Hk, hk = bhk - b * Hk;
  const long long first = static_cast<long long>(bhk) * p.group * p.S + j;
  const long long head = p.S;  // rows between two heads' partials
  const float* kp = p.dkp + first * p.D;
  const float* vp = p.dvp + first * p.Dv;
  float* dk = p.dk + b * p.st[kDK][0] + hk * p.st[kDK][1] + j * p.st[kDK][2];
  float* dv = p.dv + b * p.st[kDV][0] + hk * p.st[kDV][1] + j * p.st[kDV][2];
  for (int c = threadIdx.x; c < p.D; c += 256) {
    float acc = 0.f;
    for (int gi = 0; gi < p.group; ++gi) acc += kp[gi * head * p.D + c];
    dk[c] = acc * p.scale;
  }
  for (int c = threadIdx.x; c < p.Dv; c += 256) {
    float acc = 0.f;
    for (int gi = 0; gi < p.group; ++gi) acc += vp[gi * head * p.Dv + c];
    dv[c] = acc;
  }
}

// ---------------------------------------------------------------------------
// dK and dV: flash_bwd_dkdv
// ---------------------------------------------------------------------------

namespace dkdv {

constexpr int kBQ = 64;  // query rows a step
// m64 tiles of dK^T or dV^T rows in a head tile hd wide (hd = 160: three,
// the last with 32 real rows)
__host__ __device__ constexpr int m_tiles(int hd) { return (hd + 63) / 64; }
// Up to HD = 128 a block an SM takes items in turn (persistent); wider, a
// block an item, which the card deals to SMs as they free up (see launch)
__host__ __device__ constexpr bool persistent(int hd) { return hd <= 128; }
// named barriers between the consumers (256 threads)
enum { kPWritten = 1, kDsWritten, kPRead, kDsRead };

// Byte offsets from the 1024-aligned base: K's and V's big and small
// tiles (BK rows), ST stages of Q and of dO (64 rows), P^T's and dS^T's
// big and small tiles (BK rows x 64 queries), then the barriers: kv_full,
// kv_empty, and q_full, q_empty, do_full, do_empty for each 32-column atom
// of each stage, so that an atom reloads as soon as its last reader is
// done.
template <int HD, int BK, int ST>
struct Smem {
  static constexpr int kAtoms = HD / 32;
  static constexpr int kKVTile = kAtoms * BK * 128;
  static constexpr int kXTile = kAtoms * kBQ * 128;
  static constexpr int kGTile = 2 * BK * 128;
  static constexpr int kKb = 0;
  static constexpr int kKs = kKb + kKVTile;
  static constexpr int kVb = kKs + kKVTile;
  static constexpr int kVs = kVb + kKVTile;
  static constexpr int kQ = kVs + kKVTile;
  static constexpr int kDO = kQ + ST * kXTile;
  static constexpr int kPb = kDO + ST * kXTile;
  static constexpr int kPs = kPb + kGTile;
  static constexpr int kSb = kPs + kGTile;
  static constexpr int kSs = kSb + kGTile;
  static constexpr int kBar = kSs + kGTile;
  static constexpr size_t kBytes = 1024 + kBar + 8 * (2 + 4 * ST * kAtoms);
  // the barriers q_full, q_empty, do_full, do_empty (which 0..3) of stage
  // s, atom a
  static __device__ __forceinline__ uint32_t bar(int which, int s, int a) {
    return kBar + 8 * (2 + (which * ST + s) * kAtoms + a);
  }
};

// c = X Y^T for one warpgroup: X its 64-row tile at x (queries x HD), Y's
// big and small tiles at yb, ys (BK rows, columns placed by kpos), KS
// k-steps of 8 columns (0: ks at run time). The A fragments of 4 k-steps
// load and split while the products of the 4 before run (two register
// sets). The 4 k-steps of a chunk are one atom of X, waited for on its
// full barrier (full + 8 atom, phase parity).
template <int HD, int BK, int KS>
__device__ __forceinline__ void product_nt(float (&c)[BK / 2],
                                           const unsigned char* sm,
                                           uint32_t base, uint32_t x,
                                           uint32_t yb, uint32_t ys, int ks,
                                           uint32_t full, int parity,
                                           int warp, int lane) {
  constexpr int kMax = KS > 0 ? KS : HD / 8;
  const int n = KS > 0 ? KS : ks;
  const int r0 = 16 * warp + lane / 4, t = lane % 4;
  uint32_t fb[2][4][4], fs[2][4][4];
#pragma unroll
  for (int ch = 0; ch < (kMax + 3) / 4; ++ch) {
    uint32_t(&ab)[4][4] = fb[ch & 1];
    uint32_t(&as)[4][4] = fs[ch & 1];
    if (ch >= 2) wgmma_wait<1>();
    if (4 * ch < n) mbar_wait(full + 8 * ch, parity);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = 4 * ch + j, c0 = 8 * kk + 2 * t;  // k indices t, t + 4
      if (kk < kMax && kk < n) {
        const float2 lo = lds2(sm, x + tile_at<kBQ>(r0, c0));
        const float2 hi = lds2(sm, x + tile_at<kBQ>(r0 + 8, c0));
        const float xv[4] = {lo.x, hi.x, lo.y, hi.y};
        split4(xv, ab[j], as[j]);
        pin(ab[j], as[j]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = 4 * ch + j;
      if (kk < kMax && kk < n) {
        const uint32_t off = (kk / 4) * (BK * 128) + (kk % 4) * 32;
        wgmma_3xtf32(c, ab[j], as[j], desc_sw128(base + yb + off),
                     desc_sw128(base + ys + off), kk > 0);
      }
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(c);
}

// c[m] += X^T G^T for the m-tiles m < mt (MT: their count, 0 = mt at run
// time, up to m_tiles(HD)): X^T's rows are X's columns 64 m.. (zero past the
// loaded columns), its k the tile's 64 queries, read down X; row g of a
// warp's 16 is column 2 g of its 16, row g + 8 column 2 g + 1, so that a
// lane's two rows are one 8-byte load (the epilogue maps them back); G the
// big and
// small tiles at gb, gs (BK rows x 64 queries). A chunk is one m-tile's
// 4 k-steps; the next loads while it runs. Once the fragments of an
// m-tile are in registers, its two atoms of X are free (arrivals on empty
// + 8 atom).
template <int HD, int BK, int MT>
__device__ __forceinline__ void product_tn(float (&c)[m_tiles(HD)][BK / 2],
                                           const unsigned char* sm,
                                           uint32_t base, uint32_t x,
                                           uint32_t gb, uint32_t gs, int mt,
                                           int loaded, uint32_t empty,
                                           int warp, int lane) {
  constexpr int kMax = MT > 0 ? MT : m_tiles(HD);
  const int n = MT > 0 ? MT : mt;
  const int d0 = 16 * warp + 2 * (lane / 4), t = lane % 4;
  uint32_t fb[2][4][4], fs[2][4][4];
#pragma unroll
  for (int ch = 0; ch < 2 * kMax; ++ch) {
    const int m = ch / 2, hh = ch % 2;
    uint32_t(&ab)[4][4] = fb[ch & 1];
    uint32_t(&as)[4][4] = fs[ch & 1];
    if (ch >= 2 && m < n) wgmma_wait<1>();
    if (m < n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q0 = 8 * (4 * hh + j) + t, d = 64 * m + d0;
        const bool ok = d < loaded;  // d and d + 1
        const float2 lo = ok ? lds2(sm, x + tile_at<kBQ>(q0, d))
                             : make_float2(0.f, 0.f);
        const float2 hi = ok ? lds2(sm, x + tile_at<kBQ>(q0 + 4, d))
                             : make_float2(0.f, 0.f);
        const float xv[4] = {lo.x, lo.y, hi.x, hi.y};
        split4(xv, ab[j], as[j]);
        pin(ab[j], as[j]);
      }
      if (hh == 1 && lane == 0)
        for (int a = 2 * m; a < 2 * m + 2 && 32 * a < loaded; ++a)
          mbar_arrive(empty + 8 * a);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t off = hh * (BK * 128) + j * 32;
        wgmma_3xtf32(c[m], ab[j], as[j], desc_sw128(base + gb + off),
                     desc_sw128(base + gs + off), 1);
      }
      wgmma_commit();
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < m_tiles(HD); ++m) fence_regs(c[m]);
}

// One work item: the key tile at k0 of batch b, query head h (kv head
// hk), and the n_tiles 64-row query tiles from q_first that its band
// reaches. Items run key tile by key tile, so that blocks take the
// longest walks of the causal band first.
struct Item {
  int b, h, hk, k0, q_first, n_tiles;
};

template <int BK>
__device__ __forceinline__ Item item_of(const Params& p, int u) {
  const int bhs = p.B * p.H, kt = u / bhs, bh = u - kt * bhs;
  Item x;
  x.b = bh / p.H;
  x.h = bh - x.b * p.H;
  x.hk = x.h / p.group;
  x.k0 = kt * BK;
  x.q_first = row_begin(p, x.k0) / kBQ * kBQ;
  x.n_tiles =
      (row_end(p, min(x.k0 + BK, p.S)) - x.q_first + kBQ - 1) / kBQ;
  return x;
}

// One consumer warpgroup over one item's query tiles; it0 counts the
// tiles that went through the ring before them, last says the item is the
// block's last. ROLE 0: X = Q, Y = K, S -> P, then dK^T += Q^T dS; ROLE 1:
// X = dO, Y = V, dP -> dS, then dV^T += dO^T P. KS: k-steps of X's width
// (D or Dv), 0 = at run time. K and V are freed (kv_empty, where not 0)
// once the last tile's S and dP have read them.
template <int HD, int BK, int ST, int ROLE, int KS>
__device__ __forceinline__ void consume(const Params& p, unsigned char* sm,
                                        uint32_t base, const Item& item,
                                        int it0, bool last,
                                        uint32_t kv_empty) {
  const int b = item.b, h = item.h, q_first = item.q_first;
  const int n_tiles = item.n_tiles, k0 = item.k0;
  using L = Smem<HD, BK, ST>;
  constexpr int MT = KS > 0 ? (KS + 7) / 8 : 0;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int width = ROLE == 0 ? p.D : p.Dv;
  const int ks = (width + 7) / 8, mt = (width + 63) / 64;
  const int loaded = (width + 31) / 32 * 32;  // columns TMA brings
  // this warpgroup's full and empty barriers of stage s, atom 0
  auto full = [&](int s) { return base + L::bar(ROLE == 0 ? 0 : 2, s, 0); };
  auto empty = [&](int s) { return base + L::bar(ROLE == 0 ? 1 : 3, s, 0); };
  const uint32_t x0 = ROLE == 0 ? L::kQ : L::kDO;
  const uint32_t yb = ROLE == 0 ? L::kKb : L::kVb;
  const uint32_t ys = ROLE == 0 ? L::kKs : L::kVs;
  // this warpgroup writes one of P^T, dS^T and reads the other as its B
  const uint32_t wb = ROLE == 0 ? L::kPb : L::kSb;
  const uint32_t ws = ROLE == 0 ? L::kPs : L::kSs;
  const uint32_t gb = ROLE == 0 ? L::kSb : L::kPb;
  const uint32_t gs = ROLE == 0 ? L::kSs : L::kPs;
  const long long bh = static_cast<long long>(b) * p.H + h;
  const float* rowv = (ROLE == 0 ? p.lse : p.delta) + bh * p.S;
  const float scale2 = p.scale * kLog2e;

  float acc[m_tiles(HD)][BK / 2];
#pragma unroll
  for (int m = 0; m < m_tiles(HD); ++m)
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) acc[m][e] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int it = it0 + i, s = it % ST, q0 = q_first + i * kBQ;
    const uint32_t x = x0 + s * L::kXTile;
    float rv[2];  // lse (ROLE 0) or delta (ROLE 1) of rows g, g + 8
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + 16 * warp + g + 8 * r;
      rv[r] = row < p.S ? rowv[row] : 0.f;
    }
    float sc[BK / 2];
    product_nt<HD, BK, KS>(sc, sm, base, x, yb, ys, ks, full(s),
                           (it / ST) & 1, warp, lane);
    if (kv_empty != 0 && i + 1 == n_tiles && lane == 0)
      mbar_arrive(kv_empty);
    // the other warpgroup is done with the tile this one writes (from the
    // block's second tile on, across items too)
    if (ROLE == 0) {
      if (it > 0) named_sync(kPRead, 256);
    } else {
      named_sync(kPWritten, 256);
      if (it > 0) named_sync(kDsRead, 256);
    }
    // P (ROLE 0) or dS (ROLE 1) of each score, into the written tiles
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int key = 8 * (e / 4) + 2 * t + e % 2;  // in the tile
      const int ql = 16 * warp + g + 8 * ((e / 2) % 2);
      const uint32_t off = tile_at<BK>(key, ql);
      float val;
      if (ROLE == 0) {
        val = allowed(p, q0 + ql, k0 + key)
                  ? exp2f(sc[e] * scale2 - rv[(e / 2) % 2])
                  : 0.f;
      } else {
        const float pr = lds(sm, L::kPb + off) + lds(sm, L::kPs + off);
        val = pr * (sc[e] - rv[(e / 2) % 2]);
        const int row = q0 + ql, col = k0 + key;
        if (row < p.S && col < p.S)
          p.ds[(bh * p.S + row) * p.ld + col] = val;
      }
      sts(sm, wb + off, tf32_big(val));
      sts(sm, ws + off, tf32_small(val));
    }
    fence_async_shared();
    if (ROLE == 0) {
      named_arrive(kPWritten, 256);
      named_sync(kDsWritten, 256);
    } else {
      named_arrive(kDsWritten, 256);
    }
    product_tn<HD, BK, MT>(acc, sm, base, x, gb, gs, mt, loaded, empty(s),
                           warp, lane);
    if (i + 1 < n_tiles || !last)
      named_arrive(ROLE == 0 ? kDsRead : kPRead, 256);
  }

  // dK^T (times scale) or dV^T: G = 1 into place, G > 1 this query head's
  // partials
  const bool direct = p.dkp == nullptr;
  const int hk = h / p.group;
  float* out;
  long long ss;
  if (ROLE == 0) {
    out = direct ? p.dk + b * p.st[kDK][0] + hk * p.st[kDK][1]
                 : p.dkp + bh * p.S * p.D;
    ss = direct ? p.st[kDK][2] : p.D;
  } else {
    out = direct ? p.dv + b * p.st[kDV][0] + hk * p.st[kDV][1]
                 : p.dvp + bh * p.S * p.Dv;
    ss = direct ? p.st[kDV][2] : p.Dv;
  }
  const float mult = ROLE == 0 && direct ? p.scale : 1.f;
#pragma unroll
  for (int m = 0; m < m_tiles(HD); ++m)
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int d = 64 * m + 16 * warp + 2 * g + (e / 2) % 2;
      const int key = k0 + 8 * (e / 4) + 2 * t + e % 2;
      if (m < mt && d < width && key < p.S)
        out[key * ss + d] = acc[m][e] * mult;
    }
}

// KD, KV: k-steps of D and Dv (0: at run time). A persistent block
// (persistent(HD)) takes items blockIdx.x, + gridDim.x, ...; the ring of Q
// and dO tiles and the barriers' phases run on across items. Otherwise a
// block takes item blockIdx.x alone (see launch).
template <int HD, int BK, int ST, int KD, int KV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, Params p) {
  using L = Smem<HD, BK, ST>;
  constexpr bool kPersistent = persistent(HD);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);
  const uint32_t kv_full = base + L::kBar, kv_empty = kv_full + 8;
  auto bar = [&](int which, int s, int a) {
    return base + L::bar(which, s, a);
  };
  const int items = kPersistent ? p.B * p.H * ((p.S + BK - 1) / BK)
                                : static_cast<int>(blockIdx.x) + 1;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 8);  // lane 0 of each consumer warp
    for (int s = 0; s < ST; ++s)
      for (int a = 0; a < L::kAtoms; ++a) {
        mbar_init(bar(0, s, a), 1);
        mbar_init(bar(1, s, a), 4);  // lane 0 of each warp of warpgroup 0
        mbar_init(bar(2, s, a), 1);
        mbar_init(bar(3, s, a), 4);  // ... of warpgroup 1
      }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_map(&tq);
      prefetch_map(&tdo);
      prefetch_map(&tk);
      prefetch_map(&tv);
      const int k_atoms = (p.D + 31) / 32, v_atoms = (p.Dv + 31) / 32;
      int it = 0, round = 0;  // tiles through the ring, items
      for (int u = blockIdx.x; u < items; u += gridDim.x, ++round) {
        const Item x = item_of<BK>(p, u);
        mbar_wait(kv_empty, (round & 1) ^ 1);
        mbar_expect_tx(kv_full, 2 * (k_atoms + v_atoms) * BK * 128);
        for (int a = 0; a < k_atoms; ++a) {
          tma_load(base + L::kKb + a * BK * 128, &tk, kv_full, 32 * a, x.k0,
                   2 * x.hk, x.b);
          tma_load(base + L::kKs + a * BK * 128, &tk, kv_full, 32 * a, x.k0,
                   2 * x.hk + 1, x.b);
        }
        for (int a = 0; a < v_atoms; ++a) {
          tma_load(base + L::kVb + a * BK * 128, &tv, kv_full, 32 * a, x.k0,
                   2 * x.hk, x.b);
          tma_load(base + L::kVs + a * BK * 128, &tv, kv_full, 32 * a, x.k0,
                   2 * x.hk + 1, x.b);
        }
        for (int i = 0; i < x.n_tiles; ++i, ++it) {
          const int s = it % ST, parity = ((it / ST) & 1) ^ 1;
          const int q0 = x.q_first + i * kBQ;
          for (int a = 0; a < k_atoms || a < v_atoms; ++a) {
            if (a < k_atoms) {
              mbar_wait(bar(1, s, a), parity);
              mbar_expect_tx(bar(0, s, a), kBQ * 128);
              tma_load(base + L::kQ + s * L::kXTile + a * kBQ * 128, &tq,
                       bar(0, s, a), 32 * a, q0, x.h, x.b);
            }
            if (a < v_atoms) {
              mbar_wait(bar(3, s, a), parity);
              mbar_expect_tx(bar(2, s, a), kBQ * 128);
              tma_load(base + L::kDO + s * L::kXTile + a * kBQ * 128, &tdo,
                       bar(2, s, a), 32 * a, q0, x.h, x.b);
            }
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    if constexpr (kPersistent) {
      int it = 0, round = 0;
      for (int u = blockIdx.x; u < items; u += gridDim.x, ++round) {
        const Item x = item_of<BK>(p, u);
        const bool last = u + static_cast<int>(gridDim.x) >= items;
        mbar_wait(kv_full, round & 1);
        if (threadIdx.x < 256)
          consume<HD, BK, ST, 0, KD>(p, sm, base, x, it, last, kv_empty);
        else
          consume<HD, BK, ST, 1, KV>(p, sm, base, x, it, last, kv_empty);
        it += x.n_tiles;
      }
    } else {
      const Item x = item_of<BK>(p, blockIdx.x);
      mbar_wait(kv_full, 0);
      if (threadIdx.x < 256)
        consume<HD, BK, ST, 0, KD>(p, sm, base, x, 0, true, 0);
      else
        consume<HD, BK, ST, 1, KV>(p, sm, base, x, 0, true, 0);
    }
  }
}

}  // namespace dkdv

// ---------------------------------------------------------------------------
// dQ: flash_bwd_dq
// ---------------------------------------------------------------------------

namespace dq {

constexpr int kBQ = 128;  // query rows a block, 64 a consumer warpgroup

// Stage s at s * kStage: dS (128 rows x 32 keys), then K^T's big and small
// tiles (HD rows x 32 keys); then the full and empty barriers.
template <int HD, int ST>
struct Smem {
  static constexpr int kDs = kBQ * 128;
  static constexpr int kKt = HD * 128;
  static constexpr int kStage = kDs + 2 * kKt;
  static constexpr int kBar = ST * kStage;
  static constexpr size_t kBytes = 1024 + kBar + 8 * 2 * ST;
};

// W: D rounded up to 32 (0: at run time). dQ runs in n-tiles of 64
// columns, the last 32 wide where W is not a multiple of 64.
template <int HD, int ST, int W>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq(const __grid_constant__ CUtensorMap tds,
                 const __grid_constant__ CUtensorMap tkt, Params p) {
  using L = Smem<HD, ST>;
  constexpr int kNT = W > 0 ? (W + 63) / 64 : HD / 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);
  auto full = [&](int s) { return base + L::kBar + 8 * s; };
  auto empty = [&](int s) { return base + L::kBar + 8 * (ST + s); };
  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int hk = h / p.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ, q1 = min(q0 + kBQ, p.S);
  const int c_lo = key_begin(p, q0) / 32;
  const int n = (key_end(p, q1) + 31) / 32 - c_lo;
  const int w = W > 0 ? W : (p.D + 31) / 32 * 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_map(&tds);
      prefetch_map(&tkt);
      for (int i = 0; i < n; ++i) {
        const int s = i % ST, key0 = 32 * (c_lo + i);
        const uint32_t stage = base + s * L::kStage;
        mbar_wait(empty(s), ((i / ST) & 1) ^ 1);
        mbar_expect_tx(full(s), L::kDs + 2 * w * 128);
        tma_load(stage, &tds, full(s), key0, q0, h, b);
        tma_load(stage + L::kDs, &tkt, full(s), key0, 0, 2 * hk, b);
        tma_load(stage + L::kDs + L::kKt, &tkt, full(s), key0, 0,
                 2 * hk + 1, b);
      }
    }
    return;
  }
  setmaxnreg_inc<kConsumerRegs>();
  const int c = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rl = 64 * c + 16 * warp + g;  // this lane's rows rl, rl + 8
  const int nt = (w + 63) / 64;
  const bool half_last = w % 64 != 0;
  // zero sums, held in place before the products start (an accumulator
  // written between products serializes them)
  float acc[kNT][32];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[j][e] = 0.f;
    fence_regs(acc[j]);
  }
  // one 32-key chunk: its A fragments into (ab, as), then its products;
  // the fragments alternate between two register sets named at compile
  // time (a set picked at run time would be copied into registers that the
  // last chunk's products may still read)
  auto chunk = [&](int i, uint32_t (&ab)[4][4], uint32_t (&as)[4][4]) {
    const int s = i % ST, key0 = 32 * (c_lo + i);
    const uint32_t stage = s * L::kStage;
    mbar_wait(full(s), (i / ST) & 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kl = 8 * j + 2 * t;  // keys kl, kl + 1: k indices t, t + 4
      const int qa = q0 + rl, ka = key0 + kl;
      const float2 lo = lds2(sm, stage + tile_at<kBQ>(rl, kl));
      const float2 hi = lds2(sm, stage + tile_at<kBQ>(rl + 8, kl));
      const float xv[4] = {allowed(p, qa, ka) ? lo.x : 0.f,
                           allowed(p, qa + 8, ka) ? hi.x : 0.f,
                           allowed(p, qa, ka + 1) ? lo.y : 0.f,
                           allowed(p, qa + 8, ka + 1) ? hi.y : 0.f};
      split4(xv, ab[j], as[j]);
      pin(ab[j], as[j]);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int m = 0; m < kNT; ++m) {
        if (W == 0 && m >= nt) continue;
        const uint32_t off = stage + L::kDs + m * 64 * 128 + j * 32;
        const uint64_t bb = desc_sw128(base + off);
        const uint64_t bs = desc_sw128(base + off + L::kKt);
        if (m == kNT - 1 && (W > 0 ? W % 64 != 0 : false))
          wgmma_3xtf32(reinterpret_cast<float(&)[16]>(acc[m]), ab[j], as[j],
                       bb, bs, 1);
        else if (W == 0 && m == nt - 1 && half_last)
          wgmma_3xtf32(reinterpret_cast<float(&)[16]>(acc[m]), ab[j], as[j],
                       bb, bs, 1);
        else
          wgmma_3xtf32(acc[m], ab[j], as[j], bb, bs, 1);
      }
    wgmma_commit();
    if (i > 0) {  // the last chunk's products are done: free its stage
      wgmma_wait<1>();
      if (lane == 0) mbar_arrive(empty((i - 1) % ST));
    }
  };
  uint32_t fb0[4][4], fs0[4][4], fb1[4][4], fs1[4][4];
  int i = 0;
  for (; i + 1 < n; i += 2) {
    chunk(i, fb0, fs0);
    chunk(i + 1, fb1, fs1);
  }
  if (i < n) chunk(i, fb0, fs0);
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < kNT; ++j) fence_regs(acc[j]);
  float* dq = p.dq + b * p.st[kDQ][0] + h * p.st[kDQ][1];
  const long long ss = p.st[kDQ][2];
#pragma unroll
  for (int m = 0; m < kNT; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + rl + 8 * r, col = 64 * m + 8 * j + 2 * t;
        if (row < p.S && col < p.D)
          *reinterpret_cast<float2*>(dq + row * ss + col) =
              make_float2(acc[m][4 * j + 2 * r] * p.scale,
                          acc[m][4 * j + 2 * r + 1] * p.scale);
      }
}

}  // namespace dq

int launch_one(void (*kernel)(Params), dim3 grid, const Params& p,
               cudaStream_t stream) {
  kernel<<<grid, 256, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The five kernels of one backward (the group sum only where G > 1): HD
// the tiles' head width, BK keys a dK/dV block, ST and DST the rings'
// stages; KD, KV the k-steps of D and Dv and W the dQ width, each 0 where
// read at run time. The SM count and the two kernels' shared-memory
// attributes are set once a process and device (device_setup).
template <int HD, int BK, int ST, int DST, int KD, int KV, int W>
int launch(const Params& p, cudaStream_t stream) {
  const int Hk = p.H / p.group;
  // the two passes that need no tensor map first: the card runs them while
  // the maps are encoded
  const long long rows = static_cast<long long>(p.B) * p.H * p.S;
  int err = launch_one(flash_bwd_delta,
                       dim3(static_cast<unsigned>((rows + 7) / 8)), p, stream);
  if (err) return noted(err, "flash_bwd_delta launch");
  err = launch_one(flash_bwd_prep_kv, dim3((p.S + 31) / 32, p.B * Hk, 2), p,
                   stream);
  if (err) return noted(err, "flash_bwd_prep_kv launch");
  CUtensorMap tq, tdo, tk, tv, tds, tkt;
  // K's and V's halves are (D | Dv) rounded up to 8 wide
  const int dp = (p.D + 7) & ~7, dvp = (p.Dv + 7) & ~7;
  const long long s_d = 4ll * p.S * dp, s_dv = 4ll * p.S * dvp;
  const int w = (p.D + 31) / 32 * 32;
  if ((err = make_map(&tq, p.q, p.D, p.S, p.H, p.B, 4 * p.st[kQ][2],
                      4 * p.st[kQ][1], 4 * p.st[kQ][0], dkdv::kBQ, true)))
    return noted(err, "the tensor map of q");
  if ((err = make_map(&tdo, p.dout, p.Dv, p.S, p.H, p.B, 4 * p.st[kDO][2],
                      4 * p.st[kDO][1], 4 * p.st[kDO][0], dkdv::kBQ, true)))
    return noted(err, "the tensor map of dout");
  if ((err = make_map(&tk, p.kv, dp, p.S, 2 * Hk, p.B, 4ll * dp, s_d,
                      2 * Hk * s_d, BK, true)))
    return noted(err, "the tensor map of K's halves");
  if ((err = make_map(&tv, p.vv, dvp, p.S, 2 * Hk, p.B, 4ll * dvp, s_dv,
                      2 * Hk * s_dv, BK, true)))
    return noted(err, "the tensor map of V's halves");
  if ((err = make_map(&tds, p.ds, p.S, p.S, p.H, p.B, 4ll * p.ld,
                      4ll * p.S * p.ld, 4ll * p.H * p.S * p.ld, dq::kBQ,
                      true)))
    return noted(err, "the tensor map of dS");
  if ((err = make_map(&tkt, p.kt, p.ld, p.D, 2 * Hk, p.B, 4ll * p.ld,
                      4ll * p.D * p.ld, 8ll * Hk * p.D * p.ld, w, true)))
    return noted(err, "the tensor map of K^T's halves");
  auto kdkdv = dkdv::flash_bwd_dkdv<HD, BK, ST, KD, KV>;
  const size_t dkdv_smem = dkdv::Smem<HD, BK, ST>::kBytes;
  static std::atomic<unsigned long long> dkdv_set{0}, dq_set{0};
  int sms = 0;
  if ((err = device_setup(kdkdv, dkdv_smem, dkdv_set, sms)))
    return noted(err, "flash_bwd_dkdv's set-up");
  // persistent: a block an SM (fewer where there are fewer items);
  // otherwise (HD = 160 and 256) a block an item, which the card deals to
  // SMs as they free up: its items are unequal under the causal band, and
  // a static deal of them measured slower (at gemma3-1b's shapes, 8 items
  // an SM; at stablelm-12b's, 31 items an SM, 9 % slower)
  const int items = p.B * p.H * ((p.S + BK - 1) / BK);
  const int blocks = dkdv::persistent(HD) && items > sms ? sms : items;
  kdkdv<<<blocks, kThreads, dkdv_smem, stream>>>(tq, tdo, tk, tv, p);
  if ((err = static_cast<int>(cudaGetLastError())))
    return noted(err, "flash_bwd_dkdv launch");
  if (p.dkp != nullptr) {
    err = launch_one(flash_bwd_dkdv_sum, dim3(p.B * Hk * p.S), p, stream);
    if (err) return noted(err, "flash_bwd_dkdv_sum launch");
  }
  auto kdq = dq::flash_bwd_dq<HD, DST, W>;
  const size_t dq_smem = dq::Smem<HD, DST>::kBytes;
  if ((err = device_setup(kdq, dq_smem, dq_set, sms)))
    return noted(err, "flash_bwd_dq's set-up");
  kdq<<<dim3(p.B * p.H, (p.S + dq::kBQ - 1) / dq::kBQ), kThreads, dq_smem,
        stream>>>(tds, tkt, p);
  return noted(static_cast<int>(cudaGetLastError()), "flash_bwd_dq launch");
}

// The return value of a call whose q or dout breaks the layout rule (not
// a cudaError_t): the wrapper then names the tensor and the rule.
constexpr int kBadLayout = -1;

using hopper::layout_ok;

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// what the last flash_attention_bwd that returned an error failed at
const char* flash_attention_bwd_failure() { return g_failure; }

// The arguments of one backward call, packed by the wrapper into one block
// (flash_attention.py's _BWD_ARGS, "<8Q24q9Q7ifii": the 8-byte fields,
// then the 4-byte ones, so no padding), which one ctypes argument passes.
// q (B,H,S,D), k (B,Hk,S,D), v (B,Hk,S,Dv), o and dout (B,H,S,Dv) in; dq,
// dk, dv (shaped as q, k, v) out; st: their batch, head and sequence
// strides in elements, three each in that order; every last stride is 1;
// q and dout 16-byte aligned with strides of multiples of 4 elements,
// which a call checks before all else (kBadLayout). lse (B,H,S) contiguous
// float32 in, the forward's log2-domain log-sum-exp. Contiguous float32
// scratch: delta (B,H,S); kv (B,Hk,2,S,D8) and vv (B,Hk,2,S,Dv8), D8 and
// Dv8 D and Dv rounded up to 8; kt (B,Hk,2,D,ld) and ds (B,H,S,ld) with
// ld >= S a multiple of 8; dkp (B,H,S,D) and dvp (B,H,S,Dv) where H > Hk,
// else ignored (may be null). D and Dv multiples of 4. window <= 0: no
// window. Returns a cudaError_t or kBadLayout.
struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  long long st[kTensors][3];
  const void* lse;
  void* delta;
  void* kv;
  void* vv;
  void* kt;
  void* ds;
  void* dkp;
  void* dvp;
  void* stream;
  int B, H, Hk, S, D, Dv, ld;
  float scale;
  int causal, window;
};
static_assert(sizeof(BwdArgs) == 368, "the wrapper packs 368 bytes");

int flash_attention_bwd(const BwdArgs* a) {
  const int B = a->B, H = a->H, Hk = a->Hk, S = a->S, D = a->D, Dv = a->Dv;
  const long long(&st)[kTensors][3] = a->st;
  if (!(layout_ok(a->q, D, st[kQ][0], st[kQ][1], st[kQ][2], B, H, S, 4) &&
        layout_ok(a->dout, Dv, st[kDO][0], st[kDO][1], st[kDO][2], B, H, S,
                  4)))
    return noted(kBadLayout, "the layout of q or dout");
  // an error that an earlier runtime call of this thread left (the
  // autograd engine's thread runs this) is not this call's: clear it, so
  // that the check after each launch reads that launch's
  cudaGetLastError();
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (Hk <= 0 || H % Hk || D <= 0 || D > kMaxD || Dv <= 0 || Dv > kMaxD ||
      D % 4 || Dv % 4 || a->ld < S || a->ld % 8)
    return noted(cudaErrorInvalidValue, "the shapes");
  if (H > Hk && (a->dkp == nullptr || a->dvp == nullptr))
    return noted(cudaErrorInvalidValue, "the group sum's scratch");
  Params p;
  p.q = static_cast<const float*>(a->q);
  p.k = static_cast<const float*>(a->k);
  p.v = static_cast<const float*>(a->v);
  p.o = static_cast<const float*>(a->o);
  p.dout = static_cast<const float*>(a->dout);
  p.dq = static_cast<float*>(a->dq);
  p.dk = static_cast<float*>(a->dk);
  p.dv = static_cast<float*>(a->dv);
  p.lse = static_cast<const float*>(a->lse);
  p.delta = static_cast<float*>(a->delta);
  p.kv = static_cast<float*>(a->kv);
  p.vv = static_cast<float*>(a->vv);
  p.kt = static_cast<float*>(a->kt);
  p.ds = static_cast<float*>(a->ds);
  p.dkp = H > Hk ? static_cast<float*>(a->dkp) : nullptr;
  p.dvp = H > Hk ? static_cast<float*>(a->dvp) : nullptr;
  p.B = B;
  p.H = H;
  p.group = H / Hk;
  p.S = S;
  p.D = D;
  p.Dv = Dv;
  p.ld = a->ld;
  for (int i = 0; i < kTensors; ++i)
    for (int j = 0; j < 3; ++j) p.st[i][j] = st[i][j];
  p.scale = a->scale;
  p.causal = a->causal;
  p.window = a->window;
  cudaStream_t stream = static_cast<cudaStream_t>(a->stream);
  const int hd = D > Dv ? D : Dv;
  if (hd <= 64) {
    if (D == 64 && Dv == 64) return launch<64, 64, 2, 4, 8, 8, 64>(p, stream);
    return launch<64, 64, 2, 4, 0, 0, 0>(p, stream);
  }
  if (hd <= 128) {
    if (D == 128 && Dv == 128)
      return launch<128, 32, 2, 4, 16, 16, 128>(p, stream);
    if (D == 96 && Dv == 64)  // MLA: 64 nope + 32 rope; v 64
      return launch<128, 32, 2, 4, 12, 8, 96>(p, stream);
    return launch<128, 32, 2, 4, 0, 0, 0>(p, stream);
  }
  if (D == 160 && Dv == 160)  // stablelm-12b: 5 atoms, 32 keys, one stage
    return launch<160, 32, 1, 4, 20, 20, 160>(p, stream);
  if (D == 256 && Dv == 256)
    return launch<256, 16, 1, 2, 32, 32, 256>(p, stream);
  return launch<256, 16, 1, 2, 0, 0, 0>(p, stream);
}

}  // extern "C"
