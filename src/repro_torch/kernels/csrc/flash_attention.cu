// Causal / sliding-window flash-attention forward, for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention
// (_flash_kernel), the Pallas forward softmax attention in (B, H, S, D)
// layout. The port's prefill attention (gemma3-1b in f32, Jamba in bf16)
// runs through it.
//
// Bound on the H100: operations. A causal head costs about S*S*(D + Dv)
// flops for 2*S*(D + Dv) elements of input and output: at Jamba's shape
// (bf16, B=4, H=64, Hk=8, S=1024, D=128) 68.8 GFLOP against 1.5e8 bytes of
// q, k, v and o, 0.070 ms at the 989 TFLOP/s bf16 tensor-core rate and
// 0.045 ms at 3.35 TB/s; at gemma3-1b's global layer (f32, B=4, H=4, Hk=1,
// S=1024, D=256) 8.6 GFLOP, 0.052 ms at the 3xTF32 rate. Two kernels, one
// for each dtype:
//
// flash_fwd_mma, bf16 (FlashAttention-2 on warp-level tensor cores):
//   - one block of 4 warps per (batch*head, 64-row query tile), each warp
//     owning 16 query rows; the KV loop inside the block is bounded to the
//     causal and window bands, so the work follows the mask; the tiles that
//     reach past the diagonal go first (the grid's y runs backwards);
//   - the bf16 Q tile and double-buffered K and V tiles live in shared
//     memory as bf16, loaded with 16-byte cp.async.cg copies (the next KV
//     tile loads while this one computes); rows and columns past S, D or Dv
//     are zero-filled, so any D, Dv <= 256 that are multiples of 8 work on a
//     tile padded to HD in {64, 128, 256}; each row is padded by 8 bf16 so
//     that the 8 rows an ldmatrix reads fall on distinct banks;
//   - S = Q K^T with ldmatrix.x4 (Q as A, K without .trans as the .col B)
//     and mma.sync m16n8k16 bf16 -> f32 (at HD <= 128 a warp's Q fragments
//     stay in registers after the first tile); scale, mask and the -1e30 sentinel
//     are applied after scaling, in the log2 domain (log2(e) folded into the
//     scale, exp2f), so a row that is fully masked so far takes p = 1 and is
//     wiped by corr = 0 as in the reference; m and l are f32, the row max is
//     an xor shuffle over the 4 lanes of a C-fragment row, l is summed per
//     lane and reduced once at the end, clamped at 1e-30;
//   - O += P V: the f32 score fragments are packed to bf16 A-fragments in
//     registers (the m16n8 C layout is the m16n8k16 A layout), V comes
//     through ldmatrix.x4.trans; O is 16 x HD f32 a warp in registers; it is
//     staged through the warp's own rows of the Q tile and stored as 16-byte
//     rows. At HD = 256 the KV tiles are 32 keys (101,376 bytes of shared
//     memory, two blocks an SM); otherwise 64 keys.
//   Left for wgmma + TMA: warpgroup products from shared memory, TMA loads
//   with mbarriers, a producer warp, and persistent blocks.
//
// flash_fwd_tf32, f32 (the same FlashAttention-2 structure in 3xTF32):
//   - same grid, bands, softmax and output staging as flash_fwd_mma, but a
//     block is two groups of 4 warps that share the f32 Q tile: each group
//     takes every other KV tile of the band into its own f32 K and V tiles
//     (16-byte cp.async copies, D and Dv multiples of 4, zero-filled to HD;
//     the next K loads during P V, the next V during the next Q K^T) and
//     syncs on its own named barrier; at the end group 1 hands m, l and O
//     to group 0 through shared memory, which merges them. At HD = 256 a
//     block fills the SM's shared memory (201,728 bytes, 32-key tiles), so
//     the groups are what puts 8 warps on an SM instead of 4 (64-key tiles at
//     HD = 64);
//   - each f32 operand x is split into TF32 values big = rna(x) and small =
//     rna(x - big), and every product is small*big + big*small, then +
//     big*big, with mma.sync m16n8k8 tf32 -> f32 (small*small is dropped, as
//     in CUTLASS's fast-f32 GEMMs): about f32 accuracy, where one TF32 product
//     on either matmul misses the 1e-4 tolerance; the bound is the TF32
//     tensor-core rate over 3 (494.7 / 3 TFLOP/s). rna is the rounding of
//     cvt.rna.tf32.f32 written as an integer add and mask: the splits are
//     most of the kernel's instructions, and sm_90a expands the cvt into 4;
//   - ldmatrix moves only b16 elements, so fragments are plain shared loads.
//     Each product runs over its inner index in an order permuted within
//     groups of 8 (the fragments' t and t + 4 read 2t and 2t + 1), the same
//     for both operands: Q and K fragments are then one float2 read each, on
//     32 banks with rows padded by 8 floats, and P's m16n8 C fragment
//     (columns 2t, 2t + 1) already is its A fragment, so P stays in registers
//     without a shuffle; V, read at key 2t and column g, is padded by 4
//     floats;
//   - Q is split again on every KV tile: split Q would not fit beside the
//     K and V tiles at HD = 256;
//   - the split and mma helpers live in tf32_mma.cuh, shared with the
//     backward; where the caller passes an lse buffer (training), group 0
//     writes each row's log-sum-exp m + log2(l) after the merge, in the
//     log2 domain of the scores, so the backward need not recompute it.
// Both read kv head h / (H / Hk) directly instead of a copy (GQA), take any
// S (the ragged last tile is masked), Dv != D, and strided q, k, v with a
// unit last dimension, 16-byte aligned pointers and row strides, which the
// wrapper checks.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, group, S, D, Dv;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  float scale;
  int causal;
  int window;  // <= 0: no window
  float* lse;  // (B, H, S) contiguous, or null; f32 only
};

// ---------------------------------------------------------------------------
// bf16: flash_fwd_mma
// ---------------------------------------------------------------------------

namespace mma {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // query rows per block, 16 a warp
constexpr int kPad = 8;           // bf16 of padding at the end of a row

// HD: padded head dim (a multiple of 16 covering D and Dv); BK: keys a tile.
template <int HD, int BK>
struct Tile {
  static constexpr int kLd = HD + kPad;  // row stride in shared memory
  static constexpr int kQ = kBQ * kLd;
  static constexpr int kKV = BK * kLd;
  static constexpr size_t kBytes = sizeof(__nv_bfloat16) * (kQ + 4 * kKV);
};

__device__ __forceinline__ unsigned saddr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-fills the 16 bytes when !ok.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma16816(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ROWS rows of `cols` (a multiple of 16 bytes) elements from global rows
// row0.. of stride ss into a tile of HD columns and row stride LD, copied by
// THREADS threads, of which this is thread tid; rows >= S and columns >=
// cols are zero-filled.
template <int ROWS, int HD, int LD = HD + kPad, int THREADS = kThreads,
          typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long ss,
                                          int row0, int S, int cols,
                                          int tid) {
  constexpr int kVec = 16 / sizeof(T);  // elements a 16-byte chunk
  constexpr int kChunks = HD / kVec;    // 16-byte chunks a row
  static_assert(ROWS * kChunks % THREADS == 0, "whole rounds of copies");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / kChunks, col = (c - r * kChunks) * kVec;
    const bool ok = row0 + r < S && col < cols;
    const T* g = ok ? src + (row0 + r) * ss + col : src;
    cp_async16(saddr(dst + r * LD + col), g, ok);
  }
}

template <int HD, int BK>
__global__ void __launch_bounds__(kThreads) flash_fwd_mma(Params p) {
  using T = Tile<HD, BK>;
  constexpr int kLd = T::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + T::kQ;       // two buffers of kKV
  __nv_bfloat16* Vs = Ks + 2 * T::kKV;  // two buffers of kKV

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int hk = h / p.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int S = p.S;

  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                     h * p.o_sh;

  // KV tiles that the causal band and the window band reach
  const int q_last = min(q0 + kBQ, S) - 1;
  const int kv_hi = p.causal ? q_last + 1 : S;
  const int kv_lo = p.window > 0 ? max(q0 - p.window + 1, 0) : 0;
  const int t_lo = kv_lo / BK;
  const int t_hi = (kv_hi + BK - 1) / BK;

  load_tile<kBQ, HD>(Qs, q, p.q_ss, q0, S, p.D, threadIdx.x);
  if (t_lo < t_hi) {
    load_tile<BK, HD>(Ks, k, p.k_ss, t_lo * BK, S, p.D, threadIdx.x);
    load_tile<BK, HD>(Vs, v, p.v_ss, t_lo * BK, S, p.Dv, threadIdx.x);
  }
  cp_async_commit();

  // this lane's C-fragment rows: r0 (c0, c1) and r0 + 8 (c2, c3)
  const int r0 = q0 + warp * 16 + lane / 4;
  const float scale = p.scale * 1.4426950408889634f;  // log2(e) folded in
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this lane's share; the quad's sum at the end

  // ldmatrix row addresses of this lane (see the fragment layouts of
  // mma.m16n8k16): Q rows warp*16 + lane%16, column half lane/16; K key
  // lane%8 + (lane/16)*8, column half (lane/8)%2; V key lane%8 +
  // ((lane/8)%2)*8, column half lane/16
  const unsigned q_lane =
      saddr(Qs + (warp * 16 + lane % 16) * kLd + (lane / 16) * 8);
  const int k_lane = (lane % 8 + (lane / 16) * 8) * kLd + ((lane / 8) % 2) * 8;
  const int v_lane = (lane % 8 + ((lane / 8) % 2) * 8) * kLd + (lane / 16) * 8;

  // At HD <= 128 a warp keeps its Q fragments in registers after the first
  // tile (32 registers); at HD = 256 they are reloaded from shared memory.
  constexpr bool kQRegs = HD <= 128;
  uint32_t qf[kQRegs ? HD / 16 : 1][4];
  for (int t = t_lo; t < t_hi; ++t) {
    const int buf = (t - t_lo) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    if (t + 1 < t_hi) {
      load_tile<BK, HD>(Ks + (buf ^ 1) * T::kKV, k, p.k_ss, (t + 1) * BK, S,
                        p.D, threadIdx.x);
      load_tile<BK, HD>(Vs + (buf ^ 1) * T::kKV, v, p.v_ss, (t + 1) * BK, S,
                        p.Dv, threadIdx.x);
    }
    cp_async_commit();
    const unsigned k_base = saddr(Ks + buf * T::kKV + k_lane);
    const unsigned v_base = saddr(Vs + buf * T::kKV + v_lane);
    const int k0 = t * BK;

    // S = Q K^T: 16 rows x BK keys a warp, n-block j = keys 8j..8j+7
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
      uint32_t a[4];
      if constexpr (kQRegs) {
        if (t == t_lo) ldsm_x4(q_lane + kc * 32, qf[kc]);
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[kc][i];
      } else {
        ldsm_x4(q_lane + kc * 32, a);
      }
#pragma unroll
      for (int nb = 0; nb < BK / 16; ++nb) {
        uint32_t kb[4];
        ldsm_x4(k_base + (nb * 16 * kLd + kc * 16) * 2, kb);
        mma16816(s[2 * nb], a, kb[0], kb[1]);
        mma16816(s[2 * nb + 1], a, kb[2], kb[3]);
      }
    }

    // scale, then the mask where the tile crosses an edge of the band or S
    const bool edge = k0 + BK > S || (p.causal && k0 + BK - 1 > q0) ||
                      (p.window > 0 && q0 + kBQ - 1 - k0 >= p.window);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[j][i] * scale;
        if (edge) {
          const int qp = r0 + (i / 2) * 8;
          const int kp = k0 + j * 8 + (lane % 4) * 2 + (i % 2);
          const bool ok = kp < S && (!p.causal || kp <= qp) &&
                          (p.window <= 0 || qp - kp < p.window);
          if (!ok) x = kNegInf;
        }
        s[j][i] = x;
      }

    // online softmax, two rows a lane
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[r] = exp2f(m[r] - mx);
      m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        s[j][2 * r] = exp2f(s[j][2 * r] - mx);
        s[j][2 * r + 1] = exp2f(s[j][2 * r + 1] - mx);
        sum += s[j][2 * r] + s[j][2 * r + 1];
      }
      l[r] = l[r] * corr[r] + sum;
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // O += P V: P's C-fragments of n-blocks 2kc, 2kc+1 are the A-fragment
    // of keys 16kc..16kc+15
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      const uint32_t a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                             pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                             pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int nb = 0; nb < HD / 16; ++nb) {
        uint32_t vb[4];
        ldsm_x4_t(v_base + (kc * 16 * kLd + nb * 16) * 2, vb);
        mma16816(acc[2 * nb], a, vb[0], vb[1]);
        mma16816(acc[2 * nb + 1], a, vb[2], vb[3]);
      }
    }
  }

  // normalise, stage the warp's 16 rows in its own rows of the Q tile (only
  // this warp read them), and store them as 16-byte chunks
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv[r] = 1.f / fmaxf(sum, 1e-30f);
  }
  cp_async_wait_all();
  __syncthreads();
  __nv_bfloat16* Ow = Qs + warp * 16 * kLd;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(Ow + (lane / 4 + 8 * r) * kLd + j * 8 +
                                   (lane % 4) * 2) =
          pack_bf16(acc[j][2 * r] * inv[r], acc[j][2 * r + 1] * inv[r]);
  __syncwarp();
  constexpr int kChunks = HD / 8;
#pragma unroll
  for (int i = 0; i < 16 * kChunks / 32; ++i) {
    const int c = lane + i * 32;
    const int r = c / kChunks, col = (c - r * kChunks) * 8;
    const int qp = q0 + warp * 16 + r;
    if (qp < S && col < p.Dv)
      *reinterpret_cast<uint4*>(o + qp * p.o_ss + col) =
          *reinterpret_cast<const uint4*>(Ow + r * kLd + col);
  }
}

// ---------------------------------------------------------------------------
// f32: flash_fwd_tf32
// ---------------------------------------------------------------------------

// The f32 kernel runs two groups of 4 warps a block: both own the block's
// 64 query rows, each takes every other KV tile of the band into its own K
// and V buffers, and their softmax states are merged at the end. That gives
// an SM 8 warps, where one 4-warp block fills its shared memory at HD = 256.
constexpr int kGroups = 2;

// HD: padded head dim (a multiple of 8 covering D and Dv); BK: keys a tile.
// The padding of a row puts the fragment reads of a warp on 32 banks: Q and
// K are read as float2 at row g, column 2t (a stride = 8 mod 32 floats), V
// as float at key 2t, column g (a stride = 4 mod 32).
template <int HD, int BK>
struct TileF32 {
  static constexpr int kLdQK = HD + 8;
  static constexpr int kLdV = HD + 4;
  static constexpr int kQ = kBQ * kLdQK;
  static constexpr int kK = BK * kLdQK;
  static constexpr int kV = BK * kLdV;
  static constexpr size_t kBytes =
      sizeof(float) * (kQ + kGroups * (kK + kV));
};

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// the 4 warps of one group
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(kThreads)
               : "memory");
}

template <int HD, int BK>
__global__ void __launch_bounds__(kGroups * kThreads)
    flash_fwd_tf32(Params p) {
  using T = TileF32<HD, BK>;
  constexpr int kLdQK = T::kLdQK, kLdV = T::kLdV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  const int group = threadIdx.x / kThreads;
  const int tid = threadIdx.x % kThreads;  // thread in the group
  float* Ks = Qs + T::kQ + group * (T::kK + T::kV);  // this group's tiles
  float* Vs = Ks + T::kK;

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int hk = h / p.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;  // fragment row and column group
  const int S = p.S;

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  // KV tiles that the causal band and the window band reach; this group
  // takes t_lo + group, t_lo + group + 2, ...
  const int q_last = min(q0 + kBQ, S) - 1;
  const int kv_hi = p.causal ? q_last + 1 : S;
  const int kv_lo = p.window > 0 ? max(q0 - p.window + 1, 0) : 0;
  const int t_lo = kv_lo / BK;
  const int t_hi = (kv_hi + BK - 1) / BK;

  // Copies are committed in pairs, K then V, so that at the top of the
  // loop this thread has at most K_t and V_t in flight, and waiting for
  // all but the newest group lands K_t, then (after K_{t+2} is issued) V_t.
  load_tile<kBQ, HD, kLdQK, kGroups * kThreads>(Qs, q, p.q_ss, q0, S, p.D,
                                                threadIdx.x);
  cp_async_commit();
  const int t0 = t_lo + group;
  if (t0 < t_hi)
    load_tile<BK, HD, kLdQK>(Ks, k, p.k_ss, t0 * BK, S, p.D, tid);
  cp_async_commit();
  if (t0 < t_hi)
    load_tile<BK, HD, kLdV>(Vs, v, p.v_ss, t0 * BK, S, p.Dv, tid);
  cp_async_commit();
  cp_async_wait_one();
  __syncthreads();  // Q (copied by both groups) and the first K tiles are in

  // this lane's C-fragment rows: r0 (c0, c1) and r0 + 8 (c2, c3)
  const int r0 = q0 + warp * 16 + g;
  const float scale = p.scale * 1.4426950408889634f;  // log2(e) folded in
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this lane's share; the quad's sum at the end

  // Both products run over their inner index (head dims for Q K^T, keys for
  // P V) in an order permuted within each group of 8: the m16n8k8 fragments'
  // inner indices t and t + 4 are taken from 2t and 2t + 1. Both operands
  // share the permutation, so the sums are the same; Q and K fragments are
  // float2 reads, and P's C fragment (columns 2t, 2t + 1) is its A fragment.
  const float* q_lane = Qs + (warp * 16 + g) * kLdQK + 2 * tq;
  const float* k_lane = Ks + g * kLdQK + 2 * tq;
  const float* v_lane = Vs + 2 * tq * kLdV + g;

  for (int t = t0; t < t_hi; t += kGroups) {
    cp_async_wait_one();
    group_sync(group);  // K_t is in
    const int k0 = t * BK;

    // S = Q K^T: 16 rows x BK keys a warp, n-block j = keys 8j..8j+7; Q is
    // split again on every tile
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kc = 0; kc < HD / 8; ++kc) {
      const float2 qa = *reinterpret_cast<const float2*>(q_lane + kc * 8);
      const float2 qb =
          *reinterpret_cast<const float2*>(q_lane + 8 * kLdQK + kc * 8);
      uint32_t a_big[4], a_small[4];
      split_tf32(qa.x, a_big[0], a_small[0]);  // row g, index t
      split_tf32(qb.x, a_big[1], a_small[1]);  // row g + 8, index t
      split_tf32(qa.y, a_big[2], a_small[2]);  // row g, index t + 4
      split_tf32(qb.y, a_big[3], a_small[3]);  // row g + 8, index t + 4
#pragma unroll
      for (int nb = 0; nb < BK / 8; ++nb) {
        const float2 kb = *reinterpret_cast<const float2*>(
            k_lane + nb * 8 * kLdQK + kc * 8);
        uint32_t b_big[2], b_small[2];
        split_tf32(kb.x, b_big[0], b_small[0]);  // key g, index t
        split_tf32(kb.y, b_big[1], b_small[1]);  // key g, index t + 4
        mma_3xtf32(s[nb], a_big, a_small, b_big, b_small);
      }
    }
    group_sync(group);  // every warp of the group is done with K_t
    if (t + kGroups < t_hi)
      load_tile<BK, HD, kLdQK>(Ks, k, p.k_ss, (t + kGroups) * BK, S, p.D,
                               tid);
    cp_async_commit();

    // scale, then the mask where the tile crosses an edge of the band or S
    const bool edge = k0 + BK > S || (p.causal && k0 + BK - 1 > q0) ||
                      (p.window > 0 && q0 + kBQ - 1 - k0 >= p.window);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[j][i] * scale;
        if (edge) {
          const int qp = r0 + (i / 2) * 8;
          const int kp = k0 + j * 8 + tq * 2 + (i % 2);
          const bool ok = kp < S && (!p.causal || kp <= qp) &&
                          (p.window <= 0 || qp - kp < p.window);
          if (!ok) x = kNegInf;
        }
        s[j][i] = x;
      }

    // online softmax, two rows a lane
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[r] = exp2f(m[r] - mx);
      m[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        s[j][2 * r] = exp2f(s[j][2 * r] - mx);
        s[j][2 * r + 1] = exp2f(s[j][2 * r + 1] - mx);
        sum += s[j][2 * r] + s[j][2 * r + 1];
      }
      l[r] = l[r] * corr[r] + sum;
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    cp_async_wait_one();
    group_sync(group);  // V_t is in
    // O += P V: the C fragment of keys 8j..8j+7 is the A fragment of the
    // permuted keys (index t = key 2t, index t + 4 = key 2t + 1)
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      uint32_t a_big[4], a_small[4];
      split_tf32(s[j][0], a_big[0], a_small[0]);  // row g, key 2t
      split_tf32(s[j][2], a_big[1], a_small[1]);  // row g + 8, key 2t
      split_tf32(s[j][1], a_big[2], a_small[2]);  // row g, key 2t + 1
      split_tf32(s[j][3], a_big[3], a_small[3]);  // row g + 8, key 2t + 1
      const float* vj = v_lane + j * 8 * kLdV;
#pragma unroll
      for (int nb = 0; nb < HD / 8; ++nb) {
        uint32_t b_big[2], b_small[2];
        split_tf32(vj[nb * 8], b_big[0], b_small[0]);  // key 2t, column g
        split_tf32(vj[kLdV + nb * 8], b_big[1], b_small[1]);  // key 2t + 1
        mma_3xtf32(acc[nb], a_big, a_small, b_big, b_small);
      }
    }
    group_sync(group);  // every warp of the group is done with V_t
    if (t + kGroups < t_hi)
      load_tile<BK, HD, kLdV>(Vs, v, p.v_ss, (t + kGroups) * BK, S, p.Dv,
                              tid);
    cp_async_commit();
  }

  // Merge: group 1 hands its m, l and O fragments to group 0 through the
  // K and V buffers (lane-major, so neither side has a bank conflict);
  // group 0 rescales both to the larger m and adds them.
  cp_async_wait_all();
  __syncthreads();
  constexpr int kX = (HD / 2 + 4) * 32;  // floats a warp hands over
  float* X = Qs + T::kQ + warp * kX + lane;
  if (group == 1) {
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) X[(j * 4 + i) * 32] = acc[j][i];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      X[(HD / 2 + r) * 32] = m[r];
      X[(HD / 2 + 2 + r) * 32] = l[r];
    }
  }
  __syncthreads();
  if (group == 1) return;
  float c0[2], c1[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = X[(HD / 2 + r) * 32];
    const float mx = fmaxf(m[r], m1);
    c0[r] = exp2f(m[r] - mx);
    c1[r] = exp2f(m1 - mx);
    l[r] = l[r] * c0[r] + X[(HD / 2 + 2 + r) * 32] * c1[r];
    m[r] = mx;
  }
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc[j][i] = acc[j][i] * c0[i / 2] + X[(j * 4 + i) * 32] * c1[i / 2];

  // normalise, stage the warp's 16 rows in its own rows of the Q tile (only
  // this warp read them), and store them as 16-byte chunks
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum = fmaxf(sum, 1e-30f);
    inv[r] = 1.f / sum;
    // the row's log-sum-exp for the backward, in the log2 domain of the
    // scores (scale * log2(e) folded in): log2 sum_j 2^(s_ij scale log2 e)
    const int qp = q0 + warp * 16 + g + 8 * r;
    if (p.lse != nullptr && tq == 0 && qp < S)
      p.lse[static_cast<long long>(bh) * S + qp] = m[r] + log2f(sum);
  }
  float* Ow = Qs + warp * 16 * kLdQK;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(Ow + (g + 8 * r) * kLdQK + j * 8 + 2 * tq) =
          make_float2(acc[j][2 * r] * inv[r], acc[j][2 * r + 1] * inv[r]);
  __syncwarp();
  constexpr int kChunks = HD / 4;
#pragma unroll
  for (int i = 0; i < 16 * kChunks / 32; ++i) {
    const int c = lane + i * 32;
    const int r = c / kChunks, col = (c - r * kChunks) * 4;
    const int qp = q0 + warp * 16 + r;
    if (qp < S && col < p.Dv)
      *reinterpret_cast<float4*>(o + qp * p.o_ss + col) =
          *reinterpret_cast<const float4*>(Ow + r * kLdQK + col);
  }
}

// One launch of `kernel` with `smem` bytes of dynamic shared memory: a
// block of `threads` per (batch*head, 64-row query tile).
int launch(void (*kernel)(Params), int threads, size_t smem, const Params& p,
           int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * p.H, (p.S + kBQ - 1) / kBQ);
  kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, int BK>
int launch_bf16(const Params& p, int B, cudaStream_t stream) {
  return launch(flash_fwd_mma<HD, BK>, kThreads, Tile<HD, BK>::kBytes, p, B,
                stream);
}

template <int HD, int BK>
int launch_f32(const Params& p, int B, cudaStream_t stream) {
  return launch(flash_fwd_tf32<HD, BK>, kGroups * kThreads,
                TileF32<HD, BK>::kBytes, p, B, stream);
}

}  // namespace mma

int launch_mma(const Params& p, int B, cudaStream_t stream) {
  if (p.D % 8 || p.Dv % 8) return static_cast<int>(cudaErrorInvalidValue);
  const int hd = p.D > p.Dv ? p.D : p.Dv;
  if (hd <= 64) return mma::launch_bf16<64, 64>(p, B, stream);
  if (hd <= 128) return mma::launch_bf16<128, 64>(p, B, stream);
  return mma::launch_bf16<256, 32>(p, B, stream);
}

// f32 tiles: 90,112 bytes of shared memory at HD = 64, 103,424 at 128,
// 201,728 at 256; 256 threads a block.
int launch_tf32(const Params& p, int B, cudaStream_t stream) {
  if (p.D % 4 || p.Dv % 4) return static_cast<int>(cudaErrorInvalidValue);
  const int hd = p.D > p.Dv ? p.D : p.Dv;
  if (hd <= 64) return mma::launch_f32<64, 64>(p, B, stream);
  if (hd <= 128) return mma::launch_f32<128, 32>(p, B, stream);
  return mma::launch_f32<256, 32>(p, B, stream);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B,H,S,D), k (B,Hk,S,D), v (B,Hk,S,Dv), o (B,H,S,Dv), each given by its
// batch/head/seq strides in elements with a unit last stride; 16-byte
// aligned pointers, strides and head dims multiples of 16 bytes.
// dtype: 0 = float32 (flash_fwd_tf32), 1 = bfloat16 (flash_fwd_mma).
// window <= 0: no window. lse: null, or (f32 only) a contiguous (B, H, S)
// float32 output that takes each row's log-sum-exp in the log2 domain,
// log2 sum_j 2^(s_ij * scale * log2(e)), for the backward.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int H, int Hk, int S, int D, int Dv,
                        long long q_sb, long long q_sh, long long q_ss,
                        long long k_sb, long long k_sh, long long k_ss,
                        long long v_sb, long long v_sh, long long v_ss,
                        long long o_sb, long long o_sh, long long o_ss,
                        float scale, int causal, int window, void* lse,
                        void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (Hk <= 0 || H % Hk || D <= 0 || D > kMaxD || Dv <= 0 || Dv > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,    k,    v,    o,    H,    H / Hk, S,    D,    Dv,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,   v_sb, v_sh, v_ss,
           o_sb, o_sh, o_ss, scale, causal, window,
           static_cast<float*>(lse)};
  if (lse != nullptr && dtype != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_tf32(p, B, st);
  if (dtype == 1) return launch_mma(p, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
