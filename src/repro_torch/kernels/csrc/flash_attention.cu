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
// q, k, v and o, 0.0696 ms at the 989 TFLOP/s bf16 tensor-core rate and
// 0.045 ms at 3.35 TB/s; at minicpm3-4b's MLA heads (bf16, B=4, H=Hk=40,
// S=1024, D=96, Dv=64) the bytes bound, 0.0313 ms; at gemma3-1b's global
// layer (f32, B=4, H=4, Hk=1, S=1024, D=256) 8.6 GFLOP, 0.052 ms at the
// 3xTF32 rate. Two kernels, one for each dtype:
//
// flash_fwd_wgmma, bf16 (warp-specialised and persistent, on wgmma and TMA):
//   - one block of 384 threads per SM, which takes work items (batch*head,
//     128-row query tile) in turn, head by head, so that the blocks that
//     run at once read a few heads' K and V from L2; where there is work
//     enough, a block's unit is a head's heaviest and lightest query tiles
//     left, so that units weigh the same under the causal band. One
//     producer warpgroup, whose first thread keeps K and V tiles in flight
//     by TMA through a ring of 2 stages that runs on across items (full
//     and empty mbarriers per stage, K and V on barriers of their own, so
//     that K is released as soon as Q K^T has read it) and loads each
//     item's Q once the last item's Q is free; two consumer warpgroups of
//     64 query rows each. setmaxnreg hands the producer's registers to the
//     consumers (24 and 240 a thread), on paths that never meet again;
//   - q, k, v and o are 4-D tensor maps over (D, S, H, B) with the byte
//     strides of the views, built at each call (cuTensorMapEncodeTiled,
//     found through the runtime's driver entry point), so the model's
//     (B, S, H, D) views need no copy; tiles land 128-byte swizzled as
//     64-column atoms; rows past S and columns past D or Dv read as zero
//     (a barrier expects the whole box's bytes all the same);
//   - S = Q K^T is wgmma m64nBKk16 with Q and K from shared memory through
//     descriptors, ceil(D / 16) k-steps: at D = 96 it computes 96 columns,
//     not the tile's 128; O += P V takes P packed to bf16 from the score
//     registers (the wgmma C layout is its A layout) and V as an N-major B
//     operand (the transpose bit), Dv wide: one 128-wide product at
//     Dv = 128, else one per 64-column atom;
//   - the consumers take turns at the tensor cores (two named barriers):
//     in its turn a warpgroup issues Q K^T of tile i and P V of tile i - 1,
//     then runs the softmax of tile i while the other issues; P alternates
//     between two register sets, so that nothing an unfinished product
//     reads is rewritten and ptxas keeps the products asynchronous;
//   - the softmax is flash_fwd_tf32's below in the log2 domain, with the
//     -1e30 sentinel on the tiles that cross an edge of the band or S; the
//     others take max and exponent from the raw scores with the scale in
//     one fma, and exponents are ex2.approx.ftz; f32 m, l and O, l clamped
//     at 1e-30;
//   - each consumer stages its normalised rows as bf16 and stores them by
//     TMA (rows past S are not written), in a tile of its own up to
//     HD = 128, so that the next item's Q loads meanwhile; at HD = 256 in
//     its rows of the Q tile;
//   - HD (the tiles' head width) 64 and 128 take 128-key tiles, 256 takes
//     64; 197,712 bytes of shared memory at HD = 128 and 256. D = Dv in
//     {64, 128, 256} and MLA's 96 / 64 have instantiations of their own,
//     without branches between the products; other widths read D and Dv
//     at run time.
//   Left for later: overlapping a warpgroup's softmax with its own next
//   Q K^T (two score register sets); a deeper ring, which at HD = 128
//   needs the shared memory that the output tile takes; issuing an item's
//   first Q K^T in the last turn of the item before (with a second Q tile
//   it filled the shared memory at HD = 128 and measured no faster); a
//   dynamic tile scheduler; clusters with TMA multicast of K and V across
//   the query heads of a GQA group.
//
// flash_fwd_tf32, f32 (FlashAttention-2 on warp-level tensor cores, 3xTF32):
//   - one block of two groups of 4 warps per (batch*head, 64-row query
//     tile), each warp owning 16 query rows; the KV loop is bounded to the
//     causal and window bands, the tiles that reach past the diagonal go
//     first (the grid's y runs backwards); the groups share the f32 Q tile
//     and each takes every other KV tile of the band into its own f32 K and
//     V tiles (16-byte cp.async copies, D and Dv multiples of 4,
//     zero-filled to HD in {64, 128, 256}; the next K loads during P V, the
//     next V during the next Q K^T) and syncs on its own named barrier; at
//     the end group 1 hands m, l and O to group 0 through shared memory,
//     which merges them. At HD = 256 a block fills the SM's shared memory
//     (201,728 bytes, 32-key tiles), so the groups are what puts 8 warps on
//     an SM instead of 4 (64-key tiles at HD = 64);
//   - scale, mask and the -1e30 sentinel are applied after scaling, in the
//     log2 domain (log2(e) folded into the scale, exp2f), so a row that is
//     fully masked so far takes p = 1 and is wiped by corr = 0 as in the
//     reference; m and l are f32, the row max is an xor shuffle over the 4
//     lanes of a C-fragment row, l is summed per lane and reduced once at
//     the end, clamped at 1e-30; O is staged through the warp's own rows of
//     the Q tile and stored as 16-byte rows;
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
//   - the split and mma helpers live in tf32_mma.cuh; where the caller
//     passes an lse buffer (training), group 0 writes each row's
//     log-sum-exp m + log2(l) after the merge, in the log2 domain of the
//     scores, so the backward need not recompute it.
// Both read kv head h / (H / Hk) directly instead of a copy (GQA), take any
// S (the ragged last tile is masked), Dv != D, and strided q, k, v with a
// unit last dimension, 16-byte aligned pointers and row strides, which the
// wrapper checks.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
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
// f32: flash_fwd_tf32
// ---------------------------------------------------------------------------

namespace mma {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // query rows per block, 16 a warp

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

// ROWS rows of `cols` (a multiple of 16 bytes) elements from global rows
// row0.. of stride ss into a tile of HD columns and row stride LD, copied by
// THREADS threads, of which this is thread tid; rows >= S and columns >=
// cols are zero-filled.
template <int ROWS, int HD, int LD, int THREADS = kThreads, typename T>
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
int launch_f32(const Params& p, int B, cudaStream_t stream) {
  return launch(flash_fwd_tf32<HD, BK>, kGroups * kThreads,
                TileF32<HD, BK>::kBytes, p, B, stream);
}

}  // namespace mma

// f32 tiles: 90,112 bytes of shared memory at HD = 64, 103,424 at 128,
// 201,728 at 256; 256 threads a block.
int launch_tf32(const Params& p, int B, cudaStream_t stream) {
  if (p.D % 4 || p.Dv % 4) return static_cast<int>(cudaErrorInvalidValue);
  const int hd = p.D > p.Dv ? p.D : p.Dv;
  if (hd <= 64) return mma::launch_f32<64, 64>(p, B, stream);
  if (hd <= 128) return mma::launch_f32<128, 32>(p, B, stream);
  return mma::launch_f32<256, 32>(p, B, stream);
}

// ---------------------------------------------------------------------------
// bf16: flash_fwd_wgmma
// ---------------------------------------------------------------------------

namespace wg {

using namespace hopper;

constexpr int kBQ = 128;         // query rows a block, 64 a consumer warpgroup
constexpr int kThreads = 384;    // the producer warpgroup, then two consumers
constexpr int kStages = 2;       // K and V tiles in flight
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 24 * 128 + 240 * 256 <= 65,536

struct Args {
  int B, H, group, S, D, Dv;
  float scale;  // log2(e) folded in
  int causal;
  int window;  // <= 0: no window
  int units;     // work units, each of per_unit items (see decode)
  int per_unit;  // 1 or 2
};

// HD: the shared tiles' head width (64-column atoms covering D and Dv); BK:
// keys a tile. Byte offsets from the 1024-aligned base of shared memory.
// Up to HD = 128 the output is staged in a tile of its own, so that the
// next item's Q loads while this item's output is stored; at HD = 256 it
// is staged in the Q tile.
template <int HD, int BK>
struct Smem {
  static constexpr int kAtoms = HD / 64;
  static constexpr int kQAtom = kBQ * 128;
  static constexpr int kKVAtom = BK * 128;
  static constexpr bool kOwnO = HD <= 128;
  static constexpr int kQ = 0;
  static constexpr int kO = kOwnO ? kQ + kAtoms * kQAtom : kQ;
  static constexpr int kK = kO + kAtoms * kQAtom;
  static constexpr int kV = kK + kStages * kAtoms * kKVAtom;
  // barriers: q_full, q_empty, then k_full, v_full, k_empty and v_empty
  // for each stage
  static constexpr int kBar = kV + kStages * kAtoms * kKVAtom;
  static constexpr size_t kBytes = 1024 + kBar + 8 * (2 + 4 * kStages);
};

// One work item: the query tile of 128 rows at q0 of batch b, head h, and
// the KV tiles t_lo .. t_hi - 1 that its causal and window bands reach.
// Blocks take work units in turn (unit blockIdx.x, + gridDim.x, ...), head
// by head, so that the blocks running at one time share the K and V of a
// few heads (and the heads of a GQA group) in L2. Where there are at least
// as many pairs of query tiles as SMs, a unit is the pair (n_qt - 1 - r,
// r) of a head, which weighs the same for every r under the causal band;
// otherwise it is one query tile, the heaviest first. Returns false for
// the second half of the middle pair of an odd n_qt.
struct Item {
  int b, h, q0, t_lo, t_hi;
};

template <int BK>
__device__ __forceinline__ bool decode(const Args& p, int u, int half,
                                       Item& x) {
  const int n_qt = (p.S + kBQ - 1) / kBQ;
  const int per_head = p.per_unit == 2 ? (n_qt + 1) / 2 : n_qt;
  const int bh = u / per_head, r = u - bh * per_head;
  const int qt = half ? r : n_qt - 1 - r;
  if (half && qt == n_qt - 1 - r) return false;
  x.b = bh / p.H;
  x.h = bh - x.b * p.H;
  x.q0 = qt * kBQ;
  const int q_last = min(x.q0 + kBQ, p.S) - 1;
  const int kv_hi = p.causal ? q_last + 1 : p.S;
  const int kv_lo = p.window > 0 ? max(x.q0 - p.window + 1, 0) : 0;
  x.t_lo = kv_lo / BK;
  x.t_hi = (kv_hi + BK - 1) / BK;
  return true;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// o += P V for one 64-column atom of V that holds n (8..64) real columns:
// a product n wide, so the zero-filled columns past Dv are not multiplied
__device__ __forceinline__ void pv_atom(float (&o)[32], const uint32_t (&p)[4],
                                        uint64_t v, int n) {
  switch (n) {
    case 8: wgmma_rs_tb(reinterpret_cast<float(&)[4]>(o), p, v, 1); break;
    case 16: wgmma_rs_tb(reinterpret_cast<float(&)[8]>(o), p, v, 1); break;
    case 24: wgmma_rs_tb(reinterpret_cast<float(&)[12]>(o), p, v, 1); break;
    case 32: wgmma_rs_tb(reinterpret_cast<float(&)[16]>(o), p, v, 1); break;
    case 40: wgmma_rs_tb(reinterpret_cast<float(&)[20]>(o), p, v, 1); break;
    case 48: wgmma_rs_tb(reinterpret_cast<float(&)[24]>(o), p, v, 1); break;
    case 56: wgmma_rs_tb(reinterpret_cast<float(&)[28]>(o), p, v, 1); break;
    default: wgmma_rs_tb(o, p, v, 1); break;
  }
}

// S = Q K^T for one warpgroup: 64 rows x BK keys, `ksteps` k-steps of 16
// columns (D deep, not HD) from the warpgroup's Q rows at q and the K
// stage at k
template <int HD, int BK>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], uint32_t q,
                                         uint32_t k, int ksteps) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    if (kk < ksteps) {
      const uint32_t col = (kk % 4) * 32;  // 16 columns a step
      wgmma_ss(sc, desc_sw128(q + (kk / 4) * kBQ * 128 + col),
               desc_sw128(k + (kk / 4) * BK * 128 + col), kk > 0);
    }
}

// O += P V, Dv columns wide: the V stage at v is an N-major B operand;
// P's keys 16kc..16kc+15 are pa[kc]. At Dv = 128 (kWide) one product
// spans both atoms of V (LBO: the bytes from one to the next); otherwise
// each atom is a product of its own.
template <int kAtoms, int BK, bool kWide>
__device__ __forceinline__ void issue_pv(float (&o)[kAtoms][32],
                                         const uint32_t (&pa)[BK / 16][4],
                                         uint32_t v, int pv_atoms,
                                         int v_last) {
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) {
    if constexpr (kWide) {
      static_assert(kAtoms == 2, "two atoms of V");
      wgmma_rs_tb(reinterpret_cast<float(&)[64]>(o), pa[kc],
                  desc_sw128(v + kc * 16 * 128, BK * 128), 1);
    } else {
#pragma unroll
      for (int a = 0; a < kAtoms; ++a)
        if (a < pv_atoms)
          pv_atom(o[a], pa[kc],
                  desc_sw128(v + a * BK * 128 + kc * 16 * 128),
                  a + 1 < pv_atoms ? 64 : v_last);
    }
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one score tile (raw Q K^T in sc), two rows a lane
// (rows r0 and r0 + 8, keys k0 + 8j + 2 (lane % 4) and the next): m, l and
// corr in the log2 domain of the scaled scores, P packed to bf16 A
// fragments. A tile inside the band and S (kEdge false) takes max and
// exponent from the raw scores, scale folded into one fma; a tile on an
// edge scales first and sets what the mask drops to the -1e30 sentinel, so
// a row masked so far takes p = 1 and is wiped by corr = 0 later, as in
// the reference.
template <int BK, bool kEdge>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2],
                                             uint32_t (&pa)[BK / 16][4],
                                             const Args& p, int r0, int k0,
                                             int lane) {
  if (kEdge) {
    // key k0 + kb + col (col = 8j + e % 2, known at compile time) is kept
    // for row r0 + 8 (e / 2) where lo[e / 2] <= col <= hi[e / 2]
    const int kb = k0 + (lane % 4) * 2;
    int lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qp = r0 + 8 * r;
      hi[r] = p.S - 1 - kb;
      if (p.causal) hi[r] = min(hi[r], qp - kb);
      lo[r] = p.window > 0 ? qp - kb - p.window + 1 : -(1 << 30);
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + e % 2;
        const bool ok = col >= lo[e / 2] && col <= hi[e / 2];
        sc[4 * j + e] = ok ? sc[4 * j + e] * p.scale : kNegInf;
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(m[r], kEdge ? mx : mx * p.scale);
    corr[r] = ex2(m[r] - mx);
    m[r] = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        const float x = sc[4 * j + e];
        sc[4 * j + e] = ex2(kEdge ? x - mx : x * p.scale - mx);  // one FFMA
        sum += sc[4 * j + e];
      }
    l[r] = l[r] * corr[r] + sum;
  }
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[kc][i] = pack_bf16(sc[8 * kc + 2 * i], sc[8 * kc + 2 * i + 1]);
}

// KS: k-steps of Q K^T (ceil(D / 16)); VN: columns of P V (Dv); 0 = taken
// from the arguments. The common widths get their own instantiation, so
// that their products run without branches between them. A block stays on
// its SM and takes work units in turn (see decode); the K/V ring and the
// barriers' phases run on across items.
template <int HD, int BK, int KS, int VN>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap to, Args p) {
  using L = Smem<HD, BK>;
  constexpr int kAtoms = L::kAtoms;
  constexpr bool kWidePV = VN == 128 && kAtoms == 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const smem = smem_raw + (base - raw);
  const uint32_t q_full = base + L::kBar, q_empty = q_full + 8;
  auto k_full = [&](int s) { return q_full + 8 * (2 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (2 + kStages + s); };
  auto k_empty = [&](int s) { return q_full + 8 * (2 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return q_full + 8 * (2 + 3 * kStages + s); };
  const int S = p.S;
  // atoms that hold columns of q and k (D) and of v and o (Dv)
  const int k_atoms = (p.D + 63) / 64, v_atoms = (p.Dv + 63) / 64;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);  // lane 0 of each consumer warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 8);
      mbar_init(v_empty(s), 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // the producer: one thread keeps the ring of K and V tiles full, and
    // loads each item's Q once the last one's is free
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_map(&tq);
      prefetch_map(&tk);
      prefetch_map(&tv);
      prefetch_map(&to);
      int it = 0;  // KV tiles through the ring so far
      int round = 0;  // items so far
      for (int k = 0;; ++k) {  // the block's item slots, unit by unit
        const int u = blockIdx.x + k / p.per_unit * gridDim.x;
        if (u >= p.units) break;
        Item x;
        if (!decode<BK>(p, u, k % p.per_unit, x)) continue;
        const int hk = x.h / p.group;
        for (int t = x.t_lo; t < x.t_hi; ++t, ++it) {
          const int s = it % kStages, parity = ((it / kStages) & 1) ^ 1;
          mbar_wait(k_empty(s), parity);
          mbar_expect_tx(k_full(s), k_atoms * L::kKVAtom);
          for (int a = 0; a < k_atoms; ++a)
            tma_load(base + L::kK + (s * kAtoms + a) * L::kKVAtom, &tk,
                     k_full(s), 64 * a, t * BK, hk, x.b);
          if (t == x.t_lo) {  // Q after the item's first K
            mbar_wait(q_empty, (round & 1) ^ 1);
            mbar_expect_tx(q_full, k_atoms * L::kQAtom);
            for (int a = 0; a < k_atoms; ++a)
              tma_load(base + L::kQ + a * L::kQAtom, &tq, q_full, 64 * a,
                       x.q0, x.h, x.b);
          }
          mbar_wait(v_empty(s), parity);
          mbar_expect_tx(v_full(s), v_atoms * L::kKVAtom);
          for (int a = 0; a < v_atoms; ++a)
            tma_load(base + L::kV + (s * kAtoms + a) * L::kKVAtom, &tv,
                     v_full(s), 64 * a, t * BK, hk, x.b);
        }
        ++round;
      }
    }
  } else {
    // a consumer warpgroup: 64 query rows of each item
    setmaxnreg_inc<kConsumerRegs>();
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int ksteps = KS > 0 ? KS : (p.D + 15) / 16;  // D deep, not HD
    const int dv = VN > 0 ? VN : p.Dv;
    const int pv_atoms = (dv + 63) / 64;
    const int v_last = dv - 64 * (pv_atoms - 1);  // columns of the last atom
    const uint32_t q_rows = base + L::kQ + c * 64 * 128;
    const uint32_t o_rows = base + L::kO + c * 64 * 128;
    auto k_stage = [&](int s) {
      return base + L::kK + s * kAtoms * L::kKVAtom;
    };
    auto v_stage = [&](int s) {
      return base + L::kV + s * kAtoms * L::kKVAtom;
    };
    // The two consumers take turns at the tensor cores: one issues its
    // products (Q K^T of tile i and P V of tile i - 1) while the other runs
    // its softmax. A turn starts at bar.sync on the warpgroup's own barrier
    // (3 or 4) and ends with bar.arrive on the other's; in each item
    // consumer 0 goes first, and consumer 1 leaves out its last arrive, so
    // that every barrier phase has its 256 threads.
    auto turn_begin = [&] { named_sync(3 + c, 256); };
    auto turn_end = [&] { named_arrive(3 + (c ^ 1), 256); };

    int it = 0;  // KV tiles through the ring so far
    int round = 0;  // items so far
    for (int k = 0;; ++k) {  // the same slots as the producer's
      const int u = blockIdx.x + k / p.per_unit * gridDim.x;
      if (u >= p.units) break;
      Item x;
      if (!decode<BK>(p, u, k % p.per_unit, x)) continue;
      const int qc = x.q0 + 64 * c;               // the warpgroup's first row
      const int r0 = qc + warp * 16 + lane / 4;   // this lane's rows r0, r0 + 8
      const int n = x.t_hi - x.t_lo;
      auto stage = [&](int i) { return (it + i) % kStages; };
      auto phase = [&](int i) { return ((it + i) / kStages) & 1; };
      // does tile t cross an edge of the band or S for this warpgroup's rows?
      auto edge = [&](int t) {
        const int k0 = t * BK;
        return k0 + BK > S || (p.causal && k0 + BK - 1 > qc) ||
               (p.window > 0 && qc + 63 - k0 >= p.window);
      };
      auto softmax = [&](float (&sc)[BK / 2], float (&m)[2], float (&l)[2],
                         float (&corr)[2], uint32_t (&pa)[BK / 16][4],
                         int t) {
        if (edge(t))
          softmax_tile<BK, true>(sc, m, l, corr, pa, p, r0, t * BK, lane);
        else
          softmax_tile<BK, false>(sc, m, l, corr, pa, p, r0, t * BK, lane);
      };
      if (c == 1) turn_end();

      float o[kAtoms][32];
#pragma unroll
      for (int a = 0; a < kAtoms; ++a)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[a][i] = 0.f;
      float m[2] = {kNegInf, kNegInf};
      float l[2] = {0.f, 0.f};  // this lane's share; the quad's at the end
      float sc[BK / 2], corr[2];
      uint32_t pa[BK / 16][4], pb[BK / 16][4];

      // tile 0: Q K^T alone
      mbar_wait(q_full, round & 1);
      mbar_wait(k_full(stage(0)), phase(0));
      turn_begin();
      wgmma_fence();
      issue_qk<HD, BK>(sc, q_rows, k_stage(stage(0)), ksteps);
      wgmma_commit();
      turn_end();
      wgmma_wait<0>();
      fence_regs(sc);
      if (lane == 0) {
        mbar_arrive(k_empty(stage(0)));  // this warp is done with K
        if (L::kOwnO && n == 1) mbar_arrive(q_empty);  // ... and with Q
      }
      softmax(sc, m, l, corr, pa, x.t_lo);

      // tile i: Q K^T of tile i and P V of tile i - 1 in one turn; the
      // softmax of tile i runs while P V finishes. P alternates between
      // two sets of registers, so that no register a product in flight
      // reads is written before it completes.
      auto step = [&](int i, const uint32_t (&p_prev)[BK / 16][4],
                      uint32_t (&p_next)[BK / 16][4]) {
        const int s = stage(i), sp = stage(i - 1);
        mbar_wait(k_full(s), phase(i));
        mbar_wait(v_full(sp), phase(i - 1));
#pragma unroll
        for (int a = 0; a < kAtoms; ++a) fence_regs(o[a]);
        turn_begin();
        wgmma_fence();
        issue_qk<HD, BK>(sc, q_rows, k_stage(s), ksteps);
        wgmma_commit();
        issue_pv<kAtoms, BK, kWidePV>(o, p_prev, v_stage(sp), pv_atoms,
                                      v_last);
        wgmma_commit();
        turn_end();
        wgmma_wait<1>();
        fence_regs(sc);
        if (lane == 0) {
          mbar_arrive(k_empty(s));  // K of tile i is read
          if (L::kOwnO && i == n - 1) mbar_arrive(q_empty);  // and Q
        }
        softmax(sc, m, l, corr, p_next, x.t_lo + i);
        wgmma_wait<0>();
#pragma unroll
        for (int a = 0; a < kAtoms; ++a) fence_regs(o[a]);
        if (lane == 0) mbar_arrive(v_empty(sp));  // V of tile i - 1 is read
#pragma unroll
        for (int a = 0; a < kAtoms; ++a)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            o[a][4 * j] *= corr[0];
            o[a][4 * j + 1] *= corr[0];
            o[a][4 * j + 2] *= corr[1];
            o[a][4 * j + 3] *= corr[1];
          }
      };
      // P V of the last tile, whose P is p_last
      auto last = [&](const uint32_t (&p_last)[BK / 16][4]) {
        const int sl = stage(n - 1);
        mbar_wait(v_full(sl), phase(n - 1));
#pragma unroll
        for (int a = 0; a < kAtoms; ++a) fence_regs(o[a]);
        turn_begin();
        wgmma_fence();
        issue_pv<kAtoms, BK, kWidePV>(o, p_last, v_stage(sl), pv_atoms,
                                      v_last);
        wgmma_commit();
        if (c == 0) turn_end();
        wgmma_wait<0>();
#pragma unroll
        for (int a = 0; a < kAtoms; ++a) fence_regs(o[a]);
        if (lane == 0) mbar_arrive(v_empty(sl));
      };
      int i = 1;
      for (; i + 1 < n; i += 2) {
        step(i, pa, pb);
        step(i + 1, pb, pa);
      }
      if (i < n) {
        step(i, pa, pb);
        last(pb);
      } else {
        last(pa);
      }
      it += n;

      // normalise, stage the warpgroup's 64 rows as bf16 (swizzled as TMA
      // reads them) once its last store has read the tile, and store them
      // by TMA; rows past S and columns past Dv are not written
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float sum = l[r];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        inv[r] = 1.f / fmaxf(sum, 1e-30f);
      }
      if (L::kOwnO) {
        if (tid == 0) tma_store_wait_read();
        named_sync(1 + c, 128);
      }
#pragma unroll
      for (int a = 0; a < kAtoms; ++a) {
        if (a < pv_atoms) {
          unsigned char* tile =
              smem + L::kO + a * L::kQAtom + c * 64 * 128;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int row = warp * 16 + lane / 4 + 8 * r;
              *reinterpret_cast<uint32_t*>(
                  tile + swizzle128(row, j * 16 + (lane % 4) * 4)) =
                  pack_bf16(o[a][4 * j + 2 * r] * inv[r],
                            o[a][4 * j + 2 * r + 1] * inv[r]);
            }
        }
      }
      fence_async_shared();
      named_sync(1 + c, 128);
      if (tid == 0 && qc < S) {
        for (int a = 0; a < pv_atoms; ++a)
          tma_store(&to, o_rows + a * L::kQAtom, 64 * a, qc, x.h, x.b);
        tma_store_commit();
      }
      if (!L::kOwnO) {  // the output tile is the Q tile: free it when read
        if (tid == 0) tma_store_wait_read();
        named_sync(1 + c, 128);
        if (lane == 0) mbar_arrive(q_empty);
      }
      ++round;
    }
    if (tid == 0) tma_store_wait_read();
  }
}

// One launch: a block of 384 threads per SM (fewer where there are fewer
// work units), each taking units in turn.
template <int HD, int BK, int KS = 0, int VN = 0>
int launch(const Params& p, int B, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  const int Hk = p.H / p.group;
  int err = make_map(&tq, p.q, p.D, p.S, p.H, B, 2 * p.q_ss, 2 * p.q_sh,
                     2 * p.q_sb, kBQ);
  if (!err)
    err = make_map(&tk, p.k, p.D, p.S, Hk, B, 2 * p.k_ss, 2 * p.k_sh,
                   2 * p.k_sb, BK);
  if (!err)
    err = make_map(&tv, p.v, p.Dv, p.S, Hk, B, 2 * p.v_ss, 2 * p.v_sh,
                   2 * p.v_sb, BK);
  if (!err)
    err = make_map(&to, p.o, p.Dv, p.S, p.H, B, 2 * p.o_ss, 2 * p.o_sh,
                   2 * p.o_sb, 64);
  if (err) return err;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_qt = (p.S + kBQ - 1) / kBQ;
  const int pairs = B * p.H * ((n_qt + 1) / 2);
  const int per_unit = pairs >= sms ? 2 : 1;
  const int units = per_unit == 2 ? pairs : B * p.H * n_qt;
  const Args args{B,        p.H,      p.group, p.S,   p.D,   p.Dv,
                  p.scale * 1.4426950408889634f,    p.causal,
                  p.window, units,    per_unit};
  const size_t smem = Smem<HD, BK>::kBytes;
  e = cudaFuncSetAttribute(flash_fwd_wgmma<HD, BK, KS, VN>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = units < sms ? units : sms;
  flash_fwd_wgmma<HD, BK, KS, VN>
      <<<blocks, kThreads, smem, stream>>>(tq, tk, tv, to, args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// bf16 tiles: 99,408 bytes of shared memory at HD = 64 (128-key tiles),
// 197,712 at 128 (128 keys) and at 256 (64 keys); 384 threads a block.
int launch_wgmma(const Params& p, int B, cudaStream_t stream) {
  if (p.D % 8 || p.Dv % 8) return static_cast<int>(cudaErrorInvalidValue);
  const int hd = p.D > p.Dv ? p.D : p.Dv;
  if (hd <= 64) {
    if (p.D == 64 && p.Dv == 64)
      return wg::launch<64, 128, 4, 64>(p, B, stream);
    return wg::launch<64, 128>(p, B, stream);
  }
  if (hd <= 128) {
    if (p.D == 128 && p.Dv == 128)
      return wg::launch<128, 128, 8, 128>(p, B, stream);
    if (p.D == 96 && p.Dv == 64)  // MLA: 64 nope + 32 rope; v 64
      return wg::launch<128, 128, 6, 64>(p, B, stream);
    return wg::launch<128, 128>(p, B, stream);
  }
  if (p.D == 256 && p.Dv == 256)
    return wg::launch<256, 64, 16, 256>(p, B, stream);
  return wg::launch<256, 64>(p, B, stream);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B,H,S,D), k (B,Hk,S,D), v (B,Hk,S,Dv), o (B,H,S,Dv), each given by its
// batch/head/seq strides in elements with a unit last stride; 16-byte
// aligned pointers, strides and head dims multiples of 16 bytes.
// dtype: 0 = float32 (flash_fwd_tf32), 1 = bfloat16 (flash_fwd_wgmma).
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
  if (dtype == 1) return launch_wgmma(p, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
