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
// 0.045 ms at 3.35 TB/s. Two kernels, one for each dtype:
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
// flash_fwd_simt, f32 (kept until a 3xTF32 mma.sync path keeps f32 parity):
//   - same grid and bands; the scaled Q tile and one 64-row K tile and V
//     tile are staged in shared memory as f32 (213,760 bytes at D = Dv =
//     256, hence dynamic shared memory and cudaFuncSetAttribute); rows are
//     padded by one float so the 16x16 thread grid reads them without bank
//     conflicts;
//   - each thread owns a 4x4 block of scores and 4 rows x Dv/16 columns of
//     the f32 accumulator in registers, f32 FMAs on CUDA cores; row max and
//     row sum are xor shuffles across the 16 threads of a row, so every
//     thread of a row holds bit-identical m and l;
//   - online softmax in f32 with the finite -1e30 sentinel, l clamped at
//     1e-30.
// Both read kv head h / (H / Hk) directly instead of a copy (GQA), take any
// S (the ragged last tile is masked), Dv != D, and strided q, k, v with a
// unit last dimension; the bf16 kernel also needs 16-byte aligned pointers
// and row strides, which the wrapper checks.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 64;   // keys per KV tile
constexpr int kTX = 16;   // threads along keys / value columns
constexpr int kTY = 16;   // threads along query rows
constexpr int kThreads = kTX * kTY;
constexpr int kRows = kBQ / kTY;   // query rows per thread
constexpr int kKeys = kBK / kTX;   // keys per thread
constexpr int kMaxD = 256;
constexpr int kMaxVJ = kMaxD / kTX;  // value columns per thread
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
};

// ---------------------------------------------------------------------------
// f32: flash_fwd_simt
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

size_t smem_bytes(int D, int Dv) {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (D + 1) +
                          static_cast<size_t>(kBK) * (D + 1) +
                          static_cast<size_t>(kBK) * Dv +
                          static_cast<size_t>(kBQ) * (kBK + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_simt(Params p) {
  extern __shared__ float smem[];
  const int ld = p.D + 1;         // padded row stride of the Q and K tiles
  const int lp = kBK + 1;         // padded row stride of the P tile
  float* Qs = smem;               // kBQ x ld
  float* Ks = Qs + kBQ * ld;      // kBK x ld
  float* Vs = Ks + kBK * ld;      // kBK x Dv
  float* Ps = Vs + kBK * p.Dv;    // kBQ x lp

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int hk = h / p.group;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int S = p.S, D = p.D, Dv = p.Dv;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const int qp = q0 + r;
    Qs[r * ld + d] = qp < S ? to_f32(q[qp * p.q_ss + d]) * p.scale : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kMaxVJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxVJ; ++j) acc[i][j] = 0.f;
  }
  const int nvj = (Dv + kTX - 1) / kTX;

  // KV tiles that the causal band and the window band reach
  const int q_last = min(q0 + kBQ, S) - 1;
  const int kv_hi = p.causal ? q_last + 1 : S;
  const int kv_lo = p.window > 0 ? max(q0 - p.window + 1, 0) : 0;
  const int t_lo = kv_lo / kBK;
  const int t_hi = (kv_hi + kBK - 1) / kBK;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, d = idx - r * D;
      const int kp = k0 + r;
      Ks[r * ld + d] = kp < S ? to_f32(k[kp * p.k_ss + d]) : 0.f;
    }
    for (int idx = tid; idx < kBK * Dv; idx += kThreads) {
      const int r = idx / Dv, d = idx - r * Dv;
      const int kp = k0 + r;
      Vs[r * Dv + d] = kp < S ? to_f32(v[kp * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(ty + kTY * i) * ld + d];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kv[j] = Ks[(tx + kTX * j) * ld + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + kTY * i;
      const int qp = q0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int kp = k0 + tx + kTX * j;
        const bool ok = kp < S && (!p.causal || kp <= qp) &&
                        (p.window <= 0 || qp - kp < p.window);
        if (!ok) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float pj = expf(s[i][j] - m_new);
        Ps[r * lp + tx + kTX * j] = pj;
        sum += pj;
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kMaxVJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();  // the P tile is complete

    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(ty + kTY * i) * lp + kk];
#pragma unroll
      for (int j = 0; j < kMaxVJ; ++j) {
        if (j < nvj) {
          const int c = tx + kTX * j;
          const float vv = c < Dv ? Vs[kk * Dv + c] : 0.f;
#pragma unroll
          for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + ty + kTY * i;
    if (qp >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kMaxVJ; ++j) {
      const int c = tx + kTX * j;
      if (j < nvj && c < Dv) store(o + qp * p.o_ss + c, acc[i][j] / denom);
    }
  }
}

int launch_simt(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.D, p.Dv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_simt<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * p.H, (p.S + kBQ - 1) / kBQ);
  flash_fwd_simt<float><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

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

// ROWS rows of `cols` (a multiple of 8) bf16 from global rows row0.. of
// stride ss into a tile of HD + kPad columns; rows >= S and columns >= cols
// are zero-filled.
template <int ROWS, int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long ss, int row0, int S,
                                          int cols) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks a row
  static_assert(ROWS * kChunks % kThreads == 0, "whole rounds of copies");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / kChunks, col = (c - r * kChunks) * 8;
    const bool ok = row0 + r < S && col < cols;
    const __nv_bfloat16* g = ok ? src + (row0 + r) * ss + col : src;
    cp_async16(saddr(dst + r * (HD + kPad) + col), g, ok);
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

  load_tile<kBQ, HD>(Qs, q, p.q_ss, q0, S, p.D);
  if (t_lo < t_hi) {
    load_tile<BK, HD>(Ks, k, p.k_ss, t_lo * BK, S, p.D);
    load_tile<BK, HD>(Vs, v, p.v_ss, t_lo * BK, S, p.Dv);
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
                        p.D);
      load_tile<BK, HD>(Vs + (buf ^ 1) * T::kKV, v, p.v_ss, (t + 1) * BK, S,
                        p.Dv);
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

template <int HD, int BK>
int launch(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t smem = Tile<HD, BK>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma<HD, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * p.H, (p.S + kBQ - 1) / kBQ);
  flash_fwd_mma<HD, BK><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mma

int launch_mma(const Params& p, int B, cudaStream_t stream) {
  if (p.D % 8 || p.Dv % 8) return static_cast<int>(cudaErrorInvalidValue);
  const int hd = p.D > p.Dv ? p.D : p.Dv;
  if (hd <= 64) return mma::launch<64, 64>(p, B, stream);
  if (hd <= 128) return mma::launch<128, 64>(p, B, stream);
  return mma::launch<256, 32>(p, B, stream);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of the f32 kernel (the bf16 kernel's tiles take at
// most 101,376 bytes).
long long flash_attention_smem_bytes(int D, int Dv) {
  return static_cast<long long>(smem_bytes(D, Dv));
}

// q (B,H,S,D), k (B,Hk,S,D), v (B,Hk,S,Dv), o (B,H,S,Dv), each given by its
// batch/head/seq strides in elements with a unit last stride.
// dtype: 0 = float32 (flash_fwd_simt), 1 = bfloat16 (flash_fwd_mma: D and
// Dv multiples of 8, 16-byte aligned pointers, strides multiples of 8).
// window <= 0: no window.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int H, int Hk, int S, int D, int Dv,
                        long long q_sb, long long q_sh, long long q_ss,
                        long long k_sb, long long k_sh, long long k_ss,
                        long long v_sb, long long v_sh, long long v_ss,
                        long long o_sb, long long o_sh, long long o_ss,
                        float scale, int causal, int window, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (Hk <= 0 || H % Hk || D <= 0 || D > kMaxD || Dv <= 0 || Dv > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,    k,    v,    o,    H,    H / Hk, S,    D,    Dv,
           q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,   v_sb, v_sh, v_ss,
           o_sb, o_sh, o_ss, scale, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_simt(p, B, st);
  if (dtype == 1) return launch_mma(p, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
