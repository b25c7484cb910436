// Causal / sliding-window flash-attention forward, for sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention
// (_flash_kernel), the Pallas forward softmax attention in (B, H, S, D)
// layout. The port's gemma3 prefill attention runs through it.
//
// Bound on the H100: operations. At the gemma3-1b prefill shapes (S=1024,
// head_dim 256) a causal head costs about 2*S*S*D flops (half of the full
// 4*S*S*D) for 4*S*D elements of input and output, hundreds of flops per
// byte, far above the card's ~20 flop/byte ridge for f32 CUDA cores. Design (simple and right first; no wgmma/TMA yet):
//   - one thread block per (batch*head, 64-row query tile); the KV loop
//     inside the block replaces the TPU's sequential grid dimension, and is
//     bounded to the causal band and the window band, so the work follows
//     the mask rather than the full S x S matrix;
//   - the scaled Q tile and one 64-row K tile and V tile are staged in
//     shared memory as f32 (213,760 bytes at D = Dv = 256, hence dynamic
//     shared memory and cudaFuncSetAttribute); rows are padded by one
//     float so the 16x16 thread grid reads them without bank conflicts;
//   - each thread owns a 4x4 block of scores and 4 rows x Dv/16 columns of
//     the f32 accumulator in registers; row max and row sum are taken with
//     xor shuffles across the 16 threads of a row, so every thread of a
//     row holds bit-identical m and l;
//   - online softmax in f32 with the finite -1e30 sentinel (a fully masked
//     row stays finite), l clamped at 1e-30, output cast to q's dtype;
//   - GQA reads kv head h / (H / Hk) directly instead of a copy, any
//     strides with a unit last dimension, any S (the ragged last tile is
//     masked), Dv != D, f32 and bf16 inputs.

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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

size_t smem_bytes(int D, int Dv) {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (D + 1) +
                          static_cast<size_t>(kBK) * (D + 1) +
                          static_cast<size_t>(kBK) * Dv +
                          static_cast<size_t>(kBQ) * (kBK + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
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

template <typename T>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.D, p.Dv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * p.H, (p.S + kBQ - 1) / kBQ);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

long long flash_attention_smem_bytes(int D, int Dv) {
  return static_cast<long long>(smem_bytes(D, Dv));
}

// q (B,H,S,D), k (B,Hk,S,D), v (B,Hk,S,Dv), o (B,H,S,Dv), each given by its
// batch/head/seq strides in elements with a unit last stride.
// dtype: 0 = float32, 1 = bfloat16. window <= 0: no window.
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
  if (dtype == 0) return launch<float>(p, B, st);
  if (dtype == 1) return launch<__nv_bfloat16>(p, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
