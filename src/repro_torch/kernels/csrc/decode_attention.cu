// GQA decode attention: one query row a sequence against its KV cache, for
// sm_90a.
//
// Replaces no TPU kernel. The JAX package's decode attention
// (src/repro/models/attention.py, decode_attention) is jnp, which XLA
// fuses; the port's plain version (kernels/ref.py, decode_attention_ref)
// repeats the cache over each KV head's G query heads, casts it to f32 and
// runs two einsums, some twenty times the cache's bytes in fresh tensors a
// layer. This kernel takes its place on the card, for every attention layer
// of every GQA or MHA model the port serves.
//
// Bound on the H100: bytes. A step reads each live cache row of K and V
// once (B * Hk * n * 2 * D elements for n live positions) and does 2 * G
// flops an element read (Q K^T and P V): 4 flop/byte in bf16 at G = 4, far
// below the ~20 flop/byte at which even the f32 CUDA cores would bound it.
// At mistral-nemo-12b's chat shape (bf16, B = 48, H = 32, Hk = 8, D = 128,
// 1,089 live positions) that is 214 MB a layer, 0.064 ms at 3.35 TB/s.
// What the design does about it: it moves no byte twice.
//   - One block of 128 threads a (batch row, KV head, head group, split).
//     It reads its KV head's rows once for all GT query heads of its group
//     (GT = G rounded up to 1, 4 or 8; a G above 8 takes head groups of
//     8, each reading the rows again), in the cache's own dtype.
//   - Rows stream through a ring of shared-memory stages (K and V tiles of
//     T positions, at most 16 KB a stage), filled by 16-byte cp.async
//     copies, neighbouring threads on neighbouring bytes of a row, with all
//     but one stage in flight while one is computed.
//   - Positions above cur_pos[b] (read on the card: no host sync) or outside
//     the window are never read: the plain version gives them weight exactly
//     0 (exp(-1e30 - m) is 0 in f32). A tile's rows past the block's range
//     are zero-filled in shared memory instead of read.
//   - L lanes share a row, E = D / L elements each, read from shared memory
//     as 16-byte units (4-byte ones where a lane's share is not a multiple
//     of 16 bytes, D = 160), lane c taking units c, c + L, ..., so that a
//     warp's loads hit distinct banks. The block's 128 / L row groups take a
//     tile's rows in turn, each row group with an online softmax of its own
//     (f32 max, sum, and output over its lanes' columns for the GT heads),
//     so that no barrier stands between a tile's scores and its P V. A
//     row's dot products are summed over its L lanes by shuffles; exponents
//     are taken in the log2 domain. The row groups merge once, at the end,
//     through shared memory. Every multiply and add is written out (fmaf,
//     __fmul_rn, __fadd_rn), none left for the compiler to contract, and
//     a head's sums do not depend on its group: the same inputs give the
//     same bits in any grouping.
//   - No tensor cores. At 2 * G flop/byte the CUDA cores are not the limit,
//     and P V on wgmma would round P to bf16, where the plain version keeps
//     it in f32. Products of bf16 values are exact in f32 and every sum is
//     f32, as in the plain version: only the order of the sums differs.
//   - Split-KV ("flash-decoding") where B * Hk * head groups blocks leave the
//     card short of work (the wrapper picks the count from the SM count and
//     the cache's length): each split writes its f32 max, sum and
//     unnormalised output, and a second kernel merges them and rounds once
//     to q's dtype. The C call launches both.
// Instantiations: the cache in bf16 or f32, D in {16, 32, 64, 128, 160,
// 256} (the reduced test configurations; musicgen; mistral, phi3.5, qwen,
// deepseek, Jamba; stablelm; gemma3), GT in {1, 4, 8}. q and the output
// may be bf16 or f32 whatever the cache's dtype; q is read once a block.

#include <atomic>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStageBytes = 16384;  // K and V tiles of one stage, at most
constexpr int kStages = 4;  // three tiles in flight while one is computed
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;

// The return value of a call whose cache breaks the layout rule (not a
// cudaError_t): the wrapper then names the tensor and the rule.
constexpr int kBadLayout = -1;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const long long* pos;
  float* part_o;   // (splits, B, H, D) unnormalised outputs, splits > 1
  float* part_ml;  // (splits, B, H, 2) max (log2 domain) and sum
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int q_bf16, B, H, Hk, G, S, window, splits, groups;
  float scale;
};

// How a row of D elements of KT is shared by L lanes.
template <typename KT, int D, int L>
struct Lanes {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(KT));
  static constexpr int kLaneBytes = kRowBytes / L;
  static constexpr int kUnit = kLaneBytes % 16 == 0 ? 16 : 4;
  static constexpr int kUnits = kLaneBytes / kUnit;  // a lane's units
  static constexpr int kPerUnit = kUnit / static_cast<int>(sizeof(KT));
  static constexpr int E = D / L;
  static_assert(kRowBytes % (L * 4) == 0 && kRowBytes % 16 == 0,
                "a lane's share is whole 4-byte words, a row 16-byte chunks");
  static_assert(L <= 32 && (L & (L - 1)) == 0, "a row's lanes in one warp");
  // the column of lane c's e-th element: lane c owns units c, c + L, ...
  __device__ static constexpr int col(int c, int e) {
    return ((e / kPerUnit) * L + c) * kPerUnit + e % kPerUnit;
  }
};

__device__ __forceinline__ void unpack(uint32_t w, float* x, float) {
  x[0] = __uint_as_float(w);
}

__device__ __forceinline__ void unpack(uint32_t w, float* x, __nv_bfloat16) {
  x[0] = __uint_as_float(w << 16);  // bf16 is the top half of an f32
  x[1] = __uint_as_float(w & 0xffff0000u);
}

// Lane c's E elements of a row in shared memory, as f32.
template <typename KT, int D, int L>
__device__ __forceinline__ void load_lane(const KT* row, int c,
                                          float (&x)[D / L]) {
  using S = Lanes<KT, D, L>;
  constexpr int kPerWord = 4 / static_cast<int>(sizeof(KT));
  const char* base = reinterpret_cast<const char*>(row) + c * S::kUnit;
#pragma unroll
  for (int j = 0; j < S::kUnits; ++j) {
    const char* p = base + j * L * S::kUnit;
    if constexpr (S::kUnit == 16) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      float* y = x + j * S::kPerUnit;
      unpack(u.x, y, KT());
      unpack(u.y, y + kPerWord, KT());
      unpack(u.z, y + 2 * kPerWord, KT());
      unpack(u.w, y + 3 * kPerWord, KT());
    } else {
      unpack(*reinterpret_cast<const uint32_t*>(p), x + j * S::kPerUnit,
             KT());
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float load_q(const Params& p, long long at) {
  return p.q_bf16 ? __bfloat162float(
                        static_cast<const __nv_bfloat16*>(p.q)[at])
                  : static_cast<const float*>(p.q)[at];
}

__device__ __forceinline__ void store_o(const Params& p, long long at,
                                        float x) {
  if (p.q_bf16)
    static_cast<__nv_bfloat16*>(p.o)[at] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(p.o)[at] = x;
}

// Rows a row group takes from a stage: 4, fewer where a stage would pass
// kStageBytes. Not a function of GT, so that a head's sums run in the same
// order whatever group it is computed in (a DTensor's local shard may hold
// the kv heads expanded, G = 1, where the plain tensor has G = 4).
template <typename KT, int D, int L>
constexpr int rows_per_group() {
  constexpr int r = kThreads / L;
  constexpr int fit = kStageBytes / (r * 2 * D * static_cast<int>(sizeof(KT)));
  return fit < 1 ? 1 : (fit < 4 ? fit : 4);
}

template <typename KT, int D, int L, int GT>
struct Config {
  static constexpr int R = kThreads / L;  // row groups
  static constexpr int P = rows_per_group<KT, D, L>();
  static constexpr int T = R * P;  // positions a stage
  static constexpr int kTile = T * D;  // elements of one K or V tile
  static constexpr int kRing =
      kStages * 2 * kTile * static_cast<int>(sizeof(KT));
  static constexpr int kMerge = (R * GT * D + 2 * R * GT) * 4;
  static constexpr int kSmem = kRing > kMerge ? kRing : kMerge;
};

template <typename KT, int D, int L, int GT>
__global__ void __launch_bounds__(kThreads)
    decode_attn(const Params p) {
  using S = Lanes<KT, D, L>;
  using C = Config<KT, D, L, GT>;
  constexpr int E = S::E, R = C::R, P = C::P, T = C::T;
  constexpr int kChunks = D * static_cast<int>(sizeof(KT)) / 16;
  constexpr int kPerChunk = 16 / static_cast<int>(sizeof(KT));
  extern __shared__ __align__(16) unsigned char smem[];
  KT* ring = reinterpret_cast<KT*>(smem);  // [stage][K, V][T][D]

  const int split = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / p.groups, hg = blockIdx.y % p.groups;
  const int h0 = kvh * p.G + hg * GT;
  const int nh = min(GT, p.G - hg * GT);  // real heads of this block
  const int tid = threadIdx.x, c = tid % L, r = tid / L;

  // the live rows, [lo, hi]; none (cur_pos < 0, or past S by the window):
  // the plain version's -1e30 on every row weighs all S rows alike
  const long long cur = p.pos[b];
  long long lo = 0, hi = cur < p.S - 1 ? cur : p.S - 1;
  if (p.window > 0 && cur - p.window + 1 > lo) lo = cur - p.window + 1;
  float qscale = p.scale * kLog2e;
  if (lo > hi) {
    lo = 0;
    hi = p.S - 1;
    qscale = 0.f;
  }
  // this split's rows: whole tiles each, the last split the rest
  const long long n = hi - lo + 1;
  const long long chunk = ((n + p.splits - 1) / p.splits + T - 1) / T * T;
  const long long first = lo + split * chunk;
  const long long last = first + chunk - 1 < hi ? first + chunk - 1 : hi;
  const int rows = first <= last ? static_cast<int>(last - first + 1) : 0;
  const int tiles = (rows + T - 1) / T;

  float qr[GT][E];
  {
    const long long at = b * p.q_sb + static_cast<long long>(h0) * p.q_sh;
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int e = 0; e < E; ++e)
        qr[g][e] = g < nh ? load_q(p, at + g * p.q_sh + S::col(c, e)) : 0.f;
  }

  const char* kbase = static_cast<const char*>(p.k) +
                      (b * p.k_sb + kvh * p.k_sh) * sizeof(KT);
  const char* vbase = static_cast<const char*>(p.v) +
                      (b * p.v_sb + kvh * p.v_sh) * sizeof(KT);
  const long long kstep = p.k_ss * sizeof(KT), vstep = p.v_ss * sizeof(KT);
  auto load_tile = [&](int t, int stage) {
    KT* ks = ring + stage * 2 * C::kTile;
    const long long at = first + static_cast<long long>(t) * T;
#pragma unroll 4
    for (int i = tid; i < 2 * T * kChunks; i += kThreads) {
      const bool is_v = i >= T * kChunks;
      const int j = is_v ? i - T * kChunks : i;
      const int row = j / kChunks, ch = j % kChunks;
      const long long pos = at + row;
      const bool ok = pos <= last;
      const char* src = (is_v ? vbase : kbase) +
                        (ok ? pos * (is_v ? vstep : kstep) : 0) + ch * 16;
      cp_async16(ks + (is_v ? C::kTile : 0) + row * D + ch * kPerChunk, src,
                 ok ? 16 : 0);
    }
  };

  float acc[GT][E], m[GT], l[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -CUDART_INF_F;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) load_tile(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed; every thread is done with t - 1
    if (t + kStages - 1 < tiles)
      load_tile(t + kStages - 1, (t + kStages - 1) % kStages);
    cp_async_commit();
    const KT* ks = ring + (t % kStages) * 2 * C::kTile;
    const KT* vs = ks + C::kTile;
    const int valid = rows - t * T;  // rows of this tile in range

    float s[P][GT];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      float x[E];
      load_lane<KT, D, L>(ks + (r + i * R) * D, c, x);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qr[g][e], x[e], d);
        s[i][g] = d;
      }
    }
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < P; ++i)
#pragma unroll
        for (int g = 0; g < GT; ++g)
          s[i][g] = __fadd_rn(s[i][g],
                              __shfl_xor_sync(0xffffffffu, s[i][g], off));

    float mt[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) mt[g] = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const bool ok = r + i * R < valid;
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        s[i][g] = ok ? __fmul_rn(s[i][g], qscale) : -CUDART_INF_F;
        mt[g] = fmaxf(mt[g], s[i][g]);
      }
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float mn = fmaxf(m[g], mt[g]);
      const float base = mn == -CUDART_INF_F ? 0.f : mn;
      if (mn > m[g]) {  // a new max: rescale what the row group holds
        const float a = exp2f(__fsub_rn(m[g], base));
        l[g] = __fmul_rn(l[g], a);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = __fmul_rn(acc[g][e], a);
        m[g] = mn;
      }
#pragma unroll
      for (int i = 0; i < P; ++i) {
        s[i][g] = exp2f(__fsub_rn(s[i][g], base));
        l[g] = __fadd_rn(l[g], s[i][g]);
      }
    }
#pragma unroll
    for (int i = 0; i < P; ++i) {
      float x[E];
      load_lane<KT, D, L>(vs + (r + i * R) * D, c, x);
#pragma unroll
      for (int g = 0; g < GT; ++g)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = fmaf(s[i][g], x[e], acc[g][e]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the merge from here

  // merge the row groups: f32 outputs [R][GT][D], then max and sum [R][GT]
  float* mo = reinterpret_cast<float*>(smem);
  float* mm = mo + R * GT * D;
  float* ml = mm + R * GT;
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e)
      mo[(r * GT + g) * D + S::col(c, e)] = acc[g][e];
  if (c == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      mm[r * GT + g] = m[g];
      ml[r * GT + g] = l[g];
    }
  }
  __syncthreads();
  for (int i = tid; i < nh * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < R; ++j) mx = fmaxf(mx, mm[j * GT + g]);
    const float base = mx == -CUDART_INF_F ? 0.f : mx;
    float sum = 0.f, o = 0.f;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float w = exp2f(mm[j * GT + g] - base);
      sum = fmaf(w, ml[j * GT + g], sum);
      o = fmaf(w, mo[(j * GT + g) * D + d], o);
    }
    const long long bh = static_cast<long long>(b) * p.H + h0 + g;
    if (p.splits == 1) {
      store_o(p, bh * D + d, o / sum);
    } else {
      const long long at = static_cast<long long>(split) * p.B * p.H + bh;
      p.part_o[at * D + d] = o;
      if (d == 0) {
        p.part_ml[2 * at] = mx;
        p.part_ml[2 * at + 1] = sum;
      }
    }
  }
}

// Merge the splits of one (batch row, head): the splits' outputs weighed by
// 2^(max - the largest max), over the same weighted sums; rounded once.
__global__ void __launch_bounds__(kThreads)
    decode_merge(const Params p, int D) {
  const long long bh = blockIdx.x, stride = static_cast<long long>(p.B) * p.H;
  float mx = -CUDART_INF_F;
  for (int s = 0; s < p.splits; ++s)
    mx = fmaxf(mx, p.part_ml[2 * (s * stride + bh)]);
  float sum = 0.f;
  for (int s = 0; s < p.splits; ++s) {
    const long long at = 2 * (s * stride + bh);
    sum = fmaf(exp2f(p.part_ml[at] - mx), p.part_ml[at + 1], sum);
  }
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float o = 0.f;
    for (int s = 0; s < p.splits; ++s) {
      const long long at = s * stride + bh;
      o = fmaf(exp2f(p.part_ml[2 * at] - mx), p.part_o[at * D + d], o);
    }
    store_o(p, bh * D + d, o / sum);
  }
}

template <typename KT, int D, int L, int GT>
int launch(const Params& p, cudaStream_t stream) {
  using C = Config<KT, D, L, GT>;
  auto kernel = decode_attn<KT, D, L, GT>;
  // the ring passes 48 KB: the attribute once a device
  static std::atomic<unsigned long long> attr_set{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  const unsigned long long bit = 1ull << dev;
  if (!(attr_set.load(std::memory_order_acquire) & bit)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set.fetch_or(bit, std::memory_order_release);
  }
  const dim3 grid(p.splits, p.Hk * p.groups, p.B);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return static_cast<int>(e);
  decode_merge<<<p.B * p.H, kThreads, 0, stream>>>(p, D);
  return static_cast<int>(cudaGetLastError());
}

// The lanes a row: 16 bytes a lane (8 bf16 or 4 f32 elements), a row in at
// most one warp; 160-wide rows take 16 lanes of 10 bf16 or 32 of 5 f32.
template <typename KT>
constexpr int lanes(int d) {
  const int per = 16 / static_cast<int>(sizeof(KT));
  if (d == 160) return sizeof(KT) == 2 ? 16 : 32;
  return d / per < 32 ? d / per : 32;
}

template <typename KT, int D>
int launch_groups(const Params& p, int gt, cudaStream_t stream) {
  constexpr int L = lanes<KT>(D);
  if (gt == 1) return launch<KT, D, L, 1>(p, stream);
  if (gt == 4) return launch<KT, D, L, 4>(p, stream);
  return launch<KT, D, L, 8>(p, stream);
}

template <typename KT>
int launch_dims(const Params& p, int D, int gt, cudaStream_t stream) {
  if (D == 16) return launch_groups<KT, 16>(p, gt, stream);
  if (D == 32) return launch_groups<KT, 32>(p, gt, stream);
  if (D == 64) return launch_groups<KT, 64>(p, gt, stream);
  if (D == 128) return launch_groups<KT, 128>(p, gt, stream);
  if (D == 160) return launch_groups<KT, 160>(p, gt, stream);
  if (D == 256) return launch_groups<KT, 256>(p, gt, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The query heads a block takes: G rounded up to 1, 4 or 8
// (decode_attention.py's head_group).
int head_group(int g) { return g <= 1 ? 1 : g <= 4 ? 4 : 8; }

bool aligned(const void* ptr, long long sb, long long ss, long long sh,
             int B, int S, int Hk, int itemsize) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 &&
         (B == 1 || sb * itemsize % 16 == 0) &&
         (S == 1 || ss * itemsize % 16 == 0) &&
         (Hk == 1 || sh * itemsize % 16 == 0);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The arguments of one call, packed by the wrapper into one block
// (decode_attention.py's _ARGS, "<7Q8q9if": the 8-byte fields, then the
// 4-byte ones, so no padding). q (B, 1, H, D) by its batch and head strides
// in elements, o a contiguous (B, 1, H, D) tensor of q's dtype; k and v
// (B, S, Hk, D) by their batch, position and head strides, with a unit last
// stride, 16-byte aligned pointers and strides (kBadLayout otherwise);
// pos: B int64 on the card; part: f32 scratch of splits * B * H * (D + 2)
// elements, 16-byte aligned, where splits > 1. dtypes: 0 = float32,
// 1 = bfloat16. window <= 0: no window.
struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const void* pos;
  void* part;
  void* stream;
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int q_dtype, kv_dtype, B, H, Hk, S, D, window, splits;
  float scale;
};
static_assert(sizeof(DecodeArgs) == 160, "the wrapper packs 160 bytes");

int decode_attention(const DecodeArgs* a) {
  const int itemsize = a->kv_dtype == 0 ? 4 : 2;
  if (!(aligned(a->k, a->k_sb, a->k_ss, a->k_sh, a->B, a->S, a->Hk,
                itemsize) &&
        aligned(a->v, a->v_sb, a->v_ss, a->v_sh, a->B, a->S, a->Hk,
                itemsize)))
    return kBadLayout;
  if (a->B <= 0 || a->H <= 0) return 0;
  if (a->Hk <= 0 || a->H % a->Hk || a->S <= 0 || a->splits <= 0 ||
      (a->splits > 1 && a->part == nullptr) || a->q_dtype < 0 ||
      a->q_dtype > 1 || a->kv_dtype < 0 || a->kv_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = a->H / a->Hk, gt = head_group(G);
  float* part = static_cast<float*>(a->part);
  const long long n = static_cast<long long>(a->splits) * a->B * a->H;
  Params p{a->q,    a->k,    a->v,       a->o,
           static_cast<const long long*>(a->pos),
           part,    part == nullptr ? nullptr : part + n * a->D,
           a->q_sb, a->q_sh, a->k_sb,    a->k_ss,
           a->k_sh, a->v_sb, a->v_ss,    a->v_sh,
           a->q_dtype, a->B, a->H,       a->Hk,
           G,       a->S,    a->window,  a->splits,
           (G + gt - 1) / gt, a->scale};
  cudaStream_t st = static_cast<cudaStream_t>(a->stream);
  if (a->kv_dtype == 1)
    return launch_dims<__nv_bfloat16>(p, a->D, gt, st);
  return launch_dims<float>(p, a->D, gt, st);
}

}  // extern "C"
