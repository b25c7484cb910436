// Selective scan (the Mamba recurrence), for sm_90a.
//
// Replaces: src/repro/kernels/ssm_scan.py, ssm_scan (_ssm_kernel), the
// Pallas kernel that keeps the (blk_d, N) running state in VMEM scratch
// across a sequential grid axis over S:
//   s_t = decay_t * s_{t-1} + u_t ;  y_t[b, d] = sum_n s_t[b, d, n] * c_t[b, n]
// decay, u: (B, S, D, N) f32; c: (B, S, N) f32; state0: (B, D, N) f32;
// outputs y: (B, S, D) f32 and the final state (B, D, N) f32. All contiguous.
// Only when asked (a non-null ``bounds``, under autograd), it also writes the
// state entering each kChunk-step chunk, (B, ceil(S/kChunk), D, N) f32:
// bounds[:, k] = s_{k*kChunk-1}, with s_{-1} = state0. ssm_scan_bwd.cu
// recomputes each chunk's states from them. Serving passes null and writes
// nothing extra.
//
// Bound on the H100: device-memory bandwidth. Every element of decay and u
// is read once and used for one FMA, so the least time is
// (2*B*S*D*N + B*S*N + 2*B*D*N + B*S*D) * 4 bytes / 3.35 TB/s: 2.6469 ms
// at Jamba's B=4, S=1024, D=16384, N=16; the boundary states add
// B*ceil(S/32)*D*N*4 bytes (134 MB there, 0.040 ms).
// Design: no block carries anything to another, so the sequential axis is
// a loop inside each thread. Each thread owns one (b, d, n) state in a
// register and walks over S. The N lanes of one (b, d) are neighbouring
// lanes of one warp (N a power of two <= 32), so the loads of decay and u
// at one step are coalesced (neighbouring threads, neighbouring (d, n)
// addresses), c_t is a broadcast load, and y_t is an xor-shuffle sum over
// the N lanes that lane n == 0 stores. The loads for kAhead steps are
// issued before the FMAs that use them (they do not depend on the state),
// which keeps enough bytes in flight to cover the memory latency. Any S and
// any D: lanes of a (b, d) past the ragged edge of D compute on zeros and
// store nothing, but stay in the warp's shuffles.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAhead = 8;
constexpr int kChunk = 32;  // the backward's chunk: a multiple of kAhead
static_assert(kChunk % kAhead == 0, "a chunk starts at a kAhead step");

template <int N>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const float* __restrict__ decay, const float* __restrict__ u,
                const float* __restrict__ c, const float* __restrict__ state0,
                float* __restrict__ y, float* __restrict__ final_state,
                float* __restrict__ bounds, long long S, int D) {
  constexpr int kDPerBlock = kThreads / N;
  const int n = threadIdx.x % N;
  const int d = blockIdx.x * kDPerBlock + threadIdx.x / N;
  const long long b = blockIdx.y;
  const bool active = d < D;
  const long long dn = static_cast<long long>(D) * N;  // one step's stride
  const long long base = b * S * dn + static_cast<long long>(d) * N + n;
  const float* pd = decay + base;
  const float* pu = u + base;
  const float* pc = c + b * S * N + n;
  float* py = y + b * S * D + d;
  const bool store = active && n == 0;
  // bounds[b, k, d, n], k = t / kChunk
  float* pb = bounds ? bounds + b * ((S + kChunk - 1) / kChunk) * dn +
                           static_cast<long long>(d) * N + n
                     : nullptr;

  float s = active ? state0[b * dn + static_cast<long long>(d) * N + n] : 0.f;
  long long t = 0;
  for (; t + kAhead <= S; t += kAhead) {
    if (pb && active && t % kChunk == 0) pb[t / kChunk * dn] = s;
    float dv[kAhead], uv[kAhead], cv[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const long long off = (t + j) * dn;
      dv[j] = active ? __ldg(pd + off) : 0.f;
      uv[j] = active ? __ldg(pu + off) : 0.f;
      cv[j] = __ldg(pc + (t + j) * N);
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      s = dv[j] * s + uv[j];
      float p = s * cv[j];
#pragma unroll
      for (int m = N / 2; m > 0; m /= 2) p += __shfl_xor_sync(0xffffffffu, p, m);
      if (store) py[(t + j) * D] = p;
    }
  }
  for (; t < S; ++t) {  // the ragged tail of S
    if (pb && active && t % kChunk == 0) pb[t / kChunk * dn] = s;
    const long long off = t * dn;
    const float dv = active ? __ldg(pd + off) : 0.f;
    const float uv = active ? __ldg(pu + off) : 0.f;
    s = dv * s + uv;
    float p = s * __ldg(pc + t * N);
#pragma unroll
    for (int m = N / 2; m > 0; m /= 2) p += __shfl_xor_sync(0xffffffffu, p, m);
    if (store) py[t * D] = p;
  }
  if (active) final_state[b * dn + static_cast<long long>(d) * N + n] = s;
}

template <int N>
cudaError_t launch(const float* decay, const float* u, const float* c,
                   const float* state0, float* y, float* final_state,
                   float* bounds, int B, long long S, int D,
                   cudaStream_t stream) {
  constexpr int kDPerBlock = kThreads / N;
  const dim3 grid((D + kDPerBlock - 1) / kDPerBlock, B);
  ssm_scan_kernel<N><<<grid, kThreads, 0, stream>>>(decay, u, c, state0, y,
                                                     final_state, bounds, S,
                                                     D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns a cudaError_t; cudaErrorInvalidValue for an N the kernel does not
// take (the wrapper checks N first). ``bounds`` may be null.
int ssm_scan(const void* decay, const void* u, const void* c,
             const void* state0, void* y, void* final_state, void* bounds,
             int B, long long S, int D, int N, void* stream) {
  if (B == 0 || D == 0) return 0;
  const auto* pd = static_cast<const float*>(decay);
  const auto* pu = static_cast<const float*>(u);
  const auto* pc = static_cast<const float*>(c);
  const auto* ps = static_cast<const float*>(state0);
  auto* py = static_cast<float*>(y);
  auto* pf = static_cast<float*>(final_state);
  auto* pb = static_cast<float*>(bounds);
  auto st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 1: return static_cast<int>(launch<1>(pd, pu, pc, ps, py, pf, pb, B, S, D, st));
    case 2: return static_cast<int>(launch<2>(pd, pu, pc, ps, py, pf, pb, B, S, D, st));
    case 4: return static_cast<int>(launch<4>(pd, pu, pc, ps, py, pf, pb, B, S, D, st));
    case 8: return static_cast<int>(launch<8>(pd, pu, pc, ps, py, pf, pb, B, S, D, st));
    case 16: return static_cast<int>(launch<16>(pd, pu, pc, ps, py, pf, pb, B, S, D, st));
    case 32: return static_cast<int>(launch<32>(pd, pu, pc, ps, py, pf, pb, B, S, D, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
