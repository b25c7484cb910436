// The gradient of the selective scan (the Mamba recurrence), for sm_90a.
//
// Replaces: no Pallas kernel. The JAX package trains Mamba through
// jax.value_and_grad of its jnp chunked associative scan
// (src/repro/models/ssm.py, _chunk_scan and mamba_forward); this is the
// backward of ssm_scan.cu's forward. With s_{-1} = state0 and the forward
//   s_t = decay_t * s_{t-1} + u_t ;  y_t[b, d] = sum_n s_t[b, d, n] * c_t[b, n]
// it runs the reverse scan of the state's adjoint g:
//   g_{S-1} = dy_{S-1} c_{S-1} + dfinal ;  g_t = dy_t c_t + decay_{t+1} g_{t+1}
//   d_u_t = g_t ;  d_decay_t = g_t s_{t-1} ;  d_c_t[n] = sum_d dy_t[d] s_t[d, n]
//   d_state0 = decay_0 g_0
// decay, u: (B, S, D, N) f32; c: (B, S, N); dy: (B, S, D); dfinal: (B, D, N)
// or null (zeros); bounds: (B, ceil(S/kChunk), D, N), the state entering each
// chunk, as ssm_scan.cu writes it when asked. Outputs d_decay, d_u
// (B, S, D, N), d_c (B, S, N), d_state0 (B, D, N), f32. All contiguous.
//
// Bound on the H100: device-memory bandwidth. The function reads decay, u,
// dy, c, state0 once and writes d_decay, d_u, d_c, d_state0 once:
// (4*B*S*D*N + B*S*D + 2*B*S*N + 2*B*D*N) * 4 bytes / 3.35 TB/s, at Jamba's
// B=4, S=1024, D=16384, N=16 17,457,217,536 bytes, 5.2111 ms. This kernel
// also reads the boundary states (134 MB there) and writes and reads d_c's
// per-block partials (268 MB), 671,088,640 bytes more: 5.4114 ms for what
// it moves.
//
// Design. Never s_{t-1} = (s_t - u_t) / decay_t: decay = exp(dt*A)
// underflows to exactly 0 in f32. Instead each chunk's kChunk states are
// recomputed from its boundary state, chunks from last to first, and the
// chunk is then walked in reverse. As in the forward, each thread owns one
// (b, d, n): the N lanes of a (b, d) are neighbouring lanes of a warp, the
// adjoint g lives in a register across chunks, and no block carries
// anything to another. A chunk's recomputed states and decays stay in
// registers (the loops over the chunk are unrolled, so every index is a
// constant), so each element of decay and u is read from device memory
// once, and the chunk's kChunk loads of each are independent of the state
// and issued together. The chunk's c and dy are staged in shared memory
// (coalesced, then broadcast reads). d_c sums over D, across blocks: no
// atomics (they would change the bits from run to run, and a resumed
// training must repeat an uninterrupted one), but per-block partials:
// an xor-shuffle sum over the warp's d's, a fixed-order sum over the
// block's warps through shared memory, one (B, S, n_blocks, N) f32 partial
// a block, then ssm_scan_bwd_dc adds each (b, t)'s partials in a fixed
// tree order. Two launches give the same bits. Any S (a ragged last chunk
// runs its missing steps as decay 1, u 0, dy 0: g passes through) and any
// D (lanes past D compute on zeros and store nothing).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;  // ssm_scan.cu's boundary-state stride

template <int N>
__global__ void __launch_bounds__(kThreads)
ssm_scan_bwd_kernel(const float* __restrict__ decay,
                    const float* __restrict__ u, const float* __restrict__ c,
                    const float* __restrict__ bounds,
                    const float* __restrict__ dy,
                    const float* __restrict__ dfinal,
                    float* __restrict__ d_decay, float* __restrict__ d_u,
                    float* __restrict__ dc_part,
                    float* __restrict__ d_state0, long long S, int D) {
  constexpr int kDPerBlock = kThreads / N;
  __shared__ float sh_c[kChunk][N];
  __shared__ float sh_dy[kChunk][kDPerBlock];
  __shared__ float sh_part[kWarps][kChunk][N];
  const int tid = threadIdx.x;
  const int n = tid % N;
  const int dl = tid / N;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int d0 = blockIdx.x * kDPerBlock;
  const int d = d0 + dl;
  const long long b = blockIdx.y;
  const bool active = d < D;
  const long long dn = static_cast<long long>(D) * N;  // one step's stride
  const long long n_chunks = (S + kChunk - 1) / kChunk;
  const long long n_blocks = gridDim.x;
  const long long own = static_cast<long long>(d) * N + n;
  const float* pd = decay + b * S * dn + own;
  const float* pu = u + b * S * dn + own;
  float* pdd = d_decay + b * S * dn + own;
  float* pdu = d_u + b * S * dn + own;

  float g = active && dfinal ? dfinal[b * dn + own] : 0.f;
  for (long long k = n_chunks - 1; k >= 0; --k) {
    const long long t0 = k * kChunk;
    for (int i = tid; i < kChunk * N; i += kThreads) {
      const long long t = t0 + i / N;
      sh_c[i / N][i % N] = t < S ? c[(b * S + t) * N + i % N] : 0.f;
    }
    for (int i = tid; i < kChunk * kDPerBlock; i += kThreads) {
      const long long t = t0 + i / kDPerBlock;
      const int dd = d0 + i % kDPerBlock;
      sh_dy[i / kDPerBlock][i % kDPerBlock] =
          t < S && dd < D ? dy[(b * S + t) * D + dd] : 0.f;
    }
    // st[j] = s_{t0+j-1}: the chunk's boundary state, then its kChunk steps
    float st[kChunk + 1], dv[kChunk];
    st[0] = active ? bounds[(b * n_chunks + k) * dn + own] : 0.f;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const bool in = active && t0 + j < S;
      dv[j] = in ? __ldg(pd + (t0 + j) * dn) : 1.f;
      const float uv = in ? __ldg(pu + (t0 + j) * dn) : 0.f;
      st[j + 1] = dv[j] * st[j] + uv;
    }
    __syncthreads();  // sh_c and sh_dy hold the chunk
#pragma unroll
    for (int j = kChunk - 1; j >= 0; --j) {
      const float dyv = sh_dy[j][dl];
      g += dyv * sh_c[j][n];
      if (active && t0 + j < S) {
        pdu[(t0 + j) * dn] = g;
        pdd[(t0 + j) * dn] = g * st[j];
      }
      float p = dyv * st[j + 1];  // d_c_t[n], this lane's d
#pragma unroll
      for (int m = N; m < 32; m *= 2) p += __shfl_xor_sync(0xffffffffu, p, m);
      if (lane < N) sh_part[warp][j][lane] = p;
      g *= dv[j];
    }
    __syncthreads();  // every warp's partials are in sh_part
    for (int i = tid; i < kChunk * N; i += kThreads) {
      const long long t = t0 + i / N;
      if (t < S) {
        float acc = sh_part[0][i / N][i % N];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) acc += sh_part[w][i / N][i % N];
        dc_part[((b * S + t) * n_blocks + blockIdx.x) * N + i % N] = acc;
      }
    }
    // the next chunk's staging writes sh_c and sh_dy, which every thread
    // last read before the barrier above; sh_part is next written after
    // the next chunk's first barrier, which every thread reaches only once
    // it has read sh_part here
  }
  if (active) d_state0[b * dn + own] = g;
}

// d_c[b, t, n] = the sum over blocks of dc_part[b, t, :, n], one block per
// (b, t): kLanes partials a thread in block order, then a fixed tree.
template <int N>
__global__ void __launch_bounds__(kThreads)
ssm_scan_bwd_dc(const float* __restrict__ dc_part, float* __restrict__ d_c,
                int n_blocks) {
  constexpr int kLanes = kThreads / N;
  __shared__ float sh[kThreads];
  const int tid = threadIdx.x;
  const int jj = tid / N;
  const long long bt = blockIdx.x;
  const float* p = dc_part + bt * n_blocks * N + tid;
  float acc = 0.f;
  for (int j = jj; j < n_blocks; j += kLanes, p += kThreads) acc += *p;
  sh[tid] = acc;
  __syncthreads();
#pragma unroll
  for (int stride = kLanes / 2; stride > 0; stride /= 2) {
    if (jj < stride) sh[tid] += sh[tid + stride * N];
    __syncthreads();
  }
  if (jj == 0) d_c[bt * N + tid] = sh[tid];
}

template <int N>
cudaError_t launch(const float* decay, const float* u, const float* c,
                   const float* bounds, const float* dy, const float* dfinal,
                   float* d_decay, float* d_u, float* dc_part, float* d_c,
                   float* d_state0, int B, long long S, int D,
                   cudaStream_t stream) {
  constexpr int kDPerBlock = kThreads / N;
  const int n_blocks = (D + kDPerBlock - 1) / kDPerBlock;
  if (n_blocks > 0) {
    ssm_scan_bwd_kernel<N><<<dim3(n_blocks, B), kThreads, 0, stream>>>(
        decay, u, c, bounds, dy, dfinal, d_decay, d_u, dc_part, d_state0, S,
        D);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (S > 0) {
    ssm_scan_bwd_dc<N><<<static_cast<unsigned>(B * S), kThreads, 0,
                         stream>>>(dc_part, d_c, n_blocks);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns a cudaError_t; cudaErrorInvalidValue for an N the kernel does not
// take (the wrapper checks N first). ``dfinal`` may be null; ``dc_part`` is
// (B, S, ceil(D / (256 / N)), N) f32 scratch.
int ssm_scan_bwd(const void* decay, const void* u, const void* c,
                 const void* bounds, const void* dy, const void* dfinal,
                 void* d_decay, void* d_u, void* dc_part, void* d_c,
                 void* d_state0, int B, long long S, int D, int N,
                 void* stream) {
  if (B == 0) return 0;
  const auto* a0 = static_cast<const float*>(decay);
  const auto* a1 = static_cast<const float*>(u);
  const auto* a2 = static_cast<const float*>(c);
  const auto* a3 = static_cast<const float*>(bounds);
  const auto* a4 = static_cast<const float*>(dy);
  const auto* a5 = static_cast<const float*>(dfinal);
  auto* o0 = static_cast<float*>(d_decay);
  auto* o1 = static_cast<float*>(d_u);
  auto* o2 = static_cast<float*>(dc_part);
  auto* o3 = static_cast<float*>(d_c);
  auto* o4 = static_cast<float*>(d_state0);
  auto st = static_cast<cudaStream_t>(stream);
#define SSM_BWD_CASE(NN)                                                    \
  case NN:                                                                  \
    return static_cast<int>(launch<NN>(a0, a1, a2, a3, a4, a5, o0, o1, o2, \
                                       o3, o4, B, S, D, st));
  switch (N) {
    SSM_BWD_CASE(1)
    SSM_BWD_CASE(2)
    SSM_BWD_CASE(4)
    SSM_BWD_CASE(8)
    SSM_BWD_CASE(16)
    SSM_BWD_CASE(32)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SSM_BWD_CASE
}

}  // extern "C"
