// Changed-block scan for delta checkpoints, for sm_90a.
//
// Replaces: src/repro/kernels/delta_encode.py, delta_mask (_delta_kernel),
// the Pallas kernel that turns each delta snapshot into byte-range writes.
// mask[i] = 1 iff bytes [i*block, (i+1)*block) of `a` and `b` differ.
//
// Bound on the H100: device-memory bandwidth. It reads 2n bytes and writes
// n/block flags, with one XOR-OR per 16 bytes, so the least time is
// 2n / 3.35 TB/s. Design: one thread block per changed-block, each thread
// streams 16-byte (uint4) loads of both inputs, neighbouring threads on
// neighbouring addresses, four loads in flight per input per thread; the
// block's answer is one __syncthreads_or and one int8 store. Nothing is
// carried between blocks, so the grid has no order.
//
// Contract (checked by the Python wrapper): a, b 16-byte aligned, `block`
// a multiple of 16, n a multiple of `block`.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kThreads)
delta_mask_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                  int8_t* __restrict__ mask, long long vecs_per_block) {
  const long long base = static_cast<long long>(blockIdx.x) * vecs_per_block;
  const uint4* pa = a + base;
  const uint4* pb = b + base;
  unsigned int diff = 0;
  long long i = threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < vecs_per_block;
       i += kUnroll * kThreads) {
    uint4 x[kUnroll], y[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      x[u] = __ldg(pa + i + u * kThreads);
      y[u] = __ldg(pb + i + u * kThreads);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      diff |= (x[u].x ^ y[u].x) | (x[u].y ^ y[u].y) | (x[u].z ^ y[u].z) |
              (x[u].w ^ y[u].w);
    }
  }
  for (; i < vecs_per_block; i += kThreads) {
    const uint4 x = __ldg(pa + i);
    const uint4 y = __ldg(pb + i);
    diff |= (x.x ^ y.x) | (x.y ^ y.y) | (x.z ^ y.z) | (x.w ^ y.w);
  }
  const int changed = __syncthreads_or(diff != 0);
  if (threadIdx.x == 0) mask[blockIdx.x] = static_cast<int8_t>(changed);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// a, b: n bytes each on the device; mask: n / block int8 on the device.
int delta_mask(const void* a, const void* b, void* mask, long long n,
               long long block, void* stream) {
  const long long n_blocks = n / block;
  if (n_blocks == 0) return 0;
  delta_mask_kernel<<<static_cast<unsigned int>(n_blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(a), static_cast<const uint4*>(b),
      static_cast<int8_t*>(mask), block / 16);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
