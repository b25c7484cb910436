// Throughput of one warp-level tensor-core instruction on the card, for
// tools/mma_rate.py: every warp of a full grid runs `iters` rounds of
// 8 independent mma.sync on register operands, so the tensor pipe, not a
// dependency or a memory read, sets the time.
//   kind 0: mma.sync.m16n8k8 tf32 -> f32 (2048 flops), what the f32 flash
//           kernels run three of for each f32 product (3xTF32);
//   kind 1: mma.sync.m16n8k16 bf16 -> f32 (4096 flops), flash_fwd_mma's.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChains = 8;

template <int KIND>
__global__ void mma_loop(int iters, float* out) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = 0x3f800000u + threadIdx.x + i;
  for (int i = 0; i < 2; ++i) b[i] = 0x3f800000u + threadIdx.x * 3 + i;
  float c[kChains][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) {
      if (KIND == 0)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
    }
  }
  float s = 0.f;
  for (int j = 0; j < kChains; ++j)
    for (int i = 0; i < 4; ++i) s += c[j][i];
  if (s == 1234.5f) out[threadIdx.x] = s;  // keeps the loop
}

}  // namespace

extern "C" {

// Launches `blocks` blocks of `threads` threads, each warp running
// iters * 8 instructions of `kind`; returns a cudaError_t.
int mma_rate(int kind, int blocks, int threads, int iters, void* out,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (kind == 0)
    mma_loop<0><<<blocks, threads, 0, st>>>(iters, o);
  else
    mma_loop<1><<<blocks, threads, 0, st>>>(iters, o);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
