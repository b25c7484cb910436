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
//   - the softmax runs in the log2 domain (flash_fwd_tf32's too), with the
//     -1e30 sentinel on the tiles that cross an edge of the band or S; the
//     others take max and exponent from the raw scores with the scale in
//     one fma, and exponents are ex2.approx.ftz; f32 m, l and O, l clamped
//     at 1e-30;
//   - each consumer stages its normalised rows as bf16 and stores them by
//     TMA (rows past S are not written), in a tile of its own up to
//     HD = 128, so that the next item's Q loads meanwhile; at HD = 256 in
//     its rows of the Q tile;
//   - HD (the tiles' head width) 64 and 128 take 128-key tiles, 192 and
//     256 take 64; 197,712 bytes of shared memory at HD = 128, 192 and 256.
//     D = Dv in {64, 128, 256}, MLA's 96 / 64 and stablelm-12b's 160 have
//     instantiations of their own, without branches between the products
//     (at 160: three 64-column atoms, 32 columns of them zero fill, ten
//     16-deep k-steps, P V as the 128-wide product plus a 32-wide one);
//     other widths read D and Dv at run time.
//   Left for later: overlapping a warpgroup's softmax with its own next
//   Q K^T (two score register sets); a deeper ring, which at HD = 128
//   needs the shared memory that the output tile takes; issuing an item's
//   first Q K^T in the last turn of the item before (with a second Q tile
//   it filled the shared memory at HD = 128 and measured no faster); a
//   dynamic tile scheduler; clusters with TMA multicast of K and V across
//   the query heads of a GQA group.
//
// flash_fwd_tf32, f32 (3xTF32 on tf32 wgmma, warp-specialised and
// persistent like flash_fwd_wgmma):
//   - products: every one is wgmma.mma_async m64nNk8 .tf32 as 3xTF32
//     (hopper.cuh's wgmma_3xtf32: small(A) big(B) + big(A) small(B), then
//     + big(A) big(B); small * small is dropped, as in CUTLASS's fast-f32
//     GEMMs): about f32 accuracy, where one TF32 product on either matmul
//     misses the 1e-4 tolerance. The bound is the TF32 tensor-core rate
//     over 3 (494.7 / 3 TFLOP/s);
//   - layout: tf32 wgmma reads A and B K-major only. S = Q K^T takes A from
//     registers, each lane's Q values loaded from the raw f32 Q tile that
//     TMA lands and split there (big = x rounded to TF32, small = x - big),
//     in chunks of 4 k-steps whose A fragments load while the chunk before
//     runs, in two register sets named at compile time; B is K's halves.
//     O += P V takes A from the score registers: with the keys of a k-step
//     permuted within each 8 (kpos: k index t is key 2t, t + 4 is 2t + 1),
//     the C fragment of S is P's A fragment, split in registers; B is V^T's
//     halves, K-major over the keys in that permutation;
//   - a pre-pass, flash_fwd_prep_kv, writes K's and V^T's TF32 halves once
//     a call, (B, Hk, 2, S, D8) and (B, Hk, 2, Dv, ld) (hopper.cuh's
//     split_keys, the backward's pre-pass too), so that every B tile is an
//     exact TF32 value: 4 bytes read and 16 written for each element of K
//     and V (at MLA's heads 0.09 ms of bytes at 3.35 TB/s);
//   - one block of 384 threads an SM, taking work items (batch*head, query
//     tile) in turn: a unit is a head's heaviest and lightest tiles left,
//     head by head, where there are as many such pairs as SMs, or one tile,
//     every head's heaviest first, unless the other deal leaves the busiest
//     block fewer KV tiles (computed at launch). One producer
//     warpgroup, whose first thread keeps K's and V^T's halves in flight by
//     TMA through a ring of ST stages that runs on across items (full and
//     empty mbarriers per stage, K and V^T on barriers of their own, so that
//     K is released as soon as Q K^T has read it) and loads each item's Q
//     once the last item's is free; two consumer warpgroups. setmaxnreg
//     hands the producer's registers to the consumers (24 and 240 a thread);
//   - a consumer issues Q K^T of tile i, then P V of tile i - 1, and runs
//     the online softmax of tile i while that P V finishes
//     (flash_fwd_wgmma's, in the log2 domain with the -1e30 sentinel on
//     the tiles that cross an edge of the band or S; ex2.approx; P kept in
//     f32); then it rescales O (a warp whose rows kept their maxima skips
//     it: a multiply by 1 leaves the bits) and splits P for the next P V;
//     f32 m, l and O, l clamped at 1e-30; each lane stores its
//     normalised rows as 8-byte pairs (rows past S and columns past Dv are
//     not written) and, where the caller passes an lse buffer (training),
//     each row's log-sum-exp m + log2(l) in the log2 domain of the scores,
//     which the backward reads;
//   - tiles, widths and budgets (shared memory: the Q tile BQ x QW x 4
//     bytes, ST stages of K's halves BK x QW x 8 and V^T's DV x BK x 8):
//       D = Dv = 64 (musicgen-large): 128-row items, each consumer 64 rows;
//         64-key tiles, 2 stages: 160 KiB;
//       D = 96, Dv = 64 (minicpm3-4b's MLA): 128 rows, 64 keys, 2 stages,
//         Q K^T 96 deep and P V 64 wide, not 128: 208 KiB;
//       D = Dv = 128 (qwen2-vl-2b): 128 rows, 32 keys, 2 stages: 192 KiB;
//       D = Dv = 160 (stablelm-12b): 128-row items, each consumer all 160
//         head dims of its 64 rows (80 KiB of Q; twenty k-steps, O as 64 +
//         64 + 32 columns), a V^T box of 160 rows, 32-key tiles, one
//         stage: 161 KiB (a second K stage measured 0.7 % faster, inside
//         the spread between runs; a second V^T stage 2 % slower). 64-row
//         items whose consumers take 80 head dims each, as at 256, read
//         twice the K and V^T bytes a row from L2 and measured 1.25x
//         slower; 64-key
//         tiles do not fit beside the Q tile (tools/flash_fwd_stages.py);
//       D = Dv = 256 (gemma3-1b): a 64-row Q tile is 64 KiB and one stage
//         of 32 keys 128 KiB, so 128-row items do not fit. An item is 64
//         rows, which both consumers take: consumer c runs Q K^T over head
//         dims 128 c.. (16 k-steps, m64n32k8) and P V for O's columns 128
//         c..; each tile the two add their partial scores through shared
//         memory (one named barrier a tile) and run the same softmax, so m
//         and l agree and no merge is needed. That halves the Q fragments a
//         consumer loads and splits a tile, and O's registers, and gives
//         gemma3-1b's 16 heads of 1024 rows 256 items for the 132 SMs
//         instead of 128: 225 KiB, one stage (K of the next tile loads
//         while P V runs, V^T while Q K^T runs);
//       other widths (D and Dv multiples of 4) run the instantiation of
//         their head tile (64, 128, 256) with D and Dv read at run time;
//     products run D deep rounded up to 8 and Dv wide rounded up to the
//     64-column chunks of O (the last one 16 or 32 wide where that
//     suffices): flash_attention.product_widths;
//   - no atomics, and every sum runs in a fixed order, so two launches give
//     the same bits.
// Both read kv head h / (H / Hk) directly instead of a copy (GQA), take any
// S (the ragged last tile is masked), Dv != D, and strided q, k, v with a
// unit last dimension, 16-byte aligned pointers and row strides, which the
// wrapper checks. A call's host work is its tensor maps and launches: the
// SM count and each kernel's shared-memory attribute are set once a process
// and device, the f32 deal once a shape (device_setup, tf::launch), and the
// wrapper passes its arguments as one packed block (FwdArgs).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

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
// Up to HD = 192 the output is staged in a tile of its own, so that the
// next item's Q loads while this item's output is stored; at HD = 256 it
// is staged in the Q tile.
template <int HD, int BK>
struct Smem {
  static constexpr int kAtoms = HD / 64;
  static constexpr int kQAtom = kBQ * 128;
  static constexpr int kKVAtom = BK * 128;
  static constexpr bool kOwnO = HD <= 192;
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
// P's keys 16kc..16kc+15 are pa[kc]. At VN = 128 and 160 (kWide) one
// product spans atoms 0 and 1 of V (LBO: the bytes from one to the next),
// and at 160 a 32-wide one takes atom 2; otherwise each atom is a product
// of its own.
template <int kAtoms, int BK, int VN>
__device__ __forceinline__ void issue_pv(float (&o)[kAtoms][32],
                                         const uint32_t (&pa)[BK / 16][4],
                                         uint32_t v, int pv_atoms,
                                         int v_last) {
  constexpr bool kWide = VN == 128 || VN == 160;
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) {
    if constexpr (kWide) {
      static_assert(kAtoms == VN / 64 + (VN % 64 ? 1 : 0), "atoms of V");
      wgmma_rs_tb(reinterpret_cast<float(&)[64]>(o), pa[kc],
                  desc_sw128(v + kc * 16 * 128, BK * 128), 1);
      if constexpr (VN == 160)
        pv_atom(o[2], pa[kc], desc_sw128(v + 2 * BK * 128 + kc * 16 * 128),
                32);
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
        issue_pv<kAtoms, BK, VN>(o, p_prev, v_stage(sp), pv_atoms,
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
        issue_pv<kAtoms, BK, VN>(o, p_last, v_stage(sl), pv_atoms,
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
  static std::atomic<unsigned long long> attr_set{0};
  const size_t smem = Smem<HD, BK>::kBytes;
  int sms = 0;
  err = device_setup(flash_fwd_wgmma<HD, BK, KS, VN>, smem, attr_set, sms);
  if (err) return err;
  const int n_qt = (p.S + kBQ - 1) / kBQ;
  const int pairs = B * p.H * ((n_qt + 1) / 2);
  const int per_unit = pairs >= sms ? 2 : 1;
  const int units = per_unit == 2 ? pairs : B * p.H * n_qt;
  const Args args{B,        p.H,      p.group, p.S,   p.D,   p.Dv,
                  p.scale * 1.4426950408889634f,    p.causal,
                  p.window, units,    per_unit};
  const int blocks = units < sms ? units : sms;
  flash_fwd_wgmma<HD, BK, KS, VN>
      <<<blocks, kThreads, smem, stream>>>(tq, tk, tv, to, args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// bf16 tiles: 99,408 bytes of shared memory at HD = 64 (128-key tiles),
// 197,712 at 128 (128 keys), at 192 (64 keys) and at 256 (64 keys); 384
// threads a block.
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
  if (p.D == 160 && p.Dv == 160)  // stablelm-12b: three atoms, 32 columns pad
    return wg::launch<192, 64, 10, 160>(p, B, stream);
  if (p.D == 256 && p.Dv == 256)
    return wg::launch<256, 64, 16, 256>(p, B, stream);
  return wg::launch<256, 64>(p, B, stream);
}

// ---------------------------------------------------------------------------
// f32: flash_fwd_prep_kv, then flash_fwd_tf32
// ---------------------------------------------------------------------------

namespace tf {

using namespace hopper;

constexpr int kThreads = 384;    // the producer warpgroup, then two consumers
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 24 * 128 + 240 * 256 <= 65,536

struct Args {
  int B, H, group, S, D, Dv;
  float scale;  // log2(e) folded in
  int causal;
  int window;    // <= 0: no window
  int units;     // work units, each of per_unit items (see decode)
  int per_unit;  // 1 or 2
  float* o;
  long long o_sb, o_sh, o_ss;
  float* lse;  // (B, H, S) contiguous, or null
};

// K into its TF32 halves, (B, Hk, 2, S, D8) with D8 = D rounded up to 8,
// columns permuted within each 8; V into V^T's, (B, Hk, 2, Dv, ld), keys
// permuted within each 8 and zero from S to ld: 32 keys of one (b, kv
// head) a block, blockIdx.z 0 for K, 1 for V (hopper.cuh's split_keys, as
// the backward's pre-pass). 256 threads.
__global__ void __launch_bounds__(256)
    flash_fwd_prep_kv(Params p, float* kv, float* vt, int ld) {
  __shared__ float tile[32][33];
  const int Hk = p.H / p.group;
  const int k0 = blockIdx.x * 32, bhk = blockIdx.y;
  const int b = bhk / Hk, hk = bhk - b * Hk;
  if (blockIdx.z == 0)
    split_keys(static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh,
               p.k_ss, p.S, p.D, k0, kv + 2ll * bhk * p.S * ((p.D + 7) & ~7),
               nullptr, ld, tile);
  else
    split_keys(static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh,
               p.v_ss, p.S, p.Dv, k0, nullptr, vt + 2ll * bhk * p.Dv * ld,
               ld, tile);
}

// Byte offsets from the 1024-aligned base of shared memory, for items of BQ
// query rows, Q and K tiles QW columns wide (32-column atoms), key tiles of
// BK keys and V^T tiles of DV rows (32-key atoms), ST stages: the Q tile
// (raw f32), each stage's K halves (big, then small) and V^T halves, at BQ
// = 64 (the consumers split the head dims) each consumer's partial scores
// of the last two tiles, then the barriers: q_full, q_empty, and k_full,
// v_full, k_empty, v_empty for each stage.
template <int BQ, int QW, int DV, int BK, int ST>
struct Smem {
  static constexpr int kQAtom = BQ * 128;
  static constexpr int kKAtom = BK * 128;
  static constexpr int kVAtom = DV * 128;
  static constexpr int kKHalf = QW / 32 * kKAtom;
  static constexpr int kVHalf = BK / 32 * kVAtom;
  static constexpr int kXTile = BQ * BK * 4;  // one partial score tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + QW / 32 * kQAtom;
  static constexpr int kV = kK + ST * 2 * kKHalf;
  static constexpr int kX = kV + ST * 2 * kVHalf;
  static constexpr int kBar = kX + (BQ == 64 ? 4 * kXTile : 0);
  static constexpr size_t kBytes = 1024 + kBar + 8 * (2 + 4 * ST);
};

// One work item: the query tile of BQ rows at q0 of batch b, head h, and
// the KV tiles t_lo .. t_hi - 1 that its causal and window bands reach.
// Blocks take work units in turn (unit blockIdx.x, + gridDim.x, ...). A
// unit is either the pair (n_qt - 1 - r, r) of a head's query tiles, which
// weighs the same for every r under the causal band, head by head, so
// that the blocks running at one time share the K and V halves of a few
// heads in L2; or one query tile, every head's heaviest tiles first (the
// launch picks the deal, see launch).
// Returns false for the second half of the middle pair of an odd n_qt.
struct Item {
  int b, h, q0, t_lo, t_hi;
};

template <int BQ, int BK>
__device__ __forceinline__ bool decode(const Args& p, int u, int half,
                                       Item& x) {
  const int n_qt = (p.S + BQ - 1) / BQ;
  int bh, qt;
  if (p.per_unit == 2) {
    const int per_head = (n_qt + 1) / 2;
    bh = u / per_head;
    const int r = u - bh * per_head;
    qt = half ? r : n_qt - 1 - r;
    if (half && qt == n_qt - 1 - r) return false;
  } else {
    const int heads = p.B * p.H, r = u / heads;
    bh = u - r * heads;
    qt = n_qt - 1 - r;
  }
  x.b = bh / p.H;
  x.h = bh - x.b * p.H;
  x.q0 = qt * BQ;
  const int q_last = min(x.q0 + BQ, p.S) - 1;
  const int kv_hi = p.causal ? q_last + 1 : p.S;
  const int kv_lo = p.window > 0 ? max(x.q0 - p.window + 1, 0) : 0;
  x.t_lo = kv_lo / BK;
  x.t_hi = (kv_hi + BK - 1) / BK;
  return true;
}

// sc = Q K^T for one consumer warpgroup, or (KMAX < QW / 8) its share of
// the head dims: A is its 64 rows of the raw f32 Q tile (BQ rows at offset
// q from base, from row qrow), each lane's values loaded (columns 2t, 2t +
// 1 of a k-step as k indices t, t + 4) and split into TF32 halves in
// registers; B is the K stage's halves (big at the shared address kb,
// small a half further). KS k-steps of 8 columns from k-step k0 (KS = 0:
// ks of them, at most KMAX, read at run time). The A fragments of 4
// k-steps load and split while the products of the 4 before run, in two
// register sets named at compile time. Returns with the last two chunks'
// products in flight.
template <int BQ, int QW, int BK, int KMAX, int KS>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2],
                                         const unsigned char* sm, uint32_t q,
                                         uint32_t kb, int k0, int ks,
                                         int qrow, int warp, int lane) {
  constexpr int kMax = KS > 0 ? KS : KMAX;
  constexpr int kHalf = QW / 32 * BK * 128;
  const int n = KS > 0 ? KS : ks;
  const int r0 = qrow + 16 * warp + lane / 4, t = lane % 4;
  if (KS == 0 && n <= 0) {  // no head dims of this consumer's share
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) sc[e] = 0.f;
    return;
  }
  uint32_t fb[2][4][4], fs[2][4][4];
#pragma unroll
  for (int ch = 0; ch < (kMax + 3) / 4; ++ch) {
    uint32_t(&ab)[4][4] = fb[ch & 1];
    uint32_t(&as)[4][4] = fs[ch & 1];
    if (ch >= 2) wgmma_wait<1>();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jj = 4 * ch + j, c0 = 8 * (k0 + jj) + 2 * t;
      if (jj < kMax && jj < n) {
        const float2 lo = lds2(sm, q + tile_at<BQ>(r0, c0));
        const float2 hi = lds2(sm, q + tile_at<BQ>(r0 + 8, c0));
        const float xv[4] = {lo.x, hi.x, lo.y, hi.y};
        split4(xv, ab[j], as[j]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jj = 4 * ch + j, kk = k0 + jj;
      if (jj < kMax && jj < n) {
        const uint32_t off = (kk / 4) * (BK * 128) + (kk % 4) * 32;
        wgmma_3xtf32(sc, ab[j], as[j], desc_sw128(kb + off),
                     desc_sw128(kb + kHalf + off), jj > 0);
      }
    }
    wgmma_commit();
  }
}

// o += P V for one consumer: P's k-step j (keys 8j..8j+7 of the tile) is
// the A fragment {sc[4j], sc[4j + 2], sc[4j + 1], sc[4j + 3]} split into
// pb[j], ps[j] (V^T's keys are permuted within each 8 to match); B is the
// V^T stage's halves (big at vb, small a half further), whose rows v0 + 64
// m.. are o's chunk m, its accumulators o[32 m..]. VW > 0: the consumer's
// OW = VW columns fixed, in chunks of 64 and a last one 16, 32 or 64 wide;
// VW = 0: nv chunks at run time, the last lw = 16, 32 or 64 wide.
template <int DV, int BK, int OW, int VW>
__device__ __forceinline__ void issue_pv(float (&o)[OW / 2],
                                         const uint32_t (&pb)[BK / 8][4],
                                         const uint32_t (&ps)[BK / 8][4],
                                         uint32_t vb, int v0, int nv,
                                         int lw) {
  constexpr int kHalf = BK / 32 * DV * 128;
  constexpr int kChunks = (OW + 63) / 64;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const uint32_t koff = (8 * j / 32) * (DV * 128) + (8 * j % 32) * 4;
#pragma unroll
    for (int mc = 0; mc < kChunks; ++mc) {
      const uint32_t off = koff + (v0 + mc * 64) * 128;
      const uint64_t bb = desc_sw128(vb + off);
      const uint64_t bs = desc_sw128(vb + kHalf + off);
      float* const d = o + 32 * mc;
      if constexpr (VW > 0 && VW % 64 == 0) {
        wgmma_3xtf32(*reinterpret_cast<float(*)[32]>(d), pb[j], ps[j], bb,
                     bs, 1);
      } else if (VW > 0 || mc < nv) {
        const int w = VW > 0 ? (mc + 1 < kChunks ? 64 : OW - 64 * mc)
                             : (mc + 1 < nv ? 64 : lw);
        if (w == 16)
          wgmma_3xtf32(*reinterpret_cast<float(*)[8]>(d), pb[j], ps[j], bb,
                       bs, 1);
        else if (w == 32)
          wgmma_3xtf32(*reinterpret_cast<float(*)[16]>(d), pb[j], ps[j], bb,
                       bs, 1);
        else
          wgmma_3xtf32(*reinterpret_cast<float(*)[32]>(d), pb[j], ps[j], bb,
                       bs, 1);
      }
    }
  }
}

// The online softmax of one consumer's score tile (raw Q K^T in sc), two
// rows a lane (r0 and r0 + 8; keys k0 + 8j + 2 (lane % 4) and the next), as
// flash_fwd_wgmma's softmax_tile: m, l and corr in the log2 domain of the
// scaled scores; a tile inside the band and S (kEdge false) takes max and
// exponent from the raw scores, the scale folded into one fma; a tile on
// an edge scales first and sets what the mask drops to the -1e30
// sentinel, so a row masked so far takes p = 1 and is wiped by corr = 0
// later, as in the reference. P stays in sc, in f32.
template <int BK, bool kEdge>
__device__ __forceinline__ void softmax(float (&sc)[BK / 2], float (&m)[2],
                                        float (&l)[2], float (&corr)[2],
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
    corr[r] = wg::ex2(m[r] - mx);
    m[r] = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        const float x = sc[4 * j + e];
        sc[4 * j + e] = wg::ex2(kEdge ? x - mx : x * p.scale - mx);
        sum += sc[4 * j + e];
      }
    l[r] = l[r] * corr[r] + sum;
  }
}

// BQ: query rows an item: 128, each consumer warpgroup taking 64 of them;
// or 64, both taking all 64, consumer c computing Q K^T over its half of
// the head dims (columns 128 c..) and P V for its half of O's columns
// (128 c..): each tile the two add their partial scores in a fixed order
// through shared memory and both run the same softmax. QW: the Q and K
// tiles' columns (D rounded up to 32); DV: V^T's rows (Dv rounded up to
// 64); BK: keys a tile; ST: stages of the K and V^T ring; KS: k-steps of
// Q K^T (ceil(D / 8)) and VN: Dv, each 0 where read at run time. The
// common widths get their own instantiation, so that their products run
// without branches between them. A block stays on its SM and takes work
// units in turn (see decode); the ring and the barriers' phases run on
// across items.
template <int BQ, int QW, int DV, int BK, int ST, int KS, int VN>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_tf32(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, Args p) {
  constexpr bool kHalves = BQ == 64;  // the consumers split the head dims
  constexpr int kWays = kHalves ? 2 : 1;
  // O's columns a consumer computes: VW = Dv / kWays where Dv is fixed,
  // else its share of the tile in 64-column chunks; OW / 2 accumulators a
  // thread
  constexpr int VW = VN / kWays;
  constexpr int OW = VN > 0 ? VW : (DV + 63) / 64 / kWays * 64;
  constexpr int KMAX = QW / 8 / kWays;  // k-steps of a consumer
  constexpr int KC = KS / kWays;
  static_assert(VN == 0 || (VN == DV && VN % kWays == 0 &&
                            (VW % 64 == 0 || VW % 64 == 16 ||
                             VW % 64 == 32)),
                "P V's widths: chunks of 64, the last 16, 32 or 64 wide");
  static_assert(KS % kWays == 0 && (!kHalves || QW % 16 == 0), "halves");
  using L = Smem<BQ, QW, DV, BK, ST>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);
  const uint32_t q_full = base + L::kBar, q_empty = q_full + 8;
  auto k_full = [&](int s) { return q_full + 8 * (2 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (2 + ST + s); };
  auto k_empty = [&](int s) { return q_full + 8 * (2 + 2 * ST + s); };
  auto v_empty = [&](int s) { return q_full + 8 * (2 + 3 * ST + s); };
  const int S = p.S;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);  // lane 0 of each consumer warp
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 8);
      mbar_init(v_empty(s), 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // the producer: one thread keeps the ring of K and V^T halves full, and
    // loads each item's Q once the last one's is free
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_map(&tq);
      prefetch_map(&tk);
      prefetch_map(&tv);
      const int atoms = (p.D + 31) / 32;  // of Q, and of K's halves
      int it = 0;     // KV tiles through the ring so far
      int round = 0;  // items so far
      for (int k = 0;; ++k) {  // the block's item slots, unit by unit
        const int u = blockIdx.x + k / p.per_unit * gridDim.x;
        if (u >= p.units) break;
        Item x;
        if (!decode<BQ, BK>(p, u, k % p.per_unit, x)) continue;
        const int hk = x.h / p.group;
        for (int t = x.t_lo; t < x.t_hi; ++t, ++it) {
          const int s = it % ST, parity = ((it / ST) & 1) ^ 1;
          const uint32_t ks = base + L::kK + 2 * s * L::kKHalf;
          mbar_wait(k_empty(s), parity);
          mbar_expect_tx(k_full(s), 2 * atoms * L::kKAtom);
          for (int a = 0; a < atoms; ++a)
            for (int hf = 0; hf < 2; ++hf)
              tma_load(ks + hf * L::kKHalf + a * L::kKAtom, &tk, k_full(s),
                       32 * a, t * BK, 2 * hk + hf, x.b);
          if (t == x.t_lo) {  // Q after the item's first K
            mbar_wait(q_empty, (round & 1) ^ 1);
            mbar_expect_tx(q_full, atoms * L::kQAtom);
            for (int a = 0; a < atoms; ++a)
              tma_load(base + L::kQ + a * L::kQAtom, &tq, q_full, 32 * a,
                       x.q0, x.h, x.b);
          }
          const uint32_t vs = base + L::kV + 2 * s * L::kVHalf;
          mbar_wait(v_empty(s), parity);
          mbar_expect_tx(v_full(s), 2 * L::kVHalf);
          for (int a = 0; a < BK / 32; ++a)
            for (int hf = 0; hf < 2; ++hf)
              tma_load(vs + hf * L::kVHalf + a * L::kVAtom, &tv, v_full(s),
                       t * BK + 32 * a, 0, 2 * hk + hf, x.b);
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
    const int qrow = kHalves ? 0 : 64 * c;  // its first row of the Q tile
    // its first k-step of Q K^T and first column of O, and how many
    const int k0 = kHalves ? c * KMAX : 0;
    const int v0 = kHalves ? c * (DV / 2) : 0;
    const int ks = KS > 0 ? KC : min(max((p.D + 7) / 8 - k0, 0), KMAX);
    const int dv = VN > 0 ? VW : min(max(p.Dv - v0, 0), OW);
    const int nv = (dv + 63) / 64;  // chunks of O, the last lw wide
    const int last = dv - 64 * (nv - 1);
    const int lw = last <= 16 ? 16 : last <= 32 ? 32 : 64;
    int it = 0;     // KV tiles through the ring so far
    int round = 0;  // items so far
    for (int k = 0;; ++k) {  // the same slots as the producer's
      const int u = blockIdx.x + k / p.per_unit * gridDim.x;
      if (u >= p.units) break;
      Item x;
      if (!decode<BQ, BK>(p, u, k % p.per_unit, x)) continue;
      const int qc = x.q0 + qrow;                // the warpgroup's first row
      const int r0 = qc + warp * 16 + lane / 4;  // this lane's rows r0, r0 + 8
      const int n = x.t_hi - x.t_lo;
      auto stage = [&](int i) { return (it + i) % ST; };
      auto phase = [&](int i) { return ((it + i) / ST) & 1; };
      // does tile t cross an edge of the band or S for these rows?
      auto edge = [&](int t) {
        const int first = t * BK;
        return first + BK > S || (p.causal && first + BK - 1 > qc) ||
               (p.window > 0 && qc + 63 - first >= p.window);
      };

      float o[OW / 2];
#pragma unroll
      for (int i = 0; i < OW / 2; ++i) o[i] = 0.f;
      fence_regs(o);
      float m[2] = {kNegInf, kNegInf};
      float l[2] = {0.f, 0.f};  // this lane's share; the quad's at the end
      float sc[BK / 2], corr[2];
      uint32_t pb[BK / 8][4], ps[BK / 8][4];

      // Tile i: Q K^T of tile i, then P V of tile i - 1 behind it; the
      // softmax of tile i runs while that P V finishes. The first tile's
      // Q K^T and the last tile's P V run alone, so that no product sits
      // in a branch, and every wait comes before the products it guards
      // (a spin on an mbarrier between wgmma.fence and a product makes
      // ptxas serialize every product: C7520).
      auto qk = [&](int i) {  // Q K^T of tile i into sc, in flight
        issue_qk<BQ, QW, BK, KMAX, KC>(
            sc, sm, L::kQ, base + L::kK + 2 * stage(i) * L::kKHalf, k0, ks,
            qrow, warp, lane);
      };
      auto pv = [&](int i) {  // P V of tile i, its P split in pb, ps
        issue_pv<DV, BK, OW, VW>(o, pb, ps,
                                 base + L::kV + 2 * stage(i) * L::kVHalf,
                                 v0, nv, lw);
        wgmma_commit();
      };
      auto softmax_of = [&](int i) {  // once Q K^T of tile i is complete
        fence_regs(sc);
        if (lane == 0) {
          mbar_arrive(k_empty(stage(i)));  // this warp is done with K
          if (i == n - 1) mbar_arrive(q_empty);  // ... and with Q
        }
        if constexpr (kHalves) {
          // the scores are the sum of the two consumers' partials, the
          // same bits in both (lane-major tiles, two of each consumer by
          // the parity of the ring's tile count, so that one barrier a tile
          // suffices)
          const int par = (it + i) & 1;
          float* mine = reinterpret_cast<float*>(
                            sm + L::kX + (2 * c + par) * L::kXTile) + tid;
          const float* other = reinterpret_cast<const float*>(
                                   sm + L::kX + (2 * (c ^ 1) + par) *
                                                    L::kXTile) + tid;
#pragma unroll
          for (int e = 0; e < BK / 2; ++e) mine[e * 128] = sc[e];
          named_sync(1, 256);
#pragma unroll
          for (int e = 0; e < BK / 2; ++e) sc[e] += other[e * 128];
        }
        const int t = x.t_lo + i;
        if (edge(t))
          softmax<BK, true>(sc, m, l, corr, p, r0, t * BK, lane);
        else
          softmax<BK, false>(sc, m, l, corr, p, r0, t * BK, lane);
      };
      auto pv_done = [&](int i) {  // once P V of tile i is complete
        fence_regs(o);
        if (lane == 0) mbar_arrive(v_empty(stage(i)));  // done with V^T
      };
      auto rescale_and_split = [&] {  // O by corr; P into pb, ps
        // a warp whose rows kept their maxima (corr = 1 exactly) skips the
        // multiply, which would leave every bit as it is
        if (!__all_sync(0xffffffffu, corr[0] == 1.f && corr[1] == 1.f)) {
#pragma unroll
          for (int j = 0; j < OW / 8; ++j) {
            o[4 * j] *= corr[0];
            o[4 * j + 1] *= corr[0];
            o[4 * j + 2] *= corr[1];
            o[4 * j + 3] *= corr[1];
          }
        }
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const float xv[4] = {sc[4 * j], sc[4 * j + 2], sc[4 * j + 1],
                               sc[4 * j + 3]};
          split4(xv, pb[j], ps[j]);
        }
      };

      mbar_wait(q_full, round & 1);
      mbar_wait(k_full(stage(0)), phase(0));
      qk(0);
      wgmma_wait<0>();
      softmax_of(0);
      rescale_and_split();
      for (int i = 1; i < n; ++i) {
        mbar_wait(k_full(stage(i)), phase(i));
        mbar_wait(v_full(stage(i - 1)), phase(i - 1));
        qk(i);
        pv(i - 1);
        wgmma_wait<1>();  // Q K^T of tile i is complete
        softmax_of(i);
        wgmma_wait<0>();
        pv_done(i - 1);
        rescale_and_split();
      }
      mbar_wait(v_full(stage(n - 1)), phase(n - 1));
      wgmma_fence();
      pv(n - 1);
      wgmma_wait<0>();
      pv_done(n - 1);
      it += n;
      ++round;

      // normalise, and store this lane's rows as 8-byte pairs (its columns
      // of them where the consumers split O); rows past S and columns past
      // the consumer's share of Dv are not written
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float sum = l[r];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        sum = fmaxf(sum, 1e-30f);
        inv[r] = 1.f / sum;
        // the row's log-sum-exp for the backward, in the log2 domain of the
        // scores: log2 sum_j 2^(s_ij scale log2 e)
        const int qp = r0 + 8 * r;
        if (p.lse != nullptr && lane % 4 == 0 && qp < S &&
            (!kHalves || c == 0))
          p.lse[static_cast<long long>(x.b * p.H + x.h) * S + qp] =
              m[r] + log2f(sum);
      }
      float* out = p.o + x.b * p.o_sb + x.h * p.o_sh;
#pragma unroll
      for (int j = 0; j < OW / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r0 + 8 * r;
          const int col = v0 + 8 * j + 2 * (lane % 4);
          if (row < S && col < v0 + dv)
            *reinterpret_cast<float2*>(out + row * p.o_ss + col) =
                make_float2(o[4 * j + 2 * r] * inv[r],
                            o[4 * j + 2 * r + 1] * inv[r]);
        }
    }
  }
}

// One call: the pre-pass, then a block of 384 threads per SM (fewer where
// there are fewer work units), each taking units in turn. kv and vt are
// the pre-pass's halves of K and V^T (see flash_attention_fwd).
template <int BQ, int QW, int DV, int BK, int ST, int KS = 0, int VN = 0>
int launch(const Params& p, int B, float* kv, float* vt,
           cudaStream_t stream) {
  const int Hk = p.H / p.group;
  const int ld = (p.S + 7) & ~7, dp = (p.D + 7) & ~7;
  // the pre-pass needs no tensor map: the card runs it while they are
  // encoded
  flash_fwd_prep_kv<<<dim3((p.S + 31) / 32, B * Hk, 2), 256, 0, stream>>>(
      p, kv, vt, ld);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tq, tk, tv;
  const long long s_k = 4ll * p.S * dp, s_v = 4ll * p.Dv * ld;
  int err = make_map(&tq, p.q, p.D, p.S, p.H, B, 4 * p.q_ss, 4 * p.q_sh,
                     4 * p.q_sb, BQ, true);
  if (!err)
    err = make_map(&tk, kv, dp, p.S, 2 * Hk, B, 4ll * dp, s_k, 2 * Hk * s_k,
                   BK, true);
  if (!err)
    err = make_map(&tv, vt, ld, p.Dv, 2 * Hk, B, 4ll * ld, s_v,
                   2 * Hk * s_v, DV, true);
  if (err) return err;
  auto kernel = flash_fwd_tf32<BQ, QW, DV, BK, ST, KS, VN>;
  const size_t smem = Smem<BQ, QW, DV, BK, ST>::kBytes;
  static std::atomic<unsigned long long> attr_set{0};
  int sms = 0;
  err = device_setup(kernel, smem, attr_set, sms);
  if (err) return err;
  const int n_qt = (p.S + BQ - 1) / BQ;
  const int heads = B * p.H, per_head = (n_qt + 1) / 2;
  const int pairs = heads * per_head, singles = heads * n_qt;
  // The deal: pairs of a head's heaviest and lightest tiles where there
  // are as many pairs as SMs (flash_fwd_wgmma's rule), single tiles, every
  // head's heaviest first, otherwise; unless the other deal's makespan (the
  // most KV tiles a block takes, blocks taking units in turn) is smaller:
  // gemma3-1b's global layer, 128 pairs, takes pairs (34 tiles against 48;
  // at an equal makespan its window-512 layers measured faster as single
  // tiles). The search walks every unit, so each thread keeps the deals
  // of the last few shapes it launched.
  struct Deal {
    int heads, S, causal, window, sms, per_unit;
  };
  constexpr int kDeals = 8;
  thread_local Deal deals[kDeals] = {};  // heads 0: empty
  thread_local int next_deal = 0;
  int per_unit = 0;
  for (const Deal& d : deals)
    if (d.heads == heads && d.S == p.S && d.causal == p.causal &&
        d.window == p.window && d.sms == sms)
      per_unit = d.per_unit;
  if (per_unit == 0) {
    // KV tiles of query tile qt (decode's t_hi - t_lo)
    auto tiles = [&](int qt) {
      const int q0 = qt * BQ, q_last = (q0 + BQ < p.S ? q0 + BQ : p.S) - 1;
      const int kv_hi = p.causal ? q_last + 1 : p.S;
      const int kv_lo = p.window > 0 && q0 - p.window + 1 > 0
                            ? q0 - p.window + 1 : 0;
      return (kv_hi + BK - 1) / BK - kv_lo / BK;
    };
    auto makespan = [&](int per, int units) {
      const int blocks = units < sms ? units : sms;
      int most = 0;
      for (int b = 0; b < blocks; ++b) {
        int sum = 0;
        for (int u = b; u < units; u += blocks) {
          if (per == 1) {
            sum += tiles(n_qt - 1 - u / heads);
          } else {
            const int r = u % per_head;
            sum += tiles(n_qt - 1 - r) + (r != n_qt - 1 - r ? tiles(r) : 0);
          }
        }
        most = sum > most ? sum : most;
      }
      return most;
    };
    const int by_pairs = makespan(2, pairs), by_singles = makespan(1, singles);
    per_unit = pairs >= sms ? (by_singles < by_pairs ? 1 : 2)
                            : (by_pairs < by_singles ? 2 : 1);
    deals[next_deal] = {heads, p.S, p.causal, p.window, sms, per_unit};
    next_deal = (next_deal + 1) % kDeals;
  }
  const int units = per_unit == 2 ? pairs : singles;
  const Args args{B,        p.H,      p.group,
                  p.S,      p.D,      p.Dv,
                  p.scale * 1.4426950408889634f,
                  p.causal, p.window, units,
                  per_unit, static_cast<float*>(p.o),
                  p.o_sb,   p.o_sh,   p.o_ss,
                  p.lse};
  const int blocks = units < sms ? units : sms;
  kernel<<<blocks, kThreads, smem, stream>>>(tq, tk, tv, args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tf

// f32 tiles (template arguments BQ, QW, DV, BK, ST of tf::launch; shared
// memory in the header above); 384 threads a block.
int launch_tf32(const Params& p, int B, float* kv, float* vt,
                cudaStream_t stream) {
  if (p.D % 4 || p.Dv % 4 || kv == nullptr || vt == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hd = p.D > p.Dv ? p.D : p.Dv;
  if (hd <= 64) {
    if (p.D == 64 && p.Dv == 64)
      return tf::launch<128, 64, 64, 64, 2, 8, 64>(p, B, kv, vt, stream);
    return tf::launch<128, 64, 64, 64, 2>(p, B, kv, vt, stream);
  }
  if (hd <= 128) {
    if (p.D == 128 && p.Dv == 128)
      return tf::launch<128, 128, 128, 32, 2, 16, 128>(p, B, kv, vt, stream);
    if (p.D == 96 && p.Dv == 64)  // MLA: 64 nope + 32 rope; v 64
      return tf::launch<128, 96, 64, 64, 2, 12, 64>(p, B, kv, vt, stream);
    return tf::launch<128, 128, 128, 32, 2>(p, B, kv, vt, stream);
  }
  if (p.D == 160 && p.Dv == 160)  // stablelm-12b: 80 KiB of Q, one stage
    return tf::launch<128, 160, 160, 32, 1, 20, 160>(p, B, kv, vt, stream);
  if (p.D == 256 && p.Dv == 256)
    return tf::launch<64, 256, 256, 32, 1, 32, 256>(p, B, kv, vt, stream);
  return tf::launch<64, 256, 256, 32, 1>(p, B, kv, vt, stream);
}

// The return value of a call whose tensors break the layout rule (not a
// cudaError_t): the wrapper then names the tensor and the rule.
constexpr int kBadLayout = -1;

using hopper::layout_ok;

}  // namespace

extern "C" {

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The arguments of one forward call, packed by the wrapper into one block
// (flash_attention.py's _FWD_ARGS, "<4Q12q4Q7ifii": the 8-byte fields,
// then the 4-byte ones, so no padding), which one ctypes argument passes
// at a fifth of the host time of thirty.
// q (B,H,S,D), k (B,Hk,S,D), v (B,Hk,S,Dv), o (B,H,S,Dv), each given by its
// batch/head/seq strides in elements with a unit last stride; 16-byte
// aligned pointers, strides and head dims multiples of 16 bytes, which a
// call checks before all else (kBadLayout). dtype: 0 = float32 (flash_fwd_tf32), 1 = bfloat16 (flash_fwd_wgmma).
// window <= 0: no window. lse: null, or (f32 only) a contiguous (B, H, S)
// float32 output that takes each row's log-sum-exp in the log2 domain,
// log2 sum_j 2^(s_ij * scale * log2(e)), for the backward. kv, vt (f32
// only, else ignored): 16-byte aligned float32 scratch that the f32 call's
// pre-pass fills, (B, Hk, 2, S, D8) and (B, Hk, 2, Dv, ld) with D8 = D
// rounded up to 8 and ld = S rounded up to 8.
struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  void* lse;
  void* kv;
  void* vt;
  void* stream;
  int dtype, B, H, Hk, S, D, Dv;
  float scale;
  int causal, window;
};
static_assert(sizeof(FwdArgs) == 200, "the wrapper packs 200 bytes");

int flash_attention_fwd(const FwdArgs* a) {
  const int dtype = a->dtype, B = a->B, H = a->H, Hk = a->Hk, S = a->S;
  const int D = a->D, Dv = a->Dv;
  const int n = dtype == 0 ? 4 : 8;  // elements in 16 bytes
  if (!(layout_ok(a->q, D, a->q_sb, a->q_sh, a->q_ss, B, H, S, n) &&
        layout_ok(a->k, D, a->k_sb, a->k_sh, a->k_ss, B, Hk, S, n) &&
        layout_ok(a->v, Dv, a->v_sb, a->v_sh, a->v_ss, B, Hk, S, n) &&
        layout_ok(a->o, Dv, a->o_sb, a->o_sh, a->o_ss, B, H, S, n)))
    return kBadLayout;
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (Hk <= 0 || H % Hk || D <= 0 || D > kMaxD || Dv <= 0 || Dv > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{a->q,    a->k,    a->v,     a->o,      H,       H / Hk,
           S,       D,       Dv,       a->q_sb,   a->q_sh, a->q_ss,
           a->k_sb, a->k_sh, a->k_ss,  a->v_sb,   a->v_sh, a->v_ss,
           a->o_sb, a->o_sh, a->o_ss,  a->scale,  a->causal,
           a->window, static_cast<float*>(a->lse)};
  if (a->lse != nullptr && dtype != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(a->stream);
  if (dtype == 0)
    return launch_tf32(p, B, static_cast<float*>(a->kv),
                       static_cast<float*>(a->vt), st);
  if (dtype == 1) return launch_wgmma(p, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
