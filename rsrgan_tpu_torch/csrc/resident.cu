// The LSTM recurrences for Hopper with their weights resident in shared
// memory: the G-width ones across a persistent grid of one block per SM,
// the single-layer forward (K1) and the single-layer reverse walk with its
// weight gradients (K3) in one block per group of 16 rows.
//
// Two kernels, one design (K1 and K3 are described at their sections
// below):
// * lstm_bwd_resident_kernel replaces rsrgan_tpu/ops/pallas_lstm.py
//   `_bwd_kernel` (launched by `_bwd_pallas`, K2): the reverse walk over the
//   forward's saved gate activations; per step it emits dgates (dxw), the
//   masked m and the masked dh_total (the weight gradients are reduced
//   outside, lstm_weight_grads). In its acc mode it is K3's walk at G
//   width (`_bwd_kernel_acc`, see K3's section).
// * wavefront_resident_kernel replaces rsrgan_tpu/ops/pallas_wavefront.py
//   `_wavefront_kernel` (launched by `lstm_wavefront_fwd`, K4) in both of
//   its modes: all L layers in one program, layer k running k steps behind
//   layer 0, the top tap (decode) or, with `save`, every layer's tap, c, h
//   and gate activations de-skewed as [L, T, B, *] (training). At L = 1
//   with the residual off it is also K1 where one layer's weights do not
//   fit one SM (G width; K1's section below).
//
// What bounds them on the card: T (or T+L-1) dependent steps, each a pair
// of small products at M = B rows (K2: dh_total·projᵀ and dgates·W_hᵀ, 31
// MFLOP at U=760, P=257, B=16; K4: 200 MFLOP over four layers). The
// weights (1.95 MB per G layer, 12.5 MB for the stack in bf16) exceed one
// SM's shared memory, so the first kernels of this port (csrc/
// wavefront_fwd.cu, csrc/lstm_bwd.cu, which stream the weights) re-read
// them from L2 every step with scalar loads, and their K2 phase B had 18
// work items for 132 SMs: both were latency-bound at 34-40 µs per step.
//
// What this design does about it:
// * one cooperative launch of at most one block per SM (the Python plan,
//   `resident_plan` in ops/lstm_seq.py and ops/wavefront.py, sizes the
//   grid, the ownership and the shared-memory layout and passes them in);
// * block i owns a fixed slice of units (K4: of one layer). Before the
//   walk it copies its slice of the weights, packed by the wrapper in the
//   exact layout the products read, into shared memory; the slice stays
//   there for all steps. Only the row states (B × P) and per-step partials
//   cross L2;
// * phase A: the block stages the row state for all B rows, computes its
//   own units' gates (K4) or dm (K2), the cell math, and then its partial
//   of the next product over ALL P columns from its resident slice, written
//   to a scratch stream [blocks, B, P] in f32. The long K of that product
//   (K2: 4U = 3040) is thereby split evenly over every block;
// * grid.sync(); phase B: block j owns a few P columns (K4: (layer, column)
//   pairs) and sums the partials over the blocks in a fixed order, with no
//   atomics, so two launches give identical bits; then the masked carry
//   (K4: mask, freeze, residual tap, hand-off, save streams); grid.sync();
// * bf16: the in-block products run on tensor cores, mma.sync.m16n8k16
//   (bf16 operands, f32 accumulation) fed by ldmatrix, B padded to a
//   multiple of 16 rows, two 8-column tiles per warp so that each warp
//   keeps four accumulator chains going; f32: on CUDA cores (fmaf), one
//   weight row against 16 rows per task, K split over 8 lanes and reduced
//   by shuffles in a fixed order;
// * the per-step latencies are what is left (section timers below): each
//   thread keeps kBatch loads in flight when it stages the row state and
//   when it sums partials, the next step's inputs are prefetched into L2,
//   and bias, peepholes and lengths sit in shared memory;
// * residency is chosen by dtype and shape in the one kernel: the plan
//   keeps in shared memory as many rows of each packed weight slice as
//   fit (all of them in bf16 at the G widths; at full width in f32 the
//   gate weights do not fit beside the staging) and the kernel reads the
//   remaining rows of the same packed slice from global memory (L2) with
//   __ldg. That is not a fallback to another kernel: it is the same
//   product with the row pointer in another space.
//
// Precision (as the JAX kernels): operands of every product rounded to W
// (f32 or bf16), f32 accumulation, state, carries and gate math in f32.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSplit = 8;  // lanes per output in the f32 product
// Loads a thread keeps in flight when staging: B=16 rows of P=257 take
// one batch.
constexpr int kBatch = 20;

// Section timers for rsrgan_tpu_torch/tools/profile_resident.py, which
// builds this source with -DRESIDENT_PROFILE (the normal build compiles
// them to nothing): block 0 and the last block add the globaltimer
// nanoseconds of each section of a step to g_sections; a section ends at
// a block barrier, which the timers add.
#ifdef RESIDENT_PROFILE
__device__ unsigned long long g_sections[2][16];
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define SECTIONS_START unsigned long long t_section = now_ns()
#define SECTION_END(i)                                                 \
  do {                                                                 \
    __syncthreads();                                                   \
    if (threadIdx.x == 0 &&                                            \
        (blockIdx.x == 0 || blockIdx.x == gridDim.x - 1)) {            \
      const unsigned long long n_ = now_ns();                          \
      g_sections[blockIdx.x == 0 ? 0 : 1][i] += n_ - t_section;        \
      t_section = n_;                                                  \
    }                                                                  \
  } while (0)
#else
#define SECTIONS_START
#define SECTION_END(i) \
  do {                 \
  } while (0)
#endif

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
template <typename W>
__device__ __forceinline__ W to_w(float v);
template <>
__device__ __forceinline__ float to_w<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_w<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}
// Prefetches a span of at most 128 bytes (two lines at most) into L2.
__device__ __forceinline__ void prefetch_span(const void* p, size_t bytes) {
  prefetch_l2(p);
  prefetch_l2(static_cast<const char*>(p) + bytes - 1);
}
// A span of any length into L2, one 128-byte line a thread of the block.
__device__ __forceinline__ void prefetch_lines(const void* p, size_t bytes) {
  for (size_t i = (size_t)threadIdx.x * 128; i < bytes;
       i += (size_t)blockDim.x * 128)
    prefetch_l2(static_cast<const char*>(p) + i);
}

// The row of flat index e < 2^24 in rows of n columns, from the
// reciprocal 1/n (no integer division), corrected by one either way.
__device__ __forceinline__ int row_of(int e, int n, float inv_n) {
  int r = __float2int_rz(static_cast<float>(e) * inv_n);
  r -= r * n > e;
  r += (r + 1) * n <= e;
  return r;
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// Copies `bytes` (a multiple of 16, both ends 16-byte aligned) from global
// to shared memory, 16 bytes a thread.
__device__ void copy_to_shared(void* dst, const void* src, size_t bytes) {
  uint4* d = static_cast<uint4*>(dst);
  const uint4* s = static_cast<const uint4*>(src);
  for (size_t i = threadIdx.x; i < bytes / 16; i += blockDim.x)
    d[i] = __ldg(s + i);
}

// ---------------------------------------------------------------------------
// The in-block product. C[m, n] = sum_k A[m][k] * Wt[n][k] for m < M, n < N,
// with A in shared memory ([Mp][ld], W) and the weights packed K-contiguous
// ([Np][ld], W): row n is read from shared memory (`ws`) if n < n_res, else
// from the same packed slice in global memory (`wg`). K, Mp and Np are
// padded (K to 16, Mp to 16, Np to 8) and the pads hold zeros. `epi(m, n,
// v)` receives each result once. Every thread of the block must call it.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p, bool global) {
  return global ? __ldg(reinterpret_cast<const unsigned int*>(p))
                : *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  // not volatile: it only reads its operands, so the compiler may overlap
  // the tiles of one warp
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// NT neighbouring 16x8 tiles of C over the whole K, both operands in
// shared memory: ldmatrix for the fragments (A's shared by the tiles),
// two interleaved accumulator chains per tile (32 of K per iteration, a
// 16 tail), summed at the end (a fixed order).
template <int NT>
__device__ __forceinline__ void tiles_shared(const __nv_bfloat16* A,
                                             const __nv_bfloat16* Wt, int ld,
                                             int K, float (*c)[4]) {
  const int lane = threadIdx.x % 32;
  // A: lanes 0-15 rows 0-15 at k, lanes 16-31 the same rows at k + 8;
  // Wt: lane l reads row l % 8 (of tile t) at k + 8 * (l / 8)
  const uint32_t a_at =
      smem_addr(A + (size_t)(lane % 16) * ld + (lane / 16) * 8);
  uint32_t w_at[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t)
    w_at[t] = smem_addr(Wt + (size_t)(8 * t + lane % 8) * ld + (lane / 8) * 8);
  float d[NT][4] = {};
  int k0 = 0;
#pragma unroll 2
  for (; k0 + 32 <= K; k0 += 32) {
    uint32_t a[4], e[4];
    ldmatrix_x4(a, a_at + k0 * 2);
    ldmatrix_x4(e, a_at + (k0 + 16) * 2);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      uint32_t w[4];
      ldmatrix_x4(w, w_at[t] + k0 * 2);
      mma_bf16(c[t], a, w[0], w[1]);
      mma_bf16(d[t], e, w[2], w[3]);
    }
  }
  if (k0 < K) {
    uint32_t a[4];
    ldmatrix_x4(a, a_at + k0 * 2);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      uint32_t w[2];
      ldmatrix_x2(w, smem_addr(Wt + (size_t)(8 * t + lane % 8) * ld + k0 +
                               ((lane / 8) % 2) * 8));
      mma_bf16(c[t], a, w[0], w[1]);
    }
  }
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) c[t][r] += d[t][r];
}

// The same tile with the weight rows in global memory (a slice that did
// not fit in shared memory), loaded with __ldg.
__device__ __forceinline__ void tile_global(const __nv_bfloat16* A,
                                            const __nv_bfloat16* Wt, int ld,
                                            int K, float* c) {
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const __nv_bfloat16* wrow = Wt + (size_t)g * ld + 2 * tq;
  const __nv_bfloat16* a0 = A + (size_t)g * ld + 2 * tq;
  const __nv_bfloat16* a1 = a0 + (size_t)8 * ld;
#pragma unroll 4
  for (int k0 = 0; k0 < K; k0 += 16) {
    const uint32_t a[4] = {ld32(a0 + k0, false), ld32(a1 + k0, false),
                           ld32(a0 + k0 + 8, false),
                           ld32(a1 + k0 + 8, false)};
    mma_bf16(c, a, ld32(wrow + k0, true), ld32(wrow + k0 + 8, true));
  }
}

// bf16: one warp per 16-row, 16-column task of C (two 8-column tiles; one
// at an odd edge).
template <typename Epi>
__device__ void block_gemm(const __nv_bfloat16* A, const __nv_bfloat16* ws,
                           const __nv_bfloat16* wg, int ld, int n_res, int M,
                           int Mp, int N, int Np, int K, Epi epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int n_pairs = (Np + 15) / 16, tasks = (Mp / 16) * n_pairs;
  for (int task = warp; task < tasks; task += kWarps) {
    const int m0 = (task / n_pairs) * 16, n0 = (task % n_pairs) * 16;
    const int nt = n0 + 8 < Np ? 2 : 1;
    const __nv_bfloat16* a = A + (size_t)m0 * ld;
    float c[2][4] = {};
    if (n0 + 8 * nt <= n_res) {  // every row of the task is resident
      if (nt == 2)
        tiles_shared<2>(a, ws + (size_t)n0 * ld, ld, K, c);
      else
        tiles_shared<1>(a, ws + (size_t)n0 * ld, ld, K, c);
    } else {
#pragma unroll
      for (int t = 0; t < 2; ++t) {  // unrolled: c stays in registers
        const int n = n0 + 8 * t;
        if (t == nt) break;
        if (n + 8 <= n_res)
          tiles_shared<1>(a, ws + (size_t)n * ld, ld, K, c + t);
        else
          tile_global(a, wg + (size_t)n * ld, ld, K, c[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if (t == nt) break;
      const int mm = m0 + g, nn = n0 + 8 * t + 2 * tq;
      if (mm < M) {
        if (nn < N) epi(mm, nn, c[t][0]);
        if (nn + 1 < N) epi(mm, nn + 1, c[t][1]);
      }
      if (mm + 8 < M) {
        if (nn < N) epi(mm + 8, nn, c[t][2]);
        if (nn + 1 < N) epi(mm + 8, nn + 1, c[t][3]);
      }
    }
  }
}

// f32: a task is one weight row n against 16 rows of A; kSplit
// consecutive lanes stride over K, each weight read once per task, then a
// shuffle tree (a fixed order). The loop count is the same for every
// thread, so the shuffles always see a full warp.
template <typename Epi>
__device__ void block_gemm(const float* A, const float* ws, const float* wg,
                           int ld, int n_res, int M, int Mp, int N, int Np,
                           int K, Epi epi) {
  const int part = threadIdx.x % kSplit, group = threadIdx.x / kSplit;
  constexpr int kGroups = kThreads / kSplit;
  const int tasks = N * ((M + 15) / 16);
  for (int base = 0; base < tasks; base += kGroups) {
    const int task = base + group, n = task % N, m0 = (task / N) * 16;
    float acc[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) acc[r] = 0.0f;
    if (task < tasks) {
      const float* a = A + (size_t)m0 * ld;
      const bool global = n >= n_res;
      const float* w = (global ? wg : ws) + (size_t)n * ld;
#pragma unroll 4
      for (int k = part; k < K; k += kSplit) {
        const float wv = global ? __ldg(w + k) : w[k];
#pragma unroll
        for (int r = 0; r < 16; ++r)
          acc[r] = fmaf(a[(size_t)r * ld + k], wv, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int s = kSplit / 2; s > 0; s /= 2)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], s);
    if (task < tasks) {
#pragma unroll
      for (int r = 0; r < 16; ++r)
        if (r % kSplit == part && m0 + r < M) epi(m0 + r, n, acc[r]);
    }
  }
}

// The f32 products of K1's layer on the wavefront kernel (L = 1), where
// the block's gate columns are few (N = 4·NU) and K (P) is long, and the
// partial h has K = the block's units. Operands as block_gemm's; each
// gives an output's terms in a fixed order, so relaunches give the same
// bits.
//
// block_gemm_f32_wide: a task is kWideRows rows of A against kWide weight
// rows (N a multiple of kWide, A's rows padded to a multiple of
// kWideRows); kSplit lanes split K in float4 steps, so each A value read
// from shared memory feeds kWide products (block_gemm's f32 task reads A
// once per product), then the shuffle tree. Tasks of 8 rows, not 16, so
// that B=16 rows and 4·NU = 32 columns give every warp one.
constexpr int kWide = 4;
constexpr int kWideRows = 8;

template <typename Epi>
__device__ void block_gemm_f32_wide(const float* A, const float* ws,
                                    const float* wg, int ld, int n_res,
                                    int M, int N, int K, Epi epi) {
  const int part = threadIdx.x % kSplit, group = threadIdx.x / kSplit;
  constexpr int kGroups = kThreads / kSplit;
  const int ntask = N / kWide;
  const int tasks = ntask * ((M + kWideRows - 1) / kWideRows);
  for (int base = 0; base < tasks; base += kGroups) {
    const int task = base + group;
    const int n0 = (task % ntask) * kWide;
    const int m0 = (task / ntask) * kWideRows;
    float acc[kWideRows][kWide];
#pragma unroll
    for (int r = 0; r < kWideRows; ++r)
#pragma unroll
      for (int j = 0; j < kWide; ++j) acc[r][j] = 0.0f;
    if (task < tasks) {
      const float* a = A + (size_t)m0 * ld;
      const float* w[kWide];
#pragma unroll
      for (int j = 0; j < kWide; ++j)
        w[j] = (n0 + j < n_res ? ws : wg) + (size_t)(n0 + j) * ld;
      for (int k = 4 * part; k < K; k += 4 * kSplit) {
        float4 wv[kWide];
#pragma unroll
        for (int j = 0; j < kWide; ++j) {
          const float4* q = reinterpret_cast<const float4*>(w[j] + k);
          wv[j] = n0 + j >= n_res ? __ldg(q) : *q;
        }
#pragma unroll
        for (int r = 0; r < kWideRows; ++r) {
          const float4 av =
              *reinterpret_cast<const float4*>(a + (size_t)r * ld + k);
#pragma unroll
          for (int j = 0; j < kWide; ++j) {
            acc[r][j] = fmaf(av.x, wv[j].x, acc[r][j]);
            acc[r][j] = fmaf(av.y, wv[j].y, acc[r][j]);
            acc[r][j] = fmaf(av.z, wv[j].z, acc[r][j]);
            acc[r][j] = fmaf(av.w, wv[j].w, acc[r][j]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kWideRows; ++r)
#pragma unroll
      for (int j = 0; j < kWide; ++j)
#pragma unroll
        for (int s = kSplit / 2; s > 0; s /= 2)
          acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], s);
    if (task < tasks) {
#pragma unroll
      for (int r = 0; r < kWideRows; ++r)
#pragma unroll
        for (int j = 0; j < kWide; ++j)
          if ((r * kWide + j) % kSplit == part && m0 + r < M)
            epi(m0 + r, n0 + j, acc[r][j]);
    }
  }
}

// block_gemm_direct: the partial h of a block that owns a few units (K of
// 8 or so), where block_gemm's f32 task would split that K over 8 lanes
// and shuffle 16 sums back. A task is one weight row n (held in registers,
// kDirectK of K at a time) against kDirectRows rows of A; each output's
// terms are added in k order (a fixed order). Consecutive threads take
// consecutive n: their stores to a row-major C coalesce, they read A's
// rows as one broadcast, and the weight rows they read lie an odd stride
// apart (the plan's ld), one bank from the next.
constexpr int kDirectRows = 8;
constexpr int kDirectK = 8;

template <typename W, typename Epi>
__device__ void block_gemm_direct(const W* A, const W* ws, const W* wg,
                                  int ld, int n_res, int M, int N, int K,
                                  Epi epi) {
  const int tasks = N * ((M + kDirectRows - 1) / kDirectRows);
  for (int task = threadIdx.x; task < tasks; task += kThreads) {
    const int n = task % N, m0 = (task / N) * kDirectRows;
    const bool resident = n < n_res;
    const W* w = (resident ? ws : wg) + (size_t)n * ld;
    float acc[kDirectRows];
#pragma unroll
    for (int r = 0; r < kDirectRows; ++r) acc[r] = 0.0f;
    for (int k0 = 0; k0 < K; k0 += kDirectK) {
      float wr[kDirectK];
#pragma unroll
      for (int k = 0; k < kDirectK; ++k)
        wr[k] = k0 + k >= K  ? 0.0f
                : resident ? to_f(w[k0 + k])
                           : load(w + k0 + k);
#pragma unroll
      for (int r = 0; r < kDirectRows; ++r) {
        const W* a = A + (size_t)(m0 + r) * ld + k0;  // rows < Mp: padded
#pragma unroll
        for (int k = 0; k < kDirectK; ++k)
          if (k0 + k < K) acc[r] = fmaf(to_f(a[k]), wr[k], acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kDirectRows; ++r)
      if (m0 + r < M) epi(m0 + r, n, acc[r]);
  }
}

// Phase B's sum of one output: the n partials at src + j * stride (j =
// 0..n-1, one per block of the split) are shared by `tpi` threads (a
// power of two up to 32, neighbouring lanes); the one numbered `part`
// adds j = part, part + tpi, ... in turn, kBatch loads in flight, then a
// shuffle tree: a fixed order. Every lane of the warp must call it (with
// active = false where it has no output); all tpi lanes get the sum.
__device__ __forceinline__ float sum_partials(const float* src,
                                              size_t stride, int n, int tpi,
                                              int part, bool active) {
  float v = 0.0f;
  if (active) {
    for (int j0 = part; j0 < n; j0 += tpi * kBatch) {
      float x[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int j = j0 + q * tpi;
        x[q] = j < n ? __ldcg(src + j * stride) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) v += x[q];
    }
  }
  for (int s = tpi / 2; s > 0; s /= 2)
    v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// ---------------------------------------------------------------------------
// K2: the single-layer reverse walk (G backward; D backward at 16 rows).
// ---------------------------------------------------------------------------

struct BwdParams {
  const void* acts;     // [T, B, G] W, forward gate activations
  const int* lengths;   // [B]
  const float* dout;    // [T, B, P]
  const float* c_hist;  // [T, B, U] post-mask cell state
  const float* wi;      // [U] peepholes
  const float* wf;
  const float* wo;
  const void* proj_pk;  // [blocks][NUn][ld1] W: row u = proj[u0 + u, :P]
  const void* wh_pk;    // [blocks][Np][ld2] W: row p, column g*NU + u =
                        //   W_h[p, g*U + u0 + u]
  const int* bounds;    // unit_bounds[blocks + 1], col_bounds[blocks + 1]
  float* dh;            // [B, P] carry, zero on entry
  float* partial;       // [blocks, B, P] scratch
  void* dxw;            // [T, B, G] W
  void* m_out;          // [T, B, U] W, masked m
  void* dh_out;         // [T, B, P] W, masked dh_total
  float* dbias;         // [G] (acc only): sum of the f32 dgates
  float* dwi;           // [U] (acc only): peephole gradients
  float* dwf;
  float* dwo;
  int T, B, U, P, blocks, NU, NUn, K1, ld1, Np, K2, ld2, Mp;
  int n_res_proj, n_res_wh, tpi;
  int acc;  // K3's walk: also sum dbias and the peephole gradients
  int off_a, off_dm, off_dg, off_dc, off_k, off_proj, off_wh, smem;
};

// acc mode: the (row, unit) cells a thread owns, whose sums it keeps in
// registers for the whole walk (the plan keeps B * NU within kAccCells *
// kThreads)
constexpr int kAccCells = 8;

template <typename W, bool kAcc>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_bwd_resident_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int B = p.B, U = p.U, P = p.P, G = 4 * U, NU = p.NU;
  const int blk = blockIdx.x;
  const int u0 = p.bounds[blk], nu = p.bounds[blk + 1] - u0;
  const int c0 = p.bounds[p.blocks + 1 + blk];
  const int c1 = p.bounds[p.blocks + 2 + blk];
  W* s_a = reinterpret_cast<W*>(smem + p.off_a);         // [Mp][ld1]
  float* s_dm = reinterpret_cast<float*>(smem + p.off_dm);  // [B][NU]
  W* s_dg = reinterpret_cast<W*>(smem + p.off_dg);       // [Mp][ld2]
  float* s_dc = reinterpret_cast<float*>(smem + p.off_dc);  // [B][NU]
  // the block's peepholes [3][NU] (i, f, o), then the lengths [B]
  float* s_k = reinterpret_cast<float*>(smem + p.off_k);
  int* s_len = reinterpret_cast<int*>(s_k + 3 * NU);
  W* s_proj = reinterpret_cast<W*>(smem + p.off_proj);
  W* s_wh = reinterpret_cast<W*>(smem + p.off_wh);
  const W* g_proj = static_cast<const W*>(p.proj_pk) +
                    (size_t)blk * p.NUn * p.ld1;
  const W* g_wh = static_cast<const W*>(p.wh_pk) + (size_t)blk * p.Np * p.ld2;
  const float inv_p = 1.0f / P;

  copy_to_shared(s_proj, g_proj, (size_t)p.n_res_proj * p.ld1 * sizeof(W));
  copy_to_shared(s_wh, g_wh, (size_t)p.n_res_wh * p.ld2 * sizeof(W));
  for (int i = threadIdx.x; i < p.Mp * p.ld2; i += kThreads)
    s_dg[i] = to_w<W>(0.0f);  // pads stay zero for the whole walk
  for (int i = threadIdx.x; i < p.Mp * p.ld1; i += kThreads)
    s_a[i] = to_w<W>(0.0f);
  for (int i = threadIdx.x; i < B * NU; i += kThreads) s_dc[i] = 0.0f;
  for (int i = threadIdx.x; i < nu; i += kThreads) {
    s_k[i] = p.wi[u0 + i];
    s_k[NU + i] = p.wf[u0 + i];
    s_k[2 * NU + i] = p.wo[u0 + i];
  }
  for (int i = threadIdx.x; i < B; i += kThreads) s_len[i] = p.lengths[i];
  // acc: cell threadIdx.x + e * kThreads's dbias i, j, f, o and dw_i, dw_f,
  // dw_o terms, summed over the walk's steps in step order
  float sums[kAcc ? kAccCells : 1][7] = {};

  SECTIONS_START;
  for (int t = p.T - 1; t >= 0; --t) {
    // Phase A. Stage dh_total = dout(t) + dh for all rows, rounded to W;
    // the owners of columns [c0, c1) write the masked dh stream.
    __syncthreads();
    const int n_bp = B * P;
    for (int base = 0; base < n_bp; base += kThreads * kBatch) {
      float v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int e = base + j * kThreads + threadIdx.x;
        v[j] = e < n_bp ? p.dout[(size_t)t * n_bp + e] + __ldcg(p.dh + e)
                        : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int e = base + j * kThreads + threadIdx.x;
        if (e >= n_bp) break;
        const int b = row_of(e, P, inv_p), q = e - b * P;
        s_a[b * p.ld1 + q] = to_w<W>(v[j]);
        if (q >= c0 && q < c1)
          store(static_cast<W*>(p.dh_out) + (size_t)t * n_bp + e,
                t < s_len[b] ? v[j] : 0.0f);
      }
    }
    if (t > 0) {  // the next step's inputs, into L2 while this step runs
      const size_t row = (size_t)(t - 1) * B;
      const int lines = (n_bp * 4 + 127) / 128;
      for (int i = blk; i < lines; i += p.blocks)
        if (threadIdx.x == 0) prefetch_l2(p.dout + row * P + i * 32);
      for (int i = threadIdx.x; i < 6 * B; i += kThreads) {
        const int b = i / 6, g = i % 6;
        if (g < 4)
          prefetch_span(static_cast<const W*>(p.acts) + (row + b) * G +
                            g * U + u0, nu * sizeof(W));
        else if (g == 4)
          prefetch_span(p.c_hist + (row + b) * U + u0, nu * 4);
        else if (t > 1)
          prefetch_span(p.c_hist + (row - B + b) * U + u0, nu * 4);
      }
    }
    __syncthreads();
    SECTION_END(0);
    // dm = dh_total · projᵀ for the block's units
    block_gemm(s_a, s_proj, g_proj, p.ld1, p.n_res_proj, B, p.Mp, nu, p.NUn,
               p.K1, [&](int m, int n, float v) { s_dm[m * NU + n] = v; });
    __syncthreads();
    SECTION_END(1);
    // the peephole cell's reverse math; the dc carry stays in the block.
    // acc: cell i adds its dbias and peephole terms to cell_sums[7]
    auto cell = [&](int i, float* cell_sums) {
      const int b = i / nu, ul = i % nu, u = u0 + ul;
      const bool live = t < s_len[b];
      const float dm = live ? s_dm[b * NU + ul] : 0.0f;
      const size_t row = (size_t)t * B + b;
      const W* a = static_cast<const W*>(p.acts) + row * G + u;
      const float si = load(a), tj = load(a + U), sf = load(a + 2 * U),
                  so = load(a + 3 * U);
      const float c_new = p.c_hist[row * U + u];
      const float c_prev = t > 0 ? p.c_hist[(row - B) * U + u] : 0.0f;
      const float tc = tanhf(c_new);
      const float dc_old = s_dc[b * NU + ul];
      float d_o = dm * tc * so * (1.0f - so);
      const float dc_total = (live ? dc_old : 0.0f) +
                             dm * so * (1.0f - tc * tc) +
                             d_o * s_k[2 * NU + ul];
      float d_f = dc_total * c_prev * sf * (1.0f - sf);
      float d_i = dc_total * tj * si * (1.0f - si);
      float d_j = dc_total * si * (1.0f - tj * tj);
      const float dc_prev =
          dc_total * sf + d_f * s_k[NU + ul] + d_i * s_k[ul];
      if (!live) d_i = d_j = d_f = d_o = 0.0f;
      const float dgate[4] = {d_i, d_j, d_f, d_o};
      W* dx = static_cast<W*>(p.dxw) + row * G + u;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        store(dx + g * U, dgate[g]);
        s_dg[b * p.ld2 + g * NU + ul] = to_w<W>(dgate[g]);
      }
      store(static_cast<W*>(p.m_out) + row * U + u, live ? so * tc : 0.0f);
      s_dc[b * NU + ul] = live ? dc_prev : dc_old;
      if constexpr (kAcc) {
#pragma unroll
        for (int g = 0; g < 4; ++g) cell_sums[g] += dgate[g];
        if (live) {
          cell_sums[4] += d_i * c_prev;
          cell_sums[5] += d_f * c_prev;
          cell_sums[6] += d_o * c_new;
        }
      }
    };
    if constexpr (kAcc) {
#pragma unroll
      for (int e = 0; e < kAccCells; ++e) {  // unrolled: sums in registers
        const int i = threadIdx.x + e * kThreads;
        if (i >= B * nu) break;
        cell(i, sums[e]);
      }
    } else {
      for (int i = threadIdx.x; i < B * nu; i += kThreads) cell(i, nullptr);
    }
    __syncthreads();
    SECTION_END(2);
    // this block's partial of dh_prev = dgates · W_hᵀ over all P columns
    float* part = p.partial + (size_t)blk * B * P;
    block_gemm(s_dg, s_wh, g_wh, p.ld2, p.n_res_wh, B, p.Mp, P, p.Np, p.K2,
               [&](int m, int n, float v) { part[(size_t)m * P + n] = v; });
    SECTION_END(3);
    grid.sync();
    SECTION_END(4);
    // Phase B. Columns [c0, c1): sum the partials over the blocks in a
    // fixed order; a masked step passes dh through.
    const int nc = c1 - c0;
    for (int base = 0; base < B * nc * p.tpi; base += kThreads) {
      const int e = base + threadIdx.x, i = e / p.tpi;
      const bool active = i < B * nc;
      const size_t o = active ? (size_t)(i / nc) * P + c0 + i % nc : 0;
      const float v = sum_partials(p.partial + o, (size_t)B * P, p.blocks,
                                   p.tpi, e % p.tpi, active);
      if (active && e % p.tpi == 0 && t < s_len[i / nc]) p.dh[o] = v;
    }
    SECTION_END(5);
    grid.sync();
    SECTION_END(6);
  }
  if constexpr (kAcc) {
    // each unit's seven sums over its rows in row order, through shared
    // memory [7][B][NU] laid over the staging of A (the plan sizes it);
    // no other block owns these units, so they are written once, here
    float* s_sum = reinterpret_cast<float*>(smem + p.off_a);
#pragma unroll
    for (int e = 0; e < kAccCells; ++e) {
      const int i = threadIdx.x + e * kThreads;
      if (i >= B * nu) break;
      const int b = i / nu, ul = i % nu;
#pragma unroll
      for (int k = 0; k < 7; ++k)
        s_sum[((size_t)k * B + b) * NU + ul] = sums[e][k];
    }
    __syncthreads();
    for (int j = threadIdx.x; j < 7 * nu; j += kThreads) {
      const int k = j / nu, ul = j % nu, u = u0 + ul;
      const float* src = s_sum + (size_t)k * B * NU + ul;
      float v = 0.0f;
      for (int b = 0; b < B; ++b) v += src[(size_t)b * NU];
      if (k < 4)
        p.dbias[k * U + u] = v;
      else
        (k == 4 ? p.dwi : k == 5 ? p.dwf : p.dwo)[u] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// K4: the wavefront forward, both modes. Block i is (layer k, unit slice j).
// ---------------------------------------------------------------------------

struct FwdParams {
  const void* xw1;     // [T, B, G] W, layer-1 input projection
  const float* x;      // [T, B, P] raw inputs (layer-1 residual; may be
                       //   null with the residual off, never read then)
  const int* lengths;  // [B]
  const void* wg_pk;   // [L*nbl][NG][ldw] W: row g*NU + u of block (k, j) =
                       //   [W_h[k][:, col] | W_x[k-1][:, col] (k >= 1) | 0],
                       //   col = g*U + u0 + u
  const void* wp_pk;   // [L*nbl][Np][ldm] W: row p, column u =
                       //   proj[k][u0 + u][p]
  const float* bias;   // [L, G], forget_bias folded in
  const float* wi;     // [L, U] peepholes
  const float* wf;
  const float* wo;
  const int* bounds;   // unit_bounds[nbl + 1], pair_bounds[blocks + 1]
  float* h;            // [L, B, P] recurrent output state, zero on entry
  float* inbuf;        // [2, L, B, P] hand-off, slot (s & 1) read at step s
  float* partial;      // [L, nbl, B, P] scratch: per-block parts of m·proj
  float* y;            // [T, B, P] top tap (decode mode only)
  float* tap_s;        // [L, T, B, P] save mode only, as wavefront_fwd.cu
  float* c_s;          // [L, T, B, U]
  float* h_s;          // [L, T, B, P]
  void* acts;          // [L, T, B, G] W
  int T, B, L, U, P, residual, save, nbl, NU, NG, Kp, ldw, Np, Km, ldm, Mp;
  int n_res_g, n_res_p, tpi;
  int off_a, off_gate, off_m, off_c, off_k, off_wg, off_wp, smem;
};

template <typename W>
__global__ void __launch_bounds__(kThreads, 1)
    wavefront_resident_kernel(const FwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int B = p.B, L = p.L, U = p.U, P = p.P, G = 4 * U, NU = p.NU;
  const int NG = p.NG;
  const int blk = blockIdx.x, k = blk / p.nbl, j = blk % p.nbl;
  const int u0 = p.bounds[j], nu = p.bounds[j + 1] - u0;
  const int pair0 = p.bounds[p.nbl + 1 + blk];
  const int pair1 = p.bounds[p.nbl + 2 + blk];
  W* s_a = reinterpret_cast<W*>(smem + p.off_a);              // [Mp][ldw]
  float* s_gate = reinterpret_cast<float*>(smem + p.off_gate);  // [B][NG]
  W* s_m = reinterpret_cast<W*>(smem + p.off_m);              // [Mp][ldm]
  float* s_c = reinterpret_cast<float*>(smem + p.off_c);      // [B][NU]
  // the block's bias [4][NU] and peepholes [3][NU] (i, f, o), then the
  // lengths [B]
  float* s_k = reinterpret_cast<float*>(smem + p.off_k);
  int* s_len = reinterpret_cast<int*>(s_k + 7 * NU);
  W* s_wg = reinterpret_cast<W*>(smem + p.off_wg);
  W* s_wp = reinterpret_cast<W*>(smem + p.off_wp);
  const W* g_wg = static_cast<const W*>(p.wg_pk) + (size_t)blk * NG * p.ldw;
  const W* g_wp = static_cast<const W*>(p.wp_pk) + (size_t)blk * p.Np * p.ldm;
  const size_t slot = (size_t)L * B * P;
  const float inv_p = 1.0f / P;

  copy_to_shared(s_wg, g_wg, (size_t)p.n_res_g * p.ldw * sizeof(W));
  copy_to_shared(s_wp, g_wp, (size_t)p.n_res_p * p.ldm * sizeof(W));
  for (int i = threadIdx.x; i < p.Mp * p.ldm; i += kThreads)
    s_m[i] = to_w<W>(0.0f);  // pads stay zero for the whole launch
  for (int i = threadIdx.x; i < p.Mp * p.ldw; i += kThreads)
    s_a[i] = to_w<W>(0.0f);  // so do these, and layer 0's in-part
  for (int i = threadIdx.x; i < B * NU; i += kThreads) s_c[i] = 0.0f;
  for (int i = threadIdx.x; i < nu; i += kThreads) {
#pragma unroll
    for (int g = 0; g < 4; ++g)
      s_k[g * NU + i] = p.bias[(size_t)k * G + g * U + u0 + i];
    s_k[4 * NU + i] = p.wi[(size_t)k * U + u0 + i];
    s_k[5 * NU + i] = p.wf[(size_t)k * U + u0 + i];
    s_k[6 * NU + i] = p.wo[(size_t)k * U + u0 + i];
  }
  for (int i = threadIdx.x; i < B; i += kThreads) s_len[i] = p.lengths[i];

  SECTIONS_START;
  for (int s = 0; s < p.T + L - 1; ++s) {
    const float* in_cur = p.inbuf + (size_t)(s & 1) * slot;
    float* in_next = p.inbuf + (size_t)((s + 1) & 1) * slot;
    const int t = s - k;
    // Phase A (the whole block skips a step outside its layer's wavefront,
    // so every block reaches both grid barriers of every step).
    if (t >= 0 && t < p.T) {
      __syncthreads();
      // A = [h_k | in_k | 0] for all rows, rounded to W (layer 0 reads its
      // input projection from xw1: its in-part is zero; at L = 1 the plan
      // drops that part, K = Kp = P padded, and A is [h | 0])
      const float* hk = p.h + (size_t)k * B * P;
      const float* ink = in_cur + (size_t)k * B * P;
      const int n_bp = B * P;
      for (int base = 0; base < n_bp; base += kThreads * kBatch) {
        float vh[kBatch], vi[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int e = base + j * kThreads + threadIdx.x;
          vh[j] = e < n_bp ? __ldcg(hk + e) : 0.0f;
          vi[j] = e < n_bp && k > 0 ? __ldcg(ink + e) : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int e = base + j * kThreads + threadIdx.x;
          if (e >= n_bp) break;
          const int b = row_of(e, P, inv_p), q = e - b * P;
          s_a[b * p.ldw + q] = to_w<W>(vh[j]);
          if (L > 1) s_a[b * p.ldw + P + q] = to_w<W>(vi[j]);
        }
      }
      if (k == 0 && t + 1 < p.T)  // the next step's input projection
        for (int i = threadIdx.x; i < 4 * B; i += kThreads)
          prefetch_span(static_cast<const W*>(p.xw1) +
                            ((size_t)(t + 1) * B + i / 4) * G +
                            (i % 4) * U + u0,
                        nu * sizeof(W));
      __syncthreads();
      SECTION_END(8);
      const auto gate_out = [&](int m, int n, float v) {
        s_gate[m * NG + n] = v;
      };
      if constexpr (std::is_same<W, float>::value) {
        if (L == 1)  // K1's layer: few gate columns, a long K
          block_gemm_f32_wide(s_a, s_wg, g_wg, p.ldw, p.n_res_g, B, NG, p.Kp,
                              gate_out);
        else
          block_gemm(s_a, s_wg, g_wg, p.ldw, p.n_res_g, B, p.Mp, NG, NG,
                     p.Kp, gate_out);
      } else {
        block_gemm(s_a, s_wg, g_wg, p.ldw, p.n_res_g, B, p.Mp, NG, NG, p.Kp,
                   gate_out);
      }
      __syncthreads();
      SECTION_END(9);
      // the peephole cell update; c stays in the block for the whole launch
      for (int i = threadIdx.x; i < B * nu; i += kThreads) {
        const int b = i / nu, ul = i % nu, u = u0 + ul;
        float gate[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float sum = s_gate[b * NG + g * NU + ul];
          if (k == 0)
            sum += load(static_cast<const W*>(p.xw1) +
                        ((size_t)t * B + b) * G + g * U + u);
          gate[g] = sum + s_k[g * NU + ul];
        }
        const float c_prev = s_c[b * NU + ul];
        const float si = sigmoid(gate[0] + s_k[4 * NU + ul] * c_prev);
        const float tj = tanhf(gate[1]);
        const float sf = sigmoid(gate[2] + s_k[5 * NU + ul] * c_prev);
        const float c_new = sf * c_prev + si * tj;
        const float so = sigmoid(gate[3] + s_k[6 * NU + ul] * c_new);
        const bool live = t < s_len[b];
        s_c[b * NU + ul] = live ? c_new : c_prev;
        s_m[b * p.ldm + ul] = to_w<W>(so * tanhf(c_new));
        if (p.save) {
          const size_t row = ((size_t)k * p.T + t) * B + b;
          p.c_s[row * U + u] = live ? c_new : c_prev;
          W* a = static_cast<W*>(p.acts) + row * G + u;
          store(a, si);
          store(a + U, tj);
          store(a + 2 * U, sf);
          store(a + 3 * U, so);
        }
      }
      __syncthreads();
      SECTION_END(10);
      // this block's partial of h = m · proj over all P columns
      float* part = p.partial + (size_t)blk * B * P;
      const auto put = [&](int m, int n, float v) {
        part[(size_t)m * P + n] = v;
      };
      if (std::is_same<W, float>::value && L == 1)  // K = the block's units
        block_gemm_direct(s_m, s_wp, g_wp, p.ldm, p.n_res_p, B, P, nu, put);
      else
        block_gemm(s_m, s_wp, g_wp, p.ldm, p.n_res_p, B, p.Mp, P, p.Np, p.Km,
                   put);
    }
    SECTION_END(11);
    grid.sync();
    SECTION_END(12);
    // Phase B. (layer, column) pairs [pair0, pair1): sum the layer's
    // partials over its blocks in a fixed order, then mask, freeze, tap
    // and hand-off as wavefront_fwd.cu. pair = layer * P + column;
    // consecutive outputs are consecutive columns, so the reads coalesce.
    const int npairs = pair1 - pair0;
    for (int base = 0; base < npairs * B * p.tpi; base += kThreads) {
      const int e = base + threadIdx.x, i = e / p.tpi;
      const int pair = pair0 + i % max(npairs, 1), b = i / max(npairs, 1);
      const int kk = pair / P, cc = pair % P, tt = s - kk;
      const bool active = i < npairs * B && tt >= 0 && tt < p.T;
      const bool lead = active && e % p.tpi == 0;
      const size_t hi = ((size_t)kk * B + b) * P + cc;
      // the epilogue's loads go out before the sum's
      float h_prev = 0.0f, res = 0.0f;
      if (lead) {
        h_prev = __ldcg(p.h + hi);
        if (p.residual)
          res = kk == 0 ? p.x[((size_t)tt * B + b) * P + cc]
                        : __ldcg(in_cur + hi);
      }
      const float h_new = sum_partials(
          p.partial + ((size_t)kk * p.nbl * B + b) * P + cc, (size_t)B * P,
          p.nbl, p.tpi, e % p.tpi, active);
      if (lead) {
        const bool live = tt < s_len[b];
        if (live) p.h[hi] = h_new;  // a masked row keeps its state
        const float tap = (live ? h_new : 0.0f) + res;
        if (kk + 1 < L)
          in_next[((size_t)(kk + 1) * B + b) * P + cc] = tap;
        else if (!p.save)  // in save mode the top tap is tap_s[L-1]
          p.y[((size_t)tt * B + b) * P + cc] = tap;
        if (p.save) {
          const size_t si = (((size_t)kk * p.T + tt) * B + b) * P + cc;
          p.tap_s[si] = tap;
          p.h_s[si] = live ? h_new : h_prev;
        }
      }
    }
    SECTION_END(13);
    grid.sync();
    SECTION_END(14);
  }
}

// ---------------------------------------------------------------------------
// K1: the single-layer forward, one block per group of at most 16 rows.
//
// This is K1's design where the whole layer fits one SM's shared memory
// (the D layer; ops/lstm_seq.py `fwd_route`). Where it does not (G width:
// W_h alone is 1.56 MB in bf16), K1 runs on K4's kernel above at L = 1
// with the residual off, whose save streams at L = 1 are K1's: its grid
// (at G width 48 blocks of 16 units in bf16, 95 of 8 in f32) spreads W_h
// and proj over as many SMs, each slice resident for the whole walk, and
// a single layer's gate product drops the dead in-part (K = P padded);
// in f32 its two products take block_gemm_f32_wide and block_gemm_direct.
// This kernel at G width held none of W_h in shared memory and re-read it
// from L2 in every one of its 16-32 blocks at every step (~83 µs a step
// in bf16; PERF.md).
//
// Replaces rsrgan_tpu/ops/pallas_lstm.py `_fwd_kernel` (launched by
// `_fwd_pallas`): one layer over T from a precomputed input projection xw,
// with peepholes, the projection h = m·proj and masking; with `save` also
// c_hist, h_hist (post-mask state) and the gate activations [si, tj, sf,
// so] in W at every step.
//
// What bounds it on the card: T dependent steps of two small products (D:
// 16 rows × 40 × 1024 for the gates, 16 × 256 × 40 for the projection:
// 1.6 MFLOP a step) and the cell math between them; the bytes (xw in, the
// streams out) are ~0.01-0.02 ms at 3.35 TB/s. The first port of K1 (the
// streaming wavefront of csrc/wavefront_fwd.cu at L = 1) split a step over
// the grid in 16 and 4 work items between two grid barriers and re-read
// W_h and proj from L2 with scalar loads: ~10 µs a step. A step here is a
// chain of shared-memory, mma and MUFU latencies between three block
// barriers (~3.6-3.9 µs at D width, bf16; PERF.md).
//
// What this design does about it:
// * rows are independent in the forward, so a block owns a group of rows
//   and walks all T steps alone: a plain launch, block barriers only, no
//   grid barrier. The Python plan (`rowgroup_plan` in ops/lstm_seq.py)
//   fixes the groups, sizes and offsets: as few rows a block as the card's
//   SMs allow (one at the D step's 16 and 32 rows), because each SM then
//   runs fewer cells and moves fewer stream bytes a step, while the
//   products, which the tensor cores finish in a few cycles at any row
//   count up to 16, are not repeated more than the blocks;
// * the block copies the packed W_h and proj into shared memory once (the
//   whole D layer in bf16: ~136 KB). Rows that do not fit (f32 at D width,
//   any dtype at G width) are read from the same packed slice in global
//   memory, as the kernels above do;
// * step t's xw rows arrive in shared memory by cp.async, issued during
//   step t - 1; the cell phase reads them there and writes the gate
//   activations in their place, which leave (with c_hist, from the cell
//   state in shared memory) as coalesced 16-byte stores: no thread touches
//   the streams at the mma fragments' scattered positions;
// * the gate product: warp w owns the unit groups q = w, w + 16, ... of 8
//   units; W_h is packed so that the four gate tiles (i, j, f, o) of a
//   group are 32 consecutive rows, so a thread's accumulators hold the four
//   pre-activations of the same (row, unit) and the cell update runs in
//   registers with no barrier. With one row a block, a warp takes two
//   groups at once and shuffles the live values so that 16 lanes run one
//   cell each (in f32, lanes dot their own unit's rows, K split over two
//   lanes); the nonlinearities use ex2.approx / rcp.approx (a few ulp);
// * the projection: m (rounded to W) goes to a shared A operand; after one
//   barrier the warps split the (8-column tile, K chunk) tasks (D: 5
//   tiles x 3 chunks of 6 k-steps, two accumulator chains each), write
//   f32 partials for the group's rows to shared memory, and after another
//   the epilogue sums each output's ks partials in chunk order (a fixed
//   order: relaunches give the same bits), masks, carries and stores, and
//   writes round_W(h) into the next step's A operand; a third barrier
//   ends the step;
// * bf16 products on mma.sync.m16n8k16 fed by ldmatrix, f32 on CUDA cores
//   (fmaf) at the same fragment positions, so the cell code is shared.
// ---------------------------------------------------------------------------

constexpr int kRowThreads = 512;
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kRows = 16;  // rows of the mma tile (M): a group's most

struct RowParams {
  const void* xw;       // [T, B, G] W
  const int* lengths;   // [B]
  const void* wh_pk;    // [ngrp * 32][ldh] W: row 32q + 8g + i =
                        //   W_h[:, g*U + 8q + i] (zero past U)
  const void* wp_pk;    // [Np][ldm] W: row p = proj[:, p]
  const float* bias;    // [G], forget_bias folded in
  const float* wi;      // [U] peepholes
  const float* wf;
  const float* wo;
  const int* rows;      // row_bounds[groups + 1]
  float* out;           // [T, B, P]
  float* c_hist;        // [T, B, U] (save only)
  float* h_hist;        // [T, B, P] (save only)
  void* acts;           // [T, B, G] W (save only)
  int T, B, U, P, save, groups, grows, ngrp, Kh, ldh, Np, Km, ldm, ks;
  int kchunk, ldx, xchunk, n_res_h, n_res_p;
  int off_x, off_h, off_m, off_c, off_hf, off_part, off_k, off_wh, off_wp;
  int smem;
};

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  // the clobber keeps the compiler from moving this thread's earlier
  // reads of dst past the copy
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
}

// The cell's nonlinearities for K1 from ex2.approx and rcp.approx (f32,
// a few ulp): the accurate expf, division and tanhf cost ~3x the
// instructions, and here every cell of the block runs on one SM.
__device__ __forceinline__ float sigmoid_fast(float v) {
  return __fdividef(1.0f, 1.0f + __expf(-v));
}
__device__ __forceinline__ float tanh_fast(float v) {
  return 2.0f * sigmoid_fast(2.0f * v) - 1.0f;
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The group's rows of the xw / acts stream at step t, in xchunk-byte
// chunks (16, or 8 where a row is not a multiple of 16 bytes), against
// s_x [16][ldx]: with `out`, copies the acts that the cell phase wrote
// into s_x to step t - 1 of the acts stream; with `in` (t < T), loads
// step t's xw into s_x with cp.async. A thread handles the same chunks in
// both, so its load of a chunk is consumed before its cp.async overwrites
// it.
template <typename W>
__device__ __forceinline__ void swap_x(const RowParams& p, W* s_x, int t,
                                       int row0, int nrows, bool out,
                                       bool in) {
  const size_t row_bytes = (size_t)4 * p.U * sizeof(W);
  const int per_row = (int)(row_bytes / p.xchunk);
  const char* src = static_cast<const char*>(p.xw) +
                    ((size_t)t * p.B + row0) * row_bytes;
  char* dst = static_cast<char*>(p.acts) +
              ((size_t)(t - 1) * p.B + row0) * row_bytes;
  for (int i = threadIdx.x; i < nrows * per_row; i += kRowThreads) {
    const int r = i / per_row;
    const size_t c = (size_t)(i - r * per_row) * p.xchunk;
    char* sx = reinterpret_cast<char*>(s_x + (size_t)r * p.ldx) + c;
    const size_t g = r * row_bytes + c;
    if (out) {
      if (p.xchunk == 16)
        *reinterpret_cast<uint4*>(dst + g) = *reinterpret_cast<uint4*>(sx);
      else
        *reinterpret_cast<uint2*>(dst + g) = *reinterpret_cast<uint2*>(sx);
    }
    if (in) cp_async(sx, src + g, p.xchunk);
  }
}

// The four gate tiles of one unit group (w: its 32 packed rows) against
// the 16 rows of A over K: acc[g][r] at the mma C positions (r = 0, 1: row
// lane/4, columns 2*(lane%4) and +1; r = 2, 3: the same at row lane/4 + 8).
__device__ __forceinline__ void gate_tiles(const __nv_bfloat16* A,
                                           const __nv_bfloat16* w,
                                           bool shared, int ld, int K,
                                           float (*acc)[4]) {
  const int lane = threadIdx.x % 32;
  const uint32_t a_at =
      smem_addr(A + (size_t)(lane % 16) * ld + (lane / 16) * 8);
  if (shared) {
    const uint32_t w_at =
        smem_addr(w + (size_t)(lane % 8) * ld + ((lane / 8) % 2) * 8);
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, a_at + k0 * 2);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        uint32_t b[2];
        ldmatrix_x2(b, w_at + (uint32_t)(g * 8 * ld + k0) * 2);
        mma_bf16(acc[g], a, b[0], b[1]);
      }
    }
  } else {
    const __nv_bfloat16* wrow = w + (size_t)(lane / 4) * ld + 2 * (lane % 4);
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, a_at + k0 * 2);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const __nv_bfloat16* r = wrow + (size_t)g * 8 * ld + k0;
        mma_bf16(acc[g], a, ld32(r, true), ld32(r + 8, true));
      }
    }
  }
}

__device__ __forceinline__ void gate_tiles(const float* A, const float* w,
                                           bool shared, int ld, int K,
                                           float (*acc)[4]) {
  const int lane = threadIdx.x % 32;
  const float* a0 = A + (size_t)(lane / 4) * ld;
  const float* a1 = a0 + (size_t)8 * ld;
  const float* wr = w + (size_t)2 * (lane % 4) * ld;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float x0 = a0[k], x1 = a1[k];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float* r = wr + (size_t)g * 8 * ld + k;
      const float w0 = shared ? r[0] : __ldg(r);
      const float w1 = shared ? r[ld] : __ldg(r + ld);
      acc[g][0] = fmaf(x0, w0, acc[g][0]);
      acc[g][1] = fmaf(x0, w1, acc[g][1]);
      acc[g][2] = fmaf(x1, w0, acc[g][2]);
      acc[g][3] = fmaf(x1, w1, acc[g][3]);
    }
  }
}

// One 16x8 tile of the projection (w: the tile's 8 packed rows) over K in
// [k0, k1), into c at the mma C positions.
__device__ __forceinline__ void proj_tile(const __nv_bfloat16* A,
                                          const __nv_bfloat16* w, bool shared,
                                          int ld, int k0, int k1, int,
                                          float* c) {
  const int lane = threadIdx.x % 32;
  const uint32_t a_at =
      smem_addr(A + (size_t)(lane % 16) * ld + (lane / 16) * 8);
  const uint32_t w_at =
      smem_addr(w + (size_t)(lane % 8) * ld + ((lane / 8) % 2) * 8);
  const __nv_bfloat16* wrow = w + (size_t)(lane / 4) * ld + 2 * (lane % 4);
  auto step = [&](float* acc, int k) {
    uint32_t a[4], b[2];
    ldmatrix_x4(a, a_at + k * 2);
    if (shared) {
      ldmatrix_x2(b, w_at + k * 2);
    } else {
      b[0] = ld32(wrow + k, true);
      b[1] = ld32(wrow + k + 8, true);
    }
    mma_bf16(acc, a, b[0], b[1]);
  };
  float d[4] = {};  // a second chain for the odd k-steps, added last
  int k = k0;
  for (; k + 32 <= k1; k += 32) {
    step(c, k);
    step(d, k + 16);
  }
  if (k < k1) step(c, k);
#pragma unroll
  for (int r = 0; r < 4; ++r) c[r] += d[r];
}

__device__ __forceinline__ void proj_tile(const float* A, const float* w,
                                          bool shared, int ld, int k0, int k1,
                                          int K, float* c) {
  const int lane = threadIdx.x % 32;
  const float* a0 = A + (size_t)(lane / 4) * ld;
  const float* a1 = a0 + (size_t)8 * ld;
  const float* r = w + (size_t)2 * (lane % 4) * ld;
#pragma unroll 4
  for (int k = k0; k < min(k1, K); ++k) {
    const float x0 = a0[k], x1 = a1[k];
    const float w0 = shared ? r[k] : __ldg(r + k);
    const float w1 = shared ? r[ld + k] : __ldg(r + ld + k);
    c[0] = fmaf(x0, w0, c[0]);
    c[1] = fmaf(x0, w1, c[1]);
    c[2] = fmaf(x1, w0, c[2]);
    c[3] = fmaf(x1, w1, c[3]);
  }
}

template <typename W>
__global__ void __launch_bounds__(kRowThreads, 1)
    lstm_fwd_rowgroup_kernel(const RowParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kBf16 = sizeof(W) == 2;
  const int U = p.U, P = p.P, G = 4 * U;
  const int row0 = p.rows[blockIdx.x];
  const int nrows = p.rows[blockIdx.x + 1] - row0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  W* s_x = reinterpret_cast<W*>(smem + p.off_x);          // [rows][ldx]
  W* s_h = reinterpret_cast<W*>(smem + p.off_h);          // [16][ldh]
  W* s_m = reinterpret_cast<W*>(smem + p.off_m);          // [16][ldm]
  float* s_c = reinterpret_cast<float*>(smem + p.off_c);  // [rows][U]
  float* s_hf = reinterpret_cast<float*>(smem + p.off_hf);  // [rows][P]
  float* s_part =
      reinterpret_cast<float*>(smem + p.off_part);  // [ks][grows][Np]
  // bias [4][U], peepholes [3][U] (i, f, o), then the rows' lengths [16]
  float* s_k = reinterpret_cast<float*>(smem + p.off_k);
  int* s_len = reinterpret_cast<int*>(s_k + 7 * U);
  W* s_wh = reinterpret_cast<W*>(smem + p.off_wh);
  W* s_wp = reinterpret_cast<W*>(smem + p.off_wp);
  const W* g_wh = static_cast<const W*>(p.wh_pk);
  const W* g_wp = static_cast<const W*>(p.wp_pk);
  const float inv_p = 1.0f / P, inv_u = 1.0f / U;

  swap_x(p, s_x, 0, row0, nrows, false, true);
  copy_to_shared(s_wh, g_wh, (size_t)p.n_res_h * p.ldh * sizeof(W));
  copy_to_shared(s_wp, g_wp, (size_t)p.n_res_p * p.ldm * sizeof(W));
  // the A operands' pads (rows past nrows, K past P or U) stay zero
  for (int i = threadIdx.x; i < kRows * p.ldh; i += kRowThreads)
    s_h[i] = to_w<W>(0.0f);
  for (int i = threadIdx.x; i < kRows * p.ldm; i += kRowThreads)
    s_m[i] = to_w<W>(0.0f);
  // the plan sizes s_c and s_hf (and s_x) for the group's rows only
  for (int i = threadIdx.x; i < nrows * U; i += kRowThreads) s_c[i] = 0.0f;
  for (int i = threadIdx.x; i < nrows * P; i += kRowThreads) s_hf[i] = 0.0f;
  for (int i = threadIdx.x; i < U; i += kRowThreads) {
#pragma unroll
    for (int g = 0; g < 4; ++g) s_k[g * U + i] = p.bias[g * U + i];
    s_k[4 * U + i] = p.wi[i];
    s_k[5 * U + i] = p.wf[i];
    s_k[6 * U + i] = p.wo[i];
  }
  for (int i = threadIdx.x; i < nrows; i += kRowThreads)
    s_len[i] = p.lengths[row0 + i];
  cp_async_wait_all();
  __syncthreads();

  const int own = warp < p.ngrp ? (p.ngrp - 1 - warp) / kRowWarps + 1 : 0;
  const int K_gate = kBf16 ? p.Kh : P;
  const int n_tiles = p.Np / 8;
  const size_t step_bytes = (size_t)nrows * G * sizeof(W);

  SECTIONS_START;
  for (int t = 0; t < p.T; ++t) {
    if (t + 2 < p.T)  // step t + 2's xw rows into L2
      prefetch_lines(static_cast<const char*>(p.xw) +
                         ((size_t)(t + 2) * p.B + row0) * G * sizeof(W),
                     step_bytes);
    // the peephole cell of (row, unit u) from its four gate products;
    // reads xw from s_x and leaves the activations in its place
    auto cell = [&](int row, int u, const float* pre) {
      W* x = s_x + (size_t)row * p.ldx + u;  // xw in, acts out
      float gate[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        gate[g] = (to_f(x[g * U]) + pre[g]) + s_k[g * U + u];
      const float c_prev = s_c[row * U + u];
      const float si = sigmoid_fast(gate[0] + s_k[4 * U + u] * c_prev);
      const float tj = tanh_fast(gate[1]);
      const float sf = sigmoid_fast(gate[2] + s_k[5 * U + u] * c_prev);
      const float c_new = sf * c_prev + si * tj;
      const float so = sigmoid_fast(gate[3] + s_k[6 * U + u] * c_new);
      const float c_kept = t < s_len[row] ? c_new : c_prev;
      s_c[row * U + u] = c_kept;
      s_m[row * p.ldm + u] = to_w<W>(so * tanh_fast(c_new));
      if (p.save) {
        x[0] = to_w<W>(si);
        x[U] = to_w<W>(tj);
        x[2 * U] = to_w<W>(sf);
        x[3 * U] = to_w<W>(so);
      }
    };
    auto gates_of = [&](int q, float (*acc)[4]) {
      const bool res = (q + 1) * 32 <= p.n_res_h;
      gate_tiles((const W*)s_h,
                 (res ? s_wh : g_wh) + (size_t)q * 32 * p.ldh, res, p.ldh,
                 K_gate, acc);
    };
    if (nrows == 1) {
      // One row (the main path's groups): only lanes 0-3 hold live
      // products, so the warp takes its groups in pairs and moves each
      // live value to its own lane (lane l: unit l % 8 of the pair's
      // group l / 8), so that 16 lanes run one cell each.
      for (int j = 0; j < own; j += 2) {
        const int qa = warp + j * kRowWarps;
        const bool two = j + 1 < own;
        const int half = (lane / 8) % 2;
        const int q = qa + half * kRowWarps, u = 8 * q + lane % 8;
        float pre[4];
        if constexpr (kBf16) {
          float acc[2][4][4] = {};
          gates_of(qa, acc[0]);
          if (two) gates_of(qa + kRowWarps, acc[1]);
          const int src = (lane % 8) / 2;
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            const float a0 = __shfl_sync(0xffffffffu, acc[0][g][0], src);
            const float a1 = __shfl_sync(0xffffffffu, acc[0][g][1], src);
            const float b0 = __shfl_sync(0xffffffffu, acc[1][g][0], src);
            const float b1 = __shfl_sync(0xffffffffu, acc[1][g][1], src);
            pre[g] = lane % 2 ? (half ? b1 : a1) : (half ? b0 : a0);
          }
        } else {
          // f32 on CUDA cores: lane l dots h with its unit's four packed
          // gate rows over half of K (lanes l and l + 16 split it), and
          // one shuffle adds the halves (the same sum on both lanes)
          const bool res = (q + 1) * 32 <= p.n_res_h;
          const W* w =
              (res ? s_wh : g_wh) + ((size_t)q * 32 + lane % 8) * p.ldh;
          const int k0 = lane < 16 ? 0 : P / 2, k1 = lane < 16 ? P / 2 : P;
#pragma unroll
          for (int g = 0; g < 4; ++g) pre[g] = 0.0f;
          if (half < (two ? 2 : 1)) {
#pragma unroll 4
            for (int k = k0; k < k1; ++k) {
              const float hk = s_h[k];
#pragma unroll
              for (int g = 0; g < 4; ++g) {
                const W* r = w + (size_t)g * 8 * p.ldh + k;
                pre[g] = fmaf(hk, res ? *r : __ldg(r), pre[g]);
              }
            }
          }
#pragma unroll
          for (int g = 0; g < 4; ++g)
            pre[g] += __shfl_xor_sync(0xffffffffu, pre[g], 16);
        }
        if (lane < 16 && half < (two ? 2 : 1) && u < U) cell(0, u, pre);
      }
    } else {
      // the fragment's own positions: rows lane/4 (+8), units 2*(lane%4)
      // (+1) of each group
      for (int j = 0; j < own; ++j) {
        const int q = warp + j * kRowWarps;
        float acc[4][4] = {};
        gates_of(q, acc);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = lane / 4 + (r / 2) * 8;
          const int u = 8 * q + 2 * (lane % 4) + r % 2;
          if (row >= nrows || u >= U) continue;
          const float pre[4] = {acc[0][r], acc[1][r], acc[2][r], acc[3][r]};
          cell(row, u, pre);
        }
      }
    }
    __syncthreads();
    SECTION_END(0);
    // the saved streams out of shared memory, coalesced, and the next
    // step's xw in; then the projection's (tile, K chunk) partials
    swap_x(p, s_x, t + 1, row0, nrows, p.save, t + 1 < p.T);
    if (p.save)
      for (int e = threadIdx.x; e < nrows * U; e += kRowThreads) {
        const int b = row_of(e, U, inv_u);
        p.c_hist[((size_t)t * p.B + row0 + b) * U + e - b * U] = s_c[e];
      }
    for (int task = warp; task < n_tiles * p.ks; task += kRowWarps) {
      const int tile = task % n_tiles, ck = task / n_tiles;
      const bool res = (tile + 1) * 8 <= p.n_res_p;
      const int k0 = ck * p.kchunk * 16;
      float c[4] = {};
      proj_tile((const W*)s_m,
                (res ? s_wp : g_wp) + (size_t)tile * 8 * p.ldm, res, p.ldm,
                k0, min(k0 + p.kchunk * 16, p.Km), U, c);
      float* part = s_part + (size_t)ck * p.grows * p.Np + tile * 8 +
                    2 * (lane % 4);
      const int row = lane / 4;
      if (row < nrows) {
        part[row * p.Np] = c[0];
        part[row * p.Np + 1] = c[1];
      }
      if (row + 8 < nrows) {
        part[(row + 8) * p.Np] = c[2];
        part[(row + 8) * p.Np + 1] = c[3];
      }
    }
    __syncthreads();
    SECTION_END(1);
    // the epilogue: sum the chunks in order, mask, carry, store
    for (int e = threadIdx.x; e < nrows * P; e += kRowThreads) {
      const int b = row_of(e, P, inv_p), col = e - b * P;
      float v = 0.0f;
      for (int ck = 0; ck < p.ks; ++ck)
        v += s_part[((size_t)ck * p.grows + b) * p.Np + col];
      const bool live = t < s_len[b];
      const float h = live ? v : s_hf[b * P + col];
      s_hf[b * P + col] = h;
      s_h[b * p.ldh + col] = to_w<W>(h);
      const size_t o = ((size_t)t * p.B + row0 + b) * P + col;
      p.out[o] = live ? v : 0.0f;
      if (p.save) p.h_hist[o] = h;
    }
    cp_async_wait_all();
    __syncthreads();
    SECTION_END(2);
  }
}

// ---------------------------------------------------------------------------
// K3: the single-layer reverse walk with its weight gradients, one block per
// group of at most 16 rows (lstm_bwd_rowgroup_kernel), then the reduction
// of the weight gradients (lstm_wgrad_kernel).
//
// Replaces rsrgan_tpu/ops/pallas_lstm.py `_bwd_kernel_acc` (launched by
// `_bwd_pallas_acc`): the reverse walk over the forward's saved gate
// activations, emitting dgates (dxw), with dW_h, dproj, dbias and the
// peephole gradients summed in the kernel over all T·B row-steps.
//
// What bounds it on the card: as K1, T dependent steps of two small
// products (D, per row: 40 × 256 for dm = dh_total·projᵀ, 1024 × 40 for
// dh = dgates·W_hᵀ) with the reverse cell between them; the weight-gradient
// products (T·B·5·U·P multiply-adds, 1.6 GFLOP at D width, 32 rows, T=500)
// have no step dependency. The first port (csrc/lstm_bwd.cu, acc = 1) split
// each step over a cooperative grid between two grid barriers, re-read W_hᵀ
// and projᵀ from L2 every step and reduced an f32 dgates stream [T, B, 4U]
// after the walk (8.6 ms at D width, 32 rows, T=500 on an H100).
//
// What this design does about it:
// * the walk is K1's design run backwards: rows are independent in the
//   reverse walk too, so a block owns a group of rows (one row a block at
//   the D step's 32 and 64 rows) and walks all T steps alone, a plain
//   launch with block barriers only. The Python plan (`rowgroup_bwd_plan`
//   in ops/lstm_seq.py) fixes the groups, sizes and offsets;
// * the block copies proj (packed row u = proj[u, :], the B operand of dm)
//   and W_h (row p = W_h[p, :], the B operand of dh) into shared memory
//   once: the whole D layer, ~111 KB in bf16. Rows that do not fit (larger
//   groups) are read from the same packed weights in global memory;
// * a step: warp w computes the dm tiles of its unit groups (K1's owner
//   rule: q = w, w + 16, ...), and each of its lanes runs the reverse cell
//   of one unit of them right away, row by row, with no block barrier in
//   between. The dc carry stays in shared memory; the owning lane adds its
//   unit's dbias, dw_i, dw_f and dw_o terms in registers over the whole
//   walk and writes them once, as its group's partial (no f32 dgates
//   stream). dgates (W) go to the dh product's A operand; a barrier; dxw
//   leaves from there in coalesced chunks, the next step's acts and c(t-2)
//   arrive by cp.async, the epilogue's threads load dout(t-1), and the
//   warps split the dh product into (8-column tile, K chunk) tasks (D: 5
//   tiles x 3 chunks of 22 k-steps) with f32 partials; a barrier; the
//   epilogue sums the chunks in chunk order, masks the dh carry and writes
//   dh_total(t-1), rounded to W, into the dm product's A operand and,
//   masked, to the dh stream; a barrier;
// * bf16 products on mma.sync fed by ldmatrix (A padded to 16 rows); f32
//   on CUDA cores with the A operands holding the group's rows only, so
//   that the f32 D layer fits as well (at one row a block): dm by the
//   cell's lane (its unit's proj row), dh one warp an output over all of
//   K with a shuffle tree (the plan then has one K chunk);
// * lstm_wgrad_kernel then sums dW_h = Σ round_W(h(t-1))ᵀ·dxw(t) and
//   dproj = Σ m_maskedᵀ·dh_masked over the T·B row-steps, K split over
//   enough blocks to fill the card, a 64 × 64 output tile a block (bf16 on
//   tensor cores: mma.sync fed by ldmatrix.trans from the K-major streams;
//   f32 on CUDA cores); the last block of a tile to finish sums its splits
//   in split order, and dbias and the peepholes are the walk's group
//   partials summed in group order. Every output is summed in one fixed
//   order, with no atomics on values: relaunches give the same bits.
//
// At G width (U=760, P=257: every G layer's backward at B >= 32) the layer
// does not fit one block, so K3's walk is K2's resident grid in its acc
// mode (lstm_bwd_resident_kernel<W, true>, above): the same walk and
// streams, and each block sums the dbias and peephole terms of its own
// units, a thread's (row, unit) cells in registers over the steps, then
// over the rows in row order, written once (no other block owns those
// units: no partials, no atomics); then the same lstm_wgrad_kernel. The
// first port (csrc/lstm_bwd.cu) took 33 ms a layer there at B=32, T=500.
// ---------------------------------------------------------------------------

constexpr int kEpi = 2;  // epilogue elements a thread: group rows × P ≤ 1024

struct RowBwdParams {
  const void* acts;     // [T, B, G] W, forward gate activations
  const int* lengths;   // [B]
  const float* dout;    // [T, B, P]
  const float* c_hist;  // [T, B, U] post-mask cell state
  const void* wp_pk;    // [ngrp * 8][ld1] W: row u = proj[u, :P] (zero
                        //   past U)
  const void* wh_pk;    // [Np][ld2] W: row p = W_h[p, :G] (zero past P)
  const float* wi;      // [U] peepholes
  const float* wf;
  const float* wo;
  const int* rows;      // row_bounds[groups + 1]
  void* dxw;            // [T, B, G] W
  void* m_out;          // [T, B, U] W, masked m
  void* dh_out;         // [T, B, P] W, masked dh_total
  float* part;          // [groups][7U]: dbias [4U], dw_i, dw_f, dw_o [U]
  int T, B, U, P, groups, grows, ngrp, K1, ld1, K2, ld2, Np, ks, kchunk;
  int lda, achunk, ldc, cchunk, n_res_p, n_res_h;
  int off_a1, off_a2, off_dm, off_acts, off_c, off_dc, off_part, off_len;
  int off_wp, off_wh, smem;
};

// nrows rows of row_bytes (a multiple of chunk: 16, 8 or 4 bytes, as are
// the shared-memory row stride and both bases), consecutive in global
// memory, into shared memory by cp.async, chunk bytes a thread at a time.
__device__ __forceinline__ void stage_rows(void* dst, int dst_ld,
                                           const void* src, int nrows,
                                           int row_bytes, int chunk) {
  const int per_row = row_bytes / chunk;
  for (int i = threadIdx.x; i < nrows * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i - r * per_row) * chunk;
    cp_async(static_cast<char*>(dst) + (size_t)r * dst_ld + c,
             static_cast<const char*>(src) + (size_t)r * row_bytes + c,
             chunk);
  }
}

// The reverse: nrows rows from shared memory (stride src_ld) to
// consecutive rows in global memory, in 16- or 8-byte chunks.
__device__ __forceinline__ void unstage_rows(void* dst, const void* src,
                                             int src_ld, int nrows,
                                             int row_bytes, int chunk) {
  const int per_row = row_bytes / chunk;
  for (int i = threadIdx.x; i < nrows * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i - r * per_row) * chunk;
    char* d = static_cast<char*>(dst) + (size_t)r * row_bytes + c;
    const char* s = static_cast<const char*>(src) + (size_t)r * src_ld + c;
    if (chunk == 16)
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    else
      *reinterpret_cast<uint2*>(d) = *reinterpret_cast<const uint2*>(s);
  }
}

template <typename W>
__global__ void __launch_bounds__(kRowThreads, 1)
    lstm_bwd_rowgroup_kernel(const RowBwdParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kBf16 = sizeof(W) == 2;
  const int B = p.B, U = p.U, P = p.P, G = 4 * U, Nu = 8 * p.ngrp;
  const int row0 = p.rows[blockIdx.x];
  const int nrows = p.rows[blockIdx.x + 1] - row0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the A operands, 16 rows in bf16 (mma) and the group's in f32
  W* s_a1 = reinterpret_cast<W*>(smem + p.off_a1);  // [rows][ld1] dh_total
  W* s_a2 = reinterpret_cast<W*>(smem + p.off_a2);  // [rows][ld2] dgates
  float* s_dm = reinterpret_cast<float*>(smem + p.off_dm);  // [rows][Nu]
  W* s_acts = reinterpret_cast<W*>(smem + p.off_acts);      // [rows][lda]
  // [2][grows][ldc]: slot t & 1 holds c(t)
  float* s_c = reinterpret_cast<float*>(smem + p.off_c);
  float* s_dc = reinterpret_cast<float*>(smem + p.off_dc);  // [rows][U]
  float* s_part =
      reinterpret_cast<float*>(smem + p.off_part);  // [ks][grows][Np]
  int* s_len = reinterpret_cast<int*>(smem + p.off_len);  // [16]
  W* s_wp = reinterpret_cast<W*>(smem + p.off_wp);
  W* s_wh = reinterpret_cast<W*>(smem + p.off_wh);
  const W* g_wp = static_cast<const W*>(p.wp_pk);
  const W* g_wh = static_cast<const W*>(p.wh_pk);
  const W* acts = static_cast<const W*>(p.acts);
  W* dh_out = static_cast<W*>(p.dh_out);
  const size_t slot = (size_t)p.grows * p.ldc;
  const int a_bytes = G * (int)sizeof(W), c_bytes = U * 4;
  const int n_el = nrows * P;  // the epilogue's elements
  const float inv_p = 1.0f / P;
  auto at = [&](int t) { return (size_t)t * B + row0; };  // step t's row 0

  // step T-1's acts, c(T-1) and c(T-2) in; the weights; the A operands'
  // pads (rows past nrows, K past P or 4U) stay zero for the whole walk
  stage_rows(s_acts, p.lda * (int)sizeof(W), acts + at(p.T - 1) * G, nrows,
             a_bytes, p.achunk);
  for (int t = p.T - 1; t >= 0 && t >= p.T - 2; --t)
    stage_rows(s_c + (t & 1) * slot, p.ldc * 4, p.c_hist + at(t) * U, nrows,
               c_bytes, p.cchunk);
  copy_to_shared(s_wp, g_wp, (size_t)p.n_res_p * p.ld1 * sizeof(W));
  copy_to_shared(s_wh, g_wh, (size_t)p.n_res_h * p.ld2 * sizeof(W));
  const int a_rows = kBf16 ? kRows : p.grows;  // mma tiles take 16 rows
  for (int i = threadIdx.x; i < a_rows * p.ld1; i += kRowThreads)
    s_a1[i] = to_w<W>(0.0f);
  for (int i = threadIdx.x; i < a_rows * p.ld2; i += kRowThreads)
    s_a2[i] = to_w<W>(0.0f);
  for (int i = threadIdx.x; i < nrows * U; i += kRowThreads) s_dc[i] = 0.0f;
  for (int i = threadIdx.x; i < nrows; i += kRowThreads)
    s_len[i] = p.lengths[row0 + i];
  __syncthreads();
  // dh_total(T-1) = dout(T-1): the dh carry starts at zero. Thread and
  // element stay paired for the whole walk, so the carry lives in dh[].
  float dh[kEpi];
#pragma unroll
  for (int i = 0; i < kEpi; ++i) {
    dh[i] = 0.0f;
    const int e = threadIdx.x + i * kRowThreads;
    if (e < n_el) {
      const int b = row_of(e, P, inv_p), col = e - b * P;
      const float v = p.dout[at(p.T - 1) * P + e];
      s_a1[b * p.ld1 + col] = to_w<W>(v);
      store(dh_out + at(p.T - 1) * P + e, p.T - 1 < s_len[b] ? v : 0.0f);
    }
  }
  // the warp's unit groups (at most 4) and this lane's unit: lane l runs
  // the cell of unit l % 8 of group warp + 16 * (l / 8)
  const int own = warp < p.ngrp ? (p.ngrp - 1 - warp) / kRowWarps + 1 : 0;
  const int u = 8 * (warp + (lane / 8) * kRowWarps) + lane % 8;
  const bool cell_lane = lane / 8 < own && u < U;
  const float wi = cell_lane ? p.wi[u] : 0.0f;
  const float wf = cell_lane ? p.wf[u] : 0.0f;
  const float wo = cell_lane ? p.wo[u] : 0.0f;
  float acc[7] = {};  // dbias i, j, f, o; dw_i, dw_f, dw_o of unit u
  cp_async_wait_all();
  __syncthreads();

  SECTIONS_START;
  for (int t = p.T - 1; t >= 0; --t) {
    if (t >= 2) {  // step t - 2's streams into L2
      prefetch_lines(acts + at(t - 2) * G, (size_t)nrows * a_bytes);
      prefetch_lines(p.dout + at(t - 2) * P, (size_t)n_el * 4);
      if (t >= 3)
        prefetch_lines(p.c_hist + at(t - 3) * U, (size_t)nrows * c_bytes);
    }
    // dm = dh_total · projᵀ for the warp's unit groups, into s_dm
    if constexpr (kBf16) {
      for (int j = 0; j < own; ++j) {
        const int q = warp + j * kRowWarps;
        const bool res = (q + 1) * 8 <= p.n_res_p;
        float c[4] = {};
        proj_tile((const W*)s_a1,
                  (res ? s_wp : g_wp) + (size_t)q * 8 * p.ld1, res, p.ld1, 0,
                  p.K1, P, c);
        const int row = lane / 4, col = 8 * q + 2 * (lane % 4);
        if (row < nrows) {
          s_dm[row * Nu + col] = c[0];
          s_dm[row * Nu + col + 1] = c[1];
        }
        if (row + 8 < nrows) {
          s_dm[(row + 8) * Nu + col] = c[2];
          s_dm[(row + 8) * Nu + col + 1] = c[3];
        }
      }
    } else if (cell_lane) {
      // f32 on CUDA cores: the cell's lane dots its unit's proj row with
      // each row's dh_total (the A operand has the group's rows only)
      const bool res = u < p.n_res_p;
      const W* w = (res ? s_wp : g_wp) + (size_t)u * p.ld1;
      for (int b = 0; b < nrows; ++b) {
        const W* a = s_a1 + (size_t)b * p.ld1;
        float v = 0.0f;
#pragma unroll 4
        for (int k = 0; k < P; ++k)
          v = fmaf(a[k], res ? w[k] : __ldg(w + k), v);
        s_dm[b * Nu + u] = v;
      }
    }
    __syncwarp();
    // the peephole cell's reverse math for unit u, row by row
    if (cell_lane) {
      const float* c_cur = s_c + (t & 1) * slot;
      const float* c_pre = s_c + ((t + 1) & 1) * slot;  // c(t-1) if t > 0
      for (int b = 0; b < nrows; ++b) {
        const bool live = t < s_len[b];
        const float dm = live ? s_dm[b * Nu + u] : 0.0f;
        const W* a = s_acts + (size_t)b * p.lda + u;
        const float si = to_f(a[0]), tj = to_f(a[U]), sf = to_f(a[2 * U]),
                    so = to_f(a[3 * U]);
        const float c_new = c_cur[b * p.ldc + u];
        const float c_prev = t > 0 ? c_pre[b * p.ldc + u] : 0.0f;
        const float tc = tanhf(c_new);
        const float dc_old = s_dc[b * U + u];
        const float d_o = dm * tc * so * (1.0f - so);
        const float dc_total = (live ? dc_old : 0.0f) +
                               dm * so * (1.0f - tc * tc) + d_o * wo;
        const float d_f = dc_total * c_prev * sf * (1.0f - sf);
        const float d_i = dc_total * tj * si * (1.0f - si);
        const float d_j = dc_total * si * (1.0f - tj * tj);
        s_dc[b * U + u] = live ? dc_total * sf + d_f * wf + d_i * wi : dc_old;
        const float dgate[4] = {live ? d_i : 0.0f, live ? d_j : 0.0f,
                                live ? d_f : 0.0f, live ? d_o : 0.0f};
        W* g = s_a2 + (size_t)b * p.ld2 + u;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          g[k * U] = to_w<W>(dgate[k]);
          acc[k] += dgate[k];
        }
        if (live) {
          acc[4] += d_i * c_prev;
          acc[5] += d_f * c_prev;
          acc[6] += d_o * c_new;
        }
        store(static_cast<W*>(p.m_out) + (at(t) + b) * U + u,
              live ? so * tc : 0.0f);
      }
    }
    __syncthreads();
    SECTION_END(0);
    // dxw(t) out of s_a2; step t-1's acts and c(t-2) in; dout(t-1) into
    // the epilogue's registers; then the dh product's (tile, K chunk)
    // partials
    unstage_rows(static_cast<W*>(p.dxw) + at(t) * G, s_a2,
                 p.ld2 * (int)sizeof(W), nrows, a_bytes, p.achunk);
    if (t > 0)
      stage_rows(s_acts, p.lda * (int)sizeof(W), acts + at(t - 1) * G, nrows,
                 a_bytes, p.achunk);
    if (t > 1)
      stage_rows(s_c + (t & 1) * slot, p.ldc * 4, p.c_hist + at(t - 2) * U,
                 nrows, c_bytes, p.cchunk);
    float dn[kEpi];
#pragma unroll
    for (int i = 0; i < kEpi; ++i) {
      const int e = threadIdx.x + i * kRowThreads;
      dn[i] = t > 0 && e < n_el ? __ldg(p.dout + at(t - 1) * P + e) : 0.0f;
    }
    if constexpr (kBf16) {
      const int n_tiles = p.Np / 8;
      for (int task = warp; task < n_tiles * p.ks; task += kRowWarps) {
        const int tile = task % n_tiles, ck = task / n_tiles;
        const bool res = (tile + 1) * 8 <= p.n_res_h;
        const int k0 = ck * p.kchunk * 16;
        float c[4] = {};
        proj_tile((const W*)s_a2,
                  (res ? s_wh : g_wh) + (size_t)tile * 8 * p.ld2, res, p.ld2,
                  k0, min(k0 + p.kchunk * 16, p.K2), G, c);
        float* part = s_part + (size_t)ck * p.grows * p.Np + tile * 8 +
                      2 * (lane % 4);
        const int row = lane / 4;
        if (row < nrows) {
          part[row * p.Np] = c[0];
          part[row * p.Np + 1] = c[1];
        }
        if (row + 8 < nrows) {
          part[(row + 8) * p.Np] = c[2];
          part[(row + 8) * p.Np + 1] = c[3];
        }
      }
    } else {
      // f32 on CUDA cores (the plan's one chunk): a warp an output (row,
      // column), its lanes striding over K, then a shuffle tree (a fixed
      // order)
      for (int o = warp; o < n_el; o += kRowWarps) {
        const int b = o / P, col = o - b * P;
        const bool res = col < p.n_res_h;
        const W* w = (res ? s_wh : g_wh) + (size_t)col * p.ld2;
        const W* a = s_a2 + (size_t)b * p.ld2;
        float v = 0.0f, v2 = 0.0f;  // two chains, added last
        int k = lane;
        for (; k + 32 < G; k += 64) {
          v = fmaf(a[k], res ? w[k] : __ldg(w + k), v);
          v2 = fmaf(a[k + 32], res ? w[k + 32] : __ldg(w + k + 32), v2);
        }
        if (k < G) v = fmaf(a[k], res ? w[k] : __ldg(w + k), v);
        v += v2;
#pragma unroll
        for (int s = 16; s > 0; s /= 2)
          v += __shfl_xor_sync(0xffffffffu, v, s);
        if (lane == 0) s_part[b * p.Np + col] = v;
      }
    }
    __syncthreads();
    SECTION_END(1);
    // the epilogue: the chunks summed in chunk order, the masked dh carry,
    // and dh_total(t-1) = dout(t-1) + dh
#pragma unroll
    for (int i = 0; i < kEpi; ++i) {
      const int e = threadIdx.x + i * kRowThreads;
      if (e < n_el) {
        const int b = row_of(e, P, inv_p), col = e - b * P;
        float v = 0.0f;
        for (int ck = 0; ck < p.ks; ++ck)
          v += s_part[((size_t)ck * p.grows + b) * p.Np + col];
        if (t < s_len[b]) dh[i] = v;  // a masked step passes dh through
        if (t > 0) {
          const float d = dn[i] + dh[i];
          s_a1[b * p.ld1 + col] = to_w<W>(d);
          store(dh_out + at(t - 1) * P + e, t - 1 < s_len[b] ? d : 0.0f);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
    SECTION_END(2);
  }
  if (cell_lane) {
    float* out = p.part + (size_t)blockIdx.x * 7 * U + u;
#pragma unroll
    for (int k = 0; k < 7; ++k) out[k * U] = acc[k];
  }
}

constexpr int kWgThreads = 256;
constexpr int kWgTile = 64;  // an output tile's edge
constexpr int kWgK = 32;     // K rows staged at a time

struct WgradParams {
  const float* h_hist;  // [T, B, P] post-mask h (rounded to W here)
  const void* dxw;      // [T, B, G] W, from the walk
  const void* m;        // [T, B, U] W, masked m
  const void* dh;       // [T, B, P] W, masked dh_total
  const float* part;    // [groups][7U], the row-group walk's group
                        //   partials; null after the resident walk, which
                        //   writes dbias and the peepholes itself
  float* split;         // [splits][P * G + U * P] scratch
  int* counters;        // [tiles], zero on entry
  float* dwh;           // [P, G]
  float* dproj;         // [U, P]
  float* dbias;         // [G]
  float* dwi;           // [U]
  float* dwf;
  float* dwo;
  int T, B, U, P, groups, splits, tiles_wh, tiles, rows_wh, rows_proj;
};

// One kWgTile x kWgTile tile of C[m, n] = Σ_{k0 ≤ k < k1} round_W(A[k, m])
// · Bm[k, n] (row strides lda, ldb) into out (row stride ldo), on CUDA
// cores: 16 x 16 threads of 4 x 4 outputs, K staged kWgK rows at a time;
// each output sums its k in order.
template <typename W, typename TA>
__device__ void wgrad_tile(const TA* A, int lda, const W* Bm, int ldb,
                           int k0, int k1, int M, int N, int m0, int n0,
                           float* out, int ldo, float (*sA)[kWgTile],
                           float (*sB)[kWgTile]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {};
  for (int kb = k0; kb < k1; kb += kWgK) {
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kWgK * kWgTile / kWgThreads; ++q) {
      const int i = threadIdx.x + q * kWgThreads;
      const int kk = i / kWgTile, j = i % kWgTile, k = kb + kk;
      sA[kk][j] = k < k1 && m0 + j < M
                      ? to_f(to_w<W>(load(A + (size_t)k * lda + m0 + j)))
                      : 0.0f;
      sB[kk][j] =
          k < k1 && n0 + j < N ? load(Bm + (size_t)k * ldb + n0 + j) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kWgK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[r] = sA[kk][ty + 16 * r];
        b[r] = sB[kk][tx + 16 * r];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int m = m0 + ty + 16 * r, n = n0 + tx + 16 * c;
      if (m < M && n < N) out[(size_t)m * ldo + n] = acc[r][c];
    }
}

constexpr int kWgKm = 64;           // bf16: K rows staged at a time
constexpr int kWgLd = kWgTile + 8;  // bf16 staging row stride: 144 bytes,
                                    // so an ldmatrix's 8 rows miss banks

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ __nv_bfloat16 to_bf16(float v) {
  return __float2bfloat16(v);
}
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 v) {
  return v;
}

// One K-major operand X [k][c] (row stride ld) of a stage: kWgKm rows
// from kb, kWgTile columns from c0, zero past k1 and past C. fetch() loads
// it into registers, stash() stores it to shared memory [kWgKm][kWgLd] in
// bf16 (f32 rounded there), so that the loads stay in flight while the
// previous stage's mma run. A thread keeps one column (kVec: one 16-byte
// chunk of 8, for bf16 rows whose width and stride are multiples of 8)
// and takes every kDq-th row from its first, a warp on consecutive
// columns.
template <typename T, bool kVec>
struct WgStage {
  static constexpr int kPerRow = kVec ? kWgTile / 8 : kWgTile;
  static constexpr int kDq = kWgThreads / kPerRow;
  static constexpr int kN = kWgKm / kDq;
  using R = typename std::conditional<kVec, uint4, T>::type;
  R r[kN];

  __device__ __forceinline__ static int row0() {
    return threadIdx.x / kPerRow;
  }
  __device__ __forceinline__ static int col() {
    return (threadIdx.x % kPerRow) * (kVec ? 8 : 1);
  }
  __device__ __forceinline__ void fetch(const T* X, int ld, int kb, int k1,
                                        int c0, int C) {
    const int k = kb + row0(), j = col();
    const bool col_in = c0 + j < C;
    const T* x = X + (size_t)k * ld + c0 + j;
    const size_t step = (size_t)kDq * ld;
#pragma unroll
    for (int q = 0; q < kN; ++q) {
      const bool in = col_in && k + q * kDq < k1;
      if constexpr (kVec)
        r[q] = in ? __ldg(reinterpret_cast<const uint4*>(x + q * step))
                  : make_uint4(0, 0, 0, 0);
      else
        r[q] = in ? __ldg(x + q * step) : T{};
    }
  }
  __device__ __forceinline__ void stash(__nv_bfloat16* s) const {
    __nv_bfloat16* d = s + row0() * kWgLd + col();
#pragma unroll
    for (int q = 0; q < kN; ++q) {
      if constexpr (kVec)
        *reinterpret_cast<uint4*>(d + q * kDq * kWgLd) = r[q];
      else
        d[q * kDq * kWgLd] = to_bf16(r[q]);
    }
  }
};

// The same tile on tensor cores (bf16): C[m, n] = Σ_{k0 ≤ k < k1}
// round_bf16(A[k, m]) · Bm[k, n], f32 accumulation. 8 warps in 2 (m) x 4
// (n), a warp 32 x 16 of C: two 16-row x two 8-column mma.m16n8k16 tiles.
// Both operands are K-major, so a stage of kWgKm rows lands in shared
// memory as it lies ([k][m] and [k][n]) and the fragments come by
// ldmatrix.trans. Two stage buffers: the next stage's loads are issued
// before this stage's mma and stored after them, one barrier a stage.
// Each output sums its k in order, 16 at a time in the mma.
template <typename TA, bool kVecA, bool kVecB>
__device__ void wgrad_tile_mma(const TA* A, int lda, const __nv_bfloat16* Bm,
                               int ldb, int k0, int k1, int M, int N, int m0,
                               int n0, float* out, int ldo,
                               __nv_bfloat16* s) {
  constexpr int kStage = 2 * kWgKm * kWgLd;  // a buffer: A, then B
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * 32, wn = (warp % 4) * 16;
  const bool busy = m0 + wm < M && n0 + wn < N;  // warp-uniform
  WgStage<TA, kVecA> ra;
  WgStage<__nv_bfloat16, kVecB> rb;
  auto fetch = [&](int kb) {
    ra.fetch(A, lda, kb, k1, m0, M);
    rb.fetch(Bm, ldb, kb, k1, n0, N);
  };
  auto stash = [&](int buf) {
    ra.stash(s + buf * kStage);
    rb.stash(s + buf * kStage + kWgKm * kWgLd);
  };
  // this lane's ldmatrix row: matrix lane / 8, row lane % 8. A's four 8x8
  // matrices are a0..a3 of the m16 x k16 fragment: (k 0-7 | 8-15) x (m 0-7
  // | 8-15); B's are (k 0-7, n 0-7), (k 8-15, n 0-7), then n 8-15: b0 b1
  // of two n8 tiles
  const int mi = lane / 8, r = lane % 8;
  const int a_off = (r + (mi / 2) * 8) * kWgLd + wm + (mi % 2) * 8;
  const int b_off = (r + (mi % 2) * 8) * kWgLd + wn + (mi / 2) * 8;
  float c[2][2][4] = {};
  fetch(k0);
  stash(0);
  __syncthreads();
  int buf = 0;
  for (int kb = k0; kb < k1; kb += kWgKm) {
    const bool next = kb + kWgKm < k1;
    if (next) fetch(kb + kWgKm);  // in flight during this stage's mma
    if (busy) {
      const __nv_bfloat16* sa = s + buf * kStage;
      const uint32_t a_at = smem_addr(sa + a_off);
      const uint32_t b_at = smem_addr(sa + kWgKm * kWgLd + b_off);
#pragma unroll
      for (int ks = 0; ks < kWgKm; ks += 16) {
        uint32_t a[2][4], b[4];
        ldmatrix_x4_trans(a[0], a_at + ks * kWgLd * 2);
        ldmatrix_x4_trans(a[1], a_at + (ks * kWgLd + 16) * 2);
        ldmatrix_x4_trans(b, b_at + ks * kWgLd * 2);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(c[mt][0], a[mt], b[0], b[1]);
          mma_bf16(c[mt][1], a[mt], b[2], b[3]);
        }
      }
    }
    if (next) stash(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }
  if (!busy) return;
  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int m = m0 + wm + mt * 16 + g, n = n0 + wn + nt * 8 + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows m and m + 8
        const int mm = m + 8 * h;
        if (mm >= M) continue;
        if (n < N) out[(size_t)mm * ldo + n] = c[mt][nt][2 * h];
        if (n + 1 < N) out[(size_t)mm * ldo + n + 1] = c[mt][nt][2 * h + 1];
      }
    }
}

// Blocks [0, tiles * splits): block (split s, tile) computes its K slice of
// one output tile of dW_h (tiles [0, tiles_wh)) or dproj, bf16 on tensor
// cores and f32 on CUDA cores; the tile's last block sums the splits in
// split order. The blocks after them (row-group walk only) sum dbias and
// the peepholes over the walk's groups in group order.
template <typename W>
__global__ void __launch_bounds__(kWgThreads, 2)
    lstm_wgrad_kernel(const WgradParams p) {
  constexpr bool kBf16 = sizeof(W) == 2;
  __shared__ __align__(16) unsigned char
      s_raw[kBf16 ? 4 * kWgKm * kWgLd * 2 : 2 * kWgK * kWgTile * 4];
  __shared__ int s_last;
  const int B = p.B, U = p.U, P = p.P, G = 4 * U;
  const int tile_blocks = p.tiles * p.splits;
  if ((int)blockIdx.x >= tile_blocks) {
    const int e = (blockIdx.x - tile_blocks) * kWgThreads + threadIdx.x;
    if (e >= 7 * U) return;
    float v = 0.0f;
    for (int g = 0; g < p.groups; ++g) v += p.part[(size_t)g * 7 * U + e];
    if (e < G)
      p.dbias[e] = v;
    else if (e < 5 * U)
      p.dwi[e - G] = v;
    else if (e < 6 * U)
      p.dwf[e - 5 * U] = v;
    else
      p.dwo[e - 6 * U] = v;
    return;
  }
  const int tile = blockIdx.x % p.tiles, s = blockIdx.x / p.tiles;
  const bool wh = tile < p.tiles_wh;
  const size_t n_wh = (size_t)P * G, stride = n_wh + (size_t)U * P;
  const int M = wh ? P : U, N = wh ? G : P;
  const int tn = (N + kWgTile - 1) / kWgTile;
  const int i = wh ? tile : tile - p.tiles_wh;
  const int m0 = (i / tn) * kWgTile, n0 = (i % tn) * kWgTile;
  // dW_h pairs h row k (step t - 1) with dxw row B + k (step t)
  const int K = wh ? (p.T - 1) * B : p.T * B;
  const int rows = wh ? p.rows_wh : p.rows_proj;
  const int k0 = min(s * rows, K), k1 = min(k0 + rows, K);
  float* out = p.split + s * stride + (wh ? 0 : n_wh);
  const W* dxw1 = static_cast<const W*>(p.dxw) + (size_t)B * G;
  const W* m_in = static_cast<const W*>(p.m);
  const W* dh_in = static_cast<const W*>(p.dh);
  if constexpr (kBf16) {
    // 16-byte loads for the bf16 stream whose rows allow them (dxw where
    // 4U % 8 == 0, m where U % 8 == 0)
    auto* st = reinterpret_cast<__nv_bfloat16*>(s_raw);
    if (wh && G % 8 == 0)
      wgrad_tile_mma<float, false, true>(p.h_hist, P, dxw1, G, k0, k1, M, N,
                                         m0, n0, out, N, st);
    else if (wh)
      wgrad_tile_mma<float, false, false>(p.h_hist, P, dxw1, G, k0, k1, M,
                                          N, m0, n0, out, N, st);
    else if (U % 8 == 0)
      wgrad_tile_mma<__nv_bfloat16, true, false>(m_in, U, dh_in, P, k0, k1,
                                                 M, N, m0, n0, out, N, st);
    else
      wgrad_tile_mma<__nv_bfloat16, false, false>(m_in, U, dh_in, P, k0, k1,
                                                  M, N, m0, n0, out, N, st);
  } else {
    auto* sA = reinterpret_cast<float(*)[kWgTile]>(s_raw);
    auto* sB = sA + kWgK;
    if (wh)
      wgrad_tile<W>(p.h_hist, P, dxw1, G, k0, k1, M, N, m0, n0, out, N, sA,
                    sB);
    else
      wgrad_tile<W>(m_in, U, dh_in, P, k0, k1, M, N, m0, n0, out, N, sA,
                    sB);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(p.counters + tile, 1) == p.splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  float* dst = wh ? p.dwh : p.dproj;
  const float* src = p.split + (wh ? 0 : n_wh);
  for (int e = threadIdx.x; e < kWgTile * kWgTile; e += kWgThreads) {
    const int m = m0 + e / kWgTile, n = n0 + e % kWgTile;
    if (m >= M || n >= N) continue;
    const size_t o = (size_t)m * N + n;
    float v = 0.0f;
    for (int j = 0; j < p.splits; ++j) v += __ldcg(src + j * stride + o);
    dst[o] = v;
  }
}

// A cooperative launch of `blocks` blocks of kThreads with `smem` bytes of
// dynamic shared memory; refused (cudaErrorCooperativeLaunchTooLarge) when
// the blocks cannot all be resident at once.
cudaError_t launch_cooperative(const void* kernel, void* params, int blocks,
                               int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (blocks < 1 || blocks > per_sm * sms)
    return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {params};
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads),
                                    args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each launches its kernel on `stream` and returns cudaGetLastError() (0 on
// success). They do not synchronise and allocate nothing; the caller's
// plan fills every size and offset of the parameter block. The first two
// are cooperative launches; the ones below them are plain ones.
int lstm_bwd_resident(const void* params, int use_bf16, int device,
                      void* stream) {
  cudaGetLastError();  // clear any stale error of this runtime
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  BwdParams q = *static_cast<const BwdParams*>(params);
  // acc mode sums at most kAccCells (row, unit) cells a thread: refuse a
  // block of more rather than drop the cells past them
  if (q.acc && q.B * q.NU > kAccCells * kThreads)
    return (int)cudaErrorInvalidValue;
  const void* kernel =
      use_bf16 ? (q.acc ? reinterpret_cast<const void*>(
                              lstm_bwd_resident_kernel<__nv_bfloat16, true>)
                        : reinterpret_cast<const void*>(
                              lstm_bwd_resident_kernel<__nv_bfloat16, false>))
               : (q.acc ? reinterpret_cast<const void*>(
                              lstm_bwd_resident_kernel<float, true>)
                        : reinterpret_cast<const void*>(
                              lstm_bwd_resident_kernel<float, false>));
  return (int)launch_cooperative(kernel, &q, q.blocks, q.smem,
                                 static_cast<cudaStream_t>(stream));
}

int wavefront_resident(const void* params, int use_bf16, int device,
                       void* stream) {
  cudaGetLastError();
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  FwdParams q = *static_cast<const FwdParams*>(params);
  const void* kernel =
      use_bf16
          ? reinterpret_cast<const void*>(
                wavefront_resident_kernel<__nv_bfloat16>)
          : reinterpret_cast<const void*>(wavefront_resident_kernel<float>);
  return (int)launch_cooperative(kernel, &q, q.L * q.nbl, q.smem,
                                 static_cast<cudaStream_t>(stream));
}

// K1: a plain launch of one block per row group (no grid barrier, so no
// cooperative launch).
int lstm_fwd_rowgroup(const void* params, int use_bf16, int device,
                      void* stream) {
  cudaGetLastError();
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const RowParams q = *static_cast<const RowParams*>(params);
  const void* kernel =
      use_bf16
          ? reinterpret_cast<const void*>(
                lstm_fwd_rowgroup_kernel<__nv_bfloat16>)
          : reinterpret_cast<const void*>(lstm_fwd_rowgroup_kernel<float>);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             q.smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_bf16)
    lstm_fwd_rowgroup_kernel<__nv_bfloat16>
        <<<q.groups, kRowThreads, q.smem, s>>>(q);
  else
    lstm_fwd_rowgroup_kernel<float><<<q.groups, kRowThreads, q.smem, s>>>(q);
  return (int)cudaGetLastError();
}

// K3's walk: a plain launch of one block per row group, like K1's.
int lstm_bwd_rowgroup(const void* params, int use_bf16, int device,
                      void* stream) {
  cudaGetLastError();
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const RowBwdParams q = *static_cast<const RowBwdParams*>(params);
  const void* kernel =
      use_bf16
          ? reinterpret_cast<const void*>(
                lstm_bwd_rowgroup_kernel<__nv_bfloat16>)
          : reinterpret_cast<const void*>(lstm_bwd_rowgroup_kernel<float>);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             q.smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_bf16)
    lstm_bwd_rowgroup_kernel<__nv_bfloat16>
        <<<q.groups, kRowThreads, q.smem, s>>>(q);
  else
    lstm_bwd_rowgroup_kernel<float><<<q.groups, kRowThreads, q.smem, s>>>(q);
  return (int)cudaGetLastError();
}

// K3's weight-gradient reduction, launched after the walk on its stream.
int lstm_wgrad(const void* params, int use_bf16, int device, void* stream) {
  cudaGetLastError();
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const WgradParams q = *static_cast<const WgradParams*>(params);
  // the dbias and peephole blocks only where there are group partials
  const int blocks = q.tiles * q.splits +
                     (q.part ? (7 * q.U + kWgThreads - 1) / kWgThreads : 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_bf16)
    lstm_wgrad_kernel<__nv_bfloat16><<<blocks, kWgThreads, 0, s>>>(q);
  else
    lstm_wgrad_kernel<float><<<blocks, kWgThreads, 0, s>>>(q);
  return (int)cudaGetLastError();
}

// sizeof of the parameter blocks, for the wrappers' layout check.
int resident_params_sizes(int which) {
  switch (which) {
    case 0: return (int)sizeof(BwdParams);
    case 1: return (int)sizeof(FwdParams);
    case 2: return (int)sizeof(RowParams);
    case 3: return (int)sizeof(RowBwdParams);
    default: return (int)sizeof(WgradParams);
  }
}

#ifdef RESIDENT_PROFILE
// Copies the section timers ([2][16] nanoseconds) to `out`; zeroes them
// if `reset`.
int resident_sections(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_sections, sizeof(g_sections));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[2][16] = {};
    err = cudaMemcpyToSymbol(g_sections, zero, sizeof(zero));
  }
  return (int)err;
}
#endif

const char* resident_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
