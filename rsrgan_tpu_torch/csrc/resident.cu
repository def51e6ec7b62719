// The G-width recurrences for Hopper with their weights resident in shared
// memory across a persistent grid of one block per SM.
//
// Two kernels, one design:
// * lstm_bwd_resident_kernel replaces rsrgan_tpu/ops/pallas_lstm.py
//   `_bwd_kernel` (launched by `_bwd_pallas`, K2): the reverse walk over the
//   forward's saved gate activations; per step it emits dgates (dxw), the
//   masked m and the masked dh_total (the weight gradients are reduced
//   outside, lstm_weight_grads).
// * wavefront_resident_kernel replaces rsrgan_tpu/ops/pallas_wavefront.py
//   `_wavefront_kernel` (launched by `lstm_wavefront_fwd`, K4) in both of
//   its modes: all L layers in one program, layer k running k steps behind
//   layer 0, the top tap (decode) or, with `save`, every layer's tap, c, h
//   and gate activations de-skewed as [L, T, B, *] (training).
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
  for (size_t i = threadIdx.x; i < bytes / 16; i += kThreads)
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
  int T, B, U, P, blocks, NU, NUn, K1, ld1, Np, K2, ld2, Mp;
  int n_res_proj, n_res_wh, tpi;
  int off_a, off_dm, off_dg, off_dc, off_k, off_proj, off_wh, smem;
};

template <typename W>
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
    // the peephole cell's reverse math; the dc carry stays in the block
    for (int i = threadIdx.x; i < B * nu; i += kThreads) {
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
}

// ---------------------------------------------------------------------------
// K4: the wavefront forward, both modes. Block i is (layer k, unit slice j).
// ---------------------------------------------------------------------------

struct FwdParams {
  const void* xw1;     // [T, B, G] W, layer-1 input projection
  const float* x;      // [T, B, P] raw inputs (layer-1 residual)
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
      // input projection from xw1: its in-part is zero)
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
          s_a[b * p.ldw + P + q] = to_w<W>(vi[j]);
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
      block_gemm(s_a, s_wg, g_wg, p.ldw, p.n_res_g, B, p.Mp, NG, NG, p.Kp,
                 [&](int m, int n, float v) { s_gate[m * NG + n] = v; });
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
      block_gemm(s_m, s_wp, g_wp, p.ldm, p.n_res_p, B, p.Mp, P, p.Np, p.Km,
                 [&](int m, int n, float v) { part[(size_t)m * P + n] = v; });
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
// plan fills every size and offset of the parameter block.
int lstm_bwd_resident(const void* params, int use_bf16, int device,
                      void* stream) {
  cudaGetLastError();  // clear any stale error of this runtime
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  BwdParams q = *static_cast<const BwdParams*>(params);
  const void* kernel =
      use_bf16
          ? reinterpret_cast<const void*>(
                lstm_bwd_resident_kernel<__nv_bfloat16>)
          : reinterpret_cast<const void*>(lstm_bwd_resident_kernel<float>);
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

// sizeof of the parameter blocks, for the wrappers' layout check.
int resident_params_sizes(int which) {
  return which == 0 ? (int)sizeof(BwdParams) : (int)sizeof(FwdParams);
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
