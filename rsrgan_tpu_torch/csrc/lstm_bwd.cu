// Single-layer peephole LSTM backward for Hopper: the reverse walk over
// the forward's saved gate activations, in the first, L2-streaming
// design.
//
// Only K3 at G width runs this source now (acc = 1, ops/lstm_seq.py
// `lstm_bwd_acc`: every G layer's backward at B >= 32, the CLI's default
// batch). K3 on the D layer and K2 run the kernels of csrc/resident.cu,
// which keep their weights in shared memory; chip_smoke.py still
// launches both modes here to time them beside those. Everything below
// describes this streaming design.
//
// Replaces two TPU kernels of rsrgan_tpu/ops/pallas_lstm.py:
// * `_bwd_kernel` (launched by `_bwd_pallas`, K2): per step it emits the
//   gate gradients dgates (dxw), the masked m and the masked dh_total;
//   the weight gradients are reduced outside (lstm_weight_grads);
// * `_bwd_kernel_acc` (launched by `_bwd_pallas_acc`, K3): the same walk,
//   with dW_h, dproj, dbias and the peephole gradients computed inside the
//   kernel.
// Both run from one source: `acc` selects K3.
//
// What bounds it on the card: the T dependent reverse steps. A step is
// two small products (dh_total·projᵀ, K = P, and dgates·W_hᵀ, K = 4U) at
// M = B rows, microseconds of arithmetic; at res_lstm_l's widths (U=760,
// P=257) W_h and proj are ~2 MB in bf16, more than one SM's shared memory,
// so as in the wavefront forward the time is latency: re-reading the
// weights from L2 each step plus the grid barriers between the dependent
// phases. K3's weight-gradient products (T·B·P·4U MACs) are the only
// part with real arithmetic; they have no step dependency.
//
// What the design does about it (a simple, right first version):
// * one cooperative launch for the whole walk; every step is two
//   grid-strided phases split by grid.sync():
//   A: per (32-unit tile, 8-row chunk): dm = dh_total·projᵀ (K split over
//      the 8 warps, reduced in shared memory), then the peephole cell's
//      reverse math -> dgates, m, and the dc carry (owned by the item);
//   B: per (32-column tile, 8-row chunk): dh_prev = dgates·W_hᵀ, staged
//      through shared memory in K chunks, then the masked dh carry;
// * the weights arrive transposed (W_hᵀ [4U, P], projᵀ [P, U]) so that
//   consecutive lanes read consecutive columns;
// * K3: the TPU kernel accumulates its weight gradients into output
//   blocks revisited by every grid step. Blocks on the GPU run in no
//   order, so here the walk writes dgates (f32), m and dh to streams and,
//   after one more grid.sync(), the same launch reduces them over T·B: a
//   32x32 output tile per work item (dW_h, dproj) and a 32-column group
//   per item (dbias, peepholes). Every output element is summed by one
//   block in a fixed order: no atomics, the result is the same on every
//   run;
// * state written by other blocks in this launch is read with __ldcg
//   (L2), never through a possibly stale L1 line; every block reaches
//   every grid.sync().
//
// Precision (as the JAX kernels): products take operands rounded to W
// (f32 or bf16) and accumulate in f32; the carries and the gate math are
// f32; dxw, m and dh are stored in W; K3's dbias and peephole gradients
// sum the unrounded f32 dgates, its dW_h and dproj W-rounded operands.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;   // units (phase A), columns (phase B, reduction)
constexpr int kRows = 8;    // batch rows per work item
constexpr int kChunk = 512; // K chunk of phase B staged in shared memory
static_assert(kRows * kTile == kThreads, "one thread per (row, lane)");

struct Params {
  const void* acts;     // [T, B, G] W, forward gate activations
  const int* lengths;   // [B]
  const float* dout;    // [T, B, P] upstream gradient of the layer output
  const float* c_hist;  // [T, B, U] post-mask cell state
  const float* h_hist;  // [T, B, P] post-mask h (K3 only)
  const void* whT;      // [G, P] W, W_h transposed
  const void* projT;    // [P, U] W, proj transposed
  const float* wi;      // [U] peepholes
  const float* wf;
  const float* wo;
  float* dc;            // [B, U] carry, zero on entry
  float* dh;            // [B, P] carry, zero on entry
  float* dg;            // [B, G] this step's dgates, rounded to W
  void* dxw;            // [T, B, G] W
  void* m_out;          // [T, B, U] W, masked m
  void* dh_out;         // [T, B, P] W, masked dh_total
  // K3 only
  float* dgf;           // [T, B, G] masked dgates, f32
  float* dwh;           // [P, G]
  float* dproj;         // [U, P]
  float* dbias;         // [G]
  float* dwi;           // [U]
  float* dwf;
  float* dwo;
  int T, B, U, P, acc;
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
// Loads of data this launch wrote (L2, not the read-only path).
__device__ __forceinline__ float load_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float load_cg(const __nv_bfloat16* p) {
  const unsigned short bits =
      __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __bfloat162float(__ushort_as_bfloat16(bits));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename W>
__device__ __forceinline__ float round_to(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

size_t smem_bytes(int U, int P) {
  size_t a = (size_t)kRows * P + (size_t)kWarps * kRows * kTile;
  size_t b = (size_t)kRows * kChunk + (size_t)kWarps * kRows * kTile;
  size_t r = (size_t)2 * kTile * (kTile + 1);
  size_t m = a > b ? a : b;
  return (m > r ? m : r) * sizeof(float);
}

// Phase A for one item at step t: units [u0, u0+32), rows [b0, b0+8).
template <typename W>
__device__ void cell_reverse(const Params& p, int t, int u0, int b0,
                             float* smem) {
  const int B = p.B, U = p.U, P = p.P, G = 4 * U;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* s_dht = smem;                 // [kRows][P]
  float* s_red = smem + kRows * P;     // [kWarps][kRows][kTile]

  __syncthreads();  // the previous item is done with shared memory
  for (int i = threadIdx.x; i < kRows * P; i += kThreads) {
    const int r = i / P, q = i % P, b = b0 + r;
    float v = 0.0f;
    if (b < B) {
      const size_t o = ((size_t)t * B + b) * P + q;
      v = p.dout[o] + __ldcg(p.dh + (size_t)b * P + q);
      if (u0 == 0)  // one item per row chunk writes the dh stream
        store(static_cast<W*>(p.dh_out) + o, t < p.lengths[b] ? v : 0.0f);
    }
    s_dht[i] = round_to<W>(v);
  }
  __syncthreads();

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  const int u = u0 + lane;
  const int slice = (P + kWarps - 1) / kWarps;
  const int q_lo = warp * slice;
  const int q_hi = min(P, q_lo + slice);
  if (u < U) {
    const W* pt = static_cast<const W*>(p.projT) + u;
#pragma unroll 4
    for (int q = q_lo; q < q_hi; ++q) {
      const float w = load(pt + (size_t)q * U);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        acc[r] = fmaf(s_dht[r * P + q], w, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    s_red[(warp * kRows + r) * kTile + lane] = acc[r];
  __syncthreads();

  const int r = threadIdx.x / kTile, ln = threadIdx.x % kTile;
  const int uu = u0 + ln, b = b0 + r;
  if (uu >= U || b >= B) return;
  float dm = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) dm += s_red[(w * kRows + r) * kTile + ln];
  const bool live = t < p.lengths[b];
  if (!live) dm = 0.0f;

  const size_t row = (size_t)t * B + b;
  const W* a = static_cast<const W*>(p.acts) + row * G + uu;
  const float si = load(a), tj = load(a + U), sf = load(a + 2 * U),
              so = load(a + 3 * U);
  const float c_new = p.c_hist[row * U + uu];
  const float c_prev = t > 0 ? p.c_hist[(row - B) * U + uu] : 0.0f;
  const float tc = tanhf(c_new);
  const size_t ci = (size_t)b * U + uu;
  const float dc_old = __ldcg(p.dc + ci);

  float d_o = dm * tc * so * (1.0f - so);
  const float dc_total = (live ? dc_old : 0.0f) +
                         dm * so * (1.0f - tc * tc) + d_o * p.wo[uu];
  float d_f = dc_total * c_prev * sf * (1.0f - sf);
  float d_i = dc_total * tj * si * (1.0f - si);
  float d_j = dc_total * si * (1.0f - tj * tj);
  const float dc_prev = dc_total * sf + d_f * p.wf[uu] + d_i * p.wi[uu];
  if (!live) d_i = d_j = d_f = d_o = 0.0f;

  const float dgate[4] = {d_i, d_j, d_f, d_o};
  W* dx = static_cast<W*>(p.dxw) + row * G + uu;
  float* dgs = p.dg + (size_t)b * G + uu;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    store(dx + g * U, dgate[g]);
    dgs[g * U] = round_to<W>(dgate[g]);
    if (p.acc) p.dgf[row * G + g * U + uu] = dgate[g];
  }
  store(static_cast<W*>(p.m_out) + row * U + uu,
        live ? so * tc : 0.0f);
  p.dc[ci] = live ? dc_prev : dc_old;  // a masked step passes dc through
}

// Phase B for one item at step t: dh columns [c0, c0+32), rows [b0, b0+8).
template <typename W>
__device__ void recurrent_grad(const Params& p, int t, int c0, int b0,
                               float* smem) {
  const int B = p.B, P = p.P, G = 4 * p.U;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* s_dg = smem;                    // [kRows][kChunk]
  float* s_red = smem + kRows * kChunk;  // [kWarps][kRows][kTile]
  const int col = c0 + lane;

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  for (int g0 = 0; g0 < G; g0 += kChunk) {
    const int kc = min(kChunk, G - g0);
    __syncthreads();  // the previous chunk or item is done with s_dg
    for (int i = threadIdx.x; i < kRows * kc; i += kThreads) {
      const int r = i / kc, j = i % kc, b = b0 + r;
      s_dg[r * kChunk + j] =
          b < B ? __ldcg(p.dg + (size_t)b * G + g0 + j) : 0.0f;
    }
    __syncthreads();
    const int slice = (kc + kWarps - 1) / kWarps;
    const int j_lo = warp * slice;
    const int j_hi = min(kc, j_lo + slice);
    if (col < P) {
      const W* wt = static_cast<const W*>(p.whT) + (size_t)g0 * P + col;
#pragma unroll 8
      for (int j = j_lo; j < j_hi; ++j) {
        const float w = load(wt + (size_t)j * P);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          acc[r] = fmaf(s_dg[r * kChunk + j], w, acc[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    s_red[(warp * kRows + r) * kTile + lane] = acc[r];
  __syncthreads();

  const int r = threadIdx.x / kTile, ln = threadIdx.x % kTile;
  const int cc = c0 + ln, b = b0 + r;
  if (cc < P && b < B && t < p.lengths[b]) {
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += s_red[(w * kRows + r) * kTile + ln];
    p.dh[(size_t)b * P + cc] = v;  // a masked step passes dh through
  }
}

// K3 reduction: C[m, n] = sum_k round(A[k, m]) * round(Bm[k, n]) for one
// 32x32 tile of C; A is [K, M] with row stride lda, Bm [K, N] with ldb.
template <typename W, typename TA, typename TB>
__device__ void reduce_tile(const TA* A, int lda, const TB* Bm, int ldb,
                            int K, int M, int N, int m0, int n0, float* C,
                            int ldc, float* smem) {
  float* sA = smem;                        // [kTile][kTile + 1]
  float* sB = smem + kTile * (kTile + 1);  // [kTile][kTile + 1]
  const int ty = threadIdx.x / kTile, tx = threadIdx.x % kTile;
  constexpr int kPer = kTile / kWarps;     // outputs per thread
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += kTile) {
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
      const int kk = i / kTile, j = i % kTile, k = k0 + kk;
      sA[kk * (kTile + 1) + j] =
          k < K && m0 + j < M
              ? round_to<W>(load_cg(A + (size_t)k * lda + m0 + j))
              : 0.0f;
      sB[kk * (kTile + 1) + j] =
          k < K && n0 + j < N
              ? round_to<W>(load_cg(Bm + (size_t)k * ldb + n0 + j))
              : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTile; ++kk) {
      const float bv = sB[kk * (kTile + 1) + tx];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        acc[i] = fmaf(sA[kk * (kTile + 1) + ty + kWarps * i], bv, acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int mm = m0 + ty + kWarps * i, nn = n0 + tx;
    if (mm < M && nn < N) C[(size_t)mm * ldc + nn] = acc[i];
  }
}

// K3 reduction: out[n] = sum_k X[k, n] * (Y ? Y[k, n] : 1) for the 32
// columns [n0, n0+32); the 8 warps split the rows, then one sums.
__device__ void reduce_columns(const float* X, int ldx, const float* Y,
                               int ldy, int K, int N, int n0, float* out,
                               float* smem) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = n0 + lane;
  float sum = 0.0f;
  if (n < N) {
#pragma unroll 4
    for (int k = warp; k < K; k += kWarps) {
      const float x = __ldcg(X + (size_t)k * ldx + n);
      sum = Y ? fmaf(x, __ldcg(Y + (size_t)k * ldy + n), sum) : sum + x;
    }
  }
  __syncthreads();
  smem[warp * 32 + lane] = sum;
  __syncthreads();
  if (warp == 0 && n < N) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += smem[w * 32 + lane];
    out[n] = total;
  }
}

__host__ __device__ inline int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

__host__ __device__ inline int reduce_items(int U, int P) {
  const int G = 4 * U;
  return ceil_div(P, kTile) * ceil_div(G, kTile)     // dW_h
         + ceil_div(U, kTile) * ceil_div(P, kTile)   // dproj
         + ceil_div(G, kTile) + 3 * ceil_div(U, kTile);  // dbias, peepholes
}

template <typename W>
__device__ void reduce_grads(const Params& p, int item, float* smem) {
  const int B = p.B, U = p.U, P = p.P, G = 4 * U, T = p.T;
  const int KT = T * B, K1 = (T - 1) * B;  // all rows / rows with t >= 1
  const int n_dwh = ceil_div(P, kTile) * ceil_div(G, kTile);
  const int n_dproj = ceil_div(U, kTile) * ceil_div(P, kTile);
  const int n_bias = ceil_div(G, kTile);
  const int n_peep = ceil_div(U, kTile);
  if (item < n_dwh) {  // dW_h = h(t-1)ᵀ · dgates(t), t >= 1
    const int gt = ceil_div(G, kTile);
    reduce_tile<W>(p.h_hist, P, p.dgf + (size_t)B * G, G, K1, P, G,
                   (item / gt) * kTile, (item % gt) * kTile, p.dwh, G, smem);
    return;
  }
  item -= n_dwh;
  if (item < n_dproj) {  // dproj = m_maskedᵀ · dh_masked
    const int pt = ceil_div(P, kTile);
    reduce_tile<W>(static_cast<const W*>(p.m_out), U,
                   static_cast<const W*>(p.dh_out), P, KT, U, P,
                   (item / pt) * kTile, (item % pt) * kTile, p.dproj, P,
                   smem);
    return;
  }
  item -= n_dproj;
  if (item < n_bias) {
    reduce_columns(p.dgf, G, nullptr, 0, KT, G, item * kTile, p.dbias, smem);
    return;
  }
  item -= n_bias;
  const int which = item / n_peep, n0 = (item % n_peep) * kTile;
  if (which == 0)  // dw_i pairs d_i(t) with c(t-1)
    reduce_columns(p.dgf + (size_t)B * G, G, p.c_hist, U, K1, U, n0, p.dwi,
                   smem);
  else if (which == 1)  // dw_f pairs d_f(t) with c(t-1)
    reduce_columns(p.dgf + (size_t)B * G + 2 * U, G, p.c_hist, U, K1, U, n0,
                   p.dwf, smem);
  else  // dw_o pairs d_o(t) with c(t)
    reduce_columns(p.dgf + 3 * U, G, p.c_hist, U, KT, U, n0, p.dwo, smem);
}

template <typename W>
__global__ void __launch_bounds__(kThreads, 2)
    lstm_bwd_kernel(const Params p) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int chunks = ceil_div(p.B, kRows);
  const int items_a = ceil_div(p.U, kTile) * chunks;
  const int items_b = ceil_div(p.P, kTile) * chunks;
  for (int t = p.T - 1; t >= 0; --t) {
    for (int item = blockIdx.x; item < items_a; item += gridDim.x)
      cell_reverse<W>(p, t, (item / chunks) * kTile, (item % chunks) * kRows,
                      smem);
    grid.sync();
    for (int item = blockIdx.x; item < items_b; item += gridDim.x)
      recurrent_grad<W>(p, t, (item / chunks) * kTile,
                        (item % chunks) * kRows, smem);
    grid.sync();
  }
  if (!p.acc) return;
  const int items_r = reduce_items(p.U, p.P);
  for (int item = blockIdx.x; item < items_r; item += gridDim.x)
    reduce_grads<W>(p, item, smem);
}

template <typename W>
int plan_grid(int B, int U, int P, int acc, size_t smem, cudaError_t* err) {
  auto kernel = lstm_bwd_kernel<W>;
  *err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (*err != cudaSuccess) return -1;
  int dev = 0, sms = 0, per_sm = 0;
  if ((*err = cudaGetDevice(&dev)) != cudaSuccess) return -1;
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err != cudaSuccess) return -1;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                       kThreads, smem);
  if (*err != cudaSuccess) return -1;
  if (per_sm < 1) {
    *err = cudaErrorInvalidConfiguration;
    return -1;
  }
  const int chunks = ceil_div(B, kRows);
  int items = ceil_div(U, kTile) * chunks;
  const int items_b = ceil_div(P, kTile) * chunks;
  if (items_b > items) items = items_b;
  if (acc && reduce_items(U, P) > items) items = reduce_items(U, P);
  return items < per_sm * sms ? items : per_sm * sms;
}

template <typename W>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.U, p.P);
  cudaError_t err = cudaSuccess;
  const int grid = plan_grid<W>(p.B, p.U, p.P, p.acc, smem, &err);
  if (grid < 0) return err;
  void* args[] = {const_cast<Params*>(&p)};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(lstm_bwd_kernel<W>), dim3(grid),
      dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the reverse walk on `stream` and returns cudaGetLastError()
// (0 on success). Does not synchronise and allocates nothing. With acc = 0
// (K2) the K3 pointers are not read; with acc = 1 (K3) m_out and dh_out
// are scratch streams of the reduction.
int lstm_bwd(const void* acts, const int* lengths, const float* dout,
             const float* c_hist, const float* h_hist, const void* whT,
             const void* projT, const float* wi, const float* wf,
             const float* wo, float* dc, float* dh, float* dg, void* dxw,
             void* m_out, void* dh_out, float* dgf, float* dwh,
             float* dproj, float* dbias, float* dwi, float* dwf, float* dwo,
             int T, int B, int U, int P, int acc, int use_bf16, int device,
             void* stream) {
  cudaGetLastError();  // clear any stale error of this runtime
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Params p{acts,  lengths, dout,   c_hist, h_hist, whT,   projT,
                 wi,    wf,      wo,     dc,     dh,     dg,    dxw,
                 m_out, dh_out,  dgf,    dwh,    dproj,  dbias, dwi,
                 dwf,   dwo,     T,      B,      U,      P,     acc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(use_bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s));
}

// The grid a launch at these sizes would use (negative: CUDA error code).
int lstm_bwd_grid(int B, int U, int P, int acc, int use_bf16, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  const size_t smem = smem_bytes(U, P);
  const int grid = use_bf16
                       ? plan_grid<__nv_bfloat16>(B, U, P, acc, smem, &err)
                       : plan_grid<float>(B, U, P, acc, smem, &err);
  return grid < 0 ? -(int)err : grid;
}

const char* lstm_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
