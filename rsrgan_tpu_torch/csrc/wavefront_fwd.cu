// Wavefront multi-layer peephole LSTM forward for Hopper: the first,
// L2-streaming design.
//
// No path of the port runs this source any more. K4, the G stack in both
// modes, runs the resident kernel of csrc/resident.cu, and K1, the D
// forward (below: L = 1, residual off), runs that file's row-group
// kernel; both keep their weights in shared memory. chip_smoke.py still
// launches this source (ops/wavefront.py `_launch`) in all three wirings
// to time it beside the kernels that replaced it. Everything below
// describes this streaming design.
//
// Replaces the TPU kernel rsrgan_tpu/ops/pallas_wavefront.py
// `_wavefront_kernel` (launched by `lstm_wavefront_fwd`) in both of its
// modes: all L layers of a res_lstm_l (residual) or plain stack in one
// program, layer k running k steps behind layer 0, with the input
// projections of layers 2..L computed inside the kernel. Output: the top
// layer's tap [T, B, P] in f32. With `save` set (the TPU kernel's
// save_acts=True, the training forward) it writes instead, per layer, the
// tap, the post-mask c and h, and the gate activations [si, tj, sf, so]
// in W, de-skewed as [L, T, B, *]: a block writes layer k's step t at its
// own (k, t) row, so the TPU's skewed row layout (k*R + t) is not copied.
//
// At L = 1 with the residual off the same program is the single-layer
// forward rsrgan_tpu/ops/pallas_lstm.py `_fwd_kernel` (K1): xw1 is that
// kernel's precomputed input projection, which in bf16 is already a bf16
// product, so passing it in W is exact.
//
// What bounds it on the card: the T+L-1 dependent wavefront steps. One
// step is ~0.2 GFLOP at the res_lstm_l widths (L=4, U=760, P=257, B=16)
// — microseconds of tensor or even CUDA-core work — but every step needs
// all 6.3 M recurrent weights (25 MB in f32, 12.5 MB in bf16), which
// cannot sit in one SM's shared memory and do sit in the 50 MB L2. So
// the time is latency: re-reading the weights from L2 each step plus the
// grid-wide barriers between the dependent phases, not FLOPs or HBM.
//
// What the design does about it (a simple, right first version):
// * one cooperative launch for the whole sequence, so no kernel launch
//   per step; the grid is never larger than the co-resident block count;
// * every step is two grid-strided phases split by grid.sync():
//   A: per (layer, 32-unit tile, 8-row chunk) the four gate
//      pre-activations (in·W_x + h·W_h, K split over the 8 warps and
//      reduced in shared memory), then the peephole cell update -> c, m;
//   B: per (layer, 32-column tile, 8-row chunk) h = m·proj, then the
//      mask, state freeze, out, tap and the hand-off to the next layer;
// * the hand-off buffer is double-buffered by step parity: in phase B of
//   step s layer k-1 writes in_k(t+1) while layer k still reads in_k(t)
//   for its residual (the TPU grid runs in order and can overwrite one
//   buffer in place; blocks on the GPU cannot);
// * weights are read through L1 with consecutive lanes on consecutive
//   columns; state written by other blocks is read with __ldcg (L2), so
//   no stale L1 line survives a barrier.
// Later work (ROADMAP): weights resident in shared memory across SMs,
// wgmma, clusters.
//
// Precision (as the JAX kernel): weights and xw1 in W (f32 or bf16); the
// operands of every in-kernel product (in_k, h, m) rounded to W; f32
// accumulation; state, bias and peepholes in f32.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // units (phase A) or proj columns (phase B)
constexpr int kRows = 8;   // batch rows per work item
static_assert(kRows * kTile == kThreads, "one thread per (row, lane)");

struct Params {
  const void* xw1;     // [T, B, G] W, layer-1 input projection
  const float* x;      // [T, B, P] raw inputs (layer-1 residual)
  const int* lengths;  // [B]
  const void* wx;      // [L-1, P, G] W
  const void* wh;      // [L, P, G] W
  const void* proj;    // [L, U, P] W
  const float* bias;   // [L, G], forget_bias folded in
  const float* wi;     // [L, U] peepholes
  const float* wf;
  const float* wo;
  float* c;      // [L, B, U] cell state, zero on entry
  float* h;      // [L, B, P] recurrent output state, zero on entry
  float* m;      // [L, B, U] phase A -> phase B
  float* inbuf;  // [2, L, B, P] hand-off, slot (s & 1) read at step s
  float* y;      // [T, B, P] top tap (decode mode only)
  // save mode only (training): [L, T, B, *] per-layer streams
  float* tap_s;  // [L, T, B, P] tap (post-mask out, plus in_k if residual)
  float* c_s;    // [L, T, B, U] post-mask cell state
  float* h_s;    // [L, T, B, P] post-mask recurrent output state
  void* acts;    // [L, T, B, G] W, gate activations [si, tj, sf, so]
  int T, B, L, U, P, residual, save;
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
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

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

size_t smem_bytes(int U, int P) {
  size_t a = (size_t)2 * kRows * P + (size_t)kWarps * 4 * kRows * kTile;
  size_t b = (size_t)kRows * U + (size_t)kWarps * kRows * kTile;
  return (a > b ? a : b) * sizeof(float);
}

// Phase A for one item: gates and cell update of layer k at time t for
// units [u0, u0+32) and rows [b0, b0+8).
template <typename W>
__device__ void gates_and_cell(const Params& p, const float* in_cur, int k,
                               int t, int u0, int b0, float* smem) {
  const int B = p.B, U = p.U, P = p.P, G = 4 * U;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* s_h = smem;                  // [kRows][P]
  float* s_in = smem + kRows * P;     // [kRows][P]
  float* s_red = smem + 2 * kRows * P;  // [kWarps][4][kRows][kTile]

  __syncthreads();  // the previous item is done with shared memory
  const float* hk = p.h + (size_t)k * B * P;
  const float* ink = in_cur + (size_t)k * B * P;
  for (int i = threadIdx.x; i < kRows * P; i += kThreads) {
    const int r = i / P, q = i % P, b = b0 + r;
    float hv = 0.0f, iv = 0.0f;
    if (b < B) {
      hv = round_to<W>(__ldcg(hk + (size_t)b * P + q));
      if (k > 0) iv = round_to<W>(__ldcg(ink + (size_t)b * P + q));
    }
    s_h[i] = hv;
    s_in[i] = iv;
  }
  __syncthreads();

  float acc[4][kRows];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[g][r] = 0.0f;

  const int u = u0 + lane;
  const int slice = (P + kWarps - 1) / kWarps;
  const int q_lo = warp * slice;
  const int q_hi = min(P, q_lo + slice);
  if (u < U) {
    const W* whk = static_cast<const W*>(p.wh) + (size_t)k * P * G + u;
    if (k == 0) {
#pragma unroll 4
      for (int q = q_lo; q < q_hi; ++q) {
        float w[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) w[g] = load(whk + (size_t)q * G + g * U);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float hv = s_h[r * P + q];
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[g][r] = fmaf(hv, w[g], acc[g][r]);
        }
      }
    } else {
      const W* wxk =
          static_cast<const W*>(p.wx) + (size_t)(k - 1) * P * G + u;
#pragma unroll 4
      for (int q = q_lo; q < q_hi; ++q) {
        float w[4], v[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          w[g] = load(whk + (size_t)q * G + g * U);
          v[g] = load(wxk + (size_t)q * G + g * U);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float hv = s_h[r * P + q], iv = s_in[r * P + q];
#pragma unroll
          for (int g = 0; g < 4; ++g)
            acc[g][r] = fmaf(iv, v[g], fmaf(hv, w[g], acc[g][r]));
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      s_red[((warp * 4 + g) * kRows + r) * kTile + lane] = acc[g][r];
  __syncthreads();

  const int r = threadIdx.x / kTile, ln = threadIdx.x % kTile;
  const int uu = u0 + ln, b = b0 + r;
  if (uu < U && b < B) {
    float gate[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        sum += s_red[((w * 4 + g) * kRows + r) * kTile + ln];
      if (k == 0)
        sum += load(static_cast<const W*>(p.xw1) +
                    ((size_t)t * B + b) * G + g * U + uu);
      gate[g] = sum + p.bias[(size_t)k * G + g * U + uu];
    }
    const size_t ci = ((size_t)k * B + b) * U + uu;
    const float c_prev = __ldcg(p.c + ci);
    const size_t pi = (size_t)k * U + uu;
    const float si = sigmoid(gate[0] + p.wi[pi] * c_prev);
    const float tj = tanhf(gate[1]);
    const float sf = sigmoid(gate[2] + p.wf[pi] * c_prev);
    const float c_new = sf * c_prev + si * tj;
    const float so = sigmoid(gate[3] + p.wo[pi] * c_new);
    const bool live = t < p.lengths[b];
    p.c[ci] = live ? c_new : c_prev;
    p.m[ci] = so * tanhf(c_new);
    if (p.save) {
      const size_t row = ((size_t)k * p.T + t) * B + b;
      p.c_s[row * U + uu] = live ? c_new : c_prev;
      W* a = static_cast<W*>(p.acts) + row * G + uu;
      store(a, si);
      store(a + U, tj);
      store(a + 2 * U, sf);
      store(a + 3 * U, so);
    }
  }
}

// Phase B for one item: h = m·proj of layer k at time t for proj columns
// [c0, c0+32) and rows [b0, b0+8), then mask, freeze, tap, hand-off.
template <typename W>
__device__ void project_and_hand_off(const Params& p, const float* in_cur,
                                     float* in_next, int k, int t, int c0,
                                     int b0, float* smem) {
  const int B = p.B, U = p.U, P = p.P;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* s_m = smem;                  // [kRows][U]
  float* s_red = smem + kRows * U;    // [kWarps][kRows][kTile]

  __syncthreads();
  const float* mk = p.m + (size_t)k * B * U;
  for (int i = threadIdx.x; i < kRows * U; i += kThreads) {
    const int r = i / U, q = i % U, b = b0 + r;
    s_m[i] = b < B ? round_to<W>(__ldcg(mk + (size_t)b * U + q)) : 0.0f;
  }
  __syncthreads();

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
  const int col = c0 + lane;
  const int slice = (U + kWarps - 1) / kWarps;
  const int q_lo = warp * slice;
  const int q_hi = min(U, q_lo + slice);
  if (col < P) {
    const W* pk = static_cast<const W*>(p.proj) + (size_t)k * U * P + col;
#pragma unroll 8
    for (int q = q_lo; q < q_hi; ++q) {
      const float w = load(pk + (size_t)q * P);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        acc[r] = fmaf(s_m[r * U + q], w, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    s_red[(warp * kRows + r) * kTile + lane] = acc[r];
  __syncthreads();

  const int r = threadIdx.x / kTile, ln = threadIdx.x % kTile;
  const int cc = c0 + ln, b = b0 + r;
  if (cc < P && b < B) {
    float h_new = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      h_new += s_red[(w * kRows + r) * kTile + ln];
    const bool live = t < p.lengths[b];
    const size_t hi = ((size_t)k * B + b) * P + cc;
    const float h_prev = __ldcg(p.h + hi);
    if (live) p.h[hi] = h_new;  // a masked row keeps its state
    float tap = live ? h_new : 0.0f;
    if (p.residual)
      tap += k == 0 ? p.x[((size_t)t * B + b) * P + cc] : __ldcg(in_cur + hi);
    if (k + 1 < p.L)
      in_next[((size_t)(k + 1) * B + b) * P + cc] = tap;
    else if (!p.save)  // in save mode the top tap is tap_s[L-1]
      p.y[((size_t)t * B + b) * P + cc] = tap;
    if (p.save) {
      const size_t si = (((size_t)k * p.T + t) * B + b) * P + cc;
      p.tap_s[si] = tap;
      p.h_s[si] = live ? h_new : h_prev;
    }
  }
}

template <typename W>
__global__ void __launch_bounds__(kThreads, 2)
    wavefront_fwd_kernel(const Params p) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int L = p.L, B = p.B, P = p.P;
  const int unit_tiles = (p.U + kTile - 1) / kTile;
  const int col_tiles = (P + kTile - 1) / kTile;
  const int chunks = (B + kRows - 1) / kRows;
  const int items_a = L * unit_tiles * chunks;
  const int items_b = L * col_tiles * chunks;
  const size_t slot = (size_t)L * B * P;

  for (int s = 0; s < p.T + L - 1; ++s) {
    const float* in_cur = p.inbuf + (size_t)(s & 1) * slot;
    float* in_next = p.inbuf + (size_t)((s + 1) & 1) * slot;
    // Items outside the wavefront are skipped by the whole block at once,
    // so the block-wide barriers inside each item stay uniform, and every
    // block reaches both grid barriers of every step.
    for (int item = blockIdx.x; item < items_a; item += gridDim.x) {
      const int k = item / (unit_tiles * chunks);
      const int rest = item % (unit_tiles * chunks);
      const int t = s - k;
      if (t < 0 || t >= p.T) continue;
      gates_and_cell<W>(p, in_cur, k, t, (rest / chunks) * kTile,
                        (rest % chunks) * kRows, smem);
    }
    grid.sync();
    for (int item = blockIdx.x; item < items_b; item += gridDim.x) {
      const int k = item / (col_tiles * chunks);
      const int rest = item % (col_tiles * chunks);
      const int t = s - k;
      if (t < 0 || t >= p.T) continue;
      project_and_hand_off<W>(p, in_cur, in_next, k, t,
                              (rest / chunks) * kTile,
                              (rest % chunks) * kRows, smem);
    }
    grid.sync();
  }
}

// Grid size for a cooperative launch: the larger phase's item count,
// capped by the co-resident block count. Negative on error.
template <typename W>
int plan_grid(int B, int L, int U, int P, size_t smem, cudaError_t* err) {
  auto kernel = wavefront_fwd_kernel<W>;
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
  const int chunks = (B + kRows - 1) / kRows;
  const int items_a = L * ((U + kTile - 1) / kTile) * chunks;
  const int items_b = L * ((P + kTile - 1) / kTile) * chunks;
  const int items = items_a > items_b ? items_a : items_b;
  return items < per_sm * sms ? items : per_sm * sms;
}

template <typename W>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.U, p.P);
  cudaError_t err = cudaSuccess;
  const int grid = plan_grid<W>(p.B, p.L, p.U, p.P, smem, &err);
  if (grid < 0) return err;
  void* args[] = {const_cast<Params*>(&p)};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(wavefront_fwd_kernel<W>), dim3(grid),
      dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). Does not synchronise and allocates nothing.
// The four save-mode pointers are read only when `save` is non-zero, and
// `y` only when it is zero.
int wavefront_fwd(const void* xw1, const float* x, const int* lengths,
                  const void* wx, const void* wh, const void* proj,
                  const float* bias, const float* wi, const float* wf,
                  const float* wo, float* c, float* h, float* m,
                  float* inbuf, float* y, float* tap_s, float* c_s,
                  float* h_s, void* acts, int T, int B, int L, int U, int P,
                  int residual, int save, int use_bf16, int device,
                  void* stream) {
  cudaGetLastError();  // clear any stale error of this runtime
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Params p{xw1, x,   lengths, wx,  wh,   proj, bias, wi, wf,
                 wo,  c,   h,       m,   inbuf, y,   tap_s, c_s, h_s,
                 acts, T,  B,       L,   U,    P,    residual, save};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(use_bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s));
}

const char* wavefront_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
