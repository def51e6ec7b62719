// The optimizer update of one net in two launches: the per-tensor clip,
// the transform (SGD, Adam, RMSProp), the step and the EMA shadow over
// every leaf at once.
//
// Replaces no TPU kernel: the JAX package leaves optax's per-leaf update
// (rsrgan_tpu/training/state.py) to XLA, which fuses it into the step. The
// port's plain version, training/state.py's clip_by_norm_each, Adam,
// Sgd, RmsProp and the step loop of NetState.apply_gradients, issues one
// PyTorch kernel per leaf and per operation (about 23 a leaf for Adam with
// the clip, 11 for SGD) and copies Adam's two bias-correction scalars from
// pageable memory, which drains the queue. It stays as this kernel's twin
// (the CPU, tensor-parallel shards) and the tests hold the two bit-equal.
//
// What bounds it on the card: bytes. Adam reads g, p, mu, nu and the
// shadow and writes p, mu, nu and the shadow (36 bytes an element, 40 with
// the clip's first read of g): res_lstm_l's G, 7.05 M elements, moves
// 282 MB, 84 us at 3.35 TB/s. The plain version wrote every
// intermediate to device memory and spent its time in launches.
//
// What the design does about it:
// * the leaves are cut into chunks of kChunk elements, one block a chunk;
//   the chunk table (leaf, first element) and the leaf table (pointers to
//   parameter, moments and shadow, the size and the leaf's chunks) are
//   built on the host and copied to the card once per state
//   (ops/optim.py); the gradients, new tensors every step, go by value in
//   the launch's parameter block (kSlots pointers: 608 bytes), read
//   through __grid_constant__ so that a block's indexed read does not copy
//   the block to local memory. A net of more than kSlots leaves (none of
//   the benchmark's: 14-47) is updated in groups of kSlots, a launch pair
//   a group;
// * the clip's norms take two launches and no atomics: sumsq_kernel writes
//   each chunk's sum of squares (f64, a fixed order within the block) to a
//   scratch buffer, then each block of update_kernel sums its leaf's
//   partials in chunk order. Every run gives the same bits. The f64 sums
//   put the norm within an f32 rounding of the exact one; the plain
//   version's f32 sum differs from it by its own rounding;
// * Adam's step count lives on the card: the first group's sumsq_kernel
//   increments it, and update_kernel, ordered behind it on the stream,
//   computes the bias corrections 1 - b^count with powf. Nothing is copied
//   from the host during an update;
// * every element's arithmetic is f32 in the plain version's order, and
//   rounds where it rounds: __fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn and
//   __fsqrt_rn keep nvcc from contracting a product and a sum into an FMA.
//   RMSProp's rsqrtf is the function PyTorch's rsqrt calls.

#include <cuda_runtime.h>

#include <cstring>

enum Kind { kSgd = 0, kAdam = 1, kRmsProp = 2 };

// One leaf (parameter) of the net, in the state's fixed order.
struct Leaf {
  float* p;         // the parameter
  float* mu;        // Adam's first moment (null otherwise)
  float* nu;        // Adam's second moment, RMSProp's mean square
  float* e;         // the EMA shadow
  long long numel;  // elements
  int first;        // its first chunk
  int chunks;       // its chunks
};

struct Args {
  const Leaf* leaves;  // [n_leaves], on the card
  const int2* chunks;  // [n_chunks] (leaf, first element), on the card
  double* partials;    // [n_chunks] scratch: each chunk's sum of squares
  float* norms;        // [n_leaves] each leaf's gradient norm (clip only)
  int* count;          // Adam's step count (int32 []), or null
  float lr;            // learning rate
  float ema_c;         // 1 - EMA decay
  float max_norm;      // the clip's norm
  float b1, c1;        // Adam: b1, 1 - b1
  float b2, c2;        // Adam: b2, 1 - b2; RMSProp: decay, 1 - decay
  float eps;
  int n_leaves, n_chunks;
  int clip;            // 1: clip each leaf to max_norm
  int kind;            // Kind
  int tick;            // 1: sumsq_kernel increments *count (first group)
};

constexpr int kSlots = 64;  // gradients a launch: ops/optim.py SLOTS

// The launch's parameter block: the arguments and each leaf's gradient.
struct Block {
  Args a;
  const float* g[kSlots];
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 4096;  // elements a block (ops/optim.py CHUNK)

static_assert(sizeof(Block) <= 4096, "the parameter block's limit");

// The sum of every thread's v, in a fixed order; the result in thread 0.
__device__ double block_sum(double v) {
  __shared__ double warp_sums[kWarps];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w];
  return s;
}

__global__ void __launch_bounds__(kThreads)
    sumsq_kernel(const __grid_constant__ Block b) {
  const Args& a = b.a;
  if (blockIdx.x == 0 && threadIdx.x == 0 && a.tick) *a.count += 1;
  if (!a.clip) return;
  const int2 ch = a.chunks[blockIdx.x];
  const float* g = b.g[ch.x] + ch.y;
  const int n = (int)min((long long)kChunk, a.leaves[ch.x].numel - ch.y);
  double acc = 0.0;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const double v = g[i];
    acc += v * v;
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) a.partials[blockIdx.x] = acc;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    update_kernel(const __grid_constant__ Block b) {
  const Args& a = b.a;
  const int2 ch = a.chunks[blockIdx.x];
  const Leaf leaf = a.leaves[ch.x];
  __shared__ float s_factor;
  float factor = 1.f;
  if (a.clip) {
    if (threadIdx.x < 32) {
      // the leaf's partials in chunk order: lane l sums chunks l, l + 32,
      // ..., then a fixed shuffle tree
      double s = 0.0;
      for (int c = threadIdx.x; c < leaf.chunks; c += 32)
        s += a.partials[leaf.first + c];
      for (int o = 16; o > 0; o >>= 1)
        s += __shfl_down_sync(0xffffffffu, s, o);
      if (threadIdx.x == 0) {
        const float norm = (float)sqrt(s);
        if (ch.y == 0) a.norms[ch.x] = norm;
        // max_norm / max(norm, max_norm), as PyTorch's clamp (NaN passes)
        // and its reciprocal times the scalar
        const float m = a.max_norm;
        const float clamped = isnan(norm) ? norm : fmaxf(norm, m);
        s_factor = __fmul_rn(__fdiv_rn(1.f, clamped), m);
      }
    }
    __syncthreads();
    factor = s_factor;
  }
  float bc1 = 1.f, bc2 = 1.f;
  if (K == kAdam) {
    const float c = (float)*a.count;
    bc1 = __fsub_rn(1.f, powf(a.b1, c));
    bc2 = __fsub_rn(1.f, powf(a.b2, c));
  }
  const float* g = b.g[ch.x] + ch.y;
  float* p = leaf.p + ch.y;
  float* e = leaf.e + ch.y;
  float* mu = K == kAdam ? leaf.mu + ch.y : nullptr;
  float* nu = K != kSgd ? leaf.nu + ch.y : nullptr;
  const int n = (int)min((long long)kChunk, leaf.numel - ch.y);
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float gi = g[i];
    if (a.clip) gi = __fmul_rn(gi, factor);
    float u;
    if (K == kSgd) {
      u = gi;
    } else if (K == kAdam) {
      // mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu
      const float m = __fadd_rn(__fmul_rn(a.c1, gi), __fmul_rn(a.b1, mu[i]));
      const float v = __fadd_rn(__fmul_rn(a.c2, __fmul_rn(gi, gi)),
                                __fmul_rn(a.b2, nu[i]));
      mu[i] = m;
      nu[i] = v;
      // (mu / bc1) / (sqrt(nu / bc2) + eps)
      u = __fdiv_rn(__fdiv_rn(m, bc1),
                    __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), a.eps));
    } else {
      // nu = (1 - decay) g^2 + decay nu; rsqrt(nu + eps) g
      const float v = __fadd_rn(__fmul_rn(a.c2, __fmul_rn(gi, gi)),
                                __fmul_rn(a.b2, nu[i]));
      nu[i] = v;
      u = __fmul_rn(rsqrtf(__fadd_rn(v, a.eps)), gi);
    }
    // p -= lr u; e -= (1 - decay) (e - p)
    const float pi = __fsub_rn(p[i], __fmul_rn(a.lr, u));
    p[i] = pi;
    const float ei = e[i];
    e[i] = __fsub_rn(ei, __fmul_rn(a.ema_c, __fsub_rn(ei, pi)));
  }
}

cudaError_t launch(int which, const Args& args, const void* const* grads,
                   cudaStream_t stream) {
  Block b{};
  b.a = args;
  std::memcpy(b.g, grads, sizeof(void*) * args.n_leaves);
  if (which == 0) {
    sumsq_kernel<<<args.clip ? args.n_chunks : 1, kThreads, 0, stream>>>(b);
  } else if (args.kind == kSgd) {
    update_kernel<kSgd><<<args.n_chunks, kThreads, 0, stream>>>(b);
  } else if (args.kind == kAdam) {
    update_kernel<kAdam><<<args.n_chunks, kThreads, 0, stream>>>(b);
  } else {
    update_kernel<kRmsProp><<<args.n_chunks, kThreads, 0, stream>>>(b);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches sumsq_kernel (which = 0: the clip's partial sums and, with
// tick, Adam's count; one block when there is no clip) or update_kernel
// (which = 1) for a group of at most kSlots leaves on `stream`, with
// grads[i] the gradient of leaf i, and returns cudaGetLastError() (0 on
// success). Does not synchronise and allocates nothing.
int optim_launch(int which, const Args* args, const void* const* grads,
                 int device, void* stream) {
  cudaGetLastError();  // clear any stale error of this runtime
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (args->n_chunks < 1 || args->n_leaves < 1 || args->n_leaves > kSlots ||
      args->kind < kSgd || args->kind > kRmsProp ||
      (args->tick && args->count == nullptr))
    return (int)cudaErrorInvalidValue;
  return (int)launch(which, *args, grads, static_cast<cudaStream_t>(stream));
}

// sizeof(Leaf) (which = 0), sizeof(Args) (1) and sizeof(Block) (2), for
// ops/optim.py's check of its ctypes layouts.
int optim_sizes(int which) {
  return which == 0 ? (int)sizeof(Leaf)
                    : which == 1 ? (int)sizeof(Args) : (int)sizeof(Block);
}

const char* optim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
