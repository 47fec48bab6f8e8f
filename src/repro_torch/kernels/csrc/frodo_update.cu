// Fused FrODO parameter update: two hand-written kernels for Hopper (sm_90a).
//
// They replace the two TPU (Pallas) kernels of the JAX package,
// src/repro/kernels/frodo_update.py:
//
//   exact_update_kernel   <- _exact_kernel  / exact_update_2d
//   expsum_update_kernel  <- _expsum_kernel / expsum_update_2d
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s f32): both are streaming passes
// with ~2 flops per element of state loaded, so memory bounds them, by a
// factor of 20 (bf16 state) to 40 (f32) over compute.  Exact mode moves
// (T + 3) * n elements per call (history, g, delta, the pushed slot);
// exp-sum mode 2 * (K + 1) * n.  Every byte of state is read once and
// written at most once; the levers are to move no byte twice and to keep
// enough loads in flight.  The design:
//
//   * Flat, contiguous buffers.  The TPU kernels walk (R, 128) tiles; here a
//     thread owns contiguous elements and reads them as 16-byte vectors
//     (4 x f32 or 8 x bf16) when n and the pointers allow, with a masked
//     scalar loop for the rest (n = 1, 7, ... or unaligned pointers).
//     Neighbouring threads read neighbouring 16-byte chunks of each row, so
//     every warp access is fully coalesced.
//   * One pass.  The weighted sum over history slots (exact) or
//     accumulators (exp-sum) is carried in f32 registers; nothing
//     intermediate goes to device memory.  All arithmetic is f32 with one
//     rounding to the output type at the end, as in the Pallas kernels.
//   * Exact mode gets the UNROTATED mu weights (a device f32 vector made
//     once per optimizer) and the integer cursor; each block derives the
//     slot weights w_slot[s] = mu[n(s) - 1], n(s) = (cursor - s) mod T with
//     0 read as T, into shared memory.  No per-step host-to-device copy of
//     rotated weights and no device-to-host read of the cursor.
//   * The push of g into hist[cursor] is FUSED: each thread has read its
//     elements of every slot, slot `cursor` included (it holds g^(k-T) with
//     weight mu(T)), before it overwrites them with g.  The copy is of raw
//     bits, so the pushed history equals an out-of-kernel copy exactly.
//   * Exp-sum mode gets the K <= 16 rates and coefficients by value in the
//     kernel's parameters, packed once per optimizer on the host, and
//     writes the new accumulators in place over the old.  K is a template
//     parameter (1..16, one switch at launch).  A thread holds two 16-byte
//     chunks of each accumulator and issues the loads of up to 8
//     accumulators before it stores any (a store through `acc` would
//     otherwise keep the next accumulator's loads behind it), so 256-512
//     bytes a thread are in flight.  One block per tile of the leaf, with
//     the default cache policy: on an H100 a persistent grid was 4-7%
//     slower at full-width leaves, evict-first hints 1-2%, and a TMA ring
//     of bulk copies 2-6% (PERF.md).
//
// Host interface: plain C functions (built with nvcc into a shared library
// and called through ctypes).  Each launches on the given stream, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 16;
// Slot weights staged as f32 in shared memory: at most 48 KB without an
// opt-in attribute.
constexpr int kMaxSlots = 12288;
constexpr long long kMaxBlocks = 1LL << 20;
constexpr long long kMaxGrid = (1LL << 31) - 1;  // gridDim.x's limit

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One 16-byte chunk <-> floats.
__device__ __forceinline__ void unpack(const uint4& u, float* out, float) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* out,
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    out[2 * q] = f.x;
    out[2 * q + 1] = f.y;
  }
}
__device__ __forceinline__ uint4 pack(const float* v, float) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 pack(const float* v, __nv_bfloat16) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int q = 0; q < 4; ++q) h[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
  return u;
}

// V contiguous elements (V a multiple of one chunk) <-> V floats.
template <int V, typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  constexpr int C = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < V; j += C)
    unpack(*reinterpret_cast<const uint4*>(p + j), out + j, T());
}
template <int V, typename T>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  constexpr int C = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < V; j += C)
    *reinterpret_cast<uint4*>(p + j) = pack(v + j, T());
}

// ------------------------------------------------------------------ exact
//
// delta = -(alpha * g + beta * sum_s w_slot[s] * hist[s]);  hist[cursor] = g
// g, delta: (n,); hist: (n_slots, n), all of type T; mu: (n_slots,) f32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
exact_update_kernel(const T* __restrict__ g, T* hist, T* __restrict__ delta,
                    const float* __restrict__ mu, int n_slots, long long n,
                    int cursor, float alpha, float beta, int vectorized) {
  extern __shared__ float w_slot[];
  for (int s = threadIdx.x; s < n_slots; s += blockDim.x) {
    int d = cursor - s;  // cursor in [0, n_slots)
    if (d < 0) d += n_slots;
    w_slot[s] = mu[(d == 0 ? n_slots : d) - 1];
  }
  __syncthreads();

  constexpr int V = 16 / sizeof(T);
  const long long n_vec = vectorized ? n / V : 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  T* const push = hist + (long long)cursor * n;

  for (long long c = tid; c < n_vec; c += stride) {
    const long long i = c * V;
    const uint4 graw = *reinterpret_cast<const uint4*>(g + i);
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_slots; ++s) {
      float h[V];
      load_vec<V>(hist + (long long)s * n + i, h);
      const float w = w_slot[s];
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = fmaf(w, h[j], acc[j]);
    }
    float gv[V], out[V];
    unpack(graw, gv, T());
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = -(alpha * gv[j] + beta * acc[j]);
    store_vec<V>(delta + i, out);
    *reinterpret_cast<uint4*>(push + i) = graw;  // after slot `cursor` was read
  }

  for (long long i = n_vec * V + tid; i < n; i += stride) {
    float acc = 0.f;
    for (int s = 0; s < n_slots; ++s)
      acc = fmaf(w_slot[s], to_f32(hist[(long long)s * n + i]), acc);
    const T gi = g[i];
    delta[i] = from_f32<T>(-(alpha * to_f32(gi) + beta * acc));
    push[i] = gi;
  }
}

// ----------------------------------------------------------------- expsum
//
// M = sum_k c_k * acc[k];  acc[k] <- r_k * (acc[k] + g);
// delta = -(alpha * g + beta * M).  g, delta: (n,) of TG; acc: (K, n) of TA,
// updated in place.
struct ExpsumWeights {
  float r[kMaxK];
  float c[kMaxK];
};

// The loop's shape.  kBatch: accumulators whose chunks a thread loads
// together before it stores any.  kChunks: 16-byte chunks of each
// accumulator a thread holds at once (a block's tile is kChunks * kThreads
// chunks of every row, chunk q of thread t at q * kThreads + t, so each
// warp-wide access is one contiguous span).
constexpr int kBatch = 8;
constexpr int kChunks = 2;

// 16-byte accesses of the accumulators (and of g and delta).
__device__ __forceinline__ uint4 ld16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void st16(void* p, const uint4& v) {
  *reinterpret_cast<uint4*>(p) = v;
}

// N contiguous elements of g or delta <-> N floats.  N is one
// accumulator chunk's element count, so N * sizeof(T) is 8 (bf16 beside f32
// accumulators), 16 or 32 bytes.
template <int N, typename T>
__device__ __forceinline__ void load_n(const T* p, float* out) {
  if constexpr (N * sizeof(T) == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float2 f = __bfloat1622float2(h[q]);
      out[2 * q] = f.x;
      out[2 * q + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; j += 16 / sizeof(T))
      unpack(ld16(p + j), out + j, T());
  }
}
template <int N, typename T>
__device__ __forceinline__ void store_n(T* p, const float* v) {
  if constexpr (N * sizeof(T) == 8) {
    uint2 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int q = 0; q < 2; ++q)
      h[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
#pragma unroll
    for (int j = 0; j < N; j += 16 / sizeof(T))
      st16(p + j, pack(v + j, T()));
  }
}

// K is a template parameter, so every loop over the accumulators unrolls
// to exactly K.  n_chunks: 16-byte chunks of one accumulator row on the
// vector path (0 when the pointers or n rule it out); the elements past
// n_chunks * C go through the scalar loop.
template <typename TG, typename TA, int K>
__global__ void __launch_bounds__(kThreads, 2)
expsum_update_kernel(const TG* __restrict__ g, TA* __restrict__ acc,
                     TG* __restrict__ delta, ExpsumWeights rc, long long n,
                     long long n_chunks, float alpha, float beta) {
  constexpr int C = 16 / sizeof(TA);  // elements in one accumulator chunk
  constexpr long long kTile = (long long)kChunks * kThreads;
  const long long n_tiles = (n_chunks + kTile - 1) / kTile;

  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    long long e[kChunks];  // first element of each chunk
    bool in[kChunks];
    float gv[kChunks][C], M[kChunks][C];
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const long long c = t * kTile + q * kThreads + threadIdx.x;
      in[q] = c < n_chunks;
      e[q] = c * C;
#pragma unroll
      for (int j = 0; j < C; ++j) gv[q][j] = M[q][j] = 0.f;
      if (in[q]) load_n<C>(g + e[q], gv[q]);
    }
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += kBatch) {
      // every load of the batch is issued before its first store
      uint4 raw[kBatch][kChunks];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
#pragma unroll
        for (int q = 0; q < kChunks; ++q) {
          raw[b][q] = make_uint4(0u, 0u, 0u, 0u);
          if (k0 + b < K && in[q])
            raw[b][q] = ld16(acc + (long long)(k0 + b) * n + e[q]);
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int k = k0 + b;
        if (k < K) {
          const float ck = rc.c[k], rk = rc.r[k];
#pragma unroll
          for (int q = 0; q < kChunks; ++q) {
            float a[C];
            unpack(raw[b][q], a, TA());
#pragma unroll
            for (int j = 0; j < C; ++j) {
              M[q][j] = fmaf(ck, a[j], M[q][j]);  // k ascending, as before
              a[j] = rk * (a[j] + gv[q][j]);
            }
            raw[b][q] = pack(a, TA());
          }
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
#pragma unroll
        for (int q = 0; q < kChunks; ++q)
          if (k0 + b < K && in[q])
            st16(acc + (long long)(k0 + b) * n + e[q], raw[b][q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      if (in[q]) {
        float out[C];
#pragma unroll
        for (int j = 0; j < C; ++j)
          out[j] = -(alpha * gv[q][j] + beta * M[q][j]);
        store_n<C>(delta + e[q], out);
      }
    }
  }

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = n_chunks * C + (long long)blockIdx.x * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const float gi = to_f32(g[i]);
    float a[K];
#pragma unroll
    for (int k = 0; k < K; ++k) a[k] = to_f32(acc[(long long)k * n + i]);
    float M = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      M = fmaf(rc.c[k], a[k], M);
      acc[(long long)k * n + i] = from_f32<TA>(rc.r[k] * (a[k] + gi));
    }
    delta[i] = from_f32<TG>(-(alpha * gi + beta * M));
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int grid_for(long long units) {
  long long b = (units + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return (int)b;
}

template <typename T>
int launch_exact(const void* g, void* hist, void* delta, const void* mu,
                 int n_slots, long long n, int cursor, float alpha,
                 float beta, void* stream) {
  if (n_slots < 1 || n_slots > kMaxSlots || cursor < 0 ||
      cursor >= n_slots || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  constexpr int V = 16 / sizeof(T);
  const int vec = (n % V == 0) && aligned16(g) && aligned16(hist) &&
                  aligned16(delta);
  const long long units = vec ? n / V : n;
  exact_update_kernel<T><<<grid_for(units), kThreads,
                           n_slots * sizeof(float), (cudaStream_t)stream>>>(
      static_cast<const T*>(g), static_cast<T*>(hist), static_cast<T*>(delta),
      static_cast<const float*>(mu), n_slots, n, cursor, alpha, beta, vec);
  return (int)cudaGetLastError();
}

// One block per tile of the leaf.
template <typename TG, typename TA, int K>
int launch_expsum_k(const void* g, void* acc, void* delta,
                    const ExpsumWeights& w, long long n, float alpha,
                    float beta, cudaStream_t stream) {
  constexpr int C = 16 / sizeof(TA);
  const bool vec = (n % 8 == 0) && aligned16(g) && aligned16(acc) &&
                   aligned16(delta);
  const long long n_chunks = vec ? n / C : 0;
  const long long per_block = vec ? (long long)kChunks * kThreads : kThreads;
  const long long units = vec ? n_chunks : n;
  long long blocks = (units + per_block - 1) / per_block;
  if (blocks > kMaxGrid) blocks = kMaxGrid;
  if (blocks < 1) blocks = 1;
  expsum_update_kernel<TG, TA, K><<<(int)blocks, kThreads, 0, stream>>>(
      static_cast<const TG*>(g), static_cast<TA*>(acc),
      static_cast<TG*>(delta), w, n, n_chunks, alpha, beta);
  return (int)cudaGetLastError();
}

// One switch picks the instantiation for K.
template <typename TG, typename TA>
int launch_expsum(const void* g, void* acc, void* delta,
                  const ExpsumWeights* w, int K, long long n, float alpha,
                  float beta, void* stream) {
  if (K < 1 || K > kMaxK || n < 0 || w == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (K) {
#define FRODO_EXPSUM_K(k) \
  case k:                 \
    return launch_expsum_k<TG, TA, k>(g, acc, delta, *w, n, alpha, beta, s);
    FRODO_EXPSUM_K(1) FRODO_EXPSUM_K(2) FRODO_EXPSUM_K(3) FRODO_EXPSUM_K(4)
    FRODO_EXPSUM_K(5) FRODO_EXPSUM_K(6) FRODO_EXPSUM_K(7) FRODO_EXPSUM_K(8)
    FRODO_EXPSUM_K(9) FRODO_EXPSUM_K(10) FRODO_EXPSUM_K(11)
    FRODO_EXPSUM_K(12) FRODO_EXPSUM_K(13) FRODO_EXPSUM_K(14)
    FRODO_EXPSUM_K(15) FRODO_EXPSUM_K(16)
#undef FRODO_EXPSUM_K
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The build (frodo_update.py) compiles this file as UNITS objects side by
// side, unit u holding the entries below marked for it (their kernels
// instantiate with them), and links them into one library; without
// FRODO_UNIT one object holds every entry.
#ifndef FRODO_UNIT
#define FRODO_UNIT -1
#endif
#define FRODO_IN_UNIT(u) (FRODO_UNIT < 0 || FRODO_UNIT == (u))

extern "C" {

#if FRODO_IN_UNIT(0)
const char* frodo_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int frodo_exact_update_f32(const void* g, void* hist, void* delta,
                           const void* mu, int n_slots, long long n,
                           int cursor, float alpha, float beta,
                           void* stream) {
  return launch_exact<float>(g, hist, delta, mu, n_slots, n, cursor, alpha,
                             beta, stream);
}

int frodo_exact_update_bf16(const void* g, void* hist, void* delta,
                            const void* mu, int n_slots, long long n,
                            int cursor, float alpha, float beta,
                            void* stream) {
  return launch_exact<__nv_bfloat16>(g, hist, delta, mu, n_slots, n, cursor,
                                     alpha, beta, stream);
}
#endif

#define FRODO_EXPSUM_ENTRY(NAME, TG, TA)                                    \
  int NAME(const void* g, void* acc, void* delta, const void* weights,     \
           int K, long long n, float alpha, float beta, void* stream) {     \
    return launch_expsum<TG, TA>(                                           \
        g, acc, delta, static_cast<const ExpsumWeights*>(weights), K, n,    \
        alpha, beta, stream);                                               \
  }

#if FRODO_IN_UNIT(0)
FRODO_EXPSUM_ENTRY(frodo_expsum_update_f32_f32, float, float)
#endif
#if FRODO_IN_UNIT(1)
FRODO_EXPSUM_ENTRY(frodo_expsum_update_f32_bf16, float, __nv_bfloat16)
#endif
#if FRODO_IN_UNIT(2)
FRODO_EXPSUM_ENTRY(frodo_expsum_update_bf16_f32, __nv_bfloat16, float)
#endif
#if FRODO_IN_UNIT(3)
FRODO_EXPSUM_ENTRY(frodo_expsum_update_bf16_bf16, __nv_bfloat16,
                   __nv_bfloat16)
#endif

#undef FRODO_EXPSUM_ENTRY

}  // extern "C"
