// MoE dispatch for Hopper (sm_90a): the route -> slot map, the pack of the
// tokens into the experts' (E, cap, D) buffer, the gate-weighted combine of
// the experts' rows back onto the tokens, and the backwards of both.  Built
// with the flash-attention sources into one plain-C shared library and bound
// with ctypes (repro_torch/kernels/moe_dispatch.py).
//
// Replaces no Pallas kernel.  The reference (repro/models/moe.py _pack,
// _combine) ranks each route in its expert's queue with jnp.cumsum over the
// token-major (T*K, E) one-hot and scatters with .at[eid, pos].add, which
// XLA fuses on the TPU.  Written the same way in PyTorch (the plain version,
// repro_torch/models/moe.py), the cumsum is an outer-dim scan over a
// (T*K, E) int64 one-hot, a handful of threads each walking T*K rows, and
// the scatter and the gather's backward are accumulating index_puts, which
// sort their indices and serialise the dropped routes that all land on
// slot cap-1.  At granite's training shape on an H100 those took ~80 % of the step.
//
// What bounds them on an H100: bytes; none does arithmetic worth counting.
// At granite's training shape (T 16,384, K 8, E 40, cap 4,096, D 1,536, bf16;
// N = T*K = 131,072 routes, E*cap = 163,840 slots, kept routes <= both):
//   moe_slots        reads the ids (1 MB), writes slot (0.5 MB), the inverse
//                    map and the counts: ~0.5 us of bytes, so three launches'
//                    latency sets its time;
//   moe_pack         writes every slot row once (503 MB) and reads the kept
//                    routes' token rows: ~0.15 ms;
//   moe_pack_bwd     reads the kept slots' rows, writes d_x (50 MB);
//   moe_combine      reads the kept slots' rows, writes y (50 MB) and, for
//                    the backward, each route's row (403 MB, zeros where
//                    dropped) and its gate in the working dtype (0.26 MB):
//                    what the plain combine's mul keeps;
//   moe_combine_bwd  writes every slot row of d_out once (503 MB), reads dy
//                    and the kept routes' saved rows.
// The design moves each of those bytes once, in 16-byte vectors, and never
// reads a dropped route's row:
//   * the slot map, in three launches and no atomics: (1) one warp counts
//     the experts of each segment of SEG consecutive routes into its own
//     shared-memory histogram, ranking within 32 routes at a time with
//     __match_any_sync; (2) one block per expert turns its column of
//     segment counts into exclusive offsets (a block scan) and its total,
//     counts[e]; (3) each warp walks its segment again from those offsets:
//     a route's position is the offset of its expert plus the popcount of
//     the lower lanes of its __match_any_sync group, and the group's lowest
//     lane advances the offset.  A position is the route's rank among the
//     earlier routes to its expert in token-major order, exactly the
//     cumsum's, so the same routes are dropped; every step is integer and
//     in a fixed order, so the map is bitwise the same on every run (a
//     recomputed segment rebuilds the map its forward built).  slot[r] is
//     e*cap + pos, or -1 for a dropped route, and src[slot] = r inverts it
//     (each slot is written by one route; slots at c >= min(counts[e],
//     cap) hold no route and are never read).  The backward keeps slot and
//     counts and writes src again from slot (one pass over the routes), so
//     what autograd keeps is no more than the plain version's indices;
//   * pack and the backward's d_out are gathers over slots: one warp writes
//     one slot row, its route's row or zeros, so each row is written once
//     and nothing accumulates;
//   * combine, the pack's backward and the gate's gradient are gathers over
//     tokens: one warp reads the K slot rows of one token and sums them in
//     f32 in the order k = 0..K-1, rounding where the plain version's ops
//     round (each gate-weighted product in the working dtype, the sum once).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SEG = 256;           // routes one warp of the map counts and ranks
constexpr int MAP_WARPS = 8;       // warps in a block of the count and rank kernels
constexpr int SCAN_THREADS = 256;  // threads of the scan's block (one block an expert)
constexpr int MAX_EXPERTS = 1024;  // MAP_WARPS * E ints of shared memory: 32 KB at most
constexpr int MAX_TOP_K = 32;      // a token's K routes are held by one warp's lanes
constexpr int ROW_WARPS = 8;       // rows (slots or tokens) in a block of the row kernels

__host__ __device__ inline int segments(int n) { return (n + SEG - 1) / SEG; }

// the expert of route r, or -1 past the end or for an id outside [0, E)
__device__ __forceinline__ int route_expert(const long long* ids, long long r, int n, int E) {
  if (r >= n) return -1;
  const long long e = ids[r];
  return (e >= 0 && e < E) ? (int)e : -1;
}

// (1) hist[g * E + e]: the routes of segment g that go to expert e
__global__ void __launch_bounds__(MAP_WARPS * WARP)
    slot_count_kernel(const long long* __restrict__ ids, int n, int E, int* __restrict__ hist) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int g = blockIdx.x * MAP_WARPS + warp;
  if (g >= segments(n)) return;
  int* cnt = smem + warp * E;
  for (int e = lane; e < E; e += WARP) cnt[e] = 0;
  __syncwarp();
  const long long first = (long long)g * SEG;
  const unsigned below = (1u << lane) - 1;
  for (int c = 0; c < SEG && first + c < n; c += WARP) {
    const int e = route_expert(ids, first + c + lane, n, E);
    const unsigned same = __match_any_sync(FULL, e);
    if (e >= 0 && (same & below) == 0) cnt[e] += __popc(same);  // one lane an expert
    __syncwarp();
  }
  for (int e = lane; e < E; e += WARP) hist[(long long)g * E + e] = cnt[e];
}

// (2) for expert blockIdx.x: hist's column -> exclusive offsets over the
// segments, in place; counts[e] = the column's total
__global__ void __launch_bounds__(SCAN_THREADS)
    slot_scan_kernel(int* __restrict__ hist, int G, int E, int* __restrict__ counts) {
  __shared__ int warp_sum[SCAN_THREADS / WARP];
  const int e = blockIdx.x, lane = threadIdx.x % WARP, warp = threadIdx.x / WARP;
  int carry = 0;
  for (int g0 = 0; g0 < G; g0 += SCAN_THREADS) {
    const int g = g0 + threadIdx.x;
    const int v = g < G ? hist[(long long)g * E + e] : 0;
    int incl = v;
    for (int d = 1; d < WARP; d *= 2) {
      const int up = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane == WARP - 1) warp_sum[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < SCAN_THREADS / WARP; ++w) {
      before += w < warp ? warp_sum[w] : 0;
      total += warp_sum[w];
    }
    if (g < G) hist[(long long)g * E + e] = carry + before + incl - v;
    carry += total;
    __syncthreads();  // warp_sum is written again by the next chunk
  }
  if (threadIdx.x == 0) counts[e] = carry;
}

// (3) each route's position from its segment's offsets: slot and src
__global__ void __launch_bounds__(MAP_WARPS * WARP)
    slot_rank_kernel(const long long* __restrict__ ids, int n, int E, int cap,
                     const int* __restrict__ offsets, int* __restrict__ slot,
                     int* __restrict__ src) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int g = blockIdx.x * MAP_WARPS + warp;
  if (g >= segments(n)) return;
  int* next = smem + warp * E;
  for (int e = lane; e < E; e += WARP) next[e] = offsets[(long long)g * E + e];
  __syncwarp();
  const long long first = (long long)g * SEG;
  const unsigned below = (1u << lane) - 1;
  for (int c = 0; c < SEG && first + c < n; c += WARP) {
    const long long r = first + c + lane;
    const int e = route_expert(ids, r, n, E);
    const unsigned same = __match_any_sync(FULL, e);
    const int pos = e >= 0 ? next[e] + __popc(same & below) : cap;
    __syncwarp();
    if (e >= 0 && (same & below) == 0) next[e] += __popc(same);
    __syncwarp();
    if (r < n) {
      const int s = pos < cap ? e * cap + pos : -1;
      slot[r] = s;
      if (s >= 0) src[s] = (int)r;
    }
  }
}

// src[slot[r]] = r for every kept route r (each slot written once)
__global__ void __launch_bounds__(256)
    slot_invert_kernel(const int* __restrict__ slot, int n, int* __restrict__ src) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int s = slot[r];
  if (s >= 0) src[s] = (int)r;
}

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch rounds
}
// x rounded to T and back: where the plain version's op stores a T
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f<T>(from_f<T>(x)); }

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> zeros() {
  Vec<T, V> z;
#pragma unroll
  for (int j = 0; j < V; ++j) z.v[j] = from_f<T>(0.f);
  return z;
}

// One warp a slot row s = e * cap + c of out (E*cap rows of D): the row
// rows_in[src[s] / K] of the route in the slot, or zeros where c >=
// min(counts[e], cap).  SCALED: that row times the route's weight w (the
// gate already rounded to T), the product rounded to T (the plain
// combine's mul backward).
template <typename T, int V, bool SCALED>
__global__ void __launch_bounds__(ROW_WARPS * WARP)
    slot_rows_kernel(const T* __restrict__ rows_in, const T* __restrict__ w_in,
                     const int* __restrict__ src, const int* __restrict__ counts,
                     T* __restrict__ out, long long n_slots, int cap, int K, int D) {
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const long long s = (long long)blockIdx.x * ROW_WARPS + warp;
  if (s >= n_slots) return;
  const int nv = D / V;
  Vec<T, V>* o = reinterpret_cast<Vec<T, V>*>(out) + s * nv;
  const int e = (int)(s / cap), c = (int)(s % cap);
  if (c >= min(counts[e], cap)) {
    const Vec<T, V> z = zeros<T, V>();
    for (int i = lane; i < nv; i += WARP) o[i] = z;
    return;
  }
  const int r = src[s];
  const Vec<T, V>* in = reinterpret_cast<const Vec<T, V>*>(rows_in) + (long long)(r / K) * nv;
  const float w = SCALED ? to_f<T>(w_in[r]) : 0.f;
  for (int i = lane; i < nv; i += WARP) {
    Vec<T, V> x = in[i];
    if (SCALED) {
#pragma unroll
      for (int j = 0; j < V; ++j) x.v[j] = from_f<T>(to_f<T>(x.v[j]) * w);
    }
    o[i] = x;
  }
}

// One warp a token t: out[t] = the sum over its K routes r = t*K + k of the
// kept rows rows_in[slot[r]], in f32 in the order of k, rounded once to T.
// SCALED: each row times its gate, the gate and the product rounded to T
// first (the plain combine's mul in the working dtype).  saved and w_out
// (each may be null): each route's row, zeros where it was dropped, and
// its gate rounded to T.
template <typename T, int V, bool SCALED>
__global__ void __launch_bounds__(ROW_WARPS * WARP)
    token_rows_kernel(const T* __restrict__ rows_in, const float* __restrict__ gate,
                      const int* __restrict__ slot, T* __restrict__ out, T* __restrict__ saved,
                      T* __restrict__ w_out, int n_tokens, int K, int D) {
  __shared__ int s_slot[ROW_WARPS][MAX_TOP_K];
  __shared__ float s_gate[ROW_WARPS][MAX_TOP_K];
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const long long t = (long long)blockIdx.x * ROW_WARPS + warp;
  if (t >= n_tokens) return;
  if (lane < K) {
    s_slot[warp][lane] = slot[t * K + lane];
    s_gate[warp][lane] = SCALED ? round_to<T>(gate[t * K + lane]) : 0.f;
    if (w_out != nullptr) w_out[t * K + lane] = from_f<T>(gate[t * K + lane]);
  }
  __syncwarp();
  const int nv = D / V;
  const Vec<T, V>* in = reinterpret_cast<const Vec<T, V>*>(rows_in);
  Vec<T, V>* sv = reinterpret_cast<Vec<T, V>*>(saved);
  for (int i = lane; i < nv; i += WARP) {
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const int s = s_slot[warp][k];
      Vec<T, V> x = zeros<T, V>();
      if (s >= 0) {
        x = in[(long long)s * nv + i];
        const float w = s_gate[warp][k];
#pragma unroll
        for (int j = 0; j < V; ++j)
          acc[j] += SCALED ? round_to<T>(to_f<T>(x.v[j]) * w) : to_f<T>(x.v[j]);
      }
      if (saved != nullptr) sv[(t * K + k) * nv + i] = x;
    }
    Vec<T, V> y;
#pragma unroll
    for (int j = 0; j < V; ++j) y.v[j] = from_f<T>(acc[j]);
    reinterpret_cast<Vec<T, V>*>(out)[t * nv + i] = y;
  }
}

// One warp a token t: d_gate[r] for its routes r = t*K + k, the sum over d
// of saved[r, d] * dy[t, d], each product rounded to T, the sum in f32
// rounded once to T (the plain combine's mul backward reduced over the
// broadcast D); zero for a dropped route, whose saved row is zeros.
template <typename T, int V>
__global__ void __launch_bounds__(ROW_WARPS * WARP)
    gate_grad_kernel(const T* __restrict__ saved, const T* __restrict__ dy,
                     const int* __restrict__ slot, float* __restrict__ d_gate, int n_tokens, int K,
                     int D) {
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const long long t = (long long)blockIdx.x * ROW_WARPS + warp;
  if (t >= n_tokens) return;
  const int nv = D / V;
  const Vec<T, V>* g = reinterpret_cast<const Vec<T, V>*>(dy) + t * nv;
  for (int k = 0; k < K; ++k) {
    const long long r = t * K + k;
    if (slot[r] < 0) {  // the same for the whole warp
      if (lane == 0) d_gate[r] = 0.f;
      continue;
    }
    const Vec<T, V>* a = reinterpret_cast<const Vec<T, V>*>(saved) + r * nv;
    float acc = 0.f;
    for (int i = lane; i < nv; i += WARP) {
      const Vec<T, V> x = a[i], y = g[i];
#pragma unroll
      for (int j = 0; j < V; ++j) acc += round_to<T>(to_f<T>(x.v[j]) * to_f<T>(y.v[j]));
    }
    for (int off = WARP / 2; off > 0; off /= 2) acc += __shfl_xor_sync(FULL, acc, off);
    if (lane == 0) d_gate[r] = round_to<T>(acc);
  }
}

// 16-byte vectors where D and every row base allow them, single elements
// otherwise
template <typename T>
bool vectors(int D, const void* a, const void* b, const void* c = nullptr) {
  const uintptr_t bases = (uintptr_t)a | (uintptr_t)b | (uintptr_t)c;
  return (D * sizeof(T)) % 16 == 0 && bases % 16 == 0;
}

unsigned blocks_of(long long rows, int per_block) {
  return (unsigned)((rows + per_block - 1) / per_block);
}

template <typename T, bool SCALED>
int slot_rows(const void* rows_in, const void* w_in, const int* src, const int* counts,
              void* out, int E, int cap, int K, int D, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const long long n_slots = (long long)E * cap;
  const unsigned blocks = blocks_of(n_slots, ROW_WARPS);
  const T *in = static_cast<const T*>(rows_in), *w = static_cast<const T*>(w_in);
  T* o = static_cast<T*>(out);
  if (vectors<T>(D, rows_in, out))
    slot_rows_kernel<T, V, SCALED><<<blocks, ROW_WARPS * WARP, 0, st>>>(in, w, src, counts, o,
                                                                        n_slots, cap, K, D);
  else
    slot_rows_kernel<T, 1, SCALED><<<blocks, ROW_WARPS * WARP, 0, st>>>(in, w, src, counts, o,
                                                                        n_slots, cap, K, D);
  return (int)cudaGetLastError();
}

template <typename T, bool SCALED>
int token_rows(const void* rows_in, const float* gate, const int* slot, void* out, void* saved,
               void* w_out, int n_tokens, int K, int D, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const unsigned blocks = blocks_of(n_tokens, ROW_WARPS);
  const T* in = static_cast<const T*>(rows_in);
  T *o = static_cast<T*>(out), *sv = static_cast<T*>(saved), *w = static_cast<T*>(w_out);
  if (vectors<T>(D, rows_in, out, saved))
    token_rows_kernel<T, V, SCALED><<<blocks, ROW_WARPS * WARP, 0, st>>>(in, gate, slot, o, sv,
                                                                         w, n_tokens, K, D);
  else
    token_rows_kernel<T, 1, SCALED><<<blocks, ROW_WARPS * WARP, 0, st>>>(in, gate, slot, o, sv,
                                                                         w, n_tokens, K, D);
  return (int)cudaGetLastError();
}

template <typename T>
int gate_grad(const void* saved, const void* dy, const int* slot, float* d_gate, int n_tokens,
              int K, int D, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const unsigned blocks = blocks_of(n_tokens, ROW_WARPS);
  const T *a = static_cast<const T*>(saved), *g = static_cast<const T*>(dy);
  if (vectors<T>(D, saved, dy))
    gate_grad_kernel<T, V><<<blocks, ROW_WARPS * WARP, 0, st>>>(a, g, slot, d_gate, n_tokens, K, D);
  else
    gate_grad_kernel<T, 1><<<blocks, ROW_WARPS * WARP, 0, st>>>(a, g, slot, d_gate, n_tokens, K, D);
  return (int)cudaGetLastError();
}

bool bad_shape(int n_tokens, int K, int D) {
  return n_tokens < 0 || K < 1 || K > MAX_TOP_K || D < 1;
}

}  // namespace

extern "C" {

// ints of scratch moe_slots needs for n routes over E experts
int moe_slots_scratch(int n, int E) { return segments(n) * E; }

// expert_ids (n,) int64 -> slot (n,) int32, src (E*cap,) int32 (defined
// where a route fills the slot), counts (E,) int32; scratch as above
int moe_slots(const long long* ids, int n, int E, int cap, int* slot, int* src, int* counts,
              int* scratch, void* stream) {
  if (n < 0 || E < 1 || E > MAX_EXPERTS || cap < 1 || (long long)E * cap > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = segments(n);
  const unsigned blocks = blocks_of(G, MAP_WARPS);
  const size_t smem = (size_t)MAP_WARPS * E * sizeof(int);
  if (G > 0) slot_count_kernel<<<blocks, MAP_WARPS * WARP, smem, st>>>(ids, n, E, scratch);
  slot_scan_kernel<<<E, SCAN_THREADS, 0, st>>>(scratch, G, E, counts);
  if (G > 0)
    slot_rank_kernel<<<blocks, MAP_WARPS * WARP, smem, st>>>(ids, n, E, cap, scratch, slot, src);
  return (int)cudaGetLastError();
}

// xt (T, D) -> disp (E*cap, D)
int moe_pack(int dtype, const void* xt, const int* src, const int* counts, void* disp, int E,
             int cap, int K, int D, void* stream) {
  if (E < 1 || cap < 1 || bad_shape(0, K, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return slot_rows<float, false>(xt, nullptr, src, counts, disp, E, cap, K, D, st);
  if (dtype == 1)
    return slot_rows<__nv_bfloat16, false>(xt, nullptr, src, counts, disp, E, cap, K, D, st);
  return (int)cudaErrorInvalidValue;
}

// d_disp (E*cap, D) -> d_xt (T, D)
int moe_pack_bwd(int dtype, const void* d_disp, const int* slot, void* d_xt, int T, int K, int D,
                 void* stream) {
  if (T < 1 || bad_shape(T, K, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return token_rows<float, false>(d_disp, nullptr, slot, d_xt, nullptr, nullptr, T, K, D, st);
  if (dtype == 1)
    return token_rows<__nv_bfloat16, false>(d_disp, nullptr, slot, d_xt, nullptr, nullptr, T, K,
                                            D, st);
  return (int)cudaErrorInvalidValue;
}

// out_e (E*cap, D), gate (T*K,) f32 -> y (T, D) and, where not null, each
// route's row saved (T*K, D) and its gate rounded to the dtype, w (T*K,)
int moe_combine(int dtype, const void* out_e, const float* gate, const int* slot, void* y,
                void* saved, void* w, int T, int K, int D, void* stream) {
  if (T < 1 || bad_shape(T, K, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return token_rows<float, true>(out_e, gate, slot, y, saved, w, T, K, D, st);
  if (dtype == 1)
    return token_rows<__nv_bfloat16, true>(out_e, gate, slot, y, saved, w, T, K, D, st);
  return (int)cudaErrorInvalidValue;
}

// dy (T, D) -> d_out (E*cap, D) from the weights w where d_out is not null
// (src: E*cap ints of scratch, written again from slot), and d_gate (T*K,)
// f32 from the saved rows where d_gate is not null
int moe_combine_bwd(int dtype, const void* dy, const void* w, const void* saved,
                    const int* slot, const int* counts, int* src, void* d_out, float* d_gate,
                    int E, int cap, int T, int K, int D, void* stream) {
  if (T < 1 || E < 1 || cap < 1 || bad_shape(T, K, D) || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = 0;
  if (d_out != nullptr) {
    const int n = T * K;
    slot_invert_kernel<<<blocks_of(n, 256), 256, 0, st>>>(slot, n, src);
    err = dtype == 0
              ? slot_rows<float, true>(dy, w, src, counts, d_out, E, cap, K, D, st)
              : slot_rows<__nv_bfloat16, true>(dy, w, src, counts, d_out, E, cap, K, D, st);
  }
  if (err == 0 && d_gate != nullptr)
    err = dtype == 0 ? gate_grad<float>(saved, dy, slot, d_gate, T, K, D, st)
                     : gate_grad<__nv_bfloat16>(saved, dy, slot, d_gate, T, K, D, st);
  return err;
}

}  // extern "C"
