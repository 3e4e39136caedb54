// Flash attention for Hopper (sm_90a), SIMT route: online-softmax forward
// and the two backward kernels that recompute the probabilities, built with
// flash_attention_sm90.cu into one plain-C shared library and bound with
// ctypes (repro_torch/kernels/flash_attention.py).
//
// Replaces the Pallas TPU kernels of repro/kernels/flash_attention.py:
//   flash_fwd      <- _fwd_kernel      (flash_attention_fwd, pallas_call at :154)
//   flash_bwd_dq   <- _bwd_dq_kernel   (flash_attention_bwd, pallas_call at :311)
//   flash_bwd_dkv  <- _bwd_dkv_kernel  (flash_attention_bwd, pallas_call at :326)
//
// Routes, by dtype and D (an explicit switch in the C entry points below,
// not a fallback): bf16 inputs with D a multiple of 16 go to the
// tensor-core kernels of flash_attention_sm90.cu (wgmma, TMA, mbarrier
// ring), whose operands are whole swizzle atoms of 16, 32 or 64 columns;
// f32 inputs and bf16 with any other D run the SIMT kernels of this file.
//
// What bounds them on an H100, at the training shape (B 2, H 32, S 1024,
// D 80, bf16, causal), from chip_smoke.attention_bounds: the forward moves
// 42 MB (12.6 us at 3.35 TB/s) for 10.7 GFLOP (10.9 us at 989 TFLOP/s), so
// bytes bound it; dq (16.3 us) and dk/dv (21.7 us) are bound by the
// tensor-core rate.  These SIMT kernels do not approach either bound: their
// products run on the CUDA cores in f32 (no wgmma, no TMA, no pipelining).
// What the design does keep from the TPU kernels is the memory trade: the
// S x S score matrix never reaches device memory; the forward keeps only
// the per-row logsumexp and the backward recomputes the probabilities tile
// by tile.
//
// Design (not a block-by-block copy of the Pallas grid, whose kv axis is a
// sequential grid dimension carrying VMEM scratch):
//   * forward and dq: one block per (batch*head, 64-row q tile); the block
//     loops over 64-row kv tiles held in shared memory, with the running
//     max / sum / accumulator in f32 registers (the Pallas (bq, 128)
//     lane-broadcast m/l scratch is a TPU layout artifact and is dropped);
//   * dk/dv: one block per (batch*kv_head, 64-row kv tile); the block loops
//     over the heads of its GQA group and over the q tiles, so the group
//     fold happens in registers and no atomics are used: the results are
//     deterministic;
//   * 256 threads as a 16 x 16 grid; thread (ty, tx) owns score rows
//     ty + 16 r and columns tx + 16 c (r, c < 4) of each 64 x 64 tile, and
//     output columns tx + 16 j (j < 8, so D <= 128).  Row reductions are
//     shuffles inside the 16 lanes that share ty.  Shared-memory rows have
//     an odd pitch (D + 1) so the strided column reads hit distinct banks;
//   * inputs are f32 or bf16 (bf16 only when D is not a multiple of 16),
//     any element strides for the batch, head and sequence dims (the last
//     dim must be contiguous), all arithmetic f32;
//   * ragged sequence lengths are bounds-checked, never padded;
//   * causal masking uses the decode-style offset off = Sk - Sq (query i
//     sees keys j <= i + off), and kv tiles strictly above the band are
//     skipped.  A row that sees no key (only possible when Sq > Sk) gets
//     zero output, lse = -1e30 and zero gradients.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;         // q rows per tile
constexpr int BK = 64;         // kv rows per tile
constexpr int TX = 16;         // threads along a tile row
constexpr int TY = 16;         // threads along a tile column
constexpr int NT = TX * TY;    // threads per block
constexpr int RQ = BQ / TY;    // tile rows owned by one thread
constexpr int CK = BK / TX;    // tile columns owned by one thread
constexpr int MAXJ = 128 / TX; // output columns owned by one thread (D <= 128)

struct Strides {  // element strides of a (batch, heads, seq, D) view
  long long b, h, s;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rows [row0, row0 + nrows) of one head's (S, D) slice -> f32 shared memory
// with pitch dp; rows at or past S read as zero.
template <typename T>
__device__ void load_tile(float* dst, const T* __restrict__ src, long long s_stride,
                          int row0, int nrows, int S, int D, int dp) {
  for (int e = threadIdx.x; e < nrows * D; e += NT) {
    const int r = e / D;
    const int d = e - r * D;
    const int row = row0 + r;
    dst[r * dp + d] = row < S ? to_f(src[(long long)row * s_stride + d]) : 0.f;
  }
}

// Reduction over the 16 lanes that share ty (lanes 0-15 or 16-31 of a warp).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = TX / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = TX / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool visible(int row, int col, int Sq, int Sk, int off, int causal) {
  return row < Sq && col < Sk && (!causal || col <= row + off);
}

// Number of kv tiles that q rows [q0, q_last] can see.
__device__ __forceinline__ int kv_tiles(int q_last, int Sk, int off, int causal) {
  int n = (Sk + BK - 1) / BK;
  if (causal) {
    const int lim = q_last + off;  // last visible key of the last row
    n = lim < 0 ? 0 : min(n, lim / BK + 1);
  }
  return n;
}

// ---------------------------------------------------------------- forward

template <typename T>
__global__ void __launch_bounds__(NT)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, float* __restrict__ lse, Strides qs, Strides ks, Strides vs,
           Strides os, int H, int KV, int Sq, int Sk, int D, int causal, float scale) {
  extern __shared__ float smem[];
  const int dp = D + 1;
  float* Qs = smem;             // BQ x dp
  float* Ks = Qs + BQ * dp;     // BK x dp
  float* Vs = Ks + BK * dp;     // BK x dp
  float* Ps = Vs + BK * dp;     // BQ x (BK + 1)
  const int pp = BK + 1;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, hk = h / (H / KV);
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int off = Sk - Sq;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  load_tile(Qs, qb, qs.s, q0, BQ, Sq, D, dp);

  float m[RQ], l[RQ], acc[RQ][MAXJ];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) acc[r][j] = 0.f;
  }

  const int n_kt = kv_tiles(min(q0 + BQ, Sq) - 1, Sk, off, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's reads of Ks / Vs / Ps are done
    load_tile(Ks, kb, ks.s, k0, BK, Sk, D, dp);
    load_tile(Vs, vb, vs.s, k0, BK, Sk, D, dp);
    __syncthreads();

    float s[RQ][CK];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int c = 0; c < CK; ++c) s[r][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[RQ], kv[CK];
#pragma unroll
      for (int r = 0; r < RQ; ++r) qv[r] = Qs[(ty + TY * r) * dp + d];
#pragma unroll
      for (int c = 0; c < CK; ++c) kv[c] = Ks[(tx + TX * c) * dp + d];
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int c = 0; c < CK; ++c) s[r][c] += qv[r] * kv[c];
    }

#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const int row = q0 + ty + TY * r;
      bool ok[CK];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        ok[c] = visible(row, k0 + tx + TX * c, Sq, Sk, off, causal);
        s[r][c] = ok[c] ? s[r][c] * scale : NEG_INF;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], row_max(mx));
      const float alpha = expf(m[r] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const float p = ok[c] ? expf(s[r][c] - m_new) : 0.f;
        Ps[(ty + TY * r) * pp + tx + TX * c] = p;
        ps += p;
      }
      l[r] = l[r] * alpha + row_sum(ps);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) acc[r][j] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float pv[RQ];
#pragma unroll
      for (int r = 0; r < RQ; ++r) pv[r] = Ps[(ty + TY * r) * pp + kk];
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        const int col = tx + TX * j;
        if (col < D) {
          const float vv = Vs[kk * dp + col];
#pragma unroll
          for (int r = 0; r < RQ; ++r) acc[r][j] += pv[r] * vv;
        }
      }
    }
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int row = q0 + ty + TY * r;
    if (row >= Sq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int col = tx + TX * j;
      if (col < D) ob[(long long)row * os.s + col] = from_f<T>(acc[r][j] * inv);
    }
    if (tx == 0) lse[(long long)bh * Sq + row] = l[r] > 0.f ? m[r] + logf(l[r]) : NEG_INF;
  }
}

// -------------------------------------------------------------- backward dq

template <typename T>
__global__ void __launch_bounds__(NT)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, Strides qs, Strides ks,
          Strides vs, Strides dos, Strides dqs, int H, int KV, int Sq, int Sk, int D,
          int causal, float scale) {
  extern __shared__ float smem[];
  const int dp = D + 1;
  float* Qs = smem;              // BQ x dp
  float* dOs = Qs + BQ * dp;     // BQ x dp
  float* Ks = dOs + BQ * dp;     // BK x dp
  float* Vs = Ks + BK * dp;      // BK x dp
  float* dSs = Vs + BK * dp;     // BQ x (BK + 1)
  const int pp = BK + 1;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H, hk = h / (H / KV);
  const int q0 = blockIdx.x * BQ;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int off = Sk - Sq;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  load_tile(Qs, q + b * qs.b + h * qs.h, qs.s, q0, BQ, Sq, D, dp);
  load_tile(dOs, dout + b * dos.b + h * dos.h, dos.s, q0, BQ, Sq, D, dp);

  float lse_r[RQ], delta_r[RQ], acc[RQ][MAXJ];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int row = q0 + ty + TY * r;
    lse_r[r] = row < Sq ? lse[(long long)bh * Sq + row] : 0.f;
    delta_r[r] = row < Sq ? delta[(long long)bh * Sq + row] : 0.f;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) acc[r][j] = 0.f;
  }

  const int n_kt = kv_tiles(min(q0 + BQ, Sq) - 1, Sk, off, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile(Ks, kb, ks.s, k0, BK, Sk, D, dp);
    load_tile(Vs, vb, vs.s, k0, BK, Sk, D, dp);
    __syncthreads();

    float s[RQ][CK], dpv[RQ][CK];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int c = 0; c < CK; ++c) s[r][c] = dpv[r][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[RQ], dov[RQ], kv[CK], vv[CK];
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        qv[r] = Qs[(ty + TY * r) * dp + d];
        dov[r] = dOs[(ty + TY * r) * dp + d];
      }
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        kv[c] = Ks[(tx + TX * c) * dp + d];
        vv[c] = Vs[(tx + TX * c) * dp + d];
      }
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int c = 0; c < CK; ++c) {
          s[r][c] += qv[r] * kv[c];
          dpv[r][c] += dov[r] * vv[c];
        }
    }

#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const int row = q0 + ty + TY * r;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const bool ok = visible(row, k0 + tx + TX * c, Sq, Sk, off, causal);
        const float p = ok ? expf(s[r][c] * scale - lse_r[r]) : 0.f;
        dSs[(ty + TY * r) * pp + tx + TX * c] = p * (dpv[r][c] - delta_r[r]) * scale;
      }
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float dsv[RQ];
#pragma unroll
      for (int r = 0; r < RQ; ++r) dsv[r] = dSs[(ty + TY * r) * pp + kk];
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        const int col = tx + TX * j;
        if (col < D) {
          const float kv = Ks[kk * dp + col];
#pragma unroll
          for (int r = 0; r < RQ; ++r) acc[r][j] += dsv[r] * kv;
        }
      }
    }
  }

  T* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int row = q0 + ty + TY * r;
    if (row >= Sq) continue;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int col = tx + TX * j;
      if (col < D) dqb[(long long)row * dqs.s + col] = from_f<T>(acc[r][j]);
    }
  }
}

// ------------------------------------------------------------ backward dk/dv

template <typename T>
__global__ void __launch_bounds__(NT)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
           Strides qs, Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs,
           int H, int KV, int Sq, int Sk, int D, int causal, float scale) {
  extern __shared__ float smem[];
  const int dp = D + 1;
  const int pp = BQ + 1;
  float* Ks = smem;              // BK x dp
  float* Vs = Ks + BK * dp;      // BK x dp
  float* Qs = Vs + BK * dp;      // BQ x dp
  float* dOs = Qs + BQ * dp;     // BQ x dp
  float* Pt = dOs + BQ * dp;     // BK x (BQ + 1): p transposed
  float* dSt = Pt + BK * pp;     // BK x (BQ + 1): ds transposed
  float* lse_s = dSt + BK * pp;  // BQ
  float* delta_s = lse_s + BQ;   // BQ

  const int bk = blockIdx.y;
  const int b = bk / KV, hk = bk % KV, group = H / KV;
  const int k0 = blockIdx.x * BK;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int off = Sk - Sq;

  load_tile(Ks, k + b * ks.b + hk * ks.h, ks.s, k0, BK, Sk, D, dp);
  load_tile(Vs, v + b * vs.b + hk * vs.h, vs.s, k0, BK, Sk, D, dp);

  float acc_k[RQ][MAXJ], acc_v[RQ][MAXJ];
#pragma unroll
  for (int r = 0; r < RQ; ++r)
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) acc_k[r][j] = acc_v[r][j] = 0.f;

  // q rows that see key k0 or later: i + off >= k0
  const int first_row = causal ? max(0, k0 - off) : 0;
  const int qt0 = first_row / BQ;
  const int n_qt = (Sq + BQ - 1) / BQ;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const long long lrow = ((long long)b * H + h) * Sq;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's reads of Qs / dOs / Pt / dSt are done
      load_tile(Qs, q + b * qs.b + h * qs.h, qs.s, q0, BQ, Sq, D, dp);
      load_tile(dOs, dout + b * dos.b + h * dos.h, dos.s, q0, BQ, Sq, D, dp);
      for (int i = threadIdx.x; i < BQ; i += NT) {
        const int row = q0 + i;
        lse_s[i] = row < Sq ? lse[lrow + row] : 0.f;
        delta_s[i] = row < Sq ? delta[lrow + row] : 0.f;
      }
      __syncthreads();

      // thread (ty, tx) owns kv rows ty + 16 r and q columns tx + 16 c
      float st[RQ][CK], dpt[RQ][CK];
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int c = 0; c < CK; ++c) st[r][c] = dpt[r][c] = 0.f;
      for (int d = 0; d < D; ++d) {
        float kv[RQ], vv[RQ], qv[CK], dov[CK];
#pragma unroll
        for (int r = 0; r < RQ; ++r) {
          kv[r] = Ks[(ty + TY * r) * dp + d];
          vv[r] = Vs[(ty + TY * r) * dp + d];
        }
#pragma unroll
        for (int c = 0; c < CK; ++c) {
          qv[c] = Qs[(tx + TX * c) * dp + d];
          dov[c] = dOs[(tx + TX * c) * dp + d];
        }
#pragma unroll
        for (int r = 0; r < RQ; ++r)
#pragma unroll
          for (int c = 0; c < CK; ++c) {
            st[r][c] += kv[r] * qv[c];
            dpt[r][c] += vv[r] * dov[c];
          }
      }

#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const int col = k0 + ty + TY * r;
#pragma unroll
        for (int c = 0; c < CK; ++c) {
          const int i = tx + TX * c;
          const bool ok = visible(q0 + i, col, Sq, Sk, off, causal);
          const float p = ok ? expf(st[r][c] * scale - lse_s[i]) : 0.f;
          Pt[(ty + TY * r) * pp + i] = p;
          dSt[(ty + TY * r) * pp + i] = p * (dpt[r][c] - delta_s[i]) * scale;
        }
      }
      __syncthreads();

      for (int qq = 0; qq < BQ; ++qq) {
        float pv[RQ], dsv[RQ];
#pragma unroll
        for (int r = 0; r < RQ; ++r) {
          pv[r] = Pt[(ty + TY * r) * pp + qq];
          dsv[r] = dSt[(ty + TY * r) * pp + qq];
        }
#pragma unroll
        for (int j = 0; j < MAXJ; ++j) {
          const int c = tx + TX * j;
          if (c < D) {
            const float dov = dOs[qq * dp + c];
            const float qv = Qs[qq * dp + c];
#pragma unroll
            for (int r = 0; r < RQ; ++r) {
              acc_v[r][j] += pv[r] * dov;
              acc_k[r][j] += dsv[r] * qv;
            }
          }
        }
      }
    }
  }

  T* dkb = dk + b * dks.b + hk * dks.h;
  T* dvb = dv + b * dvs.b + hk * dvs.h;
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int row = k0 + ty + TY * r;
    if (row >= Sk) continue;
#pragma unroll
    for (int j = 0; j < MAXJ; ++j) {
      const int c = tx + TX * j;
      if (c < D) {
        dkb[(long long)row * dks.s + c] = from_f<T>(acc_k[r][j]);
        dvb[(long long)row * dvs.s + c] = from_f<T>(acc_v[r][j]);
      }
    }
  }
}

// ------------------------------------------------------------ host launchers

size_t fwd_smem(int D) { return sizeof(float) * ((BQ + 2 * BK) * (D + 1) + BQ * (BK + 1)); }
size_t dq_smem(int D) { return sizeof(float) * ((2 * BQ + 2 * BK) * (D + 1) + BQ * (BK + 1)); }
size_t dkv_smem(int D) {
  return sizeof(float) * ((2 * BQ + 2 * BK) * (D + 1) + 2 * BK * (BQ + 1) + 2 * BQ);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, Strides qs,
               Strides ks, Strides vs, Strides os, int B, int H, int KV, int Sq, int Sk, int D,
               int causal, float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem(D);
  cudaError_t err = prepare(fwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  fwd_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, qs, ks, vs, os, H, KV, Sq, Sk, D, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, Strides qs, Strides ks, Strides vs, Strides dos,
              Strides dqs, int B, int H, int KV, int Sq, int Sk, int D, int causal, float scale,
              cudaStream_t stream) {
  const size_t smem = dq_smem(D);
  cudaError_t err = prepare(dq_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  dq_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), qs, ks, vs, dos, dqs, H, KV,
      Sq, Sk, D, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, Strides qs, Strides ks, Strides vs,
               Strides dos, Strides dks, Strides dvs, int B, int H, int KV, int Sq, int Sk, int D,
               int causal, float scale, cudaStream_t stream) {
  const size_t smem = dkv_smem(D);
  cudaError_t err = prepare(dkv_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sk + BK - 1) / BK, B * KV);
  dkv_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), qs, ks,
      vs, dos, dks, dvs, H, KV, Sq, Sk, D, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The bf16 tensor-core kernels (flash_attention_sm90.cu).
int flash_fwd_sm90(const void* q, const void* k, const void* v, void* o, float* lse,
                   const long long* strides, int B, int H, int KV, int Sq, int Sk, int D,
                   int causal, float scale, cudaStream_t stream);
int flash_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, const long long* strides,
                      int B, int H, int KV, int Sq, int Sk, int D, int causal, float scale,
                      cudaStream_t stream);
int flash_bwd_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv,
                       const long long* strides, int B, int H, int KV, int Sq, int Sk, int D,
                       int causal, float scale, cudaStream_t stream);

// Plain C interface for ctypes.  dtype: 0 = float32 (SIMT kernels),
// 1 = bfloat16 (the tensor-core kernels when D is a multiple of
// SM90_D_STEP, else SIMT).
// Each tensor's strides are given as (batch, head, seq) element strides of
// its (B, heads, S, D) view; lse and delta are contiguous (B, H, Sq)
// float32.  Returns the cudaError_t of the launch (0 on success), or for
// the bf16 route an error of its tensor maps (flash_attention_sm90.cu).
constexpr int SM90_D_STEP = 16;  // the narrowest swizzle atom, in bf16 columns

extern "C" {

int flash_fwd(int dtype, const void* q, const void* k, const void* v, void* o, float* lse,
              const long long* strides /* q, k, v, o: 4 x 3 */, int B, int H, int KV, int Sq,
              int Sk, int D, int causal, float scale, void* stream) {
  const Strides qs{strides[0], strides[1], strides[2]}, ks{strides[3], strides[4], strides[5]},
      vs{strides[6], strides[7], strides[8]}, os{strides[9], strides[10], strides[11]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_fwd<float>(q, k, v, o, lse, qs, ks, vs, os, B, H, KV, Sq, Sk, D, causal, scale, st);
  if (dtype == 1 && D % SM90_D_STEP == 0)
    return flash_fwd_sm90(q, k, v, o, lse, strides, B, H, KV, Sq, Sk, D, causal, scale, st);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(q, k, v, o, lse, qs, ks, vs, os, B, H, KV, Sq, Sk, D, causal,
                                     scale, st);
  return (int)cudaErrorInvalidValue;
}

int flash_bwd_dq(int dtype, const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, void* dq,
                 const long long* strides /* q, k, v, dout, dq: 5 x 3 */, int B, int H, int KV,
                 int Sq, int Sk, int D, int causal, float scale, void* stream) {
  const Strides qs{strides[0], strides[1], strides[2]}, ks{strides[3], strides[4], strides[5]},
      vs{strides[6], strides[7], strides[8]}, dos{strides[9], strides[10], strides[11]},
      dqs{strides[12], strides[13], strides[14]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dq<float>(q, k, v, dout, lse, delta, dq, qs, ks, vs, dos, dqs, B, H, KV, Sq, Sk,
                            D, causal, scale, st);
  if (dtype == 1 && D % SM90_D_STEP == 0)
    return flash_bwd_dq_sm90(q, k, v, dout, lse, delta, dq, strides, B, H, KV, Sq, Sk, D, causal,
                             scale, st);
  if (dtype == 1)
    return launch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, qs, ks, vs, dos, dqs, B, H, KV,
                                    Sq, Sk, D, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

int flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v, const void* dout,
                  const float* lse, const float* delta, void* dk, void* dv,
                  const long long* strides /* q, k, v, dout, dk, dv: 6 x 3 */, int B, int H,
                  int KV, int Sq, int Sk, int D, int causal, float scale, void* stream) {
  const Strides qs{strides[0], strides[1], strides[2]}, ks{strides[3], strides[4], strides[5]},
      vs{strides[6], strides[7], strides[8]}, dos{strides[9], strides[10], strides[11]},
      dks{strides[12], strides[13], strides[14]}, dvs{strides[15], strides[16], strides[17]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, qs, ks, vs, dos, dks, dvs, B, H,
                             KV, Sq, Sk, D, causal, scale, st);
  if (dtype == 1 && D % SM90_D_STEP == 0)
    return flash_bwd_dkv_sm90(q, k, v, dout, lse, delta, dk, dv, strides, B, H, KV, Sq, Sk, D,
                              causal, scale, st);
  if (dtype == 1)
    return launch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, qs, ks, vs, dos, dks, dvs,
                                     B, H, KV, Sq, Sk, D, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
