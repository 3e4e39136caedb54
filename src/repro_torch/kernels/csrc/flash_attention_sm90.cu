// Flash attention in bf16 for Hopper (sm_90a): the forward and both
// backward kernels on the tensor cores, fed by TMA through an mbarrier ring.
//
// Replaces, for bf16 inputs, the Pallas TPU kernels of
// repro/kernels/flash_attention.py:
//   fwd_kernel_sm90  <- _fwd_kernel      (flash_attention_fwd, pallas_call at :154)
//   dq_kernel_sm90   <- _bwd_dq_kernel   (flash_attention_bwd, pallas_call at :311)
//   dkv_kernel_sm90  <- _bwd_dkv_kernel  (flash_attention_bwd, pallas_call at :326)
// The C entry points in flash_attention.cu route bf16 here and f32 to the
// SIMT kernels there, by dtype and D.
//
// What bounds them on an H100, at the training shape (B 2, H 32, S 1024,
// D 80, causal): the forward moves 42 MB (12.6 us at 3.35 TB/s) for 10.7
// GFLOP of causal products (10.9 us at 989 TFLOP/s), so bytes bound it,
// barely; dq does 16.1 GFLOP (16.3 us) against 53 MB (15.8 us) and dk/dv
// 21.5 GFLOP (21.7 us) against 63 MB (18.9 us), so the tensor-core rate
// bounds both backward kernels.  Either way every product has to run on the
// tensor cores and every tile load has to overlap them.  At D = 80 a third
// resource nearly ties: each score costs 4 * 80 product FLOPs and one exp2,
// and the SM's 16 exp2 a clock take 80 % as long as its tensor cores take
// for those FLOPs, so the exponentials have to overlap the products too.
// The design:
//
//   * wgmma.mma_async m64nNk16 bf16 -> f32 for all products.  The scores
//     come from shared memory (both operands K-major); the second product of
//     each pair takes the probabilities (or dS) as the A operand straight
//     from the f32 accumulator registers, rounded to bf16, and the B operand
//     MN-major from the same shared tile (V, dO, Q or K).
//   * TMA (cp.async.bulk.tensor, 4-d tensor maps over (D, S, heads, batch)
//     built on the host from each tensor's strides) loads every tile; rows
//     past S read as zero, so ragged lengths are never padded in memory, and
//     the (B, S, H, D) views the model passes load without a copy.
//   * A producer warpgroup issues the loads into a ring of stages guarded by
//     full / empty mbarriers (transaction counts); consumer warpgroups of
//     64 rows each compute.  setmaxnreg moves registers from the producer
//     (24 a thread) to the consumers, so the accumulators and fragments fit
//     without spilling (at the launch allocation they spilled).
//   * Consumer warpgroups run unsynchronised (two in a dk/dv block, one in
//     each of the two forward or dq blocks an SM holds), so the softmax (or
//     the P and dS step) of one overlaps the products of another.  Software
//     pipelining inside a warpgroup and a fixed turn order between two
//     (FlashAttention-3's ping-pong) were tried and gained nothing at the
//     path's shape, so each loop stays one product pair at a time.
//   * D is cut into swizzle atoms, each a whole atom wide: 64 columns with
//     the 128-byte swizzle, then 32 with the 64-byte and 16 with the 32-byte
//     one (D = 80 is 64 + 16, D = 16 one 16-column atom).  Every wgmma
//     operand then lies inside one atom along its contiguous dimension, so
//     the K-major steps over D are 5 (not 8 on a zero-padded 128) and the
//     MN-major products over N = D are n64 + n16, with no column of padding.
//     So every D that is a multiple of 16 up to 128 is built here; the C
//     entry points route bf16 with any other D to the SIMT kernels.
//
// Forward: one block per (batch*head, 64-row q tile), the heaviest causal
// tiles first, two blocks an SM; the block walks 128-row kv tiles through 2
// stages.  Against 128-row blocks this streams K and V twice as often, but
// a block's start (barriers, the first loads) and end overlap the other
// block's work on the SM, and the finer tiles balance the causal load;
// at the path's shape that was the faster trade.  Online
// softmax on the accumulator in registers (log2 domain), masked only on
// tiles that cross the causal diagonal or the ragged end.
//
// dk/dv: one block per (batch*kv_head, 128-row kv tile).  K and V are loaded
// once and stay; the block walks the heads of its GQA group and the 64-row
// q tiles that see the kv tile, with Q, dO, lse and delta through 3 stages.
// dK and dV accumulate in f32 registers across the whole group: the group
// fold needs no atomics and the result is deterministic.
//
// dq: the forward's skeleton with one more product a tile and no online
// max, since lse is given.  One block per (batch*head, 64-row q tile), the
// heaviest causal tiles first, two blocks an SM; Q and dO are loaded once
// and stay, lse and delta of the thread's two rows stay in registers, and
// K and V stream through 3 stages of 64 kv rows, which keeps the S and dP
// accumulators at 32 floats each beside dQ's D/2.  At the path's shape this
// was a little faster than 128-row kv tiles, and than 128-row blocks whose
// two consumer warpgroups share each K/V stage (half the K/V traffic); a
// separate wgmma group for dP, so that P's exp2 overlaps it, gained nothing.
// Per tile: S = Q K^T and dP = dO V^T, then P and dS on the accumulators,
// then dQ += dS K with K read MN-major from the tile S used.  dQ is summed
// in f32 registers by one thread per element in kv order and written once:
// no atomics (FlashAttention-2/3 add dq from the dk/dv kernel with atomics,
// which makes the gradient depend on the run), so the result is
// deterministic.
//
// As in the SIMT kernels: the causal offset is decode-style, off = Sk - Sq
// (query i sees keys j <= i + off); a row that sees no key gets zero output,
// lse = -1e30 and zero gradient (every P of such a row is masked, not
// left to exp2 of a huge number).  Unlike the Pallas kernels (and the SIMT
// ones), P and dS are rounded to bf16 before the second products; the sums
// stay f32.  tests/test_torch_kernel_numerics.py pins that rounding against
// the reference on the CPU.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int WG = 128;  // threads of a warpgroup
// Registers a thread after the split (setmaxnreg): the producer warpgroup,
// which only issues loads, keeps 24 and hands the rest of its launch
// allocation to the consumer warpgroups.
constexpr int PRODUCER_REGS = 24;

// Registers a thread at launch under __launch_bounds__(threads, blocks):
// the SM's 65,536 over the threads it holds, rounded down to 8.  The split
// hands out exactly that, so a kernel that ptxas builds with fewer would
// wait forever in setmaxnreg.inc; build() in kernels/flash_attention.py
// holds the ptxas report to this number (flash_sm90_launch_regs).
constexpr int launch_regs(int threads, int blocks) { return 65536 / (threads * blocks) / 8 * 8; }
// A consumer thread's registers after the split: its launch allocation plus
// what the producer gives back, shared by `consumers` warpgroups.
constexpr int consumer_regs(int threads, int blocks, int consumers) {
  return (threads * launch_regs(threads, blocks) - WG * PRODUCER_REGS) / (consumers * WG) / 8 * 8;
}

// ------------------------------------------------- D cut into swizzle atoms

template <int D>
struct Cols {
  static_assert(D % 16 == 0 && D >= 16 && D <= 128, "D must be a multiple of 16 up to 128");
  static constexpr int N64 = D / 64;
  static constexpr int N = N64 + (D % 64 >= 32) + (D % 32 == 16);  // number of atoms
  // width (columns) and first column of atom c
  static __host__ __device__ constexpr int width(int c) {
    return c < N64 ? 64 : (c == N64 && D % 64 >= 32) ? 32 : 16;
  }
  static __host__ __device__ constexpr int col(int c) {
    return c < N64 ? 64 * c : c == N64 ? 64 * N64 : 64 * N64 + 32;
  }
  // byte offset of atom c's region in a tile of `rows` rows
  static __host__ __device__ constexpr int offset(int c, int rows) { return rows * col(c) * 2; }
};

// f(std::integral_constant<int, c>) for each atom c of D, unrolled
template <int D, int c = 0, typename F>
__device__ __forceinline__ void for_atoms(F&& f) {
  if constexpr (c < Cols<D>::N) {
    f(std::integral_constant<int, c>{});
    for_atoms<D, c + 1>(static_cast<F&&>(f));
  }
}

// ------------------------------------------------------------------ PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// TMA: box of `map` at coordinates (c0, c1, c2, c3) -> shared `dst`,
// completing `bytes` of the barrier's transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// setmaxnreg: every warp of the warpgroup executes it.
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keeps the compiler from moving reads of wgmma registers above the wait.
template <int N>
__device__ __forceinline__ void keep(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void keep(uint32_t (*a)[4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// wgmma shared-memory descriptor of a tile inside one swizzle atom of
// `width` bf16 columns (rows of 2*width bytes, 8-row groups 16*width bytes
// apart).  K-major: the leading offset is unused; MN-major: it strides
// atoms along MN, and every MN-major operand here is one atom wide.
__device__ __forceinline__ uint64_t desc(uint32_t addr, int width) {
  const uint64_t layout = width == 64 ? 1 : width == 32 ? 2 : 3;  // 128B, 64B, 32B swizzle
  const uint64_t sbo = 16u * width;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         ((sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ bool visible(int row, int col, int Sq, int Sk, int off, int causal) {
  return row < Sq && col < Sk && (!causal || col <= row + off);
}

// D (m64 x N, f32) += A (m64 x k16, bf16, shared) * B (k16 x N, bf16, shared),
// both K-major; acc = 0 overwrites D.
template <int N>
__device__ __forceinline__ void mma_ss(float* d, uint64_t a, uint64_t b, int acc);
// D (m64 x N, f32) += A (m64 x k16, bf16 registers) * B (k16 x N, shared, MN-major).
template <int N>
__device__ __forceinline__ void mma_rs(float* d, const uint32_t* a, uint64_t b);

template <>
__device__ __forceinline__ void mma_ss<64>(float* d, uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void mma_ss<128>(float* d, uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void mma_rs<16>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs<32>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void mma_rs<64>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// ---------------------------------------------------------------- forward

constexpr int FWD_BM = 64;          // q rows of a block: one consumer warpgroup
constexpr int FWD_BN = 128;         // kv rows of a stage
constexpr int FWD_STAGES = 2;
constexpr int FWD_THREADS = 2 * WG;  // the consumer warpgroup + the producer's
constexpr int FWD_BLOCKS = 2;        // blocks an SM
// 128 a thread at launch; the producer hands back 104 each, the consumer
// takes them: 232
constexpr int FWD_CONSUMER_REGS = consumer_regs(FWD_THREADS, FWD_BLOCKS, 1);
static_assert(FWD_CONSUMER_REGS <= 256, "setmaxnreg takes at most 256");

template <int D>
struct FwdParams {
  CUtensorMap q[Cols<D>::N], k[Cols<D>::N], v[Cols<D>::N];  // one map per atom
  __nv_bfloat16* o;
  float* lse;
  long long o_sb, o_sh, o_ss;  // element strides of out's (B, H, Sq, D) view
  int H, KV, Sq, Sk, causal;
  float scale;
};

template <int D>
constexpr size_t fwd_smem() {
  return size_t(FWD_BM + 2 * FWD_STAGES * FWD_BN) * D * 2 + 8 * (1 + 3 * FWD_STAGES) + 1024;
}

// One online-softmax step on the score accumulator s (rows r0 and r0 + 8,
// columns k0 + 8j + 2t + {0, 1}): rescales o, updates m and the thread's
// partial l, and leaves P as bf16 A fragments in pa.
template <bool MASK, int D>
__device__ __forceinline__ void softmax_step(float (&s)[FWD_BN / 2],
                                             uint32_t (&pa)[FWD_BN / 16][4],
                                             float (&o)[D / 2], float (&m)[2], float (&l)[2],
                                             float sl2, int r0, int k0, int t, int Sq, int Sk,
                                             int off, int causal) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < FWD_BN / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float x = s[4 * j + 2 * i + c] * sl2;
        if (MASK && !visible(r0 + 8 * i, k0 + 8 * j + 2 * t + c, Sq, Sk, off, causal))
          x = -INFINITY;
        s[4 * j + 2 * i + c] = x;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;  // a row that saw no key yet
    const float alpha = ex2(m[i] - m_use);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < FWD_BN / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = ex2(s[4 * j + 2 * i + c] - m_use);
        s[4 * j + 2 * i + c] = p;
        sum += p;
      }
    l[i] = l[i] * alpha + sum;
    m[i] = m_new;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j + 2 * i] *= alpha;
      o[4 * j + 2 * i + 1] *= alpha;
    }
  }
#pragma unroll
  for (int kk = 0; kk < FWD_BN / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

template <int D>
__global__ void __launch_bounds__(FWD_THREADS, FWD_BLOCKS) fwd_kernel_sm90(const __grid_constant__ FwdParams<D> p) {
  using C = Cols<D>;
  constexpr uint32_t TILE_Q = FWD_BM * D * 2, TILE_KV = FWD_BN * D * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;
  auto sK = [&](int st) { return base + TILE_Q + 2 * st * TILE_KV; };
  auto sV = [&](int st) { return base + TILE_Q + (2 * st + 1) * TILE_KV; };
  const uint32_t bars = base + TILE_Q + 2 * FWD_STAGES * TILE_KV;
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8 * (1 + st); };
  auto v_full = [&](int st) { return bars + 8 * (1 + FWD_STAGES + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + 2 * FWD_STAGES + st); };

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H, hk = h / (p.H / p.KV);
  const int n_qt = (p.Sq + FWD_BM - 1) / FWD_BM;
  const int q0 = (n_qt - 1 - blockIdx.y) * FWD_BM;  // the heaviest causal tiles start first
  const int off = p.Sk - p.Sq;
  int n_kt = (p.Sk + FWD_BN - 1) / FWD_BN;
  if (p.causal) {
    const int lim = min(q0 + FWD_BM, p.Sq) - 1 + off;  // last key the block's last row sees
    n_kt = lim < 0 ? 0 : min(n_kt, lim / FWD_BN + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < FWD_STAGES; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), WG / 32);  // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= WG) {  // ---- producer warpgroup: one thread issues the TMA loads
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == WG && n_kt > 0) {
      mbar_expect_tx(q_full, TILE_Q);
      for_atoms<D>([&](auto ci) {
        constexpr int c = decltype(ci)::value;
        tma_load(sQ + C::offset(c, FWD_BM), &p.q[c], q_full, C::col(c), q0, h, b);
      });
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % FWD_STAGES;
        mbar_wait(empty(st), ((kt / FWD_STAGES) & 1) ^ 1);
        mbar_expect_tx(k_full(st), TILE_KV);
        for_atoms<D>([&](auto ci) {
          constexpr int c = decltype(ci)::value;
          tma_load(sK(st) + C::offset(c, FWD_BN), &p.k[c], k_full(st), C::col(c), kt * FWD_BN,
                   hk, b);
        });
        mbar_expect_tx(v_full(st), TILE_KV);
        for_atoms<D>([&](auto ci) {
          constexpr int c = decltype(ci)::value;
          tma_load(sV(st) + C::offset(c, FWD_BN), &p.v[c], v_full(st), C::col(c), kt * FWD_BN,
                   hk, b);
        });
      }
    }
    return;
  }

  // ---- consumer warpgroup: the block's 64 q rows
  regs_inc<FWD_CONSUMER_REGS>();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int r0 = q0 + 16 * warp + lane / 4;  // this thread's rows: r0, r0 + 8
  const float sl2 = p.scale * LOG2E;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  if (n_kt > 0) mbar_wait(q_full, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % FWD_STAGES;
    const uint32_t ph = (kt / FWD_STAGES) & 1;
    const int k0 = kt * FWD_BN;

    // S = Q K^T over the atoms of D, 16 columns a step
    float s[FWD_BN / 2];
    mbar_wait(k_full(st), ph);
    wg_fence();
    for_atoms<D>([&](auto ci) {
      constexpr int c = decltype(ci)::value, W = C::width(c);
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk) {
        const uint64_t da = desc(sQ + C::offset(c, FWD_BM) + 32 * kk, W);
        const uint64_t db = desc(sK(st) + C::offset(c, FWD_BN) + 32 * kk, W);
        mma_ss<FWD_BN>(s, da, db, c > 0 || kk > 0);
      }
    });
    wg_commit();
    wg_wait0();
    keep<FWD_BN / 2>(s);

    uint32_t pa[FWD_BN / 16][4];
    const bool mask = k0 + FWD_BN > p.Sk || (p.causal && k0 + FWD_BN - 1 > q0 + off);
    if (mask)
      softmax_step<true, D>(s, pa, o, m, l, sl2, r0, k0, t, p.Sq, p.Sk, off, p.causal);
    else
      softmax_step<false, D>(s, pa, o, m, l, sl2, r0, k0, t, p.Sq, p.Sk, off, p.causal);

    // O += P V: P from registers, V MN-major, one wgmma group per atom
    mbar_wait(v_full(st), ph);
    wg_fence();
    for_atoms<D>([&](auto ci) {
      constexpr int c = decltype(ci)::value, W = C::width(c);
#pragma unroll
      for (int kk = 0; kk < FWD_BN / 16; ++kk)
        mma_rs<W>(o + C::col(c) / 2, pa[kk],
                  desc(sV(st) + C::offset(c, FWD_BN) + kk * 16 * 2 * W, W));
    });
    wg_commit();
    wg_wait0();
    keep<D / 2>(o);
    keep<FWD_BN / 16>(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }

  // epilogue: out in q's dtype and strides, lse in f32
  __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = r0 + 8 * i;
    if (row >= p.Sq) continue;
    const float inv = lt > 0.f ? 1.f / lt : 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const __nv_bfloat162 v2 =
          __floats2bfloat162_rn(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(ob + row * p.o_ss + 8 * j + 2 * t) = v2;
    }
    if (t == 0) p.lse[(long long)bh * p.Sq + row] = lt > 0.f ? (m[i] + log2f(lt)) * LN2 : NEG_INF;
  }
}

// ------------------------------------------------------------ backward dk/dv

constexpr int DKV_BN = 128;  // kv rows of a block (64 per consumer warpgroup)
constexpr int DKV_BM = 64;   // q rows of a stage
constexpr int DKV_STAGES = 3;
constexpr int DKV_THREADS = 3 * WG;     // two consumer warpgroups + the producer's
constexpr int DKV_BLOCKS = 1;          // blocks an SM
// 168 a thread at launch; the producer hands back 144 each, the two
// consumers take 72 more each: 240
constexpr int DKV_CONSUMER_REGS = consumer_regs(DKV_THREADS, DKV_BLOCKS, 2);
static_assert(DKV_CONSUMER_REGS <= 256, "setmaxnreg takes at most 256");

template <int D>
struct DkvParams {
  CUtensorMap q[Cols<D>::N], k[Cols<D>::N], v[Cols<D>::N], dout[Cols<D>::N];
  const float* lse;
  const float* delta;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  long long dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
  int H, KV, Sq, Sk, causal;
  float scale;
};

template <int D>
__host__ __device__ constexpr uint32_t dkv_stage_bytes() {  // Q and dO tiles, lse and delta, 1024-aligned
  return (2 * DKV_BM * D * 2 + 2 * DKV_BM * 4 + 1023) / 1024 * 1024;
}
template <int D>
constexpr size_t dkv_smem() {
  return size_t(2 * DKV_BN * D * 2) + DKV_STAGES * dkv_stage_bytes<D>() + 8 * (1 + 2 * DKV_STAGES) +
         1024;
}

// P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - delta) scale on the
// accumulators (rows: kv r0, r0 + 8; columns: q q0 + 8j + 2t + {0, 1}),
// left as bf16 A fragments in pa and da.
template <bool MASK>
__device__ __forceinline__ void dkv_step(float (&st)[DKV_BM / 2], float (&dpt)[DKV_BM / 2],
                                         uint32_t (&pa)[DKV_BM / 16][4],
                                         uint32_t (&da)[DKV_BM / 16][4], const float* lse2,
                                         const float* delta, float sl2, float scale, int r0,
                                         int q0, int t, int Sq, int Sk, int off, int causal) {
#pragma unroll
  for (int j = 0; j < DKV_BM / 8; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = 8 * j + 2 * t + c;
      const float lq = lse2[col], dl = delta[col];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = 4 * j + 2 * i + c;
        float pv = ex2(st[idx] * sl2 - lq);
        if (MASK && !visible(q0 + col, r0 + 8 * i, Sq, Sk, off, causal)) pv = 0.f;
        dpt[idx] = pv * (dpt[idx] - dl) * scale;
        st[idx] = pv;
      }
    }
#pragma unroll
  for (int kk = 0; kk < DKV_BM / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      pa[kk][r] = pack_bf16(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
      da[kk][r] = pack_bf16(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
    }
}

template <int D>
__global__ void __launch_bounds__(DKV_THREADS, DKV_BLOCKS) dkv_kernel_sm90(const __grid_constant__ DkvParams<D> p) {
  using C = Cols<D>;
  constexpr uint32_t TILE_KV = DKV_BN * D * 2, TILE_Q = DKV_BM * D * 2;
  constexpr uint32_t STAGE = dkv_stage_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));  // generic view of `base`
  const uint32_t sK = base, sV = base + TILE_KV;
  auto sQ = [&](int st) { return base + 2 * TILE_KV + st * STAGE; };
  auto sDO = [&](int st) { return sQ(st) + TILE_Q; };
  auto stats = [&](int st) {  // lse * log2(e), then delta: DKV_BM floats each
    return reinterpret_cast<float*>(gbase + 2 * TILE_KV + st * STAGE + 2 * TILE_Q);
  };
  const uint32_t bars = base + 2 * TILE_KV + DKV_STAGES * STAGE;
  const uint32_t kv_full = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + DKV_STAGES + st); };

  const int bk = blockIdx.x;
  const int b = bk / p.KV, hk = bk % p.KV, group = p.H / p.KV;
  const int k0 = blockIdx.y * DKV_BN;  // low kv tiles see the most q tiles: they start first
  const int off = p.Sk - p.Sq;
  const int first_row = p.causal ? max(0, k0 - off) : 0;  // first q row that sees key k0
  const int qt0 = first_row / DKV_BM;
  const int n_qt = max(0, (p.Sq + DKV_BM - 1) / DKV_BM - qt0);  // q tiles per head
  const int n_items = group * n_qt;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < DKV_STAGES; ++st) {
      mbar_init(full(st), 32);  // the producer lanes; lane 0's arrival also expects the bytes
      mbar_init(empty(st), 2 * WG / 32);  // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 2 * WG) {  // ---- producer warpgroup: its first warp loads
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x >= 2 * WG + 32) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * TILE_KV);
      for_atoms<D>([&](auto ci) {
        constexpr int c = decltype(ci)::value;
        tma_load(sK + C::offset(c, DKV_BN), &p.k[c], kv_full, C::col(c), k0, hk, b);
        tma_load(sV + C::offset(c, DKV_BN), &p.v[c], kv_full, C::col(c), k0, hk, b);
      });
    }
    for (int it = 0; it < n_items; ++it) {
      const int st = it % DKV_STAGES;
      const int h = hk * group + it / n_qt, q0 = (qt0 + it % n_qt) * DKV_BM;
      mbar_wait(empty(st), ((it / DKV_STAGES) & 1) ^ 1);
      float* stat = stats(st);
      const long long srow = ((long long)b * p.H + h) * p.Sq;
      for (int i = lane; i < DKV_BM; i += 32) {
        const int row = q0 + i;
        stat[i] = row < p.Sq ? p.lse[srow + row] * LOG2E : 0.f;
        stat[DKV_BM + i] = row < p.Sq ? p.delta[srow + row] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(full(st), 2 * TILE_Q);
        for_atoms<D>([&](auto ci) {
          constexpr int c = decltype(ci)::value;
          tma_load(sQ(st) + C::offset(c, DKV_BM), &p.q[c], full(st), C::col(c), q0, h, b);
          tma_load(sDO(st) + C::offset(c, DKV_BM), &p.dout[c], full(st), C::col(c), q0, h, b);
        });
      } else {
        mbar_arrive(full(st));
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 kv rows each
  regs_inc<DKV_CONSUMER_REGS>();
  const int wg = threadIdx.x / WG;
  const int warp = (threadIdx.x % WG) / 32, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int kw0 = k0 + 64 * wg;                 // first kv row of the warpgroup
  const int r0 = kw0 + 16 * warp + lane / 4;    // this thread's kv rows: r0, r0 + 8
  const float sl2 = p.scale * LOG2E;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_items; ++it) {
    const int st = it % DKV_STAGES;
    const int q0 = (qt0 + it % n_qt) * DKV_BM;
    mbar_wait(full(st), (it / DKV_STAGES) & 1);

    // S^T = K Q^T and dP^T = V dO^T over the atoms of D
    float s[DKV_BM / 2], dp[DKV_BM / 2];
    wg_fence();
    for_atoms<D>([&](auto ci) {
      constexpr int c = decltype(ci)::value, W = C::width(c);
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk) {
        const uint32_t a_off = C::offset(c, DKV_BN) + 64 * wg * 2 * W + 32 * kk;
        const uint32_t b_off = C::offset(c, DKV_BM) + 32 * kk;
        mma_ss<DKV_BM>(s, desc(sK + a_off, W), desc(sQ(st) + b_off, W), c > 0 || kk > 0);
        mma_ss<DKV_BM>(dp, desc(sV + a_off, W), desc(sDO(st) + b_off, W), c > 0 || kk > 0);
      }
    });
    wg_commit();
    wg_wait0();
    keep<DKV_BM / 2>(s);
    keep<DKV_BM / 2>(dp);

    uint32_t pa[DKV_BM / 16][4], da[DKV_BM / 16][4];
    const float* stat = stats(st);
    const bool mask = q0 + DKV_BM > p.Sq || kw0 + 64 > p.Sk ||
                      (p.causal && kw0 + 63 > q0 + off);
    if (mask)
      dkv_step<true>(s, dp, pa, da, stat, stat + DKV_BM, sl2, p.scale, r0, q0, t, p.Sq, p.Sk,
                     off, p.causal);
    else
      dkv_step<false>(s, dp, pa, da, stat, stat + DKV_BM, sl2, p.scale, r0, q0, t, p.Sq, p.Sk,
                      off, p.causal);

    // dV += P^T dO and dK += dS^T Q: A from registers, dO and Q MN-major
    wg_fence();
    for_atoms<D>([&](auto ci) {
      constexpr int c = decltype(ci)::value, W = C::width(c);
#pragma unroll
      for (int kk = 0; kk < DKV_BM / 16; ++kk) {
        const uint32_t b_off = C::offset(c, DKV_BM) + kk * 16 * 2 * W;
        mma_rs<W>(dv + C::col(c) / 2, pa[kk], desc(sDO(st) + b_off, W));
        mma_rs<W>(dk + C::col(c) / 2, da[kk], desc(sQ(st) + b_off, W));
      }
    });
    wg_commit();
    wg_wait0();
    keep<D / 2>(dk);
    keep<D / 2>(dv);
    keep<DKV_BM / 16>(pa);
    keep<DKV_BM / 16>(da);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }

  // epilogue: dk, dv in k's dtype and strides
  __nv_bfloat16* dkb = p.dk + b * p.dk_sb + hk * p.dk_sh;
  __nv_bfloat16* dvb = p.dv + b * p.dv_sb + hk * p.dv_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= p.Sk) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(dkb + row * p.dk_ss + col) =
          __floats2bfloat162_rn(dk[4 * j + 2 * i], dk[4 * j + 2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvb + row * p.dv_ss + col) =
          __floats2bfloat162_rn(dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
    }
  }
}

// -------------------------------------------------------------- backward dq

constexpr int DQ_BM = 64;           // q rows of a block: one consumer warpgroup
constexpr int DQ_BN = 64;           // kv rows of a stage
constexpr int DQ_STAGES = 3;
constexpr int DQ_THREADS = 2 * WG;  // the consumer warpgroup + the producer's
constexpr int DQ_BLOCKS = 2;        // blocks an SM
// 128 a thread at launch, 232 for the consumer after the split
constexpr int DQ_CONSUMER_REGS = consumer_regs(DQ_THREADS, DQ_BLOCKS, 1);
static_assert(DQ_CONSUMER_REGS <= 256, "setmaxnreg takes at most 256");

template <int D>
struct DqParams {
  CUtensorMap q[Cols<D>::N], k[Cols<D>::N], v[Cols<D>::N], dout[Cols<D>::N];
  const float* lse;
  const float* delta;
  __nv_bfloat16* dq;
  long long dq_sb, dq_sh, dq_ss;  // element strides of dq's (B, H, Sq, D) view
  int H, KV, Sq, Sk, causal;
  float scale;
};

template <int D>
constexpr size_t dq_smem() {
  return size_t(2 * DQ_BM + 2 * DQ_STAGES * DQ_BN) * D * 2 + 8 * (1 + 2 * DQ_STAGES) + 1024;
}

// P = exp(S scale - lse) and dS = P (dP - delta) scale on the accumulators
// (rows: q r0, r0 + 8; columns: kv k0 + 8j + 2t + {0, 1}), left as bf16 A
// fragments in da.  lse2 is lse * log2(e) of the thread's two rows.
template <bool MASK>
__device__ __forceinline__ void dq_step(float (&s)[DQ_BN / 2], float (&dp)[DQ_BN / 2],
                                        uint32_t (&da)[DQ_BN / 16][4], const float (&lse2)[2],
                                        const float (&delta)[2], float sl2, float scale, int r0,
                                        int k0, int t, int Sq, int Sk, int off, int causal) {
#pragma unroll
  for (int j = 0; j < DQ_BN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int idx = 4 * j + 2 * i + c;
        float pv = ex2(s[idx] * sl2 - lse2[i]);
        if (MASK && !visible(r0 + 8 * i, k0 + 8 * j + 2 * t + c, Sq, Sk, off, causal)) pv = 0.f;
        dp[idx] = pv * (dp[idx] - delta[i]) * scale;
      }
#pragma unroll
  for (int kk = 0; kk < DQ_BN / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) da[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
}

template <int D>
__global__ void __launch_bounds__(DQ_THREADS, DQ_BLOCKS) dq_kernel_sm90(const __grid_constant__ DqParams<D> p) {
  using C = Cols<D>;
  constexpr uint32_t TILE_Q = DQ_BM * D * 2, TILE_KV = DQ_BN * D * 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sDO = base + TILE_Q;
  auto sK = [&](int st) { return base + 2 * TILE_Q + 2 * st * TILE_KV; };
  auto sV = [&](int st) { return base + 2 * TILE_Q + (2 * st + 1) * TILE_KV; };
  const uint32_t bars = base + 2 * TILE_Q + 2 * DQ_STAGES * TILE_KV;
  const uint32_t q_full = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + DQ_STAGES + st); };

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H, hk = h / (p.H / p.KV);
  const int n_qt = (p.Sq + DQ_BM - 1) / DQ_BM;
  const int q0 = (n_qt - 1 - blockIdx.y) * DQ_BM;  // the heaviest causal tiles start first
  const int off = p.Sk - p.Sq;
  int n_kt = (p.Sk + DQ_BN - 1) / DQ_BN;
  if (p.causal) {
    const int lim = min(q0 + DQ_BM, p.Sq) - 1 + off;  // last key the block's last row sees
    n_kt = lim < 0 ? 0 : min(n_kt, lim / DQ_BN + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < DQ_STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), WG / 32);  // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= WG) {  // ---- producer warpgroup: one thread starts the TMA loads
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == WG && n_kt > 0) {
      mbar_expect_tx(q_full, 2 * TILE_Q);
      for_atoms<D>([&](auto ci) {
        constexpr int c = decltype(ci)::value;
        tma_load(sQ + C::offset(c, DQ_BM), &p.q[c], q_full, C::col(c), q0, h, b);
        tma_load(sDO + C::offset(c, DQ_BM), &p.dout[c], q_full, C::col(c), q0, h, b);
      });
      for (int kt = 0; kt < n_kt; ++kt) {
        const int st = kt % DQ_STAGES;
        mbar_wait(empty(st), ((kt / DQ_STAGES) & 1) ^ 1);
        mbar_expect_tx(full(st), 2 * TILE_KV);
        for_atoms<D>([&](auto ci) {
          constexpr int c = decltype(ci)::value;
          tma_load(sK(st) + C::offset(c, DQ_BN), &p.k[c], full(st), C::col(c), kt * DQ_BN, hk, b);
          tma_load(sV(st) + C::offset(c, DQ_BN), &p.v[c], full(st), C::col(c), kt * DQ_BN, hk, b);
        });
      }
    }
    return;
  }

  // ---- consumer warpgroup: the block's 64 q rows
  regs_inc<DQ_CONSUMER_REGS>();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int r0 = q0 + 16 * warp + lane / 4;  // this thread's q rows: r0, r0 + 8
  const float sl2 = p.scale * LOG2E;
  float lse2[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    lse2[i] = row < p.Sq ? p.lse[(long long)bh * p.Sq + row] * LOG2E : 0.f;
    delta[i] = row < p.Sq ? p.delta[(long long)bh * p.Sq + row] : 0.f;
  }

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  if (n_kt > 0) mbar_wait(q_full, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % DQ_STAGES;
    const int k0 = kt * DQ_BN;
    mbar_wait(full(st), (kt / DQ_STAGES) & 1);

    // S = Q K^T and dP = dO V^T over the atoms of D
    float s[DQ_BN / 2], dp[DQ_BN / 2];
    wg_fence();
    for_atoms<D>([&](auto ci) {
      constexpr int c = decltype(ci)::value, W = C::width(c);
#pragma unroll
      for (int kk = 0; kk < W / 16; ++kk) {
        const uint32_t a_off = C::offset(c, DQ_BM) + 32 * kk;
        const uint32_t b_off = C::offset(c, DQ_BN) + 32 * kk;
        mma_ss<DQ_BN>(s, desc(sQ + a_off, W), desc(sK(st) + b_off, W), c > 0 || kk > 0);
        mma_ss<DQ_BN>(dp, desc(sDO + a_off, W), desc(sV(st) + b_off, W), c > 0 || kk > 0);
      }
    });
    wg_commit();
    wg_wait0();
    keep<DQ_BN / 2>(s);
    keep<DQ_BN / 2>(dp);

    uint32_t da[DQ_BN / 16][4];
    const bool mask = k0 + DQ_BN > p.Sk || (p.causal && k0 + DQ_BN - 1 > q0 + off);
    if (mask)
      dq_step<true>(s, dp, da, lse2, delta, sl2, p.scale, r0, k0, t, p.Sq, p.Sk, off, p.causal);
    else
      dq_step<false>(s, dp, da, lse2, delta, sl2, p.scale, r0, k0, t, p.Sq, p.Sk, off, p.causal);

    // dQ += dS K: dS from registers, K MN-major from the tile S used, one
    // wgmma group per atom
    wg_fence();
    for_atoms<D>([&](auto ci) {
      constexpr int c = decltype(ci)::value, W = C::width(c);
#pragma unroll
      for (int kk = 0; kk < DQ_BN / 16; ++kk)
        mma_rs<W>(dq + C::col(c) / 2, da[kk],
                  desc(sK(st) + C::offset(c, DQ_BN) + kk * 16 * 2 * W, W));
    });
    wg_commit();
    wg_wait0();
    keep<D / 2>(dq);
    keep<DQ_BN / 16>(da);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
  }

  // epilogue: dq in q's dtype and strides
  __nv_bfloat16* dqb = p.dq + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dqb + row * p.dq_ss + 8 * j + 2 * t) =
          __floats2bfloat162_rn(dq[4 * j + 2 * i], dq[4 * j + 2 * i + 1]);
  }
}

// ------------------------------------------------------------ host side

// cuTensorMapEncodeTiled, taken from the driver through the runtime's
// cudaGetDriverEntryPoint, so the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

constexpr int ERR_NO_ENCODER = 900;  // the driver has no cuTensorMapEncodeTiled
constexpr int ERR_ENCODE = 1000;     // + the CUresult of a map that could not be encoded

// The tensor map of atom c of a bf16 (B, heads, S, D) view with element
// strides st = (batch, head, seq): a 4-d map over (D, S, heads, B) whose box
// is (width of c, rows, 1, 1).  Rows past S read as zero.
template <int D>
int encode(CUtensorMap* map, const void* base, const long long* st, int S, int heads, int B,
           int c, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return ERR_NO_ENCODER;
  const int w = Cols<D>::width(c);
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(S), cuuint64_t(heads), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(st[2]) * 2, cuuint64_t(st[1]) * 2,
                                 cuuint64_t(st[0]) * 2};
  const cuuint32_t box[4] = {cuuint32_t(w), cuuint32_t(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = w == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : w == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + int(r);
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
               const long long* s, int B, int H, int KV, int Sq, int Sk, int causal, float scale,
               cudaStream_t stream) {
  FwdParams<D> p;
  for (int c = 0; c < Cols<D>::N; ++c) {
    int err = encode<D>(&p.q[c], q, s + 0, Sq, H, B, c, FWD_BM);
    if (!err) err = encode<D>(&p.k[c], k, s + 3, Sk, KV, B, c, FWD_BN);
    if (!err) err = encode<D>(&p.v[c], v, s + 6, Sk, KV, B, c, FWD_BN);
    if (err) return err;
  }
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = lse;
  p.o_sb = s[9], p.o_sh = s[10], p.o_ss = s[11];
  p.H = H, p.KV = KV, p.Sq = Sq, p.Sk = Sk, p.causal = causal, p.scale = scale;
  const size_t smem = fwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(fwd_kernel_sm90<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(B * H, (Sq + FWD_BM - 1) / FWD_BM);
  fwd_kernel_sm90<D><<<grid, FWD_THREADS, smem, stream>>>(p);
  return int(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, const long long* s, int B, int H, int KV,
               int Sq, int Sk, int causal, float scale, cudaStream_t stream) {
  DkvParams<D> p;
  for (int c = 0; c < Cols<D>::N; ++c) {
    int err = encode<D>(&p.q[c], q, s + 0, Sq, H, B, c, DKV_BM);
    if (!err) err = encode<D>(&p.k[c], k, s + 3, Sk, KV, B, c, DKV_BN);
    if (!err) err = encode<D>(&p.v[c], v, s + 6, Sk, KV, B, c, DKV_BN);
    if (!err) err = encode<D>(&p.dout[c], dout, s + 9, Sq, H, B, c, DKV_BM);
    if (err) return err;
  }
  p.lse = lse, p.delta = delta;
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.dk_sb = s[12], p.dk_sh = s[13], p.dk_ss = s[14];
  p.dv_sb = s[15], p.dv_sh = s[16], p.dv_ss = s[17];
  p.H = H, p.KV = KV, p.Sq = Sq, p.Sk = Sk, p.causal = causal, p.scale = scale;
  const size_t smem = dkv_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(dkv_kernel_sm90<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(B * KV, (Sk + DKV_BN - 1) / DKV_BN);
  dkv_kernel_sm90<D><<<grid, DKV_THREADS, smem, stream>>>(p);
  return int(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq, const long long* s, int B, int H, int KV, int Sq,
              int Sk, int causal, float scale, cudaStream_t stream) {
  DqParams<D> p;
  for (int c = 0; c < Cols<D>::N; ++c) {
    int err = encode<D>(&p.q[c], q, s + 0, Sq, H, B, c, DQ_BM);
    if (!err) err = encode<D>(&p.k[c], k, s + 3, Sk, KV, B, c, DQ_BN);
    if (!err) err = encode<D>(&p.v[c], v, s + 6, Sk, KV, B, c, DQ_BN);
    if (!err) err = encode<D>(&p.dout[c], dout, s + 9, Sq, H, B, c, DQ_BM);
    if (err) return err;
  }
  p.lse = lse, p.delta = delta;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dq_sb = s[12], p.dq_sh = s[13], p.dq_ss = s[14];
  p.H = H, p.KV = KV, p.Sq = Sq, p.Sk = Sk, p.causal = causal, p.scale = scale;
  const size_t smem = dq_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(dq_kernel_sm90<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(B * H, (Sq + DQ_BM - 1) / DQ_BM);
  dq_kernel_sm90<D><<<grid, DQ_THREADS, smem, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

// Called by flash_fwd / flash_bwd_dq / flash_bwd_dkv (flash_attention.cu) for bf16 inputs
// whose D is a multiple of 16.  Strides as there: (batch, head, seq)
// element strides per tensor.  The wrapper has checked the 16-byte
// alignment TMA needs.  Returns the cudaError_t of the launch, or
// ERR_NO_ENCODER / ERR_ENCODE + CUresult when a tensor map cannot be made.
#define SM90_HEAD_DIMS(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)

int flash_fwd_sm90(const void* q, const void* k, const void* v, void* o, float* lse,
                   const long long* strides, int B, int H, int KV, int Sq, int Sk, int D,
                   int causal, float scale, cudaStream_t stream) {
#define FWD_CASE(d) \
  case d: return launch_fwd<d>(q, k, v, o, lse, strides, B, H, KV, Sq, Sk, causal, scale, stream);
  switch (D) {
    SM90_HEAD_DIMS(FWD_CASE)
    default: return int(cudaErrorInvalidValue);
  }
#undef FWD_CASE
}

int flash_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, const long long* strides,
                      int B, int H, int KV, int Sq, int Sk, int D, int causal, float scale,
                      cudaStream_t stream) {
#define DQ_CASE(d)                                                                             \
  case d:                                                                                      \
    return launch_dq<d>(q, k, v, dout, lse, delta, dq, strides, B, H, KV, Sq, Sk, causal, scale, \
                        stream);
  switch (D) {
    SM90_HEAD_DIMS(DQ_CASE)
    default: return int(cudaErrorInvalidValue);
  }
#undef DQ_CASE
}

int flash_bwd_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv,
                       const long long* strides, int B, int H, int KV, int Sq, int Sk, int D,
                       int causal, float scale, cudaStream_t stream) {
#define DKV_CASE(d)                                                                          \
  case d:                                                                                    \
    return launch_dkv<d>(q, k, v, dout, lse, delta, dk, dv, strides, B, H, KV, Sq, Sk, causal, \
                         scale, stream);
  switch (D) {
    SM90_HEAD_DIMS(DKV_CASE)
    default: return int(cudaErrorInvalidValue);
  }
#undef DKV_CASE
}

// The registers a thread that kernel 0 (fwd_kernel_sm90), 1 (dkv_kernel_sm90)
// or 2 (dq_kernel_sm90) is launched with, which its setmaxnreg split
// assumes; -1 for another index.
extern "C" int flash_sm90_launch_regs(int kernel) {
  return kernel == 0 ? launch_regs(FWD_THREADS, FWD_BLOCKS)
         : kernel == 1 ? launch_regs(DKV_THREADS, DKV_BLOCKS)
         : kernel == 2 ? launch_regs(DQ_THREADS, DQ_BLOCKS)
                       : -1;
}
