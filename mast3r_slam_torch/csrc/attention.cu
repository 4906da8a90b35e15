// Exact attention softmax(q k^T * scale) v for the MASt3R encoder/decoder.
//
// Replaces mast3r_slam_tpu/ops/attention.py::_attn_kernel, a Pallas kernel
// that keeps one whole (batch*head) in VMEM and runs one grid step per head.
// A Hopper SM has at most 227 KB of shared memory and blocks run in
// parallel, so both kernels here are flash-style: one block per (batch*head,
// 64-row query tile) walks over tiles of K and V staged in shared memory,
// keeps an online softmax (running max and sum per row) in f32 and
// accumulates O in f32 registers.  The (Nq, Nk) score matrix never reaches
// device memory.
//
// Bound on this card: operations, 4*Nq*Nk*Dh per head (two matrix
// products); 2.42 GFLOP per encoder call at (1,16,768,64).
//
// bf16, the trunk's type (attn_fwd_bf16): both products run on the tensor
// cores as warpgroup matrix multiplies (wgmma).  A block is two warpgroups
// of 64 query rows each, which share every K and V tile: at these sizes
// the kernel is bound by the traffic from L2 into shared memory (each
// query tile of a head reads the head's whole K and V), so 128 rows a block
// halve what 64 would move.  Q (128 x 64, 16 KB) is loaded once; K and V
// arrive in tiles of 128 keys (16 KB each) through a three-stage ring of
// 16-byte cp.async copies, two tiles ahead of the one being computed.
// Every tile lies in shared memory in the 128-byte swizzled layout wgmma
// reads: a row is one token's Dh = 64 bf16 = 128 bytes, and 16-byte chunk c
// of row r is stored at chunk c ^ (r % 8).  S = Q K^T is four wgmma
// m64n128k16 (A = Q and B = K from shared memory, both with Dh
// contiguous); the 64 x 128 f32 scores stay in registers, where a row lives
// in the four threads of a quad, so the online softmax is two shuffles per
// row and exp2f with scale*log2(e) folded into one multiply-add.  P is
// rounded to bf16 in registers: the accumulator fragment of S is, 16 keys
// at a time, exactly the A fragment of m64k16, so P feeds the second
// product from registers.  V is its B operand with the keys as the
// product's inner dimension and Dh contiguous (the "MN-major" layout,
// transpose bit set): eight wgmma m64n64k16, each stepping 16 rows of the V
// tile.  O (64 x 64 f32) stays in registers and is rescaled per tile.
// Within a warpgroup the steps of a tile follow one another; the other
// warpgroup's softmax fills the gaps (running a tile's products under the
// same warpgroup's next softmax was tried: the assembler serializes wgmma
// groups as soon as ordinary code touches a register that any of them
// uses, and it came out slower).
//
// f32 (attn_fwd_f32; only small-model checks and tests use it): plain FMA on
// the CUDA cores, 32-key tiles, never TF32.
//
// Layout: q, o (B, H, Nq, Dh) and k, v (B, H, Nk, Dh) given by element
// strides for the batch, head and token dimensions; the last dimension is
// contiguous and (bf16) every row 16-byte aligned.  Ragged Nq and Nk are
// masked: keys past Nk are zero-filled and score -inf, rows past Nq are not
// stored.  C entry: attention_fwd (returns cudaGetLastError()).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Strides {  // in elements
  long long b, h, n;
};

// ---------------------------------------------------------------------------
// f32: FMA kernel
// ---------------------------------------------------------------------------

constexpr int BM = 64;   // query rows per block (both kernels)
constexpr int BN = 32;   // keys per shared-memory tile
constexpr int NT = 128;  // threads per block: 16 row groups x 8 col groups

template <int DH>
__global__ void __launch_bounds__(NT)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int H,
             int nq, int nk, Strides sq, Strides sk, Strides sv, Strides so,
             float scale) {
  static_assert(DH % 8 == 0, "Dh must be a multiple of 8");
  constexpr int CJ = DH / 8;  // output columns per thread
  // +1 padding keeps the row-strided reads of one warp on distinct banks
  __shared__ float qs[BM][DH + 1];
  __shared__ float ks[BN][DH + 1];
  __shared__ float vs[BN][DH];
  __shared__ float ps[BM][BN + 1];
  __shared__ float m_s[BM], l_s[BM], a_s[BM];

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BM;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  float* ob = o + b * so.b + h * so.h;
  const int tid = threadIdx.x;
  const int tx = tid % 8;  // owns columns tx + 8*j
  const int ty = tid / 8;  // owns rows ty*4 .. ty*4+3

  for (int i = tid; i < BM * DH; i += NT) {
    const int r = i / DH, c = i % DH;
    qs[r][c] = (q0 + r < nq) ? qb[(q0 + r) * sq.n + c] : 0.f;
  }
  if (tid < BM) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < nk; k0 += BN) {
    __syncthreads();  // the previous tile's ks/vs/ps are consumed
    for (int i = tid; i < BN * DH; i += NT) {
      const int r = i / DH, c = i % DH;
      const bool in = k0 + r < nk;
      ks[r][c] = in ? kb[(k0 + r) * sk.n + c] : 0.f;
      vs[r][c] = in ? vb[(k0 + r) * sv.n + c] : 0.f;
    }
    __syncthreads();

    // S tile = q k^T: 4 rows x 4 keys per thread
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[ty * 4 + i][d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[tx + 8 * j][d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 8 * j;
        ps[ty * 4 + i][c] = (k0 + c < nk) ? s[i][j] * scale : -INFINITY;
      }
    __syncthreads();

    // online softmax: two threads (adjacent lanes) per row, 16 keys each
    {
      const int r = tid / 2, c0 = (tid % 2) * (BN / 2);
      float mx = -INFINITY;
      for (int c = c0; c < c0 + BN / 2; ++c) mx = fmaxf(mx, ps[r][c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);  // finite: a tile has >= 1 key
      float sum = 0.f;
      for (int c = c0; c < c0 + BN / 2; ++c) {
        const float p = expf(ps[r][c] - m_new);
        ps[r][c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if (c0 == 0) {  // both lanes have read m_old before the shuffle
        const float alpha = expf(m_old - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // O = O * alpha + P v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = a_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] *= al;
    }
#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float pv[4], vv[CJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[ty * 4 + i][c];
#pragma unroll
      for (int j = 0; j < CJ; ++j) vv[j] = vs[c][tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r < nq) {
      const float l = l_s[r];
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        ob[(q0 + r) * so.n + tx + 8 * j] = acc[i][j] / l;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma kernel, Dh = 64
// ---------------------------------------------------------------------------

constexpr int TC_DH = 64;                  // one 128-byte swizzle row
constexpr int TC_BN = 128;                 // keys per tile
constexpr int TC_ROW = TC_DH * 2;          // bytes per token row
constexpr int TC_WG = 2;                   // warpgroups per block
constexpr int TC_NT = TC_WG * 128;         // threads per block
constexpr int TC_BM = TC_WG * BM;          // query rows per block
constexpr int TC_Q_BYTES = TC_BM * TC_ROW;   // 16 KB
constexpr int TC_KV_BYTES = TC_BN * TC_ROW;  // 16 KB
constexpr int TC_STAGES = 3;
// + 1 KB: the swizzle pattern repeats every 1024 bytes and the tiles must
// start on such a boundary, which dynamic shared memory does not promise
constexpr int TC_SMEM = TC_Q_BYTES + TC_STAGES * 2 * TC_KV_BYTES + 1024;

__device__ __forceinline__ uint32_t swz(int r, int c) {
  // byte offset of 16-byte chunk c of row r in a 128-byte swizzled tile
  return (uint32_t)(r * TC_ROW + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  // src_bytes = 0 writes 16 zero bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Rows [row0, row0 + ROWS) of a (n, 64) bf16 matrix with row stride
// `stride` into a swizzled tile, by the block's TC_NT threads; rows past n
// are zero-filled.
template <int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long stride, int row0, int n,
                                          int tid) {
#pragma unroll
  for (int i = 0; i < ROWS * 8 / TC_NT; ++i) {
    const int id = tid + i * TC_NT;
    const int r = id >> 3, c = id & 7;
    const bool in = row0 + r < n;
    const __nv_bfloat16* p = src + (in ? (row0 + r) * stride : 0) + c * 8;
    cp_async16(dst + swz(r, c), p, in ? 16 : 0);
  }
}

// Shared-memory matrix descriptor of a 128-byte swizzled tile whose rows are
// 128 bytes: groups of 8 rows are 1024 bytes apart (the stride offset); the
// leading offset is not used when the tile is one swizzle row wide.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// The compiler does not know that wgmma runs on after its instruction: it
// must not move a read of an accumulator above the wait, nor reuse the
// registers of an A fragment before it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

#define F8(d, i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128) = a (64 x 16, shared) b^T (128 x 16, shared) [+ d]
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                    uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24), F8(d, 32), F8(d, 40),
        F8(d, 48), F8(d, 56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64) += a (64 x 16, registers) b (16 x 64, shared, 64 contiguous)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef F8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&h);
}

__global__ void __launch_bounds__(TC_NT)
attn_fwd_bf16(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ o, int H, int nq, int nk,
              Strides sq, Strides sk, Strides sv, Strides so,
              float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t smem =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = smem + TC_Q_BYTES;  // stage s: K at 2s, V at 2s + 1

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * TC_BM;
  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;
  __nv_bfloat16* ob = o + b * so.b + h * so.h;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;                // this thread's warpgroup
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row and column pair
  const uint32_t q_s = smem + wg * BM * TC_ROW;  // the warpgroup's 64 rows
  const int ntiles = (nk + TC_BN - 1) / TC_BN;

  // one cp.async group per tile, also where there is no tile left to load,
  // so that "all but the newest group" always means "tile t has landed"
  load_tile<TC_BM>(smem, qb, sq.n, q0, nq, tid);
  load_tile<TC_BN>(kv_s, kb, sk.n, 0, nk, tid);
  load_tile<TC_BN>(kv_s + TC_KV_BYTES, vb, sv.n, 0, nk, tid);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (ntiles > 1) {
    load_tile<TC_BN>(kv_s + 2 * TC_KV_BYTES, kb, sk.n, TC_BN, nk, tid);
    load_tile<TC_BN>(kv_s + 3 * TC_KV_BYTES, vb, sv.n, TC_BN, nk, tid);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // thread rows: g and g + 8 of the warp's 16; partial row sums per thread
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float oacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) oacc[i] = 0.f;
  const uint64_t q_desc = smem_desc(q_s);

  for (int t = 0; t < ntiles; ++t) {
    // tile t has landed (tile t + 1 may still be on its way); make it
    // visible to the tensor cores' reads.  Past the barrier every warp has
    // finished tile t - 1, whose stage the load of tile t + 2 overwrites.
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (t + 2 < ntiles) {
      const uint32_t nxt = kv_s + ((t + 2) % TC_STAGES) * 2 * TC_KV_BYTES;
      load_tile<TC_BN>(nxt, kb, sk.n, (t + 2) * TC_BN, nk, tid);
      load_tile<TC_BN>(nxt + TC_KV_BYTES, vb, sv.n, (t + 2) * TC_BN, nk, tid);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const uint32_t k_s = kv_s + (t % TC_STAGES) * 2 * TC_KV_BYTES;
    const uint64_t k_desc = smem_desc(k_s);
    const uint64_t v_desc = smem_desc(k_s + TC_KV_BYTES);

    // S = Q K^T: 16 of Dh (32 bytes of every row) per instruction
    float s[64];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_DH / 16; ++kk)
      wgmma_m64n128k16_ss(s, q_desc + 2 * kk, k_desc + 2 * kk, kk > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    // s[4j + e]: row g + 8 * (e / 2), key 8j + 2 * t4 + (e % 2)
    const int k0 = t * TC_BN;
    if (k0 + TC_BN > nk) {
#pragma unroll
      for (int e = 0; e < 64; ++e)
        if (k0 + 8 * (e / 4) + 2 * t4 + (e & 1) >= nk) s[e] = -INFINITY;
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // finite: every tile holds at least one key
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f((m0 - mn0) * scale_log2);
    const float al1 = exp2f((m1 - mn1) * scale_log2);
    const float mb0 = mn0 * scale_log2, mb1 = mn1 * scale_log2;
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      s[4 * j] = exp2f(fmaf(s[4 * j], scale_log2, -mb0));
      s[4 * j + 1] = exp2f(fmaf(s[4 * j + 1], scale_log2, -mb0));
      s[4 * j + 2] = exp2f(fmaf(s[4 * j + 2], scale_log2, -mb1));
      s[4 * j + 3] = exp2f(fmaf(s[4 * j + 3], scale_log2, -mb1));
      sum0 += s[4 * j] + s[4 * j + 1];
      sum1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;

    // the S fragment of keys 16kk .. 16kk + 15 is the A fragment of m64k16:
    // {row g, k 2t4..}, {row g + 8, k 2t4..}, {row g, k 8 + 2t4..}, {g + 8}
    uint32_t p[TC_BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < TC_BN / 16; ++kk) {
      p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      oacc[4 * j] *= al0;
      oacc[4 * j + 1] *= al0;
      oacc[4 * j + 2] *= al1;
      oacc[4 * j + 3] *= al1;
    }

    // O += P V: 16 keys (16 rows of the V tile, 2048 bytes) per instruction
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_BN / 16; ++kk)
      wgmma_m64n64k16_rs(oacc, p[kk], v_desc + kk * (16 * TC_ROW >> 4));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(oacc);
    fence_regs(p);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;

  // O through the warpgroup's Q rows in shared memory (every warp is past
  // its last product), so that a row leaves as 128 contiguous bytes.  A
  // warp writes and reads only its own 16 rows.
  __syncthreads();
  const int r0 = warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t lo = pack_bf16(oacc[4 * j] * inv0, oacc[4 * j + 1] * inv0);
    const uint32_t hi =
        pack_bf16(oacc[4 * j + 2] * inv1, oacc[4 * j + 3] * inv1);
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(q_s + swz(r0, j) + t4 * 4),
                 "r"(lo)
                 : "memory");
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(q_s + swz(r1, j) + t4 * 4),
                 "r"(hi)
                 : "memory");
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int id = lane + 32 * i;
    const int r = warp * 16 + (id >> 3), c = id & 7;
    uint4 val;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(val.x), "=r"(val.y), "=r"(val.z), "=r"(val.w)
                 : "r"(q_s + swz(r, c))
                 : "memory");
    const int row = q0 + wg * BM + r;
    if (row < nq)
      *reinterpret_cast<uint4*>(ob + row * so.n + c * 8) = val;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Only Dh = 64 is instantiated.  strides:
// 12 element strides, (batch, head, token) of q, k, v, o.
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             void* o, int B, int H, int nq, int nk, int dh,
                             int dtype, const long long* strides, float scale,
                             void* stream) {
  if (dh != 64 || B <= 0 || H <= 0 || nq <= 0 || nk <= 0 ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid((nq + BM - 1) / BM, B * H);
    attn_fwd_f32<64><<<grid, NT, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), H, nq, nk,
        st[0], st[1], st[2], st[3], scale);
  } else if (dtype == 1) {
    // above 48 KB a kernel has to opt in to its dynamic shared memory
    static cudaError_t opt_in = cudaFuncSetAttribute(
        attn_fwd_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
    if (opt_in != cudaSuccess) return (int)opt_in;
    const dim3 grid((nq + TC_BM - 1) / TC_BM, B * H);
    attn_fwd_bf16<<<grid, TC_NT, TC_SMEM, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), H, nq, nk, st[0], st[1], st[2],
        st[3], scale * 1.4426950408889634f);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
