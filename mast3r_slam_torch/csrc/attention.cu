// Exact attention softmax(q k^T * scale) v for the MASt3R encoder/decoder.
//
// Replaces mast3r_slam_tpu/ops/attention.py::_attn_kernel, a Pallas kernel
// that keeps one whole (batch*head) in VMEM and runs one grid step per head.
// A Hopper SM has at most 227 KB of shared memory and blocks run in
// parallel, so this is a flash-style kernel instead: one block per
// (batch*head, 64-row query tile) loops over 32-key tiles of K and V staged
// in shared memory, keeps an online softmax (running max and sum per row) in
// f32, and accumulates O in f32 registers.  The (Nq, Nk) score matrix never
// reaches device memory.
//
// Bound on this card: operations, 4*Nq*Nk*Dh per head (two matrix
// products); 2.42 GFLOP per encoder call at (1,16,768,64).  This first
// version uses plain FMA on the CUDA cores (f32 math for bf16 and f32
// inputs alike), so it runs against the 67 TFLOP/s f32 peak, not the
// tensor cores; a wgmma/TMA version is later work.
//
// Layout: q (BH, Nq, Dh), k and v (BH, Nk, Dh), o (BH, Nq, Dh), contiguous,
// all of one type T (float or bf16); output in T.  Ragged Nq and Nk are
// masked.  C entry: attention_fwd (returns cudaGetLastError()).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;   // query rows per block
constexpr int BN = 32;   // keys per shared-memory tile
constexpr int NT = 128;  // threads per block: 16 row groups x 8 col groups

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
attn_fwd(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, T* __restrict__ o, int nq, int nk,
         float scale) {
  static_assert(DH % 8 == 0, "Dh must be a multiple of 8");
  constexpr int CJ = DH / 8;  // output columns per thread
  // +1 padding keeps the row-strided reads of one warp on distinct banks
  __shared__ float qs[BM][DH + 1];
  __shared__ float ks[BN][DH + 1];
  __shared__ float vs[BN][DH];
  __shared__ float ps[BM][BN + 1];
  __shared__ float m_s[BM], l_s[BM], a_s[BM];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const T* qb = q + (size_t)bh * nq * DH;
  const T* kb = k + (size_t)bh * nk * DH;
  const T* vb = v + (size_t)bh * nk * DH;
  T* ob = o + (size_t)bh * nq * DH;
  const int tid = threadIdx.x;
  const int tx = tid % 8;  // owns columns tx + 8*j
  const int ty = tid / 8;  // owns rows ty*4 .. ty*4+3

  for (int i = tid; i < BM * DH; i += NT) {
    const int r = i / DH, c = i % DH;
    qs[r][c] = (q0 + r < nq) ? to_f(qb[(size_t)(q0 + r) * DH + c]) : 0.f;
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
      ks[r][c] = in ? to_f(kb[(size_t)(k0 + r) * DH + c]) : 0.f;
      vs[r][c] = in ? to_f(vb[(size_t)(k0 + r) * DH + c]) : 0.f;
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
        ob[(size_t)(q0 + r) * DH + tx + 8 * j] = from_f<T>(acc[i][j] / l);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Only Dh = 64 is instantiated.
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             void* o, int bh, int nq, int nk, int dh,
                             int dtype, float scale, void* stream) {
  if (dh != 64 || bh <= 0 || nq <= 0 || nk <= 0 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((nq + BM - 1) / BM, bh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    attn_fwd<float, 64><<<grid, NT, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), nq, nk, scale);
  } else if (dtype == 1) {
    attn_fwd<__nv_bfloat16, 64><<<grid, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), nq, nk, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
