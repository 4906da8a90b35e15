// One Gauss-Newton iteration's normal equations of the ray+distance Sim(3)
// tracker solve under the joint ray Huber weight.
//
// Replaces mast3r_slam_tpu/ops/gn_pallas.py::_gn_kernel, a Pallas kernel
// whose sequential TPU grid writes (G, 32, 128) lane-vector partials that
// the wrapper folds.  Here the blocks run in parallel in no order, so the
// reduction is two stages with no float atomics and a fixed order, which
// makes the result bitwise deterministic:
//   stage 1: G blocks, grid-stride over the n points in plain SoA; each
//            thread transforms its points, forms the ray and distance
//            residuals and Huber weights and accumulates the 27 sums; the
//            block reduces them (warp shuffles, then warps in order) into
//            one row of a (G, 27) f32 scratch;
//   stage 2: one block folds the G rows in order (in double) into 27 floats.
// Sums: 0..5 H_tt (xx xy xz yy yz zz), 6..8 s (the -skew(r)/d block),
// 9..14 H_ww, 15..17 H_ts, 18 H_ss, 19..25 g, 26 2*cost.
//
// Bound on this card: bytes, 9 * 4 B per point read once (7.1 MB at
// n = 196,608, ~2.1 us at 3.35 TB/s); at this size the two launches'
// latency dominates.  The 13 pose scalars [R00..R22, t, s] are read from
// device memory, so a launch needs no host sync.
// C entry: gn_accumulate (returns cudaGetLastError()).

#include <cuda_runtime.h>

namespace {

constexpr int NACC = 27;
constexpr int THREADS = 256;

__device__ __forceinline__ float huber_w(float r, float k) {
  const float ra = fabsf(r);
  return ra < k ? 1.f : k / fmaxf(ra, 1e-12f);
}

__global__ void __launch_bounds__(THREADS)
gn_stage1(const float* __restrict__ pts, int n, const float* __restrict__ scal,
          float huber_k, float* __restrict__ partial) {
  const float R00 = scal[0], R01 = scal[1], R02 = scal[2];
  const float R10 = scal[3], R11 = scal[4], R12 = scal[5];
  const float R20 = scal[6], R21 = scal[7], R22 = scal[8];
  const float tx = scal[9], ty = scal[10], tz = scal[11], sc = scal[12];
  const size_t N = (size_t)n;
  const float* xf = pts;
  const float* yf = pts + N;
  const float* zf = pts + 2 * N;
  const float* rkx = pts + 3 * N;
  const float* rky = pts + 4 * N;
  const float* rkz = pts + 5 * N;
  const float* rkd = pts + 6 * N;
  const float* wray = pts + 7 * N;
  const float* wdist = pts + 8 * N;

  float acc[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = 0.f;

  for (int i = blockIdx.x * THREADS + threadIdx.x; i < n;
       i += gridDim.x * THREADS) {
    const float x = xf[i], y = yf[i], z = zf[i];
    const float px = sc * (R00 * x + R01 * y + R02 * z) + tx;
    const float py = sc * (R10 * x + R11 * y + R12 * z) + ty;
    const float pz = sc * (R20 * x + R21 * y + R22 * z) + tz;
    const float d2 = px * px + py * py + pz * pz;
    const float d = sqrtf(fmaxf(d2, 1e-24f));
    const float dinv = 1.f / d;
    const float rx = px * dinv, ry = py * dinv, rz = pz * dinv;
    const float ex = rkx[i] - rx, ey = rky[i] - ry, ez = rkz[i] - rz;
    const float ed = rkd[i] - d;
    const float w_ray = wray[i], w_dist = wdist[i];
    const float e2 = ex * ex + ey * ey + ez * ez;
    const float w_r = huber_w(w_ray * sqrtf(e2), huber_k) * w_ray * w_ray;
    const float w_d = huber_w(w_dist * ed, huber_k) * w_dist * w_dist;
    const float qxx = rx * rx, qyy = ry * ry, qzz = rz * rz;
    const float qxy = rx * ry, qxz = rx * rz, qyz = ry * rz;
    const float wrd2 = w_r * (dinv * dinv);
    const float wrd = w_r * dinv;
    const float rTe = rx * ex + ry * ey + rz * ez;
    acc[0] += wrd2 * (1.f - qxx) + w_d * qxx;
    acc[1] += (w_d - wrd2) * qxy;
    acc[2] += (w_d - wrd2) * qxz;
    acc[3] += wrd2 * (1.f - qyy) + w_d * qyy;
    acc[4] += (w_d - wrd2) * qyz;
    acc[5] += wrd2 * (1.f - qzz) + w_d * qzz;
    acc[6] += wrd * rx;
    acc[7] += wrd * ry;
    acc[8] += wrd * rz;
    acc[9] += w_r * (1.f - qxx);
    acc[10] += -w_r * qxy;
    acc[11] += -w_r * qxz;
    acc[12] += w_r * (1.f - qyy);
    acc[13] += -w_r * qyz;
    acc[14] += w_r * (1.f - qzz);
    acc[15] += w_d * px;
    acc[16] += w_d * py;
    acc[17] += w_d * pz;
    acc[18] += w_d * d2;
    acc[19] += w_r * (ex - rx * rTe) * dinv + w_d * ed * rx;
    acc[20] += w_r * (ey - ry * rTe) * dinv + w_d * ed * ry;
    acc[21] += w_r * (ez - rz * rTe) * dinv + w_d * ed * rz;
    acc[22] += w_r * (ry * ez - rz * ey);
    acc[23] += w_r * (rz * ex - rx * ez);
    acc[24] += w_r * (rx * ey - ry * ex);
    acc[25] += w_d * ed * d;
    acc[26] += w_r * e2 + w_d * ed * ed;
  }

  __shared__ float red[THREADS / 32][NACC];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < NACC; ++j) {
    float v = acc[j];
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][j] = v;
  }
  __syncthreads();
  if (threadIdx.x < NACC) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) s += red[w][threadIdx.x];
    partial[(size_t)blockIdx.x * NACC + threadIdx.x] = s;
  }
}

__global__ void gn_stage2(const float* __restrict__ partial, int G,
                          float* __restrict__ out) {
  const int t = threadIdx.x;
  if (t < NACC) {
    double s = 0.0;
    for (int g = 0; g < G; ++g) s += (double)partial[(size_t)g * NACC + t];
    out[t] = (float)s;
  }
}

}  // namespace

// pts: (9, n) f32 rows [xf, yf, zf, rkx, rky, rkz, rkd, w_ray, w_dist];
// scal: 13 f32; partial: (G, 27) f32 scratch; out: 27 f32.
extern "C" int gn_accumulate(const float* pts, int n, const float* scal,
                             float huber_k, float* partial, int G, float* out,
                             void* stream) {
  if (n <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gn_stage1<<<G, THREADS, 0, s>>>(pts, n, scal, huber_k, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_stage2<<<1, 32, 0, s>>>(partial, G, out);
  return (int)cudaGetLastError();
}
