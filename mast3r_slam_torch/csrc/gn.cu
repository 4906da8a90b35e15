// The ray+distance Sim(3) tracker solve under the joint ray Huber weight:
// one Gauss-Newton iteration's normal equations (gn_accumulate) and the
// whole solve in one launch (gn_solve).
//
// Replaces mast3r_slam_tpu/ops/gn_pallas.py::_gn_kernel, a Pallas kernel
// whose sequential TPU grid writes (G, 32, 128) lane-vector partials that
// the wrapper folds, and the device while_loop around it
// (mast3r_slam_tpu/tracker.py, body_pallas).  Here the blocks run in
// parallel in no order, so a reduction is two stages with no float atomics
// and a fixed order, which makes every result bitwise deterministic:
//   stage 1: G blocks, grid-stride over the n points in plain SoA; each
//            thread transforms its points, forms the ray and distance
//            residuals and Huber weights and accumulates the 27 sums
//            (accumulate_point); the block reduces them (warp shuffles,
//            then warps in order) into one row of a (G, 27) f32 scratch;
//   stage 2: the G rows are folded in a fixed order in double.
// Sums: 0..5 H_tt (xx xy xz yy yz zz), 6..8 s (the -skew(r)/d block),
// 9..14 H_ww, 15..17 H_ts, 18 H_ss, 19..25 g, 26 2*cost.
//
// gn_accumulate is the two stages as two launches, for one pose read from
// device memory.  Bound: bytes, 9 * 4 B per point read once (7.1 MB at
// n = 196,608, ~2.1 us at 3.35 TB/s); at this size the launches' latency
// dominates.
//
// gn_solve runs every iteration of one solve in a single cooperative
// launch, because what the loop cost was never the sums but what stood
// around them: per iteration two launches, a blocking copy and some three
// hundred small host operations for the 7x7 solve, the retraction and the
// convergence test.  Every block is resident.  A thread loads its first
// KEEP points once and holds them in registers for all iterations (a
// grid-stride remainder is re-read from L2, where the 7 MB stay).  Per
// iteration: stage 1 into row blockIdx.x of one half of a (2, G, 27)
// scratch, one grid barrier, then EVERY block folds the G rows in the same
// order, and its thread 0 assembles H and g, solves the 7x7 system by the
// Jacobi-prescaled LDL^T, retracts the pose on the left and tests
// convergence, in f32 without fused multiply-adds (the steps of the host
// loop that is its plain version), and hands the new pose and the stop flag
// to the block through shared memory.  All blocks compute the same bits from
// the same rows, so they agree on the stop flag without a second barrier.
// One iteration costs a sweep over registers plus one grid barrier; the
// bytes bound of the whole solve is the points read once.
// C entries: gn_accumulate, gn_solve (each returns cudaGetLastError()).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NACC = 27;
constexpr int THREADS = 256;
constexpr int KEEP = 3;        // points a gn_solve thread holds in registers
constexpr int FOLD_PARTS = 8;  // interleaved partial folds, one per warp

struct Pose {  // X -> sc * R X + t
  float R00, R01, R02, R10, R11, R12, R20, R21, R22, tx, ty, tz, sc;
};

__device__ __forceinline__ float huber_w(float r, float k) {
  const float ra = fabsf(r);
  return ra < k ? 1.f : k / fmaxf(ra, 1e-12f);
}

// One point's terms of the 27 sums at pose P: the arithmetic of both entries.
__device__ __forceinline__ void accumulate_point(
    const Pose& P, float x, float y, float z, float rkx, float rky, float rkz,
    float rkd, float w_ray, float w_dist, float huber_k, float (&acc)[NACC]) {
  const float px = P.sc * (P.R00 * x + P.R01 * y + P.R02 * z) + P.tx;
  const float py = P.sc * (P.R10 * x + P.R11 * y + P.R12 * z) + P.ty;
  const float pz = P.sc * (P.R20 * x + P.R21 * y + P.R22 * z) + P.tz;
  const float d2 = px * px + py * py + pz * pz;
  const float d = sqrtf(fmaxf(d2, 1e-24f));
  const float dinv = 1.f / d;
  const float rx = px * dinv, ry = py * dinv, rz = pz * dinv;
  const float ex = rkx - rx, ey = rky - ry, ez = rkz - rz;
  const float ed = rkd - d;
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

// The block's 27 sums (warp shuffles, then the warps in order) into out[27].
__device__ __forceinline__ void block_reduce(const float (&acc)[NACC],
                                             float (&red)[THREADS / 32][NACC],
                                             float* out) {
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
    out[threadIdx.x] = s;
  }
}

__global__ void __launch_bounds__(THREADS)
gn_stage1(const float* __restrict__ pts, int n, const float* __restrict__ scal,
          float huber_k, float* __restrict__ partial) {
  const Pose P = {scal[0], scal[1], scal[2],  scal[3],  scal[4],  scal[5], scal[6],
                  scal[7], scal[8], scal[9], scal[10], scal[11], scal[12]};
  const size_t N = (size_t)n;
  float acc[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = 0.f;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < n;
       i += gridDim.x * THREADS)
    accumulate_point(P, pts[i], pts[N + i], pts[2 * N + i], pts[3 * N + i],
                     pts[4 * N + i], pts[5 * N + i], pts[6 * N + i],
                     pts[7 * N + i], pts[8 * N + i], huber_k, acc);
  __shared__ float red[THREADS / 32][NACC];
  block_reduce(acc, red, partial + (size_t)blockIdx.x * NACC);
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

// ---------------------------------------------------------------------------
// The 7x7 solve, the retraction and the convergence test of gn_solve, in f32
// with every product and sum rounded on its own (no fused multiply-add), in
// the order of their PyTorch versions (ops/robust.py, ops/lie_sim3.py).
// ---------------------------------------------------------------------------

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float safe_sqrt(float x) {
  return __fsqrt_rn(fmaxf(x, 1e-24f));
}

// [R | t | s] from the embedding T = [t(3), q(xyzw), s] (quat_rot_entries)
__device__ Pose pose_of(const float* T) {
  const float x = T[3], y = T[4], z = T[5], w = T[6];
  const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
  const float xy = mul(x, y), xz = mul(x, z), yz = mul(y, z);
  const float wx = mul(w, x), wy = mul(w, y), wz = mul(w, z);
  Pose P;
  P.R00 = sub(1.f, mul(2.f, add(yy, zz)));
  P.R01 = mul(2.f, sub(xy, wz));
  P.R02 = mul(2.f, add(xz, wy));
  P.R10 = mul(2.f, add(xy, wz));
  P.R11 = sub(1.f, mul(2.f, add(xx, zz)));
  P.R12 = mul(2.f, sub(yz, wx));
  P.R20 = mul(2.f, sub(xz, wy));
  P.R21 = mul(2.f, add(yz, wx));
  P.R22 = sub(1.f, mul(2.f, add(xx, yy)));
  P.tx = T[0];
  P.ty = T[1];
  P.tz = T[2];
  P.sc = T[7];
  return P;
}

// H (7x7, layout [t(3), w(3), s]) and g from the 27 sums (ops/gn.py _H_IDX)
__device__ void assemble(const float* a, float (&H)[7][7], float (&g)[7]) {
#pragma unroll
  for (int i = 0; i < 7; ++i)
#pragma unroll
    for (int j = 0; j < 7; ++j) H[i][j] = 0.f;
  H[0][0] = a[0]; H[0][1] = a[1]; H[0][2] = a[2];
  H[1][0] = a[1]; H[1][1] = a[3]; H[1][2] = a[4];
  H[2][0] = a[2]; H[2][1] = a[4]; H[2][2] = a[5];
  H[0][4] = a[8];  H[0][5] = -a[7];
  H[1][3] = -a[8]; H[1][5] = a[6];
  H[2][3] = a[7];  H[2][4] = -a[6];
  H[3][1] = -a[8]; H[3][2] = a[7];
  H[4][0] = a[8];  H[4][2] = -a[6];
  H[5][0] = -a[7]; H[5][1] = a[6];
  H[3][3] = a[9];  H[3][4] = a[10]; H[3][5] = a[11];
  H[4][3] = a[10]; H[4][4] = a[12]; H[4][5] = a[13];
  H[5][3] = a[11]; H[5][4] = a[13]; H[5][5] = a[14];
  H[0][6] = a[15]; H[1][6] = a[16]; H[2][6] = a[17];
  H[6][0] = a[15]; H[6][1] = a[16]; H[6][2] = a[17];
  H[6][6] = a[18];
#pragma unroll
  for (int i = 0; i < 7; ++i) g[i] = a[19 + i];
}

// Jacobi-prescaled LDL^T solve of H x = g (solve_spd_small).  Returns false
// when a pivot is non-positive or non-finite.
__device__ bool solve_spd7(float (&H)[7][7], float (&g)[7], float (&x)[7]) {
  float ds[7], L[7][7], d[7], dinv[7], z[7];
#pragma unroll
  for (int i = 0; i < 7; ++i)
    ds[i] = dvd(1.f, __fsqrt_rn(fmaxf(H[i][i], 1e-30f)));
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    g[i] = mul(g[i], ds[i]);
#pragma unroll
    for (int j = 0; j < 7; ++j) H[i][j] = mul(mul(H[i][j], ds[i]), ds[j]);
  }
  bool ok = true;
#pragma unroll
  for (int j = 0; j < 7; ++j) {
    float dj = H[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) dj = sub(dj, mul(mul(L[j][k], L[j][k]), d[k]));
    ok = ok && (dj > 0.f) && isfinite(dj);
    d[j] = dj;
    dinv[j] = dvd(1.f, dj > 0.f ? dj : 1.f);
#pragma unroll
    for (int i = j + 1; i < 7; ++i) {
      float s = H[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s = sub(s, mul(mul(L[i][k], L[j][k]), d[k]));
      L[i][j] = mul(s, dinv[j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    float s = g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = sub(s, mul(L[i][k], z[k]));
    z[i] = s;
  }
#pragma unroll
  for (int i = 6; i >= 0; --i) {
    float xi = mul(z[i], dinv[i]);
#pragma unroll
    for (int k = i + 1; k < 7; ++k) xi = sub(xi, mul(L[k][i], x[k]));
    x[i] = xi;
  }
#pragma unroll
  for (int i = 0; i < 7; ++i) x[i] = mul(x[i], ds[i]);
  return ok;
}

__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* c) {
  c[0] = sub(mul(a[1], b[2]), mul(a[2], b[1]));
  c[1] = sub(mul(a[2], b[0]), mul(a[0], b[2]));
  c[2] = sub(mul(a[0], b[1]), mul(a[1], b[0]));
}

// Sim(3) exponential of xi = [tau, phi, sigma] (lie_sim3.exp, with
// exp_so3_quat and _sim3_W_coeffs): E = [t(3), q(xyzw), s]
__device__ void sim3_exp(const float* xi, float* E) {
  const float EPS = 1e-6f;
  const float* tau = xi;
  const float* phi = xi + 3;
  const float sigma = xi[6];
  const float scale = expf(sigma);
  const float theta_sq =
      add(add(mul(phi[0], phi[0]), mul(phi[1], phi[1])), mul(phi[2], phi[2]));
  const float theta = safe_sqrt(theta_sq);
  {  // exp_so3_quat
    const float p4 = mul(theta_sq, theta_sq);
    const bool small = theta_sq < EPS;
    const float imag =
        small ? add(sub(0.5f, mul((float)(1.0 / 48.0), theta_sq)),
                    mul((float)(1.0 / 3840.0), p4))
              : dvd(sinf(mul(0.5f, theta)), theta);
    const float real =
        small ? add(sub(1.f, mul((float)(1.0 / 8.0), theta_sq)),
                    mul((float)(1.0 / 384.0), p4))
              : cosf(mul(0.5f, theta));
    E[3] = mul(imag, phi[0]);
    E[4] = mul(imag, phi[1]);
    E[5] = mul(imag, phi[2]);
    E[6] = real;
  }
  // W = C I + A Phi + B Phi^2
  const bool small_theta = theta_sq < (float)(1e-6 * 1e-6);
  const bool small_sigma = fabsf(sigma) < EPS;
  const float th2 = small_theta ? 1.f : theta_sq;
  const float th = small_theta ? 1.f : theta;
  const float sg = small_sigma ? 1.f : sigma;
  const float sg2 = mul(sg, sg);
  const float sn = sinf(theta), cs = cosf(theta);
  const float A1 = small_theta ? 0.5f : dvd(sub(1.f, cs), th2);
  const float B1 =
      small_theta ? dvd(1.f, 6.f) : dvd(sub(theta, sn), mul(th2, th));
  const float C2 = dvd(sub(scale, 1.f), sg);
  const float A2a = dvd(add(mul(sub(sg, 1.f), scale), 1.f), sg2);
  const float B2a = dvd(
      sub(sub(add(mul(mul(scale, 0.5f), sg2), scale), 1.f), mul(sg, scale)),
      mul(sg2, sg));
  const float a = mul(scale, sn), b = mul(scale, cs);
  const float c = add(theta_sq, mul(sigma, sigma));
  const float c_safe = c == 0.f ? 1.f : c;
  const float A2b =
      dvd(add(mul(a, sg), mul(sub(1.f, b), th)), mul(th, c_safe));
  const float B2b =
      dvd(sub(C2, dvd(add(mul(sub(b, 1.f), sg), mul(a, th)), c_safe)), th2);
  const float A = small_sigma ? A1 : (small_theta ? A2a : A2b);
  const float B = small_sigma ? B1 : (small_theta ? B2a : B2b);
  const float C = small_sigma ? 1.f : C2;
  float pt[3], ppt[3];
  cross3(phi, tau, pt);
  cross3(phi, pt, ppt);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    E[i] = add(add(mul(C, tau[i]), mul(A, pt[i])), mul(B, ppt[i]));
  E[7] = scale;
}

// T <- normalize(exp(xi) o T) (lie_sim3.retr: mul, quat_act, quat_mul,
// normalize)
__device__ void sim3_retr(float* T, const float* xi) {
  float E[8];
  sim3_exp(xi, E);
  const float* qv = E + 3;
  const float qw = E[6];
  float c1[3], uv[3], c2[3], out[8];
  cross3(qv, T, c1);
#pragma unroll
  for (int i = 0; i < 3; ++i) uv[i] = mul(2.f, c1[i]);
  cross3(qv, uv, c2);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[i] = add(mul(E[7], add(add(T[i], mul(qw, uv[i])), c2[i])), E[i]);
  const float xi_ = E[3], yi = E[4], zi = E[5], wi = E[6];
  const float xj = T[3], yj = T[4], zj = T[5], wj = T[6];
  const float q0 = sub(add(add(mul(wi, xj), mul(xi_, wj)), mul(yi, zj)),
                       mul(zi, yj));
  const float q1 = add(add(sub(mul(wi, yj), mul(xi_, zj)), mul(yi, wj)),
                       mul(zi, xj));
  const float q2 = add(sub(add(mul(wi, zj), mul(xi_, yj)), mul(yi, xj)),
                       mul(zi, wj));
  const float q3 = sub(sub(sub(mul(wi, wj), mul(xi_, xj)), mul(yi, yj)),
                       mul(zi, zj));
  const float nrm = __fsqrt_rn(
      add(add(add(mul(q0, q0), mul(q1, q1)), mul(q2, q2)), mul(q3, q3)));
  const float den = fmaxf(nrm, 1e-12f);
  out[3] = dvd(q0, den);
  out[4] = dvd(q1, den);
  out[5] = dvd(q2, den);
  out[6] = dvd(q3, den);
  out[7] = mul(E[7], T[7]);
#pragma unroll
  for (int i = 0; i < 8; ++i) T[i] = out[i];
}

// Relative cost decrease or update norm below its threshold
// (check_convergence)
__device__ bool converged(float rel_thr, float delta_thr, float old_cost,
                          float new_cost, const float* delta) {
  const bool fin = isfinite(old_cost);
  const float old_safe = (fin && old_cost != 0.f) ? old_cost : 1.f;
  const float rel_dec = fabsf(dvd(sub(old_cost, new_cost), old_safe));
  float n2 = 0.f;
#pragma unroll
  for (int i = 0; i < 7; ++i) n2 = add(n2, mul(delta[i], delta[i]));
  return (fin && rel_dec < rel_thr) || (__fsqrt_rn(n2) < delta_thr);
}

// out: [T(8), ok, iterations run, last cost]
__global__ void __launch_bounds__(THREADS, 2)
gn_solve_kernel(const float* __restrict__ pts, int n,
                const float* __restrict__ T_init, float huber_k,
                float rel_error, float delta_norm, int max_iters,
                float* scratch, float* __restrict__ out) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float red[THREADS / 32][NACC];
  __shared__ double parts[FOLD_PARTS][NACC];
  __shared__ float sums[NACC];
  __shared__ float T_s[8];
  __shared__ Pose P_s;
  __shared__ int stop_s;

  const int tid = threadIdx.x;
  const int G = gridDim.x;
  const int gtid = blockIdx.x * THREADS + tid;
  const int stride = G * THREADS;
  const size_t N = (size_t)n;

  float held[KEEP][9];
#pragma unroll
  for (int k = 0; k < KEEP; ++k) {
    const int i = gtid + k * stride;
#pragma unroll
    for (int c = 0; c < 9; ++c) held[k][c] = i < n ? pts[c * N + i] : 0.f;
  }
  // loop state of thread 0 (every block's thread 0 holds the same values)
  float old_cost = INFINITY, cost = 0.f;
  bool ok = true;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) T_s[i] = T_init[i];
    P_s = pose_of(T_s);
  }
  __syncthreads();

  int it = 0;
  while (it < max_iters) {
    const Pose P = P_s;
    float acc[NACC];
#pragma unroll
    for (int j = 0; j < NACC; ++j) acc[j] = 0.f;
#pragma unroll
    for (int k = 0; k < KEEP; ++k)
      if (gtid + k * stride < n)
        accumulate_point(P, held[k][0], held[k][1], held[k][2], held[k][3],
                         held[k][4], held[k][5], held[k][6], held[k][7],
                         held[k][8], huber_k, acc);
    for (int i = gtid + KEEP * stride; i < n; i += stride)
      accumulate_point(P, pts[i], pts[N + i], pts[2 * N + i], pts[3 * N + i],
                       pts[4 * N + i], pts[5 * N + i], pts[6 * N + i],
                       pts[7 * N + i], pts[8 * N + i], huber_k, acc);
    // The halves of the scratch alternate: a block that is past the barrier
    // of iteration i writes its row of iteration i + 1 into the other half
    // while slower blocks still fold iteration i, and it cannot reach
    // iteration i + 2 (this half again) before they have arrived at the
    // barrier of i + 1, their fold done.
    float* rows = scratch + (size_t)(it & 1) * G * NACC;
    block_reduce(acc, red, rows + (size_t)blockIdx.x * NACC);
    grid.sync();

    // every block folds all G rows in the same fixed order, in double: warp
    // w takes rows w, w + 8, ...; then the eight partial folds in order.
    // The rows were written by other SMs: read them past L1.
    {
      const int part = tid / 32, j = tid % 32;
      if (j < NACC) {
        double s = 0.0;
        for (int g = part; g < G; g += FOLD_PARTS)
          s += (double)__ldcg(rows + (size_t)g * NACC + j);
        parts[part][j] = s;
      }
    }
    __syncthreads();
    if (tid < NACC) {
      double s = 0.0;
#pragma unroll
      for (int w = 0; w < FOLD_PARTS; ++w) s += parts[w][tid];
      sums[tid] = (float)s;
    }
    __syncthreads();

    // the rules of the host loop: a failed solve leaves T, clears ok and
    // stops; the stop flag derives from the folded sums alone, so every
    // block takes the same branch
    if (tid == 0) {
      float H[7][7], g[7], tau[7];
      assemble(sums, H, g);
      cost = mul(0.5f, sums[26]);
      bool solve_ok = solve_spd7(H, g, tau);
#pragma unroll
      for (int i = 0; i < 7; ++i) solve_ok = solve_ok && isfinite(tau[i]);
      if (!solve_ok) {
#pragma unroll
        for (int i = 0; i < 7; ++i) tau[i] = 0.f;
      }
      const bool conv = converged(rel_error, delta_norm, old_cost, cost, tau);
      if (solve_ok) {
        sim3_retr(T_s, tau);
        P_s = pose_of(T_s);
      }
      old_cost = cost;
      ok = ok && solve_ok;
      stop_s = (conv || !solve_ok) ? 1 : 0;
    }
    __syncthreads();
    ++it;
    if (stop_s) break;
  }

  if (blockIdx.x == 0 && tid == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = T_s[i];
    out[8] = ok ? 1.f : 0.f;
    out[9] = (float)it;
    out[10] = cost;
  }
}

}  // namespace

// pts: (9, n) f32 rows [xf, yf, zf, rkx, rky, rkz, rkd, w_ray, w_dist];
// scal: 13 f32 [R00..R22, t, s]; partial: (G, 27) f32 scratch; out: 27 f32.
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

// The whole solve from T_init (8 f32 on the device).  scratch: room for
// (2, scratch_rows, 27) f32; out: 11 f32 [T(8), ok, iterations run, last
// cost].  The grid is every block the card `device` (the one that holds the
// buffers and runs `stream`, current at the call) can hold at once, at most
// one thread per point and at most scratch_rows blocks: a cooperative launch
// with a larger grid is refused, not clamped.
extern "C" int gn_solve(const float* pts, int n, const float* T_init,
                        float huber_k, float rel_error, float delta_norm,
                        int max_iters, float* scratch, int scratch_rows,
                        float* out, int device, void* stream) {
  if (n <= 0 || scratch_rows <= 0) return (int)cudaErrorInvalidValue;
  int dev = -1, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev != device) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gn_solve_kernel, THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  if (!coop || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  int G = per_sm * sms;
  if (G > (n + THREADS - 1) / THREADS) G = (n + THREADS - 1) / THREADS;
  if (G > scratch_rows) G = scratch_rows;
  void* args[] = {&pts,       &n,         &T_init,  &huber_k, &rel_error,
                  &delta_norm, &max_iters, &scratch, &out};
  err = cudaLaunchCooperativeKernel((void*)gn_solve_kernel, dim3(G),
                                    dim3(THREADS), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
