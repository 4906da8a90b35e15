// Probe-table pack for the dense matcher.
//
// Replaces the Pallas kernel `_mxu_pack_kernel` of
// mast3r_slam_tpu/ops/pack.py (pack_rows_mxu).  For a table `flat`
// (b, hw, F) and K signed row offsets it writes
//
//     out[b, r, k*F + c] = flat[b, r + row0 + offsets[k], c]
//
// where that source row lies in [0, hw), and 0 elsewhere: row r of the packed
// table holds the K rows around r + row0 side by side, so the matcher fetches
// a whole probe window with one row gather.
//
// Bound on the card: bytes.  The work is a copy: hw*F*itemsize bytes read
// once (the K overlapping windows re-read lines that are still in L2) and
// n_rows*K*F*itemsize bytes written; no arithmetic beyond the index.
//
// Design: the table is handled as bytes.  One thread moves one unit of U
// bytes, U the largest of 16, 8, 4, 2, 1 that divides the row width
// F*itemsize and the alignment of both pointers.  Every source row and every
// destination block then starts on a multiple of U, so a unit never straddles
// two blocks and the same kernel serves int8, f16, bf16 and f32 bit for bit.
// Consecutive threads write consecutive units (coalesced stores); the loads
// are contiguous within a block of F*itemsize bytes.  All indices are signed
// 64-bit: the largest production table is 118 MB and offsets and row0 are
// negative.  The batch is gridDim.y, rows and units are a grid-stride loop.
// Placement matmuls, overlapping block views and the hw % tile restriction
// of the TPU kernel answer that machine's lane tiling and have no counterpart
// here.

#include <cuda_runtime.h>
#include <stdint.h>

#define PACK_MAX_K 64
#define PACK_THREADS 256
#define PACK_MAX_BLOCKS 4224   // 132 SMs x 32

struct PackOffsets {
    long long v[PACK_MAX_K];
};

template <typename V>
__global__ void pack_rows_kernel(const V* __restrict__ in, V* __restrict__ out,
                                 long long hw, long long n_rows,
                                 long long row0, int K, int upb,
                                 PackOffsets offs) {
    __shared__ long long s_off[PACK_MAX_K];
    if (threadIdx.x < K) s_off[threadIdx.x] = offs.v[threadIdx.x];
    __syncthreads();

    const long long upr = (long long)K * upb;          // units per output row
    const long long total = n_rows * upr;              // units per batch item
    const V* inb = in + (long long)blockIdx.y * hw * upb;
    V* outb = out + (long long)blockIdx.y * total;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += stride) {
        const long long r = i / upr;
        const int j = (int)(i - r * upr);
        const int k = j / upb;
        const int c = j - k * upb;
        const long long src = r + row0 + s_off[k];
        V val = V();
        if (src >= 0 && src < hw) val = inb[src * upb + c];
        outb[i] = val;
    }
}

template <typename V>
static int launch(const void* in, void* out, long long b, long long hw,
                  long long row_bytes, long long n_rows, long long row0, int K,
                  const PackOffsets& offs, cudaStream_t stream) {
    const int upb = (int)(row_bytes / (long long)sizeof(V));
    const long long total = n_rows * (long long)K * upb;
    long long blocks = (total + PACK_THREADS - 1) / PACK_THREADS;
    if (blocks > PACK_MAX_BLOCKS) blocks = PACK_MAX_BLOCKS;
    if (blocks < 1) blocks = 1;
    dim3 grid((unsigned)blocks, (unsigned)b);
    pack_rows_kernel<V><<<grid, PACK_THREADS, 0, stream>>>(
        (const V*)in, (V*)out, hw, n_rows, row0, K, upb, offs);
    return (int)cudaGetLastError();
}

// in: (b, hw, row_bytes) bytes, out: (b, n_rows, K*row_bytes) bytes, both
// contiguous on the current device; offsets: K host integers.  Returns
// cudaGetLastError(), or -1 for arguments the kernel does not take.
extern "C" int pack_rows(const void* in, void* out, long long b, long long hw,
                         long long row_bytes, long long n_rows, long long row0,
                         int K, const long long* offsets, void* stream) {
    if (K < 1 || K > PACK_MAX_K || b < 1 || b > 65535 || hw < 1 ||
        row_bytes < 1 || n_rows < 0)
        return -1;
    if (n_rows == 0) return 0;
    PackOffsets offs;
    for (int k = 0; k < K; ++k) offs.v[k] = offsets[k];
    const uintptr_t align = (uintptr_t)in | (uintptr_t)out | (uintptr_t)row_bytes;
    cudaStream_t s = (cudaStream_t)stream;
    if (align % 16 == 0)
        return launch<uint4>(in, out, b, hw, row_bytes, n_rows, row0, K, offs, s);
    if (align % 8 == 0)
        return launch<uint2>(in, out, b, hw, row_bytes, n_rows, row0, K, offs, s);
    if (align % 4 == 0)
        return launch<uint32_t>(in, out, b, hw, row_bytes, n_rows, row0, K, offs, s);
    if (align % 2 == 0)
        return launch<uint16_t>(in, out, b, hw, row_bytes, n_rows, row0, K, offs, s);
    return launch<uint8_t>(in, out, b, hw, row_bytes, n_rows, row0, K, offs, s);
}
