// Probe-table pack for the dense matcher.
//
// Replaces the Pallas kernel `_mxu_pack_kernel` of
// mast3r_slam_tpu/ops/pack.py:73 (pack_rows_mxu).  For a table `flat`
// (b, hw, F) and K signed row offsets it writes
//
//     out[b, r, k*F + c] = flat[b, r + row0 + offsets[k], c]
//
// where that source row lies in [0, hw), and 0 elsewhere: row r of the packed
// table holds the K rows around r + row0 side by side, so the matcher fetches
// a whole probe window with one row gather.
//
// Bound on the card: bytes.  The work is a copy: hw*F*itemsize bytes read and
// n_rows*K*F*itemsize bytes written, no arithmetic beyond the index.
//
// Design.  The table is handled as bytes (row width RB = F*itemsize), so the
// same kernel serves int8, f16, bf16 and f32 bit for bit, at any row width
// and any pointer alignment.  One block owns a tile: R consecutive output
// rows and a group of consecutive offsets k (all K of them, unless a single
// output row does not fit the staging; then R = 1 and the K offsets are cut
// into groups).  The tile's output is one contiguous byte range, so:
//   * every store is a coalesced 16-byte store, whatever RB is: the range's
//     16-byte aligned middle as uint4, a head and tail of at most 15 bytes
//     each as single bytes;
//   * each source byte is read from device memory once per tile: the host
//     (ops/pack.py::tile_plan) groups the offsets into spans, offsets whose
//     windows [r0 + row0 + off, + R) overlap, and the block copies each
//     span's R + (hi - lo) rows into shared memory once, over the 16-byte
//     aligned cover of their bytes, with 16-byte cp.async copies that are
//     all in flight before the block waits; bytes outside the table (or
//     outside this batch item) are the copy's zero fill.  The LM corner
//     table (0, 1, w, w+1) is 2 spans of R+1 rows; a refine table
//     p*d + (j*d - rd)*w is 2r+1 spans of R+(P-1)*d rows;
//   * the output is then assembled from shared memory in units of G bytes,
//     G the largest of 16, 8, 4, 2, 1 that divides RB and both pointers (the
//     staged copy keeps each byte's address modulo 16, so a unit never
//     straddles two rows); a 16-byte chunk holds at most two pieces of
//     source rows when RB >= 16, so a unit picks one of two pointers;
//   * no 64-bit division: the tile's addresses are computed once, and each
//     thread divides (32-bit, by the tile's output row width and RB, fixed
//     for the launch) once to find its first chunk, then steps.
// Measured on the card (PERF.md): 67-77% of the bytes bound on the
// production tables, level with one device copy of the same bytes on the
// three refine tables.
// The TPU kernel's placement matmuls, overlapping block views and hw % tile
// restriction answer that machine's lane tiling and have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

#define PACK_MAX_K 64
#define PACK_THREADS 128       // a block
// the tail of a tile's output (< 16 bytes) is written by threads 32..47
static_assert(PACK_THREADS >= 48, "pack_tiles_kernel needs 48 threads");
#define PACK_MAX_SMEM (227 * 1024 - 1024)   // a block's staging

// The tiling of ops/pack.py::tile_plan.  Group g covers the offsets
// k in [group_k[g], group_k[g+1]) and stages the spans
// [group_span[g], group_span[g+1]); span s holds the source rows
// r0 + row0 + span_lo[s] + [0, span_rows[s]) at byte span_smem[s] of the
// staging; offset k reads its rows span k_span[k] from row k_delta[k] on.
struct PackPlan {
    int R, n_groups;
    int group_k[PACK_MAX_K + 1];
    int group_span[PACK_MAX_K + 1];
    long long span_lo[PACK_MAX_K];
    int span_rows[PACK_MAX_K];
    int span_smem[PACK_MAX_K];
    int k_span[PACK_MAX_K];
    int k_delta[PACK_MAX_K];
};

template <int G> struct Unit;
template <> struct Unit<1> { typedef uint8_t T; };
template <> struct Unit<2> { typedef uint16_t T; };
template <> struct Unit<4> { typedef uint32_t T; };
template <> struct Unit<8> { typedef uint2 T; };
template <> struct Unit<16> { typedef uint4 T; };

__device__ __forceinline__ const uint8_t* ptr(long long a) {
    return reinterpret_cast<const uint8_t*>(static_cast<uintptr_t>(a));
}

// The 16 source bytes at the 16-byte aligned address a; bytes outside the
// batch item's table [vb, ve) read as 0.
__device__ __forceinline__ uint4 load_chunk(long long a, long long vb,
                                            long long ve) {
    union { uint4 v; uint8_t b[16]; } u;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        const long long x = a + j;
        u.b[j] = (x >= vb && x < ve) ? __ldg(ptr(x)) : (uint8_t)0;
    }
    return u.v;
}

// Asynchronous copy of 16 bytes to shared memory, of which the first `size`
// come from device memory and the rest are zeros.
__device__ __forceinline__ void cp_async16(void* dst, long long src, int size) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(ptr(src)), "r"(size) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Where a thread is in the tile's output: row r, the group's kk-th offset,
// byte c of its block.
struct Cursor {
    int r, kk, c;
};

__device__ __forceinline__ Cursor cursor_at(int q, int obg, int rb) {
    Cursor x;
    x.r = q / obg;
    const int rem = q - x.r * obg;
    x.kk = rem / rb;
    x.c = rem - x.kk * rb;
    return x;
}

// The 16 output bytes at cursor x (x.c a multiple of G), read from the
// staging in units of G bytes; base[kk] is the staging byte of tile row 0
// of the group's kk-th offset.  A block of rb >= 16 bytes leaves at most
// two pieces in 16 bytes: the rest of this block and the start of the next
// one, each contiguous in the staging, so a unit picks one of two pointers.
template <int G>
__device__ __forceinline__ uint4 gather16(const uint8_t* stage, const int* base,
                                          Cursor x, int rb, int nk) {
    typedef typename Unit<G>::T U;
    union { uint4 v; U u[16 / G]; } o;
    if (rb >= 16) {
        const int p1 = base[x.kk] + x.r * rb + x.c;
        const int l1 = rb - x.c;
        const int p2 = (x.kk + 1 < nk ? base[x.kk + 1] + x.r * rb
                                      : base[0] + (x.r + 1) * rb) - l1;
#pragma unroll
        for (int i = 0; i < 16 / G; ++i) {
            const int at = i * G;
            o.u[i] = *reinterpret_cast<const U*>(stage + (at < l1 ? p1 : p2) +
                                                 at);
        }
        return o.v;
    }
#pragma unroll
    for (int i = 0; i < 16 / G; ++i) {
        o.u[i] = *reinterpret_cast<const U*>(stage + base[x.kk] + x.r * rb +
                                             x.c);
        x.c += G;
        if (x.c == rb) {
            x.c = 0;
            if (++x.kk == nk) { x.kk = 0; ++x.r; }
        }
    }
    return o.v;
}

__device__ __forceinline__ uint8_t gather1(const uint8_t* stage, const int* base,
                                           int q, int obg, int rb) {
    const Cursor x = cursor_at(q, obg, rb);
    return stage[base[x.kk] + x.r * rb + x.c];
}

struct PackArgs {
    long long in, out, hw, n_rows, row0;
    int rb, K, tiles_per_item;
};

// One block's work: output rows [r0, r0 + rows) of batch item b for the
// offsets of group g.  vb, ve bound the item's table; src0 is the address
// of source row r0 + row0 (which may lie outside it).
struct Tile {
    long long vb, ve, src0, r0, b;
    int g, rows;
};

__device__ __forceinline__ Tile tile_at(int w, const PackArgs& A,
                                        const PackPlan& P) {
    Tile t;
    const int b = w / A.tiles_per_item;
    const int rest = w - b * A.tiles_per_item;
    const int tile = rest / P.n_groups;
    t.b = b;
    t.g = rest - tile * P.n_groups;
    t.r0 = (long long)tile * P.R;
    t.rows = (int)min((long long)P.R, A.n_rows - t.r0);
    t.vb = A.in + t.b * A.hw * A.rb;
    t.ve = t.vb + A.hw * A.rb;
    t.src0 = t.vb + (t.r0 + A.row0) * A.rb;
    return t;
}

// Start the copies of the tile's spans into the staging, each over the
// 16-byte aligned cover of its bytes, rows outside the table as zeros (the
// copy's zero fill).  A chunk that starts before the table and ends inside
// it (the first chunk of a table that is not 16-byte aligned) is read at
// once, bytewise.
__device__ __forceinline__ void stage_tile(const Tile& t, uint8_t* stage,
                                           const PackArgs& A,
                                           const PackPlan& P) {
    const long long safe = t.vb & ~15LL;   // a mapped address for 0 bytes
    for (int s = P.group_span[t.g]; s < P.group_span[t.g + 1]; ++s) {
        const long long gs = t.src0 + P.span_lo[s] * A.rb;
        const long long a0 = gs & ~15LL;
        const int n = (int)((gs + (long long)P.span_rows[s] * A.rb - a0 + 15)
                            >> 4);
        uint8_t* dst = stage + P.span_smem[s];
        for (int j = threadIdx.x; j < n; j += PACK_THREADS) {
            const long long a = a0 + 16LL * j;
            if (a >= t.vb || a + 16 <= t.vb) {
                const int size = a >= t.vb ? (int)max(0LL, min(16LL, t.ve - a))
                                           : 0;
                cp_async16(dst + 16 * j, size ? a : safe, size);
            } else {
                *reinterpret_cast<uint4*>(dst + 16 * j) =
                    load_chunk(a, t.vb, t.ve);
            }
        }
    }
}

// One block per tile: stage its spans, then write its output bytes
// [os, oe) (rows r0.. of the group's offsets: one contiguous range, since
// the group is all K offsets or R is 1) from the staging, the 16-byte
// aligned middle as uint4 and head and tail bytewise.
template <int G>
__global__ void __launch_bounds__(PACK_THREADS)
pack_tiles_kernel(const PackArgs A, const PackPlan P) {
    extern __shared__ __align__(16) uint8_t stage[];
    __shared__ int base[PACK_MAX_K];

    const int tid = threadIdx.x;
    const Tile t = tile_at(blockIdx.x, A, P);
    stage_tile(t, stage, A, P);
    const int k0 = P.group_k[t.g], nk = P.group_k[t.g + 1] - k0;
    if (tid < nk) {
        const int k = k0 + tid, s = P.k_span[k];
        const long long gs = t.src0 + P.span_lo[s] * A.rb;
        base[tid] = P.span_smem[s] + (int)(gs & 15) + P.k_delta[k] * A.rb;
    }
    cp_async_wait_all();
    __syncthreads();

    const int rb = A.rb, obg = nk * rb;
    const long long os = A.out + ((t.b * A.n_rows + t.r0) * A.K + k0) * rb;
    const long long oe = os + (long long)t.rows * obg;
    const long long a0 = (os + 15) & ~15LL;
    const long long a1 = oe & ~15LL;
    const int n = a1 > a0 ? (int)((a1 - a0) >> 4) : 0;
    // each thread steps 16 * PACK_THREADS bytes: (dr, dkk, dc) in cursor
    // terms, so the divisions run once a thread
    const Cursor d = cursor_at(16 * PACK_THREADS, obg, rb);
    Cursor x = cursor_at((int)(a0 - os) + 16 * tid, obg, rb);
    for (int i = tid; i < n; i += PACK_THREADS) {
        *reinterpret_cast<uint4*>(static_cast<uintptr_t>(a0 + 16LL * i)) =
            gather16<G>(stage, base, x, rb, nk);
        x.c += d.c;
        if (x.c >= rb) { x.c -= rb; ++x.kk; }
        x.kk += d.kk;
        if (x.kk >= nk) { x.kk -= nk; ++x.r; }
        x.r += d.r;
    }
    const int head = (int)(min(a0, oe) - os);
    const int tail0 = (int)(max(a1, os + head) - os);
    const int tail = (int)(oe - os) - tail0;
    if (tid < head)
        *reinterpret_cast<uint8_t*>(static_cast<uintptr_t>(os + tid)) =
            gather1(stage, base, tid, obg, rb);
    else if (tid >= 32 && tid < 32 + tail)
        *reinterpret_cast<uint8_t*>(
            static_cast<uintptr_t>(os + tail0 + tid - 32)) =
            gather1(stage, base, tail0 + tid - 32, obg, rb);
}

template <int G>
static int launch(const PackArgs& A, const PackPlan& P, int n_work,
                  int smem, cudaStream_t stream) {
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            pack_tiles_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem);
        if (e != cudaSuccess) return (int)e;
    }
    pack_tiles_kernel<G><<<n_work, PACK_THREADS, smem, stream>>>(A, P);
    return (int)cudaGetLastError();
}

// in: (b, hw, row_bytes) bytes, out: (b, n_rows, K*row_bytes) bytes, both
// contiguous on the current device at any alignment; the tiling of
// ops/pack.py::tile_plan (R rows a tile, n_groups groups of offsets, n_spans
// spans, smem bytes of staging).  Returns cudaGetLastError(), or -1 for
// arguments the kernel does not take.
extern "C" int pack_rows(const void* in, void* out, long long b, long long hw,
                         long long row_bytes, long long n_rows, long long row0,
                         int K, int R, int n_groups, const int* group_k,
                         const int* group_span, int n_spans,
                         const long long* span_lo, const int* span_rows,
                         const int* span_smem, const int* k_span,
                         const int* k_delta, int smem, void* stream) {
    if (K < 1 || K > PACK_MAX_K || b < 1 || b > 65535 || hw < 1 ||
        row_bytes < 1 || n_rows < 0 || R < 1 || n_groups < 1 ||
        n_groups > K || (n_groups > 1 && R != 1) || n_spans < 1 ||
        n_spans > PACK_MAX_K || smem < 16 || smem > PACK_MAX_SMEM ||
        (long long)R * K * row_bytes > 0x7fffffffLL)
        return -1;
    if (n_rows == 0) return 0;
    if ((n_rows + R - 1) / R * n_groups * b > 0x7fffffffLL) return -1;
    PackPlan P;
    P.R = R;
    P.n_groups = n_groups;
    for (int g = 0; g <= n_groups; ++g) {
        P.group_k[g] = group_k[g];
        P.group_span[g] = group_span[g];
    }
    for (int s = 0; s < n_spans; ++s) {
        P.span_lo[s] = span_lo[s];
        P.span_rows[s] = span_rows[s];
        P.span_smem[s] = span_smem[s];
        // a span's aligned cover takes at most round16(its bytes) + 16
        if (span_rows[s] < 1 || span_smem[s] % 16 != 0 ||
            span_smem[s] + ((long long)span_rows[s] * row_bytes + 15) / 16 * 16
                + 16 > smem)
            return -1;
    }
    for (int k = 0; k < K; ++k) {
        P.k_span[k] = k_span[k];
        P.k_delta[k] = k_delta[k];
        if (k_span[k] < 0 || k_span[k] >= n_spans || k_delta[k] < 0 ||
            k_delta[k] + R > span_rows[k_span[k]])
            return -1;
    }
    PackArgs A;
    A.in = (long long)(uintptr_t)in;
    A.out = (long long)(uintptr_t)out;
    A.hw = hw;
    A.n_rows = n_rows;
    A.row0 = row0;
    A.rb = (int)row_bytes;
    A.K = K;
    A.tiles_per_item = (int)((n_rows + R - 1) / R * n_groups);
    const int n_work = (int)(b * A.tiles_per_item);
    const uintptr_t align = (uintptr_t)in | (uintptr_t)out | (uintptr_t)row_bytes;
    cudaStream_t s = (cudaStream_t)stream;
    if (align % 16 == 0) return launch<16>(A, P, n_work, smem, s);
    if (align % 8 == 0) return launch<8>(A, P, n_work, smem, s);
    if (align % 4 == 0) return launch<4>(A, P, n_work, smem, s);
    if (align % 2 == 0) return launch<2>(A, P, n_work, smem, s);
    return launch<1>(A, P, n_work, smem, s);
}
