// Multi-bandwidth RBF MMD Gram kernels for Hopper (sm_90a), IEEE f32.
//
// Four functions, each replacing one Pallas TPU kernel of
// vgan_tpu/ops/pallas/mmd_gram.py:
//
//   K1 vgan_gram_quadrant_sums        <- _fwd_kernel           quadrant sums XX, XY, YY
//   K2 vgan_gram_quadrant_sums_stash  <- _fwd_stash_kernel     the sums + K'(d2) (m, m)
//   K3 vgan_gram_backward_flash       <- _flash_bwd_kernel     S @ z and rowsum(S), no m^2 buffer
//   K4 vgan_kprime_panel              <- _kprime_panel_kernel  an (R, C) K'(d2) panel
//
// What bounds them on an H100: the distance product. At the stress shape
// (m = 1000 rows, d = 10240) the forward needs the m (m - 1) / 2 unordered
// pairs' dot products, 1.02e10 flops on 41 MB of input: bound by the
// non-tensor f32 rate (67 TFLOP/s). Every entry then goes through the
// bandwidth ladder: one expf plus integer powers for a geometric ladder
// (ops.mmd.ladder_exponents), one expf per bandwidth otherwise.
//
// K1, K2 and K4 run on dist_tile.cuh's pipelined 128 x 128 tile (8 x 8
// outputs a thread, 16-column chunks of column-major operands
// double-buffered with cp.async, fmaf in ascending column order, never
// TF32). A Panel names the tiles a launch forms: an (R, C) block of the
// Gram whose row r is row row0 + r of the row operand and whose column c is
// column c of the column operand. When the rows are themselves columns
// diag .. diag + R of the column operand, the diagonal block forms each
// unordered pair once (tile pairs J <= I) and writes the K' of a pair J < I
// to (r, c) and to (c, r), so it is exactly symmetric; the columns left and
// right of it are ordered tiles. K1 and K2 take the whole symmetric square
// (R = C = m, diag = 0): its 128-row tile pairs only. K4 takes the panel
// backward's (R, m) row panels, or an ordered panel when the caller gives no
// offset.
//
// d2 = max(-2 dot + (|zi|^2 + |zj|^2), 0), symmetric in i and j, and the
// ladder sits behind one non-inlined call (inlined, it would copy thousands
// of instructions into every entry), its power-of-two powers read off one
// squaring chain. A mirrored tile pair stands for both orientations in the
// sums: its XX and YY entries count twice and its XY entries (row < n1 <=
// col) once; a tile on the diagonal counts each entry once.
//
// Two modes, chosen by the caller (ops/cuda/mmd_gram.py tile_schedule):
//
// (a) when the tiles alone give more than half a wave (two blocks an SM),
//     one block a tile over all of d (tile_kernel), its epilogue on its own
//     accumulators in registers: no dot product goes to device memory;
// (b) when they do not (36 tile pairs at m = 1000), the summed d axis is
//     split into slices, multiples of the 16-column chunk, until tiles x
//     slices fill one wave: dot_slices_kernel writes each (tile, slice)
//     partial dot tile to scratch (at most one wave of them, so the scratch
//     never grows with m^2 for K1 and K4), and slices_epilogue_kernel adds
//     them in slice order, four blocks a tile (sixteen for K1, whose
//     epilogue stores nothing and is latency-bound).
//
// K1 and K2 copy z into the column-major, zero-padded layout the tile reads
// (transpose_pad_kernel, d x M, M = m rounded up to 128); K2 always takes
// mode (b)'s passes, as its (m, m) stash does not fit in registers. K4's
// operands come in that layout from the caller (vgan_transpose_pad), who
// makes the column-major copy of z once for all the panels of a backward.
//
// K3 (flash_bwd_kernel) still runs on the earlier 64 x 64 tile, tile_dot,
// with the ladder inlined: block (i, s) owns a 64-row block i of the output
// and the column tiles s, s + nsplit, s + 2 nsplit, ... For each column tile
// it builds the S tile (coefficient * K') in shared memory, then streams
// 64-wide d-chunks of z[cols] through shared memory and does a
// read-add-write of its own rows of its own partial sz (no other block
// touches them, so no atomics). sum_splits then adds the nsplit partials in
// split order. The column split exists because a row block alone gives only
// m / 64 blocks (16 at m = 1000) for 132 SMs. (The Pallas kernel holds a
// full-D sz accumulator in VMEM, which does not fit Hopper's 227 KB of
// shared memory at D = 2048.)
//
// Determinism: thread blocks run in no fixed order, so no float atomics are
// used anywhere. The forward kernels write one (XX, XY, YY) partial per block
// and finalize_sums reduces the partials in a fixed order; mode (b) adds its
// d slices in slice order; the flash backward's partials are added in split
// order. Re-runs give identical bits.
//
// Ragged edges are masked in the kernels: rows >= R and columns >= C are not
// stored or summed, and d-chunk entries >= d load as zero.
//
// Plain C interface: every entry returns cudaGetLastError() after its
// launches; pointers and the stream come from the caller (ctypes).

#include <cuda_runtime.h>
#include <stddef.h>

#include "dist_tile.cuh"

namespace {

constexpr int BM = 64;   // K3: rows of a tile
constexpr int BN = 64;   // K3: columns of a tile
constexpr int BK = 16;   // K3: d-chunk of the distance product
constexpr int FD = 64;   // K3: d-chunk of S @ z
constexpr int NT = 256;  // threads per block (K3: 16 x 16, 4 x 4 outputs each)
constexpr int MAX_MULTS = 8;
constexpr int ST = 8;          // K1, K2, K4: 8 x 8 outputs a thread
constexpr int SB = 16 * ST;    // K1, K2, K4: a 128 x 128 tile
constexpr int SB2 = SB * SB;   // floats of one partial dot tile
constexpr int TT = 32;         // transpose tile

}  // namespace

extern "C" {

// Bandwidth ladder: K(d2) = sum_k exp(-d2 / (bw * mult[k])). With
// use_pow, t = exp(-d2 / (bw * base)) and exp(-d2 / (bw * mult[k])) = t^pw[k].
struct VganLadder {
    int n;
    int use_pow;
    float base;
    float mult[MAX_MULTS];
    int pw[MAX_MULTS];
};

}  // extern "C"

namespace {

// t^i by square-and-multiply from the leading bit: the same multiplications,
// in the same order, as ops.mmd.integer_powers.
__device__ __forceinline__ float int_pow(float t, int i) {
    int top = 31 - __clz(i);
    float r = t;
    for (int b = top - 1; b >= 0; --b) {
        r = r * r;
        if ((i >> b) & 1) r = r * t;
    }
    return r;
}

// K(d2) and K'(d2) = -sum_k exp(-d2 / (bw mk)) / (bw mk), summed in ladder
// order as _kernel_sum / _kernel_deriv do.
template <bool WANT_K, bool WANT_KP>
__device__ __forceinline__ void ladder_eval(float d2, float bw, const VganLadder& L,
                                            float& k, float& kp) {
    k = 0.f;
    kp = 0.f;
    float t = 0.f;
    if (L.use_pow) t = expf(-d2 / (bw * L.base));
#pragma unroll
    for (int q = 0; q < MAX_MULTS; ++q) {
        if (q < L.n) {
            float p = L.use_pow ? int_pow(t, L.pw[q]) : expf(-d2 / (bw * L.mult[q]));
            if (WANT_K) k = k + p;
            if (WANT_KP) kp = kp - p / (bw * L.mult[q]);
        }
    }
}

// acc[i][j] = sum_k zr[row0 + 4 ty + i][k] * zc[col0 + 4 tx + j][k]
__device__ __forceinline__ void tile_dot(const float* __restrict__ zr,
                                         const float* __restrict__ zc, int R, int C,
                                         int d, int row0, int col0,
                                         float (*As)[BM + 4], float (*Bs)[BN + 4],
                                         float acc[4][4]) {
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
        for (int l = 0; l < (BM * BK) / NT; ++l) {
            const int idx = tid + l * NT;
            const int r = idx / BK, kk = idx % BK;
            const int gk = k0 + kk;
            const int gr = row0 + r, gc = col0 + r;
            As[kk][r] = (gr < R && gk < d) ? zr[(size_t)gr * d + gk] : 0.f;
            Bs[kk][r] = (gc < C && gk < d) ? zc[(size_t)gc * d + gk] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
            const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
    }
}

// Sum of v over the block, in a fixed order; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane == 0) red[warp] = v;
    __syncthreads();
    float t = 0.f;
    if (threadIdx.x == 0)
        for (int w = 0; w < NT / 32; ++w) t += red[w];
    __syncthreads();
    return t;
}

// z_t[k * ld + r] = z[r * d + k] for r < m, 0 for m <= r < ld; 32 x 32
// tiles through shared memory, so both sides are coalesced.
__global__ void transpose_pad_kernel(const float* __restrict__ z, int m, int d, int ld,
                                     float* __restrict__ z_t) {
    __shared__ float t[TT][TT + 1];
    const int r0 = blockIdx.x * TT, k0 = blockIdx.y * TT;
    for (int j = threadIdx.y; j < TT; j += blockDim.y) {
        const int r = r0 + j, k = k0 + threadIdx.x;
        t[j][threadIdx.x] = r < m && k < d ? z[(size_t)r * d + k] : 0.f;
    }
    __syncthreads();
    for (int j = threadIdx.y; j < TT; j += blockDim.y) {
        const int k = k0 + j, r = r0 + threadIdx.x;
        if (k < d) z_t[(size_t)k * ld + r] = t[threadIdx.x][j];
    }
}

// The b-th tile pair (J, I), J <= I, of the upper triangle of tiles x tiles.
__device__ __forceinline__ void tile_pair(int b, int tiles, int& J, int& I) {
    J = 0;
    while (b >= tiles - J) b -= tiles - J++;
    I = J + b;
}

// One 128 x 128 tile of a panel: its rows [r0, r0 + SB) below R, its
// columns [c0, c0 + SB) below c1. mirror: the K' of entry (r, c) is also
// written to (c - diag, diag + r).
struct TileAt {
    int r0, c0, c1;
    bool mirror;
};

// The tiles of an (R, C) panel (see the header). With diag >= 0 the blocks
// take the diagonal block's tile pairs first, then, row tile by row tile,
// the `before` column tiles left of it and the `after` ones right of it;
// with diag < 0, `before` counts every column tile. ops/cuda/mmd_gram.py
// panel_blocks counts them on the host; tests/test_torch_mmd_gram.py
// models the enumeration.
struct Panel {
    int R, C, diag, rows, pairs, before, after;

    __host__ __device__ int tiles() const { return pairs + rows * (before + after); }

    __device__ TileAt at(int b) const {
        if (b < pairs) {
            int J, I;
            tile_pair(b, rows, J, I);
            return {J * SB, diag + I * SB, diag + R, I != J};
        }
        b -= pairs;
        const int per = before + after, J = b / per, k = b % per;
        if (k < before) return {J * SB, k * SB, diag < 0 ? C : diag, false};
        return {J * SB, diag + R + (k - before) * SB, C, false};
    }
};

Panel make_panel(int R, int C, int diag) {
    const int rows = dist_tile::cdiv(R, SB);
    if (diag < 0) return {R, C, -1, rows, 0, dist_tile::cdiv(C, SB), 0};
    return {R, C, diag, rows, rows * (rows + 1) / 2, dist_tile::cdiv(diag, SB),
            dist_tile::cdiv(C - diag - R, SB)};
}

// Four consecutive entries to p[0..4): the ones at or past n are left out;
// one 16-byte store when vec (p 16-byte aligned) and all four are in.
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float e, int n,
                                      bool vec) {
    if (vec && n >= 4) {
        *reinterpret_cast<float4*>(p) = make_float4(a, b, c, e);
        return;
    }
    if (n > 0) p[0] = a;
    if (n > 1) p[1] = b;
    if (n > 2) p[2] = c;
    if (n > 3) p[3] = e;
}

// ladder_eval behind a call, so that each epilogue keeps one copy of the
// ladder (instruction-cache footprint: inlined into every entry, its integer
// powers unroll into tens of thousands of instructions). The power-of-two
// exponents of a geometric ladder are read off one squaring chain t, t^2,
// t^4, t^8, t^16: int_pow forms t^(2^j) by the same j squarings, so the
// values are equal to the bit, with 4 products an entry instead of 10 and
// no loop (K1 at m = 40960, d = 1024: 48.6 ms against 55.4). Other
// exponents go through int_pow.
template <bool WANT_K, bool WANT_KP>
__device__ __noinline__ void ladder_call(float d2, float bw, const VganLadder& L, float& k,
                                         float& kp) {
    if (!L.use_pow) {
        ladder_eval<WANT_K, WANT_KP>(d2, bw, L, k, kp);
        return;
    }
    k = 0.f;
    kp = 0.f;
    const float t = expf(-d2 / (bw * L.base));
    const float t2 = t * t, t4 = t2 * t2, t8 = t4 * t4, t16 = t8 * t8;
#pragma unroll
    for (int q = 0; q < MAX_MULTS; ++q) {
        if (q < L.n) {
            const int i = L.pw[q];
            const float p = i == 1    ? t
                            : i == 2  ? t2
                            : i == 4  ? t4
                            : i == 8  ? t8
                            : i == 16 ? t16
                                      : int_pow(t, i);
            if (WANT_K) k = k + p;
            if (WANT_KP) kp = kp - p / (bw * L.mult[q]);
        }
    }
}

// The epilogue of a thread's Q x Q entries of tile t: rows[i] and cols[j]
// are their panel row and column (runs of four), v holds their dot
// products and is overwritten with K'. SUMS: add their K to s = (XX, XY,
// YY) with the pair-once weights of the header (the panel is the symmetric
// square, so rows and columns index z). KP: write K' to kp (R, C), and
// mirrored where t.mirror. The caller checks that every column start is a
// multiple of 4, so vec only needs C to be one.
template <int Q, bool SUMS, bool KP>
__device__ __forceinline__ void epilogue(float (&v)[Q][Q], const int (&rows)[Q],
                                         const int (&cols)[Q], const TileAt& t, const Panel& p,
                                         const float* __restrict__ n_rows,
                                         const float* __restrict__ n_cols, float bw, int n1,
                                         const VganLadder& L, float (&s)[3],
                                         float* __restrict__ kp) {
    float nr[Q], nc[Q];
#pragma unroll
    for (int i = 0; i < Q; ++i) {
        nr[i] = rows[i] < p.R ? n_rows[rows[i]] : 0.f;
        nc[i] = cols[i] < p.C ? n_cols[cols[i]] : 0.f;
    }
    const float w = t.mirror ? 2.f : 1.f;
#pragma unroll
    for (int i = 0; i < Q; ++i) {
#pragma unroll
        for (int j = 0; j < Q; ++j) {
            const float d2 = fmaxf(fmaf(-2.f, v[i][j], nr[i] + nc[j]), 0.f);
            float k, kpv;
            ladder_call<SUMS, KP>(d2, bw, L, k, kpv);
            v[i][j] = kpv;
            if (SUMS && rows[i] < p.R && cols[j] < t.c1) {
                const bool rx = rows[i] < n1, cx = cols[j] < n1;
                if (rx && cx) s[0] += w * k;
                else if (!rx && !cx) s[2] += w * k;
                else if (rx) s[1] += k;
            }
        }
    }
    if constexpr (KP) {
        static_assert(Q % 4 == 0, "K' goes out in runs of four");
        const bool vec = (p.C & 3) == 0;
#pragma unroll
        for (int i = 0; i < Q; ++i)  // (r, c)
            if (rows[i] < p.R)
#pragma unroll
                for (int g = 0; g < Q; g += 4)
                    store4(kp + (size_t)rows[i] * p.C + cols[g], v[i][g], v[i][g + 1],
                           v[i][g + 2], v[i][g + 3], t.c1 - cols[g], vec);
        if (t.mirror)
#pragma unroll
            for (int j = 0; j < Q; ++j)  // (c - diag, diag + r)
                if (cols[j] < t.c1)
#pragma unroll
                    for (int g = 0; g < Q; g += 4)
                        store4(kp + (size_t)(cols[j] - p.diag) * p.C + p.diag + rows[g], v[g][j],
                               v[g + 1][j], v[g + 2][j], v[g + 3][j], p.R - rows[g], vec);
    }
}

// The block's (XX, XY, YY) partial to partials[3 part ..].
__device__ __forceinline__ void write_sums(const float (&s)[3], float* red, float* partials,
                                           int part) {
    const float sxx = block_sum(s[0], red), sxy = block_sum(s[1], red),
                syy = block_sum(s[2], red);
    if (threadIdx.x == 0) {
        partials[3 * part + 0] = sxx;
        partials[3 * part + 1] = sxy;
        partials[3 * part + 2] = syy;
    }
}

constexpr size_t TILE_SMEM = sizeof(float) * dist_tile::smem_floats<ST, ST>();
static_assert(TILE_SMEM <= 48 * 1024, "launched without raising the dynamic shared memory limit");

// Mode (a): block b forms tile b of the panel over all of d, a_t / b_t the
// row and column operands (column-major, ld a multiple of 4, every row up to
// a tile's start + 128 inside), then the epilogue in registers. SUMS (K1):
// the block's (XX, XY, YY) partial; else (K4) K' to kp.
template <bool SUMS>
__global__ void __launch_bounds__(NT, 2)  // two blocks an SM: at most 128 registers
tile_kernel(const Panel p, const float* __restrict__ a_t, int lda, int row0,
            const float* __restrict__ b_t, int ldb, int d, const float* __restrict__ n_rows,
            const float* __restrict__ n_cols, const float* __restrict__ bw_ptr, int n1,
            VganLadder L, float* __restrict__ partials, float* __restrict__ kp) {
    extern __shared__ __align__(16) float smem[];
    __shared__ float red[NT / 32];
    const TileAt t = p.at(blockIdx.x);
    float acc[ST][ST];
#pragma unroll
    for (int r = 0; r < ST; ++r)
#pragma unroll
        for (int c = 0; c < ST; ++c) acc[r][c] = 0.f;
    dist_tile::NoHook hook;
    dist_tile::product<ST, ST>(dist_tile::Operand{a_t, lda, row0 + t.r0, nullptr},
                               dist_tile::Operand{b_t, ldb, t.c0, nullptr}, d, smem, acc, hook);
    int rows[ST], cols[ST];
#pragma unroll
    for (int i = 0; i < ST; ++i) {
        rows[i] = t.r0 + dist_tile::tile_row(i);
        cols[i] = t.c0 + dist_tile::tile_col(i);
    }
    float sums[3] = {0.f, 0.f, 0.f};
    epilogue<ST, SUMS, !SUMS>(acc, rows, cols, t, p, n_rows, n_cols, *bw_ptr, n1, L, sums, kp);
    if (SUMS) write_sums(sums, red, partials, blockIdx.x);
}

// Mode (b), pass 1: block (b, s) forms tile b's dot products over the d
// columns [s slice, s slice + slice) and writes them to its own partial
// tile of dots, entry (r, c) of thread t at (r ST + c) NT + t.
__global__ void __launch_bounds__(NT, 2)
dot_slices_kernel(const Panel p, const float* __restrict__ a_t, int lda, int row0,
                  const float* __restrict__ b_t, int ldb, int d, int slice,
                  float* __restrict__ dots) {
    extern __shared__ __align__(16) float smem[];
    const TileAt t = p.at(blockIdx.x);
    const size_t k0 = (size_t)blockIdx.y * slice;
    float acc[ST][ST];
#pragma unroll
    for (int r = 0; r < ST; ++r)
#pragma unroll
        for (int c = 0; c < ST; ++c) acc[r][c] = 0.f;
    dist_tile::NoHook hook;
    dist_tile::product<ST, ST>(dist_tile::Operand{a_t + k0 * lda, lda, row0 + t.r0, nullptr},
                               dist_tile::Operand{b_t + k0 * ldb, ldb, t.c0, nullptr},
                               min(slice, d - (int)k0), smem, acc, hook);
    float* out = dots + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * SB2 + threadIdx.x;
#pragma unroll
    for (int r = 0; r < ST; ++r)
#pragma unroll
        for (int c = 0; c < ST; ++c) out[(r * ST + c) * NT] = acc[r][c];
}

// Mode (b), pass 2: PARTS blocks a tile (4, or 16 for K1, whose epilogue
// stores nothing and is latency-bound at m = 1000: more warps in flight).
// Block (b, q) takes the Q x Q entries (Q = 8 / sqrt(PARTS)) of each
// thread's 8 x 8 at rows Q (q / (8 / Q)) and columns Q (q % (8 / Q)): it
// sums their nslices partial dots in slice order (the loads of one slice
// all in flight), then runs the epilogue. SUMS: the part's (XX, XY, YY)
// partial, at PARTS b + q; KP: K' to kp.
template <int PARTS, bool SUMS, bool KP>
__global__ void __launch_bounds__(NT)
slices_epilogue_kernel(const float* __restrict__ dots, int nslices, const Panel p,
                       const float* __restrict__ n_rows, const float* __restrict__ n_cols,
                       const float* __restrict__ bw_ptr, int n1, VganLadder L,
                       float* __restrict__ partials, float* __restrict__ kp) {
    constexpr int Q = PARTS == 4 ? ST / 2 : ST / 4;  // a part's rows (and columns) of a thread
    static_assert(Q * Q * PARTS == ST * ST, "PARTS is 4 or 16");
    __shared__ float red[NT / 32];
    const int b = blockIdx.x, r0 = Q * (blockIdx.y / (ST / Q)), c0 = Q * (blockIdx.y % (ST / Q));
    const TileAt t = p.at(b);
    const size_t stride = (size_t)gridDim.x * SB2;  // from one slice's tile to the next
    const float* src = dots + (size_t)b * SB2 + threadIdx.x;
    float dot[Q][Q];
#pragma unroll
    for (int i = 0; i < Q; ++i)
#pragma unroll
        for (int j = 0; j < Q; ++j) dot[i][j] = src[((r0 + i) * ST + c0 + j) * NT];
    for (int s = 1; s < nslices; ++s)
#pragma unroll
        for (int i = 0; i < Q; ++i)
#pragma unroll
            for (int j = 0; j < Q; ++j) dot[i][j] += src[s * stride + ((r0 + i) * ST + c0 + j) * NT];
    int rows[Q], cols[Q];
#pragma unroll
    for (int i = 0; i < Q; ++i) {
        rows[i] = t.r0 + dist_tile::tile_row(r0 + i);  // Q = 4: runs of four (r0 is 0 or 4)
        cols[i] = t.c0 + dist_tile::tile_col(c0 + i);
    }
    float sums[3] = {0.f, 0.f, 0.f};
    epilogue<Q, SUMS, KP>(dot, rows, cols, t, p, n_rows, n_cols, *bw_ptr, n1, L, sums, kp);
    if (SUMS) write_sums(sums, red, partials, b * PARTS + blockIdx.y);
}

// The per-block partials summed in a fixed order.
__global__ void __launch_bounds__(NT)
finalize_sums(const float* __restrict__ partials, int nblocks, float* __restrict__ sums) {
    __shared__ float red[3][NT];
    const int tid = threadIdx.x;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
        float s = 0.f;
        for (int b = tid; b < nblocks; b += NT) s += partials[3 * b + q];
        red[q][tid] = s;
    }
    __syncthreads();
    for (int s = NT / 2; s > 0; s >>= 1) {
        if (tid < s)
#pragma unroll
            for (int q = 0; q < 3; ++q) red[q][tid] += red[q][tid + s];
        __syncthreads();
    }
    if (tid == 0) {
        sums[0] = red[0][0];
        sums[1] = red[1][0];
        sums[2] = red[2][0];
        sums[3] = 0.f;
    }
}

// Replaces mmd_gram.py:_flash_bwd_kernel. Block (blockIdx.x, blockIdx.y) =
// (row block, column split); partial s of sz / rs lives at sz + s m d and
// rs + s m. See the layout note at the top of this file.
__global__ void __launch_bounds__(NT)
flash_bwd_kernel(const float* __restrict__ z, const float* __restrict__ norms,
                 const float* __restrict__ bw_ptr, int m, int d, int n1, float cxx,
                 float cyy, float cxy, VganLadder L, float* __restrict__ sz,
                 float* __restrict__ rs) {
    __shared__ __align__(16) float As[BK][BM + 4];
    __shared__ __align__(16) float Bs[BK][BN + 4];
    __shared__ float S[BM][BN + 1];
    __shared__ __align__(16) float Zs[BN][FD + 4];
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int row0 = blockIdx.x * BM;
    const int split = blockIdx.y, nsplit = gridDim.y;
    sz += (size_t)split * m * d;
    rs += (size_t)split * m;
    const float bw = *bw_ptr;
    float rsum[4] = {0.f, 0.f, 0.f, 0.f};
    for (int col0 = split * BN; col0 < m; col0 += nsplit * BN) {
        const bool first = col0 == split * BN;
        float acc[4][4];
        tile_dot(z, z, m, m, d, row0, col0, As, Bs, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = row0 + ty * 4 + i;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = col0 + tx * 4 + j;
                float s = 0.f;
                if (r < m && c < m) {
                    const float d2 = fmaxf(-2.f * acc[i][j] + norms[r] + norms[c], 0.f);
                    float k, kp;
                    ladder_eval<false, true>(d2, bw, L, k, kp);
                    const bool rx = r < n1, cx = c < n1;
                    const float coeff = (rx && cx) ? cxx : ((!rx && !cx) ? cyy : cxy);
                    s = coeff * kp;
                }
                S[ty * 4 + i][tx * 4 + j] = s;
                rsum[i] += s;
            }
        }
        __syncthreads();
        for (int dc = 0; dc < d; dc += FD) {
#pragma unroll
            for (int l = 0; l < (BN * FD) / NT; ++l) {
                const int idx = tid + l * NT;
                const int c = idx / FD, k = idx % FD;
                const int gc = col0 + c, gk = dc + k;
                Zs[c][k] = (gc < m && gk < d) ? z[(size_t)gc * d + gk] : 0.f;
            }
            __syncthreads();
            float out[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
#pragma unroll 8
            for (int c = 0; c < BN; ++c) {
                const float4 b = *reinterpret_cast<const float4*>(&Zs[c][tx * 4]);
                const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float a = S[ty * 4 + i][c];
#pragma unroll
                    for (int j = 0; j < 4; ++j) out[i][j] = fmaf(a, bv[j], out[i][j]);
                }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int r = row0 + ty * 4 + i;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int k = dc + tx * 4 + j;
                    if (r < m && k < d) {
                        float* p = &sz[(size_t)r * d + k];
                        *p = first ? out[i][j] : *p + out[i][j];
                    }
                }
            }
            __syncthreads();
        }
    }
    // rowsum(S): the 16 threads of one ty share its 4 rows (lanes 0-15 or
    // 16-31 of a warp); fixed-order butterfly.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        float v = rsum[i];
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        const int r = row0 + ty * 4 + i;
        if (tx == 0 && r < m) rs[r] = v;
    }
}

// out[i] = sum over s of parts[s n + i], in split order.
__global__ void __launch_bounds__(NT)
sum_splits(const float* __restrict__ parts, int nsplit, size_t n, float* __restrict__ out) {
    for (size_t i = (size_t)blockIdx.x * NT + threadIdx.x; i < n; i += (size_t)gridDim.x * NT) {
        float t = parts[i];
        for (int s = 1; s < nsplit; ++s) t += parts[(size_t)s * n + i];
        out[i] = t;
    }
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

inline int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

// K1 (kp == nullptr) and K2 over the symmetric square of z (m, d). scratch,
// in this order: z_t (d x M floats, M = m rounded up to 128); in mode (a)
// (K1 with one slice) the sums' partials (3 x P, P = T (T + 1) / 2 tile pairs
// of T = M / 128 tiles); in mode (b) the partial dot tiles (cdiv(d, slice) x
// P x 128^2) and the sums' partials (3 x 4 P for K2, 3 x 16 P for K1: the
// epilogue's blocks a tile pair).
int quadrant_sums(const float* z, const float* norms, const float* bw, int m, int d, int n1,
                  const VganLadder* ladder, int slice, float* scratch, float* sums, float* kp,
                  cudaStream_t s) {
    if (m < 1 || d < 1 || slice < 1 || slice % dist_tile::BK) return invalid();
    const Panel p = make_panel(m, m, 0);
    const int ld = p.rows * SB, blocks = p.tiles(), nslices = cdiv(d, slice);
    if (nslices > 65535 || cdiv(d, TT) > 65535) return invalid();
    float* z_t = scratch;
    float* dots = z_t + (size_t)d * ld;
    transpose_pad_kernel<<<dim3(ld / TT, cdiv(d, TT)), dim3(TT, 8), 0, s>>>(z, m, d, ld, z_t);
    if (!kp && nslices == 1) {
        tile_kernel<true><<<blocks, NT, TILE_SMEM, s>>>(p, z_t, ld, 0, z_t, ld, d, norms, norms, bw,
                                                        n1, *ladder, dots, nullptr);
        finalize_sums<<<1, NT, 0, s>>>(dots, blocks, sums);
        return static_cast<int>(cudaGetLastError());
    }
    float* partials = dots + (size_t)nslices * blocks * SB2;
    dot_slices_kernel<<<dim3(blocks, nslices), NT, TILE_SMEM, s>>>(p, z_t, ld, 0, z_t, ld, d, slice,
                                                                   dots);
    const int parts = kp ? 4 : 16;
    if (kp)
        slices_epilogue_kernel<4, true, true><<<dim3(blocks, parts), NT, 0, s>>>(
            dots, nslices, p, norms, norms, bw, n1, *ladder, partials, kp);
    else
        slices_epilogue_kernel<16, true, false><<<dim3(blocks, parts), NT, 0, s>>>(
            dots, nslices, p, norms, norms, bw, n1, *ladder, partials, nullptr);
    finalize_sums<<<1, NT, 0, s>>>(partials, parts * blocks, sums);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K1. slice: the d columns of one slice, a positive multiple of 16; one
// slice is mode (a). scratch: see quadrant_sums.
int vgan_gram_quadrant_sums(const float* z, const float* norms, const float* bw, int m, int d,
                            int n1, const VganLadder* ladder, int slice, float* scratch,
                            float* sums, void* stream) {
    return quadrant_sums(z, norms, bw, m, d, n1, ladder, slice, scratch, sums, nullptr,
                         static_cast<cudaStream_t>(stream));
}

// K2: always mode (b)'s passes. scratch: see quadrant_sums.
int vgan_gram_quadrant_sums_stash(const float* z, const float* norms, const float* bw,
                                  int m, int d, int n1, const VganLadder* ladder, int slice,
                                  float* scratch, float* sums, float* kp, void* stream) {
    if (!kp) return invalid();
    return quadrant_sums(z, norms, bw, m, d, n1, ladder, slice, scratch, sums, kp,
                         static_cast<cudaStream_t>(stream));
}

// nsplit column splits (1 <= nsplit <= cdiv(m, BN)). With nsplit > 1 the
// partials go to scratch (nsplit m d + nsplit m floats) and are summed into
// sz / rs; with nsplit == 1 scratch is unused.
int vgan_gram_backward_flash(const float* z, const float* norms, const float* bw, int m,
                             int d, int n1, float cxx, float cyy, float cxy,
                             const VganLadder* ladder, int nsplit, float* scratch,
                             float* sz, float* rs, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (nsplit < 1 || nsplit > cdiv(m, BN)) return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid(cdiv(m, BM), nsplit);
    if (nsplit == 1) {
        flash_bwd_kernel<<<grid, NT, 0, s>>>(z, norms, bw, m, d, n1, cxx, cyy, cxy,
                                             *ladder, sz, rs);
        return static_cast<int>(cudaGetLastError());
    }
    float* sz_parts = scratch;
    float* rs_parts = scratch + (size_t)nsplit * m * d;
    flash_bwd_kernel<<<grid, NT, 0, s>>>(z, norms, bw, m, d, n1, cxx, cyy, cxy, *ladder,
                                         sz_parts, rs_parts);
    const size_t n = (size_t)m * d;
    const int blocks = static_cast<int>((n + NT - 1) / NT < 4096 ? (n + NT - 1) / NT : 4096);
    sum_splits<<<blocks, NT, 0, s>>>(sz_parts, nsplit, n, sz);
    sum_splits<<<cdiv(m, NT), NT, 0, s>>>(rs_parts, nsplit, (size_t)m, rs);
    return static_cast<int>(cudaGetLastError());
}

// z (n, d) to z_t (d, ld) column-major, rows n .. ld zero (ld >= n, a
// multiple of 32): K4's operands.
int vgan_transpose_pad(const float* z, int n, int d, int ld, float* z_t, void* stream) {
    if (n < 1 || d < 1 || ld < n || ld % TT || cdiv(d, TT) > 65535) return invalid();
    transpose_pad_kernel<<<dim3(ld / TT, cdiv(d, TT)), dim3(TT, 8), 0,
                           static_cast<cudaStream_t>(stream)>>>(z, n, d, ld, z_t);
    return static_cast<int>(cudaGetLastError());
}

// K4: the (R, C) panel kp of K'(d2) between rows row0 .. row0 + R of rows_t
// (d x ld_rows) and the C columns of cols_t (d x ld_cols), both column-major
// with every row up to a tile's start + 128 inside. diag >= 0: rows_t is
// cols_t, row0 == diag, and the diagonal block [diag, diag + R) is formed
// pair-once; diag < 0: ordered tiles. Every column start must be a multiple
// of 4: ld_rows, ld_cols, row0 and diag, and R when columns follow the
// diagonal block. slice: as K1's, one slice is mode (a); in mode (b) scratch
// holds the partial dot tiles (cdiv(d, slice) x tiles x 128^2 floats).
int vgan_kprime_panel(const float* rows_t, int ld_rows, int row0, const float* cols_t,
                      int ld_cols, const float* n_rows, const float* n_cols, const float* bw,
                      int R, int C, int d, int diag, const VganLadder* ladder, int slice,
                      float* scratch, float* kp, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (R < 1 || C < 1 || d < 1 || slice < 1 || slice % dist_tile::BK ||
        ((ld_rows | ld_cols | row0) & 3))
        return invalid();
    if (diag >= 0 && ((diag & 3) || row0 != diag || rows_t != cols_t || diag + R > C ||
                      (diag + R < C && (R & 3))))
        return invalid();
    const Panel p = make_panel(R, C, diag);
    const int blocks = p.tiles(), nslices = cdiv(d, slice);
    if (nslices > 65535) return invalid();
    if (nslices == 1) {
        tile_kernel<false><<<blocks, NT, TILE_SMEM, s>>>(p, rows_t, ld_rows, row0, cols_t, ld_cols,
                                                         d, n_rows, n_cols, bw, 0, *ladder, nullptr,
                                                         kp);
        return static_cast<int>(cudaGetLastError());
    }
    dot_slices_kernel<<<dim3(blocks, nslices), NT, TILE_SMEM, s>>>(p, rows_t, ld_rows, row0, cols_t,
                                                                   ld_cols, d, slice, scratch);
    slices_epilogue_kernel<4, false, true><<<dim3(blocks, 4), NT, 0, s>>>(
        scratch, nslices, p, n_rows, n_cols, bw, 0, *ladder, nullptr, kp);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
