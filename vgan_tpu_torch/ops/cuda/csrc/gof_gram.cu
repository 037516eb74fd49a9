// Streaming-Gram kernels of the large-m permutation MMD test (K5) for Hopper
// (sm_90a), IEEE f32, in two passes behind one wrapper:
//
//   gram_d2_kernel + ak_kernel  <- vgan_tpu/ops/pallas/gof_gram.py:_ak_kernel
//
// C[q] = A @ K_q for every alpha q, where K_q[j][i] = exp(-alpha_q d2(z_j, z_i))
// with the diagonal (j == i) and the ragged edges (j or i >= m) zeroed by
// global index, d2 = max(-2 z_j . z_i + (n_j + n_i), 0), and A (P, m) holds
// the 0/1 indicator rows.
//
// What bounds it on an H100: the distances of the m (m - 1) / 2 unordered
// pairs, m (m - 1) d flops (3.0e12 at m = 17000, d = 10240), and 2 m^2 P
// n_alphas for the A @ K products (1.2e12 at P = 1002, two alphas), at the
// non-tensor f32 rate (67 TFLOP/s). The TPU kernel recomputed d2 inside its
// A @ K grid, for want of VMEM and of a 16 GB HBM; an 80 GB card holds the
// (m, m) d2 of m = 17000 (1.16 GB), so:
//
// - Pass 1, gram_d2_kernel, forms d2 through dist_tile.cuh's 128 x 128 tile
//   (16-column chunks of the column-major z double-buffered through
//   cp.async) only for the tiles on or above the diagonal, and writes each
//   tile to both its (J, I) and (I, J) places: every unordered pair's
//   distance is formed once, and d2 is exactly symmetric. Past a memory
//   budget (the wrapper's) d2 is formed in row panels instead, every tile of
//   the panel's rows; pairs across panels are then formed twice.
// - Pass 2, ak_kernel, is a product A @ K with K made as each d2 chunk
//   lands in shared memory (exp, and the diagonal and the ragged edges
//   zeroed by index). A block owns a 128 (indicator rows) x 64 (columns)
//   tile of one alpha's C, with the alphas on the grid, so the grid
//   (alphas x ceil(P / 128) x ceil(m / 64)) fills the card. It walks the
//   whole reduction axis and keeps C in registers and its Kahan
//   compensation in shared memory (so that two blocks fit an SM): C is
//   written once, at the end.
//
// Numerics: d2 is the f32 fmaf expansion, never TF32. The A @ K partial of
// every 64 reduction rows is Kahan-added into C with __fadd_rn / __fsub_rn,
// which nvcc neither contracts into FMAs nor reassociates, so C carries
// about one ulp of error however many partials are summed; the file must
// not be built with --use_fast_math. In the panel regime each launch of
// pass 2 starts from the C its predecessor wrote, its compensation from 0:
// one more rounding of C per panel.
//
// Determinism: one block owns each d2 tile pair and each C entry, the
// reduction runs in order, so there are no atomics and re-runs give
// identical bits.
//
// Plain C interface: each entry returns cudaGetLastError() after its launch;
// pointers and the stream come from the caller (ctypes).

#include <cuda_runtime.h>
#include <stddef.h>

#include "dist_tile.cuh"

namespace {

using dist_tile::NT;
constexpr int MAX_ALPHAS = 8;
constexpr int T1 = 8;         // pass 1: 8 x 8 outputs a thread
constexpr int BG = 16 * T1;   // pass 1: a 128 x 128 d2 tile
constexpr int TP = 8, TI = 4; // pass 2: 8 x 4 outputs a thread
constexpr int BP = 16 * TP;   // pass 2: indicator rows of a C tile
constexpr int BI = 16 * TI;   // pass 2: columns of a C tile
constexpr int KAHAN_CHUNKS = 4;  // pass 2: chunks (of 16 rows) per compensated partial

}  // namespace

extern "C" {

struct VganAlphas {
    int n;
    float a[MAX_ALPHAS];
};

}  // extern "C"

namespace {

// Pass 1. symmetric: block b is the b-th tile pair J <= I of the upper
// triangle, written to (J, I) and (I, J). Otherwise block b is tile
// (j_tile0 + b / tiles, b % tiles) of a row panel, written once, at row
// J * 128 - 128 j_tile0 of d2. z_t (d, ld) column-major and norms (ld,)
// zero-padded to whole tiles; d2 has leading dimension ld.
__global__ void __launch_bounds__(NT)
gram_d2_kernel(const float* __restrict__ z_t, const float* __restrict__ norms, int ld, int d,
               int tiles, int symmetric, int j_tile0, float* __restrict__ d2) {
    extern __shared__ __align__(16) float smem[];
    int b = blockIdx.x, J, I;
    if (symmetric) {
        J = 0;
        while (b >= tiles - J) b -= tiles - J++;
        I = J + b;
    } else {
        J = j_tile0 + b / tiles;
        I = b % tiles;
    }
    float acc[T1][T1];
#pragma unroll
    for (int r = 0; r < T1; ++r)
#pragma unroll
        for (int c = 0; c < T1; ++c) acc[r][c] = 0.f;
    dist_tile::NoHook hook;
    dist_tile::product<T1, T1>(dist_tile::Operand{z_t, ld, J * BG, nullptr},
                               dist_tile::Operand{z_t, ld, I * BG, nullptr}, d, smem, acc, hook);
    float nj[T1], ni[T1];
#pragma unroll
    for (int r = 0; r < T1; ++r) {
        nj[r] = norms[J * BG + dist_tile::tile_row(r)];
        ni[r] = norms[I * BG + dist_tile::tile_col(r)];
    }
#pragma unroll
    for (int r = 0; r < T1; ++r)
#pragma unroll
        for (int c = 0; c < T1; ++c) acc[r][c] = fmaxf(fmaf(-2.f, acc[r][c], nj[r] + ni[c]), 0.f);
    const size_t row0 = (size_t)(J - (symmetric ? 0 : j_tile0)) * BG;
    // (J, I): for each row, the thread's columns are runs of four
#pragma unroll
    for (int r = 0; r < T1; ++r) {
        float* dst = d2 + (row0 + dist_tile::tile_row(r)) * ld + (size_t)I * BG;
#pragma unroll
        for (int g = 0; g < T1 / 4; ++g)
            *reinterpret_cast<float4*>(dst + dist_tile::tile_col(4 * g)) = make_float4(
                acc[r][4 * g], acc[r][4 * g + 1], acc[r][4 * g + 2], acc[r][4 * g + 3]);
    }
    if (!symmetric || I == J) return;
    // (I, J): for each column, the thread's rows are runs of four
#pragma unroll
    for (int c = 0; c < T1; ++c) {
        float* dst = d2 + ((size_t)I * BG + dist_tile::tile_col(c)) * ld + (size_t)J * BG;
#pragma unroll
        for (int g = 0; g < T1 / 4; ++g)
            *reinterpret_cast<float4*>(dst + dist_tile::tile_row(4 * g)) = make_float4(
                acc[4 * g][c], acc[4 * g + 1][c], acc[4 * g + 2][c], acc[4 * g + 3][c]);
    }
}

// Pass 2's hook: K from each landed d2 chunk, and the Kahan step of every
// KAHAN_CHUNKS chunks' partial into C (registers) with its compensation
// comp (shared memory, [entry][thread] so that a warp touches consecutive
// words).
struct KernelHook {
    static constexpr bool kSync = true;  // the chunk is rewritten before the product reads it
    float alpha;
    int j0, rows, m, i0;  // the panel's first global row and its row count
    float* comp;
    float c[TP][TI];
    __device__ void chunk(const float*, float* Ks, int ch) {
        for (int idx = threadIdx.x; idx < dist_tile::BK * BI; idx += NT) {
            const int kk = idx / BI, col = idx % BI;
            const int jl = ch * dist_tile::BK + kk, j = j0 + jl, i = i0 + col;
            const bool valid = jl < rows && j < m && i < m && j != i;
            Ks[idx] = valid ? expf(-alpha * Ks[idx]) : 0.f;
        }
    }
    template <class Acc>
    __device__ void after(int ch, int n, Acc& part) {
        if ((ch + 1) % KAHAN_CHUNKS != 0 && ch + 1 != n) return;
        //   y = part - comp; t = c + y; comp = (t - c) - y; c = t
#pragma unroll
        for (int r = 0; r < TP; ++r)
#pragma unroll
            for (int q = 0; q < TI; ++q) {
                float* cp = comp + (r * TI + q) * NT + threadIdx.x;
                const float y = __fsub_rn(part[r][q], *cp);
                const float t = __fadd_rn(c[r][q], y);
                *cp = __fsub_rn(__fsub_rn(t, c[r][q]), y);
                c[r][q] = t;
                part[r][q] = 0.f;
            }
    }
};

// Pass 2. Block (x, y, z) owns columns [64 x, 64 x + 64), indicator rows
// [128 y, 128 y + 128) of alpha z's C, over the reduction rows [j0, j0 +
// rows). a_t (m, ld_a) is A column-major (A[p][j] at a_t[j * ld_a + p]),
// d2 the rows [j0, j0 + rows) of the distances with leading dimension
// ld_d; c is (n_alphas, P, m), read first when accumulate is set.
__global__ void __launch_bounds__(NT, 2)  // two blocks an SM: at most 128 registers
ak_kernel(const float* __restrict__ a_t, int ld_a, const float* __restrict__ d2, int ld_d, int m,
          int P, int j0, int rows, VganAlphas al, int accumulate, float* __restrict__ c) {
    extern __shared__ __align__(16) float smem[];
    const int i0 = blockIdx.x * BI, p0 = blockIdx.y * BP, q = blockIdx.z;
    float* cq = c + (size_t)q * P * m;
    float alpha = al.a[0];  // selected, not indexed: no local copy of the table
#pragma unroll
    for (int t = 1; t < MAX_ALPHAS; ++t)
        if (q == t) alpha = al.a[t];
    float* comp = smem + dist_tile::smem_floats<TP, TI>();
    KernelHook hook{alpha, j0, rows, m, i0, comp};
#pragma unroll
    for (int r = 0; r < TP; ++r) {
        const int p = p0 + dist_tile::tile_row(r);
#pragma unroll
        for (int t = 0; t < TI; ++t) {
            const int i = i0 + dist_tile::tile_col(t);
            hook.c[r][t] = accumulate && p < P && i < m ? cq[(size_t)p * m + i] : 0.f;
            comp[(r * TI + t) * NT + threadIdx.x] = 0.f;
        }
    }
    float part[TP][TI];
#pragma unroll
    for (int r = 0; r < TP; ++r)
#pragma unroll
        for (int t = 0; t < TI; ++t) part[r][t] = 0.f;
    dist_tile::product<TP, TI>(dist_tile::Operand{a_t + (size_t)j0 * ld_a, ld_a, p0, nullptr},
                               dist_tile::Operand{d2, ld_d, i0, nullptr}, rows, smem, part, hook);
#pragma unroll
    for (int r = 0; r < TP; ++r) {
        const int p = p0 + dist_tile::tile_row(r);
        if (p >= P) continue;
#pragma unroll
        for (int t = 0; t < TI; ++t) {
            const int i = i0 + dist_tile::tile_col(t);
            if (i < m) cq[(size_t)p * m + i] = hook.c[r][t];
        }
    }
}

constexpr size_t D2_SMEM = sizeof(float) * dist_tile::smem_floats<T1, T1>();
constexpr size_t AK_SMEM = sizeof(float) * (dist_tile::smem_floats<TP, TI>() + TP * TI * NT);
static_assert(D2_SMEM <= 48 * 1024, "launched without raising the dynamic shared memory limit");

}  // namespace

extern "C" {

// d2 rows of tiles [j_tile0, j_tile0 + n_j_tiles) against all columns, or
// with symmetric set the whole upper triangle mirrored (j_tile0 = 0,
// n_j_tiles = the tile count). z_t (d, ld) float32 column-major and norms
// (ld,), zero-padded to ld = 128 x tiles; d2 (n_j_tiles x 128, ld).
int vgan_gof_gram_d2(const float* z_t, const float* norms, int ld, int d, int symmetric,
                     int j_tile0, int n_j_tiles, float* d2, void* stream) {
    const int tiles = ld / BG;
    if (ld < BG || ld % BG || d < 1 || j_tile0 < 0 || n_j_tiles < 1 ||
        j_tile0 + n_j_tiles > tiles || (symmetric && (j_tile0 || n_j_tiles != tiles)))
        return static_cast<int>(cudaErrorInvalidValue);
    const long long blocks =
        symmetric ? (long long)tiles * (tiles + 1) / 2 : (long long)n_j_tiles * tiles;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    gram_d2_kernel<<<static_cast<unsigned>(blocks), NT, D2_SMEM,
                     static_cast<cudaStream_t>(stream)>>>(z_t, norms, ld, d, tiles, symmetric,
                                                          j_tile0, d2);
    return static_cast<int>(cudaGetLastError());
}

// C[q] (+)= A[:, j0:j0 + rows] @ K_q[j0:j0 + rows, :] for the alphas of the
// table. a_t (m, ld_a) float32, ld_a a multiple of 128 >= P; d2 (rows, ld_d)
// as pass 1 wrote it, ld_d a multiple of 128 >= m; c (alphas->n, P, m).
int vgan_gof_a_times_k(const float* a_t, int ld_a, const float* d2, int ld_d, int m, int P,
                       int j0, int rows, const VganAlphas* alphas, int accumulate, float* c,
                       void* stream) {
    if (m < 1 || P < 1 || rows < 1 || j0 < 0 || j0 + rows > m || alphas->n < 1 ||
        alphas->n > MAX_ALPHAS || ld_a < P || ld_a % BP || ld_d < m || ld_d % BG ||
        dist_tile::cdiv(P, BP) > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(dist_tile::cdiv(m, BI), dist_tile::cdiv(P, BP), alphas->n);
    const cudaError_t err = cudaFuncSetAttribute(
        ak_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(AK_SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
    ak_kernel<<<grid, NT, AK_SMEM, static_cast<cudaStream_t>(stream)>>>(
        a_t, ld_a, d2, ld_d, m, P, j0, rows, *alphas, accumulate, c);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
