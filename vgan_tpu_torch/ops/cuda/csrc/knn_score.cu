// Fused masked-distance and k-nearest-neighbour score kernels (K6, K7) for
// Hopper (sm_90a), IEEE f32.
//
//   knn_resident_kernel, entry vgan_knn_resident (K6) <- vgan_tpu/ops/pallas/knn_score.py:_knn_kernel
//   knn_kernel,          entry vgan_knn_stream   (K7) <- vgan_tpu/ops/pallas/knn_score.py:_knn_stream_kernel
//
// For every mask m, test row i and train row j:
//
//   d2 = max((an[m][i] + bn[m][j]) - 2 cross, 0),
//   cross = sum_{k in S(m)} xte[i][k] xtr[j][k],
//   an[m][i] = sum_{k in S(m)} xte[i][k]^2,  bn[m][j] = sum_{k in S(m)} xtr[j][k]^2,
//
// S(m) the mask's selected columns in ascending order, with columns j >= ntr,
// and j == i under exclude_self (the query row IS the train row), set to
// +3.0e38. The score of (m, i) is sqrt of the k-th smallest d2 of the row
// ('kth', pyod KNN 'largest') or the mean of the sqrt of the k smallest
// ('mean'). The distances are the JAX expansion in f32 fmaf, never TF32 and
// never a direct (a - b)^2 form; the file must not be built with
// --use_fast_math (sqrtf must stay IEEE).
//
// What bounds them on an H100: the cross products, 2 nt ntr |S(m)| flops per
// mask (4.9e12 for the stress ensemble: 500 masks selecting about 48% of
// d = 10240, 500 x 2000 rows; 3.1e10 for the bench ensemble: 1024 masks of
// about 30 of d = 100 columns, 500 x 1000 rows), at the non-tensor f32 rate
// (67 TFLOP/s). Both kernels do four things about it:
// - It reads only the selected columns. The wrapper hands over each mask's
//   column list (ascending, with its count) and column-major copies of the
//   test and train rows, so a gathered column is one contiguous run of rows.
//   A masked-out column added an exact zero to every sum, so each
//   accumulator adds the same terms in the same order as the full-width
//   masked product would, and the masked norms come out of the same chunks
//   (an on the first train tile, bn on every one) with the rounding of a
//   masked product (x^2 rounded, then added): no norm pre-pass, no masks
//   read.
// - The product is dist_tile.cuh's 128 x 128 tile (8 x 8 outputs a thread,
//   16-column chunks double-buffered through cp.async).
// - A block owns one mask x 128 test rows and streams the train rows in
//   128-row tiles, so the train rows are read nt / 128 times per mask.
// - Each (mask, test row) keeps two sorted k-lists in shared memory, merged
//   at the end. Equal values stay separate entries, so each list is the
//   exact k-smallest multiset of what it was given and the merge that of
//   the row: its k-th entry is the k-th order statistic, as the TPU's tie
//   counter gives, and no indices are needed.
// K6 and K7 are the JAX package's two VMEM regimes (a resident train block
// for small d, a streamed one past it), and each has its kernel:
// - K7 (knn_kernel, large d: about 4,900 selected columns a mask) is
//   product-bound. A train tile's d2 tile goes to shared memory and each
//   list is walked by its own thread over its half of the 128 candidates.
// - K6 (knn_resident_kernel, small d: about 30 selected columns, two
//   16-column chunks a tile) is bound by what surrounds the product: at the
//   bench shape the parent's knn_kernel spent 1.05 ms on products and 2.37
//   ms on selection (examples/torch_knn_probe.py). It keeps one cp.async
//   pipeline running across the train tiles, filters each tile's distances
//   in registers against each row's current k-th value (a bound from the
//   tile's lane minima while the lists fill), and buffers only the
//   candidates below it; no d2 tile. Its scores equal knn_kernel's to the
//   bit: the same arithmetic, and the same k-smallest multiset per row.
//
// Determinism: one block owns each (mask, test tile) output and walks the
// train tiles in order, so there are no atomics and re-runs give identical
// bits. Ragged nt, ntr and d are masked by index (the copies are padded to
// whole tiles with zeros); an all-zero mask has no columns, gives d2 == 0
// everywhere, so its score is 0.
//
// The wrapper makes both kernels' operands (the column-major copies, each
// mask's column list) in one more launch, knn_prep_kernel.
//
// Plain C interface: each entry launches its kernel on the caller's stream
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "dist_tile.cuh"

namespace {

using dist_tile::NT;
constexpr int TM = 8, TN = 8;
constexpr int BT = 16 * TM;  // test rows per block
constexpr int BR = 16 * TN;  // train rows per streamed tile
constexpr int HALF = BR / 2;  // candidates per selecting thread and tile
constexpr int MAX_K = 64;
constexpr float BIG = 3.0e38f;

static_assert(2 * BT == NT, "two selecting threads per test row");

// Shared memory of knn_kernel, in floats: the product pipeline, the d2 tile
// (rows padded to BR + 1 against bank conflicts), the masked norms of the
// tile's test and train rows, and the two k-lists per test row, stored
// [half][slot p][row] so that the threads of a warp touch consecutive words.
constexpr int D2_OFF = dist_tile::smem_floats<TM, TN>();
constexpr int AN_OFF = D2_OFF + BT * (BR + 1);
constexpr int BN_OFF = AN_OFF + BT;
constexpr int L_OFF = BN_OFF + BR;
constexpr int smem_floats(int k) { return L_OFF + 2 * k * BT; }

// The masked norms out of the product's own chunks: threads [0, BR) sum the
// squares of train row tid, threads [BR, 2 BR) on the first train tile those
// of test row tid - BR, in column order.
struct NormHook {
    static constexpr bool kSync = false;
    bool test_rows;
    float sum = 0.f;
    __device__ void chunk(const float* As, const float* Bs, int) {
        const int t = threadIdx.x % BR;
        const float* S = threadIdx.x < BR ? Bs + t : (test_rows ? As + t : nullptr);
        if (S == nullptr) return;
#pragma unroll
        for (int kk = 0; kk < dist_tile::BK; ++kk) {
            const float v = S[kk * BR];
            sum = __fadd_rn(sum, __fmul_rn(v, v));
        }
    }
    template <class Acc>
    __device__ void after(int, int, Acc&) {}
};

// The score of row `row` from its two sorted k-lists in L ([half][slot][row]):
// the lists merged ascending as far as the k-th entry; 'kth' its sqrt,
// 'mean' the mean of the sqrt of the k entries, summed in ascending order as
// the plain version's sorted top-k.
__device__ __forceinline__ void write_score(const float* L, int k, int mean, int row, float* out) {
    const float* L0 = L + row;
    const float* L1 = L + k * BT + row;
    int p0 = 0, p1 = 0;
    float sum = 0.f, v = 0.f;
    for (int p = 0; p < k; ++p) {
        const float u0 = L0[p0 * BT], u1 = L1[p1 * BT];
        if (u0 <= u1) v = u0, ++p0;
        else v = u1, ++p1;
        if (mean) sum += sqrtf(v);
    }
    *out = mean ? sum / (float)k : sqrtf(v);
}

// Block (x, y) owns mask x and test rows [128 y, 128 y + 128); see the top
// of this file. xte_t (d, ld_te) and xtr_t (d, ld_tr) are the column-major
// copies, cols (nm, ld_cols) the column lists, counts (nm,), out (nm, nt).
__global__ void __launch_bounds__(NT, 2)  // two blocks an SM: at most 128 registers
knn_kernel(const float* __restrict__ xte_t, int ld_te, const float* __restrict__ xtr_t, int ld_tr,
           const int* __restrict__ cols, int ld_cols, const int* __restrict__ counts, int nt,
           int ntr, int k, int mean, int exclude_self, float* __restrict__ out) {
    extern __shared__ __align__(16) float smem[];
    float* D2 = smem + D2_OFF;
    float* An = smem + AN_OFF;
    float* Bn = smem + BN_OFF;
    float* L = smem + L_OFF;

    const int tid = threadIdx.x;
    const int m = blockIdx.x, i0 = blockIdx.y * BT;
    const int* mcols = cols + (size_t)m * ld_cols;
    const int count = counts[m];
    for (int idx = tid; idx < 2 * k * BT; idx += NT) L[idx] = BIG;

    for (int j0 = 0; j0 < ntr; j0 += BR) {
        float acc[TM][TN];
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
            for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;
        NormHook norms{j0 == 0};
        dist_tile::product<TM, TN>(dist_tile::Operand{xte_t, ld_te, i0, mcols},
                                   dist_tile::Operand{xtr_t, ld_tr, j0, mcols}, count, smem, acc,
                                   norms);
        if (tid < BR)
            Bn[tid] = norms.sum;
        else if (j0 == 0)
            An[tid - BR] = norms.sum;
        __syncthreads();

        // the d2 tile: (an + bn) - 2 cross, one rounding each, as the plain
        // version's an + bn - 2.0 * cross (2 cross is exact)
#pragma unroll
        for (int r = 0; r < TM; ++r) {
            const int lr = dist_tile::tile_row(r), i = i0 + lr;
            const float a_n = An[lr];
#pragma unroll
            for (int c = 0; c < TN; ++c) {
                const int lc = dist_tile::tile_col(c), j = j0 + lc;
                float v = BIG;
                if (j < ntr && !(exclude_self && i == j))
                    v = fmaxf(fmaf(-2.f, acc[r][c], a_n + Bn[lc]), 0.f);
                D2[lr * (BR + 1) + lc] = v;
            }
        }
        __syncthreads();

        // insertion into this thread's sorted k-list, its half of the
        // candidates in column order
        {
            const int row = tid % BT, h = tid / BT;
            float* Lh = L + h * k * BT + row;
            const float* d2row = D2 + row * (BR + 1);
            const int c1 = min(h * HALF + HALF, ntr - j0);
            float kth = Lh[(k - 1) * BT];
            for (int c = h * HALF; c < c1; ++c) {
                const float v = d2row[c];
                if (v < kth) {
                    int p = k - 1;
                    while (p > 0 && Lh[(p - 1) * BT] > v) {
                        Lh[p * BT] = Lh[(p - 1) * BT];
                        --p;
                    }
                    Lh[p * BT] = v;
                    kth = Lh[(k - 1) * BT];
                }
            }
        }
        __syncthreads();
    }

    if (tid < BT && i0 + tid < nt) write_score(L, k, mean, tid, out + (size_t)m * nt + i0 + tid);
}

// ---------------------------------------------------------------------------
// K6: knn_resident_kernel (the JAX resident regime: few selected columns, a
// train set of at most 8192 rows). See the top of this file.
// ---------------------------------------------------------------------------

constexpr int CAP = 32;    // buffered candidates per (half, row) and round
constexpr int LANES = 16;  // the lanes that share a test row (same ty): half a warp
constexpr int GROUP = 8;   // the lanes of one half of a row (tx / 8)

// Shared memory of knn_resident_kernel, in floats: the product pipeline, the
// masked norms, the candidate buffers [half][slot][row] and their counts
// [half][row], and the two k-lists per test row, [half][slot p][row].
constexpr int R_AN_OFF = dist_tile::smem_floats<TM, TN>();
constexpr int R_BN_OFF = R_AN_OFF + BT;
constexpr int R_BUF_OFF = R_BN_OFF + BR;
constexpr int R_CNT_OFF = R_BUF_OFF + 2 * CAP * BT;
constexpr int R_L_OFF = R_CNT_OFF + 2 * BT;
constexpr int resident_smem_floats(int k) { return R_L_OFF + 2 * k * BT; }

// The row threshold of a thread's row lr: below the k-th entry of both
// lists (a value at or above it cannot be among the row's k smallest).
__device__ __forceinline__ float row_threshold(const float* L, int k, int lr) {
    return fminf(L[(k - 1) * BT + lr], L[k * BT + (k - 1) * BT + lr]);
}

// The k-th smallest (k <= 16) of v over the 16 lanes of a half-warp, ties
// by lane. Every lane of the warp calls it. Behind a call: it runs on a few
// tiles only, and unrolled over a thread's 8 rows it would add hundreds of
// instructions to the kernel.
__device__ __noinline__ float kth_of_lanes(float v, int k) {
    const int tx = threadIdx.x % 16, lane = threadIdx.x % 32;
    int rank = 0;
    for (int q = 0; q < LANES; ++q) {
        const float o = __shfl_sync(0xffffffffu, v, q, LANES);
        rank += (o < v) || (o == v && q < tx);
    }
    const unsigned hit = __ballot_sync(0xffffffffu, rank == k - 1);
    return __shfl_sync(0xffffffffu, v, __ffs((hit >> (lane & LANES)) & 0xffffu) - 1, LANES);
}

// Block (x, y) owns mask x and test rows [128 y, 128 y + 128), as
// knn_kernel, and walks the train tiles with one cp.async pipeline over all
// (tile, chunk) steps: the next tile's first chunk is in flight while a tile
// is selected. Selection keeps the distances in the product's registers:
// each thread compares its 8 x 8 with its rows' thresholds, and only the
// candidates below them go, through a buffer of CAP per (half, row) and
// round, to the row's two sorted k-lists (one thread per list inserts them;
// the d2 tile of knn_kernel and its scan of all 128 candidates per row are
// gone). While a list of the warp's rows is not yet full (its k-th entry
// +3e38), for k <= 16, a row's threshold is also the k-th smallest of its
// 16 lanes' minima on this tile (k distances of the tile are at or below
// it, so no larger one of the tile is among the row's k smallest): about 8
// candidates a list reach the buffer instead of 64.
__global__ void __launch_bounds__(NT, 2)
knn_resident_kernel(const float* __restrict__ xte_t, int ld_te, const float* __restrict__ xtr_t,
                    int ld_tr, const int* __restrict__ cols, int ld_cols,
                    const int* __restrict__ counts, int nt, int ntr, int k, int mean,
                    int exclude_self, float* __restrict__ out) {
    extern __shared__ __align__(16) float smem[];
    float* An = smem + R_AN_OFF;
    float* Bn = smem + R_BN_OFF;
    float* Buf = smem + R_BUF_OFF;
    int* Cnt = reinterpret_cast<int*>(smem + R_CNT_OFF);
    float* L = smem + R_L_OFF;

    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int m = blockIdx.x, i0 = blockIdx.y * BT;
    const int* mcols = cols + (size_t)m * ld_cols;
    const int count = counts[m];
    const int nch = dist_tile::cdiv(count, dist_tile::BK), ntiles = dist_tile::cdiv(ntr, BR);
    const int steps = nch * ntiles;
    for (int idx = tid; idx < 2 * k * BT; idx += NT) L[idx] = BIG;
    constexpr int STAGE = dist_tile::BK * (BT + BR);
    const dist_tile::Operand a{xte_t, ld_te, i0, mcols};
    auto load = [&](int step) {  // chunk step % nch of train tile step / nch
        float* S = smem + (step % dist_tile::STAGES) * STAGE;
        const dist_tile::Operand b{xtr_t, ld_tr, (step / nch) * BR, mcols};
        dist_tile::load_chunk<BT>(a, count, step % nch, S);
        dist_tile::load_chunk<BR>(b, count, step % nch, S + dist_tile::BK * BT);
        dist_tile::cp_async_commit();
    };
    if (steps > 0) load(0);

    int step = 0;
    for (int t = 0; t < ntiles; ++t) {
        const int j0 = t * BR;
        float acc[TM][TN];
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
            for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;
        // the masked norms out of the product's chunks, in column order:
        // threads [0, BR) train row tid, threads [BR, 2 BR) on the first
        // tile test row tid - BR
        float nsum = 0.f;
        for (int c = 0; c < nch; ++c, ++step) {
            if (step + 1 < steps) {
                load(step + 1);
                dist_tile::cp_async_wait<1>();
            } else {
                dist_tile::cp_async_wait<0>();
            }
            __syncthreads();
            const float* As = smem + (step % dist_tile::STAGES) * STAGE;
            const float* Bs = As + dist_tile::BK * BT;
            if (tid < BR || t == 0) {
                const float* S = tid < BR ? Bs + tid : As + tid - BR;
#pragma unroll
                for (int kk = 0; kk < dist_tile::BK; ++kk) {
                    const float v = S[kk * BR];
                    nsum = __fadd_rn(nsum, __fmul_rn(v, v));
                }
            }
#pragma unroll
            for (int kk = 0; kk < dist_tile::BK; ++kk) {
                float av[TM], bv[TN];
#pragma unroll
                for (int g = 0; g < TM / 4; ++g) {
                    const float4 v = *reinterpret_cast<const float4*>(As + kk * BT + g * 64 + ty * 4);
                    av[4 * g] = v.x, av[4 * g + 1] = v.y, av[4 * g + 2] = v.z, av[4 * g + 3] = v.w;
                }
#pragma unroll
                for (int g = 0; g < TN / 4; ++g) {
                    const float4 v = *reinterpret_cast<const float4*>(Bs + kk * BR + g * 64 + tx * 4);
                    bv[4 * g] = v.x, bv[4 * g + 1] = v.y, bv[4 * g + 2] = v.z, bv[4 * g + 3] = v.w;
                }
#pragma unroll
                for (int r = 0; r < TM; ++r)
#pragma unroll
                    for (int cc = 0; cc < TN; ++cc) acc[r][cc] = fmaf(av[r], bv[cc], acc[r][cc]);
            }
            __syncthreads();  // the step after next refills this stage
        }
        if (tid < BR)
            Bn[tid] = nsum;
        else if (t == 0)
            An[tid - BR] = nsum;
        __syncthreads();

        // the distances, in place: (an + bn) - 2 cross, as knn_kernel; then
        // each row's threshold and this thread's candidates below it
        float thr[TM];
        unsigned long long pend = 0ull;  // bit 8 r + c: acc[r][c] not yet buffered
#pragma unroll
        for (int r = 0; r < TM; ++r) {
            const int lr = dist_tile::tile_row(r), i = i0 + lr;
            const float a_n = An[lr];
            float lmin = BIG;
#pragma unroll
            for (int c = 0; c < TN; ++c) {
                const int lc = dist_tile::tile_col(c), j = j0 + lc;
                float v = BIG;
                if (j < ntr && !(exclude_self && i == j))
                    v = fmaxf(fmaf(-2.f, acc[r][c], a_n + Bn[lc]), 0.f);
                acc[r][c] = v;
                lmin = fminf(lmin, v);
            }
            thr[r] = row_threshold(L, k, lr);
            if (k <= LANES && __any_sync(0xffffffffu, thr[r] >= BIG))
                thr[r] = fminf(thr[r], nextafterf(kth_of_lanes(lmin, k), INFINITY));
#pragma unroll
            for (int c = 0; c < TN; ++c)
                if (acc[r][c] < thr[r] && acc[r][c] < BIG) pend |= 1ull << (8 * r + c);
        }

        // rounds: buffer at most CAP candidates per (half, row), insert them,
        // re-read the thresholds and drop what no longer passes
        while (__syncthreads_or(pend != 0ull)) {
            const int h = tx / GROUP, g = tx % GROUP;
#pragma unroll
            for (int r = 0; r < TM; ++r) {
                const unsigned bits = static_cast<unsigned>(pend >> (8 * r)) & 0xffu;
                const int n = __popc(bits);
                int incl = n;  // inclusive prefix over the half's 8 lanes
#pragma unroll
                for (int o = 1; o < GROUP; o *= 2) {
                    const int u = __shfl_up_sync(0xffffffffu, incl, o, GROUP);
                    if (g >= o) incl += u;
                }
                const int lr = dist_tile::tile_row(r);
                int slot = incl - n;
#pragma unroll
                for (int c = 0; c < TN; ++c) {
                    if ((bits >> c) & 1u) {
                        if (slot < CAP) {
                            Buf[(h * CAP + slot) * BT + lr] = acc[r][c];
                            pend &= ~(1ull << (8 * r + c));
                        }
                        ++slot;
                    }
                }
                if (g == GROUP - 1) Cnt[h * BT + lr] = min(incl, CAP);
            }
            __syncthreads();
            {
                // thread (h, row) inserts its buffer into list h of the row
                const int row = tid % BT, hh = tid / BT;
                float* Lh = L + hh * k * BT + row;
                const float* B = Buf + hh * CAP * BT + row;
                const int n = Cnt[hh * BT + row];
                float kth = Lh[(k - 1) * BT];
                for (int s = 0; s < n; ++s) {
                    const float v = B[s * BT];
                    if (v < kth) {
                        int p = k - 1;
                        while (p > 0 && Lh[(p - 1) * BT] > v) {
                            Lh[p * BT] = Lh[(p - 1) * BT];
                            --p;
                        }
                        Lh[p * BT] = v;
                        kth = Lh[(k - 1) * BT];
                    }
                }
            }
            __syncthreads();
#pragma unroll
            for (int r = 0; r < TM; ++r) {
                thr[r] = fminf(thr[r], row_threshold(L, k, dist_tile::tile_row(r)));
#pragma unroll
                for (int c = 0; c < TN; ++c)
                    if (!(acc[r][c] < thr[r])) pend &= ~(1ull << (8 * r + c));
            }
        }
    }

    if (tid < BT && i0 + tid < nt) write_score(L, k, mean, tid, out + (size_t)m * nt + i0 + tid);
}

// ---------------------------------------------------------------------------
// The operands of a K6 or K7 launch, in one launch (knn_score.py
// kernel_operands; its plain version is selected_columns and _column_major):
// blocks [0, nte) copy the test rows x (n, d) to x_t (d, ld) column-major,
// rows n .. ld zero, one dist_tile::transpose_tile each; the next ntr blocks
// the train rows the same way; the rest take
// 8 masks each, one warp a mask, and write its selected columns in
// ascending order (a ballot and a prefix count over 32 columns at a time)
// and their count.
// ---------------------------------------------------------------------------

using dist_tile::TT;

// tile b of x (n, d) into x_t (d, ld), tiles numbered down the rows first
__device__ __forceinline__ void copy_tile(const float* __restrict__ x, int n, int d, int ld, int b,
                                          float* __restrict__ x_t, float (*t)[TT + 1]) {
    const int per = ld / TT;
    dist_tile::transpose_tile(
        [&](int r, int k) { return r < n && k < d ? x[(size_t)r * d + k] : 0.f; },
        (b % per) * TT, (b / per) * TT, d, ld, x_t, t);
}

__global__ void __launch_bounds__(TT * 8)
knn_prep_kernel(const float* __restrict__ xte, int nt, int ld_te, const float* __restrict__ xtr,
                int ntr, int ld_tr, const float* __restrict__ masks, int nm, int d,
                float* __restrict__ xte_t, float* __restrict__ xtr_t, int* __restrict__ cols,
                int* __restrict__ counts) {
    __shared__ float t[TT][TT + 1];
    const int kt = dist_tile::cdiv(d, TT), nte = ld_te / TT * kt, ntrb = ld_tr / TT * kt;
    int b = blockIdx.x;
    if (b < nte) return copy_tile(xte, nt, d, ld_te, b, xte_t, t);
    b -= nte;
    if (b < ntrb) return copy_tile(xtr, ntr, d, ld_tr, b, xtr_t, t);
    b -= ntrb;
    const int m = b * blockDim.y + threadIdx.y, lane = threadIdx.x;
    if (m >= nm) return;
    const float* row = masks + (size_t)m * d;
    int* out = cols + (size_t)m * d;
    int n = 0;
    for (int c0 = 0; c0 < d; c0 += TT) {
        const bool sel = c0 + lane < d && row[c0 + lane] != 0.f;
        const unsigned ball = __ballot_sync(0xffffffffu, sel);
        if (sel) out[n + __popc(ball & ((1u << lane) - 1u))] = c0 + lane;
        n += __popc(ball);
    }
    if (lane == 0) counts[m] = n;
}

using KnnKernel = void (*)(const float*, int, const float*, int, const int*, int, const int*, int,
                          int, int, int, int, float*);

int launch_knn(KnnKernel kernel, size_t bytes, const float* xte_t, int ld_te, const float* xtr_t,
               int ld_tr, const int* cols, const int* counts, int nm, int nt, int ntr, int d, int k,
               int mean, int exclude_self, float* out, cudaStream_t s) {
    if (nm < 1 || nt < 1 || ntr < 1 || d < 1 || k < 1 || k > MAX_K || k > ntr ||
        (exclude_self && k >= ntr) || dist_tile::cdiv(nt, BT) > 65535 ||
        ld_te < dist_tile::cdiv(nt, BT) * BT || ld_tr < dist_tile::cdiv(ntr, BR) * BR ||
        ld_te % 4 || ld_tr % 4)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(nm, dist_tile::cdiv(nt, BT)), NT, bytes, s>>>(
        xte_t, ld_te, xtr_t, ld_tr, cols, d, counts, nt, ntr, k, mean, exclude_self, out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The operands from xte (nt, d), xtr (ntr, d) and the 0/1 masks (nm, d), all
// float32: see knn_prep_kernel. ld_te, ld_tr: nt, ntr rounded up to 128.
int vgan_knn_prep(const float* xte, int nt, int ld_te, const float* xtr, int ntr, int ld_tr,
                  const float* masks, int nm, int d, float* xte_t, float* xtr_t, int* cols,
                  int* counts, void* stream) {
    if (nt < 1 || ntr < 1 || nm < 1 || d < 1 || ld_te < nt || ld_tr < ntr || ld_te % BT ||
        ld_tr % BR)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long kt = dist_tile::cdiv(d, TT);
    const long long blocks = (ld_te / TT + ld_tr / TT) * kt + dist_tile::cdiv(nm, 8);
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    knn_prep_kernel<<<static_cast<unsigned>(blocks), dim3(TT, 8), 0,
                      static_cast<cudaStream_t>(stream)>>>(xte, nt, ld_te, xtr, ntr, ld_tr, masks,
                                                           nm, d, xte_t, xtr_t, cols, counts);
    return static_cast<int>(cudaGetLastError());
}

// xte_t (d, ld_te) and xtr_t (d, ld_tr) float32: the test and train rows,
// column-major, zero-padded to whole 128-row tiles; cols (nm, d) int32: each
// mask's selected columns first, ascending; counts (nm,) int32; out (nm, nt).
int vgan_knn_resident(const float* xte_t, int ld_te, const float* xtr_t, int ld_tr,
                      const int* cols, const int* counts, int nm, int nt, int ntr, int d, int k,
                      int mean, int exclude_self, float* out, void* stream) {
    return launch_knn(knn_resident_kernel, sizeof(float) * resident_smem_floats(k), xte_t, ld_te,
                      xtr_t, ld_tr, cols, counts, nm, nt, ntr, d, k, mean, exclude_self, out,
                      static_cast<cudaStream_t>(stream));
}

int vgan_knn_stream(const float* xte_t, int ld_te, const float* xtr_t, int ld_tr,
                    const int* cols, const int* counts, int nm, int nt, int ntr, int d, int k,
                    int mean, int exclude_self, float* out, void* stream) {
    return launch_knn(knn_kernel, sizeof(float) * smem_floats(k), xte_t, ld_te, xtr_t, ld_tr, cols,
                      counts, nm, nt, ntr, d, k, mean, exclude_self, out,
                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
