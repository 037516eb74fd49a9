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
// (67 TFLOP/s). Both kernels do five things about it:
// - It reads only the selected columns. The wrapper hands over each mask's
//   column list (ascending, with its count) and column-major copies of the
//   test and train rows, so a gathered column is one contiguous run of rows.
//   A masked-out column added an exact zero to every sum, so each
//   accumulator adds the same terms in the same order as the full-width
//   masked product would, and the masked norms come out of the same chunks
//   (an on the first train tile, bn on every one) with the rounding of a
//   masked product (x^2 rounded, then added): no norm pre-pass, no masks
//   read.
// - The product is a 128 x 128 tile, 8 x 8 outputs a thread (dist_tile.cuh's
//   layout), fed by 16-column chunks copied with cp.async.
// - A block owns one mask x 128 test rows and streams the train rows in
//   128-row tiles, so the train rows are read nt / 128 times per mask.
// - Each (mask, test row) keeps two sorted k-lists in shared memory, merged
//   at the end. Equal values stay separate entries, so each list is the
//   exact k-smallest multiset of what it was given and the merge that of
//   the row: its k-th entry is the k-th order statistic, as the TPU's tie
//   counter gives, and no indices are needed.
// - Selection keeps the distances in the product's registers: each thread
//   filters its 8 x 8 against its rows' current k-th values (a bound from
//   the tile's lane minima while the lists fill) and only the candidates
//   below them go, through a small buffer, to the lists; no d2 tile.
// K6 and K7 are the JAX package's two VMEM regimes (a resident train block
// for small d, a streamed one past it), and each has its kernel:
// - K6 (knn_resident_kernel, small d: about 30 selected columns, two
//   16-column chunks a tile) is bound by what surrounds the product: at the
//   bench shape the d2-tile design spent 1.05 ms on products and 2.37 ms on
//   selection (examples/torch_knn_probe.py). It runs dist_tile.cuh's
//   two-stage pipeline across the train tiles.
// - K7 (knn_kernel, large d: about 4,900 selected columns a mask, some 150
//   chunks a train tile) is product-bound, so what the d2 tile freed goes to
//   the feed: 32-column chunks where two blocks an SM fit them (k <= 39;
//   16 past it), double-buffered across the train tiles with one barrier a
//   chunk, each copy's addresses from loop-invariant pointers and its
//   columns fetched a step ahead; a last train tile of at most 64 rows
//   copies and multiplies only that half.
// Their scores are equal to the bit: the same arithmetic, and the same
// k-smallest multiset per row.
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
constexpr int MAX_K = 64;
constexpr float BIG = 3.0e38f;

static_assert(2 * BT == NT, "two selecting threads per test row");

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
// no d2 tile, and no scan of all 128 candidates per row). While a list of the warp's rows is not yet full (its k-th entry
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
// K7: knn_kernel (the JAX streamed regime: thousands of selected columns a
// mask). See the top of this file.
// ---------------------------------------------------------------------------

constexpr int WIDE_BK = 32;           // columns a chunk where two blocks an SM fit them
constexpr int NARROW_BK = 16;         // and past that k
constexpr int STREAM_STAGES = 2;      // the ring: one chunk multiplied while the next lands
constexpr int STREAM_CAP = 8;         // buffered candidates per (half, row) and round
constexpr int SM_SMEM = 233472;       // an SM's shared memory for blocks (228 KB)
constexpr int BLOCK_RESERVED = 1024;  // and what each resident block reserves of it
constexpr int COPY_Q = BT / 4;        // float4s a tile's column
constexpr int COPY_COLS = NT / COPY_Q;  // columns of a chunk the block copies at once
static_assert(BT == BR && NARROW_BK % COPY_COLS == 0, "a chunk is whole columns a warp");

// Shared memory of knn_kernel<bk>, in floats: the ring, the masked norms of
// the test and train rows, the candidate buffers [half][slot][row] and their
// counts [half][row], and the two k-lists per test row, [half][slot p][row].
__host__ __device__ constexpr int stream_smem_floats(int bk, int k) {
    return STREAM_STAGES * bk * (BT + BR) + BT + BR + 2 * STREAM_CAP * BT + 2 * BT + 2 * k * BT;
}

constexpr bool two_blocks_fit(int bk, int k) {
    return 2 * (4 * stream_smem_floats(bk, k) + BLOCK_RESERVED) <= SM_SMEM;
}
static_assert(two_blocks_fit(NARROW_BK, MAX_K), "two blocks an SM at every k");

// The chunk: wide where two blocks an SM fit it at k, else narrow.
int stream_bk(int k) { return two_blocks_fit(WIDE_BK, k) ? WIDE_BK : NARROW_BK; }

// One thread's share of the copies into the ring: columns kk = w + 8 i of
// each chunk (w its warp), float4 q (its lane) of the 128 rows of each, a
// column of a tile being 128 contiguous floats of the column-major copies.
// Loop-invariant pointers, so that a copy costs one 32 x 32 -> 64-bit
// multiply an address; the columns of the next chunk are fetched a step
// ahead.
template <int BK>
struct Feed {
    static constexpr int COPIES = BK / COPY_COLS;  // columns of a chunk a thread copies
    const float* a;   // xte_t + i0 + 4 q: column c at a + c ld_te
    const float* b;   // xtr_t + 4 q: column c of the train tile at j0 at b + c ld_tr + j0
    const int* cols;  // the mask's column list + w
    unsigned ld_te, ld_tr;
    int left;         // the mask's count - w
    int next[COPIES];  // the columns of the next chunk to copy, -1 past the count

    __device__ __forceinline__ void fetch(int c) {
#pragma unroll
        for (int i = 0; i < COPIES; ++i) {
            const int kk = c * BK + i * COPY_COLS;
            next[i] = kk < left ? __ldg(cols + kk) : -1;
        }
    }

    // into S (a stage + w BT + 4 q): [BK][BT] test rows, then [BK][BR]
    // train rows of the tile at j0 where b_rows (false for lanes 16 .. 31 on
    // a half tile, whose rows lie past ntr); a column of -1 zero-filled
    __device__ __forceinline__ void copy(float* S, unsigned j0, bool b_rows) const {
#pragma unroll
        for (int i = 0; i < COPIES; ++i) {
            const bool valid = next[i] >= 0;
            const unsigned long long c = valid ? static_cast<unsigned>(next[i]) : 0u;
            dist_tile::cp_async16(S + i * COPY_COLS * BT, a + c * ld_te, valid);
            if (b_rows)
                dist_tile::cp_async16(S + BK * BT + i * COPY_COLS * BR, b + (c * ld_tr + j0),
                                      valid);
        }
    }
};

// acc += one chunk's products, one fmaf a column in column order, over GN
// groups of four train columns: 2, or 1 on a half tile (columns 64 .. 127
// lie past ntr there).
template <int BK, int GN>
__device__ __forceinline__ void chunk_product(const float* As, const float* Bs,
                                              float (&acc)[TM][TN]) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
        float av[TM], bv[4 * GN];
#pragma unroll
        for (int g = 0; g < TM / 4; ++g) {
            const float4 v = *reinterpret_cast<const float4*>(As + kk * BT + g * 64 + ty * 4);
            av[4 * g] = v.x, av[4 * g + 1] = v.y, av[4 * g + 2] = v.z, av[4 * g + 3] = v.w;
        }
#pragma unroll
        for (int g = 0; g < GN; ++g) {
            const float4 v = *reinterpret_cast<const float4*>(Bs + kk * BR + g * 64 + tx * 4);
            bv[4 * g] = v.x, bv[4 * g + 1] = v.y, bv[4 * g + 2] = v.z, bv[4 * g + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
            for (int c = 0; c < 4 * GN; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
}

// One train tile's selection, knn_resident_kernel's with STREAM_CAP
// candidates per (half, row) and round: the distances formed in place in
// acc, (an + bn) - 2 cross; each row's threshold (below the k-th entry of
// both its lists and, for k <= 16 while a list of the warp's rows is not
// full, just above the k-th smallest of its 16 lanes' minima on the tile);
// the candidates below it inserted in rounds, through Buf, into the row's
// two sorted k-lists, one thread a list.
__device__ __forceinline__ void select_tile(float (&acc)[TM][TN], const float* An, const float* Bn,
                                            float* Buf, int* Cnt, float* L, int k, int i0, int j0,
                                            int ntr, int exclude_self) {
    const int tid = threadIdx.x, tx = tid % 16;
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

    // rounds: buffer at most STREAM_CAP candidates per (half, row), insert
    // them, re-read the thresholds and drop what no longer passes
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
                    if (slot < STREAM_CAP) {
                        Buf[(h * STREAM_CAP + slot) * BT + lr] = acc[r][c];
                        pend &= ~(1ull << (8 * r + c));
                    }
                    ++slot;
                }
            }
            if (g == GROUP - 1) Cnt[h * BT + lr] = min(incl, STREAM_CAP);
        }
        __syncthreads();
        {
            // thread (h, row) inserts its buffer into list h of the row
            const int row = tid % BT, hh = tid / BT;
            float* Lh = L + hh * k * BT + row;
            const float* B = Buf + hh * STREAM_CAP * BT + row;
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

// Block (x, y) owns mask x and test rows [128 y, 128 y + 128), as
// knn_resident_kernel, and walks the train tiles with one ring of
// STREAM_STAGES chunks of BK columns over all (tile, chunk) steps, the next
// tile's first chunk in flight while a tile is selected: one barrier a chunk
// (the chunk has landed for every thread, and the stage multiplied last is
// free for the step STREAM_STAGES - 1 ahead), each copy's columns fetched a
// step ahead. A train tile of at most BR / 2 rows (the last) copies and
// multiplies only that half. A tile's products leave the registers through
// local memory before selection, which keeps ptxas' allocation of the
// product loop apart from selection's (3-6% of the kernel on an H100,
// examples/torch_knn_regime_probe.py --variants).
template <int BK>
__global__ void __launch_bounds__(NT, 2)  // two blocks an SM: at most 128 registers
knn_kernel(const float* __restrict__ xte_t, int ld_te, const float* __restrict__ xtr_t, int ld_tr,
           const int* __restrict__ cols, int ld_cols, const int* __restrict__ counts, int nt,
           int ntr, int k, int mean, int exclude_self, float* __restrict__ out) {
    constexpr int STAGE = BK * (BT + BR);
    extern __shared__ __align__(16) float smem[];
    float* An = smem + STREAM_STAGES * STAGE;
    float* Bn = An + BT;
    float* Buf = Bn + BR;
    int* Cnt = reinterpret_cast<int*>(Buf + 2 * STREAM_CAP * BT);
    float* L = Buf + 2 * STREAM_CAP * BT + 2 * BT;

    const int tid = threadIdx.x;
    const int m = blockIdx.x, i0 = blockIdx.y * BT;
    const int* mcols = cols + (size_t)m * ld_cols;
    const int count = counts[m];
    const int nch = dist_tile::cdiv(count, BK), ntiles = dist_tile::cdiv(ntr, BR);
    for (int idx = tid; idx < 2 * k * BT; idx += NT) L[idx] = BIG;

    // the copy cursor: train tile lt, chunk lc and ring stage ls of the next
    // step to copy, and whether this thread copies train rows there
    const int w = tid / COPY_Q, q = tid % COPY_Q;
    Feed<BK> feed{xte_t + i0 + 4 * q, xtr_t + 4 * q, mcols + w, static_cast<unsigned>(ld_te),
                  static_cast<unsigned>(ld_tr), count - w, {}};
    float* const dst = smem + w * BT + 4 * q;
    int lt = nch > 0 ? 0 : ntiles, lc = 0, ls = 0;
    bool b_rows = ntr > BR / 2 || q < COPY_Q / 2;
    if (lt < ntiles) feed.fetch(0);
    auto copy_next = [&]() {
        if (lt < ntiles) {
            feed.copy(dst + ls * STAGE, lt * BR, b_rows);
            if (++lc == nch) {
                lc = 0;
                ++lt;
                b_rows = ntr - lt * BR > BR / 2 || q < COPY_Q / 2;
            }
            if (lt < ntiles) feed.fetch(lc);
            ls = ls + 1 == STREAM_STAGES ? 0 : ls + 1;
        }
        dist_tile::cp_async_commit();  // a group a step, empty past the last
    };
#pragma unroll
    for (int s = 0; s < STREAM_STAGES - 1; ++s) copy_next();

    int cs = 0;  // the ring stage of the next step to multiply
    for (int t = 0; t < ntiles; ++t) {
        const int j0 = t * BR;
        const bool half = ntr - j0 <= BR / 2;
        float acc[TM][TN];
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
            for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;
        // the masked norms out of the ring's chunks, in column order:
        // threads [0, BR) train row tid, threads [BR, 2 BR) on the first
        // tile test row tid - BR
        float nsum = 0.f;
        for (int c = 0; c < nch; ++c) {
            dist_tile::cp_async_wait<STREAM_STAGES - 2>();  // this step's group has landed
            __syncthreads();
            copy_next();
            const float* As = smem + cs * STAGE;
            const float* Bs = As + BK * BT;
            cs = cs + 1 == STREAM_STAGES ? 0 : cs + 1;
            if (tid < BR || t == 0) {
                const float* S = tid < BR ? Bs + tid : As + tid - BR;
#pragma unroll
                for (int kk = 0; kk < BK; ++kk) {
                    const float v = S[kk * BR];
                    nsum = __fadd_rn(nsum, __fmul_rn(v, v));
                }
            }
            if (half)
                chunk_product<BK, 1>(As, Bs, acc);
            else
                chunk_product<BK, 2>(As, Bs, acc);
        }
        if (tid < BR)
            Bn[tid] = nsum;
        else if (t == 0)
            An[tid - BR] = nsum;
        volatile float spill[TM * TN];  // the products' live range ends here
        float d2[TM][TN];
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
            for (int c = 0; c < TN; ++c) spill[r * TN + c] = acc[r][c];
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
            for (int c = 0; c < TN; ++c) d2[r][c] = spill[r * TN + c];
        __syncthreads();
        select_tile(d2, An, Bn, Buf, Cnt, L, k, i0, j0, ntr, exclude_self);
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
    const bool wide = stream_bk(k) == WIDE_BK;
    return launch_knn(wide ? knn_kernel<WIDE_BK> : knn_kernel<NARROW_BK>,
                      sizeof(float) * stream_smem_floats(wide ? WIDE_BK : NARROW_BK, k), xte_t,
                      ld_te, xtr_t, ld_tr, cols, counts, nm, nt, ntr, d, k, mean, exclude_self, out,
                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
