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
// and each with a bf16-operand variant (the entries ending in _bf16), the
// same kernels with `gram_matmul_dtype='bfloat16'` (the Pallas kernels' bf16
// z_dot, mmd_gram.py:779): the distance product reads z rounded to bf16 (to
// nearest even) and runs on the tensor cores with f32 accumulators; the
// norms (from the f32 z, by the caller), the ladder, the sums, K' and S are
// the f32 kernels' own code. On an H100 the product's rate is 989 TFLOP/s
// against the CUDA cores' 67, so the bf16 variants are bound by the ladder,
// the epilogues' f32 work and their operands' traffic.
//
// The bf16 variants have a Hopper design of their own, on wgmma_tile.cuh's
// TMA-fed wgmma product. round_rows_kernel writes z rounded to bf16,
// row-major (the K-major layout wgmma reads natively; about 20 us at m =
// 1000, d = 10240, the f32 z read once); TMA reads it through maps whose
// out-of-range rows and columns fill zeros, so no copy is padded.
//
// K1 bf16, K2 bf16 (quadrant_sums_bf16) and K4 bf16 (kprime_panel_bf16):
// one cluster_gram_kernel launch forms every tile, the d axis split over
// the CTAs of a thread-block cluster (at most 8, one CTA an SM, so that the
// tiles x slices fill a wave: ops/cuda/mmd_gram.py cluster_schedule; one
// CTA a tile past half a wave, as on K4's real panels of about 4,170
// tiles). Each CTA stages its partial dot tile in its own shared memory;
// after a cluster barrier each takes 1/S of the tile's rows, adds the S
// partials in slice order through distributed shared memory and runs the
// epilogue below on them, so no partial tile goes to device memory;
// finalize_sums ends K1's and K2's call. At the fits' Grams the product is
// bound by the L2 -> shared traffic of its operand tiles and the epilogue
// by the ladder. (A persistent K4 kernel for the real panels, its CTAs
// sharing a column tile's chunks by TMA multicast and four epilogue warps
// running the ladder during the next tile's product, measured slower than
// one CTA a tile there: 6.35 ms against 5.92.)
//
// K3 bf16 (flash_cluster_kernel): a cluster of c CTAs on a row tile walks
// the column tiles of its split. The CTAs split each dot tile's d chunks
// and add their partials through distributed shared memory; each forms 1/c
// of S's rows (the ladder) and splits each entry into three bf16 terms, hi
// = bf16(S), mid = bf16(S - hi), lo = bf16(S - hi - mid), whose sum is S
// exactly (f32's 24 significant bits in three of 8, f32's exponent range);
// the CTAs exchange their rows, and each multiplies the whole S tile with
// its own 64-column chunks of z_J (the very box the dot tile read, now
// MN-major) on wgmma, three products a k-range, each fragment folded into
// IEEE f32 as the dot product's. The products of bf16 values are exact in
// f32, so S @ z comes out to f32 rounding, as the Pallas kernel's f32 S
// times its upcast bf16 z block; rowsum(S) is summed in f64 beside the
// ladder. The output block stays in registers for the whole walk: no dot
// tile, S tile or per-tile partial goes to device memory.
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
// K1 and K2 (f32) copy z into the column-major, zero-padded layout the tile reads
// (transpose_pad_kernel, d x M, M = m rounded up to 128); K2 always takes
// mode (b)'s passes, as its (m, m) stash does not fit in registers. K4's
// operands come in that layout from the caller (vgan_transpose_pad), who
// makes the column-major copy of z once for all the panels of a backward.
//
// K3 (S @ z and rowsum(S), S = coeff .* K', for padded D <= 2048) is bound
// by its two products, the d2 product and S @ z, at the f32 rate. It forms S
// on the same pipelined tile and epilogue arithmetic as K1 (the ladder behind
// ladder_call<false, true>) and multiplies it with 128-column chunks of
// z_aug = [z | 1 | 0], 8 x 8 outputs a thread: column d of the product is
// rowsum(S). flash_prep_kernel makes both operands from z in one pass (z_t
// column-major for the d2 product, z_aug row-major). The column tiles go in
// runs (splits); split 0 writes sz and rs, each later split its own partial
// (all within FLASH_SPLIT_BYTES), which flash_finalize adds in split order.
// The mode is K1's (mmd_gram.py flash_schedule):
//
// (a) flash_tile_kernel: block (row tile I, split) walks its split's column
//     tiles J; for each it forms the ordered dot tile over all of d, turns
//     it into S in shared memory (64 KB, transposed to the operand layout)
//     and adds S_IJ @ z_aug's chunks, z_aug's rows double-buffered through
//     cp.async, into its own rows of the output in J order (a read-add-write
//     of 128 rows x (d + 1) a tile, about 1/64 byte a flop). Each d2 entry is
//     formed twice (once per ordered tile), and nothing of size m^2 goes to
//     device memory: at m = 40960 the scratch is z's two copies and one
//     split's partial.
// (b) when the tile pairs alone fall short of half a wave (at most one a
//     SM: 132 on an H100, so at most 15 row tiles, m <= 1920):
//     dot_slices_kernel forms each unordered tile pair's partial dot tiles
//     over the d slices (pair-once, at most one wave of them),
//     flash_s_kernel adds them in slice order and writes the S tile and,
//     off the diagonal, its mirror (S is symmetric to the bit), and
//     flash_product_kernel, block (row tile, split, 128-column chunk), adds
//     S_IJ @ z_aug over the split's tiles in registers on one cp.async
//     pipeline and writes its chunk once. Mode (b) keeps the whole padded S
//     in device memory, tiles^2 x 64 KB: bounded by the mode's own limit of
//     15 tiles to about 15 MB, beside the partial dot tiles' 17 MB.
//
// Determinism: thread blocks run in no fixed order, so no float atomics are
// used anywhere. The forward kernels write one (XX, XY, YY) partial per block
// and finalize_sums reduces the partials in a fixed order; mode (b) adds its
// d slices in slice order; the flash backward adds its column tiles in order
// and its splits' partials in split order. Re-runs give identical bits.
//
// Ragged edges are masked in the kernels: rows >= R and columns >= C are not
// stored or summed, and d-chunk entries >= d load as zero.
//
// Plain C interface: every entry returns cudaGetLastError() after its
// launches; pointers and the stream come from the caller (ctypes).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include "dist_tile.cuh"
#include "wgmma_tile.cuh"

namespace {

constexpr int NT = 256;  // threads per block, 16 x 16
constexpr int MAX_MULTS = 8;
constexpr int ST = 8;          // 8 x 8 outputs a thread
constexpr int SB = 16 * ST;    // a 128 x 128 tile
constexpr int SB2 = SB * SB;   // floats of one partial dot tile
using dist_tile::TT;          // transpose tile

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

// z_t[k * ld + r] = z[r * d + k] for r < m, 0 for m <= r < ld (in T).
__global__ void transpose_pad_kernel(const float* __restrict__ z, int m, int d, int ld,
                                     float* __restrict__ z_t) {
    __shared__ float t[TT][TT + 1];
    dist_tile::transpose_tile(
        [&](int r, int k) { return r < m && k < d ? z[(size_t)r * d + k] : 0.f; },
        blockIdx.x * TT, blockIdx.y * TT, d, ld, z_t, t);
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

// ladder_eval's arithmetic, kept behind a call (ladder_call below) so that
// each epilogue keeps one copy of the
// ladder (instruction-cache footprint: inlined into every entry, its integer
// powers unroll into tens of thousands of instructions). The power-of-two
// exponents of a geometric ladder are read off one squaring chain t, t^2,
// t^4, t^8, t^16: int_pow forms t^(2^j) by the same j squarings, so the
// values are equal to the bit, with 4 products an entry instead of 10 and
// no loop (K1 at m = 40960, d = 1024: 48.6 ms against 55.4). Other
// exponents go through int_pow.
template <bool WANT_K, bool WANT_KP>
__device__ __forceinline__ void ladder_body(float d2, float bw, const VganLadder& L, float& k,
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

// The same behind the call. K3 bf16 inlines ladder_body once, in a loop
// over its entries: behind the call its ladder ran at less than half the
// rate (the callee saves and restores its registers every entry).
template <bool WANT_K, bool WANT_KP>
__device__ __noinline__ void ladder_call(float d2, float bw, const VganLadder& L, float& k,
                                         float& kp) {
    ladder_body<WANT_K, WANT_KP>(d2, bw, L, k, kp);
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

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// K1 bf16 and K2 bf16: the tile pairs of the symmetric square on the tensor
// cores (wgmma_tile.cuh), d split inside a thread-block cluster. See the top
// of this file.
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;
namespace W = wgmma_tile;

static_assert(W::CONSUMERS == 2 * NT && W::TILE == SB, "the epilogue's sums pass through NT threads");
// floats of a row of a staged partial tile: a half-warp's float2 stores
// (rows g, g + 1, g + 2, g + 3) fall in distinct banks
constexpr int PPAD = SB + 8;
// the ring (1024-byte aligned by hand: the swizzle's period) and one partial tile
constexpr size_t CLUSTER_SMEM = 1024 + W::RING_BYTES + sizeof(float) * SB * PPAD;

// the column of an unpadded staged tile (rows SB floats apart) where entry
// (r, c) lives: columns XORed by 8 (r % 4), so that a warp's float2 stores of
// wgmma's fragment (eight rows, four column pairs) fall in distinct banks
// two at a time, and four consecutive columns from a multiple of 4 stay
// together
__device__ __forceinline__ int p_col(int r, int c) { return c ^ ((r & 3) << 3); }

// zb[r ld + k] = z[r d + k] rounded to bf16 (to nearest even) for k < d, 0
// for d <= k < ld (ld a multiple of 8): eight values a thread, one 16-byte
// store.
__global__ void __launch_bounds__(NT)
round_rows_kernel(const float* __restrict__ z, int m, int d, int ld, bf16* __restrict__ zb) {
    const int per_row = ld / 8;
    const size_t i = (size_t)blockIdx.x * NT + threadIdx.x;
    if (i >= (size_t)m * per_row) return;
    const int r = static_cast<int>(i / per_row), k = static_cast<int>(i % per_row) * 8;
    const float* src = z + (size_t)r * d + k;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16_rn(k + e < d ? src[e] : 0.f);
    *reinterpret_cast<uint4*>(zb + (size_t)r * ld + k) = *reinterpret_cast<const uint4*>(v);
}

// Q x Q entries at p (rows PPAD apart) into v, or added to v
template <int Q>
__device__ __forceinline__ void load_block(const float* p, bool add, float (&v)[Q][Q]) {
#pragma unroll
    for (int i = 0; i < Q; ++i) {
        float x[Q];
        if constexpr (Q == 4) {
            const float4 t = *reinterpret_cast<const float4*>(p + i * PPAD);
            x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
        } else {
            const float2 t = *reinterpret_cast<const float2*>(p + i * PPAD);
            x[0] = t.x, x[1] = t.y;
        }
#pragma unroll
        for (int j = 0; j < Q; ++j) v[i][j] = add ? v[i][j] + x[j] : x[j];
    }
}

// Cluster b of S CTAs: tile b of the panel p (K1 and K2: the tile pairs of
// the symmetric square; K4: a panel's tiles while they fall short of a
// wave). CTA q forms the tile's partial dot tile over d chunks [q chunks /
// S, (q + 1) chunks / S) on the tensor cores, rows row0 + t.r0 .. of
// rows_map against rows t.c0 .. of cols_map (one copy a stage when
// one_copy, the maps reading one matrix, and the rows are the same), and
// stages it in its own shared memory. Then it takes the tile's Q-row groups
// [q G / S, (q + 1) G / S), G = 128 / Q: for each of their Q x Q blocks a
// consumer thread adds the S CTAs' partials in slice order, read through
// distributed shared memory, and runs the epilogue (K1's sums, Q = 2; K2's
// sums and K', Q = 4; K4's K' alone, Q = 4; K' in runs of four). With SUMS
// the CTA's (XX, XY, YY) partial goes to partials[3 blockIdx.x ..].
template <bool SUMS, bool KP>
__global__ void __launch_bounds__(W::THREADS, 1)
cluster_gram_kernel(const __grid_constant__ CUtensorMap rows_map,
                    const __grid_constant__ CUtensorMap cols_map, const Panel p, int row0,
                    int one_copy, int chunks, const float* __restrict__ n_rows,
                    const float* __restrict__ n_cols, const float* __restrict__ bw_ptr, int n1,
                    VganLadder L, float* __restrict__ partials, float* __restrict__ kp) {
    constexpr int Q = KP ? 4 : 2, G = SB / Q;
    extern __shared__ uint8_t smem_raw[];
    __shared__ W::Barriers bars;
    __shared__ float upper[3][NT];          // the sums of consumer threads NT .. 2 NT
    __shared__ float red[W::THREADS / 32];  // write_sums: warps 8 .. 16 add zeros
    cg::cluster_group cluster = cg::this_cluster();
    const int S = static_cast<int>(cluster.num_blocks()), q = static_cast<int>(cluster.block_rank());
    const TileAt t = p.at(blockIdx.x / S);
    const bool same = one_copy && row0 + t.r0 == t.c0;
    uint8_t* ring = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                               ~static_cast<uintptr_t>(1023));
    float* P = reinterpret_cast<float*>(ring + W::RING_BYTES);
    const int k0 = q * chunks / S, n = (q + 1) * chunks / S - k0;
    if (threadIdx.x == 0) W::init(bars);
    __syncthreads();
    if (threadIdx.x < W::CONSUMERS) {
        float acc[W::ACC];
#pragma unroll
        for (int i = 0; i < W::ACC; ++i) acc[i] = 0.f;
        W::consume(n, same, ring, bars, acc);
#pragma unroll
        for (int i = 0; i < W::ACC; i += 2)
            *reinterpret_cast<float2*>(P + W::acc_row(i) * PPAD + W::acc_col(i)) =
                make_float2(acc[i], acc[i + 1]);
    } else {
        W::produce(&rows_map, row0 + t.r0, &cols_map, t.c0, same, k0, n, ring, bars);
    }
    __syncwarp();
    cluster.sync();  // every partial of the tile is staged
    float s[3] = {0.f, 0.f, 0.f};
    if (threadIdx.x < W::CONSUMERS) {
        const float bw = *bw_ptr;
        const int g0 = q * G / S, blocks = ((q + 1) * G / S - g0) * G;
        for (int e = threadIdx.x; e < blocks; e += W::CONSUMERS) {
            const int rl = Q * (g0 + e / G), cl = Q * (e % G);
            float v[Q][Q];
            for (int r = 0; r < S; ++r)
                load_block<Q>(cluster.map_shared_rank(P, r) + rl * PPAD + cl, r > 0, v);
            int rows[Q], cols[Q];
#pragma unroll
            for (int i = 0; i < Q; ++i) rows[i] = t.r0 + rl + i, cols[i] = t.c0 + cl + i;
            epilogue<Q, SUMS, KP>(v, rows, cols, t, p, n_rows, n_cols, bw, n1, L, s, kp);
        }
        if (SUMS && threadIdx.x >= NT)
#pragma unroll
            for (int k = 0; k < 3; ++k) upper[k][threadIdx.x - NT] = s[k], s[k] = 0.f;
    }
    if constexpr (SUMS) {
        __syncthreads();
        if (threadIdx.x < NT)
#pragma unroll
            for (int k = 0; k < 3; ++k) s[k] += upper[k][threadIdx.x];
        write_sums(s, red, partials, blockIdx.x);
    }
    cluster.sync();  // no CTA leaves while another reads its partial
}

// acc = the 128 x 128 dot tile of a_t's rows ra .. and b_t's rows rb .. over
// k < count (column-major operands), in dist_tile's f32 tile layout.
__device__ __forceinline__ void dot_tile(const float* a_t, int lda, int ra, const float* b_t,
                                         int ldb, int rb, int count, void* smem,
                                         float (&acc)[ST][ST]) {
#pragma unroll
    for (int r = 0; r < ST; ++r)
#pragma unroll
        for (int c = 0; c < ST; ++c) acc[r][c] = 0.f;
    dist_tile::NoHook hook;
    dist_tile::product<ST, ST>(dist_tile::Operand{a_t, lda, ra, nullptr},
                               dist_tile::Operand{b_t, ldb, rb, nullptr}, count,
                               static_cast<float*>(smem), acc, hook);
}

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
    dot_tile(a_t, lda, row0 + t.r0, b_t, ldb, t.c0, d, smem, acc);
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
    dot_tile(a_t + k0 * lda, lda, row0 + t.r0, b_t + k0 * ldb, ldb, t.c0, min(slice, d - (int)k0),
             smem, acc);
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

// ---------------------------------------------------------------------------
// K3: S @ z and rowsum(S), S = coeff .* K'(d2), no m^2 buffer. See the top
// of this file.
// ---------------------------------------------------------------------------

// What a K3 launch works on. z_t (d x ld) is z column-major (the distance
// operands); z_aug (ld x ldz) is z row-major with a column of ones at d and
// zeros to ldz, a multiple of 128 (the S @ z operand: column d of S @ z_aug
// is rowsum(S)). The column tiles of the square are split into nsplit runs
// of `per` tiles; split 0 adds its run's S @ z_aug straight into sz and rs,
// split s > 0 into partial s - 1 ((ld x ldz) each), which flash_finalize
// adds to sz and rs in split order.
struct Flash {
    const float* z_t;
    const float* z_aug;
    const float* norms;
    int m, d, n1, ld, ldz, tiles, per;
    float cxx, cyy, cxy;
};

// the product's pipeline, then one S tile (St)
__host__ __device__ constexpr size_t flash_smem() {
    return TILE_SMEM + sizeof(float) * SB2;
}

// The S entry of rows j (the tile's row, a z row of the column tile) and i
// from its d2: K' through ladder_call, times the quadrant's coefficient, 0
// outside the m x m square.
__device__ __forceinline__ float s_entry(float d2, int j, int i, const Flash& f, float bw,
                                         const VganLadder& L) {
    float k, kp;
    ladder_call<false, true>(d2, bw, L, k, kp);
    const bool jx = j < f.n1, ix = i < f.n1;
    const float coeff = (jx && ix) ? f.cxx : ((!jx && !ix) ? f.cyy : f.cxy);
    return (i < f.m && j < f.m) ? coeff * kp : 0.f;
}

// d2 of the thread's entries acc[r][c] = z_j . z_i, j = J 128 + tile_row(r),
// i = I 128 + tile_col(c), as K1's epilogue forms it, stored transposed to
// the product's operand layout, St[j - J 128][i - I 128]: each thread's four
// consecutive i go out as one 16-byte store, and the 16 threads of a row
// fill 64 consecutive words. No call here, so the 64 dots are not live
// across one.
__device__ __forceinline__ void d2_tile(const float (&acc)[ST][ST], int I, int J, const Flash& f,
                                        float* St) {
#pragma unroll
    for (int g = 0; g < ST; g += 4) {  // four columns at a time: few norms live
        float ni[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int i = I * SB + dist_tile::tile_col(g + q);
            ni[q] = i < f.m ? f.norms[i] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < ST; ++r) {
            const int jl = dist_tile::tile_row(r), j = J * SB + jl;
            const float nj = j < f.m ? f.norms[j] : 0.f;
            float v[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) v[q] = fmaxf(fmaf(-2.f, acc[r][g + q], ni[q] + nj), 0.f);
            *reinterpret_cast<float4*>(St + jl * SB + dist_tile::tile_col(g)) =
                make_float4(v[0], v[1], v[2], v[3]);
        }
    }
}

// One 16-row step of S @ z_aug: out[r][c] += sum over kk < 16 of
// As[kk][tile_row(r)] Bs[kk][tile_col(c)], As a chunk of an S tile [j][i]
// and Bs one of z_aug's rows, both [16][128] in shared memory.
__device__ __forceinline__ void s_z_step(const float* As, const float* Bs, float (&out)[ST][ST]) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int kk = 0; kk < dist_tile::BK; ++kk) {
        float av[ST], bv[ST];
#pragma unroll
        for (int g = 0; g < ST / 4; ++g) {
            const float4 v = *reinterpret_cast<const float4*>(As + kk * SB + g * 64 + ty * 4);
            av[4 * g] = v.x, av[4 * g + 1] = v.y, av[4 * g + 2] = v.z, av[4 * g + 3] = v.w;
        }
#pragma unroll
        for (int g = 0; g < ST / 4; ++g) {
            const float4 v = *reinterpret_cast<const float4*>(Bs + kk * SB + g * 64 + tx * 4);
            bv[4 * g] = v.x, bv[4 * g + 1] = v.y, bv[4 * g + 2] = v.z, bv[4 * g + 3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < ST; ++r)
#pragma unroll
            for (int q = 0; q < ST; ++q) out[r][q] = fmaf(av[r], bv[q], out[r][q]);
    }
}

// out[r][c] += sum over the column tile's rows k of St[k][tile_row(r)]
// z_aug[J 128 + k][c0 + tile_col(c)]: St, one S tile [j][i], stays in shared
// memory; z_aug's 16-row chunks are double-buffered through cp.async into
// Zs (2 x 16 x 128 floats). count: the tile's valid rows. Ends with a
// barrier.
__device__ __forceinline__ void s_times_z(const float* St, const Flash& f, int J, int c0,
                                          int count, float* Zs, float (&out)[ST][ST]) {
    const dist_tile::Operand b{f.z_aug + (size_t)J * SB * f.ldz, f.ldz, c0, nullptr};
    const int n = dist_tile::cdiv(count, dist_tile::BK);
    dist_tile::load_chunk<SB>(b, count, 0, Zs);
    dist_tile::cp_async_commit();
    for (int c = 0; c < n; ++c) {
        const float* Bs = Zs + (c % 2) * dist_tile::BK * SB;
        if (c + 1 < n) {
            dist_tile::load_chunk<SB>(b, count, c + 1, Zs + ((c + 1) % 2) * dist_tile::BK * SB);
            dist_tile::cp_async_commit();
            dist_tile::cp_async_wait<1>();
        } else {
            dist_tile::cp_async_wait<0>();
        }
        __syncthreads();
        const float* As = St + c * dist_tile::BK * SB;
        s_z_step(As, Bs, out);
        __syncthreads();  // the next chunk's load refills this buffer
    }
}

// A thread's 8 x 8 of rows I 128 + tile_row(r), columns c0 + tile_col(c) of
// S @ z_aug from split s: to sz and rs (s == 0), or to partial s - 1
// ((ld x ldz) row-major, 16-byte runs). add: add to what is there (a later
// column tile of the split), else store.
__device__ __forceinline__ void emit(const float (&v)[ST][ST], const Flash& f, int I, int c0,
                                     int s, bool add, float* __restrict__ P,
                                     float* __restrict__ sz, float* __restrict__ rs) {
#pragma unroll
    for (int r = 0; r < ST; ++r) {
        const int i = I * SB + dist_tile::tile_row(r);
        if (i >= f.m) continue;
        float* prow = P + ((size_t)(s - 1) * f.ld + i) * f.ldz;
        float* zrow = sz + (size_t)i * f.d;
#pragma unroll
        for (int g = 0; g < ST; g += 4) {
            const int col = c0 + dist_tile::tile_col(g);
            if (s > 0) {
                float4* p = reinterpret_cast<float4*>(prow + col);
                float4 o = make_float4(v[r][g], v[r][g + 1], v[r][g + 2], v[r][g + 3]);
                if (add) {
                    const float4 w = *p;
                    o = make_float4(w.x + o.x, w.y + o.y, w.z + o.z, w.w + o.w);
                }
                *p = o;
                continue;
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                if (col + q < f.d)
                    zrow[col + q] = add ? zrow[col + q] + v[r][g + q] : v[r][g + q];
                else if (col + q == f.d)
                    rs[i] = add ? rs[i] + v[r][g + q] : v[r][g + q];
            }
        }
    }
}

// K3's operands from z in one pass: z_aug (ld x ldz) = z, a column of ones
// at d (rows below m) and zeros; z_t (d x ld) = z column-major, rows m .. ld
// zero. One 32 x 32 tile of z_aug a block, written as it is read; its
// columns below d go on to z_t through the transpose.
__global__ void flash_prep_kernel(const float* __restrict__ z, int m, int d, int ld, int ldz,
                                  float* __restrict__ z_t, float* __restrict__ z_aug) {
    __shared__ float t[TT][TT + 1];
    dist_tile::transpose_tile(
        [&](int r, int k) {
            const float v = r < m ? (k < d ? z[(size_t)r * d + k] : (k == d ? 1.f : 0.f))
                                  : 0.f;
            z_aug[(size_t)r * ldz + k] = v;
            return v;
        },
        blockIdx.x * TT, blockIdx.y * TT, d, ld, z_t, t);
}

// Mode (a)'s two halves of a column tile, each behind a call (inlined
// together into the kernel's loop they passed 128 registers and spilled):
// the 128 x 128 dot tile of rows J and I over all of d on dist_tile's
// pipeline, its d2 into St;
__device__ __noinline__ void flash_d2(const Flash f, int I, int J, float* smem, float* St) {
    float acc[ST][ST];
    dot_tile(f.z_t, f.ld, J * SB, f.z_t, f.ld, I * SB, f.d, smem, acc);
    d2_tile(acc, I, J, f, St);
}

// S in place of d2 in St (thread t the words t, t + 256, ...: conflict-free,
// and one value live across each ladder call);
__device__ __noinline__ void flash_s(const Flash f, int I, int J, float bw, const VganLadder& L,
                                     float* St) {
    for (int e = threadIdx.x; e < SB2; e += NT)
        St[e] = s_entry(St[e], J * SB + e / SB, I * SB + e % SB, f, bw, L);
}

// and one 128-column chunk of S @ z_aug, added to the block's rows.
__device__ __noinline__ void flash_chunk(const Flash f, const float* St, int I, int J, int c0, int s,
                                         bool add, float* Zs, float* P, float* sz, float* rs) {
    float out[ST][ST];
#pragma unroll
    for (int r = 0; r < ST; ++r)
#pragma unroll
        for (int c = 0; c < ST; ++c) out[r][c] = 0.f;
    s_times_z(St, f, J, c0, min(SB, f.m - J * SB), Zs, out);
    emit(out, f, I, c0, s, add, P, sz, rs);
}

// Mode (a): block (I, s) walks the column tiles J of split s. For each: the
// dot tile and its d2 (flash_d2), S in place (flash_s), then S @ z_aug in
// 128-column chunks (flash_chunk), each added to the block's own rows of
// its output in J order (no other block touches them).
__global__ void __launch_bounds__(NT, 2)  // two blocks an SM: at most 128 registers
flash_tile_kernel(const Flash f, const float* __restrict__ bw_ptr, VganLadder L,
                  float* __restrict__ P, float* __restrict__ sz, float* __restrict__ rs) {
    extern __shared__ __align__(16) float smem[];
    float* St = smem + TILE_SMEM / sizeof(float);
    const int I = blockIdx.x, s = blockIdx.y;
    const float bw = *bw_ptr;
    const int J0 = s * f.per, J1 = min(f.tiles, J0 + f.per);
    for (int J = J0; J < J1; ++J) {
        flash_d2(f, I, J, smem, St);
        __syncthreads();
        flash_s(f, I, J, bw, L, St);
        __syncthreads();
        for (int c0 = 0; c0 < f.ldz; c0 += SB) flash_chunk(f, St, I, J, c0, s, J > J0, smem, P, sz, rs);
    }
}

// Mode (b), pass 2: block (b, q) forms the S entries of tile pair b (J <= I,
// dot_slices_kernel's b-th block over the symmetric square) at thread t's
// slots e = FLASH_S_SLOTS q .. + FLASH_S_SLOTS - 1: the entry (tile_row(e / 8),
// tile_col(e % 8)) of thread t, whose nslices partial dots lie at e 256 + t
// of each slice's tile (coalesced), added in slice order. S(j, i) goes to S
// tile (J, I) at [j - J 128][i - I 128] and, for J < I, as S(i, j) (S is
// symmetric to the bit: the dot, the norms' sum and the coefficient are) to
// tile (I, J) at [i - I 128][j - J 128]: the operand layout of pass 3.
constexpr int FLASH_S_SLOTS = 4;  // 16 blocks a tile pair: the ladder is latency-bound

__global__ void __launch_bounds__(NT)
flash_s_kernel(const Flash f, const float* __restrict__ dots, int nslices,
               const float* __restrict__ bw_ptr, VganLadder L, float* __restrict__ S_tiles) {
    const int b = blockIdx.x, t = threadIdx.x;
    int J, I;
    tile_pair(b, f.tiles, J, I);
    const float bw = *bw_ptr;
    const size_t stride = (size_t)gridDim.x * SB2;  // one slice's tiles to the next
    const float* src = dots + (size_t)b * SB2 + t;
    float* to = S_tiles + (size_t)(J * f.tiles + I) * SB2;
    float* mirror = S_tiles + (size_t)(I * f.tiles + J) * SB2;
    const int e0 = blockIdx.y * FLASH_S_SLOTS;
    for (int e = e0; e < e0 + FLASH_S_SLOTS; ++e) {
        float v = src[e * NT];
        for (int sl = 1; sl < nslices; ++sl) v += src[sl * stride + e * NT];
        const int jl = (e / ST / 4) * 64 + (t / 16) * 4 + (e / ST) % 4;  // tile_row(e / 8)
        const int il = (e % ST / 4) * 64 + (t % 16) * 4 + e % 4;         // tile_col(e % 8)
        const int j = J * SB + jl, i = I * SB + il;
        const float nj = j < f.m ? f.norms[j] : 0.f, ni = i < f.m ? f.norms[i] : 0.f;
        const float sv = s_entry(fmaxf(fmaf(-2.f, v, ni + nj), 0.f), j, i, f, bw, L);
        to[jl * SB + il] = sv;
        if (I != J) mirror[il * SB + jl] = sv;
    }
}

// Mode (b), pass 3: block (I, s, c) owns rows I, split s and output columns
// [128 c, 128 c + 128): the sum over the split's column tiles J of S tile
// (J, I) times z_aug's chunk, in registers, on one cp.async pipeline over
// all (J, 16-row chunk) steps of the split (the next tile's first chunk is
// in flight while a tile ends); it goes out once.
__global__ void __launch_bounds__(NT, 2)
flash_product_kernel(const Flash f, const float* __restrict__ S_tiles, float* __restrict__ P,
                     float* __restrict__ sz, float* __restrict__ rs) {
    extern __shared__ __align__(16) float smem[];
    constexpr int CH = SB / dist_tile::BK;  // 16-row chunks of a column tile
    constexpr int STAGE = dist_tile::BK * 2 * SB;
    const int I = blockIdx.x, s = blockIdx.y, c0 = blockIdx.z * SB;
    const int J0 = s * f.per, steps = (min(f.tiles, J0 + f.per) - J0) * CH;
    float out[ST][ST];
#pragma unroll
    for (int r = 0; r < ST; ++r)
#pragma unroll
        for (int c = 0; c < ST; ++c) out[r][c] = 0.f;
    auto load = [&](int step) {  // chunk step % CH of column tile J0 + step / CH
        const int J = J0 + step / CH, count = min(SB, f.m - J * SB);
        float* S = smem + (step % dist_tile::STAGES) * STAGE;
        dist_tile::load_chunk<SB>(dist_tile::Operand{S_tiles + (size_t)(J * f.tiles + I) * SB2, SB, 0,
                                                     nullptr},
                                  count, step % CH, S);
        dist_tile::load_chunk<SB>(dist_tile::Operand{f.z_aug + (size_t)J * SB * f.ldz, f.ldz, c0,
                                                     nullptr},
                                  count, step % CH, S + dist_tile::BK * SB);
        dist_tile::cp_async_commit();
    };
    load(0);
    for (int step = 0; step < steps; ++step) {
        if (step + 1 < steps) {
            load(step + 1);
            dist_tile::cp_async_wait<1>();
        } else {
            dist_tile::cp_async_wait<0>();
        }
        __syncthreads();
        const float* As = smem + (step % dist_tile::STAGES) * STAGE;
        const float* Bs = As + dist_tile::BK * SB;
        s_z_step(As, Bs, out);
        __syncthreads();  // the step after next refills this stage
    }
    emit(out, f, I, c0, s, false, P, sz, rs);
}

// sz[i][k] += P[s][i][k] and rs[i] += P[s][i][d] for the nsplit - 1 partials,
// in split order.
__global__ void __launch_bounds__(NT)
flash_finalize(const float* __restrict__ P, int nsplit, int m, int d, int ld, int ldz,
               float* __restrict__ sz, float* __restrict__ rs) {
    const size_t n = (size_t)m * (d + 1);
    for (size_t e = (size_t)blockIdx.x * NT + threadIdx.x; e < n; e += (size_t)gridDim.x * NT) {
        const int i = static_cast<int>(e / (d + 1)), k = static_cast<int>(e % (d + 1));
        const float* p = P + (size_t)i * ldz + k;
        float* o = k < d ? sz + (size_t)i * d + k : rs + i;
        float t = *o;
        for (int s = 0; s + 1 < nsplit; ++s) t += p[(size_t)s * ld * ldz];
        *o = t;
    }
}

// ---------------------------------------------------------------------------
// K3 bf16: S @ z and rowsum(S) on the tensor cores, the S tile formed once a
// column tile by a thread-block cluster. See the top of this file.
// ---------------------------------------------------------------------------

// What a K3 bf16 launch works on: z rounded to bf16 (zmap), the f32 rows'
// norms, its m rows in tiles of 128 and its d columns in `chunks` 64-column
// chunks, of which a cluster's output takes a group of at most FC_GROUP;
// the column tiles in nsplit runs of `per`; the coefficients of S.
struct FlashC {
    const float* norms;
    int m, d, n1, tiles, per, nsplit, chunks;
    float cxx, cyy, cxy;
};

constexpr int FC_GROUP = 16;                     // output chunks a cluster: two a CTA, eight CTAs
constexpr int FC_BOX = SB * W::WBK * 2;          // one 128-row box of 64 bf16 columns, 16 KB
// Ibuf (2 boxes), Zbuf (2 boxes), S's three bf16 terms (2 boxes each) and
// the partial dot tile (128 x 128 f32), after the 1024-byte alignment
constexpr size_t FLASH_CLUSTER_SMEM = 1024 + 10 * FC_BOX + sizeof(float) * SB2;

// byte offset of element (i, j) of a 128 x 64 K-major box under the 128-byte
// swizzle (TMA's and wgmma's layout): the 16-byte unit j / 8 of row i moves
// to unit (j / 8) ^ (i % 8)
__device__ __forceinline__ int swizzled(int i, int j) {
    return i * 128 + ((((j * 2) >> 4) ^ (i & 7)) << 4) + ((j * 2) & 15);
}

// s = hi + mid + lo exactly, each rounded to bf16 from what the previous
// left (f32 has 24 significant bits, bf16 8; exact while lo is normal, |s|
// above about 2^-110). ops/cuda/mmd_gram.py split_bf16x3 is the plain
// version.
__device__ __forceinline__ void split_bf16x3(float s, bf16& hi, bf16& mid, bf16& lo) {
    hi = __float2bfloat16_rn(s);
    const float r1 = s - __bfloat162float(hi);
    mid = __float2bfloat16_rn(r1);
    lo = __float2bfloat16_rn(r1 - __bfloat162float(mid));
}

// Cluster (I, s, g) of c CTAs (gridDim.x / c clusters, I fastest) owns row
// tile I, the column tiles of split s and output chunk group g. CTA q takes
// chunks [q n / c, (q + 1) n / c) of the dot products (n = chunks) and of
// its group's output chunks; with one group (chunks <= 16, c = chunks / 2
// rounded up) the two ranges are the same, at most two chunks, and row tile
// I's chunks stay in Ibuf for the whole walk. For each column tile J:
//  1. the partial dot tile over its chunks, J's chunks in Zbuf, each chunk's
//     fragment folded into P in IEEE f32 (wgmma_tile.cuh's accumulation);
//  2. (cluster barrier) its rows [q 128 / c, (q + 1) 128 / c) of S: the c
//     partials added in rank order through distributed shared memory, d2,
//     the ladder, the coefficient; each entry split into three bf16 terms
//     and stored to the Sbuf of every CTA of the cluster (K-major under the
//     swizzle), and the row's sum, in f64 (its x and y columns' terms
//     cancel to a small rowsum), added to rs_acc in J order (one warp a
//     row, a fixed butterfly);
//  3. (cluster barrier: every CTA holds the whole S tile) S @ z_J over its
//     output chunks: warpgroup g takes rows 64 (g % 2)
//     and chunk g / 2, A each term of S, B the chunk of z_J in Zbuf read
//     MN-major (the same box serves both products), each (term, 64-row
//     half of J) a fragment from zero folded into the accumulators `out`,
//     which stay in registers for the whole walk.
// Then out goes to sz (split 0) or the split's partial, rs_acc to rs (group
// 0 only). No dot tile, S tile or partial output goes to device memory.
// rowsum(S) is summed beside the ladder rather than taken from a column of
// ones beside z: at d = 1024 that column would be a 17th chunk, one CTA
// past the 8 of a portable cluster.
__global__ void __launch_bounds__(W::CONSUMERS, 1)
flash_cluster_kernel(const __grid_constant__ CUtensorMap zmap, const FlashC f,
                     const float* __restrict__ bw_ptr, VganLadder L, float* __restrict__ part,
                     float* __restrict__ sz, float* __restrict__ rs) {
    extern __shared__ uint8_t smem_raw[];
    __shared__ uint64_t bar_i, bar_z;
    __shared__ double rs_acc[SB];  // rowsum(S) of this CTA's rows, in J order
    cg::cluster_group cluster = cg::this_cluster();
    const int c = static_cast<int>(cluster.num_blocks()), q = static_cast<int>(cluster.block_rank());
    int cl = blockIdx.x / c;
    const int I = cl % f.tiles;
    cl /= f.tiles;
    const int split = cl % f.nsplit, grp = cl / f.nsplit;
    uint8_t* Ibuf = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                               ~static_cast<uintptr_t>(1023));
    uint8_t* Zbuf = Ibuf + 2 * FC_BOX;
    uint8_t* Sbuf = Ibuf + 4 * FC_BOX;  // term t, half h of J at (2 t + h) FC_BOX
    float* P = reinterpret_cast<float*>(Ibuf + 10 * FC_BOX);
    const int tid = threadIdx.x, g = tid / 128, warp = tid / 32, lane = tid % 32;
    const int d0 = q * f.chunks / c, d1 = (q + 1) * f.chunks / c;
    const int gbase = grp * FC_GROUP, gn = min(FC_GROUP, f.chunks - gbase);
    const int o0 = gbase + q * gn / c, o1 = gbase + (q + 1) * gn / c;
    const bool resident = f.chunks <= FC_GROUP;  // then [o0, o1) == [d0, d1)
    const int rb = q * SB / c, re = (q + 1) * SB / c;  // this CTA's rows of S
    const float bw = *bw_ptr;
    if (tid == 0) {
        W::mbar_init(&bar_i, 1);
        W::mbar_init(&bar_z, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if (tid < SB) rs_acc[tid] = 0.0;
    __syncthreads();
    int loads_i = 0, loads_z = 0;  // TMA loads into Ibuf and Zbuf so far
    auto load = [&](uint8_t* buf, uint64_t* bar, int row, int k0, int k1) {
        if (tid == 0) {
            W::mbar_expect_tx(bar, (k1 - k0) * FC_BOX);
            for (int k = k0; k < k1; ++k)
                W::tma_load(buf + (k - k0) * FC_BOX, &zmap, bar, k * W::WBK, row);
        }
    };
    float out[W::ACC], frag[W::ACC];
#pragma unroll
    for (int i = 0; i < W::ACC; ++i) out[i] = 0.f;
    if (resident) load(Ibuf, &bar_i, I * SB, d0, d1), ++loads_i;
    const int J0 = split * f.per, J1 = min(f.tiles, J0 + f.per);
    for (int J = J0; J < J1; ++J) {
        // 1. the partial dot tile, two chunks at a time
        for (int k = d0; k < d1; k += 2) {
            const int k1 = min(d1, k + 2);
            if (!resident) load(Ibuf, &bar_i, I * SB, k, k1), ++loads_i;
            load(Zbuf, &bar_z, J * SB, k, k1), ++loads_z;
            W::mbar_wait(&bar_i, (loads_i - 1) & 1);
            W::mbar_wait(&bar_z, (loads_z - 1) & 1);
            for (int kk = 0; kk < k1 - k; ++kk) {
                const uint64_t da = W::smem_desc(Ibuf + kk * FC_BOX + (g % 2) * 64 * 128),
                               db = W::smem_desc(Zbuf + kk * FC_BOX + (g / 2) * 64 * 128);
                W::wgmma_fence();
                W::wgmma_m64n64k16_fresh(frag, da, db);
                W::wgmma_m64n64k16<1>(frag, da + 2, db + 2);
                W::wgmma_m64n64k16<1>(frag, da + 4, db + 4);
                W::wgmma_m64n64k16<1>(frag, da + 6, db + 6);
                W::wgmma_commit();
                W::wgmma_wait_all();
                W::fence_operands(frag);
                const bool first = k == d0 && kk == 0;
#pragma unroll
                for (int i = 0; i < W::ACC; i += 2) {
                    const int r = W::acc_row(i);
                    float2* pp = reinterpret_cast<float2*>(P + r * SB + p_col(r, W::acc_col(i)));
                    const float2 o = first ? make_float2(0.f, 0.f) : *pp;
                    *pp = make_float2(o.x + frag[i], o.y + frag[i + 1]);
                }
            }
            __syncthreads();  // Ibuf and Zbuf are read
        }
        if (!resident && o1 > o0) load(Zbuf, &bar_z, J * SB, o0, o1), ++loads_z;
        cluster.sync();  // every CTA's partial dot tile is staged
        // 2. this CTA's rows of S
        for (int r = rb + warp; r < re; r += W::CONSUMERS / 32) {
            const int i = I * SB + r, jl = 4 * lane;
            float dot[4];
            for (int pc = 0; pc < c; ++pc) {
                const float4 v = W::ld_cluster(W::cluster_addr(P + r * SB + p_col(r, jl), pc));
                dot[0] = pc ? dot[0] + v.x : v.x, dot[1] = pc ? dot[1] + v.y : v.y;
                dot[2] = pc ? dot[2] + v.z : v.z, dot[3] = pc ? dot[3] + v.w : v.w;
            }
            const float ni = i < f.m ? f.norms[i] : 0.f;
            const bool ix = i < f.n1;
            double row_sum = 0.0;  // in f64: a row's terms cancel across the quadrants
            __align__(8) bf16 terms[3][4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int j = J * SB + jl + e;
                const float nj = j < f.m ? f.norms[j] : 0.f;
                const float d2 = fmaxf(fmaf(-2.f, dot[e], ni + nj), 0.f);
                float k, kpv;
                ladder_body<false, true>(d2, bw, L, k, kpv);
                const bool jx = j < f.n1;
                const float coeff = (jx && ix) ? f.cxx : ((!jx && !ix) ? f.cyy : f.cxy);
                const float sv = (i < f.m && j < f.m) ? coeff * kpv : 0.f;
                row_sum += static_cast<double>(sv);
                split_bf16x3(sv, terms[0][e], terms[1][e], terms[2][e]);
            }
            const int off = (jl / 64) * FC_BOX + swizzled(r, jl % 64);
            for (int pc = 0; pc < c; ++pc)  // to every CTA's Sbuf, this one's first
#pragma unroll
                for (int t = 0; t < 3; ++t)
                    W::st_cluster(W::cluster_addr(Sbuf + 2 * t * FC_BOX + off, (q + pc) % c),
                                  *reinterpret_cast<const uint2*>(terms[t]));
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) row_sum += __shfl_xor_sync(0xffffffffu, row_sum, o);
            if (lane == 0) rs_acc[r] += row_sum;
        }
        asm volatile("fence.proxy.async;\n" ::: "memory");  // the Sbufs, for wgmma
        cluster.sync();  // every CTA holds the whole S tile; P is read
        // 3. S @ z_J over this CTA's output chunks
        if (!resident && o1 > o0) W::mbar_wait(&bar_z, (loads_z - 1) & 1);
        if (o0 + g / 2 < o1) {
            const uint8_t* zc = Zbuf + (g / 2) * FC_BOX;
#pragma unroll 1
            for (int h = 0; h < 2; ++h)
                for (int t = 0; t < 3; ++t) {
                    const uint8_t* a = Sbuf + (2 * t + h) * FC_BOX + (g % 2) * 64 * 128;
                    const uint64_t da = W::smem_desc(a), db = W::smem_desc_mn(zc + h * 64 * 128);
                    W::wgmma_fence();
                    W::wgmma_m64n64k16_fresh<1>(frag, da, db);
                    W::wgmma_m64n64k16<1, 1>(frag, da + 2, db + 128);
                    W::wgmma_m64n64k16<1, 1>(frag, da + 4, db + 256);
                    W::wgmma_m64n64k16<1, 1>(frag, da + 6, db + 384);
                    W::wgmma_commit();
                    W::wgmma_wait_all();
                    W::fence_operands(frag);
#pragma unroll
                    for (int i = 0; i < W::ACC; ++i) out[i] += frag[i];
                }
        }
        __syncthreads();  // Zbuf and Sbuf are read
    }
    if (o0 + g / 2 < o1)
#pragma unroll
        for (int i = 0; i < W::ACC; ++i) {
            const int row = I * SB + W::acc_row(i), col = o0 * W::WBK + W::acc_col(i);
            if (row < f.m && col < f.d) {
                if (split == 0) sz[(size_t)row * f.d + col] = out[i];
                else part[((size_t)(split - 1) * f.m + row) * (f.d + 1) + col] = out[i];
            }
        }
    if (grp == 0)
        for (int r = rb + tid; r < re; r += W::CONSUMERS) {
            const int i = I * SB + r;
            if (i >= f.m) continue;
            const float v = static_cast<float>(rs_acc[r]);
            if (split == 0) rs[i] = v;
            else part[((size_t)(split - 1) * f.m + i) * (f.d + 1) + f.d] = v;
        }
    cluster.sync();  // no CTA leaves while another may read its shared memory
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

inline int invalid() { return static_cast<int>(cudaErrorInvalidValue); }

// floats of scratch that z's column-major copy (d x ld) takes
size_t zt_floats(int d, int ld) {
    return (size_t)d * ld;
}

// K1 (kp == nullptr) and K2 over the symmetric square of z (m, d), in f32.
// scratch, in this order: z_t (d x M, M = m rounded up to 128); in mode (a)
// (K1 with one slice) the sums' partials (3 x P, P = T (T + 1) / 2 tile
// pairs of T = M / 128 tiles); in mode (b) the partial dot tiles (cdiv(d,
// slice) x P x 128^2) and the sums' partials (3 x 4 P for K2, 3 x 16 P for
// K1: the epilogue's blocks a tile pair).
int quadrant_sums(const float* z, const float* norms, const float* bw, int m, int d, int n1,
                  const VganLadder* ladder, int slice, float* scratch, float* sums, float* kp,
                  cudaStream_t s) {
    if (m < 1 || d < 1 || slice < 1 || slice % dist_tile::BK) return invalid();
    const Panel p = make_panel(m, m, 0);
    const int ld = p.rows * SB, blocks = p.tiles(), nslices = cdiv(d, slice);
    if (nslices > 65535 || cdiv(d, TT) > 65535) return invalid();
    float* z_t = scratch;
    float* dots = scratch + zt_floats(d, ld);
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

// cuTensorMapEncodeTiled, a CUDA entry outside the runtime, looked up through
// the runtime's entry-point query (nothing links libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static const EncodeTiled fn = [] {
        void* f = nullptr;
        cudaDriverEntryPointQueryResult found;
        const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                                 cudaEnableDefault, &found);
        return err == cudaSuccess && found == cudaDriverEntryPointSuccess
                   ? reinterpret_cast<EncodeTiled>(f)
                   : nullptr;
    }();
    return fn;
}

// A kernel's dynamic shared memory limit raised to `bytes`, once a device
template <auto KERNEL>
cudaError_t allow_smem(size_t bytes) {
    static std::atomic<unsigned long long> raised{0};  // a bit a device
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
    if (raised.load() & bit) return cudaSuccess;
    err = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err == cudaSuccess) raised.fetch_or(bit);
    return err;
}

// The TMA map of a row-major bf16 matrix of `rows` x d (row stride ld
// values, a multiple of 8), box 64 columns x box_rows rows, under the
// 128-byte swizzle; reads past the edges fill zeros.
int encode_rows(CUtensorMap* map, const bf16* x, int rows, int d, int ld, int box_rows) {
    const EncodeTiled encode = encode_tiled();
    if (!encode) return static_cast<int>(cudaErrorSymbolNotFound);
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * sizeof(bf16)};
    const cuuint32_t box[2] = {W::WBK, static_cast<cuuint32_t>(box_rows)}, unit[2] = {1, 1};
    if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(x), dims, strides, box,
               unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return invalid();
    return 0;
}

// z (m, d) rounded to bf16 into zb (m x ld): round_rows_kernel.
int round_rows(const float* z, int m, int d, int ld, bf16* zb, cudaStream_t s) {
    if (m < 1 || d < 1 || ld < d || ld % 8) return invalid();
    const size_t blocks = ((size_t)m * (ld / 8) + NT - 1) / NT;
    if (blocks > INT_MAX) return invalid();
    round_rows_kernel<<<static_cast<int>(blocks), NT, 0, s>>>(z, m, d, ld, zb);
    return static_cast<int>(cudaGetLastError());
}

// cudaLaunchKernelEx of `kernel` in clusters of `cluster` CTAs
template <class Kernel, class... Args>
cudaError_t launch_clusters(Kernel kernel, long long grid, int threads, size_t smem, int cluster,
                            cudaStream_t s, Args... args) {
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(grid));
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// K1 bf16 (kp == nullptr) and K2 bf16 over the symmetric square of z (m,
// d): round_rows_kernel, cluster_gram_kernel (`slices` CTAs a tile pair,
// 1 <= slices <= 8 and at most the 64-column chunks of d), finalize_sums.
// scratch, in this order: zb (m x ld bf16, ld = d rounded up to 8), the
// sums' partials (3 x slices x P, P tile pairs).
template <bool KP>
int quadrant_sums_bf16(const float* z, const float* norms, const float* bw, int m, int d, int n1,
                       const VganLadder* ladder, int slices, float* scratch, float* sums, float* kp,
                       cudaStream_t s) {
    const int chunks = cdiv(d, W::WBK), ld = cdiv(d, 8) * 8;
    if (m < 1 || d < 1 || slices < 1 || slices > 8 || slices > chunks) return invalid();
    const Panel p = make_panel(m, m, 0);
    const long long grid = (long long)p.tiles() * slices;
    if (grid > INT_MAX) return invalid();
    bf16* zb = reinterpret_cast<bf16*>(scratch);
    float* partials = scratch + (size_t)m * ld / 2;
    CUtensorMap map;
    int rc = encode_rows(&map, zb, m, d, ld, SB);
    if (rc) return rc;
    cudaError_t err = allow_smem<cluster_gram_kernel<true, KP>>(CLUSTER_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    if ((rc = round_rows(z, m, d, ld, zb, s))) return rc;
    err = launch_clusters(cluster_gram_kernel<true, KP>, grid, W::THREADS, CLUSTER_SMEM, slices, s,
                          map, map, p, 0, 1, chunks, norms, norms, bw, n1, *ladder, partials, kp);
    if (err != cudaSuccess) return static_cast<int>(err);
    finalize_sums<<<1, NT, 0, s>>>(partials, static_cast<int>(grid), sums);
    return static_cast<int>(cudaGetLastError());
}

// K4 bf16: see vgan_kprime_panel_bf16.
int kprime_panel_bf16(const bf16* rows_b, int row0, const bf16* cols_b, int ld,
                      const float* n_rows, const float* n_cols, const float* bw, int R, int C,
                      int d, int diag, const VganLadder* ladder, int slices, float* kp,
                      cudaStream_t s) {
    const int chunks = cdiv(d, W::WBK);
    if (R < 1 || C < 1 || d < 1 || ld < d || ld % 8 || slices < 1 || slices > 8 || slices > chunks)
        return invalid();
    if (diag >= 0 && ((diag & 3) || row0 != diag || rows_b != cols_b || diag + R > C ||
                      (diag + R < C && (R & 3))))
        return invalid();
    if (diag < 0 && row0 != 0) return invalid();
    const Panel p = make_panel(R, C, diag);
    const long long grid = (long long)p.tiles() * slices;
    if (grid > INT_MAX) return invalid();
    CUtensorMap cols_map, rows_map;
    int rc = encode_rows(&cols_map, cols_b, C, d, ld, SB);
    if (rc) return rc;
    if (diag < 0 && (rc = encode_rows(&rows_map, rows_b, R, d, ld, SB))) return rc;
    cudaError_t err = allow_smem<cluster_gram_kernel<false, true>>(CLUSTER_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch_clusters(cluster_gram_kernel<false, true>, grid, W::THREADS, CLUSTER_SMEM, slices, s,
                          diag >= 0 ? cols_map : rows_map, cols_map, p, row0, diag >= 0 ? 1 : 0,
                          chunks, n_rows, n_cols, bw, 0, *ladder, static_cast<float*>(nullptr), kp);
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// K3 bf16: see vgan_gram_backward_flash_bf16.
int backward_flash_bf16(const float* z, const float* norms, const float* bw, int m, int d, int n1,
                        float cxx, float cyy, float cxy, const VganLadder* ladder, int cluster,
                        int nsplit, float* scratch, float* sz, float* rs, cudaStream_t s) {
    const int chunks = cdiv(d, W::WBK), tiles = cdiv(m, SB), ld = cdiv(d, 8) * 8;
    const int groups = cdiv(chunks, FC_GROUP);
    if (m < 1 || d < 1 || nsplit < 1 || nsplit > tiles ||
        cluster != (groups == 1 ? cdiv(chunks, 2) : 8))
        return invalid();
    const int per = cdiv(tiles, nsplit);
    if (cdiv(tiles, per) != nsplit) return invalid();
    const long long grid = (long long)tiles * nsplit * groups * cluster;
    if (grid > INT_MAX) return invalid();
    bf16* zb = reinterpret_cast<bf16*>(scratch);
    float* part = scratch + (size_t)m * ld / 2;
    CUtensorMap map;
    int rc = encode_rows(&map, zb, m, d, ld, SB);
    if (rc) return rc;
    cudaError_t err = allow_smem<flash_cluster_kernel>(FLASH_CLUSTER_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    if ((rc = round_rows(z, m, d, ld, zb, s))) return rc;
    const FlashC f{norms, m, d, n1, tiles, per, nsplit, chunks, cxx, cyy, cxy};
    err = launch_clusters(flash_cluster_kernel, grid, W::CONSUMERS, FLASH_CLUSTER_SMEM, cluster, s,
                          map, f, bw, *ladder, part, sz, rs);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (nsplit > 1) {
        const size_t n = (size_t)m * (d + 1);
        flash_finalize<<<static_cast<int>(std::min<size_t>((n + NT - 1) / NT, 4096)), NT, 0, s>>>(
            part, nsplit, m, d, m, d + 1, sz, rs);
    }
    return static_cast<int>(cudaGetLastError());
}

// K3: see vgan_gram_backward_flash.
int backward_flash(const float* z, const float* norms, const float* bw, int m, int d, int n1,
                   float cxx, float cyy, float cxy, const VganLadder* ladder, int slice, int nsplit,
                   float* scratch, float* sz, float* rs, cudaStream_t s) {
    const int tiles = cdiv(m, SB), ld = tiles * SB, ldz = cdiv(d + 1, SB) * SB;
    if (m < 1 || d < 1 || slice < 1 || (slice < d && slice % dist_tile::BK) || nsplit < 1 ||
        nsplit > tiles || ldz / TT > 65535)
        return invalid();
    const int per = cdiv(tiles, nsplit), nslices = cdiv(d, slice);
    if (cdiv(tiles, per) != nsplit || nslices > 65535) return invalid();
    float* z_t = scratch;
    float* z_aug = scratch + zt_floats(d, ld);
    float* dots = z_aug + (size_t)ld * ldz;
    float* P = dots + (nslices > 1 ? (size_t)nslices * (tiles * (tiles + 1) / 2) * SB2 : 0);
    const Flash f{z_t, z_aug, norms, m, d, n1, ld, ldz, tiles, per, cxx, cyy, cxy};
    flash_prep_kernel<<<dim3(ld / TT, ldz / TT), dim3(TT, 8), 0, s>>>(z, m, d, ld, ldz, z_t, z_aug);
    if (nslices == 1) {
        cudaError_t err = cudaFuncSetAttribute(flash_tile_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(flash_smem()));
        if (err != cudaSuccess) return static_cast<int>(err);
        flash_tile_kernel<<<dim3(tiles, nsplit), NT, flash_smem(), s>>>(f, bw, *ladder, P, sz, rs);
    } else {
        float* S_tiles = P;
        P = S_tiles + (size_t)tiles * tiles * SB2;
        const Panel p = make_panel(m, m, 0);  // the tile pairs J <= I
        dot_slices_kernel<<<dim3(p.tiles(), nslices), NT, TILE_SMEM, s>>>(p, z_t, ld, 0, z_t, ld, d,
                                                                           slice, dots);
        flash_s_kernel<<<dim3(p.tiles(), ST * ST / FLASH_S_SLOTS), NT, 0, s>>>(f, dots, nslices, bw,
                                                                              *ladder, S_tiles);
        flash_product_kernel<<<dim3(tiles, nsplit, ldz / SB), NT, TILE_SMEM, s>>>(f, S_tiles, P, sz,
                                                                                 rs);
    }
    if (nsplit > 1) {
        const size_t n = (size_t)m * (d + 1);
        flash_finalize<<<static_cast<int>(std::min<size_t>((n + NT - 1) / NT, 4096)), NT, 0, s>>>(
            P, nsplit, m, d, ld, ldz, sz, rs);
    }
    return static_cast<int>(cudaGetLastError());
}

int transpose_pad(const float* z, int n, int d, int ld, float* z_t, cudaStream_t s) {
    if (n < 1 || d < 1 || ld < n || ld % TT || cdiv(d, TT) > 65535) return invalid();
    transpose_pad_kernel<<<dim3(ld / TT, cdiv(d, TT)), dim3(TT, 8), 0, s>>>(z, n, d, ld, z_t);
    return static_cast<int>(cudaGetLastError());
}

// K4: see vgan_kprime_panel.
int kprime_panel(const float* rows_t, int ld_rows, int row0, const float* cols_t, int ld_cols,
                 const float* n_rows, const float* n_cols, const float* bw, int R, int C, int d,
                 int diag, const VganLadder* ladder, int slice, float* scratch, float* kp,
                 cudaStream_t s) {
    const int align = 3;  // column starts of float4 copies
    if (R < 1 || C < 1 || d < 1 || slice < 1 || slice % dist_tile::BK ||
        ((ld_rows | ld_cols | row0) & align))
        return invalid();
    if (diag >= 0 && ((diag & align) || row0 != diag || rows_t != cols_t || diag + R > C ||
                      (diag + R < C && (R & align))))
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
    dot_slices_kernel<<<dim3(blocks, nslices), NT, TILE_SMEM, s>>>(
        p, rows_t, ld_rows, row0, cols_t, ld_cols, d, slice, scratch);
    slices_epilogue_kernel<4, false, true><<<dim3(blocks, 4), NT, 0, s>>>(
        scratch, nslices, p, n_rows, n_cols, bw, 0, *ladder, nullptr, kp);
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

// K3. slice: the d columns of one slice of the dot pass, a positive multiple
// of 16, or d itself for mode (a) (no dot pass); nsplit: the column splits
// (1 <= nsplit <= the column tiles, each split per = cdiv(tiles, nsplit)
// tiles). scratch, in this order: z_t (d x M, M = m rounded up to 128),
// z_aug (M x D1, D1 = d + 1 rounded up to 128), in mode (b) the partial dot
// tiles (cdiv(d, slice) x tiles (tiles + 1) / 2 x 128^2) and the S tiles
// (tiles^2 x 128^2), and with nsplit > 1 the partials of splits 1 .. nsplit - 1
// ((nsplit - 1) x M x D1). ops/cuda/mmd_gram.py flash_schedule picks slice and
// nsplit and flash_scratch_floats sizes the scratch.
int vgan_gram_backward_flash(const float* z, const float* norms, const float* bw, int m,
                             int d, int n1, float cxx, float cyy, float cxy,
                             const VganLadder* ladder, int slice, int nsplit, float* scratch,
                             float* sz, float* rs, void* stream) {
    return backward_flash(z, norms, bw, m, d, n1, cxx, cyy, cxy, ladder, slice, nsplit,
                                 scratch, sz, rs, static_cast<cudaStream_t>(stream));
}

// z (n, d) to z_t (d, ld) column-major, rows n .. ld zero (ld >= n, a
// multiple of 32): K4's operands.
int vgan_transpose_pad(const float* z, int n, int d, int ld, float* z_t, void* stream) {
    return transpose_pad(z, n, d, ld, z_t, static_cast<cudaStream_t>(stream));
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
    return kprime_panel(rows_t, ld_rows, row0, cols_t, ld_cols, n_rows, n_cols, bw, R, C, d,
                               diag, ladder, slice, scratch, kp, static_cast<cudaStream_t>(stream));
}

// The bf16-operand variants. K1 bf16 and K2 bf16 take the arguments of K1
// and K2 but `slices`, the CTAs of a cluster (see quadrant_sums_bf16 for it
// and the scratch): z f32, rounded on the card; the norms from the f32 z.
int vgan_gram_quadrant_sums_bf16(const float* z, const float* norms, const float* bw, int m,
                                 int d, int n1, const VganLadder* ladder, int slices,
                                 float* scratch, float* sums, void* stream) {
    return quadrant_sums_bf16<false>(z, norms, bw, m, d, n1, ladder, slices, scratch, sums, nullptr,
                                     static_cast<cudaStream_t>(stream));
}

int vgan_gram_quadrant_sums_stash_bf16(const float* z, const float* norms, const float* bw,
                                       int m, int d, int n1, const VganLadder* ladder, int slices,
                                       float* scratch, float* sums, float* kp, void* stream) {
    if (!kp) return invalid();
    return quadrant_sums_bf16<true>(z, norms, bw, m, d, n1, ladder, slices, scratch, sums, kp,
                                    static_cast<cudaStream_t>(stream));
}

// K3 bf16: K3's arguments but `cluster`, the CTAs of a cluster (half the
// 64-column chunks of d, rounded up, while they are at most 16; else 8 and
// the chunks in groups of 16), and nsplit, the runs of column tiles (as
// K3's). scratch, in this order: zb (m x ld bf16, ld = d rounded up to 8)
// and with nsplit > 1 the partials of splits 1 .. nsplit - 1 ((nsplit - 1)
// x m x (d + 1)). ops/cuda/mmd_gram.py flash_cluster_schedule picks cluster
// and nsplit and flash_bf16_scratch_floats sizes the scratch.
int vgan_gram_backward_flash_bf16(const float* z, const float* norms, const float* bw, int m,
                                  int d, int n1, float cxx, float cyy, float cxy,
                                  const VganLadder* ladder, int cluster, int nsplit, float* scratch,
                                  float* sz, float* rs, void* stream) {
    return backward_flash_bf16(z, norms, bw, m, d, n1, cxx, cyy, cxy, ladder, cluster, nsplit,
                               scratch, sz, rs, static_cast<cudaStream_t>(stream));
}

// z (m, d) rounded to bf16 (to nearest even) into zb (m x ld, row-major, ld
// >= d a multiple of 8, columns d .. ld zero): K4 bf16's operands.
int vgan_round_rows_bf16(const float* z, int m, int d, int ld, bf16* zb, void* stream) {
    return round_rows(z, m, d, ld, zb, static_cast<cudaStream_t>(stream));
}

// K4 bf16: the (R, C) panel kp of K'(d2) between rows row0 .. row0 + R of
// rows_b and the C rows of cols_b, both from vgan_round_rows_bf16 with row
// stride ld. diag >= 0: rows_b is cols_b, row0 == diag, and the diagonal
// block [diag, diag + R) is formed pair-once (diag, and R when columns
// follow the block, multiples of 4); diag < 0: ordered tiles, row0 0. One
// cluster of `slices` CTAs a tile (1 to 8, at most the 64-column chunks of
// d), d split over them. No scratch. ops/cuda/mmd_gram.py
// panel_bf16_schedule picks slices.
int vgan_kprime_panel_bf16(const bf16* rows_b, int row0, const bf16* cols_b, int ld,
                           const float* n_rows, const float* n_cols, const float* bw, int R, int C,
                           int d, int diag, const VganLadder* ladder, int slices, float* kp,
                           void* stream) {
    return kprime_panel_bf16(rows_b, row0, cols_b, ld, n_rows, n_cols, bw, R, C, d, diag, ladder,
                             slices, kp, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
