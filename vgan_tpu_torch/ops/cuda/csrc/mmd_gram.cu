// Multi-bandwidth RBF MMD Gram kernels for Hopper (sm_90a), IEEE f32.
//
// Four kernels, each replacing one Pallas TPU kernel of
// vgan_tpu/ops/pallas/mmd_gram.py:
//
//   fwd_kernel           <- _fwd_kernel           quadrant sums XX, XY, YY
//   fwd_stash (K2)       <- _fwd_stash_kernel     quadrant sums + K'(d2) (m, m):
//                           transpose_pad_kernel, stash_dot_kernel,
//                           stash_epilogue_kernel
//   flash_bwd_kernel     <- _flash_bwd_kernel     S @ z and rowsum(S), no m^2 buffer
//                           (+ sum_splits, the fixed-order sum of its partials)
//   kprime_panel_kernel  <- _kprime_panel_kernel  (R, C) K'(d2) panel
//
// fwd_kernel, flash_bwd_kernel and kprime_panel_kernel share one tile body,
// gram_tile: a 64 x 64 block of squared distances d2 = |zi|^2 + |zj|^2 -
// 2 zi . zj, accumulated over 16-wide d-chunks staged in shared memory (each
// of 256 threads owns a 4 x 4 register micro-tile and accumulates with fmaf,
// never TF32), then clamped at 0 and pushed through the bandwidth ladder: one
// expf plus integer powers for a geometric ladder (ops.mmd.ladder_exponents),
// one expf per bandwidth otherwise.
//
// What bounds them on an H100: the distance product. At the stress shape
// (m = 1000 rows, d = 10240) the forward needs the m (m - 1) / 2 unordered
// pairs' dot products, 1.02e10 flops on 41 MB of input: bound by the
// non-tensor f32 rate (67 TFLOP/s). gram_tile forms every ordered pair (twice
// the work) and stages its chunks through registers, so it reaches a fraction
// of that rate; the flash backward does twice the forward's work (the d2
// tile, then S @ z).
//
// K2 (the stash forward, every step of a wide no-kl fit) is built instead on
// dist_tile.cuh's pipelined 128 x 128 tile (8 x 8 outputs a thread, 16-column
// chunks double-buffered with cp.async), in three passes:
//
// - transpose_pad_kernel copies z into the column-major, zero-padded layout
//   that tile reads (d x M, M = m rounded up to 128);
// - stash_dot_kernel: block (b, s) forms the dot products of tile pair b
//   (row tile J <= column tile I, the upper triangle) over d slice s, and
//   writes its partial tile to scratch. Every unordered pair is formed once
//   (the diagonal tiles in full). At m = 1000 there are only 36 tile pairs,
//   so the summed d axis is split into slices (multiples of the 16-column
//   chunk) until pairs x slices fill the card (the wrapper's stash_slices:
//   7 slices, 252 blocks, two an SM);
// - stash_epilogue_kernel: per quarter of a tile pair (four blocks a pair),
//   the slices' partials added in slice order, d2 = max(-2 dot + (|zi|^2 + |zj|^2), 0) (symmetric in i and
//   j), the ladder, K' written to (r, c) and to (c, r), so the stash is
//   exactly symmetric, and the block's (XX, XY, YY) partial: an off-diagonal
//   tile pair stands for both orientations, so its XX and YY entries count
//   twice and its XY entries (row < n1 <= col) once; a diagonal tile counts
//   each entry once, as gram_tile's masks do.
//
// Determinism: thread blocks run in no fixed order, so no float atomics are
// used anywhere. The forward kernels write one (XX, XY, YY) partial per block
// and finalize_sums reduces the partials in a fixed order; the stash forward
// adds its d slices in slice order; the flash backward gives each block sole
// ownership of its rows of one partial sz / rs and sum_splits adds the
// partials in split order. Re-runs give identical bits.
//
// The flash backward layout: the Pallas kernel holds a full-D (tile_i x D)
// sz accumulator in VMEM, which does not fit Hopper's 227 KB of shared memory
// at D = 2048. Here block (i, s) owns a 64-row block i of the output and the
// column tiles s, s + nsplit, s + 2 nsplit, ... For each column tile it builds
// the S tile (coefficient * K') in shared memory, then streams 64-wide
// d-chunks of z[cols] through shared memory and does a read-add-write of its
// own rows of its own partial sz (no other block touches them, so no
// atomics). sum_splits then adds the nsplit partials in split order. The
// column split exists because a row block alone gives only m / 64 blocks
// (16 at m = 1000) for 132 SMs; the caller picks nsplit so the grid covers
// the card. The alternative, a grid over (row block, d-chunk) that recomputes
// S per chunk, multiplies the d2 work by d / 64.
//
// Ragged edges are masked in the kernels: rows >= R, columns >= C and
// d-chunk entries >= d load as zero; the quadrant and validity masks match
// _coeff_tile (XY is the single quadrant row < n1 <= col).
//
// Plain C interface: every entry returns cudaGetLastError() after its
// launches; pointers and the stream come from the caller (ctypes).

#include <cuda_runtime.h>
#include <stddef.h>

#include "dist_tile.cuh"

namespace {

constexpr int BM = 64;   // rows of a tile
constexpr int BN = 64;   // columns of a tile
constexpr int BK = 16;   // d-chunk of the distance product
constexpr int FD = 64;   // d-chunk of the flash backward's S @ z
constexpr int NT = 256;  // threads per block: 16 x 16, 4 x 4 outputs each
constexpr int MAX_MULTS = 8;
constexpr int ST = 8;          // K2: 8 x 8 outputs a thread
constexpr int SB = 16 * ST;    // K2: a 128 x 128 tile pair
constexpr int SB2 = SB * SB;   // K2: floats of one partial dot tile
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

// The shared tile body of the forward and panel kernels. SUMS: write this
// block's (XX, XY, YY) partial. KP: write K'(d2) for the tile (no masking of
// the quadrant, as the Pallas kernels; ragged rows / columns are not stored).
template <bool SUMS, bool KP>
__device__ __forceinline__ void gram_tile(const float* __restrict__ zr,
                                          const float* __restrict__ zc,
                                          const float* __restrict__ nr,
                                          const float* __restrict__ nc,
                                          const float* __restrict__ bw_ptr, int R, int C,
                                          int d, int n1, int m, const VganLadder& L,
                                          float* __restrict__ partials,
                                          float* __restrict__ kp_out) {
    __shared__ __align__(16) float As[BK][BM + 4];
    __shared__ __align__(16) float Bs[BK][BN + 4];
    __shared__ float red[NT / 32];
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
    float acc[4][4];
    tile_dot(zr, zc, R, C, d, row0, col0, As, Bs, acc);
    const float bw = *bw_ptr;
    float sxx = 0.f, sxy = 0.f, syy = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = row0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = col0 + tx * 4 + j;
            if (r < R && c < C) {
                const float d2 = fmaxf(-2.f * acc[i][j] + nr[r] + nc[c], 0.f);
                float k, kp;
                ladder_eval<SUMS, KP>(d2, bw, L, k, kp);
                if (KP) kp_out[(size_t)r * C + c] = kp;
                if (SUMS && r < m && c < m) {
                    const bool rx = r < n1, cx = c < n1;
                    if (rx && cx) sxx += k;
                    else if (rx) sxy += k;
                    else if (!cx) syy += k;
                }
            }
        }
    }
    if (SUMS) {
        const int b = blockIdx.y * gridDim.x + blockIdx.x;
        sxx = block_sum(sxx, red);
        sxy = block_sum(sxy, red);
        syy = block_sum(syy, red);
        if (tid == 0) {
            partials[3 * b + 0] = sxx;
            partials[3 * b + 1] = sxy;
            partials[3 * b + 2] = syy;
        }
    }
}

// Replaces mmd_gram.py:_fwd_kernel.
__global__ void __launch_bounds__(NT)
fwd_kernel(const float* __restrict__ z, const float* __restrict__ norms,
           const float* __restrict__ bw, int m, int d, int n1, VganLadder L,
           float* __restrict__ partials) {
    gram_tile<true, false>(z, z, norms, norms, bw, m, m, d, n1, m, L, partials, nullptr);
}

// K2, pass 0: z_t[k * ld + r] = z[r * d + k] for r < m, 0 for m <= r < ld;
// 32 x 32 tiles through shared memory, so both sides are coalesced.
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

// K2, pass 1: block (b, s) forms tile pair b's dot products over the d
// columns [s slice, s slice + slice) of z_t (d, ld) and writes them to its
// own partial tile of dots, entry (r, c) of thread t at (r ST + c) NT + t.
__global__ void __launch_bounds__(NT, 2)  // two blocks an SM: at most 128 registers
stash_dot_kernel(const float* __restrict__ z_t, int ld, int d, int slice, int tiles,
                 float* __restrict__ dots) {
    extern __shared__ __align__(16) float smem[];
    int J, I;
    tile_pair(blockIdx.x, tiles, J, I);
    const float* base = z_t + (size_t)blockIdx.y * slice * ld;
    float acc[ST][ST];
#pragma unroll
    for (int r = 0; r < ST; ++r)
#pragma unroll
        for (int c = 0; c < ST; ++c) acc[r][c] = 0.f;
    dist_tile::NoHook hook;
    dist_tile::product<ST, ST>(dist_tile::Operand{base, ld, J * SB, nullptr},
                               dist_tile::Operand{base, ld, I * SB, nullptr},
                               min(slice, d - (int)blockIdx.y * slice), smem, acc, hook);
    float* out = dots + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * SB2 + threadIdx.x;
#pragma unroll
    for (int r = 0; r < ST; ++r)
#pragma unroll
        for (int c = 0; c < ST; ++c) out[(r * ST + c) * NT] = acc[r][c];
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

// ladder_eval<true, true> behind a call: its integer powers unroll into
// thousands of instructions, so K2's epilogue keeps one copy of them
// (instruction-cache footprint) rather than one per entry.
__device__ __noinline__ void ladder_k_kp(float d2, float bw, const VganLadder& L, float& k,
                                         float& kp) {
    ladder_eval<true, true>(d2, bw, L, k, kp);
}

// K2, pass 2: block (b, q) takes a quarter of tile pair b, the rows 4 (q / 2)
// .. + 4 and columns 4 (q % 2) .. + 4 of each thread's 8 x 8: it sums their
// nslices partial dots in slice order (the loads of one slice all in
// flight), forms d2, K and K', writes K' to (r, c) and (c, r) of kp (m, m)
// and the quarter's (XX, XY, YY) partial (see the header).
__global__ void __launch_bounds__(NT)
stash_epilogue_kernel(const float* __restrict__ dots, int nslices, int tiles,
                      const float* __restrict__ norms, const float* __restrict__ bw_ptr, int m,
                      int n1, VganLadder L, float* __restrict__ partials,
                      float* __restrict__ kp) {
    constexpr int Q = ST / 2;  // a quarter's rows (and columns) of a thread
    __shared__ float red[NT / 32];
    const int b = blockIdx.x, r0 = Q * (blockIdx.y >> 1), c0 = Q * (blockIdx.y & 1);
    int J, I;
    tile_pair(b, tiles, J, I);
    const bool diag = I == J, vec = (m & 3) == 0;
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
    const float bw = *bw_ptr;
    int rows[Q], cols[Q];
    float nr[Q], nc[Q];
#pragma unroll
    for (int i = 0; i < Q; ++i) {
        rows[i] = J * SB + dist_tile::tile_row(r0 + i);  // runs of four: r0 is 0 or 4
        cols[i] = I * SB + dist_tile::tile_col(c0 + i);
        nr[i] = rows[i] < m ? norms[rows[i]] : 0.f;
        nc[i] = cols[i] < m ? norms[cols[i]] : 0.f;
    }
    float kv[Q][Q];
    float sxx = 0.f, sxy = 0.f, syy = 0.f;
#pragma unroll
    for (int i = 0; i < Q; ++i) {
#pragma unroll
        for (int j = 0; j < Q; ++j) {
            const float d2 = fmaxf(fmaf(-2.f, dot[i][j], nr[i] + nc[j]), 0.f);
            float k, kpv;
            ladder_k_kp(d2, bw, L, k, kpv);
            kv[i][j] = kpv;
            if (rows[i] < m && cols[j] < m) {
                const bool rx = rows[i] < n1, cx = cols[j] < n1;
                const float w = diag ? 1.f : 2.f;
                if (rx && cx) sxx += w * k;
                else if (!rx && !cx) syy += w * k;
                else if (rx) sxy += k;
            }
        }
    }
#pragma unroll
    for (int i = 0; i < Q; ++i)  // (r, c)
        if (rows[i] < m)
            store4(kp + (size_t)rows[i] * m + cols[0], kv[i][0], kv[i][1], kv[i][2], kv[i][3],
                   m - cols[0], vec);
    if (!diag) {
#pragma unroll
        for (int j = 0; j < Q; ++j)  // (c, r)
            if (cols[j] < m)
                store4(kp + (size_t)cols[j] * m + rows[0], kv[0][j], kv[1][j], kv[2][j], kv[3][j],
                       m - rows[0], vec);
    }
    sxx = block_sum(sxx, red);
    sxy = block_sum(sxy, red);
    syy = block_sum(syy, red);
    if (threadIdx.x == 0) {
        const int part = b * 4 + blockIdx.y;
        partials[3 * part + 0] = sxx;
        partials[3 * part + 1] = sxy;
        partials[3 * part + 2] = syy;
    }
}

constexpr size_t STASH_DOT_SMEM = sizeof(float) * dist_tile::smem_floats<ST, ST>();
static_assert(STASH_DOT_SMEM <= 48 * 1024, "launched without raising the dynamic shared memory limit");

// Replaces mmd_gram.py:_kprime_panel_kernel.
__global__ void __launch_bounds__(NT)
kprime_panel_kernel(const float* __restrict__ zr, const float* __restrict__ zc,
                    const float* __restrict__ nr, const float* __restrict__ nc,
                    const float* __restrict__ bw, int R, int C, int d, VganLadder L,
                    float* __restrict__ kp) {
    gram_tile<false, true>(zr, zc, nr, nc, bw, R, C, d, 0, 0, L, nullptr, kp);
}

// Second pass of the forward: the per-block partials summed in a fixed order.
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

}  // namespace

extern "C" {

// Number of per-block partials the forward kernels write (3 floats each).
int vgan_gram_num_blocks(int m) { return cdiv(m, BM) * cdiv(m, BN); }

int vgan_gram_quadrant_sums(const float* z, const float* norms, const float* bw, int m,
                            int d, int n1, const VganLadder* ladder, float* partials,
                            float* sums, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    dim3 grid(cdiv(m, BN), cdiv(m, BM));
    fwd_kernel<<<grid, NT, 0, s>>>(z, norms, bw, m, d, n1, *ladder, partials);
    finalize_sums<<<1, NT, 0, s>>>(partials, grid.x * grid.y, sums);
    return static_cast<int>(cudaGetLastError());
}

// K2. slice: the d columns of one slice, a positive multiple of 16.
// scratch, in this order: z_t (d x M floats, M = m rounded up to 128), the
// partial dot tiles (cdiv(d, slice) x P x 128^2, P = T (T + 1) / 2 tile pairs
// of T = M / 128 tiles) and the sums' partials (3 x 4 P: four blocks a pair).
int vgan_gram_quadrant_sums_stash(const float* z, const float* norms, const float* bw,
                                  int m, int d, int n1, const VganLadder* ladder, int slice,
                                  float* scratch, float* sums, float* kp, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (m < 1 || d < 1 || slice < 1 || slice % dist_tile::BK)
        return static_cast<int>(cudaErrorInvalidValue);
    const int tiles = cdiv(m, SB), ld = tiles * SB, pairs = tiles * (tiles + 1) / 2;
    const int nslices = cdiv(d, slice);
    if (nslices > 65535 || cdiv(d, TT) > 65535) return static_cast<int>(cudaErrorInvalidValue);
    float* z_t = scratch;
    float* dots = z_t + (size_t)d * ld;
    float* partials = dots + (size_t)nslices * pairs * SB2;
    transpose_pad_kernel<<<dim3(ld / TT, cdiv(d, TT)), dim3(TT, 8), 0, s>>>(z, m, d, ld, z_t);
    stash_dot_kernel<<<dim3(pairs, nslices), NT, STASH_DOT_SMEM, s>>>(z_t, ld, d, slice, tiles,
                                                                      dots);
    stash_epilogue_kernel<<<dim3(pairs, 4), NT, 0, s>>>(dots, nslices, tiles, norms, bw, m, n1,
                                                        *ladder, partials, kp);
    finalize_sums<<<1, NT, 0, s>>>(partials, 4 * pairs, sums);
    return static_cast<int>(cudaGetLastError());
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

int vgan_kprime_panel(const float* z_rows, const float* z_cols, const float* n_rows,
                      const float* n_cols, const float* bw, int R, int C, int d,
                      const VganLadder* ladder, float* kp, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    dim3 grid(cdiv(C, BN), cdiv(R, BM));
    kprime_panel_kernel<<<grid, NT, 0, s>>>(z_rows, z_cols, n_rows, n_cols, bw, R, C, d,
                                            *ladder, kp);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
