// Streaming-Gram kernel of the large-m permutation MMD test (K5) for Hopper
// (sm_90a), IEEE f32.
//
//   ak_kernel  <- vgan_tpu/ops/pallas/gof_gram.py:_ak_kernel
//
// C[q] = A @ K_q for every alpha q of the launch (at most MAX_ALPHAS), where
// K_q[j][i] = exp(-alpha_q d2(z_j, z_i)) with the diagonal (j == i) and the
// ragged edges (j or i >= m) zeroed by global index, and A (P, m) holds the
// 0/1 indicator rows. K never exists in device memory: each block owns one
// 64-column tile i of every C plane and walks the reduction axis j in 64-row
// tiles. For each j tile it forms d2 in registers from 16-wide d-chunks of z
// staged in shared memory (4 x 4 micro-tile per thread, fmaf, never TF32;
// the same tile body as mmd_gram.cu's tile_dot), and then, for each alpha,
// writes the K tile to shared memory and, for each 64-row tile of A, adds
// the partial A[p-tile, j-tile] @ K_q[j-tile, i-tile] into C.
//
// What bounds it on an H100: the distances of the m (m - 1) / 2 unordered
// pairs, m (m - 1) d flops (3.0e12 at m = 17000, d = 10240), and 2 m^2 P
// n_alphas for the A @ K products (1.2e12 at P = 1002, two alphas): bound by
// the non-tensor f32 rate (67 TFLOP/s), about 62 ms at that shape. This
// design forms each d2 tile once per (j, i) tile pair, so every pair's
// distance twice (K is symmetric; the Pallas kernel's grid does the same),
// and keeps the C accumulators in device memory: per j tile a block reads
// and writes its C and compensation entries (16 bytes per entry, 2 MB per j
// tile at P = 1002, two alphas). Feeding each off-diagonal tile to both
// C[:, i] and C[:, j], wgmma, TMA and pipelining are left to later work.
//
// Numerics: the partials are Kahan-compensated into C across j tiles, so C
// carries about one ulp of error however many tiles are summed. The
// compensation steps use __fadd_rn / __fsub_rn, which nvcc neither contracts
// into FMAs nor reassociates; the file must not be built with
// --use_fast_math. The compensation of every entry lives in `comp`, a
// scratch plane of C's shape that the caller allocates.
//
// Determinism: one block owns each C entry for the whole launch and adds the
// j tiles in order, so there are no atomics and re-runs give identical bits.
//
// Plain C interface: the entry returns cudaGetLastError() after its launch;
// pointers and the stream come from the caller (ctypes).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BJ = 64;   // rows of a K tile (the reduction index j)
constexpr int BI = 64;   // columns of a K tile and of a C tile (the index i)
constexpr int BP = 64;   // indicator rows of a C tile
constexpr int BK = 16;   // d-chunk of the distance product
constexpr int NT = 256;  // threads per block: 16 x 16, 4 x 4 outputs each
constexpr int MAX_ALPHAS = 8;

}  // namespace

extern "C" {

struct VganAlphas {
    int n;
    float a[MAX_ALPHAS];
};

}  // extern "C"

namespace {

// acc[r][c] = sum_k z[j0 + 4 ty + r][k] * z[i0 + 4 tx + c][k]; rows or
// columns >= m and d-chunk entries >= d load as zero.
__device__ __forceinline__ void dist_tile(const float* __restrict__ z, int m, int d, int j0,
                                          int i0, float (*Zj)[BJ + 4], float (*Zi)[BI + 4],
                                          float acc[4][4]) {
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
        for (int l = 0; l < (BJ * BK) / NT; ++l) {
            const int idx = tid + l * NT;
            const int r = idx / BK, kk = idx % BK;
            const int gk = k0 + kk;
            const int gj = j0 + r, gi = i0 + r;
            Zj[kk][r] = (gj < m && gk < d) ? z[(size_t)gj * d + gk] : 0.f;
            Zi[kk][r] = (gi < m && gk < d) ? z[(size_t)gi * d + gk] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            const float4 a = *reinterpret_cast<const float4*>(&Zj[kk][ty * 4]);
            const float4 b = *reinterpret_cast<const float4*>(&Zi[kk][tx * 4]);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
        }
        __syncthreads();
    }
}

// Block x owns columns [64 x, 64 x + 64) of every C plane; see the top of
// this file. c and comp are (n_alphas, P, m), row-major.
__global__ void __launch_bounds__(NT)
ak_kernel(const float* __restrict__ z, const float* __restrict__ norms,
          const float* __restrict__ a, int m, int d, int P, VganAlphas al,
          float* __restrict__ c, float* __restrict__ comp) {
    __shared__ __align__(16) float Zj[BK][BJ + 4];
    __shared__ __align__(16) float Zi[BK][BI + 4];
    __shared__ __align__(16) float Ks[BJ][BI + 4];  // K_q[j0 + j][i0 + i]
    __shared__ __align__(16) float At[BJ][BP + 4];  // A[p0 + p][j0 + j], transposed
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int i0 = blockIdx.x * BI;
    const size_t plane = (size_t)P * m;
    for (int j0 = 0; j0 < m; j0 += BJ) {
        const bool first = j0 == 0;
        float d2[4][4];
        dist_tile(z, m, d, j0, i0, Zj, Zi, d2);
        bool valid[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int j = j0 + ty * 4 + r;
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
                const int i = i0 + tx * 4 + cc;
                valid[r][cc] = j < m && i < m && j != i;
                d2[r][cc] = valid[r][cc] ? fmaxf(-2.f * d2[r][cc] + norms[j] + norms[i], 0.f)
                                         : 0.f;
            }
        }
        for (int q = 0; q < al.n; ++q) {
            const float alpha = al.a[q];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int cc = 0; cc < 4; ++cc)
                    Ks[ty * 4 + r][tx * 4 + cc] = valid[r][cc] ? expf(-alpha * d2[r][cc]) : 0.f;
            for (int p0 = 0; p0 < P; p0 += BP) {
#pragma unroll
                for (int l = 0; l < (BP * BJ) / NT; ++l) {
                    const int idx = tid + l * NT;
                    const int p = idx / BJ, j = idx % BJ;
                    At[j][p] = (p0 + p < P && j0 + j < m) ? a[(size_t)(p0 + p) * m + j0 + j]
                                                          : 0.f;
                }
                __syncthreads();
                float part[4][4];
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int cc = 0; cc < 4; ++cc) part[r][cc] = 0.f;
#pragma unroll 8
                for (int j = 0; j < BJ; ++j) {
                    const float4 av4 = *reinterpret_cast<const float4*>(&At[j][ty * 4]);
                    const float4 kv4 = *reinterpret_cast<const float4*>(&Ks[j][tx * 4]);
                    const float av[4] = {av4.x, av4.y, av4.z, av4.w};
                    const float kv[4] = {kv4.x, kv4.y, kv4.z, kv4.w};
#pragma unroll
                    for (int r = 0; r < 4; ++r)
#pragma unroll
                        for (int cc = 0; cc < 4; ++cc)
                            part[r][cc] = fmaf(av[r], kv[cc], part[r][cc]);
                }
                // Kahan step into this block's own C entries:
                //   y = part - comp; t = c + y; comp = (t - c) - y; c = t
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const int p = p0 + ty * 4 + r;
                    if (p >= P) continue;
#pragma unroll
                    for (int cc = 0; cc < 4; ++cc) {
                        const int i = i0 + tx * 4 + cc;
                        if (i >= m) continue;
                        const size_t o = q * plane + (size_t)p * m + i;
                        const float cv = first ? 0.f : c[o];
                        const float cp = first ? 0.f : comp[o];
                        const float y = __fsub_rn(part[r][cc], cp);
                        const float t = __fadd_rn(cv, y);
                        comp[o] = __fsub_rn(__fsub_rn(t, cv), y);
                        c[o] = t;
                    }
                }
                __syncthreads();  // At and Ks are rewritten next
            }
        }
    }
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// c and comp: (alphas->n, P, m) float32 each; comp is scratch.
int vgan_gof_a_times_k(const float* z, const float* norms, const float* a, int m, int d,
                       int P, const VganAlphas* alphas, float* c, float* comp, void* stream) {
    if (m < 1 || d < 1 || P < 1 || alphas->n < 1 || alphas->n > MAX_ALPHAS)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    ak_kernel<<<cdiv(m, BI), NT, 0, s>>>(z, norms, a, m, d, P, *alphas, c, comp);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
