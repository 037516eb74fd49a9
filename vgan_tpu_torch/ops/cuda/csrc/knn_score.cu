// Fused masked-distance and k-nearest-neighbour score kernels (K6, K7) for
// Hopper (sm_90a), IEEE f32.
//
//   knn_kernel<RESIDENT_G>  (K6) <- vgan_tpu/ops/pallas/knn_score.py:_knn_kernel
//   knn_kernel<1>           (K7) <- vgan_tpu/ops/pallas/knn_score.py:_knn_stream_kernel
//   masked_norms_kernel          the masked squared norms both of them read
//
// For every mask m, test row i and train row j:
//
//   d2 = max((an[m][i] + bn[m][j]) - 2 cross, 0),
//   cross = sum_k (xte[i][k] m[k]) xtr[j][k],
//   an[m][i] = sum_k m[k] xte[i][k]^2,  bn[m][j] = sum_k m[k] xtr[j][k]^2,
//
// with columns j >= ntr, and j == i under exclude_self (the query row IS the
// train row), set to +3.0e38. The score of (m, i) is sqrt of the k-th smallest
// d2 of the row ('kth', pyod KNN 'largest') or the mean of the sqrt of the k
// smallest ('mean'). The distances are the JAX expansion in f32 fmaf, never
// TF32 and never a direct (a - b)^2 form; the file must not be built with
// --use_fast_math (sqrtf must stay IEEE).
//
// Selection. The TPU kernels take k min/count passes over a whole (256, NTR)
// d2 block in VMEM; 256 x 8192 f32 does not fit a Hopper block. Here each
// (mask, test row) keeps a sorted list of its k smallest d2 values in shared
// memory. The train axis streams in 64-row tiles: a 64 x 64 d2 tile per mask
// is formed in registers (16 x 16 threads, a 4 x 4 micro-tile each, 16-wide
// d-chunks through shared memory, as mmd_gram.cu's tile_dot), written to
// shared memory, and then one thread per (mask, row) walks its 64 candidates
// in column order and inserts each one below its current k-th value. Equal
// values stay separate entries, so the list is the exact k-smallest multiset
// under ties: its k-th entry is the k-th order statistic, as the TPU's tie
// counter gives, and no indices are needed.
//
// The two regimes, and what bounds them on an H100:
// - K6 (the JAX resident regime, NTR * D <= 2^20: small d). Per pair the
//   distance is 2 d flops, so the selection and re-reading the train rows per
//   mask weigh as much as the product. A block owns RESIDENT_G = 4 masks x 64
//   test rows: every staged train tile serves the 4 masks (the TPU's MASK_G
//   idea; 4 x 16 accumulators per thread, where 8 would spill), and the 4 x 64
//   (mask, row) lists give one selecting thread each to all 256 threads.
// - K7 (past that cap: here d = 10240). The d-chunked distance tile dominates
//   (2 d flops per pair against one compare), bound by the non-tensor f32
//   rate (67 TFLOP/s). A block owns one mask x 64 test rows, with the masked
//   test rows staged once per d-chunk; (<= 500 masks) x 8 test tiles give
//   thousands of blocks for 132 SMs, so the train axis is not split.
// Neither uses wgmma, TMA or bf16; the same 64 x 64 SIMT tile runs at 18-19
// TFLOP/s in mmd_gram.cu on an H100 SXM at d = 10240.
//
// Determinism: one block owns each (mask, test tile) output and walks the
// train tiles in order, so there are no atomics and re-runs give identical
// bits. Ragged nt, ntr, d and n_masks are masked by index; an all-zero mask
// gives d2 == 0 everywhere, so its score is 0.
//
// Plain C interface: each entry launches the norm pre-pass and the score
// kernel on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BT = 64;    // test rows per block; rows and masks per norm tile
constexpr int BR = 64;    // train rows per streamed tile
constexpr int BK = 16;    // d-chunk
constexpr int NT = 256;   // threads per block: 16 x 16, 4 x 4 outputs each
constexpr int MAX_K = 64;
constexpr int RESIDENT_G = 4;
constexpr float BIG = 3.0e38f;

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// out[m][r] = sum_k masks[m][k] * x[r][k]^2 for a 64 x 64 (mask, row) tile.
__global__ void __launch_bounds__(NT)
masked_norms_kernel(const float* __restrict__ masks, const float* __restrict__ x, int nm, int n,
                    int d, float* __restrict__ out) {
    __shared__ __align__(16) float Ms[BK][BT + 4];
    __shared__ __align__(16) float Xs[BK][BT + 4];
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int r0 = blockIdx.x * BT, m0 = blockIdx.y * BT;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
        for (int l = 0; l < (BT * BK) / NT; ++l) {
            const int idx = tid + l * NT;
            const int r = idx / BK, kk = idx % BK, gk = k0 + kk;
            Ms[kk][r] = (m0 + r < nm && gk < d) ? masks[(size_t)(m0 + r) * d + gk] : 0.f;
            const float v = (r0 + r < n && gk < d) ? x[(size_t)(r0 + r) * d + gk] : 0.f;
            Xs[kk][r] = __fmul_rn(v, v);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            const float4 a = *reinterpret_cast<const float4*>(&Ms[kk][ty * 4]);
            const float4 b = *reinterpret_cast<const float4*>(&Xs[kk][tx * 4]);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int m = m0 + ty * 4 + r;
        if (m >= nm) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int i = r0 + tx * 4 + c;
            if (i < n) out[(size_t)m * n + i] = acc[r][c];
        }
    }
}

// Shared memory of knn_kernel<G>, in floats: the staged test and train
// d-chunks, the G mask chunks, the G d2 tiles (rows padded to 65 against
// bank conflicts) and the k-lists, stored [slot p][(mask, row)] so that the
// threads of a warp touch consecutive words.
constexpr int smem_floats(int G, int k) {
    return 2 * BK * (BT + 4) + G * BK + G * BT * (BR + 1) + k * G * BT;
}

// Block (x, y) owns masks [G x, G x + G) and test rows [64 y, 64 y + 64);
// see the top of this file. an is (nm, nt), bn (nm, ntr), out (nm, nt).
template <int G>
__global__ void __launch_bounds__(NT)
knn_kernel(const float* __restrict__ masks, const float* __restrict__ xte,
           const float* __restrict__ xtr, const float* __restrict__ an,
           const float* __restrict__ bn, int nm, int nt, int ntr, int d, int k, int mean,
           int exclude_self, float* __restrict__ out) {
    extern __shared__ __align__(16) float smem[];
    float(*Xt)[BT + 4] = reinterpret_cast<float(*)[BT + 4]>(smem);
    float(*Xr)[BR + 4] = reinterpret_cast<float(*)[BR + 4]>(smem + BK * (BT + 4));
    float(*Mk)[BK] = reinterpret_cast<float(*)[BK]>(smem + 2 * BK * (BT + 4));
    float(*D2)[BR + 1] = reinterpret_cast<float(*)[BR + 1]>(smem + 2 * BK * (BT + 4) + G * BK);
    float* L = smem + 2 * BK * (BT + 4) + G * BK + G * BT * (BR + 1);
    constexpr int SLOTS = G * BT;

    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int m0 = blockIdx.x * G, i0 = blockIdx.y * BT;
    for (int idx = tid; idx < k * SLOTS; idx += NT) L[idx] = BIG;

    for (int j0 = 0; j0 < ntr; j0 += BR) {
        float acc[G][4][4];
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[g][r][c] = 0.f;

        for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
            for (int l = 0; l < (BT * BK) / NT; ++l) {
                const int idx = tid + l * NT;
                const int r = idx / BK, kk = idx % BK, gk = k0 + kk;
                float v = (i0 + r < nt && gk < d) ? xte[(size_t)(i0 + r) * d + gk] : 0.f;
                if constexpr (G == 1)  // one mask: stage the masked rows (exact, the mask is 0 or 1)
                    v *= (m0 < nm && gk < d) ? masks[(size_t)m0 * d + gk] : 0.f;
                Xt[kk][r] = v;
                Xr[kk][r] = (j0 + r < ntr && gk < d) ? xtr[(size_t)(j0 + r) * d + gk] : 0.f;
            }
            if constexpr (G > 1) {
                for (int idx = tid; idx < G * BK; idx += NT) {
                    const int g = idx / BK, kk = idx % BK, gk = k0 + kk;
                    Mk[g][kk] = (m0 + g < nm && gk < d) ? masks[(size_t)(m0 + g) * d + gk] : 0.f;
                }
            }
            __syncthreads();
#pragma unroll
            for (int kk = 0; kk < BK; ++kk) {
                const float4 a4 = *reinterpret_cast<const float4*>(&Xt[kk][ty * 4]);
                const float4 b4 = *reinterpret_cast<const float4*>(&Xr[kk][tx * 4]);
                const float av[4] = {a4.x, a4.y, a4.z, a4.w};
                const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
                for (int g = 0; g < G; ++g) {
                    const float mg = (G == 1) ? 1.f : Mk[g][kk];
#pragma unroll
                    for (int r = 0; r < 4; ++r) {
                        const float am = av[r] * mg;  // exact: the mask is 0 or 1
#pragma unroll
                        for (int c = 0; c < 4; ++c) acc[g][r][c] = fmaf(am, bv[c], acc[g][r][c]);
                    }
                }
            }
            __syncthreads();
        }

        // the G d2 tiles: (an + bn) - 2 cross, one rounding each, as the
        // plain version's an + bn - 2.0 * cross (2 cross is exact)
#pragma unroll
        for (int g = 0; g < G; ++g) {
            const int m = m0 + g;
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int i = i0 + ty * 4 + r;
                const bool row_ok = m < nm && i < nt;
                const float a_n = row_ok ? an[(size_t)m * nt + i] : 0.f;
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int j = j0 + tx * 4 + c;
                    float v = BIG;
                    if (row_ok && j < ntr && !(exclude_self && i == j))
                        v = fmaxf(fmaf(-2.f, acc[g][r][c], a_n + bn[(size_t)m * ntr + j]), 0.f);
                    D2[g * BT + ty * 4 + r][tx * 4 + c] = v;
                }
            }
        }
        __syncthreads();

        // insertion into each (mask, row)'s sorted k-list, candidates in
        // column order
        const int jn = min(BR, ntr - j0);
        for (int s = tid; s < SLOTS; s += NT) {
            const float* row = D2[s];
            float kth = L[(k - 1) * SLOTS + s];
            for (int c = 0; c < jn; ++c) {
                const float v = row[c];
                if (v < kth) {
                    int p = k - 1;
                    while (p > 0 && L[(p - 1) * SLOTS + s] > v) {
                        L[p * SLOTS + s] = L[(p - 1) * SLOTS + s];
                        --p;
                    }
                    L[p * SLOTS + s] = v;
                    kth = L[(k - 1) * SLOTS + s];
                }
            }
        }
        __syncthreads();
    }

    for (int s = tid; s < SLOTS; s += NT) {
        const int m = m0 + s / BT, i = i0 + s % BT;
        if (m >= nm || i >= nt) continue;
        float score;
        if (mean) {
            float sum = 0.f;  // ascending order, as the plain version's sorted top-k
            for (int p = 0; p < k; ++p) sum += sqrtf(L[p * SLOTS + s]);
            score = sum / (float)k;
        } else {
            score = sqrtf(L[(k - 1) * SLOTS + s]);
        }
        out[(size_t)m * nt + i] = score;
    }
}

template <int G>
int launch_knn(const float* masks, const float* xte, const float* xtr, int nm, int nt, int ntr,
               int d, int k, int mean, int exclude_self, float* an, float* bn, float* out,
               cudaStream_t s) {
    if (nm < 1 || nt < 1 || ntr < 1 || d < 1 || k < 1 || k > MAX_K || k > ntr ||
        (exclude_self && k >= ntr) || cdiv(nt, BT) > 65535 || cdiv(nm, BT) > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    masked_norms_kernel<<<dim3(cdiv(nt, BT), cdiv(nm, BT)), NT, 0, s>>>(masks, xte, nm, nt, d, an);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    masked_norms_kernel<<<dim3(cdiv(ntr, BT), cdiv(nm, BT)), NT, 0, s>>>(masks, xtr, nm, ntr, d, bn);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t bytes = sizeof(float) * smem_floats(G, k);
    err = cudaFuncSetAttribute(knn_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    knn_kernel<G><<<dim3(cdiv(nm, G), cdiv(nt, BT)), NT, bytes, s>>>(
        masks, xte, xtr, an, bn, nm, nt, ntr, d, k, mean, exclude_self, out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// masks (nm, d), xte (nt, d), xtr (ntr, d) float32, row-major; an (nm, nt)
// and bn (nm, ntr) are scratch for the masked norms; out (nm, nt).
int vgan_knn_resident(const float* masks, const float* xte, const float* xtr, int nm, int nt,
                      int ntr, int d, int k, int mean, int exclude_self, float* an, float* bn,
                      float* out, void* stream) {
    return launch_knn<RESIDENT_G>(masks, xte, xtr, nm, nt, ntr, d, k, mean, exclude_self, an, bn,
                                  out, static_cast<cudaStream_t>(stream));
}

int vgan_knn_stream(const float* masks, const float* xte, const float* xtr, int nm, int nt,
                    int ntr, int d, int k, int mean, int exclude_self, float* an, float* bn,
                    float* out, void* stream) {
    return launch_knn<1>(masks, xte, xtr, nm, nt, ntr, d, k, mean, exclude_self, an, bn, out,
                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
