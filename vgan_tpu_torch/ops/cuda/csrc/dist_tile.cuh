// The pipelined SIMT product tile shared by mmd_gram.cu (K1-K4),
// gof_gram.cu (K5) and knn_score.cu (K6, K7), for Hopper (sm_90a), IEEE
// f32, and the padded transpose that makes their column-major operands.
//
// One block of NT = 256 threads accumulates a (16 TM) x (16 TN) tile
//
//   acc[r][c] += sum_k A[k][row(r)] * B[k][col(c)],   k ascending,
//
// one fmaf per term, never TF32. Both operands are "column-major": column k
// of an operand is a contiguous run of rows, `base + col(k) * ld + row0`,
// where col(k) is k itself or cols[k] (a gathered column list). So a d-chunk
// of either operand is BK contiguous, coalesced rows of 16 TM (or 16 TN)
// floats, copied to shared memory with 16-byte `cp.async` straight into the
// layout the math reads: no register staging and no transpose. ld and row0
// are multiples of 4 and every row up to row0 + 16 TM lies inside the
// operand (the callers pad their copies to whole tiles); chunk entries with
// k >= count are zero-filled by the copy itself.
//
// Two stages: while the block multiplies chunk c, chunk c + 1 is in flight.
// Thread (tx, ty) = (tid % 16, tid / 16) owns rows g 64 + 4 ty + {0..3} and
// columns g 64 + 4 tx + {0..3} for each group g of four: each kk step reads
// TM / 4 + TN / 4 float4s from shared memory without bank conflicts and does
// TM TN fmafs.
//
// A hook sees every chunk once it has landed (`chunk`, before the product;
// kSync adds a barrier after it, for a hook that rewrites the chunk) and
// after its product (`after`, e.g. to fold the partial into a compensated
// sum). The caller zeroes acc.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace dist_tile {

constexpr int NT = 256;  // threads per block, 16 x 16
constexpr int BK = 16;   // d-chunk: columns per pipeline stage
constexpr int STAGES = 2;

// floats of shared memory the pipeline of a (16 TM) x (16 TN) tile takes
template <int TM, int TN>
__host__ __device__ constexpr int smem_floats() {
    return STAGES * BK * 16 * (TM + TN);
}

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

struct Operand {
    const float* base;  // column k starts at base + col(k) * ld
    int ld;
    int row0;           // first row of the tile
    const int* cols;    // gathered columns, or nullptr for col(k) = k
};

struct NoHook {
    static constexpr bool kSync = false;
    __device__ void chunk(const float*, float*, int) {}
    template <class Acc>
    __device__ void after(int, int, Acc&) {}
};

// row / column of a thread's r-th row or c-th column inside the tile
__device__ __forceinline__ int tile_row(int r) { return (r / 4) * 64 + (threadIdx.x / 16) * 4 + r % 4; }
__device__ __forceinline__ int tile_col(int c) { return (c / 4) * 64 + (threadIdx.x % 16) * 4 + c % 4; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int n = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled, nothing is read
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// chunk c of an operand tile of ROWS rows into S[BK][ROWS]
template <int ROWS>
__device__ __forceinline__ void load_chunk(const Operand& op, int count, int c, float* S) {
    constexpr int Q = ROWS / 4;  // float4s per column
    for (int idx = threadIdx.x; idx < BK * Q; idx += NT) {
        const int kk = idx / Q, q = idx % Q, k = c * BK + kk;
        const bool valid = k < count;
        const int col = valid ? (op.cols ? __ldg(op.cols + k) : k) : 0;
        cp_async16(S + kk * ROWS + 4 * q, op.base + (size_t)col * op.ld + op.row0 + 4 * q, valid);
    }
}

template <int TM, int TN, class Hook>
__device__ __forceinline__ void product(const Operand& a, const Operand& b, int count, float* smem,
                                        float (&acc)[TM][TN], Hook& hook) {
    constexpr int BM = 16 * TM, BN = 16 * TN, STAGE = BK * (BM + BN);
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const int n = cdiv(count, BK);
    if (n > 0) {
        load_chunk<BM>(a, count, 0, smem);
        load_chunk<BN>(b, count, 0, smem + BK * BM);
        cp_async_commit();
    }
    for (int c = 0; c < n; ++c) {
        float* As = smem + (c % STAGES) * STAGE;
        float* Bs = As + BK * BM;
        if (c + 1 < n) {
            float* An = smem + ((c + 1) % STAGES) * STAGE;
            load_chunk<BM>(a, count, c + 1, An);
            load_chunk<BN>(b, count, c + 1, An + BK * BM);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        hook.chunk(As, Bs, c);
        if constexpr (Hook::kSync) __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float av[TM], bv[TN];
#pragma unroll
            for (int g = 0; g < TM / 4; ++g) {
                const float4 v = *reinterpret_cast<const float4*>(As + kk * BM + g * 64 + ty * 4);
                av[4 * g] = v.x, av[4 * g + 1] = v.y, av[4 * g + 2] = v.z, av[4 * g + 3] = v.w;
            }
#pragma unroll
            for (int g = 0; g < TN / 4; ++g) {
                const float4 v = *reinterpret_cast<const float4*>(Bs + kk * BN + g * 64 + tx * 4);
                bv[4 * g] = v.x, bv[4 * g + 1] = v.y, bv[4 * g + 2] = v.z, bv[4 * g + 3] = v.w;
            }
#pragma unroll
            for (int r = 0; r < TM; ++r)
#pragma unroll
                for (int cc = 0; cc < TN; ++cc) acc[r][cc] = fmaf(av[r], bv[cc], acc[r][cc]);
        }
        hook.after(c, n, acc);
        __syncthreads();  // the next chunk's load refills this stage
    }
}

// One 32 x 32 tile of a padded transpose, through shared memory t so that
// both sides are coalesced (blocks of TT x 8 threads):
// x_t[k * ld + r] = at(r, k) for r in [r0, r0 + TT) and k in [k0, k0 + TT),
// k < d. at(r, k) gives the source's value, 0 past its rows or columns.
constexpr int TT = 32;

template <class At>
__device__ __forceinline__ void transpose_tile(At at, int r0, int k0, int d, int ld,
                                               float* __restrict__ x_t, float (*t)[TT + 1]) {
    for (int j = threadIdx.y; j < TT; j += blockDim.y) t[j][threadIdx.x] = at(r0 + j, k0 + threadIdx.x);
    __syncthreads();
    for (int j = threadIdx.y; j < TT; j += blockDim.y) {
        const int k = k0 + j, r = r0 + threadIdx.x;
        if (k < d) x_t[(size_t)k * ld + r] = t[threadIdx.x][j];
    }
}

}  // namespace dist_tile
