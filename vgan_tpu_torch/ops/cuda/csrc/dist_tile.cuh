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
//
// product_bf16 forms the same 128 x 128 tile from bf16 operands (the same
// column-major layout, ld and row0 multiples of 8) on the tensor cores:
// 32-column chunks double-buffered with 16-byte cp.async (eight bf16 a
// copy), fed to mma.sync m16n8k16 (bf16 x bf16, f32) by ldmatrix.trans,
// eight warps of 64 x 32 outputs each. The products of two bf16 values are
// exact in f32. The tensor cores do not round a running sum to nearest (they
// keep a fixed number of bits of it), which over d = 10240 all-positive
// terms (a row's own dot) drifts by about 1e-4 of the sum; so each mma sums
// its 16 products from zero, and the f32 accumulators add those 16-term sums
// with IEEE round-to-nearest, as the f32 tile adds its products. Only the
// order and the rounding of the accumulation differ from the f32 tile on the
// same rounded values. It ends by staging its accumulators through shared
// memory into the f32 tile's layout above (acc[r][c] at tile_row(r),
// tile_col(c)), so that every epilogue reads either product the same way.

#pragma once

#include <cuda_bf16.h>
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

// ---------------------------------------------------------------------------
// bf16 operands on the tensor cores (see the top of this file)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int BKH = 32;    // d-chunk of the bf16 product: two k16 steps of mma
constexpr int HPAD = 136;  // a chunk column of 128 bf16 padded to 272 bytes: the eight
                           // row addresses of an ldmatrix fall in distinct banks
constexpr int HSTAGE = 2 * BKH * HPAD;  // bf16 of one stage, A's chunk then B's
constexpr int EPAD = 136;  // floats of a row of the accumulators' staging area
constexpr int BF16_SMEM = STAGES * HSTAGE * 2 > 64 * EPAD * 4 ? STAGES * HSTAGE * 2 : 64 * EPAD * 4;

struct OperandH {
    const bf16* base;  // column k starts at base + k * ld
    int ld;
    int row0;
};

// chunk c (columns c BKH .. + BKH) of a 128-row operand tile into S[BKH][HPAD]
__device__ __forceinline__ void load_chunk_h(const OperandH& op, int count, int c, bf16* S) {
    for (int idx = threadIdx.x; idx < BKH * 16; idx += NT) {
        const int kk = idx / 16, q = idx % 16, k = c * BKH + kk;
        const bool valid = k < count;
        cp_async16(S + kk * HPAD + 8 * q, op.base + (size_t)(valid ? k : 0) * op.ld + op.row0 + 8 * q,
                   valid);
    }
}

// four 8 x 8 b16 matrices, transposed: thread l gets rows 2 (l % 4), +1 of
// column l / 4 of matrix i in r[i]; the row addresses come from threads 8 i .. 8 i + 7
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* p) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s));
}

// c += (the 16-term sums of one m16n8k16 product, each formed from zero)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
    float t[4];
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(t[0]), "=f"(t[1]), "=f"(t[2]), "=f"(t[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] += t[e];
}

// acc[r][c] = sum_k A[k][row(r)] B[k][col(c)] over k < count for the 128 x
// 128 tile (8 x 8 a thread, the layout of product<8, 8>), from bf16
// operands; smem holds BF16_SMEM bytes. Warp w owns rows 64 (w / 4) .. + 64
// and columns 32 (w % 4) .. + 32 as 4 x 4 m16n8 tiles. Ends with a barrier.
__device__ __forceinline__ void product_bf16(const OperandH& a, const OperandH& b, int count,
                                             void* smem_raw, float (&acc)[8][8]) {
    bf16* smem = static_cast<bf16*>(smem_raw);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / 4, wn = warp % 4, j = lane >> 3, r = lane & 7;
    const int n = cdiv(count, BKH);
    float c[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) c[mi][ni][e] = 0.f;
    if (n > 0) {
        load_chunk_h(a, count, 0, smem);
        load_chunk_h(b, count, 0, smem + BKH * HPAD);
        cp_async_commit();
    }
    for (int ch = 0; ch < n; ++ch) {
        const bf16* As = smem + (ch % STAGES) * HSTAGE;
        const bf16* Bs = As + BKH * HPAD;
        if (ch + 1 < n) {
            bf16* An = smem + ((ch + 1) % STAGES) * HSTAGE;
            load_chunk_h(a, count, ch + 1, An);
            load_chunk_h(b, count, ch + 1, An + BKH * HPAD);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
#pragma unroll
        for (int ks = 0; ks < BKH / 16; ++ks) {
            unsigned af[4][4], bfr[2][4];
            // A: matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15)
#pragma unroll
            for (int mi = 0; mi < 4; ++mi)
                ldmatrix_x4_trans(af[mi], As + (ks * 16 + r + (j >> 1) * 8) * HPAD + wm * 64 +
                                              mi * 16 + (j & 1) * 8);
            // B: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
#pragma unroll
            for (int np = 0; np < 2; ++np)
                ldmatrix_x4_trans(bfr[np], Bs + (ks * 16 + r + (j & 1) * 8) * HPAD + wn * 32 +
                                               np * 16 + (j >> 1) * 8);
#pragma unroll
            for (int mi = 0; mi < 4; ++mi)
#pragma unroll
                for (int ni = 0; ni < 4; ++ni)
                    mma_bf16(c[mi][ni], af[mi], bfr[ni / 2][(ni % 2) * 2], bfr[ni / 2][(ni % 2) * 2 + 1]);
        }
        __syncthreads();  // the next chunk's load refills this stage
    }
    // to the f32 tile's layout, one 64-row half at a time through smem:
    // accumulator e of m16n8 tile (mi, ni) is row 16 mi + lane / 4 + 8 (e / 2),
    // column 8 ni + 2 (lane % 4) + e % 2 of the warp's 64 x 32
    float* E = static_cast<float*>(smem_raw);
    const int g = lane / 4, t = lane % 4, tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        if (wm == h)
#pragma unroll
            for (int mi = 0; mi < 4; ++mi)
#pragma unroll
                for (int ni = 0; ni < 4; ++ni) {
                    float* p = E + (mi * 16 + g) * EPAD + wn * 32 + ni * 8 + 2 * t;
                    *reinterpret_cast<float2*>(p) = make_float2(c[mi][ni][0], c[mi][ni][1]);
                    *reinterpret_cast<float2*>(p + 8 * EPAD) = make_float2(c[mi][ni][2], c[mi][ni][3]);
                }
        __syncthreads();
#pragma unroll
        for (int q = 0; q < 4; ++q)  // rows 64 h + 4 ty + q: acc[4 h + q]
#pragma unroll
            for (int g4 = 0; g4 < 2; ++g4) {
                const float4 v = *reinterpret_cast<const float4*>(E + (ty * 4 + q) * EPAD + g4 * 64 + tx * 4);
                acc[4 * h + q][4 * g4] = v.x, acc[4 * h + q][4 * g4 + 1] = v.y;
                acc[4 * h + q][4 * g4 + 2] = v.z, acc[4 * h + q][4 * g4 + 3] = v.w;
            }
        __syncthreads();
    }
}

// One 32 x 32 tile of a padded transpose, through shared memory t so that
// both sides are coalesced (blocks of TT x 8 threads):
// x_t[k * ld + r] = at(r, k) for r in [r0, r0 + TT) and k in [k0, k0 + TT),
// k < d. at(r, k) gives the source's value, 0 past its rows or columns. A
// bf16 x_t takes each value rounded to nearest even.
constexpr int TT = 32;

__device__ __forceinline__ void store_operand(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_operand(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

template <class T, class At>
__device__ __forceinline__ void transpose_tile(At at, int r0, int k0, int d, int ld,
                                               T* __restrict__ x_t, float (*t)[TT + 1]) {
    for (int j = threadIdx.y; j < TT; j += blockDim.y) t[j][threadIdx.x] = at(r0 + j, k0 + threadIdx.x);
    __syncthreads();
    for (int j = threadIdx.y; j < TT; j += blockDim.y) {
        const int k = k0 + j, r = r0 + threadIdx.x;
        if (k < d) store_operand(x_t + (size_t)k * ld + r, t[threadIdx.x][j]);
    }
}

}  // namespace dist_tile
