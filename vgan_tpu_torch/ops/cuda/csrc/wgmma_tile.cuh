// The bf16 product tile of Hopper's tensor cores, fed by TMA, for
// mmd_gram.cu's bf16 kernels (K1-K4 bf16). sm_90a only: wgmma exists for no
// other target.
//
// One block of THREADS = 544 threads forms a 128 x 128 f32 tile
//
//   acc(r, c) = sum_k A[ra + r][k] B[rb + c][k],   k over the chunks k0 .. k0 + n,
//
// of row-major bf16 matrices read through TMA descriptors (box 64 x 128,
// the 128-byte swizzle): rows ra .. ra + 128 of A's map, rows rb .. rb + 128
// of B's, both K-major (k contiguous), as wgmma reads 16-bit operands
// natively. A chunk is 64 columns of k, one 128-byte swizzle row of bf16;
// TMA fills rows and columns past the matrix's edge with zeros.
//
// Warp specialization: warp 16 is the producer, whose lane 0 keeps the
// STAGES-deep ring of chunks full (one mbarrier `full` a stage, completed by
// the TMA's bytes; one `empty` a stage, completed by the 512 consumer
// threads). Warps 0-15 are four consumer warpgroups: warpgroup g runs
// wgmma.m64n64k16 on rows 64 (g % 2) .. + 64 of A against rows 64 (g / 2)
// .. + 64 of B, both from shared memory: a quarter of the tile each, 64
// accumulator registers a thread with the fragment below, so that 16 warps
// share the epilogue that follows. When A and B are the same rows of one
// matrix (a tile on the diagonal) one copy serves both operands.
//
// Accumulation: the tensor cores do not round a running sum to nearest
// (they keep a fixed number of bits of it, so each product is cut at the
// sum's scale), which over d = 10240 all-positive terms (a row's own dot)
// drifts by about 1e-4 of the sum. So each chunk's four k16 steps sum into
// a fragment that starts from zero (scale-d = 0 at the first step): the
// tensor core accumulates at most 64 products, and the thread adds the
// fragment to its f32 accumulators with IEEE round-to-nearest once a chunk.
// The warpgroups fold at different times, so one's adds overlap another's
// wgmma. The accumulators' layout is wgmma's: thread t of
// warpgroup g holds acc[i] at row acc_row(i), column acc_col(i).
//
// Also here, for mmd_gram.cu's flash_cluster_kernel, which builds its own
// pipeline: loads and stores in another CTA's shared memory, and the
// descriptor of an MN-major operand (a row-major matrix read as B with its
// rows along k: wgmma's transposed B).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wgmma_tile {

constexpr int TILE = 128;                 // rows and columns of the tile
constexpr int WBK = 64;                   // columns of a chunk: 128 bytes of bf16
constexpr int STAGES = 4;                 // chunks in flight
constexpr int OPERAND_BYTES = TILE * WBK * 2;  // one operand's chunk, 16 KB
constexpr int STAGE_BYTES = 2 * OPERAND_BYTES;
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int CONSUMERS = 512;            // four warpgroups
constexpr int THREADS = CONSUMERS + 32;   // and the producer warp
constexpr int ACC = 32;                   // f32 accumulators a consumer thread (m64n64)

struct Barriers {
    uint64_t full[STAGES];
    uint64_t empty[STAGES];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile(
        "{\n"
        ".reg .b64 state;\n"
        "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
        "}\n" ::"r"(smem_u32(bar))
        : "memory");
}

// until the phase of parity `parity` of *bar has completed; a phase that
// never completes (a fault of the pipeline) traps after 2^24 polls
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
    uint32_t done;
    for (uint32_t tries = 0;; ++tries) {
        if (tries == (1u << 24)) __trap();
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done)
            : "r"(smem_u32(bar)), "r"(parity)
            : "memory");
        if (done) return;
    }
}

// the (64 x 128) box at column k, row r of the map into dst (1024-byte aligned)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int k,
                                         int r) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k), "r"(r)
        : "memory");
}

// The address of p's offset in the shared memory of CTA `rank` of the
// cluster, and 16-byte loads and 8-byte stores there (volatile: a kernel
// that reaches many CTAs computes the addresses where it uses them rather
// than holding each one in registers).
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
    uint32_t a;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
    return a;
}

__device__ __forceinline__ float4 ld_cluster(uint32_t a) {
    float4 v;
    asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "r"(a)
                 : "memory");
    return v;
}

__device__ __forceinline__ void st_cluster(uint32_t a, uint2 v) {
    asm volatile("st.shared::cluster.v2.u32 [%0], {%1, %2};\n" ::"r"(a), "r"(v.x), "r"(v.y)
                 : "memory");
}

// wgmma's shared-memory descriptor of a K-major operand under the 128-byte
// swizzle: 8-row groups 1024 bytes apart; +2 moves it 16 columns (32 bytes)
// along k inside the swizzle row.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
    return (static_cast<uint64_t>(smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t(16 >> 4) << 16) |
           (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// The same for an MN-major B operand (TRANS_B = 1 below): a 64-column box of
// a row-major matrix whose 128-byte rows are k, eight k rows a 1024-byte
// swizzle atom; a k16 step reads two atoms (1024 bytes apart: both offset
// fields say so, so that the n64 product reads one atom along n), and +128
// moves it 16 rows (2048 bytes) along k.
__device__ __forceinline__ uint64_t smem_desc_mn(const void* p) {
    return (static_cast<uint64_t>(smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t(1024 >> 4) << 16) |
           (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of d across a wgmma wait
__device__ __forceinline__ void fence_operands(float (&d)[ACC]) {
#pragma unroll
    for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= the 64 x 64 x 16 product of the operands at da (rows) and db
// (columns); SCALE_D = 0 ignores d's value. TRANS_B = 1: db is MN-major
// (smem_desc_mn).
template <int SCALE_D, int TRANS_B = 0>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[ACC], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, %35;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(SCALE_D), "n"(TRANS_B));
}

// d = the 64 x 64 x 16 product alone (scale-d 0), d's registers written
// only: a fragment that starts a sum holds nothing live before it, so its
// registers serve other values between sums (register-bound kernels that
// run the ladder between products: the caller fences d after the wait).
template <int TRANS_B = 0>
__device__ __forceinline__ void wgmma_m64n64k16_fresh(float (&d)[ACC], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, %35;\n"
        "}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
          "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
          "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
          "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
          "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
          "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
          "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
          "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
        : "l"(da), "l"(db), "r"(0), "n"(TRANS_B));
}

// row and column of a consumer thread's acc[i] inside the 128 x 128 tile
__device__ __forceinline__ int acc_row(int i) {
    const int t = threadIdx.x;
    return (t / 128 % 2) * 64 + ((t % 128) / 32) * 16 + (t % 32) / 4 + 8 * ((i / 2) % 2);
}
__device__ __forceinline__ int acc_col(int i) {
    return (threadIdx.x / 256) * 64 + 8 * (i / 4) + 2 * (threadIdx.x % 4) + i % 2;
}

// Thread 0, before any other thread touches the barriers; a barrier of the
// block must follow.
__device__ __forceinline__ void init(Barriers& b) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
        mbar_init(&b.full[s], 1);
        mbar_init(&b.empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The producer warp: chunks k0 .. k0 + n of rows ra of map_a (and rb of
// map_b) into the ring. same: the two are the same rows of one matrix.
__device__ __forceinline__ void produce(const CUtensorMap* map_a, int ra, const CUtensorMap* map_b,
                                        int rb, bool same, int k0, int n, uint8_t* ring,
                                        Barriers& b) {
    if (threadIdx.x % 32 != 0) return;
    for (int c = 0; c < n; ++c) {
        const int s = c % STAGES;
        if (c >= STAGES) mbar_wait(&b.empty[s], (c / STAGES - 1) & 1);  // its last chunk was read
        uint8_t* a = ring + s * STAGE_BYTES;
        mbar_expect_tx(&b.full[s], same ? OPERAND_BYTES : STAGE_BYTES);
        tma_load(a, map_a, &b.full[s], (k0 + c) * WBK, ra);
        if (!same) tma_load(a + OPERAND_BYTES, map_b, &b.full[s], (k0 + c) * WBK, rb);
    }
}

// A consumer thread: acc += its entries of the product over the n chunks
// (see the top of this file). same: one operand copy a stage.
__device__ __forceinline__ void consume(int n, bool same, const uint8_t* ring, Barriers& b,
                                        float (&acc)[ACC]) {
    const int g = threadIdx.x / 128;
    const int row_bytes = (g % 2) * 64 * WBK * 2, col_bytes = (g / 2) * 64 * WBK * 2;
    float part[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) part[i] = 0.f;
    for (int c = 0; c < n; ++c) {
        const int s = c % STAGES;
        mbar_wait(&b.full[s], (c / STAGES) & 1);
        const uint8_t* a = ring + s * STAGE_BYTES;
        const uint64_t da = smem_desc(a + row_bytes),
                       db = smem_desc((same ? a : a + OPERAND_BYTES) + col_bytes);
        fence_operands(part);
        wgmma_fence();
        wgmma_m64n64k16<0>(part, da, db);
        wgmma_m64n64k16<1>(part, da + 2, db + 2);
        wgmma_m64n64k16<1>(part, da + 4, db + 4);
        wgmma_m64n64k16<1>(part, da + 6, db + 6);
        wgmma_commit();
        wgmma_wait_all();
        fence_operands(part);
        mbar_arrive(&b.empty[s]);
#pragma unroll
        for (int i = 0; i < ACC; ++i) acc[i] += part[i];
    }
}

}  // namespace wgmma_tile
