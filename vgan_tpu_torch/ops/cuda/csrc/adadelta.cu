// One Adadelta update over a list of tensors in one launch, for Hopper
// (sm_90a), IEEE f32:
//
//   adadelta_multi_kernel  <- no TPU kernel: vgan_tpu/train/adadelta.py is
//                             plain jnp (optax), which XLA fuses into one pass
//
// The port's training loop (train/adadelta.py) steps every parameter of the
// generator (8 tensors, 69.65 M values at d = 10240) or of the detector (16,
// 139.3 M) after each backward. Per value it reads p, g, E[g^2] and E[dx^2]
// and writes p, E[g^2] and E[dx^2], with a handful of flops between: seven
// 4-byte accesses, so on an H100 it is bound by HBM3 (3.35 TB/s), 0.58 ms a
// generator step. The design follows from that:
//
// - One launch for the whole list. The tensors are passed by value in the
//   kernel's parameter struct (VganAdadeltaBatch, at most MAX_LEAVES of
//   them): their pointers, sizes, step flags and the first chunk of each, so
//   no pointer table is copied to the card (the gradients are new tensors
//   every step). Block b takes chunk b, of CHUNK values, of the leaf whose
//   chunk range holds b.
// - Every byte is touched once: 16-byte loads and stores (float4 for the
//   f32 tensors, 4 bf16 values in 8 bytes for a bf16 state) with the
//   streaming cache hints (__ldcs, __stcs), ILP of them issued before the
//   first is used, for every leaf whose pointers are aligned for it; a
//   scalar path takes the tail past n & ~3 and leaves that are not.
// - A leaf's step flag, where it has one, is a bool on the card (the kl
//   detector's encoder): each block reads it and, when it is false, returns
//   before touching the leaf, so a frozen encoder costs a launch slot and no
//   traffic, and the host never waits for the flag.
//
// Numerics: the JAX package's operation order, which is also the plain
// PyTorch path's (ops/cuda/adadelta.py plain_update), every operation
// rounded on its own (__fmul_rn, __fadd_rn, __fsqrt_rn, __fdiv_rn: nvcc
// contracts none of them into an FMA), with the scalars rounded to f32 as
// PyTorch rounds a Python float:
//
//   g       = g + wd * p
//   new_sq  = rho * sq + ((1 - rho) * g) * g
//   delta   = (g * sqrt(acc + eps)) / sqrt(new_sq + eps)
//   new_acc = rho * acc + ((1 - rho) * delta) * delta
//   p       = p + (-lr) * delta
//
// so the result equals the plain path's on the card to the bit. A bf16
// state (opt_state_dtype='bfloat16') is read into f32, delta is taken from
// the unrounded new E[g^2], and each average is rounded once, to nearest
// even, when it is stored. A frozen leaf keeps its bits (the plain path adds
// a zero update, which turns a -0.0 parameter into +0.0: equal values).
//
// Plain C interface: each entry returns cudaGetLastError() after its launch;
// the struct and the stream come from the caller (ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEAVES = 48;
constexpr int NT = 256;              // threads a block
constexpr int ILP = 4;               // 16-byte accesses a thread has in flight, per tensor
constexpr long long CHUNK = 16384;   // values a block: 4 rounds of NT x ILP x 4

}  // namespace

extern "C" {

struct VganAdadeltaLeaf {
    float* p;
    const float* g;
    void* sq;            // float or __nv_bfloat16: the launch's state type
    void* acc;
    const bool* flag;    // null: the leaf steps
    long long n;
    int vec;             // p, g 16-byte and the state 4-value aligned
    int chunk0;          // the leaf's first chunk (block) in the launch
};

struct VganAdadeltaBatch {
    VganAdadeltaLeaf leaf[MAX_LEAVES];
    int count;
    int chunks;          // every leaf's chunks: the grid
    float rho, one_minus_rho, eps, neg_lr, wd;
};

}  // extern "C"

namespace {

struct Coef {
    float rho, omr, eps, neg_lr, wd;
};

__device__ __forceinline__ void update(float& p, float g, float& sq, float& acc, const Coef& c) {
    g = __fadd_rn(g, __fmul_rn(c.wd, p));
    sq = __fadd_rn(__fmul_rn(c.rho, sq), __fmul_rn(__fmul_rn(c.omr, g), g));
    const float delta = __fdiv_rn(__fmul_rn(g, __fsqrt_rn(__fadd_rn(acc, c.eps))),
                                  __fsqrt_rn(__fadd_rn(sq, c.eps)));
    acc = __fadd_rn(__fmul_rn(c.rho, acc), __fmul_rn(__fmul_rn(c.omr, delta), delta));
    p = __fadd_rn(p, __fmul_rn(c.neg_lr, delta));
}

__device__ __forceinline__ float bf16_bits(unsigned bits) {  // the low 16 bits, exactly
    return __uint_as_float(bits << 16);
}

__device__ __forceinline__ unsigned bf16_round(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Four consecutive state values from vector index i, and back.
__device__ __forceinline__ float4 load4(const float* s, long long i) {
    return __ldcs(reinterpret_cast<const float4*>(s) + i);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* s, long long i) {
    const uint2 u = __ldcs(reinterpret_cast<const uint2*>(s) + i);
    return make_float4(bf16_bits(u.x & 0xffffu), bf16_bits(u.x >> 16),
                       bf16_bits(u.y & 0xffffu), bf16_bits(u.y >> 16));
}

__device__ __forceinline__ void store4(float* s, long long i, float4 v) {
    __stcs(reinterpret_cast<float4*>(s) + i, v);
}

__device__ __forceinline__ void store4(__nv_bfloat16* s, long long i, float4 v) {
    __stcs(reinterpret_cast<uint2*>(s) + i,
           make_uint2(bf16_round(v.x) | (bf16_round(v.y) << 16),
                      bf16_round(v.z) | (bf16_round(v.w) << 16)));
}

__device__ __forceinline__ float load1(const float* s, long long i) { return __ldcs(s + i); }

__device__ __forceinline__ float load1(const __nv_bfloat16* s, long long i) {
    return bf16_bits(__ldcs(reinterpret_cast<const unsigned short*>(s) + i));
}

__device__ __forceinline__ void store1(float* s, long long i, float v) { __stcs(s + i, v); }

__device__ __forceinline__ void store1(__nv_bfloat16* s, long long i, float v) {
    __stcs(reinterpret_cast<unsigned short*>(s) + i, static_cast<unsigned short>(bf16_round(v)));
}

__device__ __forceinline__ void update4(float4& p, const float4& g, float4& sq, float4& acc,
                                        const Coef& c) {
    update(p.x, g.x, sq.x, acc.x, c);
    update(p.y, g.y, sq.y, acc.y, c);
    update(p.z, g.z, sq.z, acc.z, c);
    update(p.w, g.w, sq.w, acc.w, c);
}

template <typename S>
__global__ void __launch_bounds__(NT) adadelta_multi_kernel(const VganAdadeltaBatch b) {
    const int chunk = blockIdx.x;
    int t = 0;
    while (t + 1 < b.count && b.leaf[t + 1].chunk0 <= chunk) ++t;
    const VganAdadeltaLeaf& leaf = b.leaf[t];
    if (leaf.flag != nullptr && !*leaf.flag) return;  // frozen: nothing read or written
    const Coef c{b.rho, b.one_minus_rho, b.eps, b.neg_lr, b.wd};
    float* __restrict__ p = leaf.p;
    const float* __restrict__ g = leaf.g;
    S* __restrict__ sq = static_cast<S*>(leaf.sq);
    S* __restrict__ acc = static_cast<S*>(leaf.acc);
    const long long s = static_cast<long long>(chunk - leaf.chunk0) * CHUNK;
    const long long e = min(leaf.n, s + CHUNK);
    // [s, mid): 16-byte accesses; [mid, e): one value a thread
    const long long mid = leaf.vec ? max(s, min(e, leaf.n & ~3LL)) : s;

    const long long v_end = mid / 4;
    for (long long i = s / 4 + threadIdx.x; i < v_end; i += NT * ILP) {
        float4 pv[ILP], gv[ILP], qv[ILP], av[ILP];
#pragma unroll
        for (int k = 0; k < ILP; ++k) {
            const long long j = i + k * NT;
            if (j < v_end) {
                pv[k] = __ldcs(reinterpret_cast<const float4*>(p) + j);
                gv[k] = __ldcs(reinterpret_cast<const float4*>(g) + j);
                qv[k] = load4(sq, j);
                av[k] = load4(acc, j);
            }
        }
#pragma unroll
        for (int k = 0; k < ILP; ++k) {
            const long long j = i + k * NT;
            if (j < v_end) {
                update4(pv[k], gv[k], qv[k], av[k], c);
                __stcs(reinterpret_cast<float4*>(p) + j, pv[k]);
                store4(sq, j, qv[k]);
                store4(acc, j, av[k]);
            }
        }
    }
    for (long long i = mid + threadIdx.x; i < e; i += NT) {
        float pi = __ldcs(p + i), qi = load1(sq, i), ai = load1(acc, i);
        update(pi, __ldcs(g + i), qi, ai, c);
        __stcs(p + i, pi);
        store1(sq, i, qi);
        store1(acc, i, ai);
    }
}

}  // namespace

extern "C" {

// The layout the wrapper's ctypes mirror must match.
int vgan_adadelta_layout(int* max_leaves, long long* chunk, int* leaf_bytes, int* batch_bytes) {
    *max_leaves = MAX_LEAVES;
    *chunk = CHUNK;
    *leaf_bytes = static_cast<int>(sizeof(VganAdadeltaLeaf));
    *batch_bytes = static_cast<int>(sizeof(VganAdadeltaBatch));
    return 0;
}

// One launch over batch->count leaves; state_bf16: E[g^2] and E[dx^2] are
// bf16, else float.
int vgan_adadelta_multi(const VganAdadeltaBatch* batch, int state_bf16, void* stream) {
    if (batch->chunks <= 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (state_bf16) {
        adadelta_multi_kernel<__nv_bfloat16><<<batch->chunks, NT, 0, s>>>(*batch);
    } else {
        adadelta_multi_kernel<float><<<batch->chunks, NT, 0, s>>>(*batch);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
