// The whole no-kl fit in one launch (K8) for Hopper (sm_90a), IEEE f32.
//
//   fused_kernel  <- vgan_tpu/ops/pallas/fused_no_kl.py:_kernel_body
//
// One persistent cooperative launch (one block of 512 threads per SM) runs
// every train step of the fit in order. Parameters, Adadelta state and every
// intermediate live in device memory (all of it a few MB, so L2-resident);
// grid-wide barriers (cooperative_groups::this_grid().sync()) separate the
// phases of a step:
//
//   A  rows: W and b (as G left them) into shared memory; per batch row (one
//      warp a row) the noise (in-kernel Philox or an injected buffer), the 4
//      linear layers, the masked upper softmax, the row of zc = [batch;
//      u * batch] and its squared norms; per block the column max of u (and,
//      at step 0, the column sums of zc);
//   -- barrier (at step 0 one more: the centred closed-form bandwidth needs
//      the mean first, then the sum of squares; it is then frozen) --
//   B  the Gram pass over units spread across every warp of the grid, one a
//      warp (consecutive units on different SMs): a masked row against the
//      x columns, the same row against the masked columns (K'q and
//      K'(q .* zc) of the masked rows, the only rows phase E reads, in two
//      parts that E adds, and the MMD of the XY block and the YY triangle),
//      and an x row against the x columns at or after it (the XX triangle,
//      K only): the MMD takes each unordered pair once. The block streams
//      the columns of zc and their norms through a ring in shared memory
//      (16-byte cp.async through L2; at the notebook shape all of zc, 2 bs
//      x d floats, is one stage, else two stages of columns); a lane takes
//      two columns, recomputes d2 in float4 steps and the bandwidth ladder
//      (one exp, then squarings, in a rolled loop over a table in shared
//      memory: unrolled per term it outgrew the instruction cache), and
//      adds K'(q .* zc) into its own sums when d <= 16, else through a
//      warp buffer with a lane a feature. Then the column max of u (its
//      partials were put in flight at the start of B) and per block the tie
//      counts of its rows. The (m, m) Gram is never stored;
//   -- barrier --
//   E  the MMD (block 0) and the tie counts reduced, the loss; per row
//      the rank-1 backward dzc = 4/bs^2 q .* (K'q .* zc - K'(q .* zc)), the
//      coverage gradient split evenly among ties, the upper-softmax
//      backward and the whole dh chain through layers 3 -> 1 (row-wise, from
//      the shared copy of W, so every dh is taken from W before its update);
//   -- barrier --
//   G  one warp per parameter entry sums hs^T dh over the batch rows and
//      takes the torch-parity Adadelta step (L2 weight decay in the
//      gradient, rho 0.9, eps 1e-6);
//   -- barrier --
//
// so four barriers a step. Rows are compact: x rows [0, bs), masked rows
// [bs, 2 bs); the Pallas kernel's pad rows contribute exact zeros there.
//
// What bounds it on an H100: per step the distances of the 2 bs rows'
// unordered pairs and K'[q | q .* zc] over the bs masked rows at width d,
// about 20 operations per Gram entry for the ladder, and the tiny generator
// GEMMs: under 1 us of non-tensor f32 work at the notebook shape (bs 500,
// d 10). The design is bound instead by latency: a step is four grid-wide
// syncs, each phase a few dependent L2 round trips, and the Gram pass long
// dependent chains a warp. A phase timer (PhaseTimer, off unless asked for)
// measures each phase's share.
//
// Numerics: IEEE f32 (expf, logf, cosf, sqrtf; the file must not be built
// with --use_fast_math), d2 the clamped expansion max(|a|^2 + |b|^2 - 2 ab, 0)
// as the Pallas kernel forms it. The noise generator is one __device__
// function used by the fit and by the fill kernel alike, written with
// __fmul_rn / __fadd_rn so no FMA contraction can differ between the two.
//
// Determinism: no atomics; every cross-block sum is a per-block partial
// reduced after a barrier in a fixed order (lanes_reduce, scalar_reduce:
// fixed segments over the threads, then combined in segment order), so
// re-runs give identical bits.
//
// Plain C interface: each entry returns the launch's error code; pointers
// and the stream come from the caller (ctypes).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr int LP = 128;   // padded latent lanes of the noise buffer
constexpr int DP = 128;   // padded lanes of x3, zc and every activation row
constexpr int WP = 128;   // padded widths of W and b
constexpr int NT = 512;   // threads per block
constexpr int NW = NT / 32;
// dynamic shared memory: the Gram pass's column ring (one stage holding all of
// zc and its norms, or two stages of columns), then the live part of W for
// phases A and E, layer l as in_l rows of stride out_l | 1 (odd: a warp's
// lanes reading one column each hit distinct banks), at most the widest
// generator's (latent 16, d 128)
constexpr int RING_FLOATS = 20480;
constexpr int W_FLOATS = 16 * 33 + 32 * 65 + 64 * 129 + 128 * 129;
constexpr int SMEM_BYTES = (RING_FLOATS + W_FLOATS) * 4;
constexpr int MAX_LADDER = 8;
constexpr int PRE = 8;  // column-max partials a thread puts in flight at the start of B
constexpr int BARRIERS_PER_STEP = 4;
constexpr int PHASES = 5;  // A, the step-0 bandwidth, B, E, G: see the phase timer

}  // namespace

extern "C" {

struct VganFusedLadder {
    int n;
    float base;
    int power[MAX_LADDER];  // sorted ascending, powers of two
    float mult[MAX_LADDER];
};

struct VganFusedHyper {
    int d, bs, latent, total_steps;
    unsigned seed;
    float lr, weight_decay, penalty_weight, pw_over_d, inv, four_inv, thresh, bw_m2, bw_den;
};

}  // extern "C"

namespace {

struct Params {
    const float* __restrict__ x3;      // (n + bsp, DP)
    const int* __restrict__ starts;    // (total_steps,)
    const float* __restrict__ noise;   // (total_steps, bsp, LP) or null
    // written inside the launch: plain loads only (no .nc path)
    float* w;     // (4, WP, WP), (in, out)
    float* b;     // (8, WP)
    float* sqw;
    float* sqb;
    float* accw;
    float* accb;
    float* loss;  // (total_steps,)
    float* bw;    // (2,)
    float* hsT;   // (4, DP, bsp): layer inputs h0..h3, transposed
    float* gT;    // (4, DP, bsp): dh of each layer's output, transposed
    float* s;     // (bsp, DP) softmax
    float* u;     // (bsp, DP) upper softmax
    float* zc;    // (2 bsp, DP) compact [batch; u * batch]
    float* norms; // (2 bsp,)
    float* kpq;   // (2, bsp) K'q of the masked rows over the x, then the masked columns
    float* kpqz;  // (2, bsp, DP) K'(q .* zc) of the masked rows, likewise
    float* p_colmax;  // (grid, DP)
    float* p_cnt;     // (grid, DP)
    float* p_colsum;  // (grid, DP)
    float* p_scalar;  // (grid, 2): MMD partial, centred sum of squares
    unsigned long long* timer;  // (PHASES,) nanoseconds per phase over the fit, or null
    VganFusedHyper h;
    VganFusedLadder lad;
    int bsp;
    int sd;            // floats a column of zc takes in the ring: 4 x an odd number >= d / 4
    int chunk;         // columns of zc a ring stage holds, a multiple of 32
    int stage_floats;  // chunk (sd + 1)
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// Philox4x32-10 (Salmon et al., SC'11) on counter c under key k.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
    for (int r = 0; r < 10; ++r) {
        const unsigned lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
        const unsigned lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
        c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
        k.x += 0x9E3779B9u;
        k.y += 0xBB67AE85u;
    }
    return c;
}

// The standard normal of (seed, step, row, lane): Box-Muller on two 24-bit
// uniforms, +1e-12 on u1 and the cosine branch only, as the Pallas kernel.
__device__ __noinline__ float philox_normal(unsigned seed, int step, int row, int lane) {
    const uint4 bits = philox4x32_10(make_uint4((unsigned)row, (unsigned)lane, 0u, 0u),
                                     make_uint2(seed, (unsigned)step));
    const float scale = 1.0f / 16777216.0f;
    const float u1 = __fadd_rn(__fmul_rn((float)(int)(bits.x >> 8), scale), 1e-12f);
    const float u2 = __fmul_rn((float)(int)(bits.y >> 8), scale);
    const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
    return __fmul_rn(r, cosf(__fmul_rn(6.2831853071795864769f, u2)));
}

// Sum the per-warp lane vectors red[warp][k] in warp order into out[k].
__device__ __forceinline__ void block_vec_reduce(float (*red)[DP], float* out, bool take_max) {
    __syncthreads();
    if (threadIdx.x < DP) {
        float v = red[0][threadIdx.x];
        for (int w = 1; w < NW; ++w)
            v = take_max ? fmaxf(v, red[w][threadIdx.x]) : v + red[w][threadIdx.x];
        out[threadIdx.x] = v;
    }
    __syncthreads();
}

// Sum one value per warp in warp order; the result is returned to thread 0.
__device__ __forceinline__ float block_scalar_reduce(float v, float* scal) {
    __syncthreads();
    if ((threadIdx.x & 31) == 0) scal[threadIdx.x >> 5] = v;
    __syncthreads();
    float t = 0.f;
    if (threadIdx.x == 0)
        for (int w = 0; w < NW; ++w) t += scal[w];
    __syncthreads();
    return t;
}

// out[k] = the S segments seg[s d + k] combined in segment order for k < d,
// 0 for d <= k < DP (MAX: their max, from 0).
template <bool MAX>
__device__ __forceinline__ void lanes_combine(int S, int d, float* seg, float* out) {
    __syncthreads();
    if (threadIdx.x < DP) {
        float v = 0.f;
        if (threadIdx.x < d) {
#pragma unroll 8
            for (int q = 0; q < S; ++q) {
                const float x = seg[q * d + threadIdx.x];
                v = MAX ? fmaxf(v, x) : v + x;
            }
        }
        out[threadIdx.x] = v;
    }
    __syncthreads();
}

// out[k] = the sum (MAX: the max, from 0) over g < G of part[g DP + k] for
// k < d, 0 for d <= k < DP, in every block. Thread t takes lane t % d of
// segment t / d (g = segment, segment + S, ...; S = NT / d segments), then
// the segments are combined in segment order: a fixed order, so re-runs give
// identical bits.
template <bool MAX>
__device__ __forceinline__ void lanes_reduce(const float* part, int G, int d, float* seg,
                                             float* out) {
    const int S = NT / d, k = threadIdx.x % d, s = threadIdx.x / d;
    if (s < S) {
        float v = 0.f;
#pragma unroll 4
        for (int g = s; g < G; g += S) {
            const float x = part[(size_t)g * DP + k];
            v = MAX ? fmaxf(v, x) : v + x;
        }
        seg[s * d + k] = v;
    }
    lanes_combine<MAX>(S, d, seg, out);
}

// The sum over g < G of part[g stride] in a fixed order (thread t takes
// g = t, t + NT, ..., then warps and blocks in order), in every thread.
__device__ __forceinline__ float scalar_reduce(const float* part, int stride, int G, float* scal) {
    float v = 0.f;
    for (int g = threadIdx.x; g < G; g += NT) v += part[(size_t)g * stride];
    v = block_scalar_reduce(warp_sum(v), scal);
    if (threadIdx.x == 0) scal[0] = v;
    __syncthreads();
    v = scal[0];
    __syncthreads();
    return v;
}

// 16 bytes from global (through L2 only: the data was written by other SMs
// inside the launch) to shared memory; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(src),
                 "r"(valid ? 16 : 0));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy columns [ch chunk, (ch + 1) chunk) of zc (their first d floats
// rounded up to 4, the lanes past d being zero) and their norms into a ring
// stage, and commit.
__device__ __forceinline__ void stage_columns(const float* zc, const float* norms, int m, int d,
                                              int chunk, int sd, int ch, float* stage) {
    const int q4 = (d + 3) / 4, c0 = ch * chunk;
    for (int idx = threadIdx.x; idx < chunk * q4; idx += NT) {
        const int cl = idx / q4, q = idx - cl * q4, c = c0 + cl;
        cp_async16(stage + cl * sd + 4 * q, zc + (size_t)(c < m ? c : 0) * DP + 4 * q, c < m);
    }
    float* ns = stage + chunk * sd;
    for (int q = threadIdx.x; q < chunk / 4; q += NT) {
        const int c = c0 + 4 * q;
        cp_async16(ns + 4 * q, norms + (c < m ? c : 0), c < m);
    }
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ unsigned long long globaltimer() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// The phase timer: thread 0 of block 0 reads the global nanosecond clock
// right after each grid barrier and adds the time since the previous one to
// its phase, so a phase's time is that of its slowest block plus the
// barrier. Off (no clock read) when p.timer is null.
struct PhaseTimer {
    bool on;
    unsigned long long last, ns[PHASES];
    __device__ explicit PhaseTimer(bool on_) : on(on_), last(on_ ? globaltimer() : 0ull) {
#pragma unroll
        for (int q = 0; q < PHASES; ++q) ns[q] = 0ull;
    }
    __device__ __forceinline__ void lap(int q) {
        if (!on) return;
        const unsigned long long now = globaltimer();
        ns[q] += now - last;
        last = now;
    }
};

__global__ void __launch_bounds__(NT, 1) fused_kernel(Params p) {
    cg::grid_group grid = cg::this_grid();
    extern __shared__ __align__(16) float ring[];  // RING_FLOATS, then W_FLOATS of W
    float* const Ws = ring + RING_FLOATS;
    __shared__ float bsm[4][WP];
    __shared__ __align__(16) float rowbuf[NW][2][WP];
    __shared__ float kbuf[NW][64];
    __shared__ float coef_s[MAX_LADDER];
    __shared__ int sq_s[MAX_LADDER];
    __shared__ float red[NW][DP];
    __shared__ float seg[NT];
    __shared__ float colv[DP], cntv[DP], meanv[DP];
    __shared__ float scal[NW];

    const int G = gridDim.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int bs = p.h.bs, d = p.h.d, L = p.h.latent, bsp = p.bsp, m = 2 * bs;
    const int wd[5] = {L, 2 * L, 4 * L, 8 * L, d};
    int woff[4], wstr[4];  // layer l of W at Ws + woff[l], row stride wstr[l]
    for (int l = 0, off = 0; l < 4; ++l) {
        woff[l] = off;
        wstr[l] = wd[l + 1] | 1;
        off += wd[l] * wstr[l];
    }
    const int row0 = blockIdx.x * NW + warp, row_step = G * NW;
    // the Gram pass: W warps in the grid, this warp's place among them with
    // consecutive places on different SMs, the column chunks of the ring and
    // the float4s of a column; its K'(q .* zc) step gives lane l the feature
    // l % dl (and those 32 on) of the columns l / dl, + P, + 2 P, ...
    const int W = G * NW, gw = warp * G + blockIdx.x;
    const int nch = (m + p.chunk - 1) / p.chunk, nq = (d + 3) / 4;
    const int dl = d < 32 ? d : 32, P = 32 / dl, k0 = lane % dl, cp = lane / dl;
    const float rho = 0.9f, omr = (float)(1.0 - 0.9), eps = 1e-6f;
    const int nlad = p.lad.n;
    // thread t < nlad: the squarings that take the ladder's running power
    // from term t - 1's to term t's (one exp at the base, then squarings)
    int squarings = 0;
    for (int li = 0, prev = 1; li < nlad && li <= tid; ++li)
        for (squarings = 0; prev < p.lad.power[li]; prev *= 2) ++squarings;
    float bw = 0.f;
    PhaseTimer timer(p.timer != nullptr && blockIdx.x == 0 && tid == 0);

    for (int t = 0; t < p.h.total_steps; ++t) {
        // ---------------- A: rows ----------------
        // this warp's first batch row put in flight, then W and b as G left
        // them into shared memory for A and E
        const int start = p.starts[t];
        float xpre[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
            xpre[j] = row0 < bs ? p.x3[(size_t)(start + row0) * DP + lane + 32 * j] : 0.f;
        for (int l = 0; l < 4; ++l) {
            const int out = wd[l + 1];
            for (int e = tid; e < wd[l] * out; e += NT) {
                const int kk = e / out, k = e - kk * out;
                Ws[woff[l] + kk * wstr[l] + k] = p.w[((size_t)l * WP + kk) * WP + k];
            }
            if (tid < out) bsm[l][tid] = p.b[l * WP + tid];
        }
        __syncthreads();
        float cmax[4] = {0.f, 0.f, 0.f, 0.f}, csum[4] = {0.f, 0.f, 0.f, 0.f};
        for (int i = row0; i < bs; i += row_step) {
            float* hin = rowbuf[warp][0];
            float* hout = rowbuf[warp][1];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int k = lane + 32 * j;
                float z = 0.f;
                if (k < L) {
                    z = p.noise ? p.noise[((size_t)t * bsp + i) * LP + k]
                                : philox_normal(p.h.seed, t, i, k);
                    p.hsT[(size_t)k * bsp + i] = z;
                }
                hin[k] = z;
            }
            __syncwarp();
            for (int l = 0; l < 4; ++l) {
                const int in = wd[l], out = wd[l + 1];
                const float* W = Ws + woff[l];
                const int ws = wstr[l];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int k = lane + 32 * j;
                    if (k < out) {
                        float acc = 0.f;
                        for (int kk = 0; kk < in; ++kk) acc = fmaf(hin[kk], W[kk * ws + k], acc);
                        const float v = acc + bsm[l][k];
                        hout[k] = v;
                        if (l < 3) p.hsT[((size_t)(l + 1) * DP + k) * bsp + i] = v;
                    }
                }
                __syncwarp();
                float* tmp = hin;
                hin = hout;
                hout = tmp;
            }
            // masked softmax with the upper snap
            float yv[4], mx = -3.0e38f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int k = lane + 32 * j;
                yv[j] = k < d ? hin[k] : -1e30f;
                mx = fmaxf(mx, yv[j]);
            }
            mx = warp_max(mx);
            float ev[4], es = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int k = lane + 32 * j;
                ev[j] = k < d ? expf(yv[j] - mx) : 0.f;
                es += ev[j];
            }
            es = warp_sum(es);
            float nx = 0.f, ny = 0.f;
            const float* xrow = p.x3 + (size_t)(start + i) * DP;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int k = lane + 32 * j;
                const float sv = ev[j] / es;
                const float uv = k < d ? (sv >= p.h.thresh ? 1.f : sv) : 0.f;
                const float xv = i == row0 ? xpre[j] : xrow[k];
                const float yv2 = uv * xv;
                p.s[(size_t)i * DP + k] = sv;
                p.u[(size_t)i * DP + k] = uv;
                p.zc[(size_t)i * DP + k] = xv;
                p.zc[(size_t)(bs + i) * DP + k] = yv2;
                nx = fmaf(xv, xv, nx);
                ny = fmaf(yv2, yv2, ny);
                cmax[j] = fmaxf(cmax[j], uv);
                csum[j] += xv;
                csum[j] += yv2;
            }
            nx = warp_sum(nx);
            ny = warp_sum(ny);
            if (lane == 0) {
                p.norms[i] = nx;
                p.norms[bs + i] = ny;
            }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) red[warp][lane + 32 * j] = cmax[j];
        block_vec_reduce(red, p.p_colmax + (size_t)blockIdx.x * DP, true);
        if (t == 0) {
#pragma unroll
            for (int j = 0; j < 4; ++j) red[warp][lane + 32 * j] = csum[j];
            block_vec_reduce(red, p.p_colsum + (size_t)blockIdx.x * DP, false);
        }
        grid.sync();
        timer.lap(0);

        // ------- step 0: the centred closed-form bandwidth, frozen -------
        if (t == 0) {
            lanes_reduce<false>(p.p_colsum, G, d, seg, meanv);
            if (tid < d) meanv[tid] = meanv[tid] / (float)m;
            __syncthreads();
            float ss = 0.f;
            for (int i = row0; i < bs; i += row_step) {
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int k = lane + 32 * j;
                    const float a = p.zc[(size_t)i * DP + k] - meanv[k];
                    const float c = p.zc[(size_t)(bs + i) * DP + k] - meanv[k];
                    ss = fmaf(a, a, ss);
                    ss = fmaf(c, c, ss);
                }
            }
            const float part = block_scalar_reduce(warp_sum(ss), scal);
            if (tid == 0) p.p_scalar[blockIdx.x * 2 + 1] = part;
            grid.sync();
            timer.lap(1);
            const float tot = scalar_reduce(p.p_scalar + 1, 2, G, scal);
            bw = (p.h.bw_m2 * tot) / p.h.bw_den;
            if (blockIdx.x == 0 && tid == 0) {
                p.bw[0] = bw;
                p.bw[1] = 1.f;
            }
        }

        // ---------------- B: column max, ties, Gram pass ----------------
        // The column max and the tie counts are not needed before E: the
        // first ring stage and this thread's first PRE column-max partials
        // are put in flight here, and both are finished after the Gram pass.
        stage_columns(p.zc, p.norms, m, d, p.chunk, p.sd, 0, ring);
        const int Sc = NT / d, kc = tid % d, sc = tid / d;
        float upre[4];  // u of this warp's first row, for its tie counts
#pragma unroll
        for (int j = 0; j < 4; ++j) upre[j] = row0 < bs ? p.u[(size_t)row0 * DP + lane + 32 * j] : 0.f;
        float pre[PRE];
#pragma unroll
        for (int q = 0; q < PRE; ++q) {
            const int g = sc + Sc * q;
            pre[q] = sc < Sc && g < G ? p.p_colmax[(size_t)g * DP + kc] : 0.f;
        }
        const float denom0 = bw * p.lad.base;
        // the ladder as a table in shared memory, walked by a rolled loop:
        // unrolled per term and column it took thousands of instructions
        // and the Gram loop no longer fit the instruction cache
        if (tid < nlad) {
            coef_s[tid] = -1.f / (bw * p.lad.mult[tid]);
            sq_s[tid] = squarings;
        }
        __syncthreads();
        float macc = 0.f;
        // Units, each a row of zc against a range of columns, u = kind bs + i:
        // kind 0: masked row bs + i against the x columns (its K'[q | q zc]
        // there and the MMD of the XY block, as -2 K: XY and YX); kind 1: the
        // same row against the masked columns (K' and the MMD of the YY
        // triangle); kind 2: x row i against the x columns at or after it
        // (the XX triangle, K only). So the MMD takes each unordered pair once,
        // off-diagonal pairs of the triangles twice and the diagonal once.
        // Warp gw takes unit u0 + gw in each round of W units, so every SM
        // holds a share of each kind.
        // With d <= 16 (small) a lane adds K'q times its two columns' values
        // (read again from the ring) into its own 16 sums, reduced over the
        // warp when the unit ends; otherwise K'(q .* zc) goes through kbuf
        // with a lane a feature (32 / d lanes a feature when d < 32).
        const bool small = nq <= 4;
        for (int u0 = 0; u0 < 3 * bs; u0 += W) {
            if (u0 > 0) stage_columns(p.zc, p.norms, m, d, p.chunk, p.sd, 0, ring);
            const int u = u0 + gw, kind = u / bs, i = u - kind * bs;
            const bool live = u < 3 * bs, masked = kind < 2;
            const int r = masked ? bs + i : i;
            const float nrow = live ? p.norms[r] : 0.f;
            float kq = 0.f, kz[16];
#pragma unroll
            for (int q = 0; q < 16; ++q) kz[q] = 0.f;
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
                const int k = lane + 32 * jj;
                rowbuf[warp][0][k] = live ? p.zc[(size_t)r * DP + k] : 0.f;
            }
            __syncwarp();
            const float4* zr = reinterpret_cast<const float4*>(rowbuf[warp][0]);
            for (int ch = 0; ch < nch; ++ch) {
                if (ch + 1 < nch) {
                    stage_columns(p.zc, p.norms, m, d, p.chunk, p.sd, ch + 1,
                                  ring + ((ch + 1) & 1) * p.stage_floats);
                    cp_async_wait<1>();
                } else {
                    cp_async_wait<0>();
                }
                __syncthreads();
                const float* zs = ring + (ch & 1) * p.stage_floats;  // (chunk, sd) columns
                const float* ns = zs + p.chunk * p.sd;                 // their norms
                const int c0 = ch * p.chunk;
                const int lo = max(c0, kind == 0 ? 0 : (kind == 1 ? bs : i));
                const int hi = live ? min(c0 + p.chunk, kind == 1 ? m : bs) : lo;
                // two columns a lane: cb + lane and cb + 32 + lane
                for (int cb = lo; cb < hi; cb += 64) {
                    float kps[2] = {0.f, 0.f}, dot[2] = {0.f, 0.f};
                    const float4* zcol[2];
#pragma unroll
                    for (int h = 0; h < 2; ++h)
                        zcol[h] = reinterpret_cast<const float4*>(
                            zs + (min(cb + 32 * h + lane, hi - 1) - c0) * p.sd);
                    for (int q4 = 0; q4 < nq; ++q4) {
                        const float4 a = zr[q4];
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
                            const float4 b = zcol[h][q4];
                            dot[h] = fmaf(a.x, b.x, dot[h]);
                            dot[h] = fmaf(a.y, b.y, dot[h]);
                            dot[h] = fmaf(a.z, b.z, dot[h]);
                            dot[h] = fmaf(a.w, b.w, dot[h]);
                        }
                    }
                    // both columns in one rolled ladder loop (a lane past hi
                    // works on column hi - 1 and adds nothing), so their chains
                    // interleave
                    float cur[2], kk[2] = {0.f, 0.f};
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int cc = min(cb + 32 * h + lane, hi - 1);
                        const float d2 = fmaxf(nrow + ns[cc - c0] - 2.f * dot[h], 0.f);
                        cur[h] = expf(-d2 / denom0);
                    }
#pragma unroll 1
                    for (int li = 0; li < nlad; ++li) {
                        const float cf = coef_s[li];
                        for (int q = sq_s[li]; q > 0; --q) {
                            cur[0] = cur[0] * cur[0];
                            cur[1] = cur[1] * cur[1];
                        }
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
                            kk[h] += cur[h];
                            kps[h] += cur[h] * cf;
                        }
                    }
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int c = cb + 32 * h + lane;
                        const float w = c >= hi ? 0.f
                                        : kind == 0 ? -2.f : (c > r ? 2.f : (c == r ? 1.f : 0.f));
                        macc = fmaf(w, kk[h], macc);
                        if (c >= hi) kps[h] = 0.f;
                    }
                    if (!masked) continue;
                    if (small) {
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
                            const float kpq = kps[h] * (kind == 0 ? 1.f : -1.f);  // q of the column
                            kq += kpq;
#pragma unroll
                            for (int q4 = 0; q4 < 4; ++q4) {
                                if (q4 < nq) {
                                    const float4 b = zcol[h][q4];
                                    kz[4 * q4 + 0] = fmaf(kpq, b.x, kz[4 * q4 + 0]);
                                    kz[4 * q4 + 1] = fmaf(kpq, b.y, kz[4 * q4 + 1]);
                                    kz[4 * q4 + 2] = fmaf(kpq, b.z, kz[4 * q4 + 2]);
                                    kz[4 * q4 + 3] = fmaf(kpq, b.w, kz[4 * q4 + 3]);
                                }
                            }
                        }
                        continue;
                    }
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const float kpq = kps[h] * (kind == 0 ? 1.f : -1.f);  // q of the column
                        kq += kpq;
                        kbuf[warp][32 * h + lane] = kpq;
                    }
                    __syncwarp();
                    const int ncol = cp < P ? min(64, hi - cb) : 0;
                    for (int cc = cp; cc < ncol; cc += P) {
                        const float kv = kbuf[warp][cc];
                        const float* zrow = zs + (cb + cc - c0) * p.sd;
#pragma unroll
                        for (int jj = 0; jj < 4; ++jj) {
                            const int k = k0 + 32 * jj;
                            if (32 * jj < d && k < d) kz[jj] = fmaf(kv, zrow[k], kz[jj]);
                        }
                    }
                    __syncwarp();
                }
                __syncthreads();  // the next stage's copy refills this buffer
            }
            if (live && masked) {
                // kind 0 (x columns) into the first half of kpq / kpqz, kind 1 the second
                const size_t row = kind == 0 ? i : bsp + i;
                const float v = warp_sum(kq);
                if (lane == 0) p.kpq[row] = v;
                if (small) {
#pragma unroll
                    for (int q = 0; q < 16; ++q) {
                        const float z = warp_sum(kz[q]);
                        if (lane == 0 && q < d) p.kpqz[row * DP + q] = z;
                    }
                } else {
#pragma unroll
                    for (int jj = 0; jj < 4; ++jj) {
                        // the P column phases of a feature, added in phase order
                        float z = kz[jj];
                        for (int c2 = 1; c2 < P; ++c2) z += __shfl_sync(0xffffffffu, kz[jj], lane + c2 * dl);
                        const int k = k0 + 32 * jj;
                        if (cp == 0 && k < d) p.kpqz[row * DP + k] = z;
                    }
                }
            }
        }
        {
            const float part = block_scalar_reduce(warp_sum(macc), scal);
            if (tid == 0) p.p_scalar[blockIdx.x * 2] = part;
        }
        if (sc < Sc) {  // the column max: max is exact, so any order gives the same bits
            float v = 0.f;
#pragma unroll
            for (int q = 0; q < PRE; ++q) v = fmaxf(v, pre[q]);
            for (int g = sc + Sc * PRE; g < G; g += Sc) v = fmaxf(v, p.p_colmax[(size_t)g * DP + kc]);
            seg[sc * d + kc] = v;
        }
        lanes_combine<true>(Sc, d, seg, colv);
        {
            float cnt[4] = {0.f, 0.f, 0.f, 0.f};
            for (int i = row0; i < bs; i += row_step) {
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int k = lane + 32 * j;
                    const float uv = i == row0 ? upre[j] : p.u[(size_t)i * DP + k];
                    if (k < d && uv == colv[k]) cnt[j] += 1.f;
                }
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) red[warp][lane + 32 * j] = cnt[j];
            block_vec_reduce(red, p.p_cnt + (size_t)blockIdx.x * DP, false);
        }
        grid.sync();
        timer.lap(2);

        // ---------------- E: loss, row-wise backward ----------------
        lanes_reduce<false>(p.p_cnt, G, d, seg, cntv);
        if (tid < DP) cntv[tid] = fmaxf(cntv[tid], 1.f);
        if (blockIdx.x == 0) {
            const float mmd = scalar_reduce(p.p_scalar, 2, G, scal);
            if (tid == 0) {
                float pen = 0.f;
                for (int k = 0; k < d; ++k) pen += 1.f - colv[k];
                pen = pen / (float)d;
                p.loss[t] = mmd * p.h.inv + p.h.penalty_weight * pen;
            }
        }
        __syncthreads();
        for (int i = row0; i < bs; i += row_step) {
            float* g_out = rowbuf[warp][0];
            float* g_in = rowbuf[warp][1];
            const float kq = p.kpq[i] + p.kpq[bsp + i];
            const float cq = -p.h.four_inv;  // 4/bs^2 times q = -1 on masked rows
            float dsv[4], sv[4], part = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int k = lane + 32 * j;
                dsv[j] = 0.f;
                sv[j] = 0.f;
                if (k < d) {
                    const size_t o = (size_t)i * DP + k;
                    const float zy = p.zc[(size_t)(bs + i) * DP + k];
                    const float dzc = cq * (kq * zy - (p.kpqz[o] + p.kpqz[(size_t)bsp * DP + o]));
                    float du = dzc * p.zc[o];
                    const float uv = p.u[o];
                    const float eq = uv == colv[k] ? 1.f : 0.f;
                    du = du - (p.h.pw_over_d * eq) / cntv[k];
                    sv[j] = p.s[o];
                    dsv[j] = sv[j] >= p.h.thresh ? 0.f : du;
                    part = fmaf(dsv[j], sv[j], part);
                }
            }
            part = warp_sum(part);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int k = lane + 32 * j;
                const float dy = sv[j] * (dsv[j] - part);
                g_out[k] = dy;
                if (k < d) p.gT[((size_t)3 * DP + k) * bsp + i] = dy;
            }
            __syncwarp();
            for (int l = 3; l >= 1; --l) {
                // dh of layer l - 1's output = dh_l @ W_l^T, from W before its update
                const int in = wd[l], out = wd[l + 1];
                const float* W = Ws + woff[l];
                const int ws = wstr[l];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int jj = lane + 32 * j;
                    if (jj < in) {
                        float acc = 0.f;
                        for (int k = 0; k < out; ++k) acc = fmaf(g_out[k], W[jj * ws + k], acc);
                        g_in[jj] = acc;
                        p.gT[((size_t)(l - 1) * DP + jj) * bsp + i] = acc;
                    }
                }
                __syncwarp();
                float* tmp = g_out;
                g_out = g_in;
                g_in = tmp;
            }
        }
        grid.sync();
        timer.lap(3);

        // ---------------- G: weight gradients and Adadelta ----------------
        {
            int total = 0;
            for (int l = 0; l < 4; ++l) total += wd[l] * wd[l + 1] + wd[l + 1];
            for (int e = row0; e < total; e += row_step) {
                int l = 0, rest = e;
                while (rest >= wd[l] * wd[l + 1] + wd[l + 1]) {
                    rest -= wd[l] * wd[l + 1] + wd[l + 1];
                    ++l;
                }
                const bool is_bias = rest >= wd[l] * wd[l + 1];
                const int kin = is_bias ? 0 : rest / wd[l + 1];
                const int jout = is_bias ? rest - wd[l] * wd[l + 1] : rest % wd[l + 1];
                const float* hcol = p.hsT + ((size_t)l * DP + kin) * bsp;
                const float* gcol = p.gT + ((size_t)l * DP + jout) * bsp;
                const size_t o = is_bias ? (size_t)l * WP + jout : ((size_t)l * WP + kin) * WP + jout;
                float* pp = is_bias ? p.b : p.w;
                float* sq = is_bias ? p.sqb : p.sqw;
                float* ac = is_bias ? p.accb : p.accw;
                float pv = 0.f, sqv = 0.f, acv = 0.f;  // in flight during the sum
                if (lane == 0) {
                    pv = pp[o];
                    sqv = sq[o];
                    acv = ac[o];
                }
                float acc = 0.f;
                for (int i = lane; i < bs; i += 32)
                    acc = is_bias ? acc + gcol[i] : fmaf(hcol[i], gcol[i], acc);
                acc = warp_sum(acc);
                if (lane == 0) {
                    const float gg = acc + p.h.weight_decay * pv;
                    const float nsq = rho * sqv + (omr * gg) * gg;
                    const float delta = gg * sqrtf(acv + eps) / sqrtf(nsq + eps);
                    ac[o] = rho * acv + (omr * delta) * delta;
                    sq[o] = nsq;
                    pp[o] = pv - p.h.lr * delta;
                }
            }
        }
        grid.sync();
        timer.lap(4);
    }
    if (timer.on)
        for (int q = 0; q < PHASES; ++q) p.timer[q] = timer.ns[q];
}

__global__ void philox_fill_kernel(float* __restrict__ out, unsigned seed, int steps, int rows,
                                   int lanes) {
    const size_t total = (size_t)steps * rows * lanes;
    for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
         idx += (size_t)gridDim.x * blockDim.x) {
        const int k = (int)(idx % lanes);
        const size_t rest = idx / lanes;
        const int r = (int)(rest % rows);
        const int s = (int)(rest / rows);
        out[idx] = philox_normal(seed, s, r, k);
    }
}

size_t workspace_floats(int bs, int grid) {
    const size_t bsp = (size_t)((bs + 63) / 64 * 64);
    return 8 * DP * bsp + 2 * bsp * DP + 2 * bsp * DP + 2 * bsp + 2 * bsp + 2 * bsp * DP +
           3 * (size_t)grid * DP + 2 * (size_t)grid;
}

// The ring's layout for width d and m Gram columns: a column takes sd = 4 x
// an odd number >= d / 4 floats (so that lanes reading consecutive columns'
// float4s hit distinct banks), a stage chunk columns (a multiple of 32: all
// of zc in one stage when it fits the ring, else half the ring) and their
// norms.
void ring_layout(int d, int m, Params& p) {
    int q = (d + 3) / 4;
    if (q % 2 == 0) ++q;
    p.sd = 4 * q;
    const int whole = (m + 31) / 32 * 32;
    p.chunk = whole * (p.sd + 1) <= RING_FLOATS ? whole : (RING_FLOATS / 2) / (p.sd + 1) / 32 * 32;
    p.stage_floats = p.chunk * (p.sd + 1);
}

}  // namespace

extern "C" {

// One block per SM, if the card takes a cooperative launch of that many.
int vgan_fused_grid(int* grid, int* barriers) {
    int dev = 0, coop = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (!coop) return static_cast<int>(cudaErrorNotSupported);
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaFuncSetAttribute(fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_kernel, NT, SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    *grid = sms;
    *barriers = BARRIERS_PER_STEP;
    return 0;
}

int vgan_fused_workspace_floats(int bs, int grid) {
    return static_cast<int>(workspace_floats(bs, grid));
}

// w, b, sqw, sqb, accw, accb hold the initial state and are updated in place;
// work: vgan_fused_workspace_floats(bs, grid) floats of scratch; timer: null,
// or PHASES counters that receive each phase's nanoseconds over the fit.
int vgan_fused_no_kl(const float* x3, const int* starts, const float* noise, float* w, float* b,
                     float* sqw, float* sqb, float* accw, float* accb, float* loss, float* bw,
                     float* work, const VganFusedHyper* hyper, const VganFusedLadder* lad,
                     int grid, unsigned long long* timer, void* stream) {
    if (hyper->bs < 2 || hyper->d < 1 || hyper->d > DP || hyper->latent < 1 ||
        8 * hyper->latent > WP || hyper->total_steps < 1 || lad->n < 1 ||
        lad->n > MAX_LADDER || grid < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    Params p;
    p.x3 = x3;
    p.starts = starts;
    p.noise = noise;
    p.w = w;
    p.b = b;
    p.sqw = sqw;
    p.sqb = sqb;
    p.accw = accw;
    p.accb = accb;
    p.loss = loss;
    p.bw = bw;
    p.bsp = (hyper->bs + 63) / 64 * 64;
    const size_t bsp = (size_t)p.bsp;
    float* cur = work;
    p.hsT = cur; cur += 4 * DP * bsp;
    p.gT = cur; cur += 4 * DP * bsp;
    p.s = cur; cur += bsp * DP;
    p.u = cur; cur += bsp * DP;
    p.zc = cur; cur += 2 * bsp * DP;
    p.norms = cur; cur += 2 * bsp;
    p.kpq = cur; cur += 2 * bsp;
    p.kpqz = cur; cur += 2 * bsp * DP;
    p.p_colmax = cur; cur += (size_t)grid * DP;
    p.p_cnt = cur; cur += (size_t)grid * DP;
    p.p_colsum = cur; cur += (size_t)grid * DP;
    p.p_scalar = cur;
    p.timer = timer;
    p.h = *hyper;
    p.lad = *lad;
    ring_layout(hyper->d, 2 * hyper->bs, p);
    void* args[] = {&p};
    cudaError_t e =
        cudaFuncSetAttribute(fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fused_kernel), dim3(grid), dim3(NT),
                                    args, SMEM_BYTES, static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

// out: (steps, rows, lanes) float32, the normals of steps 0 .. steps - 1.
int vgan_philox_normal(float* out, unsigned seed, int steps, int rows, int lanes, void* stream) {
    if (steps < 1 || rows < 1 || lanes < 1) return static_cast<int>(cudaErrorInvalidValue);
    const size_t total = (size_t)steps * rows * lanes;
    const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
    philox_fill_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(out, seed, steps,
                                                                            rows, lanes);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
