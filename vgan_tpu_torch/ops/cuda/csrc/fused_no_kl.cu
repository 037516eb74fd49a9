// The whole no-kl fit in one launch (K8) for Hopper (sm_90a), IEEE f32.
//
//   fused_kernel  <- vgan_tpu/ops/pallas/fused_no_kl.py:_kernel_body
//
// One persistent cooperative launch runs every train step of the fit in
// order. Parameters, Adadelta state and every intermediate live in device
// memory (all of it a few MB, so L2-resident); grid-wide barriers
// (cooperative_groups::this_grid().sync()) separate the phases of a step:
//
//   A  rows: per batch row (one warp a row) the noise (in-kernel Philox or an
//      injected buffer), the 4 linear layers, the masked upper softmax, the
//      row of zc = [batch; u * batch] and its squared norms; per block the
//      column max of u (and, at step 0, the column sums of zc);
//   -- barrier (at step 0 one more: the centred closed-form bandwidth needs
//      the mean first, then the sum of squares; it is then frozen) --
//   B  the column max reduced in block order; per block the tie counts of
//      its rows; the Gram strip pass: each block owns 8-row tiles of zc and
//      walks 32-column tiles, recomputing d2 and the bandwidth ladder (one
//      exp, then squarings) per entry, and accumulates K'q, K'(q .* zc)
//      and its MMD partial. The (m, m) Gram is never stored;
//   -- barrier --
//   E  the MMD and the tie counts reduced in block order, the loss; per row
//      the rank-1 backward dzc = 4/bs^2 q .* (K'q .* zc - K'(q .* zc)), the
//      coverage gradient split evenly among ties, the upper-softmax
//      backward and the whole dh chain through layers 3 -> 1 (row-wise, so
//      every dh is taken from W before its update);
//   -- barrier --
//   G  one warp per parameter entry sums hs^T dh over the batch rows and
//      takes the torch-parity Adadelta step (L2 weight decay in the
//      gradient, rho 0.9, eps 1e-6);
//   -- barrier --
//
// so four barriers a step. Rows are compact: x rows [0, bs), masked rows
// [bs, 2 bs); the Pallas kernel's pad rows contribute exact zeros there.
//
// What bounds it on an H100: per step two Gram products over 2 bs rows at
// width d, about 20 operations per Gram entry for the ladder, and the tiny
// generator GEMMs: about 1 us of non-tensor f32 work at the notebook shape
// (bs 500, d 10). This design is bound instead by its barriers and by
// latency: a step is four grid-wide syncs and a handful of dependent L2
// round trips per phase. Fusing phases, keeping W in shared memory and
// splitting the Gram more finely are left to later work.
//
// Numerics: IEEE f32 (expf, logf, cosf, sqrtf; the file must not be built
// with --use_fast_math), d2 the clamped expansion max(|a|^2 + |b|^2 - 2 ab, 0)
// as the Pallas kernel forms it. The noise generator is one __device__
// function used by the fit and by the fill kernel alike, written with
// __fmul_rn / __fadd_rn so no FMA contraction can differ between the two.
//
// Determinism: no atomics; every cross-block sum is a per-block partial
// reduced in block order after a barrier, so re-runs give identical bits.
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
constexpr int NT = 256;   // threads per block
constexpr int NW = NT / 32;
constexpr int TR = NW;    // Gram rows per tile: one warp a row
constexpr int TC = 32;    // Gram columns per staged tile: one lane a column
constexpr int ZS = DP + 1;  // shared row stride of the column tile (no bank conflicts)
constexpr int MAX_LADDER = 8;
constexpr int BARRIERS_PER_STEP = 4;

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
    float* kpq;   // (2 bsp,)
    float* kpqz;  // (2 bsp, DP)
    float* p_colmax;  // (grid, DP)
    float* p_cnt;     // (grid, DP)
    float* p_colsum;  // (grid, DP)
    float* p_scalar;  // (grid, 2): MMD partial, centred sum of squares
    VganFusedHyper h;
    VganFusedLadder lad;
    int bsp;
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

__global__ void __launch_bounds__(NT, 1) fused_kernel(Params p) {
    cg::grid_group grid = cg::this_grid();
    __shared__ float rowbuf[NW][2][WP];
    __shared__ float Zr[TR][DP];
    __shared__ float Zc[TC][ZS];
    __shared__ float Ks[TR][TC];
    __shared__ float nc_s[TC], qc_s[TC];
    __shared__ float red[NW][DP];
    __shared__ float colv[DP], cntv[DP], meanv[DP];
    __shared__ float scal[NW];

    const int G = gridDim.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int bs = p.h.bs, d = p.h.d, L = p.h.latent, bsp = p.bsp, m = 2 * bs;
    const int wd[5] = {L, 2 * L, 4 * L, 8 * L, d};
    const int row0 = blockIdx.x * NW + warp, row_step = G * NW;
    const float rho = 0.9f, omr = (float)(1.0 - 0.9), eps = 1e-6f;
    float bw = 0.f;

    for (int t = 0; t < p.h.total_steps; ++t) {
        // ---------------- A: rows ----------------
        const int start = p.starts[t];
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
                const float* W = p.w + (size_t)l * WP * WP;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int k = lane + 32 * j;
                    if (k < out) {
                        float acc = 0.f;
                        for (int kk = 0; kk < in; ++kk) acc = fmaf(hin[kk], W[kk * WP + k], acc);
                        const float v = acc + p.b[l * WP + k];
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
                const float xv = xrow[k];
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

        // ------- step 0: the centred closed-form bandwidth, frozen -------
        if (t == 0) {
            if (tid < DP) {
                float c = 0.f;
                for (int g = 0; g < G; ++g) c += p.p_colsum[(size_t)g * DP + tid];
                meanv[tid] = c / (float)m;
            }
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
            float tot = 0.f;
            for (int g = 0; g < G; ++g) tot += p.p_scalar[g * 2 + 1];
            bw = (p.h.bw_m2 * tot) / p.h.bw_den;
            if (blockIdx.x == 0 && tid == 0) {
                p.bw[0] = bw;
                p.bw[1] = 1.f;
            }
        }

        // ---------------- B: column max, ties, Gram strips ----------------
        if (tid < DP) {
            float c = 0.f;
            for (int g = 0; g < G; ++g) c = fmaxf(c, p.p_colmax[(size_t)g * DP + tid]);
            colv[tid] = c;
        }
        __syncthreads();
        {
            float cnt[4] = {0.f, 0.f, 0.f, 0.f};
            for (int i = row0; i < bs; i += row_step) {
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int k = lane + 32 * j;
                    if (k < d && p.u[(size_t)i * DP + k] == colv[k]) cnt[j] += 1.f;
                }
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) red[warp][lane + 32 * j] = cnt[j];
            block_vec_reduce(red, p.p_cnt + (size_t)blockIdx.x * DP, false);
        }
        const float denom0 = bw * p.lad.base;
        float coef[MAX_LADDER];
#pragma unroll
        for (int li = 0; li < MAX_LADDER; ++li)
            coef[li] = li < p.lad.n ? -1.f / (bw * p.lad.mult[li]) : 0.f;
        float macc = 0.f;
        for (int tile = blockIdx.x; tile * TR < m; tile += G) {
            const int r = tile * TR + warp;
            const bool live = r < m;
            const float nr = live ? p.norms[r] : 0.f;
            const float qr = r < bs ? 1.f : -1.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int k = lane + 32 * j;
                Zr[warp][k] = (live && k < d) ? p.zc[(size_t)r * DP + k] : 0.f;
            }
            float kz[4] = {0.f, 0.f, 0.f, 0.f}, kq = 0.f;
            for (int c0 = 0; c0 < m; c0 += TC) {
                __syncthreads();
                for (int idx = tid; idx < TC * d; idx += NT) {
                    const int cc = idx / d, k = idx - cc * d;
                    Zc[cc][k] = c0 + cc < m ? p.zc[(size_t)(c0 + cc) * DP + k] : 0.f;
                }
                if (tid < TC) {
                    nc_s[tid] = c0 + tid < m ? p.norms[c0 + tid] : 0.f;
                    qc_s[tid] = c0 + tid < bs ? 1.f : -1.f;
                }
                __syncthreads();
                if (!live) continue;
                const int ncol = min(TC, m - c0);
                float kps = 0.f;
                if (lane < ncol) {
                    float dot = 0.f;
                    for (int k = 0; k < d; ++k) dot = fmaf(Zr[warp][k], Zc[lane][k], dot);
                    const float d2 = fmaxf(nr + nc_s[lane] - 2.f * dot, 0.f);
                    const float qc = qc_s[lane];
                    float cur = expf(-d2 / denom0);
                    int prev = 1;
                    for (int li = 0; li < p.lad.n; ++li) {
                        while (prev < p.lad.power[li]) {
                            cur = cur * cur;
                            prev *= 2;
                        }
                        macc += cur * qr * qc;
                        kps += cur * coef[li];
                    }
                    kq = fmaf(kps, qc, kq);
                }
                Ks[warp][lane] = kps;
                __syncwarp();
                for (int cc = 0; cc < ncol; ++cc) {
                    const float kv = Ks[warp][cc], qv = qc_s[cc];
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const int k = lane + 32 * j;
                        if (k < d) kz[j] = fmaf(kv, qv * Zc[cc][k], kz[j]);
                    }
                }
                __syncwarp();
            }
            if (live) {
                kq = warp_sum(kq);
                if (lane == 0) p.kpq[r] = kq;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int k = lane + 32 * j;
                    if (k < d) p.kpqz[(size_t)r * DP + k] = kz[j];
                }
            }
        }
        {
            const float part = block_scalar_reduce(warp_sum(macc), scal);
            if (tid == 0) p.p_scalar[blockIdx.x * 2] = part;
        }
        grid.sync();

        // ---------------- E: loss, row-wise backward ----------------
        if (tid < DP) {
            float c = 0.f;
            for (int g = 0; g < G; ++g) c += p.p_cnt[(size_t)g * DP + tid];
            cntv[tid] = fmaxf(c, 1.f);
        }
        if (blockIdx.x == 0 && tid == 0) {
            float mmd = 0.f;
            for (int g = 0; g < G; ++g) mmd += p.p_scalar[g * 2];
            float pen = 0.f;
            for (int k = 0; k < d; ++k) pen += 1.f - colv[k];
            pen = pen / (float)d;
            p.loss[t] = mmd * p.h.inv + p.h.penalty_weight * pen;
        }
        __syncthreads();
        for (int i = row0; i < bs; i += row_step) {
            float* g_out = rowbuf[warp][0];
            float* g_in = rowbuf[warp][1];
            const float kq = p.kpq[bs + i];
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
                    const float dzc = cq * (kq * zy - p.kpqz[(size_t)(bs + i) * DP + k]);
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
                const float* W = p.w + (size_t)l * WP * WP;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int jj = lane + 32 * j;
                    if (jj < in) {
                        float acc = 0.f;
                        for (int k = 0; k < out; ++k) acc = fmaf(g_out[k], W[jj * WP + k], acc);
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
                float acc = 0.f;
                for (int i = lane; i < bs; i += 32)
                    acc = is_bias ? acc + gcol[i] : fmaf(hcol[i], gcol[i], acc);
                acc = warp_sum(acc);
                if (lane == 0) {
                    const size_t o = is_bias ? (size_t)l * WP + jout
                                             : ((size_t)l * WP + kin) * WP + jout;
                    float* pp = is_bias ? p.b : p.w;
                    float* sq = is_bias ? p.sqb : p.sqw;
                    float* ac = is_bias ? p.accb : p.accw;
                    const float pv = pp[o];
                    const float gg = acc + p.h.weight_decay * pv;
                    const float nsq = rho * sq[o] + (omr * gg) * gg;
                    const float delta = gg * sqrtf(ac[o] + eps) / sqrtf(nsq + eps);
                    ac[o] = rho * ac[o] + (omr * delta) * delta;
                    sq[o] = nsq;
                    pp[o] = pv - p.h.lr * delta;
                }
            }
        }
        grid.sync();
    }
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
    return 8 * DP * bsp + 2 * bsp * DP + 2 * bsp * DP + 2 * bsp * 2 + 2 * bsp * DP +
           3 * (size_t)grid * DP + 2 * (size_t)grid;
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
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_kernel, NT, 0);
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
// work: vgan_fused_workspace_floats(bs, grid) floats of scratch.
int vgan_fused_no_kl(const float* x3, const int* starts, const float* noise, float* w, float* b,
                     float* sqw, float* sqb, float* accw, float* accb, float* loss, float* bw,
                     float* work, const VganFusedHyper* hyper, const VganFusedLadder* lad,
                     int grid, void* stream) {
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
    p.h = *hyper;
    p.lad = *lad;
    void* args[] = {&p};
    cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fused_kernel), dim3(grid),
                                                dim3(NT), args, 0,
                                                static_cast<cudaStream_t>(stream));
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
