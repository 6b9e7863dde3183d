// K11-K14: the BlazeFace training step's backward, loss and optimizer,
// NHWC f32 throughout, kernels HWIO as flax stores them.
//
// K11 — the backward of K9 (a 5x5 convolution with SAME padding, stride 1
// or 2): the input gradient of a depthwise convolution (a transposed
// depthwise correlation of the output gradient), optionally added into a
// given gradient of the same input (the block's residual gradient from K12),
// and the weight gradient [5, 5, 1, C] of a depthwise one or
// [5, 5, C_in, C_out] (+ the bias gradient) of the stem, whose ReLU it
// undoes from the saved output.
// K12 — the backward of K10 (out = relu(y . W + b + pad(pool2x2(res)))):
// the ReLU mask from the saved output, dy = g . W^T, dW = y^T . g,
// db = sum g, and the residual's gradient: the first C_res channels of g,
// at stride 2 routed to the first maximum of each 2x2 window in row-major
// order (what XLA's select-and-scatter with `ge` and torch's max_pool2d
// both do). With no ReLU and no residual it is the heads' backward.
// K13 — the heads' forward fused with the loss and its gradient: the raw
// logits and offsets of both anchor maps, sigmoid, the focal-weighted BCE
// with its 1e-7 terms and the masked smooth-L1, differentiated as JAX
// differentiates the written expression (d log(p + 1e-7) = 1 / (p + 1e-7),
// d logistic = ans (1 - ans)); one launch: a block a tile of pixels of
// one map; every block sums the whole normaliser mask itself in the same
// order (so all agree on the reg normaliser sum(mask) * 4 + 1e-6) and
// scales its own draw; the last block by ticket sums the tiles' loss
// partials in tile order. The normalisers are the launch's arguments: the
// mask summed (`norm_mask`, `norm_n` members) and the count of the focal
// mean. A whole batch passes its own mask and count; a data-parallel
// shard passes the global batch's, because the loss is a mean over the
// global batch and its smooth-L1 a sum over the global batch's mask, and no
// scaling afterwards can fix a shard's local ones (K12 mixes the two terms
// into the backbone's gradient).
// K14 — optax.adam's update in one elementwise pass over the flat
// parameters with their first and second moments. Bound by bytes: it reads
// params, grads, mu and nu and writes params, mu and nu once (2.99 MB at
// the model's 106,940 values, 0.00089 ms at 3.35 TB/s), so its time is a
// launch and one pass that hides the latency of its loads and of four
// IEEE divisions and a square root a value. A grid-stride loop of scalar
// values (418 blocks of 256 at 106,940, so a thread takes one value: many
// warps an SM to hide that latency), the step's constants by value from the
// host. A form of four values a thread with 16-byte loads in one wave of
// 105 blocks read slower on the H100, alone and in the train step
// (PERF.md), so this form stays.
//
// Replaces what jax.value_and_grad and optax.adam(1e-3) make of the JAX
// package's flyimg_tpu/models/blazeface.py loss_fn (:347) and
// make_train_step (:366): XLA's fused backward convolutions, reductions
// and elementwise update.
//
// What bounds K11 and K12 on an H100: bytes. At batch 16 their 37 calls
// move ~0.28 GB (the saved activations read back, their gradients written)
// against ~2.1 GFLOP of f32 FMAs; the 16x16 and 8x8 layers are a few
// microseconds each, set by latency. Design (host side: blazeface_train.py
// k11_plan, k12_plan): one launch a call, and every sum over pixels in a
// fixed order with no float atomics, so a gradient is the same bits from run
// to run. A weight gradient is cut into tiles (K12: up to 32 x 32 (ci, co);
// K11: a slice of 8 channels); each tile's pixels into chunks, a block a
// (tile, chunk) writing its partial sums; each block then takes a ticket on
// its tile's counter (integer atomic, after a __threadfence), and the last
// block of a tile sums the tile's partials in chunk order (read past L1)
// and resets the counter for the next call (K12, past 24 chunks, in two
// levels: the last block of each group of ~sqrt(chunks) chunks sums the
// group, the last of those the groups, so no one block sums them all). The scratch is the wrapper's,
// kept per (device, stream). Tiles are staged in shared memory with
// cp.async (16-byte spans where the channel count allows, else 8 or 4),
// rows at a padded pitch so a warp's 16-byte reads hit distinct banks.
//
// K12, one launch of two roles: the first blocks each take one dW tile of
// one chunk (rows of 32 pixels, four stages, three in flight while one is
// summed: the role is latency-bound otherwise; a thread owns 4 ci x 4 co of
// the tile and every KS-th pixel, the KS lanes then summed in order in
// shared memory; db from the same staged rows); the rest take 16-64
// pixels each: the weights staged once at a padded pitch, the masked and
// scaled gradient, dy = g . W^T with a thread owning 4 pixels x 4 ci (each
// float4 of g and of W read feeds 4 FMAs a pair), and the residual's gradient
// from the staged g (the first maximum of each 2x2 window at stride 2).
//
// K11, one launch: a block takes one channel slice and a chunk of tiles
// (whole-width bands of output-gradient rows of one image), two stages: the
// slice's g window (the band and a 2-row halo) and the x window under it,
// the SAME halo written as zeros, never loaded. dx: a thread owns a float4
// of channels x a run of 4 outputs of one row and slides the flipped 5x5
// window along it in registers; at stride 2 the outputs are split by parity
// class, each a fixed 3x3, 3x2, 2x3 or 2x2 subset of taps, so no tap is
// tested. With an input gradient to add to, dx = that + the sum (one
// rounding, as autograd's add). dk: a thread owns a float4 of channels x
// one kernel row (20 sums) and every L-th run of 4 outputs of the band,
// sliding the x row; the L lanes are summed in order. The stem (C_in = 3
// -> 24, no dx): the same with a float4 of output channels x one kernel
// row x one input channel a thread.
//
// No tensor cores: TF32 products would miss the 1e-4 relative bound, and
// the work is bound by bytes. Products are FMAs (the plain twins are cuDNN
// and torch.matmul, whose order differs anyway); K13 and K14 round every
// product and sum as written (__f*_rn intrinsics).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 25;
constexpr int kThreads = 256;
constexpr int kAnchors = 896;
constexpr int kRun = 4;          // K11: outputs a thread's window slides over
constexpr int kMaxTile = 32;     // K12: the most channels on a side of a dW tile
constexpr int kDwSubPx = 32;     // K12: pixels in a sub-tile a dW block stages at a time
constexpr int kDwStages = 4;     // K12: sub-tiles of pixels a dW block stages (3 ahead)
constexpr int kDwRed = 20;       // K12: sums a dW thread hands to the lane reduction
constexpr int kConvRed = 24;     // K11: sums a dk thread hands to it (20 + 4 bias)
constexpr int kSmemMax = 227 * 1024;
constexpr int kHeadThreads = 128;  // K13: a block's threads (a thread an anchor)
constexpr int kHeadWarps = kHeadThreads / 32;

int blocks_for(long long total, int threads) {
    const long long want = (total + threads - 1) / threads;
    return (int)(want < 132 * 8 ? want : 132 * 8);
}

// device memory to shared, asynchronously, `bytes` (4, 8 or 16) at a time
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
    const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
    if constexpr (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(BYTES)
                     : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prior() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// a staged row's pitch in floats: an odd number of 16-byte chunks
__host__ __device__ __forceinline__ int row_pitch(int c) { return 4 * (((c + 3) >> 2) | 1); }

// the widest of 4, 2, 1 floats that divides c and the alignment of p
__host__ __device__ __forceinline__ int vec_width(long long c, const void* p) {
    const uintptr_t a = (uintptr_t)p;
    return c % 4 == 0 && a % 16 == 0 ? 4 : c % 2 == 0 && a % 8 == 0 ? 2 : 1;
}

__device__ __forceinline__ float4 zero4() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// acc += v * w, a lane each
__device__ __forceinline__ void fma4(float4& acc, const float4 v, const float4 w) {
    acc.x = __fmaf_rn(v.x, w.x, acc.x);
    acc.y = __fmaf_rn(v.y, w.y, acc.y);
    acc.z = __fmaf_rn(v.z, w.z, acc.z);
    acc.w = __fmaf_rn(v.w, w.w, acc.w);
}
// acc += v * s
__device__ __forceinline__ void fma4s(float4& acc, const float4 v, const float s) {
    acc.x = __fmaf_rn(v.x, s, acc.x);
    acc.y = __fmaf_rn(v.y, s, acc.y);
    acc.z = __fmaf_rn(v.z, s, acc.z);
    acc.w = __fmaf_rn(v.w, s, acc.w);
}
__device__ __forceinline__ void add4(float4& acc, const float4 v) {
    acc.x = __fadd_rn(acc.x, v.x);
    acc.y = __fadd_rn(acc.y, v.y);
    acc.z = __fadd_rn(acc.z, v.z);
    acc.w = __fadd_rn(acc.w, v.w);
}

// zero `nfloats` (a multiple of 4) of shared memory, then wait for all
__device__ __forceinline__ void zero_shared(float* p, int nfloats) {
    float4* z = reinterpret_cast<float4*>(p);
    for (int i = threadIdx.x; i < (nfloats >> 2); i += kThreads) z[i] = zero4();
    __syncthreads();
}

// k (<= 4) channels v to o, stored as a float4, float2s or floats; with
// `add`, o + v (one rounding each)
__device__ __forceinline__ void store4(float* o, float4 v, int k, const float* add, int vec) {
    if (add != nullptr) {
        if (vec == 4 && k == 4) {
            add4(v, ld4(add));
        } else {
            float r[4] = {v.x, v.y, v.z, v.w};
            for (int e = 0; e < k; ++e) r[e] = __fadd_rn(add[e], r[e]);
            v = make_float4(r[0], r[1], r[2], r[3]);
        }
    }
    if (vec == 4 && k == 4) {
        *reinterpret_cast<float4*>(o) = v;
    } else if (vec == 2 && (k & 1) == 0) {
        *reinterpret_cast<float2*>(o) = make_float2(v.x, v.y);
        if (k == 4) *reinterpret_cast<float2*>(o + 2) = make_float2(v.z, v.w);
    } else {
        const float r[4] = {v.x, v.y, v.z, v.w};
        for (int e = 0; e < k; ++e) o[e] = r[e];
    }
}

// ------------------------------------------------ K11 and K12: staging, tickets

// pixel rows of `c` floats: dense (pixel p at base + p c) or member-strided
// (pixel p = b hw + q at base + b bstride + q c)
struct Rows {
    const float* base;
    long long bstride;
    int hw, c, dense;
    __device__ __forceinline__ const float* row(int p) const {
        if (dense) return base + (size_t)p * c;
        const int b = p / hw;
        return base + b * bstride + (size_t)(p - b * hw) * c;
    }
};

// channels [c0, c0 + nc) of pixels p0 .. p0 + np - 1 into dst rows of
// `pitch` floats, VEC floats a copy (VEC divides c, c0, nc and the base's
// alignment)
template <int VEC>
__device__ __forceinline__ void stage_slice_by(float* dst, int pitch, const Rows& src, int p0,
                                               int np, int c0, int nc) {
    const int per = nc / VEC;
    for (int e = threadIdx.x; e < np * per; e += kThreads) {
        const int r = e / per, j = e - r * per;
        cp_async<4 * VEC>(dst + r * pitch + VEC * j, src.row(p0 + r) + c0 + VEC * j);
    }
}
__device__ __forceinline__ void stage_slice(float* dst, int pitch, const Rows& src, int p0, int np,
                                            int c0, int nc, int vec) {
    if (vec == 4)
        stage_slice_by<4>(dst, pitch, src, p0, np, c0, nc);
    else if (vec == 2)
        stage_slice_by<2>(dst, pitch, src, p0, np, c0, nc);
    else
        stage_slice_by<1>(dst, pitch, src, p0, np, c0, nc);
}

// K11's window: staged rows [r_lo, r_hi) (of `rows`, `rp` floats each) from
// image rows gy0 + r of image b: `w` pixels of channels [c0, c0 + nc) (of c
// a pixel), pixel j at col0 + j pc floats into its row; the rows outside the
// image are zeroed, the columns outside it never written (the prologue's
// zeros). A whole contiguous row is w = 1, c = the row's floats.
template <int VEC>
__device__ __forceinline__ void stage_window_by(float* st, int rp, int pc, int col0,
                                                const float* src, int b, int gy0, int r_lo,
                                                int r_hi, int h, int w, int c, int c0, int nc) {
    const int per = nc / VEC, row_elems = w * per;
    const int total = (r_hi - r_lo) * row_elems;
    for (int e = threadIdx.x; e < total; e += kThreads) {
        const int rr = e / row_elems, rem = e - rr * row_elems;
        const int j = rem / per, q = rem - j * per;
        const int r = r_lo + rr;
        cp_async<4 * VEC>(st + r * rp + col0 + j * pc + VEC * q,
                          src + ((size_t)(b * h + gy0 + r) * w + j) * c + c0 + VEC * q);
    }
}
__device__ __forceinline__ void load_window(float* st, int rows, int rp, int pc, int col0,
                                            const float* src, int b, int gy0, int h, int w, int c,
                                            int c0, int nc, int vec) {
    const int r_lo = min(rows, max(0, -gy0));
    const int r_hi = max(r_lo, min(rows, h - gy0));
    float4* st4 = reinterpret_cast<float4*>(st);
    const int q = rp >> 2, nz = r_lo + rows - r_hi;
    for (int e = threadIdx.x; e < nz * q; e += kThreads) {
        const int row = e / q, r = row < r_lo ? row : r_hi + row - r_lo;
        st4[r * q + (e - row * q)] = zero4();
    }
    if (vec == 4)
        stage_window_by<4>(st, rp, pc, col0, src, b, gy0, r_lo, r_hi, h, w, c, c0, nc);
    else if (vec == 2)
        stage_window_by<2>(st, rp, pc, col0, src, b, gy0, r_lo, r_hi, h, w, c, c0, nc);
    else
        stage_window_by<1>(st, rp, pc, col0, src, b, gy0, r_lo, r_hi, h, w, c, c0, nc);
}

// g (nfloats, a multiple of 4, in place) scaled by *gscale when given, and
// zeroed where the saved output `so` (beside it, the same layout) is not > 0
__device__ __forceinline__ void mask_scale(float* sg, const float* so, int nfloats,
                                           const float* gscale) {
    const float scale = gscale != nullptr ? *gscale : 1.0f;
    float4* g4 = reinterpret_cast<float4*>(sg);
    for (int i = threadIdx.x; i < (nfloats >> 2); i += kThreads) {
        float4 v = g4[i];
        if (gscale != nullptr)
            v = make_float4(__fmul_rn(v.x, scale), __fmul_rn(v.y, scale), __fmul_rn(v.z, scale),
                            __fmul_rn(v.w, scale));
        if (so != nullptr) {
            const float4 o = ld4(so + 4 * i);
            v = make_float4(o.x > 0.0f ? v.x : 0.0f, o.y > 0.0f ? v.y : 0.0f,
                            o.z > 0.0f ? v.z : 0.0f, o.w > 0.0f ? v.w : 0.0f);
        }
        g4[i] = v;
    }
}

// The ticket: every thread's partials are written; true in the one block
// that takes the last of `total` tickets on `counter`.
__device__ __forceinline__ bool last_block(unsigned* counter, unsigned total) {
    __shared__ int is_last;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) is_last = atomicAdd(counter, 1u) == total - 1u;
    __syncthreads();
    const bool last = is_last != 0;
    if (last) __threadfence();
    return last;
}

// sum over parts c = 0, 1, ... of the float4 at p + c m, in that order,
// read past L1 (p 16-byte aligned, m a multiple of 4)
__device__ __forceinline__ float4 sum_parts4(const float* p, int parts, int m) {
    float4 s = zero4();
    int c = 0;
    for (; c + 8 <= parts; c += 8) {
        float4 v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = __ldcg(reinterpret_cast<const float4*>(p + (size_t)(c + k) * m));
#pragma unroll
        for (int k = 0; k < 8; ++k) add4(s, v[k]);
    }
    for (; c < parts; ++c) add4(s, __ldcg(reinterpret_cast<const float4*>(p + (size_t)c * m)));
    return s;
}

// ---------------------------------------------------------------- K11

struct ConvArgs {
    const float* x;       // [n, h, w, cin]
    const float* g;       // [n, oh, ow, c]
    const float* out;     // the saved output (ReLU mask) or null
    const float* kernel;  // [5, 5, 1, c] (depthwise)
    float* dx;            // [n, h, w, c] or null
    const float* dx_add;  // added into dx (may be dx itself) or null
    float* dk;
    float* db;
    float* partial;
    unsigned* counters;
    int n, h, w, cin, oh, ow, c, pad_top, pad_left;
    int cs, slices, tho, bands, tiles, tpc, chunks;
    int g_rows, gp, x_rows, xp, lead, lanes;
    int vec_x, vec_g, vec_o, vec_k, vec_dx;
};

// dx of one run of kRun outputs (n0 .. n0 + kRun - 1 along the row) of the
// parity class whose taps are ky = 2 s + py (s < TY), kx = 2 t + px (t < TX);
// at stride 1, TY = TX = 5 and py = px = 0. Output n reads the g window's
// row `row0 - s` at column n - t (+ `col0`): the flipped window slides along
// the run, each staged value read once a row.
template <int TY, int TX>
__device__ __forceinline__ void dx_run(float4 acc[kRun], const float* sg, const float* sk, int gp,
                                       int cs, int c4, int row0, int n0, int py, int px) {
#pragma unroll
    for (int r = 0; r < kRun; ++r) acc[r] = zero4();
#pragma unroll
    for (int s = 0; s < TY; ++s) {
        const int ky = TY == 5 ? s : 2 * s + py;
        float4 wk[TX];
#pragma unroll
        for (int t = 0; t < TX; ++t)
            wk[t] = ld4(sk + (ky * 5 + (TX == 5 ? t : 2 * t + px)) * cs + 4 * c4);
        const float* row = sg + (row0 - s) * gp + (n0 - (TX - 1)) * cs + 4 * c4;
#pragma unroll
        for (int j = 0; j < kRun + TX - 1; ++j) {
            const float4 v = ld4(row + j * cs);
#pragma unroll
            for (int r = 0; r < kRun; ++r) {
                const int t = r + TX - 1 - j;
                if (t >= 0 && t < TX) fma4(acc[r], v, wk[t]);
            }
        }
    }
}

// store a dx run: outputs r < count of row iy from column ix0, `step` apart
__device__ __forceinline__ void store_dx_run(const ConvArgs& a, const float4 acc[kRun], int b,
                                             int iy, int ix0, int step, int count, int c0, int c4,
                                             int nc) {
    const int kc = min(4, nc - 4 * c4);
    for (int r = 0; r < kRun && r < count; ++r) {
        const size_t o = ((size_t)(b * a.h + iy) * a.w + ix0 + r * step) * a.c + c0 + 4 * c4;
        store4(a.dx + o, acc[r], kc, a.dx_add != nullptr ? a.dx_add + o : nullptr, a.vec_dx);
    }
}

// floor(a / 2) for any sign
__device__ __forceinline__ int half_floor(int a) { return a >= 0 ? a >> 1 : -((1 - a) >> 1); }

// K11, depthwise form at stride S: see the header. Block (slice, chunk),
// slices fastest; the window of band oy0 holds g rows oy0 - 2 .. and x rows
// S oy0 - pad_top .., a pixel every cs floats (g column u is ox = u - 2, x
// column u is ix = u - pad_left).
template <int S>
__global__ void __launch_bounds__(kThreads) dw_backward_kernel(const ConvArgs a) {
    extern __shared__ __align__(16) float sm[];
    const int tid = threadIdx.x;
    const int slice = blockIdx.x % a.slices, chunk = blockIdx.x / a.slices;
    const int c0 = slice * a.cs, nc = min(a.cs, a.c - c0), c4n = a.cs >> 2;
    const int masked = a.out != nullptr;
    const int g_f = a.g_rows * a.gp, stage = (1 + masked) * g_f + a.x_rows * a.xp;
    const int t0 = chunk * a.tpc, t1 = min(a.tiles, t0 + a.tpc);
    float* sk = sm;              // [25, cs]: the kernel's slice
    float* st = sk + 25 * a.cs;  // stages: g window, (saved output window), x window
    zero_shared(sm, 25 * a.cs + (t1 - t0 > 1 ? 2 : 1) * stage);
    stage_slice(sk, a.cs, Rows{a.kernel, 0, 1, a.c, 1}, 0, kTaps, c0, nc, a.vec_k);
    auto load = [&](int t, int s) {
        if (t >= t1) return;
        const int b = t / a.bands, oy0 = (t - b * a.bands) * a.tho;
        float* sg = st + s * stage;
        load_window(sg, a.g_rows, a.gp, a.cs, 2 * a.cs, a.g, b, oy0 - 2, a.oh, a.ow, a.c, c0, nc,
                    a.vec_g);
        if (masked)
            load_window(sg + g_f, a.g_rows, a.gp, a.cs, 2 * a.cs, a.out, b, oy0 - 2, a.oh, a.ow,
                        a.c, c0, nc, a.vec_o);
        load_window(sg + (1 + masked) * g_f, a.x_rows, a.xp, a.cs, a.pad_left * a.cs, a.x, b,
                    oy0 * S - a.pad_top, a.h, a.w, a.c, c0, nc, a.vec_x);
    };
    // dk: thread = (lane, q), q = (c4, ky) with c4 fastest
    const int qn = 5 * c4n, lane = tid / qn, q = tid - lane * qn;
    const bool dk_on = lane < a.lanes;
    const int kc4 = q % c4n, ky = q / c4n;
    float4 acc[5], accb = zero4();
#pragma unroll
    for (int k = 0; k < 5; ++k) acc[k] = zero4();
    const int runs = (a.ow + kRun - 1) / kRun;

    load(t0, 0);
    cp_async_commit();  // the kernel slice and the first tile
    for (int t = t0, s = 0; t < t1; ++t, s ^= 1) {
        load(t + 1, s ^ 1);
        cp_async_commit();
        cp_async_wait_prior();
        __syncthreads();
        float* sg = st + s * stage;
        const float* sx = sg + (1 + masked) * g_f;
        if (masked) {
            mask_scale(sg, sg + g_f, g_f, nullptr);
            __syncthreads();
        }
        const int b = t / a.bands, oy0 = (t - b * a.bands) * a.tho;
        const int rows = min(a.tho, a.oh - oy0);
        if (a.dx != nullptr) {
            if (S == 1) {
                // items (c4, ty, run), c4 fastest, then rows
                const int items = c4n * a.tho * runs;
                for (int it = tid; it < items; it += kThreads) {
                    const int c4 = it % c4n, rest = it / c4n;
                    const int ty = rest % a.tho, k = rest / a.tho;
                    if (ty >= rows || 4 * c4 >= nc) continue;
                    float4 v[kRun];
                    // output ix = k kRun + r reads g column ix + 2 - t: window column ix + 4 - t
                    dx_run<5, 5>(v, sg, sk, a.gp, a.cs, c4, ty + 4, k * kRun + 4, 0, 0);
                    store_dx_run(a, v, b, oy0 + ty, k * kRun, 1, a.w - k * kRun, c0, c4, nc);
                }
            } else {
                // parity classes (py, px): dx row iy = 2 m + py - pad_top takes
                // g rows m - s, column ix = 2 n + px - pad_left g columns n - t
                const int iy_lo = 2 * oy0, iy_hi = min(a.h, iy_lo + 2 * a.tho);
                int m_lo[2], m_n[2], n_lo[2], n_runs[2], start[5];
                for (int p = 0; p < 2; ++p) {
                    m_lo[p] = half_floor(iy_lo + a.pad_top - p + 1);
                    m_n[p] = max(0, half_floor(iy_hi - 1 + a.pad_top - p) - m_lo[p] + 1);
                    n_lo[p] = half_floor(a.pad_left - p + 1);
                    const int n_hi = half_floor(a.w - 1 + a.pad_left - p);
                    n_runs[p] = (max(0, n_hi - n_lo[p] + 1) + kRun - 1) / kRun;
                }
                start[0] = 0;
                for (int cls = 0; cls < 4; ++cls)
                    start[cls + 1] = start[cls] + c4n * m_n[cls >> 1] * n_runs[cls & 1];
                for (int it = tid; it < start[4]; it += kThreads) {
                    int cls = 0;
                    while (it >= start[cls + 1]) ++cls;
                    const int py = cls >> 1, px = cls & 1;
                    const int i = it - start[cls];
                    const int c4 = i % c4n, rest = i / c4n;
                    const int mj = rest % m_n[py], k = rest / m_n[py];
                    if (4 * c4 >= nc) continue;
                    const int m = m_lo[py] + mj, n0 = n_lo[px] + k * kRun;
                    // g row m - s is window row m - s - oy0 + 2; g column n - t
                    // window column n - t + 2
                    const int row0 = m - oy0 + 2, col = n0 + 2;
                    float4 v[kRun];
                    if (py == 0 && px == 0)
                        dx_run<3, 3>(v, sg, sk, a.gp, a.cs, c4, row0, col, 0, 0);
                    else if (py == 0)
                        dx_run<3, 2>(v, sg, sk, a.gp, a.cs, c4, row0, col, 0, 1);
                    else if (px == 0)
                        dx_run<2, 3>(v, sg, sk, a.gp, a.cs, c4, row0, col, 1, 0);
                    else
                        dx_run<2, 2>(v, sg, sk, a.gp, a.cs, c4, row0, col, 1, 1);
                    const int ix0 = 2 * n0 + px - a.pad_left;
                    store_dx_run(a, v, b, 2 * m + py - a.pad_top, ix0, 2,
                                 (a.w - ix0 + 1) >> 1, c0, c4, nc);
                }
            }
        }
        if (dk_on) {
            // dk[ky][kx] += g[oy][ox] x[S oy - pt + ky][S ox - pl + kx]: g row
            // oy0 + ty is window row ty + 2, x row S ty + ky of the x window
            const int segs = rows * runs;
            for (int sgi = lane; sgi < segs; sgi += a.lanes) {
                const int ty = sgi / runs, k = sgi - ty * runs;
                const float* gr = sg + (ty + 2) * a.gp + (k * kRun + 2) * a.cs + 4 * kc4;
                float4 gv[kRun];
#pragma unroll
                for (int r = 0; r < kRun; ++r) gv[r] = ld4(gr + r * a.cs);
                const float* xr = sx + (ty * S + ky) * a.xp + k * kRun * S * a.cs + 4 * kc4;
#pragma unroll
                for (int j = 0; j < (kRun - 1) * S + 5; ++j) {
                    const float4 v = ld4(xr + j * a.cs);
#pragma unroll
                    for (int r = 0; r < kRun; ++r) {
                        const int kx = j - r * S;
                        if (kx >= 0 && kx < 5) fma4(acc[kx], gv[r], v);
                    }
                }
                if (ky == 0)
#pragma unroll
                    for (int r = 0; r < kRun; ++r) add4(accb, gv[r]);
            }
        }
        __syncthreads();  // the stage is free for the next load into it
    }

    // the lanes' sums, in lane order, as this block's partial [26, cs]:
    // dk tap-major, then db
    float* red = sm;  // [lanes][qn][kConvRed]
    if (dk_on) {
        float* r = red + (lane * qn + q) * kConvRed;
#pragma unroll
        for (int k = 0; k < 5; ++k) {
            r[4 * k] = acc[k].x, r[4 * k + 1] = acc[k].y;
            r[4 * k + 2] = acc[k].z, r[4 * k + 3] = acc[k].w;
        }
        r[20] = accb.x, r[21] = accb.y, r[22] = accb.z, r[23] = accb.w;
    }
    __syncthreads();
    const int m = (kTaps + 1) * a.cs;
    float* part = a.partial + ((size_t)slice * a.chunks + chunk) * m;
    for (int idx = tid; idx < qn * kConvRed; idx += kThreads) {
        const int qq = idx / kConvRed, e = idx - qq * kConvRed;
        float s = 0.0f;
        for (int l = 0; l < a.lanes; ++l) s = __fadd_rn(s, red[(l * qn + qq) * kConvRed + e]);
        const int c4 = qq % c4n, kyy = qq / c4n;
        if (e < 20)
            part[(kyy * 5 + (e >> 2)) * a.cs + 4 * c4 + (e & 3)] = s;
        else if (kyy == 0)
            part[kTaps * a.cs + 4 * c4 + e - 20] = s;
    }
    if (last_block(a.counters + slice, a.chunks)) {
        const float* base = a.partial + (size_t)slice * a.chunks * m;
        for (int q4 = tid; q4 < (m >> 2); q4 += kThreads) {
            const int tap = 4 * q4 / a.cs, cc = 4 * q4 - tap * a.cs;  // 4 | cs: one tap
            if (cc >= nc || (tap == kTaps && a.db == nullptr)) continue;
            const float4 v4 = sum_parts4(base + 4 * q4, a.chunks, m);
            const float v[4] = {v4.x, v4.y, v4.z, v4.w};
            float* o = tap < kTaps ? a.dk + tap * a.c + c0 + cc : a.db + c0 + cc;
            for (int e = 0; e < 4 && cc + e < nc; ++e) o[e] = v[e];
        }
        if (tid == 0) a.counters[slice] = 0;
    }
}

// K11, full form (the stem) at stride S: the weight and bias gradients, a
// block a (slice of output channels, chunk). The g window is the band's
// rows (no halo), column u = ox; the x window whole rows of cin floats a
// pixel, image column 0 at lead + pad_left cin floats (lead aligns the
// copy).
template <int S>
__global__ void __launch_bounds__(kThreads) full_backward_kernel(const ConvArgs a) {
    extern __shared__ __align__(16) float sm[];
    const int tid = threadIdx.x;
    const int slice = blockIdx.x % a.slices, chunk = blockIdx.x / a.slices;
    const int c0 = slice * a.cs, nc = min(a.cs, a.c - c0), c4n = a.cs >> 2, cin = a.cin;
    const int masked = a.out != nullptr;
    const int g_f = a.g_rows * a.gp, stage = (1 + masked) * g_f + a.x_rows * a.xp;
    const int t0 = chunk * a.tpc, t1 = min(a.tiles, t0 + a.tpc);
    float* st = sm;
    zero_shared(sm, (t1 - t0 > 1 ? 2 : 1) * stage);
    auto load = [&](int t, int s) {
        if (t >= t1) return;
        const int b = t / a.bands, oy0 = (t - b * a.bands) * a.tho;
        float* sg = st + s * stage;
        load_window(sg, a.g_rows, a.gp, a.cs, 0, a.g, b, oy0, a.oh, a.ow, a.c, c0, nc, a.vec_g);
        if (masked)
            load_window(sg + g_f, a.g_rows, a.gp, a.cs, 0, a.out, b, oy0, a.oh, a.ow, a.c, c0, nc,
                        a.vec_o);
        load_window(sg + (1 + masked) * g_f, a.x_rows, a.xp, 0, a.lead + a.pad_left * cin, a.x, b,
                    oy0 * S - a.pad_top, a.h, 1, a.w * cin, 0, a.w * cin, a.vec_x);
    };
    // thread = (lane, q), q = (c4, ky, ci) with c4 fastest
    const int qn = 5 * c4n * cin, lane = tid / qn, q = tid - lane * qn;
    const bool on = lane < a.lanes;
    const int kc4 = q % c4n, ky = (q / c4n) % 5, ci = q / (5 * c4n);
    float4 acc[5], accb = zero4();
#pragma unroll
    for (int k = 0; k < 5; ++k) acc[k] = zero4();
    const int runs = (a.ow + kRun - 1) / kRun;

    load(t0, 0);
    cp_async_commit();
    for (int t = t0, s = 0; t < t1; ++t, s ^= 1) {
        load(t + 1, s ^ 1);
        cp_async_commit();
        cp_async_wait_prior();
        __syncthreads();
        float* sg = st + s * stage;
        const float* sx = sg + (1 + masked) * g_f;
        if (masked) {
            mask_scale(sg, sg + g_f, g_f, nullptr);
            __syncthreads();
        }
        const int b = t / a.bands, oy0 = (t - b * a.bands) * a.tho;
        const int rows = min(a.tho, a.oh - oy0);
        if (on) {
            const int segs = rows * runs;
            for (int sgi = lane; sgi < segs; sgi += a.lanes) {
                const int ty = sgi / runs, k = sgi - ty * runs;
                const float* gr = sg + ty * a.gp + k * kRun * a.cs + 4 * kc4;
                float4 gv[kRun];
#pragma unroll
                for (int r = 0; r < kRun; ++r) gv[r] = ld4(gr + r * a.cs);
                const float* xr = sx + (ty * S + ky) * a.xp + a.lead + k * kRun * S * cin + ci;
#pragma unroll
                for (int j = 0; j < (kRun - 1) * S + 5; ++j) {
                    const float v = xr[j * cin];
#pragma unroll
                    for (int r = 0; r < kRun; ++r) {
                        const int kx = j - r * S;
                        if (kx >= 0 && kx < 5) fma4s(acc[kx], gv[r], v);
                    }
                }
                if (ky == 0 && ci == 0)
#pragma unroll
                    for (int r = 0; r < kRun; ++r) add4(accb, gv[r]);
            }
        }
        __syncthreads();
    }

    // partial [25 cin + 1, cs]: dk as HWIO stores it ((ky, kx, ci) rows), then db
    float* red = sm;
    if (on) {
        float* r = red + (lane * qn + q) * kConvRed;
#pragma unroll
        for (int k = 0; k < 5; ++k) {
            r[4 * k] = acc[k].x, r[4 * k + 1] = acc[k].y;
            r[4 * k + 2] = acc[k].z, r[4 * k + 3] = acc[k].w;
        }
        r[20] = accb.x, r[21] = accb.y, r[22] = accb.z, r[23] = accb.w;
    }
    __syncthreads();
    const int m = (kTaps * cin + 1) * a.cs;
    float* part = a.partial + ((size_t)slice * a.chunks + chunk) * m;
    for (int idx = tid; idx < qn * kConvRed; idx += kThreads) {
        const int qq = idx / kConvRed, e = idx - qq * kConvRed;
        float s = 0.0f;
        for (int l = 0; l < a.lanes; ++l) s = __fadd_rn(s, red[(l * qn + qq) * kConvRed + e]);
        const int c4 = qq % c4n, kyy = (qq / c4n) % 5, cii = qq / (5 * c4n);
        if (e < 20)
            part[((kyy * 5 + (e >> 2)) * cin + cii) * a.cs + 4 * c4 + (e & 3)] = s;
        else if (kyy == 0 && cii == 0)
            part[kTaps * cin * a.cs + 4 * c4 + e - 20] = s;
    }
    if (last_block(a.counters + slice, a.chunks)) {
        const float* base = a.partial + (size_t)slice * a.chunks * m;
        for (int q4 = tid; q4 < (m >> 2); q4 += kThreads) {
            const int row = 4 * q4 / a.cs, cc = 4 * q4 - row * a.cs;  // 4 | cs: one row
            if (cc >= nc || (row == kTaps * cin && a.db == nullptr)) continue;
            const float4 v4 = sum_parts4(base + 4 * q4, a.chunks, m);
            const float v[4] = {v4.x, v4.y, v4.z, v4.w};
            float* o = row < kTaps * cin ? a.dk + row * a.c + c0 + cc : a.db + c0 + cc;
            for (int e = 0; e < 4 && cc + e < nc; ++e) o[e] = v[e];
        }
        if (tid == 0) a.counters[slice] = 0;
    }
}

// ---------------------------------------------------------------- K12

struct PwArgs {
    const float* g;       // [n, h, w, cout], member stride g_bstride
    const float* gscale;  // scales g, or null
    const float* out;     // the saved output (ReLU mask) or null
    const float* y;       // [n, h, w, cin]
    const float* wt;      // [cin, cout]
    const float* res;     // the residual (the block input) or null
    float* dy;
    float* dres;
    float* dw;
    float* db;
    float* partial;
    unsigned* counters;
    long long g_bstride;
    int pixels, hw, h, w, cin, cout, res_c, res_pool, accumulate;
    int dy_tile, tci, tco, ci_tiles, co_tiles, chunk_px, chunks, group;
    int vec_g, vec_o, vec_y, vec_w, vec_dy, g_dense;
};

// K12, dW role: tile (cit, cot) of dW [cin, cout] over one chunk of pixels;
// partial [tci tco + tco]: dW (ci-major), then db (from tiles of cit = 0).
__device__ void pw_dw_block(const PwArgs& a, float* sm, int d) {
    const int tid = threadIdx.x;
    const int tiles = a.ci_tiles * a.co_tiles, tile = d % tiles, chunk = d / tiles;
    const int cit = tile / a.co_tiles, cot = tile - cit * a.co_tiles;
    const int ci0 = cit * a.tci, co0 = cot * a.tco;
    const int nci = min(a.tci, a.cin - ci0), nco = min(a.tco, a.cout - co0);
    const int yp = row_pitch(a.tci), gp = row_pitch(a.tco);
    const int masked = a.out != nullptr;
    const int y_f = kDwSubPx * yp, g_f = kDwSubPx * gp;
    const int stage = y_f + (1 + masked) * g_f;
    const int pc0 = chunk * a.chunk_px, pc1 = min(a.pixels, pc0 + a.chunk_px);
    const int nsub = (pc1 - pc0 + kDwSubPx - 1) / kDwSubPx;
    // nothing is zeroed: a channel past nci or nco, or a row past np, only
    // ever meets sums that are not stored
    const Rows ys{a.y, 0, 1, a.cin, 1}, gs{a.g, a.g_bstride, a.hw, a.cout, a.g_dense};
    const Rows os{a.out, 0, 1, a.cout, 1};
    auto load = [&](int t, int s) {
        if (t >= nsub) return;
        const int p0 = pc0 + t * kDwSubPx, np = min(kDwSubPx, pc1 - p0);
        float* st = sm + s * stage;
        stage_slice(st, yp, ys, p0, np, ci0, nci, a.vec_y);
        stage_slice(st + y_f, gp, gs, p0, np, co0, nco, a.vec_g);
        if (masked) stage_slice(st + y_f + g_f, gp, os, p0, np, co0, nco, a.vec_o);
    };
    // thread = (ks, pair), pair = (cig, cog) with cog fastest
    const int cog_n = a.tco >> 2, pairs = (a.tci >> 2) * cog_n, ks_n = kThreads / pairs;
    const int pair = tid % pairs, ks = tid / pairs;
    const bool on = ks < ks_n;
    const int cig = pair / cog_n, cog = pair - cig * cog_n;
    float4 acc[4], accb = zero4();
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = zero4();

    for (int i = 0; i < kDwStages - 1; ++i) {
        load(i, i);
        cp_async_commit();
    }
    for (int t = 0; t < nsub; ++t) {
        cp_async_wait_group<kDwStages - 2>();  // sub-tile t has landed
        __syncthreads();  // ... for every thread, and sub-tile t - 1's readers are done
        load(t + kDwStages - 1, (t + kDwStages - 1) % kDwStages);
        cp_async_commit();
        float* st = sm + (t % kDwStages) * stage;
        const int np = min(kDwSubPx, pc1 - (pc0 + t * kDwSubPx));
        if (masked || a.gscale != nullptr) {
            mask_scale(st + y_f, masked ? st + y_f + g_f : nullptr, np * gp, a.gscale);
            __syncthreads();
        }
        if (on) {
            const float* yr = st + 4 * cig;
            const float* gr = st + y_f + 4 * cog;
            for (int pl = ks; pl < np; pl += ks_n) {
                const float4 yv = ld4(yr + pl * yp), gv = ld4(gr + pl * gp);
                fma4s(acc[0], gv, yv.x);
                fma4s(acc[1], gv, yv.y);
                fma4s(acc[2], gv, yv.z);
                fma4s(acc[3], gv, yv.w);
                add4(accb, gv);
            }
        }
    }
    __syncthreads();

    float* red = sm;  // [ks_n][pairs][kDwRed]
    if (on) {
        float* r = red + (ks * pairs + pair) * kDwRed;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            r[4 * i] = acc[i].x, r[4 * i + 1] = acc[i].y;
            r[4 * i + 2] = acc[i].z, r[4 * i + 3] = acc[i].w;
        }
        r[16] = accb.x, r[17] = accb.y, r[18] = accb.z, r[19] = accb.w;
    }
    __syncthreads();
    const int tsz = a.tci * a.tco + a.tco;
    float* part = a.partial + ((size_t)tile * a.chunks + chunk) * tsz;
    for (int idx = tid; idx < pairs * kDwRed; idx += kThreads) {
        const int pr = idx / kDwRed, e = idx - pr * kDwRed;
        float s = 0.0f;
        for (int k = 0; k < ks_n; ++k) s = __fadd_rn(s, red[(k * pairs + pr) * kDwRed + e]);
        const int ci_ = pr / cog_n, co_ = pr - ci_ * cog_n;
        if (e < 16)
            part[(4 * ci_ + (e >> 2)) * a.tco + 4 * co_ + (e & 3)] = s;
        else if (ci_ == 0)
            part[a.tci * a.tco + 4 * co_ + e - 16] = s;
    }
    // the sums of `parts` partials at src (in order) into dW and db
    auto finish = [&](const float* src, int parts) {
        for (int q = tid; q < (tsz >> 2); q += kThreads) {
            const int idx = 4 * q;
            if (idx >= a.tci * a.tco && cit != 0) continue;
            const float4 v4 = sum_parts4(src + idx, parts, tsz);
            const float v[4] = {v4.x, v4.y, v4.z, v4.w};
            if (idx < a.tci * a.tco) {
                const int i = idx / a.tco, j = idx - i * a.tco;  // 4 | tco: one row
                for (int e = 0; e < 4; ++e)
                    if (i < nci && j + e < nco) a.dw[(size_t)(ci0 + i) * a.cout + co0 + j + e] = v[e];
            } else {
                const int j = idx - a.tci * a.tco;
                for (int e = 0; e < 4; ++e)
                    if (j + e < nco) a.db[co0 + j + e] = v[e];
            }
        }
    };
    // tickets: the last block of each group of `group` chunks sums the
    // group's partials in chunk order; with more than one group, into a
    // group sum, and the last of those sums the groups in order
    const int groups = (a.chunks + a.group - 1) / a.group, grp = chunk / a.group;
    const int parts = min(a.group, a.chunks - grp * a.group);
    unsigned* counters = a.counters + tile * (groups + 1);  // groups, then the tile's
    if (last_block(counters + grp, parts)) {
        const float* base = a.partial + ((size_t)tile * a.chunks + grp * a.group) * tsz;
        if (tid == 0) counters[grp] = 0;
        if (groups == 1) {
            finish(base, parts);
        } else {
            float* gsums = a.partial + (size_t)a.ci_tiles * a.co_tiles * a.chunks * tsz +
                           (size_t)tile * groups * tsz;
            for (int q = tid; q < (tsz >> 2); q += kThreads)
                reinterpret_cast<float4*>(gsums + (size_t)grp * tsz)[q] =
                    sum_parts4(base + 4 * q, parts, tsz);
            if (last_block(counters + groups, groups)) {
                finish(gsums, groups);
                if (tid == 0) counters[groups] = 0;
            }
        }
    }
}

// K12, dy role: pixels blk dy_tile .. of dy = g . W^T and the residual's
// gradient.
__device__ void pw_dy_block(const PwArgs& a, float* sm, int blk) {
    const int tid = threadIdx.x;
    const int cg_n = (a.cin + 3) >> 2, co4 = (a.cout + 3) >> 2, wp = row_pitch(a.cout);
    const int tp = a.dy_tile, masked = a.out != nullptr;
    float* sw = sm;                  // [4 cg_n, wp]: W, zero past cin and cout
    float* sg = sw + 4 * cg_n * wp;  // [tp, wp]: the masked, scaled g
    float* so = sg + tp * wp;        // [tp, wp]: the saved output
    const int p0 = blk * tp, np = min(tp, a.pixels - p0);
    // the sums run over whole float4s of co: the channels past cout must be
    // zeros in W and g (a ci past cin or a row past np only meets sums that
    // are not stored)
    if (a.cout & 3) zero_shared(sm, (4 * cg_n + (1 + masked) * tp) * wp);
    stage_slice(sw, wp, Rows{a.wt, 0, 1, a.cout, 1}, 0, a.cin, 0, a.cout, a.vec_w);
    stage_slice(sg, wp, Rows{a.g, a.g_bstride, a.hw, a.cout, a.g_dense}, p0, np, 0, a.cout,
                a.vec_g);
    if (masked) stage_slice(so, wp, Rows{a.out, 0, 1, a.cout, 1}, p0, np, 0, a.cout, a.vec_o);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if (masked || a.gscale != nullptr) {
        mask_scale(sg, masked ? so : nullptr, np * wp, a.gscale);
        __syncthreads();
    }
    // a thread: pixels pg + k tp / 4 (k < 4) x channels 4 cg .. 4 cg + 3
    const int pg_n = tp >> 2;
    for (int it = tid; it < cg_n * pg_n; it += kThreads) {
        const int cg = it / pg_n, pg = it - cg * pg_n;
        float4 acc[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = zero4();
        const float* gr = sg + pg * wp;
        const float* wr = sw + 4 * cg * wp;
        for (int q = 0; q < co4; ++q) {
            float4 gv[4], wv[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) gv[k] = ld4(gr + k * pg_n * wp + 4 * q);
#pragma unroll
            for (int j = 0; j < 4; ++j) wv[j] = ld4(wr + j * wp + 4 * q);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                float r[4] = {acc[k].x, acc[k].y, acc[k].z, acc[k].w};
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    r[j] = __fmaf_rn(gv[k].x, wv[j].x, r[j]);
                    r[j] = __fmaf_rn(gv[k].y, wv[j].y, r[j]);
                    r[j] = __fmaf_rn(gv[k].z, wv[j].z, r[j]);
                    r[j] = __fmaf_rn(gv[k].w, wv[j].w, r[j]);
                }
                acc[k] = make_float4(r[0], r[1], r[2], r[3]);
            }
        }
        const int kc = min(4, a.cin - 4 * cg);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int pl = pg + k * pg_n;
            if (pl >= np) continue;
            float* o = a.dy + (size_t)(p0 + pl) * a.cin + 4 * cg;
            store4(o, acc[k], kc, a.accumulate ? o : nullptr, a.vec_dy);
        }
    }
    if (a.res == nullptr) return;
    for (int e = tid; e < np * a.res_c; e += kThreads) {
        const int pl = e / a.res_c, c = e - pl * a.res_c;
        const int p = p0 + pl;
        const float gv = sg[pl * wp + c];
        if (!a.res_pool) {
            a.dres[(size_t)p * a.res_c + c] = gv;
            continue;
        }
        const int b = p / a.hw, rem = p - b * a.hw, yy = rem / a.w, x = rem - yy * a.w;
        const size_t rw = (size_t)2 * a.w * a.res_c;
        const size_t i00 = (((size_t)b * 2 * a.h + 2 * yy) * 2 * a.w + 2 * x) * a.res_c + c;
        const size_t idx[4] = {i00, i00 + a.res_c, i00 + rw, i00 + rw + a.res_c};
        int first = 0;
        float best = a.res[idx[0]];
        for (int k = 1; k < 4; ++k) {
            const float v = a.res[idx[k]];
            if (v > best) {
                best = v;
                first = k;
            }
        }
        for (int k = 0; k < 4; ++k) a.dres[idx[k]] = k == first ? gv : 0.0f;
    }
}

// K12: the dW blocks first (they run longest), then the dy blocks.
__global__ void __launch_bounds__(kThreads) pw_backward_kernel(const PwArgs a) {
    extern __shared__ __align__(16) float sm[];
    const int dw_blocks = a.ci_tiles * a.co_tiles * a.chunks;
    if ((int)blockIdx.x < dw_blocks)
        pw_dw_block(a, sm, blockIdx.x);
    else
        pw_dy_block(a, sm, blockIdx.x - dw_blocks);
}

// ---------------------------------------------------------------- K13

// One anchor map and its heads; a tile is `tile_px` pixels of one member,
// `per` tiles a member; `vec` 4 where x's rows copy in 16-byte words.
struct HeadMap {
    const float* x;
    const float* wc;
    const float* bc;
    const float* wr;
    const float* br;
    int hw, cin, na, tile_px, per, vec;
};

// a K13 tile's staged x row pitch: 16-byte rows, 4 floats of padding
// (a warp's 8 pixels a bank phase read distinct banks)
__host__ __device__ __forceinline__ int head_pitch(int cin) { return (cin + 3) / 4 * 4 + 4; }

// a K13 tile's shared floats: its x rows, then the class weights [cin, na]
// (to a 16-byte end), then the offset weights [cin, 4 na]
__host__ __device__ __forceinline__ long long head_smem_floats(const HeadMap& m) {
    return (long long)m.tile_px * head_pitch(m.cin) + ((long long)m.cin * m.na + 3) / 4 * 4 +
           4LL * m.cin * m.na;
}

struct HeadArgs {
    HeadMap m16, m8;
    const float* tp;
    const float* tb;
    const float* mask;
    float* dlogits;
    float* draw;
    float* loss;
    float* partial;     // 2 a tile: focal, masked smooth-L1
    unsigned* counters; // 1, zero before and after a call
    const float* norm_mask;  // the reg normaliser's mask, norm_n members
    int n, tiles16, tiles, norm_n;
    float inv_count, count;  // the focal mean's count and its reciprocal
};

// Tile t's map, member, first pixel and pixels.
struct HeadTile {
    HeadMap m;
    int b, p0, px, base;  // base: the map's first anchor of a member
};

__device__ __forceinline__ HeadTile head_tile(const HeadArgs& a, int t) {
    const bool second = t >= a.tiles16;
    HeadTile ht;
    ht.m = second ? a.m8 : a.m16;
    const int tt = second ? t - a.tiles16 : t;
    ht.b = tt / ht.m.per;
    ht.p0 = (tt - ht.b * ht.m.per) * ht.m.tile_px;
    ht.px = min(ht.m.tile_px, ht.m.hw - ht.p0);
    ht.base = second ? a.m16.hw * a.m16.na : 0;
    return ht;
}

// Fixed-order sums over a K13 block of K values a thread: a shuffle tree
// within each warp, then the warps' sums in warp order. `red` holds
// K (kHeadWarps + 1) floats.
template <int K>
__device__ void block_sum(float v[K], float* red) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int j = 0; j < K; ++j)
        for (int o = 16; o > 0; o >>= 1) v[j] = __fadd_rn(v[j], __shfl_down_sync(~0u, v[j], o));
    if (lane == 0)
        for (int j = 0; j < K; ++j) red[K * warp + j] = v[j];
    __syncthreads();
    if (warp == 0) {
#pragma unroll
        for (int j = 0; j < K; ++j) {
            float w = lane < kHeadWarps ? red[K * lane + j] : 0.0f;
            for (int o = 16; o > 0; o >>= 1) w = __fadd_rn(w, __shfl_down_sync(~0u, w, o));
            if (lane == 0) red[K * kHeadWarps + j] = w;
        }
    }
    __syncthreads();
    for (int j = 0; j < K; ++j) v[j] = red[K * kHeadWarps + j];
    __syncthreads();
}

// A block a tile of pixels of one map, a thread an anchor of the tile.
// The anchor's targets, mask and biases are loaded first; the tile's x rows
// (16-byte cp.async words where the rows allow) and the map's head weights
// as they lie in memory are copied to shared memory asynchronously, all in
// flight at once, while the block sums the whole normaliser mask (in the
// order every block takes) for the reg normaliser sum(mask) * 4 + 1e-6; a thread sums its
// anchor's logit and 4 offsets over the channels in channel order (five
// chains in flight; the 4 offset weights one 16-byte read), then forms the
// sigmoid, focal BCE, masked smooth-L1, dlogits and the scaled draw; the
// block's fixed-order sums of focal and masked smooth-L1 go to `partial`,
// and the last block by ticket sums them in tile order and writes the loss.
__global__ void __launch_bounds__(kHeadThreads) head_loss_kernel(const HeadArgs a) {
    extern __shared__ __align__(16) float hsm[];
    __shared__ float red[2 * (kHeadWarps + 1)];
    const int tid = threadIdx.x, t = blockIdx.x;
    const HeadTile ht = head_tile(a, t);
    const HeadMap& m = ht.m;
    const int cin = m.cin, na = m.na, pitch = head_pitch(cin), px = ht.px;
    const long long i =
        tid < px * na ? (long long)ht.b * kAnchors + ht.base + (long long)ht.p0 * na + tid : -1;
    const int p = tid / na, an = tid - p * na;
    float* xs = hsm;
    float* wcs = xs + m.tile_px * pitch;
    float* wrs = wcs + (cin * na + 3) / 4 * 4;
    const float* xg = m.x + ((long long)ht.b * m.hw + ht.p0) * cin;
    if (m.vec == 4) {
        const int c4 = cin / 4;
        for (int e = tid; e < px * c4; e += kHeadThreads) {
            const int q = e / c4, c = e - q * c4;
            cp_async<16>(xs + q * pitch + 4 * c, xg + 4LL * e);
        }
    } else {
        for (int e = tid; e < px * cin; e += kHeadThreads) {
            const int q = e / cin, c = e - q * cin;
            cp_async<4>(xs + q * pitch + c, xg + e);
        }
    }
    for (int e = tid; e < cin * na; e += kHeadThreads) cp_async<4>(wcs + e, m.wc + e);
    for (int e = tid; e < 4 * cin * na; e += kHeadThreads) cp_async<4>(wrs + e, m.wr + e);
    cp_async_commit();
    float tgt = 0.0f, mv = 0.0f, bc = 0.0f, tb[4] = {}, br[4] = {};
    if (i >= 0) {
        tgt = a.tp[i];
        mv = a.mask[i];
        bc = m.bc[an];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            tb[j] = a.tb[4 * i + j];
            br[j] = m.br[4 * an + j];
        }
    }
    float ms[1] = {0.0f};
    const long long anchors = (long long)a.norm_n * kAnchors;  // a multiple of 4
    if ((uintptr_t)a.norm_mask % 16 == 0) {
        for (long long q = 4 * tid; q < anchors; q += 4 * kHeadThreads) {
            const float4 v = ld4(a.norm_mask + q);
            ms[0] = __fadd_rn(ms[0], __fadd_rn(__fadd_rn(v.x, v.y), __fadd_rn(v.z, v.w)));
        }
    } else {
        for (long long q = tid; q < anchors; q += kHeadThreads)
            ms[0] = __fadd_rn(ms[0], a.norm_mask[q]);
    }
    block_sum<1>(ms, red);
    const float denom = __fadd_rn(__fmul_rn(ms[0], 4.0f), 1e-6f);
    const float inv = __fdiv_rn(1.0f, denom);
    cp_async_wait_all();
    __syncthreads();
    float part[2] = {0.0f, 0.0f};  // focal, masked smooth-L1
    if (i >= 0) {
        const float* xr = xs + p * pitch;
        float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        for (int ci = 0; ci < cin; ++ci) {
            const float v = xr[ci];
            const float4 w4 = ld4(wrs + 4 * (ci * na + an));
            acc[0] = __fmaf_rn(v, wcs[ci * na + an], acc[0]);
            acc[1] = __fmaf_rn(v, w4.x, acc[1]);
            acc[2] = __fmaf_rn(v, w4.y, acc[2]);
            acc[3] = __fmaf_rn(v, w4.z, acc[3]);
            acc[4] = __fmaf_rn(v, w4.w, acc[4]);
        }
        const float logit = __fadd_rn(acc[0], bc);
        const float pr = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-logit)));
        const float lp = logf(__fadd_rn(pr, 1e-7f));
        const float omt = __fsub_rn(1.0f, tgt);
        const float lq = logf(__fadd_rn(__fsub_rn(1.0f, pr), 1e-7f));
        const float bce = -__fadd_rn(__fmul_rn(tgt, lp), __fmul_rn(omt, lq));
        const float wgt = __fadd_rn(0.25f, __fmul_rn(0.75f, tgt));
        part[0] = __fmul_rn(bce, wgt);
        // d focal / d logit, as JAX's reverse pass forms it
        const float ct = -__fmul_rn(a.inv_count, wgt);
        const float dp = __fsub_rn(__fdiv_rn(__fmul_rn(ct, tgt), __fadd_rn(pr, 1e-7f)),
                                   __fdiv_rn(__fmul_rn(ct, omt),
                                             __fadd_rn(__fsub_rn(1.0f, pr), 1e-7f)));
        a.dlogits[i] = __fmul_rn(dp, __fmul_rn(pr, __fsub_rn(1.0f, pr)));
        float dr[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float d = __fsub_rn(__fadd_rn(acc[1 + j], br[j]), tb[j]);
            const float ad = fabsf(d);
            const bool quad = ad < 1.0f;
            const float l1 = quad ? __fmul_rn(__fmul_rn(0.5f, d), d) : __fsub_rn(ad, 0.5f);
            part[1] = __fadd_rn(part[1], __fmul_rn(l1, mv));
            const float slope = quad ? d : (d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f));
            dr[j] = __fmul_rn(__fmul_rn(mv, slope), inv);
        }
        *reinterpret_cast<float4*>(a.draw + 4 * i) = make_float4(dr[0], dr[1], dr[2], dr[3]);
    }
    block_sum<2>(part, red);
    if (tid == 0) {
        a.partial[2 * t] = part[0];
        a.partial[2 * t + 1] = part[1];
    }
    if (last_block(a.counters, a.tiles)) {
        float s[2] = {0.0f, 0.0f};
        for (int q = tid; q < a.tiles; q += kHeadThreads)
            for (int j = 0; j < 2; ++j) s[j] = __fadd_rn(s[j], __ldcg(&a.partial[2 * q + j]));
        block_sum<2>(s, red);
        if (tid == 0) {
            *a.loss = __fadd_rn(__fdiv_rn(s[0], a.count), __fdiv_rn(s[1], denom));
            a.counters[0] = 0;
        }
    }
}

// ---------------------------------------------------------------- K14

__global__ void adam_kernel(float* __restrict__ params, const float* __restrict__ grads,
                            float* __restrict__ mu, float* __restrict__ nu, long long count,
                            float one_minus_b1, float b1, float one_minus_b2, float b2, float bc1,
                            float bc2, float eps, float neg_lr) {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < count;
         i += (long long)gridDim.x * blockDim.x) {
        const float gv = grads[i];
        const float m = __fadd_rn(__fmul_rn(one_minus_b1, gv), __fmul_rn(b1, mu[i]));
        const float v = __fadd_rn(__fmul_rn(one_minus_b2, __fmul_rn(gv, gv)), __fmul_rn(b2, nu[i]));
        mu[i] = m;
        nu[i] = v;
        const float u = __fdiv_rn(__fdiv_rn(m, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), eps));
        params[i] = __fadd_rn(params[i], __fmul_rn(neg_lr, u));
    }
}

// raise `fn`'s dynamic shared-memory ceiling to `smem`, once a device and
// size (a benign race: two threads may both set it)
template <typename F>
cudaError_t ensure_smem(F fn, int id, long long smem) {
    static int seen[8][64] = {};
    if (smem <= 48 * 1024) return cudaSuccess;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 0 && dev < 64 && smem <= seen[id][dev]) return cudaSuccess;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess && dev >= 0 && dev < 64) seen[id][dev] = (int)smem;
    return err;
}

// g window columns K11 reads (blazeface_train.py _k11_gw_cols)
int k11_gw_cols(int w, int ow, int stride, int pad_left, int depthwise) {
    const int runs = (ow + kRun - 1) / kRun;
    if (!depthwise) return runs * kRun;
    if (stride == 1) return runs * kRun + 4;
    int need = runs * kRun + 2;
    for (int px = 0; px < 2; ++px) {
        const int n_lo = (pad_left - px + 1) / 2, n_hi = (w - 1 + pad_left - px) / 2;
        const int count = n_hi - n_lo + 1 > 0 ? n_hi - n_lo + 1 : 0;
        const int v = n_lo + (count + kRun - 1) / kRun * kRun + 2;
        need = v > need ? v : need;
    }
    return need;
}

}  // namespace

// K11 on `stream`. `x` f32 [n, h, w, cin], `g` the output gradient f32
// [n, oh, ow, cout], `out` the saved output (ReLU mask) or null, `kernel`
// HWIO f32. Writes `dx` (depthwise only; null skips it; with `dx_add`, which
// may be dx itself, dx = dx_add + the input gradient), `dk` (HWIO, the
// kernel's shape) and `db` [cout] (null: no bias). The plan
// (blazeface_train.py k11_plan): slices of `cs` channels (depthwise C, else
// C_out), tiles of `tho` output rows of one image, `tpc` tiles a chunk, a
// block a (slice, chunk); staged g rows of `gp` floats, x rows of `xp`;
// `lanes` threads share each dk sum. `partial` holds slices x chunks x
// (25 C_in' + 1) cs floats (C_in' = 1 depthwise), `counters` slices zeros
// (left zero).
extern "C" int flyimg_bf_conv5x5_backward(const float* x, const float* g, const float* out,
                                          const float* kernel, float* dx, const float* dx_add,
                                          float* dk, float* db, float* partial,
                                          unsigned* counters, int n, int h, int w, int cin, int oh,
                                          int ow, int cout, int stride, int pad_top, int pad_left,
                                          int depthwise, int cs, int tho, int tpc, int gp, int xp,
                                          int lanes, void* stream) {
    if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || oh <= 0 || ow <= 0 || cout <= 0 ||
        (stride != 1 && stride != 2) || (depthwise && cout != cin) ||
        (dx != nullptr && !depthwise) || (dx_add != nullptr && dx == nullptr) || cs <= 0 ||
        cs % 4 != 0 || tho <= 0 || tpc <= 0 || gp % 4 != 0 || xp % 4 != 0 || lanes <= 0 ||
        (long long)n * h * w * (cin > cout ? cin : cout) >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    const int qn = 5 * (cs / 4) * (depthwise ? 1 : cin);
    if (qn * lanes > kThreads) return (int)cudaErrorInvalidValue;
    ConvArgs a{x, g, out, kernel, dx, dx_add, dk, db, partial, counters};
    a.n = n, a.h = h, a.w = w, a.cin = cin, a.oh = oh, a.ow = ow, a.c = cout;
    a.pad_top = pad_top, a.pad_left = pad_left, a.cs = cs, a.tho = tho, a.tpc = tpc;
    a.slices = (cout + cs - 1) / cs;
    a.bands = (oh + tho - 1) / tho;
    a.tiles = n * a.bands;
    a.chunks = (a.tiles + tpc - 1) / tpc;
    a.g_rows = depthwise ? tho + (stride == 1 ? 4 : 3) : tho;
    a.x_rows = (tho - 1) * stride + 5;
    a.gp = gp, a.xp = xp, a.lanes = lanes;
    const int xw = ((ow + kRun - 1) / kRun * kRun - 1) * stride + 5;
    a.vec_g = vec_width(cout, g);
    a.vec_o = out != nullptr ? vec_width(cout, out) : 1;
    a.vec_k = vec_width(cout, kernel);
    a.vec_dx = dx != nullptr ? vec_width(cout, dx) : 1;
    if (dx_add != nullptr && vec_width(cout, dx_add) < a.vec_dx) a.vec_dx = vec_width(cout, dx_add);
    if (depthwise) {
        a.vec_x = vec_width(cin, x);
        a.lead = 0;
        if (xp < xw * cs) return (int)cudaErrorInvalidValue;
    } else {
        a.vec_x = vec_width((long long)w * cin, x);
        a.lead = (a.vec_x - (pad_left * cin) % a.vec_x) % a.vec_x;
        if (xp < a.lead + xw * cin) return (int)cudaErrorInvalidValue;
    }
    if (gp < k11_gw_cols(w, ow, stride, pad_left, depthwise) * cs) return (int)cudaErrorInvalidValue;
    const long long stage = (long long)((out != nullptr ? 2 : 1) * a.g_rows * gp + a.x_rows * xp);
    long long floats = (depthwise ? kTaps * cs : 0) + (tpc > 1 ? 2 : 1) * stage;
    const long long red = (long long)kThreads * kConvRed;
    if (floats < red) floats = red;
    const long long smem = 4 * floats;
    if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int blocks = a.slices * a.chunks;
    cudaError_t err;
#define FLYIMG_K11(KERNEL, ID)                                  \
    err = ensure_smem(KERNEL, ID, smem);                        \
    if (err != cudaSuccess) return (int)err;                    \
    KERNEL<<<blocks, kThreads, smem, s>>>(a);
    if (depthwise) {
        if (stride == 1) {
            FLYIMG_K11(dw_backward_kernel<1>, 0)
        } else {
            FLYIMG_K11(dw_backward_kernel<2>, 1)
        }
    } else if (stride == 1) {
        FLYIMG_K11(full_backward_kernel<1>, 2)
    } else {
        FLYIMG_K11(full_backward_kernel<2>, 3)
    }
#undef FLYIMG_K11
    return (int)cudaGetLastError();
}

// K12 on `stream`. `g` the output gradient [n, h, w, cout] with member
// stride `g_bstride` floats (pixels and channels dense), scaled by
// `*gscale` when not null; `out` the saved output (ReLU mask) or null;
// `y` f32 [n, h, w, cin]; `wt` [cin, cout]; `res` the block input
// [n, h, w, res_c] or, with `res_pool`, [n, 2h, 2w, res_c], or null. Writes
// (or with `accumulate` adds to) `dy`, writes `dres` (the residual's
// shape) and dW [cin, cout] into `dw`, db [cout] into `db`. The plan
// (blazeface_train.py k12_plan): dy blocks of `dy_tile` pixels; dW tiles of
// `tci` x `tco` channels over chunks of `chunk_px` pixels (a multiple of
// kDwSubPx, the rows staged at a time), summed in groups of `group` chunks.
// `partial` holds tiles x (chunks + groups) x (tci tco + tco) floats,
// `counters` tiles x (groups + 1) zeros (left zero).
extern "C" int flyimg_bf_pointwise_backward(const float* g, long long g_bstride,
                                            const float* gscale, const float* out, const float* y,
                                            const float* wt, const float* res, float* dy,
                                            float* dres, float* dw, float* db, float* partial,
                                            unsigned* counters, int n, int h, int w, int cin,
                                            int cout, int res_c, int res_pool, int accumulate,
                                            int dy_tile, int tci, int tco, int chunk_px,
                                            int group, void* stream) {
    if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || dy_tile <= 0 ||
        dy_tile % 4 != 0 || tci <= 0 || tci % 4 != 0 || tci > kMaxTile || tco <= 0 ||
        tco % 4 != 0 || tco > kMaxTile || chunk_px <= 0 || chunk_px % kDwSubPx != 0 ||
        group <= 0 || g_bstride < (long long)h * w * cout ||
        (long long)n * h * w * (cin > cout ? cin : cout) >= (1LL << 31) ||
        (long long)(n - 1) * g_bstride + (long long)h * w * cout >= (1LL << 31) ||
        (res != nullptr && (res_c <= 0 || res_c > cout || dres == nullptr)))
        return (int)cudaErrorInvalidValue;
    PwArgs a{g, gscale, out, y, wt, res, dy, dres, dw, db, partial, counters, g_bstride};
    a.pixels = n * h * w, a.hw = h * w, a.h = h, a.w = w, a.cin = cin, a.cout = cout;
    a.res_c = res_c, a.res_pool = res_pool, a.accumulate = accumulate;
    a.dy_tile = dy_tile, a.tci = tci, a.tco = tco, a.chunk_px = chunk_px, a.group = group;
    a.ci_tiles = (cin + tci - 1) / tci;
    a.co_tiles = (cout + tco - 1) / tco;
    a.chunks = (a.pixels + chunk_px - 1) / chunk_px;
    a.g_dense = g_bstride == (long long)h * w * cout;
    a.vec_g = vec_width(cout, g);
    while (g_bstride % a.vec_g != 0) a.vec_g >>= 1;
    a.vec_o = out != nullptr ? vec_width(cout, out) : 1;
    a.vec_y = vec_width(cin, y);
    a.vec_w = vec_width(cout, wt);
    a.vec_dy = vec_width(cin, dy);
    const int masked = out != nullptr;
    const long long wp = row_pitch(cout);
    const long long dy_floats = (4LL * ((cin + 3) / 4) + (1 + masked) * dy_tile) * wp;
    long long dw_floats =
        (long long)kDwStages * kDwSubPx * (row_pitch(tci) + (1 + masked) * row_pitch(tco));
    if (dw_floats < (long long)kThreads * kDwRed) dw_floats = (long long)kThreads * kDwRed;
    const long long smem = 4 * (dy_floats > dw_floats ? dy_floats : dw_floats);
    if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
    const cudaError_t err = ensure_smem(pw_backward_kernel, 4, smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = a.ci_tiles * a.co_tiles * a.chunks + (a.pixels + dy_tile - 1) / dy_tile;
    pw_backward_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
    return (int)cudaGetLastError();
}

// K13 on `stream`: maps x16 [n, hw16, c16] and x8 [n, hw8, c8] with their
// class (wc [c, na], bc [na]) and offset (wr [c, 4 na], br [4 na]) heads,
// targets tp [n, 896], tb [n, 896, 4], mask [n, 896]. Writes dlogits
// [n, 896], draw [n, 896, 4] and `loss` [1]. The plan
// (blazeface_train.py k13_plan): tiles of `tile16` / `tile8` pixels, a
// block a tile. `partial` holds 2 floats a tile, `counters` 1 zero (left
// zero). The loss is a mean over a batch of N members and its smooth-L1 is
// normalised by the sum of `norm_mask` [norm_n, 896]: inv_count =
// f32(1 / (N 896)), count = N 896; a whole batch passes N = n and its own
// mask, a data-parallel shard the global batch's N and mask. One launch.
extern "C" int flyimg_bf_head_loss(const float* x16, const float* wc16, const float* bc16,
                                   const float* wr16, const float* br16, int hw16, int c16,
                                   int na16, const float* x8, const float* wc8, const float* bc8,
                                   const float* wr8, const float* br8, int hw8, int c8, int na8,
                                   const float* tp, const float* tb, const float* mask,
                                   float* dlogits, float* draw, float* loss, float* partial,
                                   unsigned* counters, int n, int tile16, int tile8,
                                   float inv_count, float count, const float* norm_mask,
                                   int norm_n, void* stream) {
    if (n <= 0 || norm_n <= 0 || norm_mask == nullptr ||
        hw16 * na16 + hw8 * na8 != kAnchors || c16 <= 0 || c8 <= 0 || tile16 <= 0 ||
        tile8 <= 0 || tile16 * na16 > kHeadThreads || tile8 * na8 > kHeadThreads ||
        (uintptr_t)draw % 16 != 0)
        return (int)cudaErrorInvalidValue;
    HeadArgs a;
    a.m16 = HeadMap{x16, wc16, bc16, wr16, br16, hw16, c16, na16, tile16,
                    (hw16 + tile16 - 1) / tile16, vec_width(c16, x16)};
    a.m8 = HeadMap{x8, wc8, bc8, wr8, br8, hw8, c8, na8, tile8, (hw8 + tile8 - 1) / tile8,
                   vec_width(c8, x8)};
    a.tp = tp, a.tb = tb, a.mask = mask, a.dlogits = dlogits, a.draw = draw, a.loss = loss;
    a.partial = partial, a.counters = counters;
    a.norm_mask = norm_mask, a.norm_n = norm_n;
    a.n = n;
    a.tiles16 = n * a.m16.per;
    a.tiles = a.tiles16 + n * a.m8.per;
    a.inv_count = inv_count, a.count = count;
    const long long floats = head_smem_floats(a.m16) > head_smem_floats(a.m8)
                                 ? head_smem_floats(a.m16)
                                 : head_smem_floats(a.m8);
    const long long smem = 4 * floats;
    if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
    const cudaError_t err = ensure_smem(head_loss_kernel, 5, smem);
    if (err != cudaSuccess) return (int)err;
    head_loss_kernel<<<a.tiles, kHeadThreads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
        a);
    return (int)cudaGetLastError();
}

// K14 on `stream`: params, mu, nu updated in place from grads, `count`
// values each; bc1 = 1 - b1^t, bc2 = 1 - b2^t (f32, from the host).
extern "C" int flyimg_bf_adam(float* params, const float* grads, float* mu, float* nu,
                              long long count, float one_minus_b1, float b1, float one_minus_b2,
                              float b2, float bc1, float bc2, float eps, float neg_lr,
                              void* stream) {
    if (count <= 0) return (int)cudaErrorInvalidValue;
    adam_kernel<<<blocks_for(count, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        params, grads, mu, nu, count, one_minus_b1, b1, one_minus_b2, b2, bc1, bc2, eps, neg_lr);
    return (int)cudaGetLastError();
}
