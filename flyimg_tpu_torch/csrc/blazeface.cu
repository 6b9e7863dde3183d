// K9 and K10: the BlazeFace forward's layers, NHWC f32 throughout.
//
// K9 — a direct 5x5 convolution with SAME padding: the stem (full
// convolution, C_in = 3 -> 24, stride 2, + bias + ReLU) and each
// BlazeBlock's depthwise convolution (one 5x5 filter a channel, stride 1
// or 2, no bias). K10 — a 1x1 (pointwise) convolution: the block form adds
// the bias and the block's residual (the block input, 2x2 max-pooled at
// stride 2 and zero-padded in channels) and applies ReLU; the head form
// computes a feature map's class logits and box offsets, and writes
// sigmoid probabilities and anchor-decoded boxes straight into the
// [N, 896] / [N, 896, 4] outputs at the map's anchor offset.
//
// Replaces the JAX package's flyimg_tpu/models/blazeface.py BlazeBlock and
// BlazeFace (flax convolutions that XLA lowers to its convolution
// emitters) plus _forward's sigmoid and decode_boxes.
//
// Layouts are the JAX package's: activations NHWC, kernels HWIO as flax
// stores them — the stem (5, 5, 3, 24), a depthwise kernel (5, 5, 1, C), a
// pointwise kernel (1, 1, C_in, C_out). SAME padding at stride s over an
// input of n puts floor(t / 2) before and the rest after, t = (ceil(n / s)
// - 1) * s + 5 - n: at stride 2 on an even size that is 1 before, 2 after.
// Heads flatten in (y, x, anchor) order, offsets as (y, x, anchor, 4).
//
// What bounds them on an H100, at the serving batch (64 views of 128x128;
// PERF.md): bytes, with launch latency on the small maps. The 17 K9 calls
// move ~286 MB (0.0855 ms at 3.35 TB/s), 175 MB of it in the stem and the
// three depthwise layers on 64x64 maps; the nine 16x16 and 8x8 layers are a
// few microseconds each, set by latency.
//
// K9, depthwise form (dw5x5_kernel): persistent blocks (host side:
// blazeface.py k9_plan) walk tiles of `th` output rows over the whole output
// width of one image. A block stages the tile's input window, s (th - 1) + 5
// rows by s (runs R - 1) + 5 columns by C channels, in shared memory with
// cp.async (16-byte chunks where C % 4 == 0, a row of the image being one
// contiguous span; else a pixel at a time, 8- or 4-byte), two tiles deep, and
// writes the SAME-padding halo as zeros itself (never loaded). A thread owns
// 4 channels (a float4) x a run of R consecutive output pixels of one row
// (R = 8 at stride 1 on rows at least 16 wide, else 4): for each filter row
// ky it reads that row's 5 taps once and slides the 5-tap window along its
// run in registers (R + 4 float4 reads at stride 1,
// 2R + 3 at stride 2), so each staged value is read once a (thread, ky)
// instead of once a tap. Lanes take channel groups fastest, then rows, and
// the row pitch is padded so that s x pitch == G (mod 8) in 16-byte chunks
// (G = ceil(C / 4)): eight consecutive lanes read eight distinct banks.
// Stem form (full5x5_kernel, C_in = 3 -> 24 at stride 2): the same staged
// window (a 4-byte-copied span, shifted so its chunks align where they can),
// the 25 x C_in x 24 filter in shared memory; a thread owns 8 output channels
// x 4 output pixels of a row (columns k, k + cols, ..., so neighbouring lanes
// take neighbouring pixels) and reads each staged input value once for all 8
// channels; lanes take channel groups fastest, so a warp's weight reads are
// a few distinct float4s. Numerics as before: every output is one f32 FMA
// chain in (ky, kx) order (depthwise) or (ky, kx, ci) order (stem), + bias,
// ReLU; a halo tap adds fma(0, w, acc) = acc exactly, so K11 sees the same
// ReLU mask. No tensor cores: TF32 products would miss the 1e-5 relative
// bound, and a depthwise convolution has no reduction to feed an MMA.
//
// K10's head form (head_kernel): one launch for both anchor maps. The first
// blocks take tiles of the 16x16 map's pixels, the rest the 8x8 map's. A
// block stages its tile of `tile_px` contiguous NHWC pixels (16-byte
// cp.async into rows of an odd number of chunks), its map's weight columns
// [C_in, 5 na] (class | offsets) and biases; a thread computes one column's
// logits of 4 pixels (each one FMA chain over ci in order, + bias; the 4
// share each weight read), into shared memory; then a thread a (pixel,
// anchor) applies the sigmoid and the anchor
// decode (the same expf and __f*_rn calls) and stores the probability and
// the box as one 16-byte store. Latency-bound: ~8.5 MB at 64 views.
//
// K10's block form is bound by bytes (its 16 calls move ~366 MB at 64
// views, against ~2.3 GFLOP of f32 FMAs). Design: persistent blocks, as
// many as fit on the card for the layer's plan (host side: blazeface.py
// k10_plan); each stages the weights and bias once, then walks tiles of
// `tile_px` contiguous NHWC pixels, so a tile's input, output and residual
// are contiguous spans (at stride 2 a tile is whole output rows, and its
// residual the 2 x 2W input rows under them). The next tile's input and
// residual are copied with cp.async (16-byte chunks where the channel count
// allows, else 8- or 4-byte) while the current one is computed. Staged rows
// have an odd number of 16-byte chunks, so the lanes of a warp, each on its
// own pixel, read 16-byte chunks from distinct banks. A thread owns 4
// pixels x 4 output channels in registers: each input chunk (4 channels) of
// its 4 pixels, then each of the 4 weight rows as a broadcast float4, 16
// FMAs a row (8 channels a thread was slower at every layer: half the
// threads, twice the serial FMAs). Every output is still one f32 FMA chain
// over ci = 0 .. C_in - 1 in order (padded channels add exact zeros), then
// + bias, + residual, ReLU, so K12 (the backward) sees the same values for
// its ReLU mask. Outputs are stored from registers as 16- (or 8-) byte
// vectors, or, where C_out is no multiple of 8 (a pixel's outputs then do
// not fill whole 32-byte sectors), gathered in shared memory and stored as
// one span. No tensor cores: TF32 products would miss the 1e-5 relative
// bound, and the layer is bound by bytes, not by its FMAs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPwMaxThreads = 512;
constexpr int kK9MaxThreads = 512;
constexpr int kK9FullPx = 4;  // K9's full form: output pixels a thread
constexpr int kHeadMaxThreads = 512;
// ensure_smem's kernel ids: K9's seven instances 0-6, then these
constexpr int kSmemHead = 7;
constexpr int kSmemPointwise = 8;
constexpr int kSmemKernels = 9;
constexpr int kCo = 4;  // K10: output channels a thread (of 4 pixels)
constexpr int kSmemMax = 227 * 1024;

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
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// a staged row's pitch in floats: an odd number of 16-byte chunks
__host__ __device__ __forceinline__ int row_pitch(int c) { return 4 * (((c + 3) >> 2) | 1); }

// K10's shared memory in floats: weights [cin4, cpad], bias [cpad], two
// stages of tile_px input rows and (4 x at stride 2) tile_px residual rows,
// and with stage_out the tile's output [tile_px, cout]
__host__ __device__ __forceinline__ long long pointwise_smem_floats(int cin, int cout, int res_c,
                                                                    int res_pool, int tile_px,
                                                                    int stage_out) {
    const long long cin4 = (cin + 3) & ~3, cpad = (cout + kCo - 1) / kCo * kCo;
    const long long rpx = res_c > 0 ? (long long)(res_pool ? 4 : 1) * tile_px : 0;
    return cin4 * cpad + cpad + 2 * ((long long)tile_px * row_pitch(cin) + rpx * row_pitch(res_c)) +
           (stage_out ? (long long)tile_px * cout : 0);
}

// the widest of 4, 2, 1 floats that divides c and the alignment of p
__host__ __device__ __forceinline__ int vec_width(int c, const void* p) {
    const uintptr_t a = (uintptr_t)p;
    return c % 4 == 0 && a % 16 == 0 ? 4 : c % 2 == 0 && a % 8 == 0 ? 2 : 1;
}

// rows [0, nrows) of c floats, contiguous at src, into shared rows of
// `pitch` floats, `vec` floats (vec_width of c and src) a copy
template <int VEC>
__device__ __forceinline__ void stage_rows_by(float* dst, const float* src, int nrows, int c,
                                              int pitch, int tid, int nthreads) {
    const int per = c / VEC;
    for (int e = tid; e < nrows * per; e += nthreads) {
        const int r = e / per;
        cp_async<4 * VEC>(dst + r * pitch + VEC * (e - r * per), src + VEC * e);
    }
}
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int nrows, int c,
                                           int pitch, int vec, int tid, int nthreads) {
    if (vec == 4)
        stage_rows_by<4>(dst, src, nrows, c, pitch, tid, nthreads);
    else if (vec == 2)
        stage_rows_by<2>(dst, src, nrows, c, pitch, tid, nthreads);
    else
        stage_rows_by<1>(dst, src, nrows, c, pitch, tid, nthreads);
}

// rows [0, nrows) of `w` pixels of c floats, contiguous at src, into shared
// rows of `pitch` floats, a pixel every `pc` floats (pc > c), `VEC` floats a
// copy
template <int VEC>
__device__ __forceinline__ void stage_pixels_by(float* dst, const float* src, int nrows, int w,
                                                int c, int pc, int pitch, int tid, int nthreads) {
    const int per = c / VEC;
    for (int e = tid; e < nrows * w * per; e += nthreads) {
        const int q = e / per, r = q / w;
        cp_async<4 * VEC>(dst + r * pitch + (q - r * w) * pc + VEC * (e - q * per), src + VEC * e);
    }
}

// zero the staged rows [0, r_lo) and [r_hi, sh) of a stage of rows of `rp`
// floats: the rows of a tile's window that lie outside the image
__device__ __forceinline__ void zero_rows(float* st, int r_lo, int r_hi, int sh, int rp, int tid,
                                          int nthreads) {
    const int q = rp >> 2, nz = r_lo + sh - r_hi;
    float4* st4 = reinterpret_cast<float4*>(st);
    for (int e = tid; e < nz * q; e += nthreads) {
        const int row = e / q, r = row < r_lo ? row : r_hi + row - r_lo;
        st4[r * q + (e - row * q)] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
}

// K9's tile window into the stage `st` (rows of `rp` floats): staged row r
// is input row iy0 + r of image b; rows outside the image are zeroed, the
// others copied (cp.async) from column offset `col0` on, either as one span
// of w * c floats (pc == c) or a pixel at a time (a pixel every pc floats).
// The halo columns are never written here: they keep the prologue's zeros.
__device__ __forceinline__ void stage_window(float* st, const float* in, int b, int iy0, int sh,
                                             int h, int w, int c, int pc, int rp, int col0,
                                             int vec, int tid, int nthreads) {
    const int r_lo = min(sh, max(0, -iy0));
    const int r_hi = max(r_lo, min(sh, h - iy0));
    zero_rows(st, r_lo, r_hi, sh, rp, tid, nthreads);
    const float* src = in + ((long long)b * h + iy0 + r_lo) * w * c;
    float* dst = st + r_lo * rp + col0;
    const int nrows = r_hi - r_lo;
    if (pc == c)
        stage_rows(dst, src, nrows, w * c, rp, vec, tid, nthreads);
    else if (vec == 2)
        stage_pixels_by<2>(dst, src, nrows, w, c, pc, rp, tid, nthreads);
    else
        stage_pixels_by<1>(dst, src, nrows, w, c, pc, rp, tid, nthreads);
}

__device__ __forceinline__ void fma4(float4& acc, const float4 v, const float4 w) {
    acc.x = __fmaf_rn(v.x, w.x, acc.x);
    acc.y = __fmaf_rn(v.y, w.y, acc.y);
    acc.z = __fmaf_rn(v.z, w.z, acc.z);
    acc.w = __fmaf_rn(v.w, w.w, acc.w);
}

// the epilogue of channels co0 .. co0 + k - 1 (k <= 4) of one output:
// + bias, ReLU, stored as a float4 (vec 4), float2s (vec 2) or floats
__device__ __forceinline__ void store_out(float* o, float v[4], int k, const float* bias, int co0,
                                          int relu, int vec) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        if (bias != nullptr && e < k) v[e] = __fadd_rn(v[e], bias[co0 + e]);
        if (relu) v[e] = fmaxf(v[e], 0.0f);
    }
    if (vec == 4 && k == 4) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else if (vec == 2) {
        if (k >= 2) *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
        if (k >= 4) *reinterpret_cast<float2*>(o + 2) = make_float2(v[2], v[3]);
    } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
            if (e < k) o[e] = v[e];
    }
}

// K9's shared memory in floats (blazeface.py k9_smem_bytes): the filter
// ([25, ceil4(C)] depthwise, [25 C_in, ceil8(C_out)] full) and `stages`
// stages of (th - 1) s + 5 rows of `rp` floats
__host__ __device__ __forceinline__ long long conv5x5_smem_floats(int depthwise, int cin, int cout,
                                                                  int th, int stride, int rp,
                                                                  int stages) {
    const long long wf = depthwise ? 25LL * ((cin + 3) & ~3) : 25LL * cin * ((cout + 7) & ~7);
    return wf + (long long)stages * ((th - 1) * stride + 5) * rp;
}

// zero `nfloats` (a multiple of 4) of shared memory, then wait for all
__device__ __forceinline__ void zero_shared(float* p, int nfloats, int tid, int nthreads) {
    float4* z = reinterpret_cast<float4*>(p);
    for (int i = tid; i < (nfloats >> 2); i += nthreads) z[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncthreads();
}

// K9, depthwise form: see the header. Items are (channel group g, tile row
// ty, run k), g fastest; run k is output columns kR .. kR + R - 1.
template <int R, int S>
__global__ void __launch_bounds__(kK9MaxThreads) dw5x5_kernel(
    const float* __restrict__ in, const float* __restrict__ kernel, const float* __restrict__ bias,
    float* __restrict__ out, int n, int h, int w, int c, int oh, int ow, int pad_top,
    int pad_left, int th, int rp, int vec_in, int vec_w, int vec_out, int relu) {
    extern __shared__ __align__(16) float sm[];
    const int tid = threadIdx.x, nthreads = blockDim.x;
    const int pc = (c + 3) & ~3, groups = pc >> 2;
    const int runs = (ow + R - 1) / R;
    const int sh = (th - 1) * S + 5, stage = sh * rp;
    const int bands = (oh + th - 1) / th;
    const long long tiles = (long long)n * bands;
    const int two = tiles > gridDim.x;  // a block walks more than one tile
    float* sw = sm;                     // [25, pc], zero past c
    float* st = sw + 25 * pc;           // one or two stages of [sh, rp]

    // the halo columns, the padded channels and the weights' padding are
    // read but never copied: zero them
    zero_shared(sm, 25 * pc + (1 + two) * stage, tid, nthreads);
    stage_rows(sw, kernel, 25, c, pc, vec_w, tid, nthreads);
    auto load = [&](long long t, int s) {
        if (t >= tiles) return;
        const int b = (int)(t / bands), oy0 = (int)(t - (long long)b * bands) * th;
        stage_window(st + s * stage, in, b, oy0 * S - pad_top, sh, h, w, c, pc, rp, pad_left * pc,
                     vec_in, tid, nthreads);
    };
    long long t = blockIdx.x;
    load(t, 0);
    cp_async_commit();  // the weights and the first tile
    const int items = groups * th * runs;
    for (int s = 0; t < tiles; t += gridDim.x, s ^= 1) {
        load(t + gridDim.x, s ^ 1);
        cp_async_commit();
        cp_async_wait_prior();
        __syncthreads();
        const float* sx = st + s * stage;
        const int b = (int)(t / bands), oy0 = (int)(t - (long long)b * bands) * th;
        const int rows = min(th, oh - oy0);
        for (int it = tid; it < items; it += nthreads) {
            const int rest = it / groups, g = it - rest * groups;
            const int k = rest / th, ty = rest - k * th;
            if (ty >= rows) continue;
            const float* base = sx + ty * S * rp + k * R * S * pc + 4 * g;
            float4 acc[R];
#pragma unroll
            for (int r = 0; r < R; ++r) acc[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
            for (int ky = 0; ky < 5; ++ky) {
                float4 wk[5];
#pragma unroll
                for (int kx = 0; kx < 5; ++kx)
                    wk[kx] = *reinterpret_cast<const float4*>(sw + (ky * 5 + kx) * pc + 4 * g);
                const float* row = base + ky * rp;
#pragma unroll
                for (int j = 0; j < (R - 1) * S + 5; ++j) {
                    const float4 v = *reinterpret_cast<const float4*>(row + j * pc);
#pragma unroll
                    for (int r = 0; r < R; ++r) {
                        const int kx = j - r * S;  // taps in order: kx rises with j
                        if (kx >= 0 && kx < 5) fma4(acc[r], v, wk[kx]);
                    }
                }
            }
            const int co0 = 4 * g, kc = min(4, c - co0);
            float* o = out + (((long long)b * oh + oy0 + ty) * ow + k * R) * c + co0;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                if (k * R + r >= ow) break;
                float v[4] = {acc[r].x, acc[r].y, acc[r].z, acc[r].w};
                store_out(o + r * c, v, kc, bias, co0, relu, vec_out);
            }
        }
        __syncthreads();  // the stage is free for the next load into it
    }
}

// K9, full form (the stem): see the header. Items are (channel group q of
// 8, column k, tile row ty), q fastest: lanes sharing a pixel read one
// address, neighbouring pixels s cin floats apart; column k is output pixels
// k, k + cols, ..., k + (P - 1) cols of the row (P = kK9FullPx). CIN > 0 is
// C_in known at compile time (the stem's 3: the whole 5 x 5 x C_in loop
// unrolled).
template <int S, int CIN>
__global__ void __launch_bounds__(kK9MaxThreads) full5x5_kernel(
    const float* __restrict__ in, const float* __restrict__ kernel, const float* __restrict__ bias,
    float* __restrict__ out, int n, int h, int w, int cin_, int oh, int ow, int cout, int pad_top,
    int pad_left, int th, int rp, int vec_in, int vec_w, int vec_out, int relu) {
    constexpr int P = kK9FullPx;
    extern __shared__ __align__(16) float sm[];
    const int cin = CIN > 0 ? CIN : cin_;
    const int tid = threadIdx.x, nthreads = blockDim.x;
    const int coutp = (cout + 7) & ~7, groups = coutp >> 3;
    const int cols = (ow + P - 1) / P;
    const int sh = (th - 1) * S + 5, stage = sh * rp;
    const int bands = (oh + th - 1) / th;
    const long long tiles = (long long)n * bands;
    const int two = tiles > gridDim.x;
    // staged column x sits at lead + x cin: the image's first column (x =
    // pad_left) on a `vec_in` boundary, so the span copies align
    const int lead = (vec_in - (pad_left * cin) % vec_in) % vec_in;
    float* sw = sm;                     // [25 cin, coutp], zero past cout
    float* st = sw + 25 * cin * coutp;  // one or two stages of [sh, rp]

    zero_shared(sm, 25 * cin * coutp + (1 + two) * stage, tid, nthreads);
    stage_rows(sw, kernel, 25 * cin, cout, coutp, vec_w, tid, nthreads);
    auto load = [&](long long t, int s) {
        if (t >= tiles) return;
        const int b = (int)(t / bands), oy0 = (int)(t - (long long)b * bands) * th;
        stage_window(st + s * stage, in, b, oy0 * S - pad_top, sh, h, w, cin, cin, rp,
                     lead + pad_left * cin, vec_in, tid, nthreads);
    };
    long long t = blockIdx.x;
    load(t, 0);
    cp_async_commit();
    const int items = groups * cols * th;
    const int step = cols * S * cin;  // floats between a thread's pixels
    for (int s = 0; t < tiles; t += gridDim.x, s ^= 1) {
        load(t + gridDim.x, s ^ 1);
        cp_async_commit();
        cp_async_wait_prior();
        __syncthreads();
        const float* sx = st + s * stage;
        const int b = (int)(t / bands), oy0 = (int)(t - (long long)b * bands) * th;
        const int rows = min(th, oh - oy0);
        for (int it = tid; it < items; it += nthreads) {
            const int rest = it / groups, q = it - rest * groups;
            const int ty = rest / cols, k = rest - ty * cols;
            if (ty >= rows) continue;
            float acc[P][8];
#pragma unroll
            for (int p = 0; p < P; ++p)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[p][j] = 0.0f;
            const float* base = sx + ty * S * rp + lead + k * S * cin;
#pragma unroll
            for (int ky = 0; ky < 5; ++ky) {
#pragma unroll
                for (int kx = 0; kx < 5; ++kx) {
                    const float* wt = sw + (ky * 5 + kx) * cin * coutp + 8 * q;
                    const float* src = base + ky * rp + kx * cin;
#pragma unroll
                    for (int ci = 0; ci < cin; ++ci) {
                        const float4 w0 = *reinterpret_cast<const float4*>(wt + ci * coutp);
                        const float4 w1 = *reinterpret_cast<const float4*>(wt + ci * coutp + 4);
                        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
                        for (int p = 0; p < P; ++p) {
                            const float v = src[p * step + ci];
#pragma unroll
                            for (int j = 0; j < 8; ++j) acc[p][j] = __fmaf_rn(v, wv[j], acc[p][j]);
                        }
                    }
                }
            }
            const int co0 = 8 * q;
#pragma unroll
            for (int p = 0; p < P; ++p) {
                const int x = k + p * cols;
                if (x >= ow) break;
                float* o = out + (((long long)b * oh + oy0 + ty) * ow + x) * cout + co0;
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    const int c0 = co0 + 4 * hf, kc = min(4, cout - c0);
                    if (kc <= 0) break;
                    float v[4] = {acc[p][4 * hf], acc[p][4 * hf + 1], acc[p][4 * hf + 2],
                                  acc[p][4 * hf + 3]};
                    store_out(o + 4 * hf, v, kc, bias, c0, relu, vec_out);
                }
            }
        }
        __syncthreads();
    }
}

__global__ void __launch_bounds__(kPwMaxThreads) pointwise_kernel(
    const float* __restrict__ in, const float* __restrict__ kernel, const float* __restrict__ bias,
    const float* __restrict__ res, float* __restrict__ out, long long pixels, int w, int cin,
    int cout, int res_c, int res_pool, int tile_px, int stage_out, int vec_in, int vec_res,
    int vec_w, int vec_out) {
    extern __shared__ __align__(16) float sm[];
    const int tid = threadIdx.x, nthreads = blockDim.x;
    const int nch = (cin + 3) >> 2, cin4 = 4 * nch;
    const int cpad = (cout + kCo - 1) / kCo * kCo;
    const int xs = row_pitch(cin), rs = row_pitch(res_c);
    const int rpx = res_pool ? 4 * tile_px : tile_px;
    const int stage = tile_px * xs + (res_c > 0 ? rpx * rs : 0);
    float* sw = sm;                   // [cin4, cpad], zero past cin and cout
    float* sb = sw + cin4 * cpad;     // [cpad]
    float* st = sb + cpad;            // two stages: x rows, then residual rows
    float* so = st + 2 * stage;       // with stage_out: the tile's output

    // the weights' and bias's padding (rows past cin, columns past cout) and
    // the input channels past cin are read but never copied: zero them
    if (cin != cin4 || cout != cpad) {
        for (int i = tid; i < cin4 * cpad + cpad + 2 * stage; i += nthreads) sm[i] = 0.0f;
        __syncthreads();
    }
    stage_rows(sw, kernel, cin, cout, cpad, vec_w, tid, nthreads);
    stage_rows(sb, bias, 1, cout, cpad, vec_width(cout, bias), tid, nthreads);

    const long long tiles = (pixels + tile_px - 1) / tile_px;
    auto load = [&](long long t, int s) {
        if (t >= tiles) return;
        const long long p0 = t * tile_px;
        const int np = (int)min((long long)tile_px, pixels - p0);
        float* sx = st + s * stage;
        stage_rows(sx, in + p0 * cin, np, cin, xs, vec_in, tid, nthreads);
        if (res_c > 0) {
            const int k = res_pool ? 4 : 1;
            stage_rows(sx + tile_px * xs, res + k * p0 * res_c, k * np, res_c, rs, vec_res, tid,
                       nthreads);
        }
    };
    long long t = blockIdx.x;
    load(t, 0);
    cp_async_commit();  // the weights, the bias and the first tile
    const int npg = tile_px >> 2, items = cpad / kCo * npg;
    for (int s = 0; t < tiles; t += gridDim.x, s ^= 1) {
        load(t + gridDim.x, s ^ 1);
        cp_async_commit();
        cp_async_wait_prior();
        __syncthreads();
        const float* sx = st + s * stage;
        const float* sr = sx + tile_px * xs;
        const long long p0 = t * tile_px;
        const int np = (int)min((long long)tile_px, pixels - p0);
        for (int it = tid; it < items; it += nthreads) {
            const int cg = it / npg, pg = it - cg * npg, co0 = cg * kCo;
            float acc[4][kCo];
#pragma unroll
            for (int k = 0; k < 4; ++k)
#pragma unroll
                for (int j = 0; j < kCo; ++j) acc[k][j] = 0.0f;
            for (int q = 0; q < nch; ++q) {
                float xv[4][4];
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const float4 v =
                        *reinterpret_cast<const float4*>(sx + (pg + k * npg) * xs + 4 * q);
                    xv[k][0] = v.x, xv[k][1] = v.y, xv[k][2] = v.z, xv[k][3] = v.w;
                }
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
                    const float4 v =
                        *reinterpret_cast<const float4*>(sw + (4 * q + kk) * cpad + co0);
                    const float wv[kCo] = {v.x, v.y, v.z, v.w};
#pragma unroll
                    for (int k = 0; k < 4; ++k)
#pragma unroll
                        for (int j = 0; j < kCo; ++j)
                            acc[k][j] = __fmaf_rn(xv[k][kk], wv[j], acc[k][j]);
                }
            }
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int lp = pg + k * npg;
                if (lp >= np) continue;
                float v[kCo];
#pragma unroll
                for (int j = 0; j < kCo; ++j) v[j] = __fadd_rn(acc[k][j], sb[co0 + j]);
                if (co0 < res_c) {
                    float4 a;
                    if (res_pool) {
                        const int lr = lp / w, lx = lp - lr * w;
                        const float* r0 = sr + (2 * lr * 2 * w + 2 * lx) * rs + co0;
                        const float* r1 = r0 + 2 * w * rs;
                        a = *reinterpret_cast<const float4*>(r0);
                        const float4 b = *reinterpret_cast<const float4*>(r0 + rs);
                        const float4 c = *reinterpret_cast<const float4*>(r1);
                        const float4 d = *reinterpret_cast<const float4*>(r1 + rs);
                        a.x = fmaxf(fmaxf(a.x, b.x), fmaxf(c.x, d.x));
                        a.y = fmaxf(fmaxf(a.y, b.y), fmaxf(c.y, d.y));
                        a.z = fmaxf(fmaxf(a.z, b.z), fmaxf(c.z, d.z));
                        a.w = fmaxf(fmaxf(a.w, b.w), fmaxf(c.w, d.w));
                    } else {
                        a = *reinterpret_cast<const float4*>(sr + lp * rs + co0);
                    }
                    const float rv[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        if (co0 + e < res_c) v[e] = __fadd_rn(v[e], rv[e]);
                }
#pragma unroll
                for (int j = 0; j < kCo; ++j) v[j] = fmaxf(v[j], 0.0f);
                if (stage_out) {
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        if (co0 + e < cout) so[lp * cout + co0 + e] = v[e];
                    continue;
                }
                float* o = out + (p0 + lp) * cout + co0;
                if (vec_out == 4 && co0 + 4 <= cout) {
                    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
                } else if (vec_out == 2 && co0 + 4 <= cout) {
                    *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
                    *reinterpret_cast<float2*>(o + 2) = make_float2(v[2], v[3]);
                } else {
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        if (co0 + e < cout) o[e] = v[e];
                }
            }
        }
        if (stage_out) {  // the tile's output as one span, 16-byte stores
            __syncthreads();
            float* o = out + p0 * cout;
            const int span = np * cout;
            const int nvec = ((uintptr_t)o & 15) == 0 ? span / 4 : 0;
            for (int i = tid; i < nvec; i += nthreads)
                reinterpret_cast<float4*>(o)[i] = reinterpret_cast<const float4*>(so)[i];
            for (int i = 4 * nvec + tid; i < span; i += nthreads) o[i] = so[i];
        }
        __syncthreads();  // the stage is free for the next load into it
    }
}

// one anchor map of K10's head form, by value
struct HeadMap {
    const float* in;  // [n, hw, cin]
    const float* wc;  // [cin, na]
    const float* bc;  // [na]
    const float* wr;  // [cin, 4 na]
    const float* br;  // [4 na]
    int hw, cin, na, offset, tile_px, tiles, vec_in;
};

// K10 head form's shared memory in floats (blazeface.py head_smem_bytes):
// the weight columns [cin, 5 na] and biases [5 na] (each from a 16-byte
// boundary), the tile's pixels [ceil4(tile_px), row_pitch(cin)] and their
// logits [ceil4(tile_px), 5 na]
__host__ __device__ __forceinline__ int head_smem_floats(int cin, int na, int tile_px) {
    const int cols = 5 * na, px = (tile_px + 3) & ~3;
    return ((cin * cols + 3) & ~3) + ((cols + 3) & ~3) + px * row_pitch(cin) + px * cols;
}

__global__ void __launch_bounds__(kHeadMaxThreads) head_kernel(HeadMap m0, HeadMap m1,
                                                                const float* __restrict__ anchors,
                                                                float* __restrict__ probs,
                                                                float* __restrict__ boxes, int n,
                                                                int total_anchors, int vec_box) {
    extern __shared__ __align__(16) float sm[];
    const int tid = threadIdx.x, nthreads = blockDim.x;
    const bool second = blockIdx.x >= m0.tiles;
    const HeadMap m = second ? m1 : m0;
    const int t = second ? blockIdx.x - m0.tiles : blockIdx.x;
    const int cin = m.cin, na = m.na, cols = 5 * na, xs = row_pitch(cin);
    float* sw = sm;                              // [cin, cols]: class | offsets
    float* sb = sw + ((cin * cols + 3) & ~3);    // [cols]
    float* sx = sb + ((cols + 3) & ~3);          // [tile_px, xs]
    float* sl = sx + ((m.tile_px + 3) & ~3) * xs;  // [ceil4(tile_px), cols] logits
    const long long p0 = (long long)t * m.tile_px;
    const int np = (int)min((long long)m.tile_px, (long long)n * m.hw - p0);

    stage_rows(sx, m.in + p0 * cin, np, cin, xs, m.vec_in, tid, nthreads);
    stage_rows_by<1>(sw, m.wc, cin, na, cols, tid, nthreads);
    stage_rows_by<1>(sw + na, m.wr, cin, 4 * na, cols, tid, nthreads);
    stage_rows_by<1>(sb, m.bc, 1, na, cols, tid, nthreads);
    stage_rows_by<1>(sb + na, m.br, 1, 4 * na, cols, tid, nthreads);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    // logits: a thread a column of 4 pixels, each one FMA chain over ci in
    // order, + bias; the 4 pixels share each weight read (pixels past np
    // compute on stale rows and are never read)
    const int quads = (np + 3) >> 2;
    for (int it = tid; it < quads * cols; it += nthreads) {
        const int pq = it / cols, col = it - pq * cols;
        const float* xr = sx + 4 * pq * xs;
        const float* wcol = sw + col;
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        int ci = 0;
        if ((cin & 3) == 0) {
            for (; ci < cin; ci += 4) {
                float4 v[4];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    v[j] = *reinterpret_cast<const float4*>(xr + j * xs + ci);
                const float w0 = wcol[ci * cols], w1 = wcol[(ci + 1) * cols];
                const float w2 = wcol[(ci + 2) * cols], w3 = wcol[(ci + 3) * cols];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    acc[j] = __fmaf_rn(v[j].x, w0, acc[j]);
                    acc[j] = __fmaf_rn(v[j].y, w1, acc[j]);
                    acc[j] = __fmaf_rn(v[j].z, w2, acc[j]);
                    acc[j] = __fmaf_rn(v[j].w, w3, acc[j]);
                }
            }
        }
        for (; ci < cin; ++ci) {
            const float wv = wcol[ci * cols];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[j] = __fmaf_rn(xr[j * xs + ci], wv, acc[j]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) sl[(4 * pq + j) * cols + col] = __fadd_rn(acc[j], sb[col]);
    }
    __syncthreads();

    // a (pixel, anchor): the sigmoid and the anchor decode
    for (int it = tid; it < np * na; it += nthreads) {
        const int p = it / na, a = it - p * na;
        const long long q = p0 + p;  // pixel over the batch
        const int b = (int)(q / m.hw);
        const int k = m.offset + (int)(q - (long long)b * m.hw) * na + a;  // anchor index
        const float* lg = sl + p * cols;
        const float cls = lg[a];
        const float r0 = lg[na + 4 * a], r1 = lg[na + 4 * a + 1];
        const float r2 = lg[na + 4 * a + 2], r3 = lg[na + 4 * a + 3];
        const float4 an = vec_box ? *reinterpret_cast<const float4*>(anchors + 4 * k)
                                  : make_float4(anchors[4 * k], anchors[4 * k + 1],
                                                anchors[4 * k + 2], anchors[4 * k + 3]);
        const long long o = (long long)b * total_anchors + k;
        probs[o] = 1.0f / (1.0f + expf(-cls));
        const float4 bx = make_float4(
            __fadd_rn(an.x, __fmul_rn(__fmul_rn(r0, 0.1f), an.z)),
            __fadd_rn(an.y, __fmul_rn(__fmul_rn(r1, 0.1f), an.w)),
            __fmul_rn(an.z, expf(fminf(fmaxf(__fmul_rn(r2, 0.2f), -4.0f), 4.0f))),
            __fmul_rn(an.w, expf(fminf(fmaxf(__fmul_rn(r3, 0.2f), -4.0f), 4.0f))));
        if (vec_box) {
            *reinterpret_cast<float4*>(boxes + 4 * o) = bx;
        } else {
            float* d = boxes + 4 * o;
            d[0] = bx.x, d[1] = bx.y, d[2] = bx.z, d[3] = bx.w;
        }
    }
}

// raise kernel `id`'s dynamic shared-memory ceiling to `smem`, once a device
// and size (a benign race: two threads may both set it)
template <typename F>
cudaError_t ensure_smem(F fn, int id, long long smem) {
    static int seen[kSmemKernels][64] = {};
    if (smem <= 48 * 1024) return cudaSuccess;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 0 && dev < 64 && smem <= seen[id][dev]) return cudaSuccess;
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess && dev >= 0 && dev < 64) seen[id][dev] = (int)smem;
    return err;
}

template <int R, int S>
cudaError_t launch_dw(int id, int blocks, int threads, long long smem, cudaStream_t stream,
                      const float* in, const float* kernel, const float* bias, float* out, int n,
                      int h, int w, int c, int oh, int ow, int pad_top, int pad_left, int th,
                      int rp, int vec_in, int vec_w, int vec_out, int relu) {
    cudaError_t err = ensure_smem(dw5x5_kernel<R, S>, id, smem);
    if (err != cudaSuccess) return err;
    dw5x5_kernel<R, S><<<blocks, threads, smem, stream>>>(in, kernel, bias, out, n, h, w, c, oh,
                                                          ow, pad_top, pad_left, th, rp, vec_in,
                                                          vec_w, vec_out, relu);
    return cudaGetLastError();
}

template <int S, int CIN>
cudaError_t launch_full(int id, int blocks, int threads, long long smem, cudaStream_t stream,
                        const float* in, const float* kernel, const float* bias, float* out, int n,
                        int h, int w, int cin, int oh, int ow, int cout, int pad_top,
                        int pad_left, int th, int rp, int vec_in, int vec_w, int vec_out,
                        int relu) {
    cudaError_t err = ensure_smem(full5x5_kernel<S, CIN>, id, smem);
    if (err != cudaSuccess) return err;
    full5x5_kernel<S, CIN><<<blocks, threads, smem, stream>>>(
        in, kernel, bias, out, n, h, w, cin, oh, ow, cout, pad_top, pad_left, th, rp, vec_in,
        vec_w, vec_out, relu);
    return cudaGetLastError();
}

}  // namespace

// K9 on `stream`: `in` f32 [n, h, w, cin] -> `out` f32 [n, oh, ow, cout];
// `kernel` HWIO f32 [5, 5, cin, cout] or, with `depthwise` (cout == cin),
// [5, 5, 1, cin]; `bias` f32 [cout] or null; SAME padding given as
// pad_top/pad_left; stride 1 or 2. The plan (blazeface.py k9_plan):
// `blocks` persistent blocks of `threads` threads walk tiles of `th` output
// rows of one image, staged in rows of `rp` floats, with `run` output
// pixels a thread: 4, or 8 in the depthwise form at stride 1. Returns
// cudaGetLastError() after the launch.
extern "C" int flyimg_bf_conv5x5(const float* in, const float* kernel, const float* bias,
                                 float* out, int n, int h, int w, int cin, int oh, int ow,
                                 int cout, int stride, int pad_top, int pad_left, int depthwise,
                                 int relu, int th, int run, int rp, int threads, int blocks,
                                 void* stream) {
    if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || oh <= 0 || ow <= 0 || cout <= 0 ||
        (stride != 1 && stride != 2) || (depthwise && cout != cin) || th <= 0 || rp <= 0 ||
        rp % 4 != 0 || threads < 32 || threads > kK9MaxThreads || threads % 32 != 0 ||
        blocks <= 0 || (run != 4 && !(run == 8 && depthwise && stride == 1)))
        return (int)cudaErrorInvalidValue;
    const int pc = depthwise ? (cin + 3) & ~3 : cin;
    // staged columns: the runs' reads (and the full form's lead)
    const int span = ((ow + run - 1) / run * run - 1) * stride + 5;
    if (rp < span * pc + (depthwise ? 0 : 3)) return (int)cudaErrorInvalidValue;
    const long long tiles = (long long)n * ((oh + th - 1) / th);
    const int stages = tiles > blocks ? 2 : 1;
    const long long smem = (long long)sizeof(float) *
                           conv5x5_smem_floats(depthwise, cin, cout, th, stride, rp, stages);
    if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
    const int vec_w = vec_width(cout, kernel);
    const int vec_out = vec_width(cout, out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (depthwise) {
        // one span a row where c % 4 == 0, else a pixel at a time
        const int vec_in = vec_width(cin % 4 == 0 ? w * cin : cin, in);
#define FLYIMG_DW(R, S, ID)                                                                     \
    launch_dw<R, S>(ID, blocks, threads, smem, s, in, kernel, bias, out, n, h, w, cin, oh, ow, \
                    pad_top, pad_left, th, rp, vec_in, vec_w, vec_out, relu)
        if (run == 8)
            err = FLYIMG_DW(8, 1, 0);
        else
            err = stride == 1 ? FLYIMG_DW(4, 1, 1) : FLYIMG_DW(4, 2, 2);
#undef FLYIMG_DW
    } else {
        const int vec_in = vec_width(w * cin, in);
#define FLYIMG_FULL(S, CIN, ID)                                                              \
    launch_full<S, CIN>(ID, blocks, threads, smem, s, in, kernel, bias, out, n, h, w, cin, oh, \
                        ow, cout, pad_top, pad_left, th, rp, vec_in, vec_w, vec_out, relu)
        if (cin != 3)
            err = stride == 1 ? FLYIMG_FULL(1, 0, 3) : FLYIMG_FULL(2, 0, 4);
        else
            err = stride == 1 ? FLYIMG_FULL(1, 3, 5) : FLYIMG_FULL(2, 3, 6);
#undef FLYIMG_FULL
    }
    return (int)err;
}

// K10, block form: `in` f32 [n, h, w, cin] (the depthwise output), `kernel`
// f32 [cin, cout], `bias` f32 [cout], `res` the block input f32
// [n, h, w, res_c] or, with `res_pool`, [n, 2h, 2w, res_c] (res_c <= cout)
// -> `out` f32 [n, h, w, cout] = relu(in . kernel + bias + residual).
// The plan (blazeface.py k10_plan): `blocks` persistent blocks of `threads`
// threads walk tiles of `tile_px` pixels (a multiple of 4, and of w with
// res_pool); with `stage_out` a tile's output is gathered in shared memory
// and stored as one span.
extern "C" int flyimg_bf_pointwise(const float* in, const float* kernel, const float* bias,
                                   const float* res, float* out, int n, int h, int w, int cin,
                                   int cout, int res_c, int res_pool, int tile_px, int stage_out,
                                   int threads, int blocks, void* stream) {
    if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || res_c < 0 || res_c > cout ||
        tile_px <= 0 || tile_px % 4 != 0 || (res_pool && tile_px % w != 0) || threads < 32 ||
        threads > kPwMaxThreads || threads % 32 != 0 || blocks <= 0)
        return (int)cudaErrorInvalidValue;
    const long long smem =
        (long long)sizeof(float) *
        pointwise_smem_floats(cin, cout, res_c, res_pool, tile_px, stage_out);
    if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
    const cudaError_t err = ensure_smem(pointwise_kernel, kSmemPointwise, smem);
    if (err != cudaSuccess) return (int)err;
    pointwise_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        in, kernel, bias, res, out, (long long)n * h * w, w, cin, cout, res_c, res_pool, tile_px,
        stage_out, vec_width(cin, in), res_c > 0 ? vec_width(res_c, res) : 1,
        vec_width(cout, kernel), vec_width(cout, out));
    return (int)cudaGetLastError();
}

// K10, head form, over both anchor maps in one launch: map i is `in_i` f32
// [n, hw_i, cin_i] with class kernel `wc_i` [cin_i, na_i] and bias `bc_i`
// [na_i], offset kernel `wr_i` [cin_i, 4 na_i] and bias `br_i` [4 na_i], in
// tiles of `tile_i` pixels; `anchors` f32 [total_anchors, 4] (cx, cy, w, h).
// Writes, for each pixel and anchor a of
// map i, k = offset_i + pixel * na_i + a: probs[b, k] = sigmoid(class logit)
// and boxes[b, k] = the decoded (cx, cy, w, h), into `probs` f32
// [n, total_anchors] and `boxes` f32 [n, total_anchors, 4].
extern "C" int flyimg_bf_head(const float* in0, const float* wc0, const float* bc0,
                              const float* wr0, const float* br0, int hw0, int cin0, int na0,
                              int offset0, int tile0, const float* in1, const float* wc1,
                              const float* bc1, const float* wr1, const float* br1, int hw1,
                              int cin1, int na1, int offset1, int tile1, const float* anchors,
                              float* probs, float* boxes, int n, int total_anchors, int threads,
                              void* stream) {
    HeadMap maps[2] = {{in0, wc0, bc0, wr0, br0, hw0, cin0, na0, offset0, tile0, 0, 0},
                       {in1, wc1, bc1, wr1, br1, hw1, cin1, na1, offset1, tile1, 0, 0}};
    if (n <= 0 || threads < 32 || threads > kHeadMaxThreads || threads % 32 != 0)
        return (int)cudaErrorInvalidValue;
    long long smem = 0, blocks = 0;
    for (int i = 0; i < 2; ++i) {
        HeadMap& m = maps[i];
        if (m.in == nullptr || m.hw <= 0 || m.cin <= 0 || m.na <= 0 || m.tile_px <= 0 ||
            m.offset < 0 || m.offset + (long long)m.hw * m.na > total_anchors)
            return (int)cudaErrorInvalidValue;
        m.tiles = (int)(((long long)n * m.hw + m.tile_px - 1) / m.tile_px);
        m.vec_in = vec_width(m.cin, m.in);
        smem = max(smem, (long long)sizeof(float) * head_smem_floats(m.cin, m.na, m.tile_px));
        blocks += m.tiles;
    }
    if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
    cudaError_t err = ensure_smem(head_kernel, kSmemHead, smem);
    if (err != cudaSuccess) return (int)err;
    const int vec_box = ((uintptr_t)boxes & 15) == 0 && ((uintptr_t)anchors & 15) == 0;
    head_kernel<<<(int)blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        maps[0], maps[1], anchors, probs, boxes, n, total_anchors, vec_box);
    return (int)cudaGetLastError();
}
