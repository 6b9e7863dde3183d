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
// What bounds them on an H100: neither bytes nor flops at the serving
// batch (64 views of 128x128: ~2.4 GFLOP and ~170 MB of activations a
// forward, tens of microseconds at the card's rates); the forward is 35
// launches, so launch latency. K9 is a thread an output element (channels
// fastest, so a warp reads consecutive channels of one pixel), its filter
// staged in shared memory; the head form is a thread a (pixel, anchor).
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

constexpr int kTaps = 25;
constexpr int kPwMaxThreads = 512;
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

__global__ void conv5x5_kernel(const float* __restrict__ in, const float* __restrict__ kernel,
                               const float* __restrict__ bias, float* __restrict__ out, int n,
                               int h, int w, int cin, int oh, int ow, int cout, int stride,
                               int pad_top, int pad_left, int depthwise, int relu) {
    extern __shared__ float sw[];
    const int wsize = kTaps * (depthwise ? 1 : cin) * cout;
    for (int i = threadIdx.x; i < wsize; i += blockDim.x) sw[i] = kernel[i];
    __syncthreads();
    const long long total = (long long)n * oh * ow * cout;
    for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < total;
         p += (long long)gridDim.x * blockDim.x) {
        const int co = (int)(p % cout);
        long long r = p / cout;
        const int ox = (int)(r % ow);
        r /= ow;
        const int oy = (int)(r % oh);
        const int b = (int)(r / oh);
        float acc = 0.0f;
        for (int ky = 0; ky < 5; ++ky) {
            const int iy = oy * stride - pad_top + ky;
            if (iy < 0 || iy >= h) continue;
            for (int kx = 0; kx < 5; ++kx) {
                const int ix = ox * stride - pad_left + kx;
                if (ix < 0 || ix >= w) continue;
                const float* src = in + (((long long)b * h + iy) * w + ix) * cin;
                const int tap = ky * 5 + kx;
                if (depthwise) {
                    acc = __fmaf_rn(src[co], sw[tap * cout + co], acc);
                } else {
                    const float* wt = sw + tap * cin * cout + co;
                    for (int ci = 0; ci < cin; ++ci) acc = __fmaf_rn(src[ci], wt[ci * cout], acc);
                }
            }
        }
        if (bias != nullptr) acc = __fadd_rn(acc, bias[co]);
        if (relu) acc = fmaxf(acc, 0.0f);
        out[p] = acc;
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

__global__ void head_kernel(const float* __restrict__ in, const float* __restrict__ wc,
                            const float* __restrict__ bc, const float* __restrict__ wr,
                            const float* __restrict__ br, const float* __restrict__ anchors,
                            float* __restrict__ probs, float* __restrict__ boxes, int n, int hw,
                            int cin, int na, int total_anchors, int offset) {
    const long long total = (long long)n * hw * na;
    for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < total;
         p += (long long)gridDim.x * blockDim.x) {
        const int a = (int)(p % na);
        const long long q = p / na;            // pixel over the batch
        const int b = (int)(q / hw);
        const int k = offset + (int)(q % hw) * na + a;   // anchor index
        const float* xs = in + q * cin;
        float cls = 0.0f, r0 = 0.0f, r1 = 0.0f, r2 = 0.0f, r3 = 0.0f;
        const int rc = 4 * na;
        for (int ci = 0; ci < cin; ++ci) {
            const float v = xs[ci];
            const float* wrow = wr + ci * rc + 4 * a;
            cls = __fmaf_rn(v, wc[ci * na + a], cls);
            r0 = __fmaf_rn(v, wrow[0], r0);
            r1 = __fmaf_rn(v, wrow[1], r1);
            r2 = __fmaf_rn(v, wrow[2], r2);
            r3 = __fmaf_rn(v, wrow[3], r3);
        }
        cls = __fadd_rn(cls, bc[a]);
        r0 = __fadd_rn(r0, br[4 * a + 0]);
        r1 = __fadd_rn(r1, br[4 * a + 1]);
        r2 = __fadd_rn(r2, br[4 * a + 2]);
        r3 = __fadd_rn(r3, br[4 * a + 3]);
        const float* an = anchors + 4 * k;
        const long long o = (long long)b * total_anchors + k;
        probs[o] = 1.0f / (1.0f + expf(-cls));
        float* bx = boxes + 4 * o;
        bx[0] = __fadd_rn(an[0], __fmul_rn(__fmul_rn(r0, 0.1f), an[2]));
        bx[1] = __fadd_rn(an[1], __fmul_rn(__fmul_rn(r1, 0.1f), an[3]));
        bx[2] = __fmul_rn(an[2], expf(fminf(fmaxf(__fmul_rn(r2, 0.2f), -4.0f), 4.0f)));
        bx[3] = __fmul_rn(an[3], expf(fminf(fmaxf(__fmul_rn(r3, 0.2f), -4.0f), 4.0f)));
    }
}

int blocks_for(long long total, int threads) {
    const long long want = (total + threads - 1) / threads;
    return (int)(want < 132 * 8 ? want : 132 * 8);
}

}  // namespace

// K9 on `stream`: `in` f32 [n, h, w, cin] -> `out` f32 [n, oh, ow, cout];
// `kernel` HWIO f32 [5, 5, cin, cout] or, with `depthwise` (cout == cin),
// [5, 5, 1, cin]; `bias` f32 [cout] or null; SAME padding given as
// pad_top/pad_left. Returns cudaGetLastError() after the launch.
extern "C" int flyimg_bf_conv5x5(const float* in, const float* kernel, const float* bias,
                                 float* out, int n, int h, int w, int cin, int oh, int ow,
                                 int cout, int stride, int pad_top, int pad_left, int depthwise,
                                 int relu, void* stream) {
    if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || oh <= 0 || ow <= 0 || cout <= 0 ||
        stride < 1 || (depthwise && cout != cin))
        return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(float) * kTaps * (depthwise ? 1 : cin) * cout;
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    const int threads = 256;
    conv5x5_kernel<<<blocks_for((long long)n * oh * ow * cout, threads), threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(in, kernel, bias, out, n, h, w, cin, oh,
                                                          ow, cout, stride, pad_top, pad_left,
                                                          depthwise, relu);
    return (int)cudaGetLastError();
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
    // the shared-memory ceiling is raised once a device, to the largest plan
    // seen (a benign race: two threads may both set it)
    static int smem_set[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= 64 || smem > smem_set[dev]) {
        err = cudaFuncSetAttribute(pointwise_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        if (dev >= 0 && dev < 64) smem_set[dev] = (int)smem;
    }
    pointwise_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        in, kernel, bias, res, out, (long long)n * h * w, w, cin, cout, res_c, res_pool, tile_px,
        stage_out, vec_width(cin, in), res_c > 0 ? vec_width(res_c, res) : 1,
        vec_width(cout, kernel), vec_width(cout, out));
    return (int)cudaGetLastError();
}

// K10, head form: `in` f32 [n, hw, cin]; class kernel `wc` [cin, na] and
// bias `bc` [na]; offset kernel `wr` [cin, 4 na] and bias `br` [4 na];
// `anchors` f32 [total_anchors, 4] (cx, cy, w, h). Writes, for each pixel
// and anchor a, k = offset + pixel * na + a: probs[b, k] = sigmoid(class
// logit) and boxes[b, k] = the decoded (cx, cy, w, h), into `probs` f32
// [n, total_anchors] and `boxes` f32 [n, total_anchors, 4].
extern "C" int flyimg_bf_head(const float* in, const float* wc, const float* bc, const float* wr,
                              const float* br, const float* anchors, float* probs, float* boxes,
                              int n, int hw, int cin, int na, int total_anchors, int offset,
                              void* stream) {
    if (n <= 0 || hw <= 0 || cin <= 0 || na <= 0 || offset < 0 ||
        offset + hw * na > total_anchors)
        return (int)cudaErrorInvalidValue;
    const int threads = 128;
    head_kernel<<<blocks_for((long long)n * hw * na, threads), threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(in, wc, bc, wr, br, anchors, probs, boxes,
                                                       n, hw, cin, na, total_anchors, offset);
    return (int)cudaGetLastError();
}
