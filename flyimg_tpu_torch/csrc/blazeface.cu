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
// launches, so launch latency. Design, simple first: K9 is a thread an
// output element (channels fastest, so a warp reads consecutive channels
// of one pixel), its filter staged in shared memory; K10 stages its
// weights once per persistent block and a tile of 16 pixels' inputs, then
// a thread computes output channels of the tile; the head form is a
// thread a (pixel, anchor). Sums are f32 FMAs in index order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 25;
constexpr int kTile = 16;  // pixels of one K10 tile

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

__global__ void pointwise_kernel(const float* __restrict__ in, const float* __restrict__ kernel,
                                 const float* __restrict__ bias, const float* __restrict__ res,
                                 float* __restrict__ out, int n, int h, int w, int cin, int cout,
                                 int res_c, int res_pool) {
    extern __shared__ float sm[];
    float* sw = sm;                 // [cin, cout]
    float* sx = sm + cin * cout;    // [kTile, cin]
    for (int i = threadIdx.x; i < cin * cout; i += blockDim.x) sw[i] = kernel[i];
    const long long pixels = (long long)n * h * w;
    const long long tiles = (pixels + kTile - 1) / kTile;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
        const long long p0 = t * kTile;
        const int np = (int)min((long long)kTile, pixels - p0);
        __syncthreads();  // the previous tile's readers are done (and sw is staged)
        for (int i = threadIdx.x; i < np * cin; i += blockDim.x) sx[i] = in[p0 * cin + i];
        __syncthreads();
        for (int o = threadIdx.x; o < np * cout; o += blockDim.x) {
            const int pl = o / cout, co = o % cout;
            const long long p = p0 + pl;
            const float* xs = sx + pl * cin;
            float acc = 0.0f;
            for (int ci = 0; ci < cin; ++ci) acc = __fmaf_rn(xs[ci], sw[ci * cout + co], acc);
            float v = __fadd_rn(acc, bias[co]);
            if (co < res_c) {
                float rv;
                if (res_pool) {
                    const int x = (int)(p % w);
                    const long long q = p / w;
                    const int y = (int)(q % h);
                    const long long b = q / h;
                    const int rw = 2 * w;
                    const float* r0 = res + ((b * (2 * h) + 2 * y) * rw + 2 * x) * res_c + co;
                    const float* r1 = r0 + (long long)rw * res_c;
                    rv = fmaxf(fmaxf(r0[0], r0[res_c]), fmaxf(r1[0], r1[res_c]));
                } else {
                    rv = res[p * res_c + co];
                }
                v = __fadd_rn(v, rv);
            }
            out[p * cout + co] = fmaxf(v, 0.0f);
        }
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
extern "C" int flyimg_bf_pointwise(const float* in, const float* kernel, const float* bias,
                                   const float* res, float* out, int n, int h, int w, int cin,
                                   int cout, int res_c, int res_pool, void* stream) {
    if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || res_c < 0 || res_c > cout)
        return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(float) * ((size_t)cin * cout + (size_t)kTile * cin);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    const int threads = 256;
    const long long tiles = ((long long)n * h * w + kTile - 1) / kTile;
    const int blocks = (int)(tiles < 132 * 8 ? tiles : 132 * 8);
    pointwise_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        in, kernel, bias, res, out, n, h, w, cin, cout, res_c, res_pool);
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
