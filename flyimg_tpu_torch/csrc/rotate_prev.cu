// The previous K4 (one thread a pixel over a flat grid-stride loop), kept
// as it was so that chip_smoke.py can hold the current K4 (rotate.cu) to
// its bits. Nothing in the package launches it.
//
// K4: rotate an f32 batch by any angle: inverse-affine map, bilinear gather
// clamped to each member's valid region, background outside, optional
// round/clip/u8 store.
//
// Replaces the JAX package's flyimg_tpu/ops/rotate.py rotate_image_dynamic
// (and the sampled branch of rotate_image, which calls it with the whole
// frame valid), vmapped over the batch and fused by XLA on the TPU.
//
// Per output pixel (yo, xo) of member b, with geometry row
// (th, tw, rot_h, rot_w) = valid (h, w) of the input frame and the host's
// rotated bounds of that region:
//   cy_out = (rot_h - 1) / 2, cx_out = (rot_w - 1) / 2,
//   cy_in = (th - 1) / 2,     cx_in = (tw - 1) / 2,
//   dx = xo - cx_out, dy = yo - cy_out,
//   xs = cos * dx + sin * dy + cx_in,  ys = -sin * dx + cos * dy + cy_in,
// the four taps at floor(xs|ys) + {0, 1} clamped to [0, th-1] x [0, tw-1],
// blended (top row, bottom row, then between them), and replaced by the
// background unless -0.5 <= xs <= tw - 0.5 and -0.5 <= ys <= th - 0.5.
// cos and sin are the host's f32 roundings of cos/sin(radians(deg % 360)).
// Every product and sum is rounded in the reference's order (built with
// --fmad=false): xs and ys decide the floor and the `inside` test, and an ulp
// there is a whole pixel or the background.
//
// What bounds it on an H100: bytes. A pixel reads four taps (12 bytes each,
// neighbours of the previous pixel's, so from cache) and writes 12 (f32) or 3
// (u8) bytes, ~40 flops. Design: one thread per output pixel, consecutive
// threads on consecutive output columns, so a warp's taps lie on at most a
// few source rows; the geometry row is read once a pixel from cache.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint8_t to_u8(float a) {
    return (uint8_t)fminf(fmaxf(rintf(a), 0.0f), 255.0f);
}

__global__ void rotate_prev_kernel(const float* __restrict__ img, const float* __restrict__ geom,
                              float* __restrict__ out_f, uint8_t* __restrict__ out_u8,
                              int batch, int in_h, int in_w, int out_h, int out_w, float cos_t,
                              float sin_t, float bg0, float bg1, float bg2) {
    const long long total = (long long)batch * out_h * out_w;
    for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < total;
         p += (long long)gridDim.x * blockDim.x) {
        const int xo = (int)(p % out_w);
        const long long r = p / out_w;
        const int yo = (int)(r % out_h);
        const long long b = r / out_h;
        const float* g = geom + b * 4;
        const float th = g[0], tw = g[1];
        const float cy_out = __fsub_rn(g[2], 1.0f) / 2.0f;
        const float cx_out = __fsub_rn(g[3], 1.0f) / 2.0f;
        const float cy_in = __fsub_rn(th, 1.0f) / 2.0f;
        const float cx_in = __fsub_rn(tw, 1.0f) / 2.0f;
        const float dx = __fsub_rn((float)xo, cx_out);
        const float dy = __fsub_rn((float)yo, cy_out);
        const float xs = __fadd_rn(__fadd_rn(__fmul_rn(cos_t, dx), __fmul_rn(sin_t, dy)), cx_in);
        const float ys = __fadd_rn(__fadd_rn(__fmul_rn(-sin_t, dx), __fmul_rn(cos_t, dy)), cy_in);
        float v0 = bg0, v1 = bg1, v2 = bg2;
        const bool inside = xs >= -0.5f && xs <= __fsub_rn(tw, 0.5f) && ys >= -0.5f &&
                            ys <= __fsub_rn(th, 0.5f);
        if (inside) {
            const float x0 = floorf(xs), y0 = floorf(ys);
            const float fx = __fsub_rn(xs, x0), fy = __fsub_rn(ys, y0);
            const float hy = __fsub_rn(th, 1.0f), hx = __fsub_rn(tw, 1.0f);
            // clip in f32, then truncate, as the reference's gather does
            const int ya = (int)fminf(fmaxf(y0, 0.0f), hy);
            const int yb = (int)fminf(fmaxf(__fadd_rn(y0, 1.0f), 0.0f), hy);
            const int xa = (int)fminf(fmaxf(x0, 0.0f), hx);
            const int xb = (int)fminf(fmaxf(__fadd_rn(x0, 1.0f), 0.0f), hx);
            const float* base = img + b * in_h * in_w * 3;
            const float* p00 = base + ((long long)ya * in_w + xa) * 3;
            const float* p01 = base + ((long long)ya * in_w + xb) * 3;
            const float* p10 = base + ((long long)yb * in_w + xa) * 3;
            const float* p11 = base + ((long long)yb * in_w + xb) * 3;
            const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
            float v[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                const float top = __fadd_rn(__fmul_rn(__ldg(p00 + c), gx), __fmul_rn(__ldg(p01 + c), fx));
                const float bot = __fadd_rn(__fmul_rn(__ldg(p10 + c), gx), __fmul_rn(__ldg(p11 + c), fx));
                v[c] = __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy));
            }
            v0 = v[0];
            v1 = v[1];
            v2 = v[2];
        }
        if (out_u8) {
            uint8_t* d = out_u8 + p * 3;
            d[0] = to_u8(v0);
            d[1] = to_u8(v1);
            d[2] = to_u8(v2);
        } else {
            float* d = out_f + p * 3;
            d[0] = v0;
            d[1] = v1;
            d[2] = v2;
        }
    }
}

}  // namespace

// Launch K4 on `stream`. img is f32 [batch, in_h, in_w, 3]; geom f32
// [batch, 4] = (valid h, valid w, rotated h, rotated w) with the valid region
// inside the frame; exactly one of out_f (f32) and out_u8 (u8)
// [batch, out_h, out_w, 3] is non-null. Returns cudaGetLastError().
extern "C" int flyimg_rotate_prev(const float* img, const float* geom, float* out_f,
                             uint8_t* out_u8, int batch, int in_h, int in_w, int out_h,
                             int out_w, float cos_t, float sin_t, float bg0, float bg1,
                             float bg2, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (batch <= 0 || in_h <= 0 || in_w <= 0 || out_h <= 0 || out_w <= 0 ||
        (out_f == nullptr) == (out_u8 == nullptr))
        return (int)cudaErrorInvalidValue;
    const int threads = 256;
    const long long total = (long long)batch * out_h * out_w;
    const long long want = (total + threads - 1) / threads;
    const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
    rotate_prev_kernel<<<blocks, threads, 0, s>>>(img, geom, out_f, out_u8, batch, in_h, in_w, out_h,
                                             out_w, cos_t, sin_t, bg0, bg1, bg2);
    return (int)cudaGetLastError();
}
