// K8: the facefind skin-blob masks of a bucket of images: skin probability
// (normalized-rgb chromaticity Gaussian x RGB gates), `> threshold` inside
// each member's valid region, then erode, dilate, dilate, erode with 5x5
// windows clipped to that region, `& valid`.
//
// Replaces the JAX package's flyimg_tpu/models/facefind.py
// _skin_probability and _batched_face_masks (with _morph_clean's open +
// close), which XLA fuses into one jitted program per bucket.
//
// Semantics, per pixel (y, x) of member b, with (vh, vw) = in_true[b]:
//   valid = y < vh && x < vw (in f32);
//   total = ((r + g) + b) + 1e-6; rn = r / total; gn = g / total;
//   a = (rn - 0.44) * inv07; c = (gn - 0.31) * inv05 (inv07, inv05 =
//   f32(1 / f32(0.07)), f32(1 / f32(0.05)): XLA turns the reference's
//   divisions by those constants into these multiplies);
//   d2 = fma(a, a, c * c) (XLA's contraction, measured on the CPU);
//   prob = expf(-0.5 * d2) where r > 60, r > b, r > g * 0.9 and
//   |r - g| > 10, else 0 — every step rounded in that order (explicit
//   __f*_rn intrinsics: none of them is contracted);
//   m0 = valid && prob > threshold[b];
//   then four morphology passes: each output is the min (erode) or max
//   (dilate) of the 5x5 window around it, clipped to the valid region;
//   invalid pixels are 0 after every pass (so the result is `& valid`).
// The threshold is a knife-edge: an ulp of exp flips a pixel, and the four
// passes spread it over an 8-pixel radius. expf is the CUDA math library's,
// as torch's CUDA exp calls it, so the plain version on the card agrees.
//
// What bounds it on an H100: bytes — 3 bytes read and 1 written a pixel in
// the first pass, a byte each way in the morphology passes (the windows'
// re-reads hit L1/L2), and ~30 flops a pixel. Design: five launches, one
// thread a pixel, u8 masks ping-ponged through two scratch planes; the
// probability map is stored only when asked (for the check against the
// plain version). A simple kernel first: fusing the four passes in one
// shared-memory tile with an 8-pixel halo is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float skin_probability(float r, float g, float b, float inv07,
                                                  float inv05) {
    const float total = __fadd_rn(__fadd_rn(__fadd_rn(r, g), b), 1e-6f);
    const float rn = __fdiv_rn(r, total);
    const float gn = __fdiv_rn(g, total);
    const float a = __fmul_rn(__fsub_rn(rn, 0.44f), inv07);
    const float c = __fmul_rn(__fsub_rn(gn, 0.31f), inv05);
    const float d2 = __fmaf_rn(a, a, __fmul_rn(c, c));
    const float chroma = expf(__fmul_rn(-0.5f, d2));
    const bool gate = r > 60.0f && r > b && r > __fmul_rn(g, 0.9f) && fabsf(__fsub_rn(r, g)) > 10.0f;
    return gate ? chroma : 0.0f;
}

__global__ void skin_mask_kernel(const uint8_t* __restrict__ img, const float* __restrict__ in_true,
                                 const float* __restrict__ thresholds, uint8_t* __restrict__ mask,
                                 float* __restrict__ prob_out, int batch, int h, int w,
                                 float inv07, float inv05) {
    const long long total = (long long)batch * h * w;
    for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < total;
         p += (long long)gridDim.x * blockDim.x) {
        const int x = (int)(p % w);
        const long long r = p / w;
        const int y = (int)(r % h);
        const int b = (int)(r / h);
        const uint8_t* s = img + p * 3;
        const float prob = skin_probability((float)s[0], (float)s[1], (float)s[2], inv07, inv05);
        if (prob_out != nullptr) prob_out[p] = prob;
        const bool valid = (float)y < in_true[2 * b] && (float)x < in_true[2 * b + 1];
        mask[p] = (valid && prob > thresholds[b]) ? 1 : 0;
    }
}

__global__ void morph_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                             const float* __restrict__ in_true, int batch, int h, int w, int radius,
                             int dilate) {
    const long long total = (long long)batch * h * w;
    for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < total;
         p += (long long)gridDim.x * blockDim.x) {
        const int x = (int)(p % w);
        const long long r = p / w;
        const int y = (int)(r % h);
        const int b = (int)(r / h);
        const float vh = in_true[2 * b], vw = in_true[2 * b + 1];
        if (!((float)y < vh && (float)x < vw)) {
            out[p] = 0;
            continue;
        }
        const uint8_t* plane = in + (long long)b * h * w;
        int acc = dilate ? 0 : 1;
        for (int yy = max(y - radius, 0); yy <= min(y + radius, h - 1); ++yy) {
            if (!((float)yy < vh)) break;
            const uint8_t* row = plane + (long long)yy * w;
            for (int xx = max(x - radius, 0); xx <= min(x + radius, w - 1); ++xx) {
                if (!((float)xx < vw)) break;
                acc = dilate ? max(acc, (int)row[xx]) : min(acc, (int)row[xx]);
            }
        }
        out[p] = (uint8_t)acc;
    }
}

int blocks_for(long long total, int threads) {
    const long long want = (total + threads - 1) / threads;
    return (int)(want < 132 * 16 ? want : 132 * 16);
}

}  // namespace

// Launch K8 on `stream`: `img` u8 [batch, h, w, 3]; `in_true` f32
// [batch, 2] (valid h, w); `thresholds` f32 [batch]; `out` u8 [batch, h, w]
// (0/1, the cleaned mask); `scratch` u8 [batch, h, w]; `prob_out` f32
// [batch, h, w] or null. Five launches: the mask, then erode, dilate,
// dilate, erode (radius 2). Returns the first nonzero cudaGetLastError().
extern "C" int flyimg_face_masks(const uint8_t* img, const float* in_true, const float* thresholds,
                                 uint8_t* out, uint8_t* scratch, float* prob_out, int batch, int h,
                                 int w, float inv07, float inv05, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (batch <= 0 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
    const int threads = 256;
    const long long total = (long long)batch * h * w;
    const int blocks = blocks_for(total, threads);
    skin_mask_kernel<<<blocks, threads, 0, s>>>(img, in_true, thresholds, out, prob_out, batch, h,
                                                w, inv07, inv05);
    int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    // out -> scratch -> out -> scratch -> out
    const int dilate[4] = {0, 1, 1, 0};
    for (int i = 0; i < 4; ++i) {
        const uint8_t* src = (i % 2 == 0) ? out : scratch;
        uint8_t* dst = (i % 2 == 0) ? scratch : out;
        morph_kernel<<<blocks, threads, 0, s>>>(src, dst, in_true, batch, h, w, 2, dilate[i]);
        rc = (int)cudaGetLastError();
        if (rc != 0) return rc;
    }
    return 0;
}
