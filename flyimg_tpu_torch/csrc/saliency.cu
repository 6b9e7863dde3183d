// K2: the smart-crop saliency field of a bucket-padded u8 batch, in one pass.
//
// Replaces the JAX package's flyimg_tpu/models/smartcrop.py
// _analyse_features_valid + weighted_field, batched by _batched_weighted
// (XLA-fused on the TPU; the same work its removed Pallas _saliency_kernel
// did). Per pixel of the member's valid region: floored Rec.709 luma, the
// 3x3 Laplacian edge map (the valid region's 1px border left unfiltered),
// skin distance on the unit colour sphere, saturation, each map thresholded
// and floored to an integer in [0, 255] exactly like the reference's uint8
// round trip, then the weighted merge; zero outside the valid region.
//
// Exactness: the maps are floored integers, so a one-ulp difference before a
// floor is a whole level after it. This file is built with --fmad=false (no
// multiply-add contraction), uses IEEE division and sqrtf, and keeps the
// reference's operation order, so it reproduces the plain PyTorch version
// bit for bit.
//
// What bounds it on an H100: memory. Each pixel reads 3 bytes and writes one
// f32 (7 bytes); the ~60 flops a pixel are far under the f32 rate. One thread
// per pixel, rows along x so loads and stores coalesce; the Laplacian reads
// its four neighbours' bytes again (L1 hits) instead of staging a halo tile,
// which at 7 bytes a pixel costs nothing the memory system notices.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the reference's constants, rounded to f32 the way its Python scalars are
// (double arithmetic first, then one rounding at the f32 operation)
constexpr float DETAIL_WEIGHT = 0.2f;
constexpr float SKIN_BIAS = 0.01f;
constexpr float SKIN_WEIGHT = 1.8f;
constexpr float SATURATION_BIAS = 0.2f;
constexpr float SATURATION_WEIGHT = 0.3f;
constexpr float SKIN_R = 0.78f, SKIN_G = 0.57f, SKIN_B = 0.44f;
constexpr float SKIN_THRESHOLD = 0.8f;
constexpr float SKIN_LO = (float)(0.2 * 255.0);
constexpr float SKIN_HI = (float)(1.0 * 255.0);
constexpr float SKIN_SCALE = (float)(255.0 / (1.0 - 0.8));
constexpr float SAT_THRESHOLD = 0.4f;
constexpr float SAT_LO = (float)(0.05 * 255.0);
constexpr float SAT_HI = (float)(0.9 * 255.0);
constexpr float SAT_SCALE = (float)(255.0 / (1.0 - 0.4));

__device__ __forceinline__ float luma(const uint8_t* p) {
    float r = (float)p[0], g = (float)p[1], b = (float)p[2];
    return floorf(0.2126f * r + 0.7152f * g + 0.0722f * b);
}

__device__ __forceinline__ float clip255(float v) { return fminf(fmaxf(v, 0.0f), 255.0f); }

__global__ void saliency_kernel(const uint8_t* __restrict__ img, const float* __restrict__ in_true,
                                float* __restrict__ out, int h, int w) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y;
    const int b = blockIdx.z;
    if (x >= w) return;
    const float th = in_true[2 * b];
    const float tw = in_true[2 * b + 1];
    const size_t o = ((size_t)b * h + y) * w + x;
    if (!((float)y < th && (float)x < tw)) {
        out[o] = 0.0f;
        return;
    }
    const size_t pitch = (size_t)w * 3;
    const uint8_t* p = img + ((size_t)b * h + y) * pitch + (size_t)x * 3;
    const float r = (float)p[0], g = (float)p[1], bl = (float)p[2];
    const float cie = luma(p);

    // edge: 3x3 Laplacian + 1, clamped; the valid region's border keeps luma
    float edge;
    const bool border = y == 0 || (float)y == th - 1.0f || x == 0 || (float)x == tw - 1.0f;
    if (border) {
        edge = cie;
    } else {
        float lap = 4.0f * cie - luma(p - pitch) - luma(p + pitch) - luma(p - 3) - luma(p + 3);
        edge = floorf(clip255(lap + 1.0f));
    }

    // skin
    const float mag = sqrtf(r * r + g * g + bl * bl);
    const bool dark = mag < 1e-6f;
    const float safe = dark ? 1.0f : mag;
    const float rd = dark ? -SKIN_R : r / safe - SKIN_R;
    const float gd = dark ? -SKIN_G : g / safe - SKIN_G;
    const float bd = dark ? -SKIN_B : bl / safe - SKIN_B;
    const float skin = 1.0f - sqrtf(rd * rd + gd * gd + bd * bd);
    const bool skin_mask = skin > SKIN_THRESHOLD && cie >= SKIN_LO && cie <= SKIN_HI;
    const float skin_out = floorf(clip255(skin_mask ? (skin - SKIN_THRESHOLD) * SKIN_SCALE : 0.0f));

    // saturation
    const float mx = fmaxf(fmaxf(r, g), bl);
    const float mn = fminf(fminf(r, g), bl);
    const bool eq = mx == mn;
    float ssum = (mx + mn) / 255.0f;
    float d = (mx - mn) / 255.0f;
    d = eq ? 0.0f : d;
    ssum = eq ? 1.0f : ssum;
    ssum = ssum > 1.0f ? 2.0f - d : ssum;
    const float sat = d / ssum;
    const bool sat_mask = sat > SAT_THRESHOLD && cie >= SAT_LO && cie <= SAT_HI;
    const float sat_out = floorf(clip255(sat_mask ? (sat - SAT_THRESHOLD) * SAT_SCALE : 0.0f));

    // weighted merge (weighted_field)
    const float skin_f = skin_out / 255.0f;
    const float detail = edge / 255.0f;
    const float sat_f = sat_out / 255.0f;
    out[o] = detail * DETAIL_WEIGHT + skin_f * (detail + SKIN_BIAS) * SKIN_WEIGHT
             + sat_f * (detail + SATURATION_BIAS) * SATURATION_WEIGHT;
}

}  // namespace

// img [batch, h, w, 3] u8, in_true [batch, 2] f32 (valid h, w), out [batch, h, w]
// f32. Returns cudaGetLastError() after the launch.
extern "C" int flyimg_saliency_field(const uint8_t* img, const float* in_true, float* out,
                                     int batch, int h, int w, void* stream) {
    const int threads = 128;
    dim3 grid((w + threads - 1) / threads, h, batch);
    saliency_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(img, in_true, out, h, w);
    return (int)cudaGetLastError();
}
