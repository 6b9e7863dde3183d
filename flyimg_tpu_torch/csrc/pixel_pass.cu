// K6: one fused pixel pass over an f32 batch: extent-pad placement on a
// background canvas -> grayscale -> ordered monochrome dither -> optional
// round/clip/u8 store.
//
// Replaces the JAX package's flyimg_tpu/ops/pad.py extent_pad and
// flyimg_tpu/ops/color.py to_grayscale / monochrome_dither (and, when this
// pass is the program's last stage, the round/clip/u8 epilogue of
// flyimg_tpu/ops/compose.py make_program_fn), which XLA fuses on the TPU.
//
// Semantics, per output pixel (y, x) of member b:
//   - pad: the canvas pixel shows source pixel (y - off_y, x - off_x) where
//     that lies in the source frame, else the background (negative offsets
//     crop at the canvas edge; no overlap gives an all-background canvas);
//     with no pad the canvas is the frame (offsets 0);
//   - grayscale: every channel becomes fma(b, w2, fma(g, w1, r * w0)) in
//     f32 — the JAX package's tensordot as XLA's CPU dot computes it (each
//     fused multiply-add rounds once; nothing else is contracted: built with
//     --fmad=false);
//   - dither: the Rec.709 luma of the (possibly gray) pixel is compared with
//     (bayer[y & 7][x & 7] + 0.5f) * 3.984375f (255/64, exact in f32) by
//     `>`: 255 above, 0 otherwise. The threshold is a knife-edge: an ulp of
//     the luma flips a pixel by 255 levels, which is why the luma follows the
//     reference's arithmetic to the bit.
//
// What bounds it on an H100: bytes. It reads 12 bytes and writes 12 (f32)
// or 3 (u8) a pixel and does ~10 flops, far below the card's 20 flops a
// byte. Design: one thread per output pixel in a grid-stride loop, three
// consecutive floats a thread (a warp touches 384 contiguous bytes), the
// Bayer matrix in constant memory. Nothing is staged: every input byte is
// read at most once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__constant__ float kBayer8[64] = {
    0, 32, 8, 40, 2, 34, 10, 42,  48, 16, 56, 24, 50, 18, 58, 26,
    12, 44, 4, 36, 14, 46, 6, 38, 60, 28, 52, 20, 62, 30, 54, 22,
    3, 35, 11, 43, 1, 33, 9, 41,  51, 19, 59, 27, 49, 17, 57, 25,
    15, 47, 7, 39, 13, 45, 5, 37, 63, 31, 55, 23, 61, 29, 53, 21,
};

// Rec.709 luma weights, the dither's (flyimg_tpu/ops/color.py LUMA_WEIGHTS)
constexpr float kL0 = 0.212656f, kL1 = 0.715158f, kL2 = 0.072186f;

__device__ __forceinline__ float luma(float r, float g, float b, float w0, float w1,
                                      float w2) {
    return __fmaf_rn(b, w2, __fmaf_rn(g, w1, __fmul_rn(r, w0)));
}

__device__ __forceinline__ uint8_t to_u8(float a) {
    return (uint8_t)fminf(fmaxf(rintf(a), 0.0f), 255.0f);
}

__global__ void pixel_pass_kernel(const float* __restrict__ in, float* __restrict__ out_f,
                                  uint8_t* __restrict__ out_u8, int batch, int in_h, int in_w,
                                  int out_h, int out_w, int off_y, int off_x, float bg0,
                                  float bg1, float bg2, int gray, float gw0, float gw1,
                                  float gw2, int dither) {
    const long long total = (long long)batch * out_h * out_w;
    for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < total;
         p += (long long)gridDim.x * blockDim.x) {
        const int x = (int)(p % out_w);
        const long long r = p / out_w;
        const int y = (int)(r % out_h);
        const long long b = r / out_h;
        const int sy = y - off_y, sx = x - off_x;
        float v0 = bg0, v1 = bg1, v2 = bg2;
        if (sy >= 0 && sy < in_h && sx >= 0 && sx < in_w) {
            const float* s = in + ((b * in_h + sy) * in_w + sx) * 3;
            v0 = s[0];
            v1 = s[1];
            v2 = s[2];
        }
        if (gray) {
            const float l = luma(v0, v1, v2, gw0, gw1, gw2);
            v0 = v1 = v2 = l;
        }
        if (dither) {
            const float l = luma(v0, v1, v2, kL0, kL1, kL2);
            const float thr = __fmul_rn(__fadd_rn(kBayer8[(y & 7) * 8 + (x & 7)], 0.5f), 3.984375f);
            v0 = v1 = v2 = l > thr ? 255.0f : 0.0f;
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

// Launch K6 on `stream`. `in` is f32 [batch, in_h, in_w, 3]; exactly one of
// out_f (f32) and out_u8 (u8) [batch, out_h, out_w, 3] is non-null. With no
// pad, out_h/out_w equal in_h/in_w and the offsets are 0. Returns
// cudaGetLastError() after the launch.
extern "C" int flyimg_pixel_pass(const float* in, float* out_f, uint8_t* out_u8, int batch,
                                 int in_h, int in_w, int out_h, int out_w, int off_y, int off_x,
                                 float bg0, float bg1, float bg2, int gray, float gw0,
                                 float gw1, float gw2, int dither, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (batch <= 0 || in_h <= 0 || in_w <= 0 || out_h <= 0 || out_w <= 0 ||
        (out_f == nullptr) == (out_u8 == nullptr))
        return (int)cudaErrorInvalidValue;
    const int threads = 256;
    const long long total = (long long)batch * out_h * out_w;
    // enough blocks for a few waves on 132 SMs; the loop strides the rest
    const long long want = (total + threads - 1) / threads;
    const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
    pixel_pass_kernel<<<blocks, threads, 0, s>>>(in, out_f, out_u8, batch, in_h, in_w, out_h,
                                                 out_w, off_y, off_x, bg0, bg1, bg2, gray, gw0,
                                                 gw1, gw2, dither);
    return (int)cudaGetLastError();
}
