// K15: one step of the ring rotate. A rank adds, into its f32 accumulator of
// output rows, the bilinear taps that the tile visiting it this step owns;
// on the ring's last step it also applies the inside test and the
// background fill, and stores f32 (in place) or u8 (round, clip).
//
// Replaces the per-device step of the JAX package's
// flyimg_tpu/parallel/tiling.py _build_ring_rotate (:395-470): the
// inverse-affine sample positions of the rank's output rows (:398-421),
// tap_rows for both y-taps of the visiting tile (:423-441) added into acc,
// and the inside test with the background after the last visit (:461-465),
// which XLA fuses on the TPU between the ppermutes of the ring.
//
// Per output pixel (yo, xo) of the rank's tile, yo = row0 + local row:
//   dx = xo - cx_out, dy = yo - cy_out,
//   xs = cos * dx + sin * dy + cx_in,  ys = -sin * dx + cos * dy + cy_in,
//   fx = xs - floor(xs), fy = ys - floor(ys) (the unclamped floors),
//   the taps floor + {0, 1} clamped to [0, th - 1] x [0, tw - 1] (th, tw the
//   TRUE input height and width), so each tap row is owned by exactly one
//   tile [src0, src0 + tile_h);
//   for the tap row y0c (weight 1 - fy) and then y1c (weight fy), where the
//   visiting tile owns it: acc += (v(x0c) * (1 - fx) + v(x1c) * fx) * weight.
// Every product and sum rounds in the reference's written order (built with
// --fmad=false): xs and ys decide the floor and the inside test. A tap that
// another tile owns adds an exact 0.0 in the reference, so the sum over the
// ring does not depend on which step owns which tap, and equals the untiled
// rotate's (K4, flyimg_tpu/ops/rotate.py as written). The jitted reference
// program is not bit-reproducible this way: XLA on the CPU fuses some of
// these products and sums into multiply-adds, and which ones changes with
// the mesh size and angle (measured), so an ulp of xs or ys separates them.
//
// What bounds it on an H100: bytes. A step reads the rank's accumulator and
// writes it back wherever this tile owns a tap (12 + 12 bytes a pixel), and
// the owned taps of the visiting tile (from cache: neighbouring pixels share
// source rows); ~40 flops a pixel. Design: one thread per output pixel,
// consecutive threads on consecutive output columns; a pixel whose taps the
// visiting tile does not own returns after the map without touching acc.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint8_t to_u8(float a) {
    return (uint8_t)fminf(fmaxf(rintf(a), 0.0f), 255.0f);
}

__global__ void ring_step_kernel(const float* __restrict__ visit, int src0, int tile_h,
                                 int in_w, float* __restrict__ acc, uint8_t* __restrict__ out_u8,
                                 int row0, int out_h, int out_w, float cos_t, float sin_t,
                                 float cy_out, float cx_out, float cy_in, float cx_in, float th,
                                 float tw, int last, float bg0, float bg1, float bg2) {
    const long long total = (long long)out_h * out_w;
    for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < total;
         p += (long long)gridDim.x * blockDim.x) {
        const int xo = (int)(p % out_w);
        const int yo = row0 + (int)(p / out_w);
        const float dx = __fsub_rn((float)xo, cx_out);
        const float dy = __fsub_rn((float)yo, cy_out);
        const float xs = __fadd_rn(__fadd_rn(__fmul_rn(cos_t, dx), __fmul_rn(sin_t, dy)), cx_in);
        const float ys = __fadd_rn(__fadd_rn(__fmul_rn(-sin_t, dx), __fmul_rn(cos_t, dy)), cy_in);
        const float x0 = floorf(xs), y0 = floorf(ys);
        const float fx = __fsub_rn(xs, x0), fy = __fsub_rn(ys, y0);
        const float hy = __fsub_rn(th, 1.0f), hx = __fsub_rn(tw, 1.0f);
        // clip in f32, then truncate, as the reference does
        const int la = (int)fminf(fmaxf(y0, 0.0f), hy) - src0;
        const int lb = (int)fminf(fmaxf(__fadd_rn(y0, 1.0f), 0.0f), hy) - src0;
        const bool own_a = la >= 0 && la < tile_h, own_b = lb >= 0 && lb < tile_h;
        if (!own_a && !own_b && !last) continue;
        float* a = acc + p * 3;
        float v[3] = {a[0], a[1], a[2]};
        if (own_a || own_b) {
            const int xa = (int)fminf(fmaxf(x0, 0.0f), hx);
            const int xb = (int)fminf(fmaxf(__fadd_rn(x0, 1.0f), 0.0f), hx);
            const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
            if (own_a) {
                const float* r = visit + (long long)la * in_w * 3;
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    const float val = __fadd_rn(__fmul_rn(__ldg(r + xa * 3 + c), gx),
                                                __fmul_rn(__ldg(r + xb * 3 + c), fx));
                    v[c] = __fadd_rn(v[c], __fmul_rn(val, gy));
                }
            }
            if (own_b) {
                const float* r = visit + (long long)lb * in_w * 3;
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    const float val = __fadd_rn(__fmul_rn(__ldg(r + xa * 3 + c), gx),
                                                __fmul_rn(__ldg(r + xb * 3 + c), fx));
                    v[c] = __fadd_rn(v[c], __fmul_rn(val, fy));
                }
            }
        }
        if (last) {
            const bool inside = xs >= -0.5f && xs <= __fsub_rn(tw, 0.5f) && ys >= -0.5f &&
                                ys <= __fsub_rn(th, 0.5f);
            if (!inside) {
                v[0] = bg0;
                v[1] = bg1;
                v[2] = bg2;
            }
            if (out_u8) {
                uint8_t* d = out_u8 + p * 3;
                d[0] = to_u8(v[0]);
                d[1] = to_u8(v[1]);
                d[2] = to_u8(v[2]);
                continue;
            }
        }
        a[0] = v[0];
        a[1] = v[1];
        a[2] = v[2];
    }
}

}  // namespace

// Launch K15 on `stream`. visit is the visiting tile, f32 [tile_h, in_w, 3],
// whose first row is global source row src0; acc is the rank's f32
// [out_h, out_w, 3] accumulator of global output rows [row0, row0 + out_h),
// updated in place. cos_t, sin_t are the host's f32 roundings; cy_out,
// cx_out, cy_in, cx_in the centres; th, tw the true input height and width.
// With last != 0 the inside test and background (bg0-2) are applied and the
// result stored to out_u8 (u8 [out_h, out_w, 3]) when it is non-null, else
// to acc. Returns cudaGetLastError().
extern "C" int flyimg_ring_rotate_step(const float* visit, int src0, int tile_h, int in_w,
                                       float* acc, uint8_t* out_u8, int row0, int out_h,
                                       int out_w, float cos_t, float sin_t, float cy_out,
                                       float cx_out, float cy_in, float cx_in, float th,
                                       float tw, int last, float bg0, float bg1, float bg2,
                                       void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (tile_h <= 0 || in_w <= 0 || out_h <= 0 || out_w <= 0 || src0 < 0 || row0 < 0 ||
        !(th >= 1.0f) || !(tw >= 1.0f) || (out_u8 != nullptr && !last))
        return (int)cudaErrorInvalidValue;
    const int threads = 256;
    const long long total = (long long)out_h * out_w;
    const long long want = (total + threads - 1) / threads;
    const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
    ring_step_kernel<<<blocks, threads, 0, s>>>(visit, src0, tile_h, in_w, acc, out_u8, row0,
                                                out_h, out_w, cos_t, sin_t, cy_out, cx_out,
                                                cy_in, cx_in, th, tw, last, bg0, bg1, bg2);
    return (int)cudaGetLastError();
}
