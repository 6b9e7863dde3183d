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
// there is a whole pixel or the background. The arithmetic is the previous
// K4's (rotate_prev.cu), to the bit.
//
// What bounds it on an H100: bytes (the valid input once, the output once).
// A pixel's four taps are gathers, which the previous K4 took from L1 one
// pixel a thread along a flat index: a warp's 12 scalar loads touched lines
// of ~8 source rows each. Design: a block of 128 threads owns a 32 x 32
// output tile of one member (a 2-D grid of tiles x members, 32-bit index
// math, the member's constants once a block; nine blocks an SM):
//   - warp 0 maps the tile's four corners exactly (double, a corner a lane)
//     and widens the box they span by `margin`, a bound on the f32
//     positions' rounding error (ops/rotate.py k4_plan, whose k4_footprint
//     is this arithmetic's twin): every tap of the tile lies in that box
//     clamped to the valid region, and a tile whose box lies wholly outside
//     the valid region writes background and loads nothing;
//   - the box is copied into shared memory once by cp.async, a warp a row,
//     the row's 16-byte words whole (the box's first float at its offset
//     within its word, kept a row in `rofs`), and the gathers read it there;
//   - with a u8 output none of that: the stores are a quarter of the
//     bytes, and a tile's chain of corner map, copy and waits cost more
//     than the box saved (on an H100, the r_30 crop's u8 store 0.260 ms
//     staged against 0.213 unstaged, the previous K4 0.243; the f32 frame
//     0.940 staged against 0.993). The u8 instance gathers from device
//     memory (through L1) and tests each pixel alone;
//   - a thread computes two neighbouring pixels of four rows and stores
//     each pair straight from registers, streaming, in the widest stores
//     its alignment allows (8-byte f32 or 2-byte u8 stores; a staged
//     output with 16-byte stores read slower).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;  // output tile: TILE x TILE pixels
constexpr int THREADS = 128;
constexpr int PAIRS = TILE / 2;                  // pixel pairs of a tile row
constexpr int RS = THREADS / PAIRS;              // rows a pass of the block covers
constexpr int ROWS_PER = TILE / RS;              // output rows a thread

__device__ __forceinline__ uint8_t to_u8(float a) {
    return (uint8_t)fminf(fmaxf(rintf(a), 0.0f), 255.0f);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// floats of a box row of bw pixels: its 16-byte words from the aligned one
// before it (up to 3 floats of room), 4 mod 8 words so that the rows'
// gathers spread over the banks (ops/rotate.py k4_plan's twin)
__host__ __device__ constexpr int box_pitch(int bw) { return ((3 * bw + 6) & ~3) | 4; }

// a tap from the staged box, or from device memory through the read-only path
template <bool STAGED>
__device__ __forceinline__ float tap(const float* p) {
    if constexpr (STAGED)
        return *p;
    else
        return __ldg(p);
}

constexpr int MAX_BOX_ROWS = 64;  // k4_plan keeps a tile's box to this many rows

// nine blocks an SM: 56 registers, no spills (on an H100, 9 read faster
// than the compiler's own 54-55, 12 spilling and slower)
template <bool U8>
__global__ void __launch_bounds__(THREADS, 9)
rotate_tile(const float* __restrict__ img, const float* __restrict__ geom,
            float* __restrict__ out_f, uint8_t* __restrict__ out_u8, int in_h, int in_w,
            int out_h, int out_w, int tiles_x, float cos_t, float sin_t, float bg0, float bg1,
            float bg2, float margin, int box_cap) {
    extern __shared__ __align__(16) float smem[];
    __shared__ int s_box[5];            // skip, bx0, by0, bw, bh
    __shared__ int rofs[MAX_BOX_ROWS];  // each box row's first float in smem
    const int ty = blockIdx.x / tiles_x, tx = blockIdx.x - ty * tiles_x;
    const int b = blockIdx.y;
    const int xo0 = tx * TILE, yo0 = ty * TILE;
    const int tw_t = min(TILE, out_w - xo0), th_t = min(TILE, out_h - yo0);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const float* g = geom + 4 * b;
    const float th = __ldg(g), tw = __ldg(g + 1);
    const float cy_out = __fsub_rn(__ldg(g + 2), 1.0f) / 2.0f;
    const float cx_out = __fsub_rn(__ldg(g + 3), 1.0f) / 2.0f;
    const float cy_in = __fsub_rn(th, 1.0f) / 2.0f;
    const float cx_in = __fsub_rn(tw, 1.0f) / 2.0f;

    constexpr bool STAGED = !U8;  // the f32 instance gathers from a staged box
    if (STAGED && warp == 0) {
        // the exact positions of the tile's corners, one a lane of lanes
        // 0-3; the map is affine, so every pixel's lies between them, and
        // its f32 rounding within margin
        const int i = lane & 3;
        const double dx = (double)(xo0 + (i & 1) * (tw_t - 1)) - (double)cx_out;
        const double dy = (double)(yo0 + (i >> 1) * (th_t - 1)) - (double)cy_out;
        const double xe = (double)cos_t * dx + (double)sin_t * dy + (double)cx_in;
        const double ye = -(double)sin_t * dx + (double)cos_t * dy + (double)cy_in;
        double xmin = xe, xmax = xe, ymin = ye, ymax = ye;
#pragma unroll
        for (int d = 1; d < 4; d <<= 1) {
            xmin = fmin(xmin, __shfl_xor_sync(0xffffffffu, xmin, d));
            xmax = fmax(xmax, __shfl_xor_sync(0xffffffffu, xmax, d));
            ymin = fmin(ymin, __shfl_xor_sync(0xffffffffu, ymin, d));
            ymax = fmax(ymax, __shfl_xor_sync(0xffffffffu, ymax, d));
        }
        if (lane == 0) {
            const double m = (double)margin;
            const bool skip = xmax < -0.5 - m || xmin > (double)tw - 0.5 + m ||
                              ymax < -0.5 - m || ymin > (double)th - 0.5 + m;
            const double hx = (double)tw - 1.0, hy = (double)th - 1.0;
            const int bx0 = (int)fmin(fmax(floor(xmin - m), 0.0), hx);
            const int bx1 = (int)fmin(fmax(floor(xmax + m) + 1.0, 0.0), hx);
            const int by0 = (int)fmin(fmax(floor(ymin - m), 0.0), hy);
            const int by1 = (int)fmin(fmax(floor(ymax + m) + 1.0, 0.0), hy);
            s_box[0] = skip;
            s_box[1] = bx0;
            s_box[2] = by0;
            s_box[3] = bx1 - bx0 + 1;
            s_box[4] = by1 - by0 + 1;
            // the plan sized the box for any tile at this angle
            if (!skip && (s_box[4] > MAX_BOX_ROWS || s_box[4] * box_pitch(s_box[3]) > box_cap))
                __trap();
        }
    }
    if constexpr (STAGED) __syncthreads();
    const bool skip = STAGED && s_box[0] != 0;
    const int bx0 = STAGED ? s_box[1] : 0, by0 = STAGED ? s_box[2] : 0;
    if (STAGED && !skip) {
        const int bw = s_box[3], bh = s_box[4];
        // a warp a row: the row's 16-byte words, copied whole (those that
        // cross the batch's end float by float); the box's first float at
        // its offset within its word
        const int BP = box_pitch(bw);
        const float* end = img + (size_t)gridDim.y * in_h * in_w * 3;
        for (int r = warp; r < bh; r += THREADS / 32) {
            const float* first = img + (((size_t)b * in_h + by0 + r) * in_w + bx0) * 3;
            const int sh = (int)(((uintptr_t)first >> 2) & 3);
            const float* g0 = first - sh;
            float* drow = smem + r * BP;
            for (int q = lane; q < (sh + 3 * bw + 3) >> 2; q += 32) {
                const float* gw = g0 + 4 * q;
                if (gw + 4 <= end) {
                    cp_async16(drow + 4 * q, gw);
                } else {
                    for (int e = 0; e < 4 && gw + e < end; ++e) cp_async4(drow + 4 * q + e, gw + e);
                }
            }
            if (lane == 0) rofs[r] = r * BP + sh;
        }
        cp_async_wait_all();
    }
    if constexpr (STAGED) __syncthreads();
    // the member's frame, where the unstaged instance gathers
    const float* src = img + (size_t)b * in_h * in_w * 3;

    // a thread: pixel pair k (columns 2k, 2k + 1) of rows rr, rr + RS, ...
    const int k = threadIdx.x % PAIRS, rr = threadIdx.x / PAIRS;
    float v[ROWS_PER][2][3];
    const float hy = __fsub_rn(th, 1.0f), hx = __fsub_rn(tw, 1.0f);
    const float ex = __fsub_rn(tw, 0.5f), ey = __fsub_rn(th, 0.5f);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        const float dx = __fsub_rn((float)(xo0 + 2 * k + e), cx_out);
        const float cdx = __fmul_rn(cos_t, dx), sdx = __fmul_rn(-sin_t, dx);
#pragma unroll
        for (int i = 0; i < ROWS_PER; ++i) {
            const int r = rr + i * RS;
            v[i][e][0] = bg0;
            v[i][e][1] = bg1;
            v[i][e][2] = bg2;
            if (skip || r >= th_t || 2 * k + e >= tw_t) continue;
            const float dy = __fsub_rn((float)(yo0 + r), cy_out);
            const float xs = __fadd_rn(__fadd_rn(cdx, __fmul_rn(sin_t, dy)), cx_in);
            const float ys = __fadd_rn(__fadd_rn(sdx, __fmul_rn(cos_t, dy)), cy_in);
            const bool inside = xs >= -0.5f && xs <= ex && ys >= -0.5f && ys <= ey;
            if (!inside) continue;
            const float x0 = floorf(xs), y0 = floorf(ys);
            const float fx = __fsub_rn(xs, x0), fy = __fsub_rn(ys, y0);
            // clip in f32, then truncate, as the reference's gather does; a
            // staged box holds every clipped tap (k4_plan's margin)
            const int ya = (int)fminf(fmaxf(y0, 0.0f), hy);
            const int yb = (int)fminf(fmaxf(__fadd_rn(y0, 1.0f), 0.0f), hy);
            const float* ra = STAGED ? smem + rofs[ya - by0] : src + (size_t)ya * in_w * 3;
            const float* rb = STAGED ? smem + rofs[yb - by0] : src + (size_t)yb * in_w * 3;
            const int xa = ((int)fminf(fmaxf(x0, 0.0f), hx) - bx0) * 3;
            const int xb = ((int)fminf(fmaxf(__fadd_rn(x0, 1.0f), 0.0f), hx) - bx0) * 3;
            const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                const float top = __fadd_rn(__fmul_rn(tap<STAGED>(ra + xa + c), gx),
                                            __fmul_rn(tap<STAGED>(ra + xb + c), fx));
                const float bot = __fadd_rn(__fmul_rn(tap<STAGED>(rb + xa + c), gx),
                                            __fmul_rn(tap<STAGED>(rb + xb + c), fx));
                v[i][e][c] = __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy));
            }
        }
    }

    // a pair's values straight from registers, streaming (the output is
    // not read again here), in the widest stores its address allows: f32,
    // three 8-byte stores where its first float is 8-byte aligned, else a
    // float, two 8-byte stores and a float; u8, three 2-byte stores where
    // its first byte is 2-byte aligned, else a byte, two 2-byte stores and
    // a byte; a lone last pixel, element by element
    const size_t pix0 = ((size_t)b * out_h + yo0) * out_w + xo0;
#pragma unroll
    for (int i = 0; i < ROWS_PER; ++i) {
        const int r = rr + i * RS;
        if (r >= th_t || 2 * k >= tw_t) continue;
        const size_t at = (pix0 + (size_t)r * out_w + 2 * k) * 3;
        const float* f = &v[i][0][0];
        const bool lone = 2 * k + 1 >= tw_t;
        if constexpr (U8) {
            uint8_t q[6];
#pragma unroll
            for (int e = 0; e < 6; ++e) q[e] = to_u8(f[e]);
            uint8_t* d = out_u8 + at;
            auto pack = [&](int e) { return (unsigned short)(q[e] | (q[e + 1] << 8)); };
            if (lone) {
                __stcs(reinterpret_cast<char*>(d), (char)q[0]);
                __stcs(reinterpret_cast<char*>(d + 1), (char)q[1]);
                __stcs(reinterpret_cast<char*>(d + 2), (char)q[2]);
            } else if (((uintptr_t)d & 1) == 0) {
                __stcs(reinterpret_cast<unsigned short*>(d), pack(0));
                __stcs(reinterpret_cast<unsigned short*>(d + 2), pack(2));
                __stcs(reinterpret_cast<unsigned short*>(d + 4), pack(4));
            } else {
                __stcs(reinterpret_cast<char*>(d), (char)q[0]);
                __stcs(reinterpret_cast<unsigned short*>(d + 1), pack(1));
                __stcs(reinterpret_cast<unsigned short*>(d + 3), pack(3));
                __stcs(reinterpret_cast<char*>(d + 5), (char)q[5]);
            }
        } else {
            float* d = out_f + at;
            if (lone) {
                __stcs(d, f[0]);
                __stcs(d + 1, f[1]);
                __stcs(d + 2, f[2]);
            } else if (((uintptr_t)d & 7) == 0) {
                __stcs(reinterpret_cast<float2*>(d), make_float2(f[0], f[1]));
                __stcs(reinterpret_cast<float2*>(d + 2), make_float2(f[2], f[3]));
                __stcs(reinterpret_cast<float2*>(d + 4), make_float2(f[4], f[5]));
            } else {
                __stcs(d, f[0]);
                __stcs(reinterpret_cast<float2*>(d + 1), make_float2(f[1], f[2]));
                __stcs(reinterpret_cast<float2*>(d + 3), make_float2(f[3], f[4]));
                __stcs(d + 5, f[5]);
            }
        }
    }
}

}  // namespace

// Launch K4 on `stream`. img is f32 [batch, in_h, in_w, 3]; geom f32
// [batch, 4] = (valid h, valid w, rotated h, rotated w) with the valid region
// inside the frame; exactly one of out_f (f32) and out_u8 (u8)
// [batch, out_h, out_w, 3] is non-null. margin and box_cap (floats of
// shared memory for a tile's source box) come from ops/rotate.py k4_plan.
// Returns cudaGetLastError().
extern "C" int flyimg_rotate(const float* img, const float* geom, float* out_f,
                             uint8_t* out_u8, int batch, int in_h, int in_w, int out_h,
                             int out_w, float cos_t, float sin_t, float bg0, float bg1,
                             float bg2, float margin, int box_cap, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (batch <= 0 || batch > 65535 || in_h <= 0 || in_w <= 0 || out_h <= 0 || out_w <= 0 ||
        box_cap <= 0 || (out_f == nullptr) == (out_u8 == nullptr))
        return (int)cudaErrorInvalidValue;
    const bool u8 = out_u8 != nullptr;
    const size_t smem = u8 ? 0 : (size_t)box_cap * sizeof(float);  // the u8 instance stages none
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    auto kern = u8 ? rotate_tile<true> : rotate_tile<false>;
    if (smem > 48 * 1024) {
        cudaError_t err =
            cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const int tiles_x = (out_w + TILE - 1) / TILE, tiles_y = (out_h + TILE - 1) / TILE;
    kern<<<dim3(tiles_x * tiles_y, batch), THREADS, smem, s>>>(
        img, geom, out_f, out_u8, in_h, in_w, out_h, out_w, tiles_x, cos_t, sin_t, bg0, bg1, bg2,
        margin, box_cap);
    return (int)cudaGetLastError();
}
