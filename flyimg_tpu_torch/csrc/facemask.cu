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
// What bounds it on an H100: bytes — 3 bytes read and 1 written a pixel —
// against ~30 flops a pixel (two IEEE divisions and an expf among them).
// In practice the instructions an SM issues: each pixel's bytes, gates and
// bounds, and the chroma for every pixel of a warp that has a gated one.
// Design (host side: facefind.py k8_plan): ONE launch of 1,024-thread
// blocks, a block a 2-D output tile (`tile_rows` rows by a whole row, or
// by `tile_cols` columns past 2048) plus an 8-pixel halo (4 passes x
// radius 2) in y, and in x where a row is cut; the rows are the fewest
// whose blocks fit one an SM. The mask lives in shared memory a bit a
// pixel, 32 pixels to a word. A lane takes 8 neighbouring pixels: their
// 24 bytes (six 4-byte loads where the rows allow), the gates of 4 pixels
// at once on bytes (byte permutes to planar r, g, b; byte compares;
// 10 r > 9 g in 16-bit lanes, which is r > f32(g * 0.9f) for bytes), and
// the divisions and exp under a branch the whole warp takes only where one
// of its lanes' pixels passes the gates; 4 lanes' bits are OR-ed into a
// word by shuffles. Each 5x5 pass is a 5-tap row pass (funnel shifts of a
// word and its neighbours, AND for erode, OR for dilate) then a 5-tap
// column pass (five words of one column), exact because the valid region
// is a rectangle anchored at (0, 0): a clipped 5x5 window is the product
// of two clipped 5-tap windows. Before an erode the pixels outside the
// valid region (or the image) hold 1, the identity; before a dilate they
// hold 0, and every pass ends `& valid`. Each pass trusts 2 fewer halo
// pixels; the tile's core is exact after four. Only the core is stored, a
// byte a pixel (4 at a time); the probability map (for the check against
// the plain version) is written in the same launch when asked. Pixels
// outside the valid region skip the probability unless it is asked.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHalo = 8;  // 4 passes x radius 2
constexpr int kThreads = 1024;  // a block's
constexpr int kWarps = kThreads / 32;

// the chromaticity Gaussian, where the gates pass
__device__ __forceinline__ float skin_chroma(float r, float g, float b, float inv07, float inv05) {
    const float total = __fadd_rn(__fadd_rn(__fadd_rn(r, g), b), 1e-6f);
    const float rn = __fdiv_rn(r, total);
    const float gn = __fdiv_rn(g, total);
    const float a = __fmul_rn(__fsub_rn(rn, 0.44f), inv07);
    const float c = __fmul_rn(__fsub_rn(gn, 0.31f), inv05);
    const float d2 = __fmaf_rn(a, a, __fmul_rn(c, c));
    return expf(__fmul_rn(-0.5f, d2));
}

// rows (or columns) i in [0, size) with (float)i < v: min(size, ceil(v))
__device__ __forceinline__ int valid_count(float v, int size) {
    if (!(v > 0.0f)) return 0;
    if (v >= (float)size) return size;
    return (int)ceilf(v);
}

// bits [lo, hi) of a word, clipped to [0, 32)
__device__ __forceinline__ uint32_t bit_span(int lo, int hi) {
    lo = max(lo, 0);
    hi = min(hi, 32);
    if (hi <= lo) return 0u;
    const uint32_t below_hi = hi == 32 ? ~0u : ((1u << hi) - 1u);
    return below_hi & ~((1u << lo) - 1u);
}

struct MaskArgs {
    const uint8_t* img;
    const float* in_true;
    const float* thresholds;
    uint8_t* out;
    float* prob_out;
    int h, w;
    int tile_rows, words, tile_cols, halo_x, tiles_y, tiles_x;
    int vec;  // rows of the image and the output read and written 4 bytes at a time
    float inv07, inv05;
};

// byte k of `w` as an exact float: the byte in the mantissa of 2^23, less
// 2^23 (a byte permute and an add, no integer-to-float conversion)
__device__ __forceinline__ float byte_float(uint32_t w, int k) {
    return __fsub_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u | (unsigned)k)),
                     8388608.0f);
}

// bits j of 8 with lo <= x + j < hi
__device__ __forceinline__ uint32_t span8(int x, int lo, int hi) {
    const int a = min(max(lo - x, 0), 8), b = min(max(hi - x, 0), 8);
    return ((1u << b) - 1u) & ~((1u << a) - 1u);
}

// The gates of 4 pixels from their 12 bytes in three words, a bit each
// (bit j for pixel j), and the pixels' planar r, g, b bytes: r > 60,
// r > b, |r - g| > 10 and r > f32(g * 0.9f), which for integers r, g is
// 10 r > 9 g (exactly: no product of a byte and 0.9f rounds across an
// integer), on bytes and 16-bit lanes, 4 pixels at once.
__device__ __forceinline__ uint32_t gate_bits4(uint32_t w0, uint32_t w1, uint32_t w2,
                                               uint32_t& r4, uint32_t& g4, uint32_t& b4) {
    r4 = __byte_perm(__byte_perm(w0, w1, 0x0630u), w2, 0x5210u);
    g4 = __byte_perm(__byte_perm(w0, w1, 0x0741u), w2, 0x6210u);
    b4 = __byte_perm(__byte_perm(w0, w1, 0x0052u), w2, 0x7410u);
    const uint32_t r_even = r4 & 0x00ff00ffu, r_odd = (r4 >> 8) & 0x00ff00ffu;
    const uint32_t g_even = g4 & 0x00ff00ffu, g_odd = (g4 >> 8) & 0x00ff00ffu;
    const uint32_t tint = (__vcmpgtu2(r_even * 10u, g_even * 9u) & 0x00ff00ffu) |
                          ((__vcmpgtu2(r_odd * 10u, g_odd * 9u) & 0x00ff00ffu) << 8);
    const uint32_t gates = __vcmpgtu4(r4, 0x3c3c3c3cu) & __vcmpgtu4(r4, b4) &
                           __vcmpgtu4(__vabsdiffu4(r4, g4), 0x0a0a0a0au) & tint;
    return ((gates & 0x01010101u) * 0x01020408u) >> 24;
}

// 4 mask bits -> 4 bytes of 0/1, bit j to byte j
__device__ __forceinline__ uint32_t nibble_bytes(uint32_t n) {
    return (n * 0x00204081u) & 0x01010101u;
}

// One block a (member, tile row, tile column). Shared memory: the window's
// mask words `m` and the row passes' words `rp`, (tile_rows + 16) x words
// each. Window row r is image row y0 - 8 + r; window bit i of word k is
// image column x0 - halo_x + 32 k + i.
__global__ void __launch_bounds__(kThreads) face_mask_kernel(const MaskArgs a) {
    extern __shared__ uint32_t smem[];
    const int rows = a.tile_rows + 2 * kHalo, nw = a.words;
    uint32_t* m = smem;
    uint32_t* rp = smem + rows * nw;
    int t = blockIdx.x;
    const int tx = t % a.tiles_x;
    t /= a.tiles_x;
    const int ty = t % a.tiles_y;
    const int b = t / a.tiles_y;
    const int y0 = ty * a.tile_rows, x0 = tx * a.tile_cols;
    const int ys = y0 - kHalo, xs = x0 - a.halo_x;
    const int vh = valid_count(a.in_true[2 * b], a.h);
    const int vw = valid_count(a.in_true[2 * b + 1], a.w);
    const float thr = __ldg(a.thresholds + b);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // the core, in window coordinates
    const int core_r0 = kHalo, core_r1 = kHalo + min(a.tile_rows, a.h - y0);
    const int core_c0 = a.halo_x, core_c1 = a.halo_x + min(a.tile_cols, a.w - x0);
    const uint8_t* img = a.img + (size_t)b * a.h * a.w * 3;
    const uint32_t zero_passes = 0.0f > thr ? ~0u : 0u;  // a gated-out pixel's 0 > thr

    // the thresholded mask: a lane 8 pixels, 4 lanes a word, a warp 8
    // words of the window in row-major order (each lane's word stepped
    // along without a division); the lanes' 8-bit groups OR-ed into words
    {
        const int cells = rows * nw, sub = lane & 3, step = kWarps * 8;
        const int step_r = step / nw, step_k = step - step_r * nw;
        int cell = warp * 8 + (lane >> 2);
        int r = cell / nw, k = cell - r * nw;
        for (int c0 = warp * 8; c0 < cells; c0 += step) {
            const bool in = cell < cells;
            const int y = ys + r, xw = 32 * k + 8 * sub, x = xs + xw;
            const bool row_valid = in && y >= 0 && y < vh;
            const bool row_core = in && a.prob_out != nullptr && r >= core_r0 && r < core_r1;
            const uint32_t valid8 = row_valid ? span8(x, 0, vw) : 0u;
            const uint32_t core8 = row_core ? span8(xw, core_c0, core_c1) : 0u;
            const long long p0 = (long long)y * a.w + x;
            uint32_t rgb[6] = {0u, 0u, 0u, 0u, 0u, 0u};
            if ((valid8 | core8) != 0u) {
                if (a.vec && x >= 0 && x + 8 <= a.w) {
                    const uint32_t* s = reinterpret_cast<const uint32_t*>(img + 3 * p0);
#pragma unroll
                    for (int q = 0; q < 6; ++q) rgb[q] = s[q];
                } else {
#pragma unroll
                    for (int q = 0; q < 24; ++q)
                        if (x + q / 3 >= 0 && x + q / 3 < a.w)
                            rgb[q / 4] |= (uint32_t)img[3 * p0 + q] << (8 * (q % 4));
                }
            }
            // planar r, g, b of each 4 pixels and their gates
            uint32_t r4[2], g4[2], b4[2], gate8 = 0u;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                gate8 |= gate_bits4(rgb[3 * h], rgb[3 * h + 1], rgb[3 * h + 2], r4[h], g4[h], b4[h])
                         << (4 * h);
            }
            gate8 &= valid8 | core8;
            uint32_t bits = zero_passes & valid8 & ~gate8;
            // the divisions and the exp only where some lane's gates pass
            // (a branch the whole warp takes or skips)
            if (__any_sync(0xffffffffu, gate8 != 0u)) {
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    const float chroma =
                        skin_chroma(byte_float(r4[j / 4], j % 4), byte_float(g4[j / 4], j % 4),
                                    byte_float(b4[j / 4], j % 4), a.inv07, a.inv05);
                    if ((gate8 >> j & 1u) && chroma > thr) bits |= valid8 & (1u << j);
                    if (core8 >> j & 1u)
                        a.prob_out[(long long)b * a.h * a.w + p0 + j] =
                            (gate8 >> j & 1u) ? chroma : 0.0f;
                }
            } else if (core8 != 0u) {
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    if (core8 >> j & 1u) a.prob_out[(long long)b * a.h * a.w + p0 + j] = 0.0f;
            }
            uint32_t word = bits << (8 * sub);
            word |= __shfl_xor_sync(0xffffffffu, word, 1);
            word |= __shfl_xor_sync(0xffffffffu, word, 2);
            if (sub == 0 && in) m[cell] = word;
            cell += step;
            k += step_k;
            r += step_r;
            if (k >= nw) {
                k -= nw;
                ++r;
            }
        }
    }
    __syncthreads();

    // erode, dilate, dilate, erode: a row pass, then a column pass; a
    // thread keeps one column k of rows r0, r0 + rstep, ... and that
    // column's (and its neighbours') valid bits
    const int kc = threadIdx.x % nw, r0 = threadIdx.x / nw, rstep = kThreads / nw;
    const int xk = xs + 32 * kc;
    const uint32_t vcol = bit_span(-xk, vw - xk);
    const uint32_t vleft = kc > 0 ? bit_span(32 - xk, vw - xk + 32) : 0u;
    const uint32_t vright = kc + 1 < nw ? bit_span(-xk - 32, vw - xk - 32) : 0u;
    for (int pass = 0; pass < 4; ++pass) {
        const bool dilate = pass == 1 || pass == 2;
        const uint32_t ident = dilate ? 0u : ~0u;
        for (int r = r0; r < rows && r0 < rstep; r += rstep) {
            const int y = ys + r;
            const bool row_ok = y >= 0 && y < vh;
            const uint32_t* row = m + r * nw;
            // an erode's input: the pixels outside the valid region (or
            // past the window) hold 1; m is 0 there, so a dilate's is m
            uint32_t c = row[kc];
            uint32_t l = kc > 0 ? row[kc - 1] : ident;
            uint32_t rr = kc + 1 < nw ? row[kc + 1] : ident;
            if (!dilate) {
                c |= row_ok ? ~vcol : ~0u;
                l |= row_ok ? ~vleft : ~0u;
                rr |= row_ok ? ~vright : ~0u;
            }
            const uint32_t r1 = __funnelshift_r(c, rr, 1), r2 = __funnelshift_r(c, rr, 2);
            const uint32_t l1 = __funnelshift_l(l, c, 1), l2 = __funnelshift_l(l, c, 2);
            rp[r * nw + kc] = dilate ? (c | r1 | r2 | l1 | l2) : (c & r1 & r2 & l1 & l2);
        }
        __syncthreads();
        for (int r = r0; r < rows && r0 < rstep; r += rstep) {
            const int y = ys + r;
            uint32_t acc = rp[r * nw + kc];
#pragma unroll
            for (int d = -2; d <= 2; ++d) {
                if (d == 0) continue;
                const uint32_t v = (r + d >= 0 && r + d < rows) ? rp[(r + d) * nw + kc] : ident;
                acc = dilate ? (acc | v) : (acc & v);
            }
            m[r * nw + kc] = (y >= 0 && y < vh) ? (acc & vcol) : 0u;
        }
        __syncthreads();
    }

    // the core, a byte a pixel: a lane 4 pixels (one 4-byte store where the
    // rows allow), a warp 128 of one core row
    uint8_t* out = a.out + (size_t)b * a.h * a.w;
    const int chunks = (nw + 3) / 4;  // 128-pixel chunks of a core row
    for (int item = warp; item < (core_r1 - core_r0) * chunks; item += kWarps) {
        const int rc = item / chunks, ch = item - rc * chunks;
        const int xw = 128 * ch + 4 * lane, k = 4 * ch + (lane >> 3);
        if (k >= nw || xw >= core_c1 || xw + 4 <= core_c0) continue;
        const uint32_t bytes = nibble_bytes((m[(rc + kHalo) * nw + k] >> (4 * (lane & 7))) & 0xfu);
        uint8_t* o = out + (long long)(y0 + rc) * a.w + xs + xw;
        if (a.vec && xw >= core_c0 && xw + 4 <= core_c1) {
            *reinterpret_cast<uint32_t*>(o) = bytes;
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
                if (xw + j >= core_c0 && xw + j < core_c1) o[j] = (uint8_t)(bytes >> (8 * j));
        }
    }
}

}  // namespace

// Launch K8 on `stream`: `img` u8 [batch, h, w, 3]; `in_true` f32
// [batch, 2] (valid h, w); `thresholds` f32 [batch]; `out` u8 [batch, h, w]
// (0/1, the cleaned mask); `prob_out` f32 [batch, h, w] or null. The plan
// (facefind.py k8_plan): tiles of `tile_rows` x `tile_cols` pixels,
// `tiles_y` x `tiles_x` of them a member, each staged as (tile_rows + 16)
// rows of `words` 32-pixel words starting `halo_x` columns left of the
// tile. One launch. Returns cudaGetLastError().
extern "C" int flyimg_face_masks(const uint8_t* img, const float* in_true, const float* thresholds,
                                 uint8_t* out, float* prob_out, int batch, int h, int w,
                                 int tile_rows, int words, int tile_cols, int halo_x, int tiles_y,
                                 int tiles_x, float inv07, float inv05, void* stream) {
    if (batch <= 0 || h <= 0 || w <= 0 || tile_rows <= 0 || tile_cols <= 0 || words <= 0 ||
        (halo_x != 0 && halo_x != kHalo) || tile_cols + 2 * halo_x > 32 * words ||
        (long long)tiles_y * tile_rows < h || (long long)tiles_x * tile_cols < w ||
        (halo_x == 0 && tiles_x != 1) || words > kThreads ||
        (long long)batch * tiles_y * tiles_x >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    const long long smem = 2LL * (tile_rows + 2 * kHalo) * words * 4;
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    // 4-byte loads of the pixels' bytes and 4-byte stores of 4 pixels'
    // masks: every row, and every 4-pixel group of a window, starts on a
    // 4-byte boundary
    const int vec = w % 4 == 0 && tile_cols % 4 == 0 && halo_x % 4 == 0 &&
                    ((uintptr_t)img | (uintptr_t)out) % 4 == 0;
    const MaskArgs a{img, in_true, thresholds, out, prob_out, h, w, tile_rows, words, tile_cols,
                     halo_x, tiles_y, tiles_x, vec, inv07, inv05};
    face_mask_kernel<<<batch * tiles_y * tiles_x, kThreads, (size_t)smem,
                       static_cast<cudaStream_t>(stream)>>>(a);
    return (int)cudaGetLastError();
}
