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
// floor is a whole level after it. The result equals the plain PyTorch
// version bit for bit: this file is built with --fmad=false, and every value
// is computed in the plain version's f32 operation order (luma, skin, merge),
// read from a table the host built with that order (the saturation level,
// models/smartcrop.py k2_table_bytes), or taken from a fast form only where
// it is certain to floor to the same level (k / 255, the skin level).
//
// What bounds it on an H100: the ~7 bytes a pixel are 0.04 ms at the
// flagship, but a pixel done the plain way costs ~200 issued instructions
// (nine IEEE divisions, two square roots, fifteen byte loads, five lumas),
// which is what held the first version at ~0.30 ms. This design cuts the
// instructions:
// - a block owns a tile of output rows by a column chunk of one member; the
//   tile's source bytes (one-pixel halo) are staged once with 16-byte
//   copies at the source's own 16-byte phase;
// - each staged pixel's floored luma is computed once and kept as a byte,
//   four to a word, so a pixel's four neighbours cost three shared loads a
//   group of four pixels;
// - a thread takes four neighbouring pixels (one 12-byte read from shared
//   memory, realigned with funnel shifts) and stores one float4;
// - the divisions by 255 are a product with the rounded reciprocal and one
//   exact correction (three full-rate operations, correctly rounded for
//   every k the kernel divides); the whole saturation level of a (max, min)
//   pair comes from a table in shared memory; the per-pixel luma windows are
//   integer compares;
// - the skin level is needed only where luma >= 51 and a conservative
//   integer pre-test of the skin cosine passes (under 15% of all colours,
//   and whole warps skip it on coherent images); there a fast approximation
//   (two rsqrt, fused operations) gives it wherever it lies clear of a
//   whole level, and the few pixels left go through the plain version's f32
//   arithmetic (two square roots, three IEEE divisions);
// - floors are adds of 2^23 rounded toward zero, not floorf and conversions
//   (which issue at a quarter of the rate).
// Blocks are persistent (the 32 KB table is staged once a block) and
// walk the tiles in order; the next tile's rows are copied with cp.async
// while the current tile is computed. Measured on the H100 (PERF.md §5):
// ~0.16 ms at the flagship, 4x the byte bound, the staging (~0.05 ms) and
// the per-pixel work adding up rather than overlapping.
//
// Contract: in_true holds whole numbers no larger than the bucket (h, w).
// Knock-out builds for flyimg_tpu_torch/k2_breakdown.py: -DK2_CUT_SKIN,
// -DK2_CUT_SKIN_EVAL (the pre-test kept), -DK2_CUT_SAT, -DK2_CUT_STORE,
// -DK2_CUT_COMPUTE, -DK2_CUT_LUMA, -DK2_CUT_TILES (each result is garbage;
// only the time means anything).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K2_THREADS = 512;
constexpr int TABLE_BYTES = 256 * 257 / 2;      // level of (max, min <= max)
static_assert(TABLE_BYTES % 16 == 0, "the table is staged as 16-byte words");

// the reference's constants, rounded to f32 the way its Python scalars are
// (double arithmetic first, then one rounding at the f32 operation)
constexpr float DETAIL_WEIGHT = 0.2f;
constexpr float SKIN_BIAS = 0.01f;
constexpr float SKIN_WEIGHT = 1.8f;
constexpr float SATURATION_BIAS = 0.2f;
constexpr float SATURATION_WEIGHT = 0.3f;
constexpr float SKIN_R = 0.78f, SKIN_G = 0.57f, SKIN_B = 0.44f;
constexpr float SKIN_THRESHOLD = 0.8f;
constexpr float SKIN_SCALE = (float)(255.0 / (1.0 - 0.8));
// round(100 * skin colour), the pre-test's integer dot product
constexpr uint32_t DOT_R = 78, DOT_G = 57, DOT_B = 44;
constexpr float R255 = 1.0f / 255.0f;
// how close to a whole level the fast skin level sends a pixel to the
// exact path (tests/test_torch_saliency.py: a model of the approximation
// with both rsqrt results 2 ulp off stays within a third of it over the
// RGB cube)
constexpr float SKIN_LEVEL_MARGIN = 1.0f / 256.0f;

__device__ __forceinline__ uint32_t byte_at(uint32_t word, int k) {
    return __byte_perm(word, 0u, 0x4440u | (uint32_t)k);
}

// byte k (0..11) of the 12-byte run (a, b, c)
__device__ __forceinline__ uint32_t run_byte(uint32_t a, uint32_t b, uint32_t c, int k) {
    const uint32_t word = k < 4 ? a : (k < 8 ? b : c);
    return byte_at(word, k & 3);
}

// exact f32 of a whole number below 2^23: 2^23 + v, less 2^23
__device__ __forceinline__ float byte_f32(uint32_t v) {
    return __uint_as_float(0x4B000000u | v) - 8388608.0f;
}

__device__ __forceinline__ float clip255(float v) { return fminf(fmaxf(v, 0.0f), 255.0f); }

// the count of whole indices i with (float)i < t, within [0, n]
__device__ __forceinline__ int valid_extent(float t, int n) {
    if (!(t > 0.0f)) return 0;
    if (t >= (float)n) return n;
    return (int)ceilf(t);
}

// the index i with (float)i == t - 1, or -1
__device__ __forceinline__ int last_index(float t, int n) {
    const float l = t - 1.0f;
    return (l >= 0.0f && l < (float)n && l == floorf(l)) ? (int)l : -1;
}

// 12 bytes at byte position pos of shared memory, any alignment
__device__ __forceinline__ void read12(const uint32_t* s32, int pos, uint32_t& a, uint32_t& b,
                                       uint32_t& c) {
    const uint32_t* p = s32 + (pos >> 2);
    const uint32_t sh = (uint32_t)(pos & 3) * 8u;
    const uint32_t w0 = p[0], w1 = p[1], w2 = p[2], w3 = p[3];
    a = __funnelshift_r(w0, w1, sh);
    b = __funnelshift_r(w1, w2, sh);
    c = __funnelshift_r(w2, w3, sh);
}

// floor(v) + 2^23 for 0 <= v < 2^23: the add rounded toward zero keeps the
// whole part (a full-rate add, where floorf and a conversion are not)
__device__ __forceinline__ float floor_biased(float v) { return __fadd_rz(v, 8388608.0f); }

__device__ __forceinline__ uint32_t luma_of(uint32_t a, uint32_t b, uint32_t c, int j) {
    const float r = byte_f32(run_byte(a, b, c, 3 * j));
    const float g = byte_f32(run_byte(a, b, c, 3 * j + 1));
    const float bl = byte_f32(run_byte(a, b, c, 3 * j + 2));
    return __float_as_uint(floor_biased(0.2126f * r + 0.7152f * g + 0.0722f * bl)) & 0xFFu;
}

__device__ __forceinline__ int skin_level(uint32_t ir, uint32_t ig, uint32_t ib) {
    const float r = byte_f32(ir), g = byte_f32(ig), bl = byte_f32(ib);
    // luma >= 51 here, so the magnitude is never below 1e-6 (the plain
    // version's dark branch cannot be taken)
    const float mag = sqrtf(r * r + g * g + bl * bl);
    const float rd = r / mag - SKIN_R;
    const float gd = g / mag - SKIN_G;
    const float bd = bl / mag - SKIN_B;
    const float skin = 1.0f - sqrtf(rd * rd + gd * gd + bd * bd);
    return skin > SKIN_THRESHOLD ? (int)floorf(clip255((skin - SKIN_THRESHOLD) * SKIN_SCALE)) : 0;
}

// the skin level from a fast approximation, or -1 where it is not
// certain: u = rgb rsqrt(|rgb|^2), the level (0.2 - |u - s|) * 1275 with
// |u - s| = d2 rsqrt(d2), two rsqrt and fused operations. The value is
// within a small fraction of a level of the exact f32 one (|u - s| >= |s| -
// 1 > 0.06 keeps the distance conditioned), so one more than
// SKIN_LEVEL_MARGIN from every whole level floors to the exact level.
// chip_smoke.py holds this over every colour of the RGB cube.
__device__ __forceinline__ int skin_level_fast(uint32_t ir, uint32_t ig, uint32_t ib,
                                               uint32_t mag2) {
    const float inv = rsqrtf(byte_f32(mag2));
    const float rd = __fmaf_rn(byte_f32(ir), inv, -SKIN_R);
    const float gd = __fmaf_rn(byte_f32(ig), inv, -SKIN_G);
    const float bd = __fmaf_rn(byte_f32(ib), inv, -SKIN_B);
    const float d2 = __fmaf_rn(rd, rd, __fmaf_rn(gd, gd, __fmul_rn(bd, bd)));
    const float lv = __fmaf_rn(__fmul_rn(d2, rsqrtf(d2)), -SKIN_SCALE,
                               (1.0f - SKIN_THRESHOLD) * SKIN_SCALE);
    if (lv < 1.0f - SKIN_LEVEL_MARGIN) return 0;
    if (lv > 255.0f + SKIN_LEVEL_MARGIN) return 255;
    const float whole = floor_biased(lv);
    const float frac = lv - (whole - 8388608.0f);
    return (frac > SKIN_LEVEL_MARGIN && frac < 1.0f - SKIN_LEVEL_MARGIN)
               ? (int)(__float_as_uint(whole) & 0xFFu)
               : -1;
}

// k / 255 correctly rounded, for whole k in 0..510: the product with the
// rounded reciprocal, corrected once by its exact residual
// (tests/test_torch_saliency.py holds this against the plain division for
// every k)
__device__ __forceinline__ float quot255(int k) {
    const float kf = byte_f32((uint32_t)k);
    const float p = __fmul_rn(kf, R255);
    return __fmaf_rn(__fmaf_rn(-p, 255.0f, kf), R255, p);
}

// floor(i / d) as a multiply, with m = magic(d) = ceil(2^32 / d): exact for
// 0 <= i, d < 2^16
__device__ __forceinline__ uint64_t magic(uint32_t d) { return ((1ull << 32) + d - 1) / d; }
__device__ __forceinline__ int div_by(int i, uint64_t m) {
    return (int)(((uint64_t)(uint32_t)i * m) >> 32);
}

// whole aligned 16-byte words, device memory to shared, asynchronously
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prior() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// one tile: rows [y0, y0 + rows) x columns [x0, x0 + cols) of member b;
// valid extents vh, vw; staged rows [ys, ye) x columns [xs, xe)
struct Tile {
    int b, y0, x0, rows, cols, vh, vw, ys, ye, xs, xe;
    bool live;  // any of it inside the valid region
};

__device__ __forceinline__ Tile tile_at(int t, const float* in_true, int h, int w, int tile_h,
                                        int chunk_w, int n_ct, int per_member) {
    Tile T;
    T.b = t / per_member;
    const int rem = t - T.b * per_member;
    const int rt = rem / n_ct;
    T.y0 = rt * tile_h;
    T.x0 = (rem - rt * n_ct) * chunk_w;
    T.rows = min(tile_h, h - T.y0);
    T.cols = min(chunk_w, w - T.x0);
    T.vh = valid_extent(in_true[2 * T.b], h);
    T.vw = valid_extent(in_true[2 * T.b + 1], w);
    T.live = T.y0 < T.vh && T.x0 < T.vw;
    T.ys = max(0, T.y0 - 1);
    T.ye = min(T.vh, T.y0 + T.rows + 1);
    T.xs = max(0, T.x0 - 1);
    T.xe = min(T.vw, T.x0 + T.cols + 1);
    return T;
}

__device__ __forceinline__ const uint8_t* row_src(const uint8_t* img, const Tile& T, int y, int h,
                                                  int w) {
    return img + (((size_t)T.b * h + y) * w + T.xs) * 3;
}

// queue the copies of a tile's staged rows, each at its source's 16-byte
// phase (row y at staged row y - y0 + 1). Whole aligned words are copied:
// the few bytes around a row's range lie in the same allocation granule
// and are never read back.
__device__ __forceinline__ void stage_tile(const Tile& T, uint8_t* buf, const uint8_t* img, int h,
                                           int w, int stage_pitch, int lane, int warp) {
    if (!T.live) return;
    const int nbytes = 3 * (T.xe - T.xs);
    for (int y = T.ys + warp; y < T.ye; y += K2_THREADS / 32) {
        const uint8_t* g = row_src(img, T, y, h, w);
        const int shift = (int)((uintptr_t)g & 15);
        const uint8_t* ga = g - shift;
        uint8_t* srow = buf + (y - T.y0 + 1) * stage_pitch;
        const int nch = (shift + nbytes + 15) >> 4;
        for (int k = lane; k < nch; k += 32) cp_async16(srow + 16 * k, ga + 16 * k);
    }
}

__global__ void __launch_bounds__(K2_THREADS)
saliency_kernel(const uint8_t* __restrict__ img, const uint4* __restrict__ tables,
                const float* __restrict__ in_true, float* __restrict__ out, int batch, int h,
                int w, int tile_h, int chunk_w, int stage_pitch, int luma_pitch, int skin_lo,
                int sat_lo, int sat_hi, uint32_t pretest_k) {
    extern __shared__ __align__(16) uint8_t smem[];
    const uint8_t* sat_table = smem;
    const uint32_t* s32 = reinterpret_cast<const uint32_t*>(smem);
    const int srows = tile_h + 2;
    const int stage_bytes = srows * stage_pitch;
    uint8_t* stage = smem + TABLE_BYTES;  // two buffers of stage_bytes
    uint32_t* luma = reinterpret_cast<uint32_t*>(stage + 2 * stage_bytes);
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;

    // the table rides with the first tile's copies
    for (int i = tid; i < TABLE_BYTES / 16; i += K2_THREADS) cp_async16(smem + 16 * i, tables + i);

    const int n_rt = (h + tile_h - 1) / tile_h;
    const int n_ct = (w + chunk_w - 1) / chunk_w;
    const int per_member = n_rt * n_ct;
    const int n_tiles = batch * per_member;
    const size_t pitch = (size_t)w * 3;
#ifdef K2_CUT_TILES
    if (n_tiles >= 0) return;
#endif
    int t = blockIdx.x;
    if (t < n_tiles) {
        stage_tile(tile_at(t, in_true, h, w, tile_h, chunk_w, n_ct, per_member), stage, img, h,
                   w, stage_pitch, lane, warp);
    }
    cp_async_commit();
    for (int it = 0; t < n_tiles; t += gridDim.x, ++it) {
        const Tile T = tile_at(t, in_true, h, w, tile_h, chunk_w, n_ct, per_member);
        uint8_t* buf = stage + (it & 1) * stage_bytes;
        // the next tile's copies fly while this one is computed
        if (t + (int)gridDim.x < n_tiles) {
            stage_tile(tile_at(t + gridDim.x, in_true, h, w, tile_h, chunk_w, n_ct, per_member),
                       stage + ((it + 1) & 1) * stage_bytes, img, h, w, stage_pitch, lane, warp);
        }
        cp_async_commit();
        cp_async_wait_prior();
        __syncthreads();

        const int ngroups = (T.cols + 3) >> 2;
        const int buf_pos = (int)(buf - smem);
        const uint8_t* src0 = row_src(img, T, 0, h, w);
        // floored lumas, four pixels a word; word gw holds columns
        // x0 + 4 (gw - 1) .. + 3; rows and groups not staged read 0
        const int lwords = ngroups + 2;
#ifndef K2_CUT_LUMA
        if (T.live) {
            const uint64_t m_lwords = magic(lwords);
            for (int i = tid; i < srows * lwords; i += K2_THREADS) {
                const int sr = div_by(i, m_lwords), gw = i - sr * lwords;
                const int y = T.y0 + sr - 1, xg = T.x0 + 4 * (gw - 1);
                uint32_t word = 0;
                if (y >= T.ys && y < T.ye && xg + 3 >= T.xs && xg < T.xe) {
                    const int shift = (int)((uintptr_t)(src0 + (size_t)y * pitch) & 15);
                    uint32_t a, bb, c;
                    read12(s32, buf_pos + sr * stage_pitch + shift + 3 * (xg - T.xs), a, bb, c);
                    word = luma_of(a, bb, c, 0) | (luma_of(a, bb, c, 1) << 8)
                           | (luma_of(a, bb, c, 2) << 16) | (luma_of(a, bb, c, 3) << 24);
                }
                luma[sr * luma_pitch + gw] = word;
            }
        }
#endif
        __syncthreads();

        const float th = in_true[2 * T.b], tw = in_true[2 * T.b + 1];
        const int ylast = last_index(th, h), xlast = last_index(tw, w);
        float* out_b = out + (size_t)T.b * h * w;
        const int total = T.rows * ngroups;
        const uint64_t m_groups = magic(ngroups);
        for (int i = tid; i < total; i += K2_THREADS) {
            const int ro = div_by(i, m_groups), gi = i - ro * ngroups;
            const int y = T.y0 + ro, x = T.x0 + 4 * gi;
            const int n = min(4, T.cols - 4 * gi);
            float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#ifndef K2_CUT_COMPUTE
            if (T.live && y < T.vh && x < T.vw) {
                const int sr = ro + 1;
                const uint32_t* lrow = luma + sr * luma_pitch + gi;
                const uint32_t lc = lrow[1], ll = lrow[0], lr = lrow[2];
                const uint32_t lu = lrow[1 - luma_pitch], ld = lrow[1 + luma_pitch];
                const int shift = (int)((uintptr_t)(src0 + (size_t)y * pitch) & 15);
                uint32_t a, bb, c;
                read12(s32, buf_pos + sr * stage_pitch + shift + 3 * (x - T.xs), a, bb, c);
                const bool row_border = y == 0 || y == ylast;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int xx = x + j;
                    if (xx >= T.vw) break;
                    const int cie = (int)byte_at(lc, j);
                    // edge: 3x3 Laplacian + 1, clamped; whole numbers, so
                    // integer arithmetic is exact
                    int edge = cie;
                    if (!(row_border || xx == 0 || xx == xlast)) {
                        const int left = (int)(j == 0 ? byte_at(ll, 3) : byte_at(lc, j - 1));
                        const int right = (int)(j == 3 ? byte_at(lr, 0) : byte_at(lc, j + 1));
                        const int lap = 4 * cie - (int)byte_at(lu, j) - (int)byte_at(ld, j)
                                        - left - right + 1;
                        edge = min(max(lap, 0), 255);
                    }
                    const uint32_t ir = run_byte(a, bb, c, 3 * j);
                    const uint32_t ig = run_byte(a, bb, c, 3 * j + 1);
                    const uint32_t ib = run_byte(a, bb, c, 3 * j + 2);
                    int skin = 0;
#ifndef K2_CUT_SKIN
                    if (cie >= skin_lo) {
                        const uint32_t dot = DOT_R * ir + DOT_G * ig + DOT_B * ib;
                        const uint32_t mag2 = ir * ir + ig * ig + ib * ib;
                        if (dot * dot > pretest_k * mag2) {
#ifdef K2_CUT_SKIN_EVAL
                            skin = (int)(dot & 1u);
#else
                            skin = skin_level_fast(ir, ig, ib, mag2);
                            if (skin < 0) skin = skin_level(ir, ig, ib);
#endif
                        }
                    }
#endif
                    int sat = 0;
#ifndef K2_CUT_SAT
                    if (cie >= sat_lo && cie <= sat_hi) {
                        const uint32_t mx = max(max(ir, ig), ib), mn = min(min(ir, ig), ib);
                        sat = sat_table[((mx * (mx + 1)) >> 1) + mn];
                    }
#endif
                    // weighted merge (weighted_field), its f32 order
                    const float detail = quot255(edge);
                    const float skin_f = quot255(skin);
                    const float sat_f = quot255(sat);
                    v[j] = detail * DETAIL_WEIGHT + skin_f * (detail + SKIN_BIAS) * SKIN_WEIGHT
                           + sat_f * (detail + SATURATION_BIAS) * SATURATION_WEIGHT;
                }
            }
#endif
            float* o = out_b + (size_t)y * w + x;
#ifdef K2_CUT_STORE
            if (v[0] != -1.0f) continue;
#endif
            if (n == 4 && ((uintptr_t)o & 15) == 0) {
                *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
            } else {
                for (int j = 0; j < n; ++j) o[j] = v[j];
            }
        }
        // this tile's buffer is the one the next sweep's copies go to
        __syncthreads();
    }
}

}  // namespace

// img [batch, h, w, 3] u8, tables TABLE_BYTES (16-byte aligned), in_true
// [batch, 2] f32 (valid h, w), out [batch, h, w] f32; the tile plan from
// models/smartcrop.py k2_plan, the luma thresholds and the skin pre-test
// constant from k2_thresholds. Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a plan the kernel does not take.
extern "C" int flyimg_saliency_field(const uint8_t* img, const void* tables, const float* in_true,
                                     float* out, int batch, int h, int w, int tile_h, int chunk_w,
                                     int stage_pitch, int luma_pitch, int smem_bytes, int blocks,
                                     int skin_lo, int sat_lo, int sat_hi, int pretest_k,
                                     void* stream) {
    const int need_pitch = ((15 + 3 * (chunk_w + 2) + 15) / 16) * 16 + 16;
    if (batch < 1 || h < 1 || w < 1 || tile_h < 1 || chunk_w < 4 || chunk_w % 4 != 0
        || stage_pitch < need_pitch || stage_pitch % 16 != 0 || luma_pitch < chunk_w / 4 + 2
        || blocks < 1 || pretest_k < 0
        || smem_bytes != TABLE_BYTES + (tile_h + 2) * (2 * stage_pitch + 4 * luma_pitch)
        || ((uintptr_t)tables & 15) != 0) {
        return (int)cudaErrorInvalidValue;
    }
    // the shared-memory ceiling is raised once a device, to the largest plan
    // seen (a benign race: two threads may both set it)
    static int smem_set[64] = {0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= 64 || smem_bytes > smem_set[dev]) {
        err = cudaFuncSetAttribute(saliency_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_bytes);
        if (err != cudaSuccess) return (int)err;
        if (dev >= 0 && dev < 64) smem_set[dev] = smem_bytes;
    }
    saliency_kernel<<<blocks, K2_THREADS, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
        img, static_cast<const uint4*>(tables), in_true, out, batch, h, w, tile_h, chunk_w,
        stage_pitch, luma_pitch, skin_lo, sat_lo, sat_hi, (uint32_t)pretest_k);
    return (int)cudaGetLastError();
}
