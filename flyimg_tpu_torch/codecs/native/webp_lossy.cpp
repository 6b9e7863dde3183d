// Lossy WebP (VP8) encode and decode, and the WebP container, for the
// port's host codec layer.
//
// The machine with the card has no libwebp, so the port carries its own
// codec for the key frames of the VP8 bitstream (RFC 6386, "VP8 Data Format
// and Decoding Guide"; its tables are in vp8_tables.h) and the container of
// the WebP format. It is built into one library with webp_lossless.cpp (the
// VP8L codec), whose entries this file calls for "VP8L" chunks and for the
// alpha plane of an "ALPH" chunk. Plain C interface for ctypes
// (codecs/native_codec.py); buffers are malloc'd here and released with
// fl_free; no global state, so calls may run from many threads at once.
//
// Decoder: key frames as RFC 6386 specifies them (segments, both loop
// filters, sharpness, loop-filter deltas, 1-8 token partitions, quantizer
// deltas, coefficient probability updates, the skip probability). The
// planes go to RGB as libwebp's WebPDecodeRGB(A) takes them: its "fancy"
// 2x chroma upsampler and its 14-bit fixed-point YUV -> RGB. The container:
// a simple "VP8 " or "VP8L" file, or VP8X with ALPH (compression 0 or 1,
// filters none, horizontal, vertical, gradient) before "VP8 ". ICC, EXIF and
// XMP chunks are skipped; an animation is refused with status 2.
//
// Encoder: RGB -> Y'CbCr 4:2:0 in libwebp's fixed point (chroma from 2x2
// sums), the planes padded to whole macroblocks by edge replication; per
// macroblock the 16x16 luma mode (DC, V, H, TM), the ten sub-block modes
// and the chroma mode chosen by distortion + lambda * estimated bits, with
// the reconstruction the decoder makes; the tokens collected, then the
// coefficient probabilities that save bits written as updates and the
// tokens coded with them. One segment; one token partition unless asked
// for more; the normal loop filter (the simple one when asked) at a level
// from the quantizer. The quality -> quantizer map is quality_to_qindex.
// An alpha plane with a value below 255 goes into ALPH as a headerless VP8L
// stream (compression 1, no filter): alpha is lossless.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "vp8_tables.h"
#include "webp_lossless.h"

namespace {

using namespace vp8;

constexpr int BPS = 32;  // the stride of a macroblock's work buffers

inline int clip255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }
inline int clamp_int(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

uint32_t le32(const uint8_t* p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
}
uint32_t le24(const uint8_t* p) { return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16); }

// --------------------------------------------------------- the quantizers

struct Quant {
    int y1[2], y2[2], uv[2];  // [dc, ac] dequantization factors
};

// the factors of quantizer index q and the frame's deltas (section 14.1, as
// libwebp takes them: y2 dc x2, y2 ac x155/100 and at least 8, uv dc at
// most index 117)
Quant make_quant(int q, const int dq[5]) {
    Quant m;
    m.y1[0] = kDcTable[clamp_int(q + dq[0], 0, 127)];
    m.y1[1] = kAcTable[clamp_int(q, 0, 127)];
    m.y2[0] = kDcTable[clamp_int(q + dq[1], 0, 127)] * 2;
    m.y2[1] = (kAcTable[clamp_int(q + dq[2], 0, 127)] * 101581) >> 16;
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[clamp_int(q + dq[3], 0, 117)];
    m.uv[1] = kAcTable[clamp_int(q + dq[4], 0, 127)];
    return m;
}

// ------------------------------------------------------------- transforms

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// the inverse DCT of in[16], added to the 4x4 block at dst (section 14.3)
void idct_add(const int16_t* in, uint8_t* dst) {
    int tmp[16];
    for (int i = 0; i < 4; ++i) {  // vertical pass
        const int a = in[i] + in[8 + i];
        const int b = in[i] - in[8 + i];
        const int c = mul2(in[4 + i]) - mul1(in[12 + i]);
        const int d = mul1(in[4 + i]) + mul2(in[12 + i]);
        tmp[4 * i + 0] = a + d;
        tmp[4 * i + 1] = b + c;
        tmp[4 * i + 2] = b - c;
        tmp[4 * i + 3] = a - d;
    }
    for (int i = 0; i < 4; ++i) {  // horizontal pass
        const int dc = tmp[i] + 4;
        const int a = dc + tmp[8 + i];
        const int b = dc - tmp[8 + i];
        const int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]);
        const int d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
        uint8_t* row = dst + i * BPS;
        row[0] = (uint8_t)clip255(row[0] + ((a + d) >> 3));
        row[1] = (uint8_t)clip255(row[1] + ((b + c) >> 3));
        row[2] = (uint8_t)clip255(row[2] + ((b - c) >> 3));
        row[3] = (uint8_t)clip255(row[3] + ((a - d) >> 3));
    }
}

inline bool any_nonzero(const int16_t* c) {
    for (int i = 0; i < 16; ++i)
        if (c[i]) return true;
    return false;
}

// the inverse Walsh-Hadamard transform of the y2 block: out[16 * k] is
// the dc of luma block k (section 14.3)
void iwht(const int16_t* in, int16_t* out) {
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
        const int a0 = in[0 + i] + in[12 + i];
        const int a1 = in[4 + i] + in[8 + i];
        const int a2 = in[4 + i] - in[8 + i];
        const int a3 = in[0 + i] - in[12 + i];
        tmp[0 + i] = a0 + a1;
        tmp[8 + i] = a0 - a1;
        tmp[4 + i] = a3 + a2;
        tmp[12 + i] = a3 - a2;
    }
    for (int i = 0; i < 4; ++i) {
        const int dc = tmp[0 + i * 4] + 3;
        const int a0 = dc + tmp[3 + i * 4];
        const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
        const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
        const int a3 = dc - tmp[3 + i * 4];
        out[0] = (int16_t)((a0 + a1) >> 3);
        out[16] = (int16_t)((a3 + a2) >> 3);
        out[32] = (int16_t)((a0 - a1) >> 3);
        out[48] = (int16_t)((a3 - a2) >> 3);
        out += 64;
    }
}

// ------------------------------------------------------ intra prediction
//
// Each predictor writes the block at dst (stride BPS) from the samples above
// (dst[-BPS..]), to the left (dst[-1 + k * BPS]) and above-left.

inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2(int a, int b) { return (a + b + 1) >> 1; }

void fill(uint8_t* dst, int size, int v) {
    for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, v, size);
}

void true_motion(uint8_t* dst, int size) {
    const uint8_t* top = dst - BPS;
    const int tl = top[-1];
    for (int y = 0; y < size; ++y) {
        const int left = dst[y * BPS - 1];
        for (int x = 0; x < size; ++x) dst[y * BPS + x] = (uint8_t)clip255(top[x] + left - tl);
    }
}

void vertical(uint8_t* dst, int size) {
    for (int y = 0; y < size; ++y) std::memcpy(dst + y * BPS, dst - BPS, size);
}

void horizontal(uint8_t* dst, int size) {
    for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, dst[y * BPS - 1], size);
}

// DC of a 16x16 (size 16, shift 5) or 8x8 (size 8, shift 4) block; the
// edges of the frame take the other side only, or 128 at its corner
void dc_pred(uint8_t* dst, int size, bool has_top, bool has_left) {
    const int shift = size == 16 ? 5 : 4;
    int sum = 0;
    if (has_top)
        for (int i = 0; i < size; ++i) sum += dst[i - BPS];
    if (has_left)
        for (int i = 0; i < size; ++i) sum += dst[i * BPS - 1];
    int v;
    if (has_top && has_left) v = (sum + size) >> shift;
    else if (has_top || has_left) v = (sum + size / 2) >> (shift - 1);
    else v = 128;
    fill(dst, size, v);
}

// a 16x16 luma or 8x8 chroma prediction of mode DC, TM, V or H
void predict_block(uint8_t* dst, int size, int mode, int mb_x, int mb_y) {
    switch (mode) {
        case DC_PRED: dc_pred(dst, size, mb_y > 0, mb_x > 0); break;
        case TM_PRED: true_motion(dst, size); break;
        case V_PRED: vertical(dst, size); break;
        default: horizontal(dst, size); break;
    }
}

#define DST(x, y) dst[(x) + (y) * BPS]

// a 4x4 sub-block prediction (section 12.3); dst[4..7 - BPS] is above-right
void predict4(uint8_t* dst, int mode) {
    const uint8_t* top = dst - BPS;
    const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
    const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
    const int E = top[4], F = top[5], G = top[6], H = top[7];
    switch (mode) {
        case B_DC: {
            int dc = 4;
            for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
            fill(dst, 4, dc >> 3);
            break;
        }
        case B_TM: true_motion(dst, 4); break;
        case B_VE: {
            const uint8_t v[4] = {(uint8_t)avg3(X, A, B), (uint8_t)avg3(A, B, C),
                                  (uint8_t)avg3(B, C, D), (uint8_t)avg3(C, D, E)};
            for (int y = 0; y < 4; ++y) std::memcpy(dst + y * BPS, v, 4);
            break;
        }
        case B_HE: {
            const int r[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
            for (int y = 0; y < 4; ++y) std::memset(dst + y * BPS, r[y], 4);
            break;
        }
        case B_RD:
            DST(0, 3) = avg3(J, K, L);
            DST(1, 3) = DST(0, 2) = avg3(I, J, K);
            DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
            DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
            DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
            DST(3, 1) = DST(2, 0) = avg3(C, B, A);
            DST(3, 0) = avg3(D, C, B);
            break;
        case B_VR:
            DST(0, 0) = DST(1, 2) = avg2(X, A);
            DST(1, 0) = DST(2, 2) = avg2(A, B);
            DST(2, 0) = DST(3, 2) = avg2(B, C);
            DST(3, 0) = avg2(C, D);
            DST(0, 3) = avg3(K, J, I);
            DST(0, 2) = avg3(J, I, X);
            DST(0, 1) = DST(1, 3) = avg3(I, X, A);
            DST(1, 1) = DST(2, 3) = avg3(X, A, B);
            DST(2, 1) = DST(3, 3) = avg3(A, B, C);
            DST(3, 1) = avg3(B, C, D);
            break;
        case B_LD:
            DST(0, 0) = avg3(A, B, C);
            DST(1, 0) = DST(0, 1) = avg3(B, C, D);
            DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
            DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
            DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
            DST(3, 2) = DST(2, 3) = avg3(F, G, H);
            DST(3, 3) = avg3(G, H, H);
            break;
        case B_VL:
            DST(0, 0) = avg2(A, B);
            DST(1, 0) = DST(0, 2) = avg2(B, C);
            DST(2, 0) = DST(1, 2) = avg2(C, D);
            DST(3, 0) = DST(2, 2) = avg2(D, E);
            DST(0, 1) = avg3(A, B, C);
            DST(1, 1) = DST(0, 3) = avg3(B, C, D);
            DST(2, 1) = DST(1, 3) = avg3(C, D, E);
            DST(3, 1) = DST(2, 3) = avg3(D, E, F);
            DST(3, 2) = avg3(E, F, G);
            DST(3, 3) = avg3(F, G, H);
            break;
        case B_HD:
            DST(0, 0) = DST(2, 1) = avg2(I, X);
            DST(0, 1) = DST(2, 2) = avg2(J, I);
            DST(0, 2) = DST(2, 3) = avg2(K, J);
            DST(0, 3) = avg2(L, K);
            DST(3, 0) = avg3(A, B, C);
            DST(2, 0) = avg3(X, A, B);
            DST(1, 0) = DST(3, 1) = avg3(I, X, A);
            DST(1, 1) = DST(3, 2) = avg3(J, I, X);
            DST(1, 2) = DST(3, 3) = avg3(K, J, I);
            DST(1, 3) = avg3(L, K, J);
            break;
        default:  // B_HU
            DST(0, 0) = avg2(I, J);
            DST(2, 0) = DST(0, 1) = avg2(J, K);
            DST(2, 1) = DST(0, 2) = avg2(K, L);
            DST(1, 0) = avg3(I, J, K);
            DST(3, 0) = DST(1, 1) = avg3(J, K, L);
            DST(3, 1) = DST(1, 2) = avg3(K, L, L);
            DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
            break;
    }
}

#undef DST

// ----------------------------------------------------------------- planes

// the frame's planes, whole macroblocks (mb_w * 16 x mb_h * 16 luma)
struct Planes {
    int mb_w = 0, mb_h = 0;
    std::vector<uint8_t> y, u, v;
    int ys() const { return mb_w * 16; }
    int uvs() const { return mb_w * 8; }
    void resize(int mbw, int mbh) {
        mb_w = mbw, mb_h = mbh;
        y.assign((size_t)mbw * 16 * mbh * 16, 0);
        u.assign((size_t)mbw * 8 * mbh * 8, 0);
        v.assign((size_t)mbw * 8 * mbh * 8, 0);
    }
};

// A macroblock's work buffers: the block with its row above (and the four
// samples above-right of luma) and its column to the left, filled from the
// planes' unfiltered reconstruction as libwebp fills them: 127 above the
// frame, 129 left of it (the above-left sample of the first column below
// the first row too). The above-right samples of a sub-block in column 3
// are those above-right of the macroblock, for every row of sub-blocks.
struct Work {
    uint8_t ybuf[BPS * 17], ubuf[BPS * 9], vbuf[BPS * 9];
    uint8_t* y() { return ybuf + BPS + 8; }
    uint8_t* u() { return ubuf + BPS + 8; }
    uint8_t* v() { return vbuf + BPS + 8; }

    void load(const Planes& p, int mb_x, int mb_y) {
        load_plane(y(), p.y.data(), p.ys(), 16, mb_x, mb_y, p.mb_w);
        load_plane(u(), p.u.data(), p.uvs(), 8, mb_x, mb_y, p.mb_w);
        load_plane(v(), p.v.data(), p.uvs(), 8, mb_x, mb_y, p.mb_w);
    }

    static void load_plane(uint8_t* dst, const uint8_t* plane, int stride, int size, int mb_x,
                           int mb_y, int mb_w) {
        const int x0 = mb_x * size, y0 = mb_y * size;
        uint8_t* top = dst - BPS;
        const int right = size == 16 ? 4 : 0;
        if (mb_y == 0) {
            std::memset(top - 1, 127, size + 1 + right);
        } else {
            const uint8_t* above = plane + (size_t)(y0 - 1) * stride + x0;
            std::memcpy(top, above, size);
            top[-1] = mb_x > 0 ? above[-1] : 129;
            if (right) {
                if (mb_x < mb_w - 1) std::memcpy(top + 16, above + 16, 4);
                else std::memset(top + 16, above[15], 4);
            }
        }
        for (int j = 0; j < size; ++j)
            dst[j * BPS - 1] = mb_x > 0 ? plane[(size_t)(y0 + j) * stride + x0 - 1] : 129;
        if (right)
            for (int r = 3; r < 15; r += 4) std::memcpy(dst + r * BPS + 16, top + 16, 4);
    }

    // the macroblock alone (no edges), as the encoder's source
    void load_block(const Planes& p, int mb_x, int mb_y) {
        for (int j = 0; j < 16; ++j)
            std::memcpy(y() + j * BPS, p.y.data() + (size_t)(mb_y * 16 + j) * p.ys() + mb_x * 16, 16);
        for (int j = 0; j < 8; ++j) {
            const size_t o = (size_t)(mb_y * 8 + j) * p.uvs() + mb_x * 8;
            std::memcpy(u() + j * BPS, p.u.data() + o, 8);
            std::memcpy(v() + j * BPS, p.v.data() + o, 8);
        }
    }

    void store(Planes& p, int mb_x, int mb_y) const {
        store_plane(ybuf + BPS + 8, p.y.data(), p.ys(), 16, mb_x, mb_y);
        store_plane(ubuf + BPS + 8, p.u.data(), p.uvs(), 8, mb_x, mb_y);
        store_plane(vbuf + BPS + 8, p.v.data(), p.uvs(), 8, mb_x, mb_y);
    }

    static void store_plane(const uint8_t* src, uint8_t* plane, int stride, int size, int mb_x,
                            int mb_y) {
        for (int j = 0; j < size; ++j)
            std::memcpy(plane + (size_t)(mb_y * size + j) * stride + mb_x * size, src + j * BPS,
                        size);
    }
};

// the position of luma sub-block n (raster order) in the work buffer
inline int scan4(int n) { return (n & 3) * 4 + (n >> 2) * 4 * BPS; }
// ... and of chroma block n of one plane (raster order, 2x2)
inline int scan_uv(int n) { return (n & 1) * 4 + (n >> 1) * 4 * BPS; }

// --------------------------------------------------------- the loop filter

inline int sclip1(int v) { return v < -128 ? -128 : (v > 127 ? 127 : v); }  // [-1020,1020]
inline int sclip2(int v) { return v < -16 ? -16 : (v > 15 ? 15 : v); }      // [-112,112]

inline void do_filter2(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    const int a1 = sclip2((a + 4) >> 3);
    const int a2 = sclip2((a + 3) >> 3);
    p[-step] = (uint8_t)clip255(p0 + a2);
    p[0] = (uint8_t)clip255(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0);
    const int a1 = sclip2((a + 4) >> 3);
    const int a2 = sclip2((a + 3) >> 3);
    const int a3 = (a1 + 1) >> 1;
    p[-2 * step] = (uint8_t)clip255(p1 + a3);
    p[-step] = (uint8_t)clip255(p0 + a2);
    p[0] = (uint8_t)clip255(q0 - a1);
    p[step] = (uint8_t)clip255(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
    const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
    const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    const int a1 = (27 * a + 63) >> 7;
    const int a2 = (18 * a + 63) >> 7;
    const int a3 = (9 * a + 63) >> 7;
    p[-3 * step] = (uint8_t)clip255(p2 + a3);
    p[-2 * step] = (uint8_t)clip255(p1 + a2);
    p[-step] = (uint8_t)clip255(p0 + a1);
    p[0] = (uint8_t)clip255(q0 - a1);
    p[step] = (uint8_t)clip255(q1 - a2);
    p[2 * step] = (uint8_t)clip255(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
    const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
    const int p0 = p[-step], q0 = p[0];
    const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
    if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
    return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
           std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// the simple filter across one edge of `size` samples: `step` crosses
// the edge, `along` walks it
void simple_edge(uint8_t* p, int step, int along, int size, int thresh) {
    const int t2 = 2 * thresh + 1;
    for (int i = 0; i < size; ++i, p += along)
        if (needs_filter(p, step, t2)) do_filter2(p, step);
}

// the normal filter across one edge: a macroblock edge (6 taps) or an
// inner edge (4 taps)
void normal_edge(uint8_t* p, int step, int along, int size, int thresh, int ithresh,
                 int hev_thresh, bool mb_edge) {
    const int t2 = 2 * thresh + 1;
    for (int i = 0; i < size; ++i, p += along) {
        if (!needs_filter2(p, step, t2, ithresh)) continue;
        if (hev(p, step, hev_thresh)) do_filter2(p, step);
        else if (mb_edge) do_filter6(p, step);
        else do_filter4(p, step);
    }
}

struct FilterInfo {
    int limit = 0;   // 2 * level + interior limit; 0: no filtering
    int ilevel = 0;  // the interior limit
    int hev_thresh = 0;
    bool inner = false;
};

// a filter level and the frame's sharpness -> the macroblock's thresholds
FilterInfo filter_info(int level, int sharpness) {
    FilterInfo f;
    level = clamp_int(level, 0, 63);
    if (level == 0) return f;
    int ilevel = level;
    if (sharpness > 0) {
        ilevel >>= sharpness > 4 ? 2 : 1;
        if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
    }
    if (ilevel < 1) ilevel = 1;
    f.ilevel = ilevel;
    f.limit = 2 * level + ilevel;
    f.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
    return f;
}

// filter one macroblock in place: its left edge, inner vertical edges, top
// edge, inner horizontal edges (section 15)
void filter_mb(Planes& p, int mb_x, int mb_y, const FilterInfo& f, bool simple) {
    if (f.limit == 0) return;
    const int ys = p.ys(), uvs = p.uvs();
    uint8_t* y = p.y.data() + (size_t)mb_y * 16 * ys + mb_x * 16;
    if (simple) {
        if (mb_x > 0) simple_edge(y, 1, ys, 16, f.limit + 4);
        if (f.inner)
            for (int k = 4; k < 16; k += 4) simple_edge(y + k, 1, ys, 16, f.limit);
        if (mb_y > 0) simple_edge(y, ys, 1, 16, f.limit + 4);
        if (f.inner)
            for (int k = 4; k < 16; k += 4) simple_edge(y + k * ys, ys, 1, 16, f.limit);
        return;
    }
    uint8_t* u = p.u.data() + (size_t)mb_y * 8 * uvs + mb_x * 8;
    uint8_t* v = p.v.data() + (size_t)mb_y * 8 * uvs + mb_x * 8;
    const int lim = f.limit, il = f.ilevel, hv = f.hev_thresh;
    if (mb_x > 0) {
        normal_edge(y, 1, ys, 16, lim + 4, il, hv, true);
        normal_edge(u, 1, uvs, 8, lim + 4, il, hv, true);
        normal_edge(v, 1, uvs, 8, lim + 4, il, hv, true);
    }
    if (f.inner) {
        for (int k = 4; k < 16; k += 4) normal_edge(y + k, 1, ys, 16, lim, il, hv, false);
        normal_edge(u + 4, 1, uvs, 8, lim, il, hv, false);
        normal_edge(v + 4, 1, uvs, 8, lim, il, hv, false);
    }
    if (mb_y > 0) {
        normal_edge(y, ys, 1, 16, lim + 4, il, hv, true);
        normal_edge(u, uvs, 1, 8, lim + 4, il, hv, true);
        normal_edge(v, uvs, 1, 8, lim + 4, il, hv, true);
    }
    if (f.inner) {
        for (int k = 4; k < 16; k += 4) normal_edge(y + k * ys, ys, 1, 16, lim, il, hv, false);
        normal_edge(u + 4 * uvs, uvs, 1, 8, lim, il, hv, false);
        normal_edge(v + 4 * uvs, uvs, 1, 8, lim, il, hv, false);
    }
}

// ----------------------------------------------------------- YUV -> RGB
//
// libwebp's 14-bit fixed point (its VP8YUVToR/G/B) and its "fancy"
// upsampler: each output pixel's chroma is (9 * nearest + 3 * horizontal +
// 3 * vertical + diagonal) / 16 of the four nearest chroma samples, rounded
// in libwebp's order; the first row, and the last of an even height, take
// one chroma row.

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t clip8(int v) {
    return (uint8_t)(((v & ~16383) == 0) ? (v >> 6) : (v < 0) ? 0 : 255);
}
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
    rgb[0] = clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
    rgb[1] = clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
    rgb[2] = clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

inline uint32_t load_uv(int u, int v) { return (uint32_t)u | ((uint32_t)v << 16); }

// one or two output rows (bottom_y null: one) of len pixels from the chroma
// rows above (top_u/v) and below (cur_u/v) them
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u,
                   const uint8_t* top_v, const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len, int xstep) {
    const int last_pair = (len - 1) >> 1;
    uint32_t tl_uv = load_uv(top_u[0], top_v[0]);
    uint32_t l_uv = load_uv(cur_u[0], cur_v[0]);
    {
        const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
        yuv_to_rgb(top_y[0], uv0 & 0xff, uv0 >> 16, top_dst);
    }
    if (bottom_y) {
        const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
        yuv_to_rgb(bottom_y[0], uv0 & 0xff, uv0 >> 16, bottom_dst);
    }
    for (int x = 1; x <= last_pair; ++x) {
        const uint32_t t_uv = load_uv(top_u[x], top_v[x]);
        const uint32_t uv = load_uv(cur_u[x], cur_v[x]);
        const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
        const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
        const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
        {
            const uint32_t uv0 = (diag_12 + tl_uv) >> 1;
            const uint32_t uv1 = (diag_03 + t_uv) >> 1;
            yuv_to_rgb(top_y[2 * x - 1], uv0 & 0xff, uv0 >> 16, top_dst + (2 * x - 1) * xstep);
            yuv_to_rgb(top_y[2 * x], uv1 & 0xff, uv1 >> 16, top_dst + (2 * x) * xstep);
        }
        if (bottom_y) {
            const uint32_t uv0 = (diag_03 + l_uv) >> 1;
            const uint32_t uv1 = (diag_12 + uv) >> 1;
            yuv_to_rgb(bottom_y[2 * x - 1], uv0 & 0xff, uv0 >> 16,
                       bottom_dst + (2 * x - 1) * xstep);
            yuv_to_rgb(bottom_y[2 * x], uv1 & 0xff, uv1 >> 16, bottom_dst + (2 * x) * xstep);
        }
        tl_uv = t_uv;
        l_uv = uv;
    }
    if (!(len & 1)) {
        {
            const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
            yuv_to_rgb(top_y[len - 1], uv0 & 0xff, uv0 >> 16, top_dst + (len - 1) * xstep);
        }
        if (bottom_y) {
            const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
            yuv_to_rgb(bottom_y[len - 1], uv0 & 0xff, uv0 >> 16, bottom_dst + (len - 1) * xstep);
        }
    }
}

// the w x h visible part of the planes -> interleaved RGB(A) with `nch`
// channels (the alpha bytes are left for the caller)
void planes_to_rgb(const Planes& p, int w, int h, uint8_t* out, int nch) {
    const int ys = p.ys(), uvs = p.uvs();
    const size_t row = (size_t)w * nch;
    const uint8_t* u = p.u.data();
    const uint8_t* v = p.v.data();
    upsample_pair(p.y.data(), nullptr, u, v, u, v, out, nullptr, w, nch);
    int y = 0;
    for (; y + 2 < h; y += 2) {
        const uint8_t* tu = p.u.data() + (size_t)(y / 2) * uvs;
        const uint8_t* tv = p.v.data() + (size_t)(y / 2) * uvs;
        upsample_pair(p.y.data() + (size_t)(y + 1) * ys, p.y.data() + (size_t)(y + 2) * ys, tu,
                      tv, tu + uvs, tv + uvs, out + (y + 1) * row, out + (y + 2) * row, w, nch);
    }
    if (!(h & 1)) {  // the last row of an even height
        const uint8_t* cu = p.u.data() + (size_t)(y / 2) * uvs;
        const uint8_t* cv = p.v.data() + (size_t)(y / 2) * uvs;
        upsample_pair(p.y.data() + (size_t)(h - 1) * ys, nullptr, cu, cv, cu, cv,
                      out + (h - 1) * row, nullptr, w, nch);
    }
}

// ========================================================== the decoder

// the boolean entropy decoder (section 7); past its end it reads zeros.
// `eof` stands for libwebp's end-of-data flag, which fails the frame where
// libwebp checks it (after each row of modes, after each macroblock's
// tokens): set when a bit is read after more shifts than the partition has
// bits (at once for an empty one). Cut files then fail as libwebp fails
// them, but for a cut in the last two or three bytes, which libwebp may
// refuse and this decoder reads (tests/test_torch_webp.py).
struct BoolDecoder {
    const uint8_t* p = nullptr;
    const uint8_t* end = nullptr;
    uint32_t value = 0, range = 255;
    int bit_count = 0;
    int64_t shifts = 0, limit = 0;
    bool eof = false;

    void init(const uint8_t* data, size_t size) {
        p = data, end = data + size, range = 255, bit_count = 0;
        shifts = 0, limit = 8 * (int64_t)size, eof = size == 0;
        value = (uint32_t)next() << 8;
        value |= next();
    }
    uint8_t next() { return p < end ? *p++ : 0; }
    int get(int prob) {
        if (shifts > limit) eof = true;
        const uint32_t split = 1 + (((range - 1) * (uint32_t)prob) >> 8);
        const uint32_t big = split << 8;
        int bit;
        if (value >= big) {
            bit = 1;
            range -= split;
            value -= big;
        } else {
            bit = 0;
            range = split;
        }
        while (range < 128) {
            value <<= 1;
            range <<= 1;
            ++shifts;
            if (++bit_count == 8) {
                bit_count = 0;
                value |= next();
            }
        }
        return bit;
    }
    int flag() { return get(128); }
    int literal(int bits) {
        int v = 0;
        while (bits-- > 0) v = (v << 1) | get(128);
        return v;
    }
    int signed_literal(int bits) {
        const int v = literal(bits);
        return flag() ? -v : v;
    }
};

struct MBInfo {
    uint8_t segment = 0, skip = 0, is_i4 = 0, uv_mode = 0;
    uint8_t modes[16] = {0};  // the 16x16 mode in [0], else the sub-block modes
};

struct FrameHeader {
    int width = 0, height = 0;
    bool use_segment = false, update_map = false, absolute_delta = false;
    int seg_quant[4] = {0}, seg_filter[4] = {0};
    uint8_t seg_proba[3] = {255, 255, 255};
    bool simple = false;
    int level = 0, sharpness = 0;
    bool use_lf_delta = false;
    int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
    int base_q = 0, dq[5] = {0};
    uint8_t proba[kNumTypes][kNumBands][kNumCtx][kNumProbas];
    bool use_skip = false;
    int skip_p = 0;
};

// the coefficients of one block from `first` on (section 13): returns the
// position past the last token that was not EOB
int read_coeffs(BoolDecoder& br, const uint8_t (*prob)[kNumCtx][kNumProbas], int ctx,
                const int dq[2], int n, int16_t* out) {
    const uint8_t* p = prob[kBands[n]][ctx];
    for (; n < 16; ++n) {
        if (!br.get(p[0])) return n;  // EOB
        while (!br.get(p[1])) {       // ZERO
            if (++n == 16) return 16;
            p = prob[kBands[n]][0];
        }
        int v;
        if (!br.get(p[2])) {
            v = 1;
            p = prob[kBands[n + 1]][1];
        } else {
            if (!br.get(p[3])) {
                if (!br.get(p[4])) v = 2;
                else v = 3 + br.get(p[5]);
            } else if (!br.get(p[6])) {
                if (!br.get(p[7])) {
                    v = 5 + br.get(159);
                } else {
                    v = 7 + 2 * br.get(165);
                    v += br.get(145);
                }
            } else {
                const int bit1 = br.get(p[8]);
                const int bit0 = br.get(p[9 + bit1]);
                const int cat = 2 * bit1 + bit0;
                static const uint8_t* const kCats[4] = {kCat3, kCat4, kCat5, kCat6};
                v = 0;
                for (const uint8_t* tab = kCats[cat]; *tab; ++tab) v += v + br.get(*tab);
                v += 3 + (8 << cat);
            }
            p = prob[kBands[n + 1]][2];
        }
        const int s = br.flag() ? -v : v;
        out[kZigzag[n]] = (int16_t)(s * dq[n > 0]);
    }
    return 16;
}

struct Vp8Decoder {
    FrameHeader hdr;
    Planes planes;
    const char* error = nullptr;

    bool fail(const char* what) {
        error = what;
        return false;
    }

    bool decode(const uint8_t* data, size_t size) {
        if (size < 10) return fail("VP8 frame too short");
        const uint32_t bits = le24(data);
        const bool key_frame = !(bits & 1);
        const int profile = (bits >> 1) & 7;
        const bool show = (bits >> 4) & 1;
        const uint32_t part0_size = bits >> 5;
        if (!key_frame || profile > 3 || !show) return fail("not a displayable VP8 key frame");
        if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a)
            return fail("bad VP8 start code");
        hdr.width = (data[6] | (data[7] << 8)) & 0x3fff;
        hdr.height = (data[8] | (data[9] << 8)) & 0x3fff;
        if (hdr.width == 0 || hdr.height == 0) return fail("empty VP8 frame");
        data += 10, size -= 10;
        if (part0_size > size) return fail("VP8 partition 0 truncated");
        BoolDecoder br;
        br.init(data, part0_size);
        br.flag();  // colour space
        br.flag();  // clamping type: libwebp always clamps
        read_segment_header(br);
        read_filter_header(br);
        if (br.eof) return fail("VP8 header truncated");
        const int num_parts = 1 << br.literal(2);
        // the token partitions: their sizes (3 bytes each but the last's)
        const uint8_t* sizes = data + part0_size;
        const size_t rest = size - part0_size;
        if (rest < 3u * (num_parts - 1)) return fail("VP8 partition sizes truncated");
        const uint8_t* part = sizes + 3 * (num_parts - 1);
        const uint8_t* end = data + size;
        std::vector<BoolDecoder> parts(num_parts);
        for (int k = 0; k < num_parts; ++k) {
            size_t psize = k < num_parts - 1 ? le24(sizes + 3 * k) : (size_t)(end - part);
            if (part + psize > end) psize = (size_t)(end - part);
            if (k == num_parts - 1 && part >= end) return fail("VP8 partitions truncated");
            parts[k].init(part, psize);
            part += psize;
        }
        read_quant(br);
        br.flag();  // refresh entropy probs: one frame, nothing to keep
        for (int t = 0; t < kNumTypes; ++t)
            for (int b = 0; b < kNumBands; ++b)
                for (int c = 0; c < kNumCtx; ++c)
                    for (int p = 0; p < kNumProbas; ++p)
                        hdr.proba[t][b][c][p] = br.get(kCoeffsUpdateProba[t][b][c][p])
                                                    ? (uint8_t)br.literal(8)
                                                    : kCoeffsProba0[t][b][c][p];
        hdr.use_skip = br.flag();
        if (hdr.use_skip) hdr.skip_p = br.literal(8);
        return decode_macroblocks(br, parts);
    }

    void read_segment_header(BoolDecoder& br) {
        hdr.use_segment = br.flag();
        if (!hdr.use_segment) return;
        hdr.update_map = br.flag();
        if (br.flag()) {  // update the segments' data
            hdr.absolute_delta = br.flag();
            for (int s = 0; s < 4; ++s) hdr.seg_quant[s] = br.flag() ? br.signed_literal(7) : 0;
            for (int s = 0; s < 4; ++s) hdr.seg_filter[s] = br.flag() ? br.signed_literal(6) : 0;
        }
        if (hdr.update_map)
            for (int s = 0; s < 3; ++s) hdr.seg_proba[s] = br.flag() ? (uint8_t)br.literal(8) : 255;
    }

    void read_filter_header(BoolDecoder& br) {
        hdr.simple = br.flag();
        hdr.level = br.literal(6);
        hdr.sharpness = br.literal(3);
        hdr.use_lf_delta = br.flag();
        if (hdr.use_lf_delta && br.flag()) {  // update the deltas
            for (int i = 0; i < 4; ++i)
                if (br.flag()) hdr.ref_lf_delta[i] = br.signed_literal(6);
            for (int i = 0; i < 4; ++i)
                if (br.flag()) hdr.mode_lf_delta[i] = br.signed_literal(6);
        }
    }

    void read_quant(BoolDecoder& br) {
        hdr.base_q = br.literal(7);
        for (int k = 0; k < 5; ++k) hdr.dq[k] = br.flag() ? br.signed_literal(4) : 0;
    }

    void read_modes(BoolDecoder& br, MBInfo& mb, uint8_t* top, uint8_t* left) {
        if (hdr.update_map)
            mb.segment = !br.get(hdr.seg_proba[0]) ? br.get(hdr.seg_proba[1])
                                                   : br.get(hdr.seg_proba[2]) + 2;
        else
            mb.segment = 0;
        mb.skip = hdr.use_skip ? br.get(hdr.skip_p) : 0;
        mb.is_i4 = !br.get(kYModeIsI4);
        if (!mb.is_i4) {
            const int ymode = br.get(kYModeProba[0]) ? (br.get(kYModeProba[2]) ? TM_PRED : H_PRED)
                                                     : (br.get(kYModeProba[1]) ? V_PRED : DC_PRED);
            mb.modes[0] = (uint8_t)ymode;
            std::memset(top, ymode, 4);
            std::memset(left, ymode, 4);
        } else {
            for (int y = 0; y < 4; ++y) {
                int ymode = left[y];
                for (int x = 0; x < 4; ++x) {
                    const uint8_t* prob = kBModesProba[top[x]][ymode];
                    int i = kYModesIntra4[br.get(prob[0])];
                    while (i > 0) i = kYModesIntra4[2 * i + br.get(prob[i])];
                    ymode = -i;
                    top[x] = (uint8_t)ymode;
                    mb.modes[4 * y + x] = (uint8_t)ymode;
                }
                left[y] = (uint8_t)ymode;
            }
        }
        mb.uv_mode = !br.get(kUVModeProba[0])   ? DC_PRED
                     : !br.get(kUVModeProba[1]) ? V_PRED
                     : br.get(kUVModeProba[2])  ? TM_PRED
                                                : H_PRED;
    }

    bool decode_macroblocks(BoolDecoder& br, std::vector<BoolDecoder>& parts) {
        const int mb_w = (hdr.width + 15) >> 4, mb_h = (hdr.height + 15) >> 4;
        planes.resize(mb_w, mb_h);
        Quant quant[4];
        for (int s = 0; s < 4; ++s) {
            int q = hdr.base_q;
            if (hdr.use_segment) {
                q = hdr.seg_quant[s];
                if (!hdr.absolute_delta) q += hdr.base_q;
            }
            quant[s] = make_quant(q, hdr.dq);
        }
        FilterInfo fstrength[4][2];
        for (int s = 0; s < 4; ++s) {
            int base = hdr.level;
            if (hdr.use_segment) {
                base = hdr.seg_filter[s];
                if (!hdr.absolute_delta) base += hdr.level;
            }
            for (int i4 = 0; i4 <= 1; ++i4) {
                int level = base;
                if (hdr.use_lf_delta) {
                    level += hdr.ref_lf_delta[0];
                    if (i4) level += hdr.mode_lf_delta[0];
                }
                fstrength[s][i4] = filter_info(level, hdr.sharpness);
                fstrength[s][i4].inner = i4;
            }
        }
        const bool filtering = hdr.level != 0;
        std::vector<FilterInfo> finfo(filtering ? (size_t)mb_w * mb_h : 0);
        // the contexts: sub-block modes and non-zero flags above (per
        // macroblock column) and to the left
        std::vector<uint8_t> intra_t(4 * mb_w, B_DC);
        std::vector<uint8_t> nz_top(mb_w, 0), nz_dc_top(mb_w, 0);
        Work work;
        int16_t coeffs[384];
        std::vector<MBInfo> row(mb_w);
        for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
            uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
            uint8_t nz_left = 0, nz_dc_left = 0;
            BoolDecoder& tokens = parts[mb_y & (parts.size() - 1)];
            // a row's modes, then its tokens, with libwebp's checks
            for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
                row[mb_x] = MBInfo();
                read_modes(br, row[mb_x], &intra_t[4 * mb_x], intra_l);
            }
            if (br.eof) return fail("VP8 partition 0 ends early");
            for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
                const MBInfo& mb = row[mb_x];
                bool skip = mb.skip;
                uint32_t nz_y = 0, nz_uv = 0;  // blocks with a coefficient
                std::memset(coeffs, 0, sizeof(coeffs));
                if (!skip) {
                    read_residuals(tokens, mb, quant[mb.segment], coeffs, nz_top[mb_x],
                                   nz_dc_top[mb_x], nz_left, nz_dc_left, nz_y, nz_uv);
                    skip = !(nz_y | nz_uv);
                } else {
                    nz_top[mb_x] = nz_left = 0;
                    if (!mb.is_i4) nz_dc_top[mb_x] = nz_dc_left = 0;
                }
                if (tokens.eof) return fail("VP8 token partition ends early");
                if (filtering) {
                    FilterInfo& f = finfo[(size_t)mb_y * mb_w + mb_x];
                    f = fstrength[mb.segment][mb.is_i4];
                    f.inner = f.inner || !skip;
                }
                reconstruct(work, mb, coeffs, mb_x, mb_y);
            }
        }
        if (filtering)
            for (int mb_y = 0; mb_y < mb_h; ++mb_y)
                for (int mb_x = 0; mb_x < mb_w; ++mb_x)
                    filter_mb(planes, mb_x, mb_y, finfo[(size_t)mb_y * mb_w + mb_x], hdr.simple);
        return true;
    }

    // the tokens of one macroblock; the non-zero contexts are bit masks:
    // bits 0-3 the luma blocks' column (top) or row (left), 4-5 u, 6-7 v
    void read_residuals(BoolDecoder& br, const MBInfo& mb, const Quant& q, int16_t* dst,
                        uint8_t& top_nz, uint8_t& top_dc, uint8_t& left_nz, uint8_t& left_dc,
                        uint32_t& nz_y, uint32_t& nz_uv) {
        int first;
        int type;
        if (!mb.is_i4) {
            int16_t dc[16] = {0};
            const int ctx = top_dc + left_dc;
            const int nz = read_coeffs(br, hdr.proba[1], ctx, q.y2, 0, dc);
            top_dc = left_dc = nz > 0;
            if (nz > 1) {
                iwht(dc, dst);
            } else {
                const int dc0 = (dc[0] + 3) >> 3;
                for (int i = 0; i < 256; i += 16) dst[i] = (int16_t)dc0;
            }
            first = 1;
            type = 0;
        } else {
            first = 0;
            type = 3;
        }
        uint8_t tnz = top_nz & 0x0f, lnz = left_nz & 0x0f;
        uint8_t out_t = 0, out_l = 0;
        for (int y = 0; y < 4; ++y) {
            int l = (lnz >> y) & 1;
            for (int x = 0; x < 4; ++x) {
                const int ctx = l + ((tnz >> x) & 1);
                int16_t* c = dst + 16 * (4 * y + x);
                const int nz = read_coeffs(br, hdr.proba[type], ctx, q.y1, first, c);
                l = nz > first;
                tnz = (uint8_t)((tnz & ~(1 << x)) | (l << x));
                if (nz > first || c[0] != 0) nz_y |= 1u << (4 * y + x);
            }
            out_l |= (uint8_t)(l << y);
        }
        out_t = tnz;
        for (int ch = 0; ch < 2; ++ch) {
            const int shift = 4 + 2 * ch;
            uint8_t t = (top_nz >> shift) & 3, lf = (left_nz >> shift) & 3;
            for (int y = 0; y < 2; ++y) {
                int l = (lf >> y) & 1;
                for (int x = 0; x < 2; ++x) {
                    const int ctx = l + ((t >> x) & 1);
                    int16_t* c = dst + 256 + 64 * ch + 16 * (2 * y + x);
                    const int nz = read_coeffs(br, hdr.proba[2], ctx, q.uv, 0, c);
                    l = nz > 0;
                    t = (uint8_t)((t & ~(1 << x)) | (l << x));
                    if (nz > 0) nz_uv |= 1u << (4 * ch + 2 * y + x);
                }
                lf = (uint8_t)((lf & ~(1 << y)) | (l << y));
            }
            out_t |= (uint8_t)(t << shift);
            out_l |= (uint8_t)(lf << shift);
        }
        top_nz = out_t;
        left_nz = out_l;
    }

    void reconstruct(Work& work, const MBInfo& mb, const int16_t* coeffs, int mb_x, int mb_y) {
        work.load(planes, mb_x, mb_y);
        uint8_t* y = work.y();
        if (mb.is_i4) {
            for (int n = 0; n < 16; ++n) {
                uint8_t* dst = y + scan4(n);
                predict4(dst, mb.modes[n]);
                if (any_nonzero(coeffs + 16 * n)) idct_add(coeffs + 16 * n, dst);
            }
        } else {
            predict_block(y, 16, mb.modes[0], mb_x, mb_y);
            for (int n = 0; n < 16; ++n)
                if (any_nonzero(coeffs + 16 * n)) idct_add(coeffs + 16 * n, y + scan4(n));
        }
        uint8_t* uv[2] = {work.u(), work.v()};
        for (int ch = 0; ch < 2; ++ch) {
            predict_block(uv[ch], 8, mb.uv_mode, mb_x, mb_y);
            for (int n = 0; n < 4; ++n) {
                const int16_t* c = coeffs + 256 + 64 * ch + 16 * n;
                if (any_nonzero(c)) idct_add(c, uv[ch] + scan_uv(n));
            }
        }
        work.store(planes, mb_x, mb_y);
    }
};

// ------------------------------------------------------------------ ALPH

// an ALPH chunk -> the w x h alpha plane (the WebP container's alpha
// chunk: compression 0 raw or 1 VP8L, filters none, horizontal, vertical,
// gradient)
bool decode_alpha(const uint8_t* data, size_t size, int w, int h, std::vector<uint8_t>& alpha) {
    if (size < 1) return false;
    const int method = data[0] & 3, filter = (data[0] >> 2) & 3;
    const int pre = (data[0] >> 4) & 3, reserved = data[0] >> 6;
    if (method > 1 || pre > 1 || reserved != 0) return false;
    const size_t n = (size_t)w * h;
    alpha.resize(n);
    if (method == 0) {
        if (size - 1 < n) return false;
        std::memcpy(alpha.data(), data + 1, n);
    } else {
        std::vector<uint32_t> argb;
        if (!webp_lossless::decode_headerless(data + 1, size - 1, w, h, argb)) return false;
        for (size_t i = 0; i < n; ++i) alpha[i] = (uint8_t)(argb[i] >> 8);
    }
    if (filter == 0) return true;
    for (int y = 0; y < h; ++y) {
        uint8_t* row = alpha.data() + (size_t)y * w;
        const uint8_t* prev = y > 0 ? row - w : nullptr;
        if (!prev || filter == 1) {  // horizontal (and every filter's first row)
            int pred = prev ? prev[0] : 0;
            for (int x = 0; x < w; ++x) pred = row[x] = (uint8_t)(row[x] + pred);
        } else if (filter == 2) {  // vertical
            for (int x = 0; x < w; ++x) row[x] = (uint8_t)(row[x] + prev[x]);
        } else {  // gradient
            int left = prev[0], top_left = prev[0];
            for (int x = 0; x < w; ++x) {
                const int top = prev[x];
                left = (uint8_t)(row[x] + clip255(left + top - top_left));
                row[x] = (uint8_t)left;
                top_left = top;
            }
        }
    }
    return true;
}

// ========================================================== the encoder

// RGB -> Y'CbCr in libwebp's 16-bit fixed point (its VP8RGBToY/U/V); the
// chroma takes the sum of a 2x2 block of pixels
inline uint8_t rgb_to_y(int r, int g, int b) {
    return (uint8_t)((16839 * r + 33059 * g + 6420 * b + (1 << 15) + (16 << 16)) >> 16);
}
inline uint8_t clip_uv(int uv) {
    uv = (uv + (1 << 17) + (128 << 18)) >> 18;
    return (uint8_t)((uv & ~0xff) == 0 ? uv : uv < 0 ? 0 : 255);
}
inline uint8_t rgb_to_u(int r4, int g4, int b4) { return clip_uv(-9719 * r4 - 19081 * g4 + 28800 * b4); }
inline uint8_t rgb_to_v(int r4, int g4, int b4) { return clip_uv(28800 * r4 - 24116 * g4 - 4684 * b4); }

// [h, w, channels] pixels -> planes of whole macroblocks, the right and
// bottom edges replicated
void import_planes(const uint8_t* px, int w, int h, int channels, Planes& p) {
    p.resize((w + 15) >> 4, (h + 15) >> 4);
    const int ys = p.ys(), uvs = p.uvs();
    const int H = p.mb_h * 16, W = p.mb_w * 16;
    auto at = [&](int x, int y) {
        return px + ((size_t)std::min(y, h - 1) * w + std::min(x, w - 1)) * channels;
    };
    for (int y = 0; y < H; ++y)
        for (int x = 0; x < W; ++x) {
            const uint8_t* s = at(x, y);
            p.y[(size_t)y * ys + x] = rgb_to_y(s[0], s[1], s[2]);
        }
    const int cw = (w + 1) >> 1, chh = (h + 1) >> 1;
    for (int y = 0; y < H / 2; ++y)
        for (int x = 0; x < W / 2; ++x) {
            const int cx = std::min(x, cw - 1), cy = std::min(y, chh - 1);
            int r = 0, g = 0, b = 0;
            for (int dy = 0; dy < 2; ++dy)
                for (int dx = 0; dx < 2; ++dx) {
                    const uint8_t* s = at(2 * cx + dx, 2 * cy + dy);
                    r += s[0], g += s[1], b += s[2];
                }
            p.u[(size_t)y * uvs + x] = rgb_to_u(r, g, b);
            p.v[(size_t)y * uvs + x] = rgb_to_v(r, g, b);
        }
}

// the forward DCT of src - ref (4x4, strides BPS), libwebp's integer form
void fdct(const uint8_t* src, const uint8_t* ref, int16_t* out) {
    int tmp[16];
    for (int i = 0; i < 4; ++i, src += BPS, ref += BPS) {
        const int d0 = src[0] - ref[0], d1 = src[1] - ref[1];
        const int d2 = src[2] - ref[2], d3 = src[3] - ref[3];
        const int a0 = d0 + d3, a1 = d1 + d2, a2 = d1 - d2, a3 = d0 - d3;
        tmp[0 + i * 4] = (a0 + a1) * 8;
        tmp[1 + i * 4] = (a2 * 2217 + a3 * 5352 + 1812) >> 9;
        tmp[2 + i * 4] = (a0 - a1) * 8;
        tmp[3 + i * 4] = (a3 * 2217 - a2 * 5352 + 937) >> 9;
    }
    for (int i = 0; i < 4; ++i) {
        const int a0 = tmp[0 + i] + tmp[12 + i], a1 = tmp[4 + i] + tmp[8 + i];
        const int a2 = tmp[4 + i] - tmp[8 + i], a3 = tmp[0 + i] - tmp[12 + i];
        out[0 + i] = (int16_t)((a0 + a1 + 7) >> 4);
        out[4 + i] = (int16_t)(((a2 * 2217 + a3 * 5352 + 12000) >> 16) + (a3 != 0));
        out[8 + i] = (int16_t)((a0 - a1 + 7) >> 4);
        out[12 + i] = (int16_t)((a3 * 2217 - a2 * 5352 + 51000) >> 16);
    }
}

// the forward Walsh-Hadamard transform of the 16 luma dcs (in[16 * k])
void fwht(const int16_t* in, int16_t* out) {
    int tmp[16];
    for (int i = 0; i < 4; ++i, in += 64) {
        const int a0 = in[0] + in[32], a1 = in[16] + in[48];
        const int a2 = in[16] - in[48], a3 = in[0] - in[32];
        tmp[0 + i * 4] = a0 + a1;
        tmp[1 + i * 4] = a3 + a2;
        tmp[2 + i * 4] = a3 - a2;
        tmp[3 + i * 4] = a0 - a1;
    }
    for (int i = 0; i < 4; ++i) {
        const int a0 = tmp[0 + i] + tmp[8 + i], a1 = tmp[4 + i] + tmp[12 + i];
        const int a2 = tmp[4 + i] - tmp[12 + i], a3 = tmp[0 + i] - tmp[8 + i];
        out[0 + i] = (int16_t)((a0 + a1) >> 1);
        out[4 + i] = (int16_t)((a3 + a2) >> 1);
        out[8 + i] = (int16_t)((a3 - a2) >> 1);
        out[12 + i] = (int16_t)((a0 - a1) >> 1);
    }
}

// a quantizer of one block type: the step, its reciprocal and the rounding
// bias (dc, ac), in 17-bit fixed point
struct QMatrix {
    int q[2];
    uint32_t iq[2], bias[2];
    void set(const int step[2], const double round[2]) {
        for (int k = 0; k < 2; ++k) {
            q[k] = step[k];
            iq[k] = (1u << 17) / (uint32_t)step[k];
            bias[k] = (uint32_t)(round[k] * (1 << 17));
        }
    }
};

// quantize a raster block from position `first` (zigzag): levels in zigzag
// order, the dequantized values back in raster order (the positions before
// `first` untouched); returns the last non-zero position, -1 for none
int quantize(const int16_t* in, const QMatrix& m, int first, int16_t* levels, int16_t* deq) {
    int last = -1;
    for (int n = 0; n < first; ++n) levels[n] = 0;
    for (int n = first; n < 16; ++n) {
        const int j = kZigzag[n], k = n > 0;
        const int c = in[j];
        const uint32_t a = (uint32_t)(c < 0 ? -c : c);
        if (a * m.iq[k] + m.bias[k] < (1u << 17)) {  // rounds to 0
            levels[n] = 0;
            deq[j] = 0;
            continue;
        }
        int lvl = (int)((a * m.iq[k] + m.bias[k]) >> 17);
        if (lvl > 2047) lvl = 2047;
        const int s = c < 0 ? -lvl : lvl;
        levels[n] = (int16_t)s;
        deq[j] = (int16_t)(s * m.q[k]);
        last = n;
    }
    return last;
}

int sse(const uint8_t* a, const uint8_t* b, int wdt, int hgt) {
    int s = 0;
    for (int y = 0; y < hgt; ++y)
        for (int x = 0; x < wdt; ++x) {
            const int d = a[y * BPS + x] - b[y * BPS + x];
            s += d * d;
        }
    return s;
}

void copy_block(const uint8_t* src, uint8_t* dst, int wdt, int hgt) {
    for (int y = 0; y < hgt; ++y) std::memcpy(dst + y * BPS, src + y * BPS, wdt);
}

// --- bit costs, in 1/256 bit

struct Costs {
    uint16_t bit[256][2];
    Costs() {
        for (int p = 0; p < 256; ++p) {
            const double p0 = p == 0 ? 0.5 / 256 : p / 256.0;
            bit[p][0] = (uint16_t)std::lround(-std::log2(p0) * 256);
            bit[p][1] = (uint16_t)std::lround(-std::log2(1 - p / 256.0) * 256);
        }
    }
};
const Costs kCosts;
inline int bit_cost(int bit, int prob) { return kCosts.bit[prob][bit]; }

// the path of a sub-block mode through the mode tree: (node, bit) pairs
struct TreePath {
    int len = 0;
    uint8_t node[9], bit[9];
};
struct ModePaths {
    TreePath p[kNumBModes];
    ModePaths() { walk(0, TreePath()); }
    void walk(int node, TreePath path) {
        for (int b = 0; b < 2; ++b) {
            TreePath q = path;
            q.node[q.len] = (uint8_t)node, q.bit[q.len] = (uint8_t)b, ++q.len;
            const int next = kYModesIntra4[2 * node + b];
            if (next > 0) walk(next, q);
            else p[-next] = q;
        }
    }
};
const ModePaths kModePaths;

// the bits of each sub-block mode under each (above, left) context
struct I4ModeCosts {
    uint16_t c[kNumBModes][kNumBModes][kNumBModes];
    I4ModeCosts() {
        for (int top = 0; top < kNumBModes; ++top)
            for (int left = 0; left < kNumBModes; ++left)
                for (int mode = 0; mode < kNumBModes; ++mode) {
                    const TreePath& t = kModePaths.p[mode];
                    int cost = 0;
                    for (int k = 0; k < t.len; ++k)
                        cost += bit_cost(t.bit[k], kBModesProba[top][left][t.node[k]]);
                    c[top][left][mode] = (uint16_t)cost;
                }
    }
};
const I4ModeCosts kI4ModeCosts;

inline int i4_mode_cost(int top, int left, int mode) { return kI4ModeCosts.c[top][left][mode]; }

// (bit, probability) pairs of the 16x16 and chroma mode trees
const uint8_t kI16Bits[4][2] = {{0, 0}, {1, 1}, {0, 1}, {1, 0}};  // DC, TM, V, H
const uint8_t kI16Probs[4][2] = {{156, 163}, {156, 128}, {156, 163}, {156, 128}};
int i16_mode_cost(int mode) {
    return bit_cost(kI16Bits[mode][0], kI16Probs[mode][0]) +
           bit_cost(kI16Bits[mode][1], kI16Probs[mode][1]);
}
int uv_mode_cost(int mode) {
    switch (mode) {
        case DC_PRED: return bit_cost(0, 142);
        case V_PRED: return bit_cost(1, 142) + bit_cost(0, 114);
        case H_PRED: return bit_cost(1, 142) + bit_cost(1, 114) + bit_cost(0, 183);
        default: return bit_cost(1, 142) + bit_cost(1, 114) + bit_cost(1, 183);
    }
}

using Proba = uint8_t[kNumTypes][kNumBands][kNumCtx][kNumProbas];

// The tokens of one block (levels in zigzag order, from `first`, the last
// non-zero at `last`) through a sink: sink.adaptive(bit, band, ctx, node)
// for the bits coded with the frame's coefficient probabilities,
// sink.fixed(bit, prob) for the others. Returns whether the block has a
// non-zero coefficient (its context for the blocks right of and below it).
template <class Sink>
bool put_tokens(Sink& s, int first, int last, const int16_t* levels, int ctx) {
    int n = first;
    int band = kBands[n];
    if (!s.adaptive(last >= 0, band, ctx, 0)) return false;
    while (n < 16) {
        const int c = levels[n++];
        int v = c < 0 ? -c : c;
        if (!s.adaptive(v != 0, band, ctx, 1)) {
            band = kBands[n], ctx = 0;
            continue;
        }
        if (!s.adaptive(v > 1, band, ctx, 2)) {
            band = kBands[n], ctx = 1;
        } else {
            if (!s.adaptive(v > 4, band, ctx, 3)) {
                if (s.adaptive(v != 2, band, ctx, 4)) s.adaptive(v == 4, band, ctx, 5);
            } else if (!s.adaptive(v > 10, band, ctx, 6)) {
                if (!s.adaptive(v > 6, band, ctx, 7)) {
                    s.fixed(v == 6, 159);
                } else {
                    s.fixed(v >= 9, 165);
                    s.fixed(!(v & 1), 145);
                }
            } else {
                int mask;
                const uint8_t* tab;
                if (v < 3 + (8 << 1)) {
                    s.adaptive(0, band, ctx, 8), s.adaptive(0, band, ctx, 9);
                    v -= 3 + (8 << 0), mask = 1 << 2, tab = kCat3;
                } else if (v < 3 + (8 << 2)) {
                    s.adaptive(0, band, ctx, 8), s.adaptive(1, band, ctx, 9);
                    v -= 3 + (8 << 1), mask = 1 << 3, tab = kCat4;
                } else if (v < 3 + (8 << 3)) {
                    s.adaptive(1, band, ctx, 8), s.adaptive(0, band, ctx, 10);
                    v -= 3 + (8 << 2), mask = 1 << 4, tab = kCat5;
                } else {
                    s.adaptive(1, band, ctx, 8), s.adaptive(1, band, ctx, 10);
                    v -= 3 + (8 << 3), mask = 1 << 10, tab = kCat6;
                }
                for (; mask; mask >>= 1) s.fixed(!!(v & mask), *tab++);
            }
            band = kBands[n], ctx = 2;
        }
        s.fixed(c < 0, 128);
        if (n == 16 || !s.adaptive(n <= last, band, ctx, 0)) return true;
    }
    return true;
}

// sums the bit costs of a block's tokens under one type's probabilities
struct CostSink {
    const uint8_t (*prob)[kNumCtx][kNumProbas];
    int total = 0;
    int adaptive(int bit, int band, int ctx, int node) {
        total += bit_cost(bit, prob[band][ctx][node]);
        return bit;
    }
    void fixed(int bit, int p) { total += bit_cost(bit, p); }
};

int tokens_cost(const Proba& pr, int type, int first, int last, const int16_t* levels, int ctx) {
    CostSink s{pr[type]};
    put_tokens(s, first, last, levels, ctx);
    return s.total;
}

// counts, per probability, the bits coded with it
struct StatsSink {
    uint32_t (*counts)[kNumCtx][kNumProbas][2];
    int adaptive(int bit, int band, int ctx, int node) {
        ++counts[band][ctx][node][bit];
        return bit;
    }
    void fixed(int, int) {}
};

// the boolean entropy encoder (section 7.3), its carry propagated into the
// bytes already written
struct BoolEncoder {
    std::vector<uint8_t> out;
    uint32_t range = 255, bottom = 0;
    int bit_count = 24;
    void add_one() {
        size_t i = out.size();
        while (i > 0 && out[i - 1] == 255) out[--i] = 0;
        if (i > 0) ++out[i - 1];
    }
    int put(int bit, int prob) {
        const uint32_t split = 1 + (((range - 1) * (uint32_t)prob) >> 8);
        if (bit) {
            bottom += split;
            range -= split;
        } else {
            range = split;
        }
        while (range < 128) {
            range <<= 1;
            if (bottom & (1u << 31)) add_one();
            bottom <<= 1;
            if (!--bit_count) {
                out.push_back((uint8_t)(bottom >> 24));
                bottom &= (1u << 24) - 1;
                bit_count = 8;
            }
        }
        return bit;
    }
    void put_literal(int v, int bits) {
        while (bits-- > 0) put((v >> bits) & 1, 128);
    }
    void put_signed(int v, int bits) {
        put_literal(std::abs(v), bits);
        put(v < 0, 128);
    }
    void flush() {
        int c = bit_count;
        uint32_t v = bottom;
        if (v & (1u << (32 - c))) add_one();
        v <<= c & 7;
        c >>= 3;
        while (--c >= 0) v <<= 8;
        for (c = 0; c < 4; ++c, v <<= 8) out.push_back((uint8_t)(v >> 24));
    }
};

struct WriteSink {
    BoolEncoder& bw;
    const uint8_t (*prob)[kNumCtx][kNumProbas];
    int adaptive(int bit, int band, int ctx, int node) { return bw.put(bit, prob[band][ctx][node]); }
    void fixed(int bit, int p) { bw.put(bit, p); }
};

// what the encoder keeps of a macroblock for the writing pass
struct EncMB {
    uint8_t is_i4 = 0, uv_mode = 0, skip = 0;
    uint8_t coded = 0;  // a dequantized coefficient is non-zero (the decoder's test)
    uint8_t modes[16] = {0};
    int16_t y2[16];
    int16_t y[16][16];
    int16_t uv[8][16];  // u blocks 0-3, v blocks 4-7
    int8_t last_y2 = -1, last_y[16], last_uv[8];
};

// The quality -> quantizer index map of this encoder: libwebp's curve
// without its per-segment modulation, at 0.9 of its index. Quality q in
// [0, 1] gives a linear "compression" (2q/3 below 0.75, else 2q - 1), c is
// its cube root, and the index is floor(0.9 * 127 * (1 - c)): q 0 -> 114,
// 50 -> 35, 75 -> 23, 90 -> 8, 100 -> 0. The 0.9 brings the bytes of
// a file near libwebp's at the same quality (PERF.md). Monotone: a higher
// quality never takes a larger index.
int quality_to_qindex(int quality) {
    const double q = clamp_int(quality, 0, 100) / 100.0;
    const double linear = q < 0.75 ? q * (2.0 / 3.0) : 2.0 * q - 1.0;
    const double c = std::cbrt(linear);
    return clamp_int((int)(0.9 * 127.0 * (1.0 - c)), 0, 127);
}

struct EncOptions {
    int quality = 75;
    bool simple_filter = false;
    int sharpness = 0;
    int partitions_log2 = 0;  // 1, 2, 4 or 8 token partitions
    int mode_lf_delta = 0;    // the loop-filter level delta of i4 macroblocks
};

// The modes tried in full (transform, quantize, reconstruct, count the
// tokens), of those ranked by their prediction's error plus mode bits: two
// of the four 16x16 modes, three of the ten sub-block modes, two of the
// four chroma modes. The files of chip_smoke.py phase 10's encodes stay
// within 0.7% of the size and 0.05 dB of the PSNR of trying every mode.
constexpr int kI16Trials = 2, kI4Trials = 3, kUVTrials = 2;

// order[0..n) <- 0..n-1 by key, least first, ties in index order
void rank_modes(const int64_t* key, int n, int* order) {
    for (int k = 0; k < n; ++k) {
        int j = k;
        for (; j > 0 && key[order[j - 1]] > key[k]; --j) order[j] = order[j - 1];
        order[j] = k;
    }
}

struct Vp8Encoder {
    EncOptions opt;
    int w = 0, h = 0, qindex = 0;
    Quant quant;
    QMatrix qy1, qy2, quv;
    int64_t lambda = 0;  // 16 * (squared error per bit)
    Planes src, rec;
    std::vector<EncMB> mbs;
    Proba proba;
    int level = 0;

    int64_t score(int64_t d, int64_t r) const { return d * 4096 + lambda * r; }

    void setup() {
        qindex = quality_to_qindex(opt.quality);
        const int dq[5] = {0, 0, 0, 0, 0};
        quant = make_quant(qindex, dq);
        // rounding toward zero of a fraction under 1/2 of a step (dc, ac):
        // libwebp's biases
        const double r_y1[2] = {0.375, 0.43}, r_y2[2] = {0.375, 0.42}, r_uv[2] = {0.43, 0.45};
        qy1.set(quant.y1, r_y1);
        qy2.set(quant.y2, r_y2);
        quv.set(quant.uv, r_uv);
        const int64_t qac = quant.y1[1];
        lambda = std::max<int64_t>(1, (qac * qac * 16 * 3) / 100);  // 0.03 * Q^2 per bit
        std::memcpy(proba, kCoeffsProba0, sizeof(proba));
        // the loop filter's level from the quantizer's ac step
        level = clamp_int((int)std::lround(0.29 * quant.y1[1]), 0, 63);
        if (qindex == 0) level = 0;
    }

    // --- one macroblock

    struct Ctx {
        uint8_t* top_nz;     // [4 luma, 2 u, 2 v] of this column
        uint8_t* left_nz;    // [4 luma, 2 u, 2 v] of this row
        uint8_t* top_dc;
        uint8_t* left_dc;
        uint8_t* top_modes;  // 4
        uint8_t* left_modes;
    };

    void encode_mb(Work& work, int mb_x, int mb_y, Ctx c, EncMB& mb) {
        work.load(rec, mb_x, mb_y);
        Work srcw;  // the source block, in the work layout
        srcw.load_block(src, mb_x, mb_y);
        // --- luma 16x16
        uint8_t best16[BPS * 16];
        int64_t best16_score = -1;
        int best16_mode = 0;
        EncMB cand;
        int best_nz_top[4], best_nz_left[4];
        int best_dc_nz = 0;
        EncMB b16;
        int64_t pre16[4];
        for (int mode = 0; mode < 4; ++mode) {
            predict_block(work.y(), 16, mode, mb_x, mb_y);
            pre16[mode] = score(sse(srcw.y(), work.y(), 16, 16), i16_mode_cost(mode));
        }
        int order16[4];
        rank_modes(pre16, 4, order16);
        for (int t = 0; t < kI16Trials; ++t) {
            const int mode = order16[t];
            uint8_t* y = work.y();
            predict_block(y, 16, mode, mb_x, mb_y);
            int16_t coeffs[256];
            for (int n = 0; n < 16; ++n) fdct(srcw.y() + scan4(n), y + scan4(n), coeffs + 16 * n);
            int16_t dc[16], dcq[16];
            fwht(coeffs, dc);
            cand.last_y2 = (int8_t)quantize(dc, qy2, 0, cand.y2, dcq);
            int16_t deq[256];
            std::memset(deq, 0, sizeof(deq));
            iwht(dcq, deq);
            int rate = i16_mode_cost(mode) + bit_cost(1, kYModeIsI4);
            const int dc_ctx = *c.top_dc + *c.left_dc;
            rate += tokens_cost(proba, 1, 0, cand.last_y2, cand.y2, dc_ctx);
            int tnz[4], lnz[4];
            for (int k = 0; k < 4; ++k) tnz[k] = c.top_nz[k], lnz[k] = c.left_nz[k];
            for (int n = 0; n < 16; ++n) {
                const int x = n & 3, yy = n >> 2;
                cand.last_y[n] = (int8_t)quantize(coeffs + 16 * n, qy1, 1, cand.y[n], deq + 16 * n);
                rate += tokens_cost(proba, 0, 1, cand.last_y[n], cand.y[n], tnz[x] + lnz[yy]);
                tnz[x] = lnz[yy] = cand.last_y[n] >= 0;
            }
            cand.coded = 0;
            for (int n = 0; n < 16; ++n)
                if (any_nonzero(deq + 16 * n)) {
                    idct_add(deq + 16 * n, y + scan4(n));
                    cand.coded = 1;
                }
            const int d = sse(srcw.y(), y, 16, 16);
            const int64_t sc = score(d, rate);
            if (best16_score < 0 || sc < best16_score) {
                best16_score = sc;
                best16_mode = mode;
                copy_block(y, best16, 16, 16);
                b16 = cand;
                for (int k = 0; k < 4; ++k) best_nz_top[k] = tnz[k], best_nz_left[k] = lnz[k];
                best_dc_nz = cand.last_y2 >= 0;
            }
        }
        // --- luma sub-blocks
        EncMB b4;
        int64_t total4 = score(0, bit_cost(0, kYModeIsI4));
        int tnz4[4], lnz4[4];
        for (int k = 0; k < 4; ++k) tnz4[k] = c.top_nz[k], lnz4[k] = c.left_nz[k];
        uint8_t tmodes[4], lmodes[4];
        std::memcpy(tmodes, c.top_modes, 4);
        std::memcpy(lmodes, c.left_modes, 4);
        uint8_t* y = work.y();
        bool i4_ok = true;
        for (int n = 0; n < 16 && i4_ok; ++n) {
            const int x = n & 3, yy = n >> 2;
            uint8_t* dst = y + scan4(n);
            const uint8_t* s4 = srcw.y() + scan4(n);
            int64_t best = -1;
            uint8_t best_pix[BPS * 4] = {0};
            int16_t best_lv[16];
            int best_last = -1, best_mode = 0;
            int64_t pre[kNumBModes];
            for (int mode = 0; mode < kNumBModes; ++mode) {
                predict4(dst, mode);
                pre[mode] = score(sse(s4, dst, 4, 4), i4_mode_cost(tmodes[x], lmodes[yy], mode));
            }
            int order[kNumBModes];
            rank_modes(pre, kNumBModes, order);
            for (int t = 0; t < kI4Trials; ++t) {
                const int mode = order[t];
                predict4(dst, mode);
                int16_t co[16], deq[16], lv[16];
                fdct(s4, dst, co);
                const int last = quantize(co, qy1, 0, lv, deq);
                if (last >= 0) idct_add(deq, dst);
                const int d = sse(s4, dst, 4, 4);
                const int r = i4_mode_cost(tmodes[x], lmodes[yy], mode) +
                              tokens_cost(proba, 3, 0, last, lv, tnz4[x] + lnz4[yy]);
                const int64_t sc = score(d, r);
                if (best < 0 || sc < best) {
                    best = sc, best_mode = mode, best_last = last;
                    copy_block(dst, best_pix, 4, 4);
                    std::memcpy(best_lv, lv, sizeof(lv));
                }
            }
            copy_block(best_pix, dst, 4, 4);
            b4.modes[n] = (uint8_t)best_mode;
            std::memcpy(b4.y[n], best_lv, sizeof(best_lv));
            b4.last_y[n] = (int8_t)best_last;
            tnz4[x] = lnz4[yy] = best_last >= 0;
            tmodes[x] = lmodes[yy] = (uint8_t)best_mode;
            total4 += best;
            if (total4 >= best16_score) i4_ok = false;
        }
        if (i4_ok) {
            mb.is_i4 = 1;
            std::memcpy(mb.modes, b4.modes, 16);
            std::memcpy(mb.y, b4.y, sizeof(mb.y));
            std::memcpy(mb.last_y, b4.last_y, sizeof(mb.last_y));
            mb.last_y2 = -1;
            for (int k = 0; k < 4; ++k) c.top_nz[k] = tnz4[k], c.left_nz[k] = lnz4[k];
            std::memcpy(c.top_modes, tmodes, 4);
            std::memcpy(c.left_modes, lmodes, 4);
        } else {
            mb.is_i4 = 0;
            mb.coded = b16.coded;
            mb.modes[0] = (uint8_t)best16_mode;
            std::memcpy(mb.y2, b16.y2, sizeof(mb.y2));
            mb.last_y2 = b16.last_y2;
            std::memcpy(mb.y, b16.y, sizeof(mb.y));
            std::memcpy(mb.last_y, b16.last_y, sizeof(mb.last_y));
            copy_block(best16, work.y(), 16, 16);
            for (int k = 0; k < 4; ++k) c.top_nz[k] = best_nz_top[k], c.left_nz[k] = best_nz_left[k];
            *c.top_dc = *c.left_dc = (uint8_t)best_dc_nz;
            std::memset(c.top_modes, best16_mode, 4);
            std::memset(c.left_modes, best16_mode, 4);
        }
        // --- chroma
        int64_t best_uv = -1;
        uint8_t bu[BPS * 8], bv[BPS * 8];
        EncMB buv;
        int best_t[4], best_l[4];
        int64_t pre_uv[4];
        for (int mode = 0; mode < 4; ++mode) {
            predict_block(work.u(), 8, mode, mb_x, mb_y);
            predict_block(work.v(), 8, mode, mb_x, mb_y);
            pre_uv[mode] = score(sse(srcw.u(), work.u(), 8, 8) + sse(srcw.v(), work.v(), 8, 8),
                                 uv_mode_cost(mode));
        }
        int order_uv[4];
        rank_modes(pre_uv, 4, order_uv);
        for (int trial = 0; trial < kUVTrials; ++trial) {
            const int mode = order_uv[trial];
            uint8_t* planes[2] = {work.u(), work.v()};
            const uint8_t* srcs[2] = {srcw.u(), srcw.v()};
            int rate = uv_mode_cost(mode), d = 0;
            int t[4], l[4];
            for (int k = 0; k < 4; ++k) t[k] = c.top_nz[4 + k], l[k] = c.left_nz[4 + k];
            for (int ch = 0; ch < 2; ++ch) {
                predict_block(planes[ch], 8, mode, mb_x, mb_y);
                for (int n = 0; n < 4; ++n) {
                    const int x = n & 1, yy = n >> 1;
                    int16_t co[16], deq[16];
                    uint8_t* dst = planes[ch] + scan_uv(n);
                    fdct(srcs[ch] + scan_uv(n), dst, co);
                    const int last = quantize(co, quv, 0, cand.uv[4 * ch + n], deq);
                    cand.last_uv[4 * ch + n] = (int8_t)last;
                    rate += tokens_cost(proba, 2, 0, last, cand.uv[4 * ch + n],
                                        t[2 * ch + x] + l[2 * ch + yy]);
                    t[2 * ch + x] = l[2 * ch + yy] = last >= 0;
                    if (last >= 0) idct_add(deq, dst);
                }
                d += sse(srcs[ch], planes[ch], 8, 8);
            }
            const int64_t sc = score(d, rate);
            if (best_uv < 0 || sc < best_uv) {
                best_uv = sc;
                mb.uv_mode = (uint8_t)mode;
                copy_block(work.u(), bu, 8, 8);
                copy_block(work.v(), bv, 8, 8);
                std::memcpy(buv.uv, cand.uv, sizeof(cand.uv));
                std::memcpy(buv.last_uv, cand.last_uv, sizeof(cand.last_uv));
                for (int k = 0; k < 4; ++k) best_t[k] = t[k], best_l[k] = l[k];
            }
        }
        std::memcpy(mb.uv, buv.uv, sizeof(mb.uv));
        std::memcpy(mb.last_uv, buv.last_uv, sizeof(mb.last_uv));
        copy_block(bu, work.u(), 8, 8);
        copy_block(bv, work.v(), 8, 8);
        for (int k = 0; k < 4; ++k) c.top_nz[4 + k] = best_t[k], c.left_nz[4 + k] = best_l[k];
        bool any = mb.last_y2 >= 0, uv_any = false;
        for (int n = 0; n < 16; ++n) any = any || mb.last_y[n] >= 0;
        for (int n = 0; n < 8; ++n) uv_any = uv_any || mb.last_uv[n] >= 0;
        mb.skip = !(any || uv_any);
        // an i4 macroblock's blocks start at position 0: a level is a
        // non-zero coefficient
        mb.coded = uv_any || (mb.is_i4 ? any : mb.coded);
        work.store(rec, mb_x, mb_y);
    }
    // --- the frame

    void analyse() {
        const int mb_w = src.mb_w, mb_h = src.mb_h;
        rec.resize(mb_w, mb_h);
        mbs.assign((size_t)mb_w * mb_h, EncMB());
        std::vector<uint8_t> top_nz(8 * mb_w, 0), top_dc(mb_w, 0), top_modes(4 * mb_w, B_DC);
        Work work;
        for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
            uint8_t left_nz[8] = {0}, left_dc = 0, left_modes[4] = {B_DC, B_DC, B_DC, B_DC};
            for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
                Ctx c{&top_nz[8 * mb_x], left_nz, &top_dc[mb_x], &left_dc, &top_modes[4 * mb_x],
                      left_modes};
                encode_mb(work, mb_x, mb_y, c, mbs[(size_t)mb_y * mb_w + mb_x]);
            }
        }
    }

    // walk the macroblocks' tokens in coding order with their contexts;
    // fn(mb, type, first, last, levels, ctx) per block of a macroblock that
    // is not skipped
    template <class Fn>
    void walk_tokens(Fn&& fn) {
        const int mb_w = src.mb_w, mb_h = src.mb_h;
        std::vector<uint8_t> top_nz(8 * mb_w, 0), top_dc(mb_w, 0);
        for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
            uint8_t left_nz[8] = {0}, left_dc = 0;
            for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
                const EncMB& mb = mbs[(size_t)mb_y * mb_w + mb_x];
                uint8_t* tnz = &top_nz[8 * mb_x];
                if (mb.skip) {
                    std::memset(tnz, 0, 8);
                    std::memset(left_nz, 0, 8);
                    if (!mb.is_i4) top_dc[mb_x] = left_dc = 0;
                    continue;
                }
                int first = 0, type = 3;
                if (!mb.is_i4) {
                    const int nz = fn(mb_y, 1, 0, mb.last_y2, mb.y2, top_dc[mb_x] + left_dc);
                    top_dc[mb_x] = left_dc = (uint8_t)nz;
                    first = 1, type = 0;
                }
                for (int n = 0; n < 16; ++n) {
                    const int x = n & 3, y = n >> 2;
                    tnz[x] = left_nz[y] = (uint8_t)fn(mb_y, type, first, mb.last_y[n], mb.y[n],
                                                      tnz[x] + left_nz[y]);
                }
                for (int n = 0; n < 8; ++n) {
                    const int ch = n >> 2, x = n & 1, y = (n >> 1) & 1;
                    uint8_t& t = tnz[4 + 2 * ch + x];
                    uint8_t& l = left_nz[4 + 2 * ch + y];
                    t = l = (uint8_t)fn(mb_y, 2, 0, mb.last_uv[n], mb.uv[n], t + l);
                }
            }
        }
    }

    // the coefficient probabilities that save bits over the defaults
    int choose_proba() {
        static uint32_t zero[kNumTypes][kNumBands][kNumCtx][kNumProbas][2];
        std::vector<uint32_t> buf(sizeof(zero) / sizeof(uint32_t), 0);
        auto* counts = reinterpret_cast<uint32_t(*)[kNumBands][kNumCtx][kNumProbas][2]>(buf.data());
        walk_tokens([&](int, int type, int first, int last, const int16_t* lv, int ctx) {
            StatsSink s{counts[type]};
            return (int)put_tokens(s, first, last, lv, ctx);
        });
        int updates = 0;
        for (int t = 0; t < kNumTypes; ++t)
            for (int b = 0; b < kNumBands; ++b)
                for (int c = 0; c < kNumCtx; ++c)
                    for (int p = 0; p < kNumProbas; ++p) {
                        const uint32_t n0 = counts[t][b][c][p][0], n1 = counts[t][b][c][p][1];
                        const int old_p = kCoeffsProba0[t][b][c][p];
                        const int up = kCoeffsUpdateProba[t][b][c][p];
                        proba[t][b][c][p] = (uint8_t)old_p;
                        if (n0 + n1 == 0) continue;
                        const int new_p =
                            clamp_int((int)((n0 * 255ull + (n0 + n1) / 2) / (n0 + n1)), 1, 255);
                        const int64_t old_cost = (int64_t)n0 * bit_cost(0, old_p) +
                                                 (int64_t)n1 * bit_cost(1, old_p) + bit_cost(0, up);
                        const int64_t new_cost = (int64_t)n0 * bit_cost(0, new_p) +
                                                 (int64_t)n1 * bit_cost(1, new_p) + bit_cost(1, up) +
                                                 8 * 256;
                        if (new_cost < old_cost) {
                            proba[t][b][c][p] = (uint8_t)new_p;
                            ++updates;
                        }
                    }
        return updates;
    }

    std::vector<uint8_t> write() {
        const int mb_w = src.mb_w, mb_h = src.mb_h;
        int skipped = 0;
        for (const EncMB& mb : mbs) skipped += mb.skip;
        const int total = mb_w * mb_h;
        const int skip_p = clamp_int((total - skipped) * 255 / total, 1, 254);
        const bool use_skip = skipped > 0;
        BoolEncoder hdr;
        hdr.put(0, 128);  // colour space
        hdr.put(0, 128);  // clamping required
        hdr.put(0, 128);  // no segmentation
        hdr.put(opt.simple_filter, 128);
        hdr.put_literal(level, 6);
        hdr.put_literal(opt.sharpness, 3);
        hdr.put(opt.mode_lf_delta != 0, 128);  // loop-filter deltas
        if (opt.mode_lf_delta) {
            hdr.put(1, 128);  // update them
            for (int i = 0; i < 4; ++i) hdr.put(0, 128);
            for (int i = 0; i < 4; ++i) {
                hdr.put(i == 0, 128);
                if (i == 0) hdr.put_signed(opt.mode_lf_delta, 6);
            }
        }
        hdr.put_literal(opt.partitions_log2, 2);
        hdr.put_literal(qindex, 7);
        for (int k = 0; k < 5; ++k) hdr.put(0, 128);  // no quantizer deltas
        hdr.put(0, 128);  // refresh entropy probs
        for (int t = 0; t < kNumTypes; ++t)
            for (int b = 0; b < kNumBands; ++b)
                for (int c = 0; c < kNumCtx; ++c)
                    for (int p = 0; p < kNumProbas; ++p) {
                        const int v = proba[t][b][c][p];
                        const bool update = v != kCoeffsProba0[t][b][c][p];
                        hdr.put(update, kCoeffsUpdateProba[t][b][c][p]);
                        if (update) hdr.put_literal(v, 8);
                    }
        hdr.put(use_skip, 128);
        if (use_skip) hdr.put_literal(skip_p, 8);
        // the modes, in partition 0
        for (int mb_y = 0; mb_y < mb_h; ++mb_y)
            for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
                const EncMB& mb = mbs[(size_t)mb_y * mb_w + mb_x];
                if (use_skip) hdr.put(mb.skip, skip_p);
                hdr.put(!mb.is_i4, kYModeIsI4);
                if (!mb.is_i4) {
                    const int m = mb.modes[0];
                    hdr.put(kI16Bits[m][0], kI16Probs[m][0]);
                    hdr.put(kI16Bits[m][1], kI16Probs[m][1]);
                } else {
                    put_i4_modes(hdr, mb_x, mb_y);
                }
                const int uv = mb.uv_mode;
                hdr.put(uv != DC_PRED, 142);
                if (uv != DC_PRED) {
                    hdr.put(uv != V_PRED, 114);
                    if (uv != V_PRED) hdr.put(uv == TM_PRED, 183);
                }
            }
        hdr.flush();
        // the tokens
        const int num_parts = 1 << opt.partitions_log2;
        std::vector<BoolEncoder> parts(num_parts);
        walk_tokens([&](int mb_y, int type, int first, int last, const int16_t* lv, int ctx) {
            WriteSink s{parts[mb_y & (num_parts - 1)], proba[type]};
            return (int)put_tokens(s, first, last, lv, ctx);
        });
        for (BoolEncoder& p : parts) p.flush();
        // the frame: tag, start code, size, partition 0, sizes, partitions
        std::vector<uint8_t> out;
        const uint32_t part0 = (uint32_t)hdr.out.size();
        const int profile = opt.simple_filter ? 1 : 0;
        const uint32_t tag = 0 | (profile << 1) | (1 << 4) | (part0 << 5);
        out.push_back((uint8_t)tag), out.push_back((uint8_t)(tag >> 8));
        out.push_back((uint8_t)(tag >> 16));
        out.insert(out.end(), {0x9d, 0x01, 0x2a});
        out.push_back((uint8_t)w), out.push_back((uint8_t)(w >> 8));
        out.push_back((uint8_t)h), out.push_back((uint8_t)(h >> 8));
        out.insert(out.end(), hdr.out.begin(), hdr.out.end());
        for (int k = 0; k + 1 < num_parts; ++k) {
            const uint32_t n = (uint32_t)parts[k].out.size();
            out.push_back((uint8_t)n), out.push_back((uint8_t)(n >> 8));
            out.push_back((uint8_t)(n >> 16));
        }
        for (const BoolEncoder& p : parts) out.insert(out.end(), p.out.begin(), p.out.end());
        return out;
    }

    // the sub-block modes of macroblock (mb_x, mb_y), each coded under the
    // modes above and to the left of it
    void put_i4_modes(BoolEncoder& bw, int mb_x, int mb_y) {
        const int mb_w = src.mb_w;
        const EncMB& mb = mbs[(size_t)mb_y * mb_w + mb_x];
        auto mode_at = [&](int mx, int my, int n) -> int {
            if (mx < 0 || my < 0) return B_DC;
            const EncMB& o = mbs[(size_t)my * mb_w + mx];
            return o.is_i4 ? o.modes[n] : o.modes[0];
        };
        for (int n = 0; n < 16; ++n) {
            const int x = n & 3, y = n >> 2;
            const int top = y > 0 ? mb.modes[n - 4] : mode_at(mb_x, mb_y - 1, 12 + x);
            const int left = x > 0 ? mb.modes[n - 1] : mode_at(mb_x - 1, mb_y, 4 * y + 3);
            const TreePath& t = kModePaths.p[mb.modes[n]];
            const uint8_t* prob = kBModesProba[top][left];
            for (int k = 0; k < t.len; ++k) bw.put(t.bit[k], prob[t.node[k]]);
        }
    }

    // the decoder's loop filter over the reconstruction, at `level`
    void filter_rec(Planes& p, int lvl) const {
        const int mb_w = p.mb_w, mb_h = p.mb_h;
        FilterInfo f[2];
        for (int i4 = 0; i4 < 2; ++i4) {
            f[i4] = filter_info(lvl + (i4 ? opt.mode_lf_delta : 0), opt.sharpness);
            f[i4].inner = i4;
        }
        for (int mb_y = 0; mb_y < mb_h; ++mb_y)
            for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
                const EncMB& mb = mbs[(size_t)mb_y * mb_w + mb_x];
                FilterInfo fi = f[mb.is_i4];
                fi.inner = fi.inner || mb.coded;
                filter_mb(p, mb_x, mb_y, fi, opt.simple_filter);
            }
    }

    // squared error of the visible part of `p` against the source
    int64_t frame_sse(const Planes& p) const {
        int64_t e = 0;
        auto plane = [&](const std::vector<uint8_t>& a, const std::vector<uint8_t>& b,
                         int stride, int pw, int ph) {
            for (int y = 0; y < ph; ++y)
                for (int x = 0; x < pw; ++x) {
                    const int d = a[(size_t)y * stride + x] - b[(size_t)y * stride + x];
                    e += d * d;
                }
        };
        plane(p.y, src.y, p.ys(), w, h);
        plane(p.u, src.u, p.uvs(), (w + 1) / 2, (h + 1) / 2);
        plane(p.v, src.v, p.uvs(), (w + 1) / 2, (h + 1) / 2);
        return e;
    }

    // the loop-filter level: of 0, half, all and 1.5x the quantizer's
    // level, the one whose filtered reconstruction is nearest the source
    void choose_level() {
        const int base = level;
        int64_t best = -1;
        for (const int cand : {base, 0, base / 2, std::min(63, base * 3 / 2)}) {
            Planes f = rec;
            if (cand > 0) filter_rec(f, cand);
            const int64_t e = frame_sse(f);
            if (best < 0 || e < best) best = e, level = cand;
        }
    }

    std::vector<uint8_t> encode(const uint8_t* px, int width, int height, int channels) {
        w = width, h = height;
        import_planes(px, w, h, channels, src);
        setup();
        analyse();
        choose_level();
        choose_proba();
        return write();
    }
};

// ------------------------------------------------------------- container

void append_le32(std::vector<uint8_t>& out, uint32_t v) {
    for (int k = 0; k < 4; ++k) out.push_back((uint8_t)(v >> (8 * k)));
}

void append_chunk(std::vector<uint8_t>& out, const char* fourcc, const std::vector<uint8_t>& data) {
    out.insert(out.end(), fourcc, fourcc + 4);
    append_le32(out, (uint32_t)data.size());
    out.insert(out.end(), data.begin(), data.end());
    if (data.size() & 1) out.push_back(0);
}

// the chunks -> a RIFF/WEBP file, malloc'd
uint8_t* riff_file(const std::vector<uint8_t>& chunks, size_t* out_len) {
    std::vector<uint8_t> out = {'R', 'I', 'F', 'F'};
    append_le32(out, 4 + (uint32_t)chunks.size());
    out.insert(out.end(), {'W', 'E', 'B', 'P'});
    out.insert(out.end(), chunks.begin(), chunks.end());
    auto* buf = static_cast<uint8_t*>(std::malloc(out.size()));
    if (!buf) return nullptr;
    std::memcpy(buf, out.data(), out.size());
    *out_len = out.size();
    return buf;
}

}  // namespace

extern "C" {

void fl_free(void* ptr) { std::free(ptr); }

// a WebP file -> [h, w, ch] uint8 (ch 4 iff the file carries alpha, as
// libwebp's WebPGetFeatures says), malloc'd; null with *status 1 for a
// damaged file, 2 for an animation, and *reason naming the fault
uint8_t* fl_webp_decode(const uint8_t* data, size_t len, int* width, int* height, int* channels,
                        int* status, const char** reason) {
    *status = 1;
    auto fail = [&](const char* why) -> uint8_t* {
        *reason = why;
        return nullptr;
    };
    if (!data || len < 20 || std::memcmp(data, "RIFF", 4) || std::memcmp(data + 8, "WEBP", 4))
        return fail("not a RIFF/WEBP file");
    const size_t end = std::min(len, (size_t)le32(data + 4) + 8);
    bool vp8x = false, vp8x_alpha = false;
    int canvas_w = 0, canvas_h = 0;
    const uint8_t* alph = nullptr;
    size_t alph_len = 0;
    const uint8_t* body = nullptr;
    size_t body_len = 0;
    bool lossless = false;
    for (size_t pos = 12; pos + 8 <= end;) {
        const uint8_t* c = data + pos;
        const size_t clen = le32(c + 4);
        if (pos + 8 + clen > end) return fail("a chunk runs past the file");
        if (!std::memcmp(c, "VP8X", 4) && clen >= 10) {
            vp8x = true;
            vp8x_alpha = (c[8] & 0x10) != 0;
            canvas_w = (int)le24(c + 12) + 1;
            canvas_h = (int)le24(c + 15) + 1;
            if (c[8] & 0x02) {  // animation
                *status = 2;
                return fail("an animation");
            }
        } else if (!std::memcmp(c, "ANIM", 4) || !std::memcmp(c, "ANMF", 4)) {
            *status = 2;
            return fail("an animation");
        } else if (!std::memcmp(c, "ALPH", 4)) {
            if (!alph) alph = c + 8, alph_len = clen;
        } else if (!std::memcmp(c, "VP8 ", 4) || !std::memcmp(c, "VP8L", 4)) {
            body = c + 8;
            body_len = clen;
            lossless = c[3] == 'L';
            break;
        }
        pos += 8 + clen + (clen & 1);
    }
    if (!body) return fail("no VP8 or VP8L chunk");
    int w = 0, h = 0, nch = 3;
    uint8_t* out = nullptr;
    if (lossless) {
        bool alpha = false;
        std::vector<uint32_t> px;
        if (!webp_lossless::decode_chunk(body, body_len, w, h, alpha, px))
            return fail("a damaged VP8L stream");
        if (vp8x && (w != canvas_w || h != canvas_h)) return fail("the canvas is not the image's size");
        nch = (vp8x ? vp8x_alpha : alpha) ? 4 : 3;
        out = static_cast<uint8_t*>(std::malloc((size_t)w * h * nch));
        if (!out) return fail("out of memory");
        for (size_t i = 0; i < px.size(); ++i) {
            uint8_t* o = out + i * nch;
            o[0] = (uint8_t)(px[i] >> 16), o[1] = (uint8_t)(px[i] >> 8), o[2] = (uint8_t)px[i];
            if (nch == 4) o[3] = (uint8_t)(px[i] >> 24);
        }
    } else {
        Vp8Decoder dec;
        if (!dec.decode(body, body_len)) return fail(dec.error);
        w = dec.hdr.width, h = dec.hdr.height;
        if (vp8x && (w != canvas_w || h != canvas_h)) return fail("the canvas is not the image's size");
        // ALPH counts only in an extended file, as libwebp reads it
        if (!vp8x) alph = nullptr;
        nch = (vp8x_alpha || alph) ? 4 : 3;
        std::vector<uint8_t> alpha;
        if (alph && !decode_alpha(alph, alph_len, w, h, alpha)) return fail("a damaged ALPH chunk");
        out = static_cast<uint8_t*>(std::malloc((size_t)w * h * nch));
        if (!out) return fail("out of memory");
        planes_to_rgb(dec.planes, w, h, out, nch);
        if (nch == 4)
            for (size_t i = 0; i < (size_t)w * h; ++i) out[i * 4 + 3] = alph ? alpha[i] : 255;
    }
    *width = w, *height = h, *channels = nch, *status = 0;
    return out;
}

// the quantizer index the lossy encoder takes for `quality`
int fl_webp_qindex(int quality) { return quality_to_qindex(quality); }

// [h, w, channels] uint8 (channels 3 or 4) -> a WebP file, malloc'd, its
// size in *out_len; null on bad arguments. lossless: one VP8L chunk.
// Lossy: a "VP8 " chunk at `quality` (0-100), after VP8X and ALPH when an
// alpha value is below 255. simple_filter, sharpness (0-7),
// partitions_log2 (0-3) and mode_lf_delta (-63..63, the loop-filter delta
// of sub-block macroblocks) set the bitstream's options.
uint8_t* fl_webp_encode(const uint8_t* pixels, int w, int h, int channels, int quality, int lossless,
                        int simple_filter, int sharpness, int partitions_log2, int mode_lf_delta,
                        size_t* out_len) {
    if (!pixels || w < 1 || h < 1 || w > 16383 || h > 16383 || (channels != 3 && channels != 4) ||
        sharpness < 0 || sharpness > 7 || partitions_log2 < 0 || partitions_log2 > 3 ||
        mode_lf_delta < -63 || mode_lf_delta > 63)
        return nullptr;
    std::vector<uint8_t> chunks;
    if (lossless) {
        append_chunk(chunks, "VP8L", webp_lossless::encode_chunk(pixels, w, h, channels));
        return riff_file(chunks, out_len);
    }
    const size_t n = (size_t)w * h;
    std::vector<uint8_t> alpha;
    if (channels == 4) {
        alpha.resize(n);
        bool used = false;
        for (size_t i = 0; i < n; ++i) used |= (alpha[i] = pixels[4 * i + 3]) != 255;
        if (!used) alpha.clear();
    }
    Vp8Encoder enc;
    enc.opt.quality = quality;
    enc.opt.simple_filter = simple_filter != 0;
    enc.opt.sharpness = sharpness;
    enc.opt.partitions_log2 = partitions_log2;
    enc.opt.mode_lf_delta = mode_lf_delta;
    const std::vector<uint8_t> frame = enc.encode(pixels, w, h, channels);
    if (!alpha.empty()) {
        std::vector<uint8_t> vp8x(10, 0);
        vp8x[0] = 0x10;  // alpha
        for (int k = 0; k < 3; ++k) {
            vp8x[4 + k] = (uint8_t)((w - 1) >> (8 * k));
            vp8x[7 + k] = (uint8_t)((h - 1) >> (8 * k));
        }
        append_chunk(chunks, "VP8X", vp8x);
        std::vector<uint8_t> alph = {1};  // compression 1 (VP8L), no filter
        const std::vector<uint8_t> stream = webp_lossless::encode_alpha(alpha.data(), w, h);
        alph.insert(alph.end(), stream.begin(), stream.end());
        append_chunk(chunks, "ALPH", alph);
    }
    append_chunk(chunks, "VP8 ", frame);
    return riff_file(chunks, out_len);
}

}  // extern "C"
