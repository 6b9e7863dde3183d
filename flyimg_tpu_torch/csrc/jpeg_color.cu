// K19: upsampling and colour conversion of a batch of JPEG decodes to
// interleaved RGB, one launch for every pixel of every member.
//
// Replaces what libjpeg-turbo does after the IDCT inside
// jpeg_read_scanlines under the JAX package's fc_jpeg_decode and
// fc_jpeg_decode_roi (flyimg_tpu/codecs/native/fastcodec.cpp), and that
// function's own CMYK fold:
//
//   - jdsample.c, with do_fancy_upsampling on: h2v1_fancy_upsample
//     ((3 * near + far + 1 or 2) >> 2 across a row), h1v2_fancy_upsample
//     (the same down a column, bias 1 above and 2 below) and
//     h2v2_fancy_upsample (column sums 3 * near + far, then
//     (3 * this + neighbour + 8 or 7) >> 4), the first and last column
//     and row replicated (jdmainct.c's context rows); fullsize_upsample;
//     and replication (h2v1_upsample, h2v2_upsample, int_upsample) for the
//     other integer ratios and for planes of 2 columns or fewer;
//   - jdcolor.c: ycc_rgb_convert's fixed-point tables (Cr -> R, Cb -> B
//     rounded, G's two terms scaled by 2^16), gray_rgb_convert,
//     rgb_rgb_convert, ycck_cmyk_convert, each clamped by range_limit;
//   - fastcodec.cpp's CMYK -> RGB: c * k / 255 where the file is
//     Adobe-inverted or YCCK, else (255 - c) * (255 - k) / 255.
//
// The member table (K19Member) gives each member's window (its frame row
// y0, since the upsampler's rows are the frame's), colour space and, for
// each component, its plane (K18's output: the component's scaled
// samples from block row row0 / scale and the window's first block
// column), the columns the upsampler sees (dw: a window decode's
// jpeg_crop_scanline width, whose last column replicates as libjpeg-turbo's
// does), the plane's height (dh, the bottom edge) and its method. The
// plain version is codecs/jpeg_dec_plain.py k19, held to this kernel bit
// for bit.
//
// What bounds it on an H100: bytes: a pixel reads 1-4 component samples
// (at 4:2:0 1.5 bytes) and writes 3. Design: a tile table built on the
// host (codecs/jpeg_dec.py color_tiles), a row a strip of one member: the
// frame rows of one chroma row pair (one row at a window's odd edge) by up
// to kMaxCols columns. Persistent CTAs of 128 threads walk the strips, two
// at a time: while a strip is worked, the next one's source rows (with the
// rows above and below and the columns beside them that the fancy filters
// read) come into the other half of shared memory by cp.async as whole
// 16-byte chunks, and the strip's fields (from its member's row of the
// table) into shared memory once. A thread makes 8 consecutive
// pixels, reading the staged rows a word at a time: a body for each common
// case (YCbCr with full, h2v1, h1v2 or h2v2 chroma; gray; RGB), chosen
// once a strip, each chroma column sum shared by the pixels beside it; one
// generic body, a pixel at a time, for CMYK, YCCK, replication and mixed
// methods. The thread's 24 bytes of RGB go straight to the output from
// registers, as three 8-byte or six 4-byte stores where the row's
// alignment allows (bytes otherwise, and at a row's end): a warp writes
// 768 contiguous bytes. Staging the RGB in shared memory for 16-byte
// stores cost more than it saved at every timed shape (a barrier, the
// shared-memory round trip and the shifts to the output's alignment), so
// the rows do not go through it.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

// 64-bit fields: a batch's planes, pixels and output bytes may pass 2^31
struct K19Comp {
  long long plane, pitch, row0, dw, dh, method, hx, vx;
};

// a row of the member table (codecs/jpeg_dec_plain.py MEM_*)
struct K19Member {
  long long out, w, h, y0, color, inverted, ncomp, first;
  K19Comp comp[4];
};

// a row of the tile table (codecs/jpeg_dec.py COLOR_TILE): a strip of
// frame rows y.. (to the end of y's row pair or of the window) and window
// columns x0..x0 + nw - 1 of one member
struct __align__(16) K19Tile {
  int member, y, x0, nw;
};

namespace {

constexpr int kThreads = 128;
constexpr int kMinCtas = 8;
constexpr int kPx = 8;           // consecutive pixels a thread
constexpr int kMaxCols = 512;    // a strip's columns at most: 64 threads a row
static_assert(kMaxCols == kThreads / 2 * kPx, "codecs/jpeg_dec.py COLOR_STRIP_COLS");
constexpr int kSlots = 12;       // staged source rows: 3 a component
constexpr int kSlot = 560;       // a staged row's bytes: 15 of alignment, kMaxCols columns,
                                 // the columns beside and a group's overreach
constexpr int kStage = kSlots * kSlot;

enum { kFull = 0, kH2V1 = 1, kH1V2 = 2, kH2V2 = 3, kReplicate = 4 };
enum { kGray = 0, kYcc = 1, kRgb = 2, kCmyk = 3, kYcck = 4 };
// the bodies: YCbCr with each chroma method (0-3), then these
enum { kGrayBody = 4, kRgbBody = 5, kGeneric = 6 };

// a strip's fields in shared memory, from its member's row
struct Strip {
  const uint8_t* src[kSlots];  // staged row s: its first 16-byte chunk in the planes,
  int nch[kSlots];             // its chunks,
  int bias[kSlots];            // column c at stage[bias[s] + c]
  int method[4], dw[4], hx[4];
  long long out;               // the strip's first pixel's byte
  int rowbytes;                // the member's RGB bytes a row
  int nr, body, color, inverted, ncomp;
};

__device__ __forceinline__ int clamp255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

// the strip's fields and its staged rows, from its member's row m: the
// slots on warp 0, the components' and the member's fields on warp 1, so
// that the two run at once. Slot s = 3 * component + j holds frame row y (j 0)
// and the strip's last row (j 1) of a full-height component, y / vx and
// the last row's of a replicated one, and of a vertically fancy one the
// row pair's source row (j 1) and the rows above (j 0) and below (j 2),
// clamped at the plane's edges as jdsample.c's context rows are.
// Columns: the strip's, and each side's neighbour for the horizontal
// filters (the left clamped at 0, the right at dw - 1).
__device__ __forceinline__ void setup(const uint8_t* __restrict__ planes,
                                      const K19Member* __restrict__ mems, const K19Tile& t,
                                      Strip& s) {
  const int tid = threadIdx.x;
  if (tid >= kSlots && (tid < 32 || tid > 36)) return;
  const K19Member& m = mems[t.member];
  const int ncomp = static_cast<int>(m.ncomp);
  const int end = static_cast<int>(m.y0 + m.h), pair = 2 - (t.y & 1);
  const int nr = end - t.y < pair ? end - t.y : pair;
  if (tid < kSlots) {
    const int c = tid / 3, j = tid - 3 * c;
    const K19Comp& p = m.comp[c];
    const long long plane = p.plane, pitch = p.pitch, row0 = p.row0;
    const int dw = static_cast<int>(p.dw), dh = static_cast<int>(p.dh);
    const int method = static_cast<int>(p.method), hx = static_cast<int>(p.hx),
              vx = static_cast<int>(p.vx);
    const bool vfancy = method == kH1V2 || method == kH2V2;
    const bool hfancy = method == kH2V1 || method == kH2V2;
    const int xe = t.x0 + t.nw - 1, near = t.y >> 1;
    int row = j == 0 ? t.y : t.y + nr - 1, cl = t.x0, ch = xe;
    if (vfancy) row = j == 0 ? max(near - 1, 0) : (j == 1 ? near : min(near + 1, dh - 1));
    if (hfancy) {
      cl = max((t.x0 >> 1) - 1, 0);
      ch = max(xe >> 1, min((xe >> 1) + 1, dw - 1));
    }
    if (method == kReplicate) {
      row /= vx;
      cl /= hx;
      ch /= hx;
    }
    const uint8_t* src = planes;
    int nch = 0, bias = 0;
    if (c < ncomp && (j < 2 || vfancy)) {
      const uint8_t* a = planes + plane + (row - row0) * pitch + cl;
      src = a - (reinterpret_cast<uintptr_t>(a) & 15);
      nch = static_cast<int>((a + (ch - cl + 1) - src + 15) >> 4);
      bias = tid * kSlot + static_cast<int>(a - src) - cl;
    }
    s.src[tid] = src;
    s.nch[tid] = nch;
    s.bias[tid] = bias;
  } else if (tid < 36) {
    const int c = tid - 32;
    const K19Comp& p = m.comp[c];
    s.method[c] = static_cast<int>(p.method);
    s.dw[c] = static_cast<int>(p.dw);
    s.hx[c] = static_cast<int>(p.hx);
  } else {
    const int color = static_cast<int>(m.color);
    const int m0 = static_cast<int>(m.comp[0].method), m1 = static_cast<int>(m.comp[1].method),
              m2 = static_cast<int>(m.comp[2].method);
    s.nr = nr;
    s.color = color;
    s.inverted = static_cast<int>(m.inverted);
    s.ncomp = ncomp;
    s.rowbytes = static_cast<int>(m.w) * 3;
    s.out = m.out + ((t.y - m.y0) * m.w + t.x0) * 3;
    int body = kGeneric;
    if (color == kYcc && ncomp == 3 && m0 == kFull && m1 == m2 && m1 != kReplicate)
      body = m1;
    else if (color == kGray && ncomp == 1 && m0 == kFull)
      body = kGrayBody;
    else if (color == kRgb && ncomp == 3 && m0 == kFull && m1 == kFull && m2 == kFull)
      body = kRgbBody;
    s.body = body;
  }
}

// the strip's staged rows into st (cp.async, 16 bytes a copy): a third of
// the CTA a slot, three slots at a time
__device__ __forceinline__ void stage(uint8_t* st, const Strip& s) {
  constexpr int kTeam = kThreads / 3;
  static_assert(kTeam >= kSlot / 16, "a team copies a slot in one pass");
  const int team = threadIdx.x / kTeam, k = threadIdx.x - team * kTeam;
  if (team < 3)
    for (int sl = team; sl < kSlots; sl += 3)
      if (k < s.nch[sl])
        __pipeline_memcpy_async(st + sl * kSlot + k * 16, s.src[sl] + k * 16, 16);
}

// the 8 bytes at p (any alignment) as two little-endian words: three
// aligned word loads, funnel-shifted
__device__ __forceinline__ uint2 load8(const uint8_t* p) {
  const unsigned* w = reinterpret_cast<const unsigned*>(p - (reinterpret_cast<uintptr_t>(p) & 3));
  const unsigned sh = static_cast<unsigned>(reinterpret_cast<uintptr_t>(p) & 3) * 8;
  const unsigned a = w[0], b = w[1], c = w[2];
  return make_uint2(__funnelshift_r(a, b, sh), __funnelshift_r(b, c, sh));
}

// byte i of the 8 (one byte permute)
__device__ __forceinline__ int byte_of(const uint2& v, int i) {
  return static_cast<int>(__byte_perm(i < 4 ? v.x : v.y, 0, 0x4440 + (i & 3)));
}

// component c's 8 samples at window columns x.. of frame row y (the
// strip's row rr), method M: jdsample.c's arithmetic on the staged rows
template <int M>
__device__ __forceinline__ void comp8(const uint8_t* __restrict__ st, const Strip& s, int c,
                                      int x, int y, int rr, int (&v)[kPx]) {
  if constexpr (M == kFull) {
    const uint2 p = load8(st + s.bias[3 * c + rr] + x);
#pragma unroll
    for (int i = 0; i < kPx; ++i) v[i] = byte_of(p, i);
  } else if constexpr (M == kH1V2) {
    const bool below = y & 1;
    const uint2 n = load8(st + s.bias[3 * c + 1] + x);
    const uint2 f = load8(st + s.bias[3 * c + (below ? 2 : 0)] + x);
#pragma unroll
    for (int i = 0; i < kPx; ++i) v[i] = (3 * byte_of(n, i) + byte_of(f, i) + (below ? 2 : 1)) >> 2;
  } else {
    // h2v1 on the row, h2v2 on column sums 3 * near + far; a pixel's own
    // column is x >> 1, its neighbour the column beside it away from the
    // pixel's centre, clamped at 0 on the left and dw - 1 on the right.
    // q: the columns from x / 2 - 1 on, r: each right neighbour.
    const int cx = x >> 1, dw = s.dw[c];
    const uint8_t* n = st + s.bias[3 * c + (M == kH2V1 ? rr : 1)];
    const uint8_t* f = st + s.bias[3 * c + ((y & 1) ? 2 : 0)];
    constexpr int kHalf = kPx / 2;  // the pixels' own columns
    int q[kHalf + 1], r[kHalf];
    if (cx >= 1 && cx + kHalf < dw) {
      // no clamp: the columns as words
      const uint2 nn = load8(n + cx - 1), ff = load8(f + cx - 1);
      int sum[kHalf + 2];
#pragma unroll
      for (int k = 0; k < kHalf + 2; ++k)
        sum[k] = M == kH2V1 ? byte_of(nn, k) : 3 * byte_of(nn, k) + byte_of(ff, k);
#pragma unroll
      for (int k = 0; k <= kHalf; ++k) q[k] = sum[k];
#pragma unroll
      for (int k = 0; k < kHalf; ++k) r[k] = sum[k + 2];
    } else {
      auto sum = [&](int col) { return M == kH2V1 ? n[col] : 3 * n[col] + f[col]; };
      q[0] = sum(cx > 0 ? cx - 1 : 0);
#pragma unroll
      for (int k = 0; k < kHalf; ++k) {
        q[k + 1] = sum(cx + k);
        r[k] = sum(cx + k + 1 < dw ? cx + k + 1 : dw - 1);
      }
    }
    // a pixel pair shares its own column's 3 * sum
#pragma unroll
    for (int k = 0; k < kHalf; ++k) {
      const int here = 3 * q[1 + k];
      if (M == kH2V1) {
        v[2 * k] = (here + q[k] + 1) >> 2;
        v[2 * k + 1] = (here + r[k] + 2) >> 2;
      } else {
        v[2 * k] = (here + q[k] + 8) >> 4;
        v[2 * k + 1] = (here + r[k] + 7) >> 4;
      }
    }
  }
}

// jdcolor.c build_ycc_rgb_table, computed in place of its tables (the
// -128 of Cb and Cr folded into the constants), added to Y
__device__ __forceinline__ void ycc_rgb(int y, int cb, int cr, int& r, int& g, int& b) {
  r = y + ((91881 * cr - 91881 * 128 + 32768) >> 16);
  g = y + ((-22554 * cb - 46802 * cr + (22554 + 46802) * 128 + 32768) >> 16);
  b = y + ((116130 * cb - 116130 * 128 + 32768) >> 16);
}

// n (at most 8) pixels' RGB to the output at o: a complete group as three
// 8-byte or six 4-byte stores where o's alignment allows (a row's
// alignment holds for all its groups), else bytes
__device__ __forceinline__ void put(uint8_t* o, int n, const int (&r)[kPx], const int (&g)[kPx],
                                    const int (&b)[kPx]) {
  constexpr int kWords = 3 * kPx / 4;
  unsigned w[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    unsigned v[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int j = 4 * k + m, px = j / 3, ch = j % 3;
      v[m] = static_cast<unsigned>(ch == 0 ? r[px] : (ch == 1 ? g[px] : b[px]));
    }
    // four low bytes into a word: three byte permutes
    w[k] = __byte_perm(__byte_perm(v[0], v[1], 0x0040), __byte_perm(v[2], v[3], 0x0040), 0x5410);
  }
  const unsigned align = static_cast<unsigned>(reinterpret_cast<uintptr_t>(o) & 7);
  if (n == kPx && align == 0) {
#pragma unroll
    for (int k = 0; k < kWords; k += 2)
      reinterpret_cast<uint2*>(o)[k / 2] = make_uint2(w[k], w[k + 1]);
  } else if (n == kPx && (align & 3) == 0) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) reinterpret_cast<unsigned*>(o)[k] = w[k];
  } else {
#pragma unroll
    for (int j = 0; j < 4 * kWords; ++j)
      if (j < 3 * n) o[j] = static_cast<uint8_t>(w[j >> 2] >> (8 * (j & 3)));
  }
}

template <int Body>
__device__ __forceinline__ void pixels(const uint8_t* __restrict__ st, const Strip& s, int x,
                                       int y, int rr, int n, uint8_t* o) {
  int r[kPx], g[kPx], b[kPx];
  if constexpr (Body <= kH2V2) {
    int lum[kPx], cb[kPx], cr[kPx];
    comp8<kFull>(st, s, 0, x, y, rr, lum);
    comp8<Body>(st, s, 1, x, y, rr, cb);
    comp8<Body>(st, s, 2, x, y, rr, cr);
#pragma unroll
    for (int i = 0; i < kPx; ++i) {
      int yr, yg, yb;
      ycc_rgb(lum[i], cb[i], cr[i], yr, yg, yb);
      r[i] = clamp255(yr);
      g[i] = clamp255(yg);
      b[i] = clamp255(yb);
    }
  } else if constexpr (Body == kGrayBody) {
    comp8<kFull>(st, s, 0, x, y, rr, r);
#pragma unroll
    for (int i = 0; i < kPx; ++i) g[i] = b[i] = r[i];
  } else {  // kRgbBody
    comp8<kFull>(st, s, 0, x, y, rr, r);
    comp8<kFull>(st, s, 1, x, y, rr, g);
    comp8<kFull>(st, s, 2, x, y, rr, b);
  }
  put(o, n, r, g, b);
}

// component c upsampled at window column x of frame row y (the strip's row
// rr), any method (the plain version's arithmetic, a pixel at a time)
__device__ __forceinline__ int upsampled(const uint8_t* __restrict__ st, const Strip& s, int c,
                                         int x, int y, int rr) {
  const int dw = s.dw[c];
  const uint8_t* row = st + s.bias[3 * c + rr];
  const bool below = y & 1;
  const uint8_t* n = st + s.bias[3 * c + 1];
  const uint8_t* f = st + s.bias[3 * c + (below ? 2 : 0)];
  const int col = x >> 1;
  const bool odd = x & 1;
  const int nb = odd ? min(col + 1, dw - 1) : max(col - 1, 0);
  switch (s.method[c]) {
    case kFull:
      return row[x];
    case kReplicate:
      return row[x / s.hx[c]];
    case kH2V1:
      return (3 * row[col] + row[nb] + (odd ? 2 : 1)) >> 2;
    case kH1V2:
      return (3 * n[x] + f[x] + (below ? 2 : 1)) >> 2;
    default:  // kH2V2
      return (3 * (3 * n[col] + f[col]) + 3 * n[nb] + f[nb] + (odd ? 7 : 8)) >> 4;
  }
}

// the generic body: CMYK, YCCK, replication, mixed methods
__device__ __forceinline__ void pixels_generic(const uint8_t* __restrict__ st, const Strip& s,
                                               int x, int y, int rr, int npx, uint8_t* o) {
  const int color = s.color, ncomp = s.ncomp;
  for (int i = 0; i < npx; ++i) {
    int v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = k < ncomp ? upsampled(st, s, k, x + i, y, rr) : 0;
    int r, g, b;
    if (color == kGray) {
      r = g = b = v[0];
    } else if (color == kRgb) {
      r = v[0], g = v[1], b = v[2];
    } else {
      int yr, yg, yb;
      ycc_rgb(v[0], v[1], v[2], yr, yg, yb);
      if (color == kYcc) {
        r = clamp255(yr), g = clamp255(yg), b = clamp255(yb);
      } else {
        // fastcodec.cpp's CMYK fold (YCCK: jdcolor.c ycck_cmyk_convert first)
        int c0 = v[0], c1 = v[1], c2 = v[2];
        if (color == kYcck) {
          c0 = clamp255(255 - yr);
          c1 = clamp255(255 - yg);
          c2 = clamp255(255 - yb);
        }
        const int k = v[3];
        if (s.inverted) {
          r = c0 * k / 255, g = c1 * k / 255, b = c2 * k / 255;
        } else {
          r = (255 - c0) * (255 - k) / 255, g = (255 - c1) * (255 - k) / 255,
          b = (255 - c2) * (255 - k) / 255;
        }
      }
    }
    o[3 * i] = static_cast<uint8_t>(r);
    o[3 * i + 1] = static_cast<uint8_t>(g);
    o[3 * i + 2] = static_cast<uint8_t>(b);
  }
}

__global__ void __launch_bounds__(kThreads, kMinCtas)
color_kernel(const uint8_t* __restrict__ planes, const K19Member* __restrict__ mems,
             const K19Tile* __restrict__ tiles, int ntiles, uint8_t* __restrict__ out) {
  __shared__ __align__(16) uint8_t st[2][kStage];     // the strips' staged source rows
  __shared__ Strip ss[3];  // the strips' fields: this one's, the next one's and the one
                           // before, which slower warps may still read
  const int tid = threadIdx.x, grid = gridDim.x;
  const int rr = tid >> 6, xo = (tid & 63) * kPx;  // the thread's row and first column
  int t = blockIdx.x;  // the grid is at most the tiles: every CTA has one
  K19Tile cur = tiles[t];
  setup(planes, mems, cur, ss[0]);
  __syncthreads();
  stage(st[0], ss[0]);
  __pipeline_commit();
  K19Tile next = t + grid < ntiles ? tiles[t + grid] : cur;
  for (int k = 0; t < ntiles; ++k, t += grid) {
    const int buf = k & 1, now_s = k % 3, next_s = (k + 1) % 3;
    const bool more = t + grid < ntiles;
    // the next strip's fields and copies go out before this one is worked
    if (more) setup(planes, mems, next, ss[next_s]);
    __syncthreads();
    if (more) stage(st[buf ^ 1], ss[next_s]);
    __pipeline_commit();
    const K19Tile now = cur;
    cur = next;
    if (t + 2 * grid < ntiles) next = tiles[t + 2 * grid];  // read meanwhile
    __pipeline_wait_prior(1);
    __syncthreads();
    const Strip& s = ss[now_s];
    if (rr < s.nr && xo < now.nw) {
      const int x = now.x0 + xo, y = now.y + rr, n = now.nw - xo < kPx ? now.nw - xo : kPx;
      uint8_t* o = out + s.out + rr * s.rowbytes + xo * 3;
      switch (s.body) {
        case kFull: pixels<kFull>(st[buf], s, x, y, rr, n, o); break;
        case kH2V1: pixels<kH2V1>(st[buf], s, x, y, rr, n, o); break;
        case kH1V2: pixels<kH1V2>(st[buf], s, x, y, rr, n, o); break;
        case kH2V2: pixels<kH2V2>(st[buf], s, x, y, rr, n, o); break;
        case kGrayBody: pixels<kGrayBody>(st[buf], s, x, y, rr, n, o); break;
        case kRgbBody: pixels<kRgbBody>(st[buf], s, x, y, rr, n, o); break;
        default: pixels_generic(st[buf], s, x, y, rr, n, o); break;
      }
    }
  }
}

}  // namespace

// planes: K18's u8 planes on the card (its allocation rounded up to 16
// bytes: a staged row's last chunk may pass the last plane's end); mems:
// the K19Member rows; tiles: ntiles K19Tile rows (both 16-byte aligned);
// out: u8 RGB. Returns a CUDA error code (0 = launched).
extern "C" int flyimg_jpeg_color(const uint8_t* planes, const K19Member* mems,
                                 const K19Tile* tiles, int ntiles, uint8_t* out, void* stream) {
  if (ntiles < 1 || reinterpret_cast<uintptr_t>(tiles) % 16 ||
      reinterpret_cast<uintptr_t>(mems) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaFuncSetAttribute(color_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                         static_cast<int>(cudaSharedmemCarveoutMaxShared));
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, color_kernel, kThreads, 0);
    if (per_sm < 1) per_sm = 1;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long slots = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(ntiles < slots ? ntiles : slots);
  color_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(planes, mems, tiles,
                                                                         ntiles, out);
  return static_cast<int>(cudaGetLastError());
}
