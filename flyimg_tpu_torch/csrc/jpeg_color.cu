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
// (up to 4 each for the fancy filters, mostly from L1) and writes 3 bytes.
// Design: a thread a pixel, grid-stride; a pixel finds its member by
// binary search over the members' first pixels.

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

namespace {

constexpr int kThreads = 256;
constexpr int kCtasPerSm = 8;

enum { kFull = 0, kH2V1 = 1, kH1V2 = 2, kH2V2 = 3, kReplicate = 4 };
enum { kGray = 0, kYcc = 1, kRgb = 2, kCmyk = 3, kYcck = 4 };

__device__ __forceinline__ int find_member(const K19Member* __restrict__ mems, int n,
                                           long long p) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (mems[mid].first <= p) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ int sample(const uint8_t* __restrict__ planes, const K19Comp& c,
                                      int row, int col) {
  return planes[static_cast<size_t>(c.plane) +
                static_cast<size_t>(row - static_cast<int>(c.row0)) *
                    static_cast<size_t>(c.pitch) +
                col];
}

// component c of the member at window column x, frame row y (a member's
// rows, columns and factors fit 32 bits)
__device__ __forceinline__ int upsampled(const uint8_t* __restrict__ planes, const K19Comp& c,
                                         int x, int y) {
  const int dw = static_cast<int>(c.dw), dh = static_cast<int>(c.dh);
  switch (static_cast<int>(c.method)) {
    case kFull:
      return sample(planes, c, y, x);
    case kReplicate:
      return sample(planes, c, y / static_cast<int>(c.vx), x / static_cast<int>(c.hx));
    case kH2V1: {
      const int col = x >> 1;
      const bool odd = x & 1;
      const int nb = odd ? min(col + 1, dw - 1) : max(col - 1, 0);
      return (3 * sample(planes, c, y, col) + sample(planes, c, y, nb) + (odd ? 2 : 1)) >> 2;
    }
    case kH1V2: {
      const int row = y >> 1;
      const bool below = y & 1;
      const int far = below ? min(row + 1, dh - 1) : max(row - 1, 0);
      return (3 * sample(planes, c, row, x) + sample(planes, c, far, x) + (below ? 2 : 1)) >> 2;
    }
    default: {  // kH2V2
      const int row = y >> 1;
      const bool below = y & 1;
      const int far = below ? min(row + 1, dh - 1) : max(row - 1, 0);
      const int col = x >> 1;
      const bool odd = x & 1;
      const int nb = odd ? min(col + 1, dw - 1) : max(col - 1, 0);
      const int cs = 3 * sample(planes, c, row, col) + sample(planes, c, far, col);
      const int ns = 3 * sample(planes, c, row, nb) + sample(planes, c, far, nb);
      return (3 * cs + ns + (odd ? 7 : 8)) >> 4;
    }
  }
}

__device__ __forceinline__ int clamp255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

__global__ void __launch_bounds__(kThreads)
color_kernel(const uint8_t* __restrict__ planes, const K19Member* __restrict__ mems, int nmem,
             long long total, uint8_t* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long p = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; p < total;
       p += stride) {
    const K19Member& m = mems[find_member(mems, nmem, p)];
    const int local = static_cast<int>(p - m.first);
    const int mw = static_cast<int>(m.w);
    const int yw = local / mw, x = local - yw * mw;
    const int y = static_cast<int>(m.y0) + yw;
    const int color = static_cast<int>(m.color), ncomp = static_cast<int>(m.ncomp);
    int v[4] = {0, 0, 0, 0};
    for (int k = 0; k < ncomp; ++k) v[k] = upsampled(planes, m.comp[k], x, y);
    int r, g, b;
    if (color == kGray) {
      r = g = b = v[0];
    } else if (color == kRgb) {
      r = v[0], g = v[1], b = v[2];
    } else {
      // jdcolor.c build_ycc_rgb_table, computed in place of its tables
      const int cb = v[1] - 128, cr = v[2] - 128;
      const int rr = v[0] + ((91881 * cr + 32768) >> 16);
      const int gg = v[0] + ((-22554 * cb + 32768 + -46802 * cr) >> 16);
      const int bb = v[0] + ((116130 * cb + 32768) >> 16);
      if (color == kYcc) {
        r = clamp255(rr), g = clamp255(gg), b = clamp255(bb);
      } else {
        int c0 = v[0], c1 = v[1], c2 = v[2];
        if (color == kYcck) {
          c0 = clamp255(255 - rr);
          c1 = clamp255(255 - gg);
          c2 = clamp255(255 - bb);
        }
        const int k = v[3];
        if (m.inverted) {
          r = c0 * k / 255, g = c1 * k / 255, b = c2 * k / 255;
        } else {
          r = (255 - c0) * (255 - k) / 255, g = (255 - c1) * (255 - k) / 255,
          b = (255 - c2) * (255 - k) / 255;
        }
      }
    }
    uint8_t* dst = out + static_cast<size_t>(m.out) + static_cast<size_t>(local) * 3;
    dst[0] = static_cast<uint8_t>(r);
    dst[1] = static_cast<uint8_t>(g);
    dst[2] = static_cast<uint8_t>(b);
  }
}

}  // namespace

// planes: K18's u8 planes on the card; mems: nmem K19Member rows on the
// card, in order of their first pixel; total: the pixels of all members;
// out: u8 RGB. Returns a CUDA error code (0 = launched).
extern "C" int flyimg_jpeg_color(const uint8_t* planes, const K19Member* mems, int nmem,
                                 long long total, uint8_t* out, void* stream) {
  if (nmem < 1 || total < 1) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long groups = (total + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(groups < sms * kCtasPerSm ? groups : sms * kCtasPerSm);
  color_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(planes, mems, nmem,
                                                                         total, out);
  return static_cast<int>(cudaGetLastError());
}
