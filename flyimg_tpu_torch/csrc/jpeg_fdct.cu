// K17: libjpeg's integer FDCT and quantization of u8 planes, one launch
// an encode.
//
// Replaces what libjpeg does inside jpeg_write_scanlines under the JAX
// package's fc_jpeg_encode (flyimg_tpu/codecs/native/fastcodec.cpp) and
// under Pillow's JPEG save in its _encode_cmyk_jpeg
// (flyimg_tpu/service/handler.py): jfdctint.c's jpeg_fdct_islow (the
// default DCT method; LL&M with 13-bit constants, two passes, results
// scaled by 8) and jcdctmgr.c's quantization as libjpeg-turbo does it, by
// reciprocal: q = sign(t) * (((|t| + corr) * recip) >> shift), with
// (recip, corr, shift) from compute_reciprocal(quantval * 8) on the host
// (jpeg_plain.divisor_rows). The planes come laid out on their block
// grids as libjpeg's preprocessing leaves them (the three YCbCr planes of
// a moz_0 encode, or the four inverted CMYK planes), one after another in
// one buffer. Output: int16 [blocks][64] zigzag, the planes' blocks
// row-major one after another (codecs/native/jpeg_writer.cpp's layout).
//
// All integer arithmetic (64-bit, as libjpeg's JLONG), so the order of
// operations is free and the result exact.
//
// What bounds it on an H100: bytes: 1 byte a sample in, 2 out (384
// bytes a block moved for ~700 integer operations). Design (simple
// first): a thread a block, its 64 samples read byte by byte, the DCT in
// a 64-entry array; the table words (reciprocals) come from the launch's
// parameter block.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxPlanes = 4;

// the launch's parameters (jpeg_enc._FdctParams mirrors it); at file scope,
// so the C entry below, which takes it, keeps external linkage
struct K17Params {
  int nplanes;
  int bw[kMaxPlanes];             // blocks a row
  int table[kMaxPlanes];          // quantization table of each plane
  int block_off[kMaxPlanes + 1];  // first block of each plane; [nplanes] = total
  long long plane_off[kMaxPlanes];
  unsigned recip[128];            // [table][natural index]
  unsigned corr[128];
  int shift[128];
};

namespace {

constexpr int kThreads = 128;

__constant__ int kZigzagToNat[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;

__device__ __forceinline__ long long descale(long long x, int n) {
  return (x + (1LL << (n - 1))) >> n;
}

// one pass of jpeg_fdct_islow over d[0], d[stride], ..., d[7 * stride]
__device__ __forceinline__ void islow_pass(long long* d, int stride, bool final_pass) {
  long long tmp0 = d[0] + d[7 * stride], tmp7 = d[0] - d[7 * stride];
  long long tmp1 = d[stride] + d[6 * stride], tmp6 = d[stride] - d[6 * stride];
  long long tmp2 = d[2 * stride] + d[5 * stride], tmp5 = d[2 * stride] - d[5 * stride];
  long long tmp3 = d[3 * stride] + d[4 * stride], tmp4 = d[3 * stride] - d[4 * stride];
  const long long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const long long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int shift;
  if (final_pass) {
    d[0] = descale(tmp10 + tmp11, kPass1Bits);
    d[4 * stride] = descale(tmp10 - tmp11, kPass1Bits);
    shift = kConstBits + kPass1Bits;
  } else {
    d[0] = (tmp10 + tmp11) * (1 << kPass1Bits);
    d[4 * stride] = (tmp10 - tmp11) * (1 << kPass1Bits);
    shift = kConstBits - kPass1Bits;
  }
  long long z1 = (tmp12 + tmp13) * 4433;
  d[2 * stride] = descale(z1 + tmp13 * 6270, shift);
  d[6 * stride] = descale(z1 + tmp12 * -15137, shift);
  z1 = tmp4 + tmp7;
  long long z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
  const long long z5 = (z3 + z4) * 9633;
  tmp4 *= 2446;
  tmp5 *= 16819;
  tmp6 *= 25172;
  tmp7 *= 12299;
  z1 *= -7373;
  z2 *= -20995;
  z3 = z3 * -16069 + z5;
  z4 = z4 * -3196 + z5;
  d[7 * stride] = descale(tmp4 + z1 + z3, shift);
  d[5 * stride] = descale(tmp5 + z2 + z4, shift);
  d[3 * stride] = descale(tmp6 + z2 + z3, shift);
  d[stride] = descale(tmp7 + z1 + z4, shift);
}

__global__ void __launch_bounds__(kThreads)
fdct_kernel(const uint8_t* __restrict__ planes, int16_t* __restrict__ out, K17Params p) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= p.block_off[p.nplanes]) return;
  int pl = 0;
  while (pl + 1 < p.nplanes && idx >= p.block_off[pl + 1]) ++pl;
  const int local = idx - p.block_off[pl];
  const int bw = p.bw[pl];
  const int brow = local / bw, bcol = local - brow * bw;
  const int pitch = bw * 8;
  const uint8_t* src = planes + p.plane_off[pl] + static_cast<size_t>(brow) * 8 * pitch + bcol * 8;
  long long d[64];
  for (int y = 0; y < 8; ++y) {
    for (int x = 0; x < 8; ++x) d[y * 8 + x] = static_cast<long long>(src[y * pitch + x]) - 128;
  }
  for (int y = 0; y < 8; ++y) islow_pass(d + y * 8, 1, false);
  for (int x = 0; x < 8; ++x) islow_pass(d + x, 8, true);
  const int t = p.table[pl] * 64;
  int16_t* dst = out + static_cast<size_t>(idx) * 64;
  for (int k = 0; k < 64; ++k) {
    const int n = kZigzagToNat[k];
    const long long v = d[n];
    const unsigned long long mag =
        ((static_cast<unsigned long long>(v < 0 ? -v : v) + p.corr[t + n]) * p.recip[t + n]) >>
        p.shift[t + n];
    dst[k] = static_cast<int16_t>(v < 0 ? -static_cast<long long>(mag) : static_cast<long long>(mag));
  }
}

}  // namespace

// planes: the planes' u8 samples one after another on the card; out:
// int16 [blocks][64]; params: the host's K17Params, copied into the
// launch. Returns a CUDA error code (0 = launched).
extern "C" int flyimg_jpeg_fdct(const uint8_t* planes, int16_t* out, const K17Params* params,
                                void* stream) {
  if (!params || params->nplanes < 1 || params->nplanes > kMaxPlanes)
    return static_cast<int>(cudaErrorInvalidValue);
  const K17Params p = *params;
  const int blocks = p.block_off[p.nplanes];
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  fdct_kernel<<<(blocks + kThreads - 1) / kThreads, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(planes, out, p);
  return static_cast<int>(cudaGetLastError());
}
