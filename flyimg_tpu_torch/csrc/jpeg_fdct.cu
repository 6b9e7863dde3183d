// K17: libjpeg's integer FDCT and quantization of u8 planes, one launch
// an encode or a group of encodes (up to kMaxPlanes planes).
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
// a moz_0 encode, of each encode of a group, or the four inverted CMYK
// planes), one after another in one buffer; a block finds its plane by
// binary search over the planes' first blocks. Output: int16 [blocks][64]
// zigzag, the planes' blocks row-major one after another
// (codecs/native/jpeg_writer.cpp's layout).
//
// Integer arithmetic, so the order of operations is free and the result
// exact. 32 bits suffice: jfdctint.c picks CONST_BITS 13 and PASS1_BITS 2
// so that 8-bit samples keep every intermediate of both passes under 2^31
// (tests/test_torch_jpeg_encode.py carries each as a linear form in the
// 64 samples: at most 343,982,080), and (|t| + corr) * recip stays under
// 2^32 for every divisor and every |t| < 2^15 (the same test file).
//
// What bounds it on an H100: bytes: 1 byte a sample in, 2 out (192 bytes
// a block for ~700 integer operations); a 1920x1080 frame's three planes
// take 0.0056 ms at 3.35 TB/s. Design: 8 lanes a block, four blocks side
// by side a warp; lane r loads row r as one 8-byte load (a warp's row is
// 32 contiguous bytes), runs pass 1 on it in registers, the rows cross to
// columns through shared memory, lane c runs pass 2 on column c and
// quantizes its 8 outputs, and the zigzag goes through shared memory to
// one 16-byte store a lane. CTAs walk the blocks in a grid-stride loop,
// each lane loading its next row before it works the current one; the
// divisors come from a device buffer (the wrapper keeps one a table set),
// copied once into each CTA's shared memory with each column's 8 words
// side by side.

#include <cuda_runtime.h>
#include <stdint.h>

// the planes of a group of up to 32 three-component encodes in one launch
constexpr int kMaxPlanes = 96;

// the launch's parameters (jpeg_enc._FdctParams mirrors it); at file scope,
// so the C entry below, which takes it, keeps external linkage
struct K17Params {
  int nplanes;
  int bw[kMaxPlanes];             // blocks a row
  int table[kMaxPlanes];          // quantization table of each plane
  int block_off[kMaxPlanes + 1];  // first block of each plane; [nplanes] = total
  long long plane_off[kMaxPlanes];
};

namespace {

constexpr int kBlocks = 16;  // blocks a CTA works at a time, four a warp
constexpr int kThreads = kBlocks * 8;
constexpr int kCtasPerSm = 16;

// natural index -> zigzag position, in global memory: the lanes read it at
// different indices
__device__ const uint8_t kNatToZigzag[64] = {
    0,  1,  5,  6,  14, 15, 27, 28, 2,  4,  7,  13, 16, 26, 29, 42,
    3,  8,  12, 17, 25, 30, 41, 43, 9,  11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63};

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;

__device__ __forceinline__ int descale(int x, int n) { return (x + (1 << (n - 1))) >> n; }

// one pass of jpeg_fdct_islow over a row or a column held in registers
template <bool kFinal>
__device__ __forceinline__ void islow_pass(int (&d)[8]) {
  const int tmp0 = d[0] + d[7], tmp7 = d[0] - d[7];
  const int tmp1 = d[1] + d[6], tmp6 = d[1] - d[6];
  const int tmp2 = d[2] + d[5], tmp5 = d[2] - d[5];
  const int tmp3 = d[3] + d[4], tmp4 = d[3] - d[4];
  const int tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  constexpr int shift = kFinal ? kConstBits + kPass1Bits : kConstBits - kPass1Bits;
  if (kFinal) {
    d[0] = descale(tmp10 + tmp11, kPass1Bits);
    d[4] = descale(tmp10 - tmp11, kPass1Bits);
  } else {
    d[0] = (tmp10 + tmp11) * (1 << kPass1Bits);
    d[4] = (tmp10 - tmp11) * (1 << kPass1Bits);
  }
  const int z1 = (tmp12 + tmp13) * 4433;
  d[2] = descale(z1 + tmp13 * 6270, shift);
  d[6] = descale(z1 + tmp12 * -15137, shift);
  const int z1o = tmp4 + tmp7, z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
  const int z5 = (z3 + z4) * 9633;
  const int p1 = z1o * -7373, p2 = z2 * -20995;
  const int p3 = z3 * -16069 + z5, p4 = z4 * -3196 + z5;
  d[7] = descale(tmp4 * 2446 + p1 + p3, shift);
  d[5] = descale(tmp5 * 16819 + p2 + p4, shift);
  d[3] = descale(tmp6 * 25172 + p2 + p3, shift);
  d[1] = descale(tmp7 * 12299 + p1 + p4, shift);
}

__device__ __forceinline__ int plane_of(const K17Params& p, int b) {
  // the last plane whose first block is at or before b
  int lo = 0, hi = p.nplanes - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (p.block_off[mid] <= b) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// row r of block b: its 8 samples
__device__ __forceinline__ uint2 load_row(const uint8_t* __restrict__ planes, const K17Params& p,
                                          int b, int r) {
  const int pl = plane_of(p, b);
  const int local = b - p.block_off[pl];
  const int bw = p.bw[pl];
  const int brow = local / bw, bcol = local - brow * bw;
  const uint8_t* src = planes + p.plane_off[pl] +
                       (static_cast<size_t>(brow) * 8 + r) * bw * 8 + bcol * 8;
  return *reinterpret_cast<const uint2*>(src);
}

__global__ void __launch_bounds__(kThreads)
fdct_kernel(const uint8_t* __restrict__ planes, int16_t* __restrict__ out, K17Params p,
            const unsigned* __restrict__ div, int ntables) {
  // [table][recip, corr, shift][column][row]
  __shared__ __align__(16) unsigned sdiv[2][3][8][8];
  __shared__ uint8_t nat2zz[64];
  __shared__ int rows[kBlocks][8][9];
  __shared__ __align__(16) int16_t zz[kBlocks][64];
  __shared__ K17Params sp;  // indexed by plane below: not from the parameter space
  const int tid = threadIdx.x;
  if (tid == 0) sp = p;
  for (int i = tid; i < ntables * 48; i += kThreads)
    reinterpret_cast<uint4*>(&sdiv[0][0][0][0])[i] = reinterpret_cast<const uint4*>(div)[i];
  for (int i = tid; i < 64; i += kThreads) nat2zz[i] = kNatToZigzag[i];
  __syncthreads();

  const int lb = tid >> 3, r = tid & 7;  // block of the CTA's 16, row (then column)
  const int total = sp.block_off[sp.nplanes];
  const int stride = gridDim.x * kBlocks;
  int base = blockIdx.x * kBlocks;
  uint2 next = load_row(planes, sp, min(base + lb, total - 1), r);
  for (; base < total; base += stride) {
    const int idx = base + lb;
    const int b = min(idx, total - 1);  // past the end: the last block again, not stored
    const uint2 px = next;
    if (base + stride < total) next = load_row(planes, sp, min(idx + stride, total - 1), r);
    int d[8];
#pragma unroll
    for (int x = 0; x < 8; ++x)
      d[x] = static_cast<int>(((x < 4 ? px.x : px.y) >> (8 * (x & 3))) & 255) - 128;
    islow_pass<false>(d);
#pragma unroll
    for (int u = 0; u < 8; ++u) rows[lb][r][u] = d[u];
    __syncwarp();
#pragma unroll
    for (int y = 0; y < 8; ++y) d[y] = rows[lb][y][r];
    islow_pass<true>(d);
    // lane r now holds column r: natural indices v * 8 + r
    const int t = sp.table[plane_of(sp, b)];
    unsigned recip[8], corr[8], shift[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 a = reinterpret_cast<const uint4*>(sdiv[t][0][r])[h];
      const uint4 c = reinterpret_cast<const uint4*>(sdiv[t][1][r])[h];
      const uint4 s = reinterpret_cast<const uint4*>(sdiv[t][2][r])[h];
      recip[4 * h] = a.x, recip[4 * h + 1] = a.y, recip[4 * h + 2] = a.z, recip[4 * h + 3] = a.w;
      corr[4 * h] = c.x, corr[4 * h + 1] = c.y, corr[4 * h + 2] = c.z, corr[4 * h + 3] = c.w;
      shift[4 * h] = s.x, shift[4 * h + 1] = s.y, shift[4 * h + 2] = s.z, shift[4 * h + 3] = s.w;
    }
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int val = d[v];
      const unsigned mag = ((static_cast<unsigned>(val < 0 ? -val : val) + corr[v]) * recip[v]) >>
                           shift[v];
      zz[lb][nat2zz[v * 8 + r]] = static_cast<int16_t>(val < 0 ? -static_cast<int>(mag)
                                                               : static_cast<int>(mag));
    }
    __syncwarp();
    if (idx < total)
      reinterpret_cast<uint4*>(out + static_cast<size_t>(idx) * 64)[r] =
          reinterpret_cast<const uint4*>(zz[lb])[r];
    __syncwarp();
  }
}

}  // namespace

// planes: the planes' u8 samples one after another on the card (8-byte
// aligned); out: int16 [blocks][64]; params: the host's K17Params, copied
// into the launch; div: ntables x [recip, corr, shift] x [column][row]
// words on the card. Returns a CUDA error code (0 = launched).
extern "C" int flyimg_jpeg_fdct(const uint8_t* planes, int16_t* out, const K17Params* params,
                                const unsigned* div, int ntables, void* stream) {
  if (!params || params->nplanes < 1 || params->nplanes > kMaxPlanes || !div || ntables < 1 ||
      ntables > 2 || reinterpret_cast<uintptr_t>(planes) % 8 ||
      reinterpret_cast<uintptr_t>(div) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const K17Params p = *params;
  const int blocks = p.block_off[p.nplanes];
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int groups = (blocks + kBlocks - 1) / kBlocks;
  const int grid = groups < sms * kCtasPerSm ? groups : sms * kCtasPerSm;
  fdct_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(planes, out, p, div,
                                                                        ntables);
  return static_cast<int>(cudaGetLastError());
}
