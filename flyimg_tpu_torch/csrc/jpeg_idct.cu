// K18: dequantization and the inverse DCT of a batch of JPEG decodes, one
// launch for every block of every member.
//
// Replaces what libjpeg-turbo does inside jpeg_read_scanlines under the
// JAX package's fc_jpeg_decode and fc_jpeg_decode_roi
// (flyimg_tpu/codecs/native/fastcodec.cpp): jddctmgr.c's choice of IDCT by
// each component's scaled size and the transforms themselves, as the
// library computes them on an x86-64 host: jpeg_idct_islow (jidctint.c)
// for 8x8 output and jpeg_idct_4x4 / jpeg_idct_2x2 (jidctred.c) in the
// lanes of their SIMD versions (jidctint-avx2.asm, jidctred-sse2.asm), and
// the C jpeg_idct_1x1 for 1x1 output. The SIMD arithmetic is the C
// transform's, with 16-bit lanes where the C code has int: each
// dequantized coefficient keeps its low 16 bits, the sums in0 +- in4, in7
// + in3 and in5 + in1 of the 8x8 transform wrap at 16 bits, a block whose
// AC rows (all but row 4 at 4x4; no test at 2x2) are zero takes DC << 2 in
// 16 bits through pass 1, each pass's outputs saturate to 16 bits and the
// samples to -128..127 before +128. At 1x1 the DC is dequantized in int,
// descaled and looked up through the range-limit table (x & 1023 wraps).
// On values a valid file gives, all of this is jidctint.c's and
// jidctred.c's C arithmetic; codecs/jpeg_dec_plain.py idct_blocks is the
// plain version, held to this kernel bit for bit.
//
// Input: the batch's coefficients, int16 [blocks][64] in natural order,
// each component's padded block grid row-major (codecs/native/
// jpeg_reader.cpp's layout); int32 quantization tables [t][64]; and a
// segment table, a row a component window of a member (K18Segment, int64
// fields): its
// grid, the window of blocks to transform, their output size (8, 4, 2 or
// 1), its table and its output plane (row-major, pitch bytes). Output:
// the u8 planes.
//
// What bounds it on an H100: bytes: a block reads 128 bytes of
// coefficients and writes scale^2 samples (~400 integer operations at 8x8).
// Design: 8 lanes a block, 16 blocks a CTA; lane r loads coefficient row r
// (one 16-byte load) and its quantization row, the block crosses to
// columns through shared memory, lane c runs pass 1 on column c, the
// workspace crosses back, lane r runs pass 2 on row r and stores its
// samples. CTAs walk the blocks in a grid-stride loop; a block finds its
// segment by binary search over the segments' first blocks.

#include <cuda_runtime.h>
#include <stdint.h>

// a row of the segment table (codecs/jpeg_dec_plain.py SEG_*), 64-bit
// fields: a batch's planes and blocks may pass 2^31
struct K18Segment {
  long long coef;      // the component grid's first block in the coefficient buffer
  long long grid_w;    // its blocks a row (alloc_w)
  long long bx0, by0;  // the window's first block
  long long nbx, nby;  // the window, in blocks
  long long scale;     // output samples a block side: 8, 4, 2 or 1
  long long qt;        // quantization table
  long long out;       // the plane's first byte
  long long pitch;     // the plane's bytes a row
  long long first;     // the segment's first block in the launch's numbering
  long long pad;
};

namespace {

constexpr int kBlocks = 16;  // blocks a CTA works at a time, four a warp
constexpr int kThreads = kBlocks * 8;
constexpr int kCtasPerSm = 16;

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;

constexpr int F_0_211 = 1730, F_0_298 = 2446, F_0_390 = 3196, F_0_509 = 4176, F_0_541 = 4433,
              F_0_601 = 4926, F_0_720 = 5906, F_0_765 = 6270, F_0_850 = 6967, F_0_899 = 7373,
              F_1_061 = 8697, F_1_175 = 9633, F_1_272 = 10426, F_1_451 = 11893,
              F_1_501 = 12299, F_1_847 = 15137, F_1_961 = 16069, F_2_053 = 16819,
              F_2_172 = 17799, F_2_562 = 20995, F_3_072 = 25172, F_3_624 = 29692;

// 32-bit lanes wrap: sums and products in unsigned
__device__ __forceinline__ int add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
__device__ __forceinline__ int mul(int a, int c) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(c));
}
__device__ __forceinline__ int shl(int a, int n) {
  return static_cast<int>(static_cast<unsigned>(a) << n);
}
__device__ __forceinline__ int w16(int a) { return static_cast<int16_t>(a); }
__device__ __forceinline__ int s16(int a) { return a < -32768 ? -32768 : (a > 32767 ? 32767 : a); }
// descale by n bits (a 32-bit lane's add and arithmetic shift), saturate to 16
__device__ __forceinline__ int out16(int v, int n) { return s16(add(v, 1 << (n - 1)) >> n); }

// one pass of the 8x8 transform over c[0..7] -> o[0..7]
__device__ __forceinline__ void islow(const int (&c)[8], int (&o)[8], int n) {
  const int tmp3 = add(mul(c[2], F_0_541 + F_0_765), mul(c[6], F_0_541));
  const int tmp2 = add(mul(c[2], F_0_541), mul(c[6], F_0_541 - F_1_847));
  const int tmp0 = shl(w16(c[0] + c[4]), kConstBits);
  const int tmp1 = shl(w16(c[0] - c[4]), kConstBits);
  const int tmp10 = add(tmp0, tmp3), tmp13 = sub(tmp0, tmp3);
  const int tmp11 = add(tmp1, tmp2), tmp12 = sub(tmp1, tmp2);
  const int z3 = w16(c[7] + c[3]), z4 = w16(c[5] + c[1]);
  const int z3p = add(mul(z3, F_1_175 - F_1_961), mul(z4, F_1_175));
  const int z4p = add(mul(z3, F_1_175), mul(z4, F_1_175 - F_0_390));
  const int t0 = add(add(mul(c[7], F_0_298 - F_0_899), mul(c[1], -F_0_899)), z3p);
  const int t3 = add(add(mul(c[7], -F_0_899), mul(c[1], F_1_501 - F_0_899)), z4p);
  const int t1 = add(add(mul(c[5], F_2_053 - F_2_562), mul(c[3], -F_2_562)), z4p);
  const int t2 = add(add(mul(c[5], -F_2_562), mul(c[3], F_3_072 - F_2_562)), z3p);
  o[0] = out16(add(tmp10, t3), n);
  o[7] = out16(sub(tmp10, t3), n);
  o[1] = out16(add(tmp11, t2), n);
  o[6] = out16(sub(tmp11, t2), n);
  o[2] = out16(add(tmp12, t1), n);
  o[5] = out16(sub(tmp12, t1), n);
  o[3] = out16(add(tmp13, t0), n);
  o[4] = out16(sub(tmp13, t0), n);
}

// one pass of the 4x4 transform -> o[0..3]
__device__ __forceinline__ void red4(const int (&c)[8], int (&o)[8], int n) {
  const int tmp0 = shl(c[0], kConstBits + 1);
  const int tmp2 = add(mul(c[2], F_1_847), mul(c[6], -F_0_765));
  const int tmp10 = add(tmp0, tmp2), tmp12 = sub(tmp0, tmp2);
  const int t0 = add(add(mul(c[1], F_1_061), mul(c[3], -F_2_172)),
                     add(mul(c[5], F_1_451), mul(c[7], -F_0_211)));
  const int t2 = add(add(mul(c[1], F_2_562), mul(c[3], F_0_899)),
                     add(mul(c[5], -F_0_601), mul(c[7], -F_0_509)));
  o[0] = out16(add(tmp10, t2), n);
  o[3] = out16(sub(tmp10, t2), n);
  o[1] = out16(add(tmp12, t0), n);
  o[2] = out16(sub(tmp12, t0), n);
}

// one pass of the 2x2 transform -> o[0..1]
__device__ __forceinline__ void red2(const int (&c)[8], int (&o)[8], int n) {
  const int tmp10 = shl(c[0], kConstBits + 2);
  const int t0 = add(add(mul(c[1], F_3_624), mul(c[3], -F_1_272)),
                     add(mul(c[5], F_0_850), mul(c[7], -F_0_720)));
  o[0] = out16(add(tmp10, t0), n);
  o[1] = out16(sub(tmp10, t0), n);
}

__device__ __forceinline__ void pass(int scale, const int (&c)[8], int (&o)[8], bool first) {
  if (scale == 8)
    islow(c, o, first ? kConstBits - kPass1Bits : kConstBits + kPass1Bits + 3);
  else if (scale == 4)
    red4(c, o, first ? kConstBits - kPass1Bits + 1 : kConstBits + kPass1Bits + 3 + 1);
  else
    red2(c, o, first ? kConstBits - kPass1Bits + 2 : kConstBits + kPass1Bits + 3 + 2);
}

// IDCT_range_limit(cinfo)[x & RANGE_MASK] (jdmaster.c)
__device__ __forceinline__ int range_limit(int x) {
  const int y = x & 1023;
  return y < 128 ? y + 128 : (y < 512 ? 255 : (y < 896 ? 0 : y - 896));
}

__device__ __forceinline__ int find_segment(const K18Segment* __restrict__ segs, int nseg,
                                            long long b) {
  int lo = 0, hi = nseg - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (segs[mid].first <= b) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
idct_kernel(const int16_t* __restrict__ coefs, const int* __restrict__ quant,
            const K18Segment* __restrict__ segs, int nseg, long long total,
            uint8_t* __restrict__ out) {
  __shared__ int raw[kBlocks][8][9];   // the coefficients (the zero test)
  __shared__ int dq[kBlocks][8][9];    // dequantized, 16-bit
  __shared__ int ws[kBlocks][8][9];    // pass 1's output
  const int tid = threadIdx.x;
  const int lb = tid >> 3, r = tid & 7;  // block of the CTA's 16, row (then column)
  const unsigned group = 0xFFu << ((tid & 31) & ~7);
  const long long stride = static_cast<long long>(gridDim.x) * kBlocks;
  for (long long base = static_cast<long long>(blockIdx.x) * kBlocks; base < total;
       base += stride) {
    const long long idx = base + lb;
    const bool live = idx < total;
    const long long b = live ? idx : total - 1;
    const K18Segment& sg = segs[find_segment(segs, nseg, b)];
    // a segment's own blocks, rows and columns fit 32 bits
    const int local = static_cast<int>(b - sg.first);
    const int nbx = static_cast<int>(sg.nbx), pitch = static_cast<int>(sg.pitch);
    const int by = local / nbx, bx = local - by * nbx;
    const size_t block = static_cast<size_t>(sg.coef) +
                         static_cast<size_t>(sg.by0 + by) * static_cast<size_t>(sg.grid_w) +
                         static_cast<size_t>(sg.bx0 + bx);
    const int qt = static_cast<int>(sg.qt);
    const uint4 row = reinterpret_cast<const uint4*>(coefs + block * 64)[r];
    const uint4 q0 = reinterpret_cast<const uint4*>(quant + qt * 64 + r * 8)[0];
    const uint4 q1 = reinterpret_cast<const uint4*>(quant + qt * 64 + r * 8)[1];
    const unsigned words[4] = {row.x, row.y, row.z, row.w};
    const int qv[8] = {static_cast<int>(q0.x), static_cast<int>(q0.y), static_cast<int>(q0.z),
                       static_cast<int>(q0.w), static_cast<int>(q1.x), static_cast<int>(q1.y),
                       static_cast<int>(q1.z), static_cast<int>(q1.w)};
    const int scale = static_cast<int>(sg.scale);
    bool nonzero = false;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = static_cast<int16_t>((words[u >> 1] >> (16 * (u & 1))) & 0xFFFF);
      raw[lb][r][u] = c;
      // ISLOW_MULT_TYPE is short: the table value and the product in 16 bits
      dq[lb][r][u] = w16(mul(c, static_cast<int16_t>(qv[u])));
      nonzero |= c != 0;
    }
    // the whole block's AC rows zero (the SIMD pass 1's DC shortcut)
    const bool ac_row = r != 0 && !(scale == 4 && r == 4);
    const unsigned votes = __ballot_sync(0xFFFFFFFFu, ac_row && nonzero) & group;
    const bool dc_only = votes == 0 && scale != 2;
    __syncwarp();
    // every lane runs the same barriers whatever its block's size: a warp's
    // four blocks may take different sizes (a 4:2:0 file's luma at 1x1,
    // its chroma at 2x2)
    // pass 1: lane r takes column r
    if (scale > 1) {
      int c[8], o[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) c[k] = dq[lb][k][r];
      if (dc_only) {
        const int dc = w16(shl(c[0], kPass1Bits));
#pragma unroll
        for (int k = 0; k < 8; ++k) o[k] = dc;
      } else {
        pass(scale, c, o, true);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (k < scale) ws[lb][k][r] = o[k];
    }
    __syncwarp();
    if (scale == 1) {
      if (r == 0 && live) {
        const int dc = raw[lb][0][0] * static_cast<int16_t>(qv[0]);
        const int v = range_limit((dc + 4) >> 3);
        out[static_cast<size_t>(sg.out) + static_cast<size_t>(by) * pitch + bx] =
            static_cast<uint8_t>(v);
      }
    } else if (r < scale && live) {
      // pass 2: lane r takes workspace row r
      int c[8], o[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) c[k] = ws[lb][r][k];
      pass(scale, c, o, false);
      uint8_t* dst = out + static_cast<size_t>(sg.out) +
                     static_cast<size_t>(by * scale + r) * pitch + bx * scale;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (k < scale) {
          const int v = o[k] < -128 ? -128 : (o[k] > 127 ? 127 : o[k]);
          dst[k] = static_cast<uint8_t>(v + 128);
        }
      }
    }
    __syncwarp();
  }
}

}  // namespace

// coefs: int16 [blocks][64] on the card (16-byte aligned); quant: int32
// [tables][64] (16-byte aligned); segs: nseg K18Segment rows on the card,
// in order of their first block; total: the blocks of all segments; out:
// the u8 planes. Returns a CUDA error code (0 = launched).
extern "C" int flyimg_jpeg_idct(const int16_t* coefs, const int* quant, const K18Segment* segs,
                                int nseg, long long total, uint8_t* out, void* stream) {
  if (nseg < 1 || total < 1 || reinterpret_cast<uintptr_t>(coefs) % 16 ||
      reinterpret_cast<uintptr_t>(quant) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long groups = (total + kBlocks - 1) / kBlocks;
  const int grid = static_cast<int>(groups < sms * kCtasPerSm ? groups : sms * kCtasPerSm);
  idct_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(coefs, quant, segs,
                                                                        nseg, total, out);
  return static_cast<int>(cudaGetLastError());
}
