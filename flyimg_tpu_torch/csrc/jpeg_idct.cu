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
// 16 bits through pass 1, each pass's outputs saturate to 16 bits (at 2x2
// pass 1's column 0 stays in 32 bits, and pass 2 shifts it in a 32-bit
// lane) and the samples to -128..127 before +128. At 1x1 the DC is dequantized in int,
// descaled and looked up through the range-limit table (x & 1023 wraps).
// On values a valid file gives, all of this is jidctint.c's and
// jidctred.c's C arithmetic; codecs/jpeg_dec_plain.py idct_blocks is the
// plain version, held to this kernel bit for bit.
//
// Input: the batch's coefficients, int16 [blocks][64] in natural order,
// each component's padded block grid row-major (codecs/native/
// jpeg_reader.cpp's layout); int32 quantization tables [t][64]; and a tile
// table built on the host (codecs/jpeg_dec.py idct_tiles), a row a CTA's
// tile: a run of up to kTile blocks of one block row of one component
// window, so one output size, one table and one band of one plane. Output:
// the u8 planes (row-major, the window's blocks side by side).
//
// What bounds it on an H100: bytes: a block reads 128 bytes of
// coefficients and writes scale^2 samples (~1,000 integer operations at
// 8x8, a quarter of that at 4x4). Design: persistent CTAs of 128 threads
// walk the tiles; a tile's blocks are contiguous in the coefficient
// buffer, so its coefficients and its table come to shared memory as
// whole 128-byte lines by cp.async, the next tile's while this one is
// transformed (two buffers). A body for each output size S takes S lanes
// a block, so that every lane has a column in pass 1 and a row in pass 2,
// and keeps its quantization values in registers for the tile; a block's
// row of samples goes to shared memory as one store, and the tile's rows
// go out to the plane as 16-byte stores (funnel-shifted to the plane's
// alignment; bytes at a row's ends). A row of the table is read once a
// tile: no search, no division a block. The host sizes the tiles to the
// batch (short ones for a small decode, so that its few blocks spread
// over the SMs) and starts them 16 samples apart, so that a row starting
// on a 16-byte boundary needs no shift.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

// a row of the tile table (codecs/jpeg_dec.py IDCT_TILE): 64-bit offsets,
// a batch's planes and blocks may pass 2^31
struct __align__(16) K18Tile {
  long long coef;  // the tile's first block in the coefficient buffer
  long long out;   // its first sample's byte in the planes
  int pitch;       // the plane's bytes a row
  int n;           // blocks, 1..kTile
  int scale;       // output samples a block side: 8, 4, 2 or 1
  int qt;          // quantization table
};

namespace {

constexpr int kTile = 64;       // blocks a tile at most
constexpr int kThreads = 128;
constexpr int kMinCtas = 8;     // CTAs an SM: 64 registers a thread, ~26 KB of shared memory
constexpr int kOutPitch = 544;  // a staged sample row: 64 x 8 samples and the chunk a
                                // shifted read reaches past them (136 words: a warp's
                                // 8-byte stores of 8 rows fall in different banks)

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
// descale by n bits (a 32-bit lane's add and arithmetic shift), saturate to
// 16 (pass 2's outputs only descaled: the samples' clamp to -128..127 takes
// in the 16-bit saturation)
template <bool Sat>
__device__ __forceinline__ int out16(int v, int n) {
  const int d = add(v, 1 << (n - 1)) >> n;
  return Sat ? s16(d) : d;
}

// one pass of the 8x8 transform over c[0..7] -> o[0..7]
template <bool Sat>
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
  o[0] = out16<Sat>(add(tmp10, t3), n);
  o[7] = out16<Sat>(sub(tmp10, t3), n);
  o[1] = out16<Sat>(add(tmp11, t2), n);
  o[6] = out16<Sat>(sub(tmp11, t2), n);
  o[2] = out16<Sat>(add(tmp12, t1), n);
  o[5] = out16<Sat>(sub(tmp12, t1), n);
  o[3] = out16<Sat>(add(tmp13, t0), n);
  o[4] = out16<Sat>(sub(tmp13, t0), n);
}

// one pass of the 4x4 transform -> o[0..3]
template <bool Sat>
__device__ __forceinline__ void red4(const int (&c)[8], int (&o)[8], int n) {
  const int tmp0 = shl(c[0], kConstBits + 1);
  const int tmp2 = add(mul(c[2], F_1_847), mul(c[6], -F_0_765));
  const int tmp10 = add(tmp0, tmp2), tmp12 = sub(tmp0, tmp2);
  const int t0 = add(add(mul(c[1], F_1_061), mul(c[3], -F_2_172)),
                     add(mul(c[5], F_1_451), mul(c[7], -F_0_211)));
  const int t2 = add(add(mul(c[1], F_2_562), mul(c[3], F_0_899)),
                     add(mul(c[5], -F_0_601), mul(c[7], -F_0_509)));
  o[0] = out16<Sat>(add(tmp10, t2), n);
  o[3] = out16<Sat>(sub(tmp10, t2), n);
  o[1] = out16<Sat>(add(tmp12, t0), n);
  o[2] = out16<Sat>(sub(tmp12, t0), n);
}

// one pass of the 2x2 transform -> o[0..1], saturated to 16 bits where
// `sat` (jidctred-sse2.asm packs pass 1's odd columns to words for pass 2's
// multiplies and keeps column 0, which pass 2 only shifts, in 32 bits)
__device__ __forceinline__ void red2(const int (&c)[8], int (&o)[8], int n, bool sat) {
  const int tmp10 = shl(c[0], kConstBits + 2);
  const int t0 = add(add(mul(c[1], F_3_624), mul(c[3], -F_1_272)),
                     add(mul(c[5], F_0_850), mul(c[7], -F_0_720)));
  o[0] = out16<false>(add(tmp10, t0), n);
  o[1] = out16<false>(sub(tmp10, t0), n);
  if (sat) {
    o[0] = s16(o[0]);
    o[1] = s16(o[1]);
  }
}

// one pass over column u (pass 1) or a workspace row (pass 2)
template <int S, bool First>
__device__ __forceinline__ void pass(const int (&c)[8], int (&o)[8], int u) {
  if constexpr (S == 8)
    islow<First>(c, o, First ? kConstBits - kPass1Bits : kConstBits + kPass1Bits + 3);
  else if constexpr (S == 4)
    red4<First>(c, o, First ? kConstBits - kPass1Bits + 1 : kConstBits + kPass1Bits + 3 + 1);
  else
    red2(c, o, First ? kConstBits - kPass1Bits + 2 : kConstBits + kPass1Bits + 3 + 2,
         First && u != 0);
}

// IDCT_range_limit(cinfo)[x & RANGE_MASK] (jdmaster.c)
__device__ __forceinline__ int range_limit(int x) {
  const int y = x & 1023;
  return y < 128 ? y + 128 : (y < 512 ? 255 : (y < 896 ? 0 : y - 896));
}

// coefficient (row v, column u) of staged block b: a block's rows are its
// eight 16-byte chunks, row v kept at chunk v ^ (b & 7), so that the blocks
// a warp reads at once fall in different banks
__device__ __forceinline__ int coef_at(const int16_t* sc, int b, int v, int u) {
  return sc[b * 64 + ((v ^ (b & 7)) << 3) + u];
}

// the tile's coefficients and table into shared memory (cp.async, 16 bytes
// a copy); thread 0 keeps its row
__device__ __forceinline__ void stage(const int16_t* __restrict__ coefs,
                                      const int* __restrict__ quant, const K18Tile& t,
                                      int16_t* sc, int* sq, K18Tile* st) {
  const int16_t* src = coefs + t.coef * 64;
  for (int i = threadIdx.x; i < t.n * 8; i += kThreads) {
    const int b = i >> 3, v = i & 7;
    __pipeline_memcpy_async(sc + b * 64 + ((v ^ (b & 7)) << 3), src + i * 8, 16);
  }
  if (threadIdx.x < 16)
    __pipeline_memcpy_async(sq + threadIdx.x * 4, quant + t.qt * 64 + threadIdx.x * 4, 16);
  if (threadIdx.x == 0) *st = t;
}

// a pass 2 output as a sample: saturated to -128..127, then + 128
__device__ __forceinline__ unsigned sample(int v) {
  return static_cast<unsigned>((v < -128 ? -128 : (v > 127 ? 127 : v)) + 128);
}
__device__ __forceinline__ unsigned pack4(const int (&o)[8], int k) {
  return sample(o[k]) | sample(o[k + 1]) << 8 | sample(o[k + 2]) << 16 | sample(o[k + 3]) << 24;
}

// the tile's n blocks at output size S into ob: row r of the tile's samples
// at ob[r * kOutPitch], a block's S samples of a row as one store. S lanes
// a block, kThreads / S blocks a round; every lane runs every round's votes
// and barriers (a dead block reads stale data in bounds and stores
// nothing). A lane's quantization values stay in registers for the tile.
template <int S>
__device__ __forceinline__ void transform(const int16_t* __restrict__ sc,
                                          const int* __restrict__ sq, int* __restrict__ ws,
                                          uint8_t* __restrict__ ob, int n) {
  const int tid = threadIdx.x;
  if constexpr (S == 1) {
    // jpeg_idct_1x1: the DC dequantized in int, descaled, through the table
    if (tid < n) {
      const int dc = coef_at(sc, tid, 0, 0) * static_cast<int16_t>(sq[0]);
      ob[tid] = static_cast<uint8_t>(range_limit((dc + 4) >> 3));
    }
  } else {
    constexpr int kGroups = kThreads / S;
    // the lane's columns in pass 1 (at 2x2 only the five pass 2 reads:
    // 0, 3, 7 and 1, 5; -1 none)
    constexpr int kCols = S == 2 ? 3 : 8 / S;
    const int lane = tid & (S - 1), g = tid / S;
    int cols[kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      cols[k] = S == 2 ? (lane == 0 ? (k == 0 ? 0 : (k == 1 ? 3 : 7))
                                    : (k == 0 ? 1 : (k == 1 ? 5 : -1)))
                       : lane + k * S;
    // ISLOW_MULT_TYPE is short: the table's values in 16 bits
    int q[kCols][8];
#pragma unroll
    for (int k = 0; k < kCols; ++k)
#pragma unroll
      for (int v = 0; v < 8; ++v) q[k][v] = static_cast<int16_t>(sq[v * 8 + (cols[k] & 7)]);
    const unsigned group = ((1u << S) - 1) << ((tid & 31) & ~(S - 1));
    int* w = ws + g * S * 9;  // the block's workspace: S rows of 8 (stride 9)
    for (int base = 0; base < n; base += kGroups) {
      const int b = base + g;
      int raw[8];  // at 8x8 the lane's one column, kept from the vote to pass 1
      bool dc_only = false;
      if constexpr (S != 2) {
        // the whole block's AC rows zero (all but row 4 at 4x4; no test at
        // 2x2): the SIMD pass 1's DC shortcut
        bool nonzero = false;
#pragma unroll
        for (int k = 0; k < kCols; ++k)
#pragma unroll
          for (int v = 0; v < 8; ++v) {
            const int c = coef_at(sc, b, v, cols[k]);
            if (S == 8) raw[v] = c;
            if (v > 0 && (S == 8 || v != 4)) nonzero |= c != 0;
          }
        dc_only = (__ballot_sync(0xFFFFFFFFu, nonzero) & group) == 0;
      }
      // pass 1: the lane's columns
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int u = cols[k];
        if (u < 0) continue;
        int c[8], o[8];
#pragma unroll
        for (int v = 0; v < 8; ++v)
          c[v] = w16(mul(S == 8 ? raw[v] : coef_at(sc, b, v, u), q[k][v]));
        if (dc_only) {
          const int dc = w16(shl(c[0], kPass1Bits));
#pragma unroll
          for (int v = 0; v < 8; ++v) o[v] = dc;
        } else {
          pass<S, true>(c, o, u);
        }
#pragma unroll
        for (int v = 0; v < S; ++v) w[v * 9 + u] = o[v];
      }
      __syncwarp();
      // pass 2: the lane's workspace row -> the block's samples of that row
      if (b < n) {
        int c[8], o[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) c[k] = w[lane * 9 + k];
        pass<S, false>(c, o, lane);
        uint8_t* dst = ob + lane * kOutPitch + b * S;
        if constexpr (S == 8)
          *reinterpret_cast<uint2*>(dst) = make_uint2(pack4(o, 0), pack4(o, 4));
        else if constexpr (S == 4)
          *reinterpret_cast<unsigned*>(dst) = pack4(o, 0);
        else
          *reinterpret_cast<unsigned short*>(dst) =
              static_cast<unsigned short>(sample(o[0]) | sample(o[1]) << 8);
      }
      __syncwarp();
    }
  }
}

// the 16 bytes at row + o (o >= 0; row 16-byte aligned in shared memory):
// the aligned chunk or two, funnel-shifted
__device__ __forceinline__ uint4 bytes_at(const uint8_t* row, int o) {
  const uint4* p = reinterpret_cast<const uint4*>(row + (o & ~15));
  const int s = o & 15;
  const uint4 a = p[0];
  if (s == 0) return a;
  const uint4 b = p[1];
  const unsigned w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int q = s >> 2, sh = (s & 3) * 8;
  unsigned v[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    v[i] = q == 0 ? w[i] : (q == 1 ? w[i + 1] : (q == 2 ? w[i + 2] : w[i + 3]));
  return make_uint4(__funnelshift_r(v[0], v[1], sh), __funnelshift_r(v[1], v[2], sh),
                    __funnelshift_r(v[2], v[3], sh), __funnelshift_r(v[3], v[4], sh));
}

// the staged rows (len bytes each at ob[r * kOutPitch]) out to the plane,
// pitch apart from dst: every whole 16-byte chunk of the plane as one
// store, a row's partial end chunks by bytes
__device__ __forceinline__ void store(uint8_t* __restrict__ dst, int pitch, int len, int rows,
                                      const uint8_t* __restrict__ ob) {
  const int nch = (len + 30) >> 4;  // a row's chunks at any alignment
  // i / nch as a product: exact for i < 2^32 / nch
  const unsigned magic = 0xFFFFFFFFu / static_cast<unsigned>(nch) + 1;
  for (int i = threadIdx.x; i < rows * nch; i += kThreads) {
    const int r = static_cast<int>(__umulhi(static_cast<unsigned>(i), magic)), c = i - r * nch;
    uint8_t* row = dst + static_cast<long long>(r) * pitch;
    const uint8_t* src = ob + r * kOutPitch;
    const int lo = c * 16 - static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15);
    if (lo >= 0 && lo + 16 <= len) {
      *reinterpret_cast<uint4*>(row + lo) = bytes_at(src, lo);
    } else {
      for (int j = lo > 0 ? lo : 0; j < (lo + 16 < len ? lo + 16 : len); ++j) row[j] = src[j];
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinCtas)
idct_kernel(const int16_t* __restrict__ coefs, const int* __restrict__ quant,
            const K18Tile* __restrict__ tiles, int ntiles, uint8_t* __restrict__ out) {
  __shared__ __align__(16) int16_t sc[2][kTile * 64];  // the tiles' coefficients
  __shared__ __align__(16) int sq[2][64];              // their tables
  __shared__ K18Tile st[2];                            // their rows
  __shared__ int ws[kThreads * 9];                     // pass 1's output
  __shared__ __align__(16) uint8_t ob[8 * kOutPitch];  // the samples, row by row
  const int grid = gridDim.x;
  int t = blockIdx.x;  // the grid is at most the tiles: every CTA has one
  K18Tile next = tiles[t];
  stage(coefs, quant, next, sc[0], sq[0], &st[0]);
  __pipeline_commit();
  if (t + grid < ntiles) next = tiles[t + grid];
  for (int k = 0; t < ntiles; ++k, t += grid) {
    const int buf = k & 1;
    // the next tile's copies go out before this tile is transformed, and
    // the row after it is read meanwhile
    if (t + grid < ntiles) {
      stage(coefs, quant, next, sc[buf ^ 1], sq[buf ^ 1], &st[buf ^ 1]);
      if (t + 2 * grid < ntiles) next = tiles[t + 2 * grid];
    }
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();
    const K18Tile cur = st[buf];
    switch (cur.scale) {
      case 8: transform<8>(sc[buf], sq[buf], ws, ob, cur.n); break;
      case 4: transform<4>(sc[buf], sq[buf], ws, ob, cur.n); break;
      case 2: transform<2>(sc[buf], sq[buf], ws, ob, cur.n); break;
      default: transform<1>(sc[buf], sq[buf], ws, ob, cur.n); break;
    }
    __syncthreads();
    store(out + cur.out, cur.pitch, cur.n * cur.scale, cur.scale, ob);
    __syncthreads();
  }
}

}  // namespace

// coefs: int16 [blocks][64] on the card; quant: int32 [tables][64]; tiles:
// ntiles K18Tile rows on the card (all 16-byte aligned); out: the u8
// planes. Returns a CUDA error code (0 = launched).
extern "C" int flyimg_jpeg_idct(const int16_t* coefs, const int* quant, const K18Tile* tiles,
                                int ntiles, uint8_t* out, void* stream) {
  if (ntiles < 1 || reinterpret_cast<uintptr_t>(coefs) % 16 ||
      reinterpret_cast<uintptr_t>(quant) % 16 || reinterpret_cast<uintptr_t>(tiles) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaFuncSetAttribute(idct_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                         static_cast<int>(cudaSharedmemCarveoutMaxShared));
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, idct_kernel, kThreads, 0);
    if (per_sm < 1) per_sm = 1;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long slots = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(ntiles < slots ? ntiles : slots);
  idct_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(coefs, quant, tiles,
                                                                        ntiles, out);
  return static_cast<int>(cudaGetLastError());
}
