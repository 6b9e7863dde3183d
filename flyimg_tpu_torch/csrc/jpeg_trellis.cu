// K16: the trellis JPEG encoder's coefficients, one launch for a group of
// encodes at one quality and sampling (a lone encode is a group of one):
// a frame table gives each frame its pixels, coefficients, geometry and
// first CTA, and a CTA finds its frame by binary search.
//
// Replaces the device-free arithmetic of the JAX package's native encoder
// (flyimg_tpu/codecs/native/fastcodec.cpp fc_jpeg_encode_trellis, with
// trellis::fdct8x8 and trellis::trellis_ac), which it runs on the host
// before libjpeg's entropy coding. Per 8x8 block of each component:
//   - samples: Y = 0.299 R + 0.587 G + 0.114 B, Cb and Cr the JFIF
//     forms plus 128, all f32 in the C++ order; chroma subsampled by the
//     luma factors (h, v) is the mean of the in-bounds samples of its box
//     (adds in row order, one division by the count); rows and columns
//     past a plane replicate its last ones; minus 128;
//   - the separable f32 DCT-II against the host's cosine table (computed
//     in double and rounded once, as the JAX package's init_cos does),
//     summing x = 0..7 then y = 0..7;
//   - zigzag; DC = round-half-away(c0 / q0); the AC run by the exact
//     rate-distortion dynamic program of trellis_ac (candidates round(|c|
//     / q) and one less, rates from the standard AC tables' code lengths
//     weighted by lambda, ZRL escapes folded by run residue).
// Output: int16 [blocks][64] zigzag, Y's blocks then Cb's then Cr's, each
// component's width_in_blocks x height_in_blocks row-major (the layout
// codecs/native/jpeg_writer.cpp reads).
//
// Bit-equality with the C++ code: built with --fmad=false, and every
// product, sum and quotient below is an explicit round-to-nearest
// intrinsic, so no multiply-add is contracted and divisions are IEEE.
// Minima are taken with fminf (exact, and no candidate is -0 or NaN) and
// ties go where the C loops' strict < sends them.
//
// What bounds it on an H100: bytes (3 a pixel in, 128 a block out) put
// the floor of a 1920x1080 frame at 0.0056 ms; its float operations (~300
// million on a photo, ~3,000 a block) at the unfused rate (--fmad=false:
// an instruction does one) at 0.009 ms; and each block's dynamic program
// is a chain of 63 dependent steps (a 16-way minimum, a compare, the ZRL
// fold), so a block's latency, not the card's rates, sets the time at the
// answer's shape and, through the blocks a CTA can keep resident, at
// 1920x1080. Design (a team of kLanes lanes a block; PERF.md has the
// widths' times):
//   - a CTA takes a strip of kTeams neighbouring blocks of one component;
//     its first global loads (the component's constants and the strip's
//     RGB rows as aligned 16-byte words) go out together, and it converts
//     each pixel once (each box mean once for subsampled chroma) into its
//     teams' slots in shared memory;
//   - the DCT's 64 outputs of each pass split over the team, each output
//     summed by one lane in the reference order, written in zigzag order;
//     the program's per-position values (the candidates round(|c| / q) and
//     one less, their sizes and squared errors) computed in parallel over
//     the positions; the prefix sums of c^2 as one sequential f32 sum in
//     position order;
//   - the chain keeps the last 16 w values in registers, spread over the
//     lanes; at a position where some block of the warp has a candidate,
//     the 16 run lengths of each size split over the lanes and a shuffle
//     butterfly takes the minimum (v0 - 1's own minimum only where its
//     size differs from v0's); a run of up to 16 positions where no block
//     has one is one turn of the window, since there w[j] is the ZRL fold
//     of w[j - 16] (or 1e30) and depends on nothing newer; the records
//     overwrite the per-position values in place;
//   - the back pointers are not tracked on the chain: afterwards the
//     chosen positions, shared out over the team, find their first
//     minimum again from the stored w values (the same sums, so the same
//     argument) and their cost as the last nonzero position, and one lane
//     follows the pointers;
//   - everything per block lives in registers or in the team's slots in
//     shared memory (no local memory; 12 KB a CTA at 4:4:4, the staging
//     area sized a launch); the block's 128 bytes go out as 16-byte
//     stores.
// The constants (cosines, quantizers, lambda-rates) come from a device
// buffer the wrapper keeps a quality, copied into each CTA's shared
// memory (lanes read them at different indices, which a kernel parameter
// or constant memory would serialise).

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef K16_LANES
#define K16_LANES 8
#endif
// -DK16_PHASE_CLOCKS (jpeg_breakdown.py): each team's lane 0 writes the
// clock at the phase boundaries, and the chain's cycles, into its block's
// output in place of the coefficients
#ifdef K16_PHASE_CLOCKS
#define K16_CLOCK(i) (stamp[i] = clock64())
#else
#define K16_CLOCK(i)
#endif

namespace {

constexpr int kLanes = K16_LANES;
static_assert(kLanes == 2 || kLanes == 4 || kLanes == 8 || kLanes == 16 || kLanes == 32,
              "K16_LANES is a power of two from 2 to 32");
constexpr int kTeams = kLanes >= 4 ? 8 : 32 / kLanes;  // blocks a CTA
constexpr int kThreads = kTeams * kLanes;
constexpr int kCols = kTeams * 8;                        // plane columns a strip
constexpr int kM = kLanes >= 16 ? 1 : 16 / kLanes;       // run lengths m a lane
constexpr int kPos = 64 / kLanes;                        // positions a lane
constexpr unsigned kFull = 0xffffffffu;

// the host's constants (jpeg_tables.trellis_param_block), in words
constexpr int kWordCos = 0, kWordQ = 64, kWordRate = 192, kWordZrl = 544, kWordEob = 546;

// one component table's constants in a CTA's shared memory
struct alignas(16) Table {
  float cos[8][8];
  float q[64];           // zigzag order
  float lrate[11][16];   // [size][run], lambda * (code bits + size); size 0 is 0
  float lzrl, leob;
};

// A team's block in shared memory, in two slots (each padded by 16 bytes so
// that the four teams of a warp read different banks at the same offset):
//  - a 64-float slot: the block's plane samples, then its DCT in zigzag
//    order, then c^2 of each position, then the output (int16 [64] and
//    the back pointers, uint8 [64]);
//  - a 64-float4 slot: position k's program values (d^2 for v0 and
//    v0 - 1, then prefix[k], v0 | size0 << 16 | size1 << 20 | (c < 0) <<
//    24), which the chain overwrites with its record of k (w[k], best[k],
//    prefix[k + 1], chosen | zrl << 16 | (c < 0) << 17); position 0
//    records w[0] = 0 and prefix[64].
constexpr int kSlotFloats = 64 + 4;
constexpr int kRecBytes = 64 * 16 + 16;
constexpr int kRecBytesAll = kTeams * kRecBytes;

struct K16Geom {
  int w, h, sh, sv;
  int pw[3], ph[3];   // plane sizes
  int bw[3];          // blocks a row
  int off[4];         // first block of each component; off[3] = total
  int strips[3];      // strips a block row
  int cta_off[4];     // first CTA of each component; cta_off[3] = grid
  int pitch;          // staged bytes a pixel row (chroma rows of a subsampled frame)
};

// a row of a group's frame table (trellis_kernel)
struct K16Frame {
  long long rgb, out;  // the frame's pixels and coefficients on the card
  K16Geom g;
  int cta_first;       // the frame's first CTA in the launch
};

// natural index -> zigzag position, in global memory: the lanes read it at
// different indices
__device__ const uint8_t kNatToZigzag[64] = {
    0,  1,  5,  6,  14, 15, 27, 28, 2,  4,  7,  13, 16, 26, 29, 42,
    3,  8,  12, 17, 25, 30, 41, 43, 9,  11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63};

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ int bit_size(int v) { return 32 - __clz(v); }  // v >= 0
// component c's value of three (a launch parameter indexed at run time
// would be copied out of the parameter space)
__device__ __forceinline__ int pick(int c, int a0, int a1, int a2) {
  return c == 0 ? a0 : (c == 1 ? a1 : a2);
}

// Y, Cb or Cr of one pixel, in fc_jpeg_encode_trellis's order
__device__ __forceinline__ float ycc(const uint8_t* p, int c) {
  const float r = p[0], g = p[1], b = p[2];
  if (c == 0) return fadd(fadd(fmul(0.299f, r), fmul(0.587f, g)), fmul(0.114f, b));
  if (c == 1)
    return fadd(fadd(fsub(fmul(-0.168735892f, r), fmul(0.331264108f, g)), fmul(0.5f, b)),
                128.f);
  return fadd(fsub(fsub(fmul(0.5f, r), fmul(0.418687589f, g)), fmul(0.081312411f, b)), 128.f);
}

// n consecutive floats from 4n-byte-aligned shared memory
template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&dst)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      dst[i] = v.x;
      dst[i + 1] = v.y;
      dst[i + 2] = v.z;
      dst[i + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    dst[0] = v.x;
    dst[1] = v.y;
  } else {
    dst[0] = p[0];
  }
}

// the minimum of v over the team (a shuffle butterfly), two at once
__device__ __forceinline__ float team_min(float v) {
#pragma unroll
  for (int off = kLanes / 2; off >= 1; off >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, off, kLanes));
  return v;
}
__device__ __forceinline__ void team_min2(float& a, float& b) {
#pragma unroll
  for (int off = kLanes / 2; off >= 1; off >>= 1) {
    const float oa = __shfl_xor_sync(kFull, a, off, kLanes);
    const float ob = __shfl_xor_sync(kFull, b, off, kLanes);
    a = fminf(a, oa);
    b = fminf(b, ob);
  }
}

// this lane's first minimum over its run lengths of sum_i = w_i + rate_i
template <int N>
__device__ __forceinline__ float lane_min(const float (&w)[N], const float (&rate)[N]) {
  // the slot the last step filled (0) last: it waits on the chain
  float b = fadd(w[N - 1], rate[N - 1]);
#pragma unroll
  for (int i = N - 2; i >= 0; --i) b = fminf(b, fadd(w[i], rate[i]));
  return b;
}

// trellis::fdct8x8 of the team's block, read from and written to its slot
// (zigzag order): rows, then columns, each output summed by one lane
__device__ __forceinline__ void team_fdct(float* slot, float4* rec, const Table& tab,
                                          const uint8_t* zz, int tl) {
  if constexpr (kLanes <= 8) {
    constexpr int kU = kLanes <= 8 ? 8 / kLanes : 1;  // columns u a lane
    float cu[kU][8], tmp[kU][8];
#pragma unroll
    for (int j = 0; j < kU; ++j) load_row(tab.cos[tl * kU + j], cu[j]);
#pragma unroll
    for (int y = 0; y < 8; ++y) {
      float s[8];
      load_row(slot + y * 8, s);
#pragma unroll
      for (int j = 0; j < kU; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int x = 0; x < 8; ++x) acc = fadd(acc, fmul(s[x], cu[j][x]));
        tmp[j][y] = acc;
      }
    }
    __syncwarp();  // every sample read before the slot takes the outputs
#pragma unroll
    for (int j = 0; j < kU; ++j) {
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        float acc = 0.f;
#pragma unroll
        for (int y = 0; y < 8; ++y) acc = fadd(acc, fmul(tmp[j][y], tab.cos[v][y]));
        slot[zz[v * 8 + tl * kU + j]] = acc;
      }
    }
  } else {
    constexpr int kRows = 64 / kLanes;  // rows (then output rows) a lane
    const int u = tl & 7, y0 = (tl >> 3) * kRows;
    float* tmp = reinterpret_cast<float*>(rec);  // [y][u]
    float cu[8];
    load_row(tab.cos[u], cu);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float s[8];
      load_row(slot + (y0 + i) * 8, s);
      float acc = 0.f;
#pragma unroll
      for (int x = 0; x < 8; ++x) acc = fadd(acc, fmul(s[x], cu[x]));
      tmp[(y0 + i) * 8 + u] = acc;
    }
    __syncwarp();
    float col[8];
#pragma unroll
    for (int y = 0; y < 8; ++y) col[y] = tmp[y * 8 + u];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float acc = 0.f;
#pragma unroll
      for (int y = 0; y < 8; ++y) acc = fadd(acc, fmul(col[y], tab.cos[y0 + i][y]));
      slot[zz[(y0 + i) * 8 + u]] = acc;
    }
  }
}

// one CTA's strip of frame g (the CTA's number among the frame's, cta); g
// in shared memory
__device__ __forceinline__ void trellis_strip(const uint8_t* __restrict__ rgb,
                                              int16_t* __restrict__ out, const K16Geom& g,
                                              const float* __restrict__ params, const int cta) {
  __shared__ Table tab;
  __shared__ uint8_t zz[64];                              // natural -> zigzag
  __shared__ __align__(16) float slots[kTeams][kSlotFloats];
  // the strip's staged RGB bytes, then the teams' 64-float4 slots
  extern __shared__ __align__(16) uint8_t stage[];

#ifdef K16_PHASE_CLOCKS
  long long stamp[16] = {};  // [8], [9]: the chain's cycles and steps with a candidate; [10]: runs
#endif
  K16_CLOCK(0);
  const int tid = threadIdx.x;
  const int c = cta < g.cta_off[1] ? 0 : (cta < g.cta_off[2] ? 1 : 2);
  const int t = c == 0 ? 0 : 1;
  const int local = cta - pick(c, 0, g.cta_off[1], g.cta_off[2]);
  const int strips = pick(c, g.strips[0], g.strips[1], g.strips[2]);
  const int bw = pick(c, g.bw[0], g.bw[1], g.bw[2]);
  const int brow = local / strips;
  const int bcol0 = (local - brow * strips) * kTeams;
  const int nb = min(kTeams, bw - bcol0);
  const bool sub = c > 0 && (g.sh > 1 || g.sv > 1);
  const int fh = sub ? g.sh : 1, fv = sub ? g.sv : 1;

  // the component table's constants, the zigzag table and the strip's
  // pixels (rows [r0, r1), columns [c0, c1), as aligned 16-byte words: a
  // word holding a byte of the image lies in its allocation): every global
  // load of a batch issued before its shared stores
  const int r0 = brow * 8 * fv, r1 = min(r0 + 8 * fv, g.h);
  const int c0 = bcol0 * 8 * fh, c1 = min(c0 + nb * 8 * fh, g.w);
  const int pitch = sub ? g.pitch : kCols * 3 + 32;
  const int wpr = pitch / 16;
  {
    constexpr int kVecs = 16 + 16 + 44;  // cos, q[t], lrate[t] as float4
    constexpr int kPer = (kVecs + kThreads - 1) / kThreads;
    const float4* src = reinterpret_cast<const float4*>(params);
    float4 vec[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + j * kThreads;
      if (i < kVecs)
        vec[j] = src[i < 16 ? kWordCos / 4 + i
                            : (i < 32 ? (kWordQ + 64 * t) / 4 + i - 16
                                      : (kWordRate + 176 * t) / 4 + i - 32)];
    }
    constexpr int kZz = (64 + kThreads - 1) / kThreads;
    uint8_t zv[kZz];
#pragma unroll
    for (int j = 0; j < kZz; ++j)
      if (tid + j * kThreads < 64) zv[j] = kNatToZigzag[tid + j * kThreads];
    const float lzrl = params[kWordZrl + t], leob = params[kWordEob + t];
    // word wi of staged row rr, for i = rr * wpr + wi = tid + j * kThreads
    const uint4* words = reinterpret_cast<const uint4*>(rgb);
    const int rows = r1 - r0, step_rr = kThreads / wpr, step_wi = kThreads - step_rr * wpr;
    int rr = tid / wpr, wi = tid - rr * wpr;
    constexpr int kBatch = 4;
    uint4 w[kBatch];
    int at[kBatch];
    // the first batch's loads go out with the constants'; the rest (the
    // rows of subsampled chroma) a batch at a time
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const size_t start = (static_cast<size_t>(r0 + rr) * g.w + c0) * 3;
      const size_t word = (start >> 4) + wi;
      at[j] = -1;
      if (rr < rows && word <= ((start + static_cast<size_t>(c1 - c0) * 3 - 1) >> 4)) {
        w[j] = words[word];
        at[j] = rr * pitch + wi * 16;
      }
      rr += step_rr;
      wi += step_wi;
      if (wi >= wpr) {
        wi -= wpr;
        ++rr;
      }
    }
    float4* dst = reinterpret_cast<float4*>(&tab.cos[0][0]);  // cos, q, lrate in a row
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (tid + j * kThreads < kVecs) dst[tid + j * kThreads] = vec[j];
#pragma unroll
    for (int j = 0; j < kZz; ++j)
      if (tid + j * kThreads < 64) zz[tid + j * kThreads] = zv[j];
    if (tid == 0) {
      tab.lzrl = lzrl;
      tab.leob = leob;
    }
    while (true) {
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (at[j] >= 0) *reinterpret_cast<uint4*>(stage + at[j]) = w[j];
      if (rr >= rows) break;
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const size_t start = (static_cast<size_t>(r0 + rr) * g.w + c0) * 3;
        const size_t word = (start >> 4) + wi;
        at[j] = -1;
        if (rr < rows && word <= ((start + static_cast<size_t>(c1 - c0) * 3 - 1) >> 4)) {
          w[j] = words[word];
          at[j] = rr * pitch + wi * 16;
        }
        rr += step_rr;
        wi += step_wi;
        if (wi >= wpr) {
          wi -= wpr;
          ++rr;
        }
      }
    }
  }
  __syncthreads();
  K16_CLOCK(1);

  // the strip's plane, minus 128, edges replicated, into the teams' slots
  // (a thread a column; a team past the strip's end gets its last block)
  {
    const int pw = pick(c, g.pw[0], g.pw[1], g.pw[2]), ph = pick(c, g.ph[0], g.ph[1], g.ph[2]);
    const int w16 = g.w & 15;  // a row's first byte modulo 16 is (y * w + c0) * 3 mod 16
    for (int xx = tid; xx < kCols; xx += kThreads) {
      const int sx = min(bcol0 * 8 + min(xx, (nb - 1) * 8 + (xx & 7)), pw - 1);
      float* col = &slots[xx >> 3][xx & 7];
      if (!sub) {
#pragma unroll
        for (int yy = 0; yy < 8; ++yy) {
          const int sy = min(brow * 8 + yy, ph - 1);
          const int lead = ((sy * w16 + c0) * 3) & 15;
          col[yy * 8] = fsub(ycc(stage + (sy - r0) * pitch + lead + (sx - c0) * 3, c), 128.f);
        }
      } else {
        for (int yy = 0; yy < 8; ++yy) {
          const int sy = min(brow * 8 + yy, ph - 1);
          float acc = 0.f;
          int cnt = 0;
          for (int dy = 0; dy < fv; ++dy) {
            const int y = sy * fv + dy;
            if (y >= g.h) break;
            const uint8_t* row = stage + (y - r0) * pitch + (((y * w16 + c0) * 3) & 15);
            for (int dx = 0; dx < fh; ++dx) {
              const int x = sx * fh + dx;
              if (x >= g.w) break;
              acc = fadd(acc, ycc(row + (x - c0) * 3, c));
              ++cnt;
            }
          }
          col[yy * 8] = fsub(__fdiv_rn(acc, static_cast<float>(cnt)), 128.f);
        }
      }
    }
  }
  __syncthreads();
  K16_CLOCK(2);

  // a team a block; a team past the strip's end repeats its last block and
  // stores nothing
  const int team = tid / kLanes, tl = tid % kLanes;
  float* slot = slots[team];
  float4* rec = reinterpret_cast<float4*>(stage + team * kRecBytes);
  team_fdct(slot, rec, tab, zz, tl);
  __syncwarp();
  K16_CLOCK(3);

  // per position (lane tl: k = tl + i * kLanes): DC, or the program's
  // values (c^2 back into the slot for the prefix sums)
  int16_t dc = 0;
  int v0s[kPos], size0s[kPos], size1s[kPos];
#pragma unroll
  for (int i = 0; i < kPos; ++i) {
    const int k = tl + i * kLanes;
    const float cz = slot[k];
    const float q = tab.q[k];
    v0s[i] = size0s[i] = size1s[i] = 0;
    if (k == 0) {
      const float d = __fdiv_rn(cz, q);
      dc = static_cast<int16_t>(static_cast<int>(d < 0 ? fsub(d, 0.5f) : fadd(d, 0.5f)));
    } else {
      const float a = fabsf(cz);
      const int v0 = min(static_cast<int>(fadd(__fdiv_rn(a, q), 0.5f)), 1023);
      const int v1 = max(v0 - 1, 0);
      const float d0 = fsub(a, fmul(static_cast<float>(v0), q));
      const float d1 = fsub(a, fmul(static_cast<float>(v1), q));
      v0s[i] = v0;
      size0s[i] = bit_size(v0);
      size1s[i] = bit_size(v1);
      rec[k] = make_float4(fmul(d0, d0), fmul(d1, d1), 0.f,
                           __int_as_float(v0 | size0s[i] << 16 | size1s[i] << 20 |
                                          (cz < 0.f ? 1 << 24 : 0)));
      slot[k] = fmul(cz, cz);
    }
  }
  // for the warp: the positions where some block has a candidate, and
  // where some block's v0 - 1 has a size of its own
  uint64_t any_mask = 0, two_mask = 0;
#pragma unroll
  for (int i = 0; i < kPos; ++i) {
    unsigned any = __ballot_sync(kFull, v0s[i] >= 1);
    unsigned two = __ballot_sync(kFull, v0s[i] >= 2 && size1s[i] != size0s[i]);
#pragma unroll
    for (int f = kLanes; f < 32; f <<= 1) {
      any |= any >> f;
      two |= two >> f;
    }
    constexpr unsigned kTeamBits = kLanes == 32 ? kFull : (1u << kLanes) - 1;
    any_mask |= static_cast<uint64_t>(any & kTeamBits) << (i * kLanes);
    two_mask |= static_cast<uint64_t>(two & kTeamBits) << (i * kLanes);
  }
  __syncwarp();
  K16_CLOCK(4);

  // the prefix sums of c^2, one sequential f32 sum in position order, into
  // the values' .z; then the slot holds the output: zeros and the DC
  if (tl == 0) {
    float acc = 0.f;  // prefix[1]
#pragma unroll
    for (int base = 1; base < 64; base += 16) {  // 16 loads in flight, then their sums
      float sq[16];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (base + j < 64) sq[j] = slot[base + j];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (base + j < 64) {
          rec[base + j].z = acc;
          acc = fadd(acc, sq[j]);
        }
      }
    }
    rec[0] = make_float4(0.f, 1e30f, acc, 0.f);  // w[0] = 0; prefix[64]
  }
  __syncwarp();
  int16_t* outz = reinterpret_cast<int16_t*>(slot);
  uint8_t* prev = reinterpret_cast<uint8_t*>(slot) + 128;
  for (int i = tl; i < 8; i += kLanes)
    reinterpret_cast<uint4*>(outz)[i] = make_uint4(i == 0 ? static_cast<uint16_t>(dc) : 0u,
                                                   0u, 0u, 0u);
  const float p64 = rec[0].z;

  // the chain: lane tl holds w[k - 1 - m] for m = tl * kM + i. A position
  // where some block of the warp has a candidate is one step; a run of up
  // to 16 positions where none has one is one turn of the window, since
  // there w[j] is the ZRL fold of w[j - 16] (or 1e30) and depends on
  // nothing newer
  const float inf = __int_as_float(0x7f800000);
  const float lzrl = tab.lzrl, leob = tab.leob;
  const float* rates = &tab.lrate[0][0];
  const int mbase = (tl * kM) & 15;
  float win[kM];
#pragma unroll
  for (int i = 0; i < kM; ++i) win[i] = tl * kM + i == 0 ? 0.f : inf;
  int k = 1;
#pragma unroll 1
  while (k < 64) {
#ifdef K16_PHASE_CLOCKS
    const long long step0 = clock64();
#endif
    const uint64_t rest = any_mask >> k;
    if (rest & 1) {
      const float4 in = rec[k];
      const float pnext = k < 63 ? rec[k + 1].z : p64;
      const int pk = __float_as_int(in.w);
      const int v0 = pk & 0xffff, size0 = (pk >> 16) & 15, size1 = (pk >> 20) & 15;
      float rate0[kM];
      load_row(rates + size0 * 16 + mbase, rate0);
      // w[k - 16] (lane 15 / kM's last slot), off the chain
      const float z = fadd(__shfl_sync(kFull, win[kM - 1], 15 / kM, kLanes), lzrl);
      const float up = __shfl_up_sync(kFull, win[kM - 1], 1, kLanes);
      // the minima over m: this lane's, then the team's; v0 - 1 of v0's
      // size has v0's minimum
      float b0 = lane_min(win, rate0), b1;
      if ((two_mask >> k) & 1) {
        float rate1[kM];
        load_row(rates + size1 * 16 + mbase, rate1);
        b1 = lane_min(win, rate1);
        team_min2(b0, b1);
      } else {
        b0 = team_min(b0);
        b1 = b0;
      }
      const float cost0 = fadd(fadd(in.x, in.z), b0);
      const float cost1 = fadd(fadd(in.y, in.z), b1);
      float best = 1e30f;
      int chosen = 0;
      if (v0 >= 1 && cost0 < best) {
        best = cost0;
        chosen = v0;
      }
      if (v0 >= 2 && cost1 < best) {
        best = cost1;
        chosen = v0 - 1;
      }
      const float gk = best < 1e29f ? fsub(best, pnext) : 1e30f;
      const bool zrl = k >= 16 && z < gk;
      const float wk = zrl ? z : gk;
      __syncwarp();  // every lane has read k's values before they are overwritten
      if (tl == 0)
        rec[k] = make_float4(wk, best, pnext,
                             __int_as_float(chosen | zrl << 16 | ((pk >> 24) & 1) << 17));
#pragma unroll
      for (int i = kM - 1; i > 0; --i) win[i] = win[i - 1];
      win[0] = tl == 0 ? wk : up;
      if (kLanes * kM > 16 && tl * kM >= 16) win[0] = inf;
#ifdef K16_PHASE_CLOCKS
      stamp[8] += clock64() - step0;
      stamp[9] += 1;
#endif
      k += 1;
    } else {
      // positions k .. k + r - 1: the window turns by r, and its r newest
      // entries (m < r: position k + r - 1 - m) fold w[j - 16], which the
      // turn brings them from m + 16 - r
      const int r = min(rest ? __ffsll(static_cast<long long>(rest)) - 1 : 64 - k, 16);
      float turned[kM];
#pragma unroll
      for (int i = 0; i < kM; ++i) {
        const int from = (i - r) & (kM - 1);  // the slot each lane sends
        float send = win[0];
#pragma unroll
        for (int j = 1; j < kM; ++j)
          if (from == j) send = win[j];
        const int m = tl * kM + i;
        float v = __shfl_sync(kFull, send, ((m - r) & 15) / kM, kLanes);
        if (m < r) {
          const int j = k + r - 1 - m;
          const float zf = fadd(v, lzrl);
          const bool zrl = j >= 16 && zf < 1e30f;
          v = zrl ? zf : 1e30f;
          rec[j] = make_float4(v, 1e30f, 0.f, __int_as_float(zrl ? 1 << 16 : 0));
        }
        turned[i] = m < 16 ? v : inf;
      }
#pragma unroll
      for (int i = 0; i < kM; ++i) win[i] = turned[i];
#ifdef K16_PHASE_CLOCKS
      stamp[10] += clock64() - step0;
#endif
      k += r;
    }
  }
  __syncwarp();
  K16_CLOCK(5);

  // the chosen positions, a lane's share of them at a time: their costs
  // as the last nonzero position (the first minimum, the all-zero block
  // first), and their back pointers (the chosen size's first minimum over
  // m again, then the ZRL folds back to its position)
  uint64_t chosen_mask = 0;
#pragma unroll
  for (int i = 0; i < kPos; ++i) {
    const int kk = tl + i * kLanes;
    const unsigned b = __ballot_sync(kFull, kk > 0 && (__float_as_int(rec[kk].w) & 0xffff));
    chosen_mask |= static_cast<uint64_t>((b >> (tid & 31 & ~(kLanes - 1))) &
                                         (kLanes == 32 ? kFull : (1u << kLanes) - 1))
                   << (i * kLanes);
  }
  int last;
  {
    float lv = inf;
    int lk = 64;
    uint64_t mine = chosen_mask;
    for (int j = 0; j < tl && mine; ++j) mine &= mine - 1;
    while (mine) {
      const int kk = __ffsll(static_cast<long long>(mine)) - 1;
      const float4 r = rec[kk];
      if (r.y < 1e29f) {
        const float cost = fadd(fadd(r.y, fsub(p64, r.z)), kk < 63 ? leob : 0.f);
        if (cost < lv || (cost == lv && kk < lk)) {
          lv = cost;
          lk = kk;
        }
      }
      const float* rr = rates + bit_size(__float_as_int(r.w) & 0xffff) * 16;
      // the first minimum over m < min(kk, 16), as a tree of neighbouring
      // ranges: the lower range's keeps unless the higher's is strictly less
      float cand[16];
      int arg[16];
#pragma unroll
      for (int m = 0; m < 16; ++m) {
        cand[m] = m < kk ? fadd(rec[kk - 1 - m].x, rr[m]) : inf;
        arg[m] = m;
      }
#pragma unroll
      for (int stride = 1; stride < 16; stride <<= 1) {
#pragma unroll
        for (int m = 0; m < 16; m += 2 * stride) {
          if (cand[m + stride] < cand[m]) {
            cand[m] = cand[m + stride];
            arg[m] = arg[m + stride];
          }
        }
      }
      int p = kk - 1 - arg[0];
      while ((__float_as_int(rec[p].w) >> 16) & 1) p -= 16;
      prev[kk] = static_cast<uint8_t>(p);
      for (int j = 0; j < kLanes && mine; ++j) mine &= mine - 1;
    }
#pragma unroll
    for (int off = kLanes / 2; off >= 1; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, lv, off, kLanes);
      const int ok = __shfl_xor_sync(kFull, lk, off, kLanes);
      if (ov < lv || (ov == lv && ok < lk)) {
        lv = ov;
        lk = ok;
      }
    }
    last = lv < fadd(p64, leob) ? lk : 0;
  }
  __syncwarp();
  K16_CLOCK(6);
  if (tl == 0) {
    for (int kk = last; kk > 0; kk = prev[kk]) {
      const int f = __float_as_int(rec[kk].w);
      outz[kk] = static_cast<int16_t>((f >> 17) & 1 ? -(f & 0xffff) : f & 0xffff);
    }
  }
  __syncwarp();
  K16_CLOCK(7);
  const size_t blk = static_cast<size_t>(pick(c, 0, g.off[1], g.off[2])) +
                     static_cast<size_t>(brow) * bw + bcol0 + team;
#ifdef K16_PHASE_CLOCKS
  if (team < nb && tl == 0) {
    long long* dst = reinterpret_cast<long long*>(out + blk * 64);
#pragma unroll
    for (int i = 0; i < 16; ++i) dst[i] = stamp[i];
  }
  return;
#endif
  if (team < nb) {
    uint4* dst = reinterpret_cast<uint4*>(out + blk * 64);
    for (int i = tl; i < 8; i += kLanes) dst[i] = reinterpret_cast<const uint4*>(outz)[i];
  }
}

// a group's frames in one launch: CTA i works a strip of the frame whose
// CTAs it falls among (binary search over the frames' first CTAs). The
// frame's row goes to shared memory first: held in registers, its fields
// would stay live across the whole strip (as a kernel parameter they were
// free operands). 16 CTAs an SM, so 64 registers: unasked, ptxas takes 72,
// which fit 14; shared memory fits 17 at 4:4:4.
__global__ void __launch_bounds__(kThreads, 16)
trellis_kernel(const K16Frame* __restrict__ frames, int nframes,
               const float* __restrict__ params) {
  __shared__ K16Frame row;
  int lo = 0, hi = nframes - 1;
  const int cta = blockIdx.x;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (frames[mid].cta_first <= cta) lo = mid;
    else hi = mid - 1;
  }
  constexpr int kWords = sizeof(K16Frame) / 4;
  static_assert(kWords <= kThreads, "a thread a word of the frame's row");
  if (threadIdx.x < kWords)
    reinterpret_cast<int*>(&row)[threadIdx.x] =
        reinterpret_cast<const int*>(frames + lo)[threadIdx.x];
  __syncthreads();
  trellis_strip(reinterpret_cast<const uint8_t*>(row.rgb), reinterpret_cast<int16_t*>(row.out),
                row.g, params, cta - row.cta_first);
}

}  // namespace

namespace {

// the launch geometry of one frame; returns its dynamic shared bytes
int make_geom(int width, int height, int samp_h, int samp_v, K16Geom* out) {
  K16Geom& g = *out;
  g.w = width;
  g.h = height;
  g.sh = samp_h;
  g.sv = samp_v;
  g.pw[0] = width;
  g.ph[0] = height;
  g.pw[1] = g.pw[2] = (width + samp_h - 1) / samp_h;
  g.ph[1] = g.ph[2] = (height + samp_v - 1) / samp_v;
  g.off[0] = 0;
  g.cta_off[0] = 0;
  for (int c = 0; c < 3; ++c) {
    // libjpeg's width_in_blocks / height_in_blocks
    const int h = c == 0 ? samp_h : 1, v = c == 0 ? samp_v : 1;
    g.bw[c] = (width * h + 8 * samp_h - 1) / (8 * samp_h);
    const int bh = (height * v + 8 * samp_v - 1) / (8 * samp_v);
    g.off[c + 1] = g.off[c] + g.bw[c] * bh;
    g.strips[c] = (g.bw[c] + kTeams - 1) / kTeams;
    g.cta_off[c + 1] = g.cta_off[c] + g.strips[c] * bh;
  }
  // staged rows: a strip's pixels with 32 bytes of slack for the first and
  // last 16-byte word; 8 * v of them for subsampled chroma
  g.pitch = kCols * 3 * samp_h + 32;
  const int rgb_bytes = (samp_h * samp_v > 1 ? 8 * samp_v * g.pitch : 8 * (kCols * 3 + 32));
  return rgb_bytes > kRecBytesAll ? rgb_bytes : kRecBytesAll;
}

bool bad_frame(int width, int height, int samp_h, int samp_v) {
  return width < 1 || height < 1 || samp_h < 1 || samp_h > 4 || samp_v < 1 || samp_v > 4 ||
         samp_h * samp_v > 8;
}

}  // namespace

// A frame's row of a group's frame table, written to row (K16Frame bytes,
// on the host): its pixels (rgb, 16-byte aligned) and coefficients (out)
// on the card, its geometry and first CTA (cta_first). Returns the frame's
// CTAs, or -1 for a size or sampling K16 does not take; *smem receives its
// dynamic shared bytes (a group's frames share their sampling, so one).
extern "C" int flyimg_jpeg_trellis_frame(const uint8_t* rgb, int16_t* out, int width, int height,
                                         int samp_h, int samp_v, int cta_first, void* row,
                                         int* smem) {
  if (bad_frame(width, height, samp_h, samp_v) || reinterpret_cast<uintptr_t>(rgb) % 16)
    return -1;
  K16Frame f;
  f.rgb = reinterpret_cast<long long>(rgb);
  f.out = reinterpret_cast<long long>(out);
  f.cta_first = cta_first;
  *smem = make_geom(width, height, samp_h, samp_v, &f.g);
  *static_cast<K16Frame*>(row) = f;
  return f.g.cta_off[3];
}

// The bytes of a K16Frame (the wrapper's table stride).
extern "C" int flyimg_jpeg_trellis_frame_bytes() { return static_cast<int>(sizeof(K16Frame)); }

// frames: nframes K16Frame rows on the card, in order of their first CTA;
// ctas: the CTAs of all; smem: the frames' dynamic shared bytes; params:
// the K16Params words (jpeg_tables.trellis_param_block) on the card,
// 16-byte aligned. One launch for the group's frames. Returns a CUDA
// error code (0 = launched).
extern "C" int flyimg_jpeg_trellis_frames(const void* frames, int nframes, int ctas, int smem,
                                          const float* params, void* stream) {
  if (nframes < 1 || ctas < 1 || !params || reinterpret_cast<uintptr_t>(params) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  trellis_kernel<<<ctas, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const K16Frame*>(frames), nframes, params);
  return static_cast<int>(cudaGetLastError());
}
