// K16: the trellis JPEG encoder's coefficients, one launch an encode.
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
//
// What bounds it on an H100: neither bytes (3 bytes a pixel in, 128
// bytes a block out) nor the FDCT's ~2k flops a block; the trellis is a
// sequential DP of up to 63 x 2 x 16 steps a block with data-dependent
// branches. Design (simple first): a thread a block, its DP state in
// local memory, the constants (cosines, quantizers, lambda-rates) staged
// in shared memory by each CTA so the DP's divergent table reads do not
// serialise on the constant bank. A warp-per-block form is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

struct K16Params {
  float cos[8][8];
  float q[2][64];          // zigzag order
  float lrate[2][11][16];  // [table][size][run], lambda * (code bits + size)
  float lzrl[2];
  float leob[2];
};

struct K16Geom {
  int w, h, sh, sv;
  int pw[3], ph[3];   // plane sizes
  int bw[3];          // blocks a row
  int off[4];         // first block of each component; off[3] = total
};

__constant__ int kZigzagToNat[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }

// Y, Cb or Cr of one pixel, in fc_jpeg_encode_trellis's order
__device__ float ycc(const uint8_t* rgb, int w, int y, int x, int c) {
  const uint8_t* p = rgb + (static_cast<size_t>(y) * w + x) * 3;
  const float r = p[0], g = p[1], b = p[2];
  if (c == 0) return fadd(fadd(fmul(0.299f, r), fmul(0.587f, g)), fmul(0.114f, b));
  if (c == 1)
    return fadd(fadd(fsub(fmul(-0.168735892f, r), fmul(0.331264108f, g)), fmul(0.5f, b)),
                128.f);
  return fadd(fsub(fsub(fmul(0.5f, r), fmul(0.418687589f, g)), fmul(0.081312411f, b)), 128.f);
}

// one sample of component c's plane at (sy, sx) (inside the plane)
__device__ float plane_sample(const uint8_t* rgb, const K16Geom& g, int c, int sy, int sx) {
  if (c == 0 || (g.sh == 1 && g.sv == 1)) return ycc(rgb, g.w, sy, sx, c);
  float acc = 0.f;
  int cnt = 0;
  for (int dy = 0; dy < g.sv; ++dy) {
    for (int dx = 0; dx < g.sh; ++dx) {
      const int y = sy * g.sv + dy, x = sx * g.sh + dx;
      if (y < g.h && x < g.w) {
        acc = fadd(acc, ycc(rgb, g.w, y, x, c));
        ++cnt;
      }
    }
  }
  return __fdiv_rn(acc, static_cast<float>(cnt));
}

__device__ __forceinline__ int bit_size(int v) {
  int size = 0;
  while (v) {
    ++size;
    v >>= 1;
  }
  return size;
}

// trellis::trellis_ac: cz, qz zigzag; writes outz[1..63]
__device__ void trellis_ac(const float* cz, const float* qz, const float (*lrate)[16],
                           float lzrl, float leob, int16_t* outz) {
  float best[64];
  int prev_nz[64];
  int chosen[64];
  float prefix[65];
  float w[64];
  int wj[64];
  prefix[1] = 0.f;
  for (int k = 1; k < 64; ++k) prefix[k + 1] = fadd(prefix[k], fmul(cz[k], cz[k]));
  w[0] = 0.f;
  wj[0] = 0;
  for (int k = 1; k < 64; ++k) {
    best[k] = 1e30f;
    prev_nz[k] = 0;
    chosen[k] = 0;
    const float a = fabsf(cz[k]);
    const float q = qz[k];
    int v0 = static_cast<int>(fadd(__fdiv_rn(a, q), 0.5f));
    if (v0 > 1023) v0 = 1023;
    if (v0 >= 1) {
      const int mmax = (k - 1 < 15) ? k - 1 : 15;
      for (int dv = 0; dv <= 1; ++dv) {
        const int v = v0 - dv;
        if (v < 1) break;
        const int size = bit_size(v);
        if (size > 10) continue;
        const float d = fsub(a, fmul(static_cast<float>(v), q));
        const float fixed = fadd(fmul(d, d), prefix[k]);
        const float* rates = lrate[size];
        float bc = fadd(w[k - 1], rates[0]);
        int bm = 0;
        for (int m = 1; m <= mmax; ++m) {
          const float c = fadd(w[k - 1 - m], rates[m]);
          if (c < bc) {
            bc = c;
            bm = m;
          }
        }
        const float cost = fadd(fixed, bc);
        if (cost < best[k]) {
          best[k] = cost;
          prev_nz[k] = wj[k - 1 - bm];
          chosen[k] = v;
        }
      }
    }
    const float g = (best[k] < 1e29f) ? fsub(best[k], prefix[k + 1]) : 1e30f;
    if (k >= 16 && fadd(w[k - 16], lzrl) < g) {
      w[k] = fadd(w[k - 16], lzrl);
      wj[k] = wj[k - 16];
    } else {
      w[k] = g;
      wj[k] = k;
    }
  }
  float total_best = fadd(prefix[64], leob);
  int last = 0;
  for (int k = 1; k < 64; ++k) {
    if (best[k] >= 1e29f) continue;
    const float tail = fsub(prefix[64], prefix[k + 1]);
    const float cost = fadd(fadd(best[k], tail), k < 63 ? leob : 0.f);
    if (cost < total_best) {
      total_best = cost;
      last = k;
    }
  }
  for (int k = 1; k < 64; ++k) outz[k] = 0;
  for (int k = last; k > 0; k = prev_nz[k]) {
    outz[k] = static_cast<int16_t>(cz[k] < 0 ? -chosen[k] : chosen[k]);
  }
}

__global__ void __launch_bounds__(kThreads)
trellis_kernel(const uint8_t* __restrict__ rgb, int16_t* __restrict__ out, K16Geom g,
               K16Params params) {
  __shared__ K16Params sp;
  {
    const float* src = reinterpret_cast<const float*>(&params);
    float* dst = reinterpret_cast<float*>(&sp);
    for (int i = threadIdx.x; i < static_cast<int>(sizeof(K16Params) / 4); i += blockDim.x)
      dst[i] = src[i];
  }
  __syncthreads();
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= g.off[3]) return;
  const int c = idx < g.off[1] ? 0 : (idx < g.off[2] ? 1 : 2);
  const int t = c == 0 ? 0 : 1;
  const int local = idx - g.off[c];
  const int brow = local / g.bw[c], bcol = local - brow * g.bw[c];
  const int pw = g.pw[c], ph = g.ph[c];

  float samples[64];
  for (int yy = 0; yy < 8; ++yy) {
    const int sy = min(brow * 8 + yy, ph - 1);
    for (int xx = 0; xx < 8; ++xx) {
      const int sx = min(bcol * 8 + xx, pw - 1);
      samples[yy * 8 + xx] = fsub(plane_sample(rgb, g, c, sy, sx), 128.f);
    }
  }
  // trellis::fdct8x8: rows, then columns
  float tmp[64];
  for (int y = 0; y < 8; ++y) {
    for (int u = 0; u < 8; ++u) {
      float s = 0.f;
      for (int x = 0; x < 8; ++x) s = fadd(s, fmul(samples[y * 8 + x], sp.cos[u][x]));
      tmp[y * 8 + u] = s;
    }
  }
  float dct[64];
  for (int u = 0; u < 8; ++u) {
    for (int v = 0; v < 8; ++v) {
      float s = 0.f;
      for (int y = 0; y < 8; ++y) s = fadd(s, fmul(tmp[y * 8 + u], sp.cos[v][y]));
      dct[v * 8 + u] = s;
    }
  }
  float cz[64];
  for (int k = 0; k < 64; ++k) cz[k] = dct[kZigzagToNat[k]];
  int16_t outz[64];
  const float dc = __fdiv_rn(cz[0], sp.q[t][0]);
  outz[0] = static_cast<int16_t>(static_cast<int>(dc < 0 ? fsub(dc, 0.5f) : fadd(dc, 0.5f)));
  trellis_ac(cz, sp.q[t], sp.lrate[t], sp.lzrl[t], sp.leob[t], outz);
  int16_t* dst = out + static_cast<size_t>(idx) * 64;
  for (int k = 0; k < 64; ++k) dst[k] = outz[k];
}

}  // namespace

// rgb: [height][width][3] u8 on the card; out: int16 [blocks][64];
// params: the host's K16Params (jpeg_tables.trellis_param_block), copied
// into the launch. Returns a CUDA error code (0 = launched).
extern "C" int flyimg_jpeg_trellis(const uint8_t* rgb, int16_t* out, int width, int height,
                                   int samp_h, int samp_v, const float* params, void* stream) {
  if (width < 1 || height < 1 || samp_h < 1 || samp_h > 4 || samp_v < 1 || samp_v > 4 ||
      samp_h * samp_v > 8 || !params)
    return static_cast<int>(cudaErrorInvalidValue);
  K16Geom g;
  g.w = width;
  g.h = height;
  g.sh = samp_h;
  g.sv = samp_v;
  g.pw[0] = width;
  g.ph[0] = height;
  g.pw[1] = g.pw[2] = (width + samp_h - 1) / samp_h;
  g.ph[1] = g.ph[2] = (height + samp_v - 1) / samp_v;
  g.off[0] = 0;
  for (int c = 0; c < 3; ++c) {
    // libjpeg's width_in_blocks / height_in_blocks
    const int h = c == 0 ? samp_h : 1, v = c == 0 ? samp_v : 1;
    g.bw[c] = (width * h + 8 * samp_h - 1) / (8 * samp_h);
    const int bh = (height * v + 8 * samp_v - 1) / (8 * samp_v);
    g.off[c + 1] = g.off[c] + g.bw[c] * bh;
  }
  K16Params p;
  const float* src = params;
  float* dst = reinterpret_cast<float*>(&p);
  for (size_t i = 0; i < sizeof(K16Params) / 4; ++i) dst[i] = src[i];
  const int grid = (g.off[3] + kThreads - 1) / kThreads;
  trellis_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(rgb, out, g, p);
  return static_cast<int>(cudaGetLastError());
}
