// K7: face-region pixelation of one u8 image: factor x factor block mean
// (partial blocks edge-padded), nearest upsample, select inside any of the
// boxes, round half to even, clip, u8 store.
//
// Replaces the JAX package's flyimg_tpu/ops/pixelate.py _block_pixelate /
// pixelate_regions and the round/clip/u8 of
// flyimg_tpu/models/facefind.py blur_faces, which XLA runs as a handful of
// fused programs.
//
// Semantics, per output pixel (y, x):
//   - inside = any box (bx, by, bw, bh) with x >= bx, x < bx + bw,
//     y >= by, y < by + bh, all in f32 (zero-area boxes never match);
//   - outside: the source pixel, unchanged;
//   - inside: the mean of the pixel's block (rows and columns past the
//     image clamp to its last row and column, as an edge pad does): the
//     block's integer sum times inv = f32(1 / factor^2), the form XLA
//     gives the JAX package's jitted mean; rounded half to even (rintf),
//     clipped to [0, 255].
//
// What bounds it on an H100: bytes and launch latency. Every pixel is read
// once and written once (6 bytes; 1.8 MB for a 480x640 answer, 0.55 us at
// the card's rate), so the kernel has to keep its loads in flight together
// and do little else. Design: a block of 256 threads owns a band of
// `factor` rows by a run of whole pixel blocks (at most kRunPx pixels, ~4 a
// thread: a band that meets a box is bound by its latency, and the slowest
// band sets the kernel's time). Each thread loads one aligned 16-byte word
// of the band (the words that cover each row) into registers, and one box,
// both in flight together; the block culls the boxes against its rectangle
// (a conservative f32 test, so a box that holds any of its pixels is kept).
// A band that meets no box stores its words straight back: 16-byte stores,
// bytes at the unaligned ends of a row. A band that meets a box puts them
// in shared memory, sums each (block, channel) exactly in integers (a row's
// partial at a time, added by shared atomics: the lanes of a warp add into
// different sums), rewrites the pixels inside a kept box in place, and
// stores the words back the same way. (Summing straight from the register
// words was slower on an H100, 0.0106 against 0.0047 ms: neighbouring lanes
// add into the same sum, and a warp's atomics on one address serialise.)
// Faces cover a small share of an image, so most bands are copies.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBoxes = kThreads;  // a box a thread
// a band's run: at most kRunPx pixels (rows x columns) and kRunCols columns,
// so a box's band is ~4 pixels a thread (the box path is latency-bound)
constexpr int kRunPx = 1024;
constexpr int kRunCols = 256;
// the aligned 16-byte words that cover a band's rows are one a thread
static_assert((3 * kRunPx + 30 * 32) / 16 <= kThreads, "a band is one word a thread");
constexpr int kSums = 3 * kRunCols;  // block x channel sums of a band

__device__ __forceinline__ uint8_t to_u8(float a) {
    return (uint8_t)fminf(fmaxf(rintf(a), 0.0f), 255.0f);
}

// the bytes of `word` (a row's bytes [at, at + 16)) that lie in [0, len),
// stored at row + at: one 16-byte store when all do and row + at is aligned
__device__ __forceinline__ void store_word(uint8_t* row, int at, int len, uint4 word) {
    if (at >= 0 && at + 16 <= len && ((uintptr_t)(row + at) & 15) == 0) {
        *reinterpret_cast<uint4*>(row + at) = word;
        return;
    }
    const uint32_t v[4] = {word.x, word.y, word.z, word.w};
#pragma unroll
    for (int k = 0; k < 16; ++k)
        if (at + k >= 0 && at + k < len) row[at + k] = (uint8_t)(v[k >> 2] >> (8 * (k & 3)));
}

__global__ void __launch_bounds__(kThreads) pixelate_kernel(
    const uint8_t* __restrict__ in, const float* __restrict__ boxes, uint8_t* __restrict__ out,
    int h, int w, int nbox, int factor, float inv, int run_blocks) {
    __shared__ float4 sbox[kMaxBoxes];
    __shared__ int nkept;
    __shared__ uint4 stage[kThreads];
    __shared__ int sums[kSums];

    const int tid = threadIdx.x;
    const int y0 = blockIdx.x * factor;
    const int y1 = min(h, y0 + factor);
    const int x0 = blockIdx.y * run_blocks * factor;
    const int x1 = min(w, x0 + run_blocks * factor);
    const int rows = y1 - y0, cols = x1 - x0, len = 3 * cols;
    const int nb = (cols + factor - 1) / factor;
    auto row_at = [&](int r) { return ((size_t)(y0 + r) * w + x0) * 3; };
    if (tid == 0) nkept = 0;
    for (int i = tid; i < nb * 3; i += kThreads) sums[i] = 0;

    // this thread's word of the band: word i of row r's aligned words, which
    // cover [a & ~15, a + len) for the row's first byte a; it holds the row's
    // bytes [at, at + 16). Its load, and the box's, fly together.
    const int wcap = (len + 30) >> 4;  // words a row spans at most
    const int r = tid / wcap, i = tid - r * wcap;
    const int at = 16 * i - (r < rows ? (int)((uintptr_t)(in + row_at(r)) & 15) : 0);
    const bool mine = r < rows && at < len;
    uint4 word = make_uint4(0, 0, 0, 0);
    if (mine) word = __ldcs(reinterpret_cast<const uint4*>(in + row_at(r) + at));
    float4 box = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (tid < nbox)
        box = make_float4(boxes[4 * tid], boxes[4 * tid + 1], boxes[4 * tid + 2],
                          boxes[4 * tid + 3]);
    __syncthreads();  // nkept and the sums are 0

    // cull: keep the boxes that may hold a pixel of [x0, x1) x [y0, y1)
    if (tid < nbox && (float)(x1 - 1) >= box.x && (float)x0 < __fadd_rn(box.x, box.z) &&
        (float)(y1 - 1) >= box.y && (float)y0 < __fadd_rn(box.y, box.w))
        sbox[atomicAdd(&nkept, 1)] = box;
    __syncthreads();
    const int kept = nkept;
    if (kept == 0) {  // a copy
        if (mine) store_word(out + row_at(r), at, len, word);
        return;
    }

    // the band in shared memory, row r at the same alignment as in device
    // memory: its first byte at offset (its address & 15) of its wcap words
    uint8_t* sb = reinterpret_cast<uint8_t*>(stage);
    if (mine) stage[tid] = word;
    __syncthreads();
    auto staged = [&](int rr) {
        return sb + 16 * rr * wcap + (int)((uintptr_t)(in + row_at(rr)) & 15);
    };

    // exact integer sums per (block, channel): each of the block's `factor`
    // rows (rows past the image repeat its last row, columns its last
    // column) adds its partial with a shared atomic, exact in any order
    for (int k = tid; k < factor * nb * 3; k += kThreads) {
        const int ch = k % 3, b = (k / 3) % nb, rr = min(k / (3 * nb), rows - 1);
        const uint8_t* row = staged(rr) + ch;
        const int xb = b * factor, last = cols - 1;
        int s = 0;
#pragma unroll 4
        for (int j = 0; j < factor; ++j) s += row[3 * min(xb + j, last)];
        atomicAdd(&sums[3 * b + ch], s);
    }
    __syncthreads();

    // the select, in place: sum * inv, rounded half to even, clipped
    for (int k = tid; k < rows * cols; k += kThreads) {
        const int rr = k / cols, c = k - rr * cols;
        const float fx = (float)(x0 + c), fy = (float)(y0 + rr);
        bool inside = false;
        for (int q = 0; q < kept && !inside; ++q) {
            const float4 bx = sbox[q];
            inside = fx >= bx.x && fx < __fadd_rn(bx.x, bx.z) && fy >= bx.y &&
                     fy < __fadd_rn(bx.y, bx.w);
        }
        if (inside) {
            uint8_t* p = staged(rr) + 3 * c;
            const int* v = sums + 3 * (c / factor);
            p[0] = to_u8(__fmul_rn((float)v[0], inv));
            p[1] = to_u8(__fmul_rn((float)v[1], inv));
            p[2] = to_u8(__fmul_rn((float)v[2], inv));
        }
    }
    __syncthreads();
    if (mine) store_word(out + row_at(r), at, len, stage[tid]);
}

}  // namespace

// Launch K7 on `stream`: `in`, `out` u8 [h, w, 3]; `boxes` f32 [nbox, 4]
// (x, y, w, h), nbox <= 256; 1 <= factor <= 32. A block owns `factor` rows
// by a run of min(kRunPx / factor^2, kRunCols / factor) pixel blocks.
// Returns cudaGetLastError() after the launch.
extern "C" int flyimg_pixelate(const uint8_t* in, const float* boxes, uint8_t* out, int h, int w,
                               int nbox, int factor, void* stream) {
    if (h <= 0 || w <= 0 || nbox < 0 || nbox > kMaxBoxes || factor < 1 || factor > 32)
        return (int)cudaErrorInvalidValue;
    const int run_blocks = max(1, min(kRunPx / (factor * factor), kRunCols / factor));
    const int blocks_w = (w + factor - 1) / factor;
    const dim3 grid((h + factor - 1) / factor, (blocks_w + run_blocks - 1) / run_blocks);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    const float inv = 1.0f / (float)(factor * factor);
    pixelate_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        in, boxes, out, h, w, nbox, factor, inv, run_blocks);
    return (int)cudaGetLastError();
}
