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
// What bounds it on an H100: bytes. Every pixel is read once and written
// once (6 bytes) and a block's sum is 3 integer adds a pixel. Design: one
// block of factor^2 threads a pixel block (100 at the reference's factor
// 10), a thread a pixel; the boxes are staged in shared memory; a block
// with no pixel inside a box copies and skips the reduction; a block sum
// is a warp reduction (__reduce_add_sync) and one shared atomic a warp,
// exact in any order. A simple kernel: the face pass runs it once per
// image, on images of serving size.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBoxes = 256;

__device__ __forceinline__ uint8_t to_u8(float a) {
    return (uint8_t)fminf(fmaxf(rintf(a), 0.0f), 255.0f);
}

__global__ void pixelate_kernel(const uint8_t* __restrict__ in, const float* __restrict__ boxes,
                                uint8_t* __restrict__ out, int h, int w, int nbox, int factor,
                                float inv) {
    __shared__ float sbox[kMaxBoxes * 4];
    __shared__ int ssum[3];
    const int tid = threadIdx.x;
    const int y = blockIdx.y * factor + tid / factor;
    const int x = blockIdx.x * factor + tid % factor;
    if (tid < 3) ssum[tid] = 0;
    for (int i = tid; i < nbox * 4; i += blockDim.x) sbox[i] = boxes[i];
    __syncthreads();

    const bool here = y < h && x < w;
    bool inside = false;
    if (here) {
        const float fx = (float)x, fy = (float)y;
        for (int b = 0; b < nbox && !inside; ++b) {
            const float bx = sbox[b * 4 + 0], by = sbox[b * 4 + 1];
            const float bw = sbox[b * 4 + 2], bh = sbox[b * 4 + 3];
            inside = fx >= bx && fx < __fadd_rn(bx, bw) && fy >= by && fy < __fadd_rn(by, bh);
        }
    }
    // block-uniform: every thread takes the same branch and barrier below
    if (__syncthreads_or(inside)) {
        const int sy = min(y, h - 1), sx = min(x, w - 1);
        const uint8_t* s = in + ((size_t)sy * w + sx) * 3;
        const int lanes = min(32, (int)blockDim.x - (tid & ~31));
        const unsigned mask = lanes == 32 ? 0xffffffffu : (1u << lanes) - 1u;
        const int v0 = __reduce_add_sync(mask, (int)s[0]);
        const int v1 = __reduce_add_sync(mask, (int)s[1]);
        const int v2 = __reduce_add_sync(mask, (int)s[2]);
        if ((tid & 31) == 0) {
            atomicAdd(&ssum[0], v0);
            atomicAdd(&ssum[1], v1);
            atomicAdd(&ssum[2], v2);
        }
        __syncthreads();
    }
    if (!here) return;
    const size_t p = ((size_t)y * w + x) * 3;
    if (inside) {
        out[p + 0] = to_u8(__fmul_rn((float)ssum[0], inv));
        out[p + 1] = to_u8(__fmul_rn((float)ssum[1], inv));
        out[p + 2] = to_u8(__fmul_rn((float)ssum[2], inv));
    } else {
        out[p + 0] = in[p + 0];
        out[p + 1] = in[p + 1];
        out[p + 2] = in[p + 2];
    }
}

}  // namespace

// Launch K7 on `stream`: `in`, `out` u8 [h, w, 3]; `boxes` f32 [nbox, 4]
// (x, y, w, h), nbox <= 256; 1 <= factor <= 32. Returns cudaGetLastError()
// after the launch.
extern "C" int flyimg_pixelate(const uint8_t* in, const float* boxes, uint8_t* out, int h, int w,
                               int nbox, int factor, void* stream) {
    if (h <= 0 || w <= 0 || nbox < 0 || nbox > kMaxBoxes || factor < 1 || factor > 32)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((w + factor - 1) / factor, (h + factor - 1) / factor);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    const float inv = 1.0f / (float)(factor * factor);
    pixelate_kernel<<<grid, factor * factor, 0, static_cast<cudaStream_t>(stream)>>>(
        in, boxes, out, h, w, nbox, factor, inv);
    return (int)cudaGetLastError();
}
