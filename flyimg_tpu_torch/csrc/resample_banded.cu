// K1: banded K-tap windowed resample of a u8 batch, fused u8 load ->
// vertical band pass -> horizontal band pass -> round/clip/u8 store.
//
// Replaces the JAX package's flyimg_tpu/ops/resample.py _band_axis +
// resample_image_banded (and the round/clip/u8 epilogue of
// flyimg_tpu/ops/compose.py make_program_fn), which XLA fuses on the TPU.
//
// Sampling model (the reference's): output sample i of an axis reads source
// position x(i) = start + (i + 0.5) * size / max(out_true, 1) - 0.5, clamped to
// [0, in_true - 1]. Its K taps are the integer window j0 + k centred at
// floor(x); weights come from the UNCLIPPED tap positions, taps outside
// [0, in_true) are zeroed, then the row is renormalised (the unclipped-tap
// invariant, docs/kernels.md). Gather indices are clipped to the static axis.
//
// What bounds it on an H100: memory. Each member's u8 source is read once per
// output row that touches it (Ky * out_h / in_h times, L2 catches most of it),
// the output is 3 bytes a pixel, and the arithmetic is Ky + Kx multiply-adds a
// channel (~100 FLOP a u8 output channel at the 512 -> 300 flagship), far under
// the 67 TFLOP/s f32 rate. Design:
//   - a first small kernel evaluates every band weight once per member and
//     axis (the filter's sin/exp work, which would otherwise dominate), into
//     f32 tables the wrapper allocates;
//   - the main kernel runs one block per (output row, member): the vertical
//     pass for that row lands in shared memory as f32 over just the source
//     columns the row's horizontal bands reach (read 4 bytes at a time), then
//     the horizontal pass reads it from shared memory, one output pixel (3
//     channels) per thread, and stores u8 directly. The f32 intermediate
//     never touches device memory. The common band widths are compile-time
//     constants, so the tap loops unroll.
// No tensor cores: at K = 16 the contraction is too short for them to matter
// next to the byte traffic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Method { LANCZOS3 = 0, TRIANGLE = 1, GAUSSIAN = 2, CUBIC = 3, BOX = 4, NEAREST = 5 };

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float sinc_f(float x) {
    // jnp.sinc: sin(pi x) / (pi x), 1 at 0
    if (x == 0.0f) return 1.0f;
    float px = __fmul_rn(3.14159265358979323846f, x);
    return sinf(px) / px;
}

__device__ float filter_fn(int method, float x) {
    float ax = fabsf(x);
    switch (method) {
    case LANCZOS3:
        return ax < 3.0f ? __fmul_rn(sinc_f(x), sinc_f(x / 3.0f)) : 0.0f;
    case TRIANGLE:
        return fmaxf(0.0f, 1.0f - ax);
    case GAUSSIAN:
        return ax < 1.5f ? expf(__fmul_rn(__fmul_rn(-2.0f, x), x)) : 0.0f;
    case CUBIC: {
        // Mitchell-Netravali B = C = 1/3, the reference's coefficients
        const float b = 1.0f / 3.0f, c = 1.0f / 3.0f;
        float ax2 = ax * ax, ax3 = ax * ax * ax;
        float p1 = ((12.0f - 9.0f * b - 6.0f * c) * ax3
                    + (-18.0f + 12.0f * b + 6.0f * c) * ax2 + (6.0f - 2.0f * b)) / 6.0f;
        float p2 = ((-b - 6.0f * c) * ax3 + (6.0f * b + 30.0f * c) * ax2
                    + (-12.0f * b - 48.0f * c) * ax + (8.0f * b + 24.0f * c)) / 6.0f;
        return ax < 1.0f ? p1 : (ax < 2.0f ? p2 : 0.0f);
    }
    default:  // BOX
        return (x >= -0.5f && x < 0.5f) ? 1.0f : 0.0f;
    }
}

// One thread per (member, output sample) of one axis: K normalised weights
// and the unclipped band start j0. geom rows are [span_y(2), span_x(2),
// out_true(h, w), in_true(h, w)].
__global__ void band_weights_kernel(const float* __restrict__ geom, int batch, int axis,
                                    int in_size, int out_size, int taps, int method,
                                    float* __restrict__ w, int* __restrict__ j0_out) {
    int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= batch * out_size) return;
    int b = idx / out_size;
    int i = idx - b * out_size;
    const float* g = geom + (size_t)b * 8;
    float start = g[axis * 2 + 0];
    float size = g[axis * 2 + 1];
    float out_true = fmaxf(g[4 + axis], 1.0f);
    float in_true = g[6 + axis];
    float q = size / out_true;
    // the reference's operation order, no FMA contraction: floor(x) picks
    // the band, so x must round exactly as it does there
    float x = __fsub_rn(__fadd_rn(start, __fmul_rn(__fadd_rn((float)i, 0.5f), q)), 0.5f);
    x = fminf(fmaxf(x, 0.0f), fmaxf(in_true - 1.0f, 0.0f));
    int j0 = taps >= in_size ? 0 : (int)floorf(x) - taps / 2 + 1;
    float* wr = w + (size_t)idx * taps;
    j0_out[idx] = j0;
    if (method == NEAREST) {
        float near = fminf(fmaxf(floorf(x + 0.5f), 0.0f), fmaxf(in_true - 1.0f, 0.0f));
        for (int k = 0; k < taps; ++k) wr[k] = ((float)(j0 + k) == near) ? 1.0f : 0.0f;
        return;
    }
    float s = fmaxf(q, 1.0f);
    float sum = 0.0f;
    for (int k = 0; k < taps; ++k) {
        int j = j0 + k;
        float wk = filter_fn(method, ((float)j - x) / s);
        if (!(j >= 0 && (float)j < in_true)) wk = 0.0f;
        wr[k] = wk;
        sum += wk;
    }
    float denom = sum == 0.0f ? 1.0f : sum;
    for (int k = 0; k < taps; ++k) wr[k] = wr[k] / denom;
}

// One block per (output row, member); 3 channels, interleaved [h, w, 3].
// KY/KX > 0 fix the band widths at compile time (the common buckets, so the
// tap loops unroll and their loads overlap); 0 reads them at run time. The
// source width must be a multiple of 4 (buckets are multiples of 128), so a
// row is whole 32-bit words.
// The vertical pass reads the source a 32-bit word (4 bytes) at a time;
// the horizontal pass computes all three channels of one output pixel per
// thread, so each weight is loaded once for three multiply-adds.
template <int KY, int KX>
__global__ void resample_rows_kernel(const uint8_t* __restrict__ img, uint8_t* __restrict__ out,
                                     const float* __restrict__ wy, const int* __restrict__ jy,
                                     const float* __restrict__ wx, const int* __restrict__ jx,
                                     int in_h, int in_w, int out_h, int out_w, int ky_rt,
                                     int kx_rt) {
    const int ky = KY > 0 ? KY : ky_rt;
    const int kx = KX > 0 ? KX : kx_rt;
    extern __shared__ float smem[];
    const int oy = blockIdx.x;
    const int b = blockIdx.y;
    float* wy_s = smem;
    int* roff_s = reinterpret_cast<int*>(smem + ky);  // tap rows, in 32-bit words
    float* row = smem + 2 * ky;

    const int pitch = in_w * 3;          // bytes; in_w % 4 == 0, so words too
    const int pitch_w = pitch / 4;
    const float* wyb = wy + ((size_t)b * out_h + oy) * ky;
    const int j0y = jy[(size_t)b * out_h + oy];
    for (int k = threadIdx.x; k < ky; k += blockDim.x) {
        wy_s[k] = wyb[k];
        roff_s[k] = clampi(j0y + k, 0, in_h - 1) * pitch_w;
    }
    // band starts are monotone in the output index, so the first and last
    // output columns bound every source column this row reads; widen the
    // byte range to whole words
    const int* jxb = jx + (size_t)b * out_w;
    const int lo = clampi(jxb[0], 0, in_w - 1);
    const int hi = clampi(jxb[out_w - 1] + kx - 1, 0, in_w - 1);
    const int s0 = (lo * 3) & ~3;
    const int s1 = min(((hi + 1) * 3 + 3) & ~3, pitch);
    __syncthreads();

    const uint32_t* imw = reinterpret_cast<const uint32_t*>(img + (size_t)b * in_h * pitch)
                          + s0 / 4;
    const int nw = (s1 - s0) / 4;
    for (int t = threadIdx.x; t < nw; t += blockDim.x) {
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
        for (int k = 0; k < ky; ++k) {
            const uint32_t v = __ldg(imw + roff_s[k] + t);
            const float w = wy_s[k];
            a0 += w * (float)(v & 0xFFu);
            a1 += w * (float)((v >> 8) & 0xFFu);
            a2 += w * (float)((v >> 16) & 0xFFu);
            a3 += w * (float)(v >> 24);
        }
        float* r = row + 4 * t;
        r[0] = a0;
        r[1] = a1;
        r[2] = a2;
        r[3] = a3;
    }
    __syncthreads();

    const float* wxb = wx + (size_t)b * out_w * kx;
    uint8_t* ob = out + ((size_t)b * out_h + oy) * out_w * 3;
    for (int ox = threadIdx.x; ox < out_w; ox += blockDim.x) {
        const int j0 = jxb[ox];
        const float* w = wxb + (size_t)ox * kx;
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
#pragma unroll
        for (int k = 0; k < kx; ++k) {
            const float* p = row + clampi(j0 + k, 0, in_w - 1) * 3 - s0;
            const float wk = __ldg(w + k);
            a0 += wk * p[0];
            a1 += wk * p[1];
            a2 += wk * p[2];
        }
        uint8_t* o = ob + ox * 3;
        o[0] = (uint8_t)fminf(fmaxf(rintf(a0), 0.0f), 255.0f);
        o[1] = (uint8_t)fminf(fmaxf(rintf(a1), 0.0f), 255.0f);
        o[2] = (uint8_t)fminf(fmaxf(rintf(a2), 0.0f), 255.0f);
    }
}

template <int KY, int KX>
cudaError_t launch_rows(dim3 grid, size_t smem, cudaStream_t s, const uint8_t* img,
                        uint8_t* out, const float* wy, const int* jy, const float* wx,
                        const int* jx, int in_h, int in_w, int out_h, int out_w, int ky,
                        int kx) {
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(resample_rows_kernel<KY, KX>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
        if (err != cudaSuccess) return err;
    }
    resample_rows_kernel<KY, KX><<<grid, 256, smem, s>>>(img, out, wy, jy, wx, jx, in_h, in_w,
                                                         out_h, out_w, ky, kx);
    return cudaSuccess;
}

}  // namespace

extern "C" size_t flyimg_resample_banded_smem_bytes(int in_w, int ky) {
    // tap weights and row offsets, then the vertical pass over up to the
    // whole row widened to words
    return (size_t)(2 * ky + 3 * in_w + 4) * sizeof(float);
}

// Launch both kernels on `stream`. wy/jy and wx/jx are scratch tables of
// [batch, out_h, ky] / [batch, out_h] and [batch, out_w, kx] / [batch, out_w].
// Returns cudaGetLastError() after the launches.
extern "C" int flyimg_resample_banded_u8(const uint8_t* img, uint8_t* out, const float* geom,
                                         float* wy, int* jy, float* wx, int* jx,
                                         int batch, int in_h, int in_w, int out_h, int out_w,
                                         int ky, int kx, int method, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int threads = 128;
    int ny = batch * out_h;
    int nx = batch * out_w;
    band_weights_kernel<<<(ny + threads - 1) / threads, threads, 0, s>>>(
        geom, batch, 0, in_h, out_h, ky, method, wy, jy);
    band_weights_kernel<<<(nx + threads - 1) / threads, threads, 0, s>>>(
        geom, batch, 1, in_w, out_w, kx, method, wx, jx);
    size_t smem = flyimg_resample_banded_smem_bytes(in_w, ky);
    dim3 grid(out_h, batch);
    cudaError_t err;
#define FLYIMG_K1_CASE(A, B)                                                              \
    if (ky == A && kx == B)                                                               \
        err = launch_rows<A, B>(grid, smem, s, img, out, wy, jy, wx, jx, in_h, in_w, out_h, \
                                out_w, ky, kx);                                           \
    else
    FLYIMG_K1_CASE(8, 8)
    FLYIMG_K1_CASE(8, 16)
    FLYIMG_K1_CASE(16, 8)
    FLYIMG_K1_CASE(16, 16)
    FLYIMG_K1_CASE(16, 32)
    FLYIMG_K1_CASE(32, 16)
    FLYIMG_K1_CASE(32, 32)
    err = launch_rows<0, 0>(grid, smem, s, img, out, wy, jy, wx, jx, in_h, in_w, out_h, out_w,
                            ky, kx);
#undef FLYIMG_K1_CASE
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
