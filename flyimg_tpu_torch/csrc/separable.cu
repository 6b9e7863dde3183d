// K5: separable Gaussian over an f32 [B, H, W, 3] batch with edge clamping
// and any tap count, then an optional unsharp epilogue and u8 store.
//
// Replaces the JAX package's flyimg_tpu/ops/filters.py _separable_conv_core
// (edge-padded depthwise conv, the H pass first, then the W pass),
// gaussian_blur, unsharp_from_blurred / unsharp_mask and sharpen, which XLA
// runs as two depthwise convolutions and an elementwise epilogue on the TPU
// (plus, when this is the program's last stage, the round/clip/u8 epilogue of
// flyimg_tpu/ops/compose.py make_program_fn).
//
// Epilogue modes: 0 blur (out = b); 1 unsharp (out = x + (|x - b| >= thr ?
// gain * (x - b) : 0), sharpen is gain 1, thr 0), each product and sum
// rounded in that order (an ulp there decides the threshold's knife-edge,
// ~gain * thr * 255 levels). The tap count is known only at run time
// (blr_0x10 gives 61 taps); the taps sit in shared memory.
//
// What bounds it on an H100: bytes for few taps, the f32 rate for many.
// Two launches through an f32 scratch buffer (the wrapper's torch.empty):
//   - vertical pass: a thread owns one float column of the row-major
//     [H, W * 3] plane (channels are independent, so no deinterleaving) and
//     VR consecutive output rows; it streams the VR + K - 1 source rows
//     those need, each read once and added into every accumulator whose
//     band holds it (taps in order, so each output sums k = 0..K-1);
//     neighbouring threads read neighbouring floats;
//   - horizontal pass: a block stages one row segment of HX pixels plus the
//     (K - 1)-pixel halo, edge-clamped, in shared memory, and each thread
//     sums its outputs' taps from there, then applies the epilogue (reading
//     x once) and stores f32 or u8.
// Each source float is read from device memory once per pass (the vertical
// halo rows of neighbouring row strips come from L2).
//
// The tiled form (halo > 0) replaces the per-device body of
// flyimg_tpu/parallel/tiling.py _build_tiled_filter: the input holds `halo`
// extra rows above and below each member (a rank's tile with the rows its
// neighbours sent), the vertical pass reads them instead of clamping (valid in
// H, halo = K / 2, so no clamp binds), the horizontal pass keeps its edge
// clamp in W, and the unsharp epilogue reads x from the member's own rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int VR = 8;        // output rows a thread of the vertical pass owns
constexpr int HX = 256;      // pixels of a horizontal-pass row segment
constexpr int THREADS = 256;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ uint8_t to_u8(float a) {
    return (uint8_t)fminf(fmaxf(rintf(a), 0.0f), 255.0f);
}

// grid: (column blocks * row strips, batch)
__global__ void __launch_bounds__(THREADS)
vertical_pass(const float* __restrict__ in, float* __restrict__ out, const float* __restrict__ taps,
              int H, int C, int K, int n_cb, int halo) {
    extern __shared__ float w_s[];
    for (int k = threadIdx.x; k < K; k += THREADS) w_s[k] = taps[k];
    __syncthreads();
    const int strip = blockIdx.x / n_cb;
    const int c = (blockIdx.x - strip * n_cb) * THREADS + threadIdx.x;
    if (c >= C) return;
    const int y0 = strip * VR;
    const int half = K / 2;
    const int H_in = H + 2 * halo;  // input rows a member: its own and the halos
    const float* src = in + (size_t)blockIdx.y * H_in * C + c;
    float acc[VR];
#pragma unroll
    for (int j = 0; j < VR; ++j) acc[j] = 0.0f;
    const int n_in = VR + K - 1;
    for (int i = 0; i < n_in; ++i) {
        const float v = __ldg(src + (size_t)clampi(y0 + halo - half + i, 0, H_in - 1) * C);
#pragma unroll
        for (int j = 0; j < VR; ++j) {
            const int k = i - j;
            if (k >= 0 && k < K) acc[j] = fmaf(w_s[k], v, acc[j]);
        }
    }
    float* dst = out + (size_t)blockIdx.y * H * C + c;
#pragma unroll
    for (int j = 0; j < VR; ++j)
        if (y0 + j < H) dst[(size_t)(y0 + j) * C] = acc[j];
}

// grid: (row segments * H, batch)
__global__ void __launch_bounds__(THREADS)
horizontal_pass(const float* __restrict__ tmp, const float* __restrict__ x,
                float* __restrict__ out_f, uint8_t* __restrict__ out_u8,
                const float* __restrict__ taps, int H, int W, int K, int n_seg, int mode,
                float gain, float thr, int halo) {
    extern __shared__ float smem[];
    float* w_s = smem;                 // [K]
    float* row = smem + ((K + 3) & ~3);  // [(HX + K - 1) * 3]
    const int y = blockIdx.x / n_seg;
    const int x0 = (blockIdx.x - y * n_seg) * HX;
    const int half = K / 2;
    const size_t row_off = ((size_t)blockIdx.y * H + y) * W * 3;
    for (int k = threadIdx.x; k < K; k += THREADS) w_s[k] = taps[k];
    const int n_stage = (HX + K - 1) * 3;
    for (int i = threadIdx.x; i < n_stage; i += THREADS) {
        const int px = clampi(x0 - half + i / 3, 0, W - 1);
        row[i] = __ldg(tmp + row_off + (size_t)px * 3 + (i % 3));
    }
    __syncthreads();
    const int n_out = min(HX, W - x0) * 3;
    for (int o = threadIdx.x; o < n_out; o += THREADS) {
        const float* r = row + o;  // output pixel o / 3, channel o % 3: taps at r[3k]
        float acc = 0.0f;
        for (int k = 0; k < K; ++k) acc = fmaf(w_s[k], r[3 * k], acc);
        const size_t at = row_off + (size_t)x0 * 3 + o;
        float v = acc;
        if (mode == 1) {
            // x's own rows start `halo` rows into the member's input rows
            const float xv = __ldg(x + ((size_t)blockIdx.y * (H + 2 * halo) + halo + y) * W * 3 +
                                   (size_t)x0 * 3 + o);
            const float diff = __fsub_rn(xv, acc);
            const float amount = __fmul_rn(gain, diff);
            v = __fadd_rn(xv, fabsf(diff) >= thr ? amount : 0.0f);
        }
        if (out_u8)
            out_u8[at] = to_u8(v);
        else
            out_f[at] = v;
    }
}

}  // namespace

// Launch K5 on `stream`: x f32 [batch, H + 2 * halo, W, 3] -> out (exactly
// one of out_f f32 or out_u8 u8, [batch, H, W, 3]), through tmp f32
// [batch, H, W, 3]; taps f32 [K] on the card, K odd. mode 0 = blur, 1 =
// unsharp with gain and thr (the threshold in levels, thr * 255 of the
// reference). halo = 0 is the whole-image filter; the tiled form gives a
// rank's tile with halo (at most K / 2) neighbour rows above and below, and
// rows are clamped only within x, so with halo = K / 2 the vertical pass
// reads the supplied rows as they are. Returns cudaGetLastError() after the
// launches.
extern "C" int flyimg_separable(const float* x, float* tmp, float* out_f, uint8_t* out_u8,
                                const float* taps, int batch, int H, int W, int K, int halo,
                                int mode, float gain, float thr, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (batch <= 0 || H <= 0 || W <= 0 || K <= 0 || K % 2 == 0 || (mode != 0 && mode != 1) ||
        (out_f == nullptr) == (out_u8 == nullptr) || batch > 65535 || halo < 0 || halo > K / 2)
        return (int)cudaErrorInvalidValue;
    const int C = W * 3;
    const int n_cb = (C + THREADS - 1) / THREADS;
    const int n_strips = (H + VR - 1) / VR;
    vertical_pass<<<dim3(n_cb * n_strips, batch), THREADS, K * sizeof(float), s>>>(
        x, tmp, taps, H, C, K, n_cb, halo);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int n_seg = (W + HX - 1) / HX;
    const size_t smem = (((K + 3) & ~3) + (size_t)(HX + K - 1) * 3) * sizeof(float);
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(horizontal_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    horizontal_pass<<<dim3(n_seg * H, batch), THREADS, smem, s>>>(
        tmp, x, out_f, out_u8, taps, H, W, K, n_seg, mode, gain, thr, halo);
    return (int)cudaGetLastError();
}
