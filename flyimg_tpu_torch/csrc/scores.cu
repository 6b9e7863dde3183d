// K3: smart-crop candidate scoring — a strided VALID cross-correlation of each
// member's saliency field with its stack of C kernels, plus the field totals.
//
// Replaces the JAX package's flyimg_tpu/models/smartcrop.py _batched_scores
// (the per-member conv_general_dilated at Precision.HIGHEST, XLA on the TPU),
// and the flagship scoring conv of __graft_entry__.py (one 150x150 importance
// kernel at stride 8).
//
//   grids[b, oy, ox, c] = sum_{ky < khm, kx < kwm}
//       field[b, oy*stride + ky, ox*stride + kx] * ker[b, ky, kx, c]
//   totals[b] = sum field[b]
//
// f32 operands, f32 accumulation: a direct correlation, no tensor cores, no
// TF32.
//
// What bounds it on an H100: operations. The flagship scores 13 x 19
// positions of a 150 x 150 window per member: ~2.8 GFLOP per 256-member batch
// against ~77 MB of field, ~37 flops a byte, above the f32 ridge (67 TFLOP/s
// over 3.35 TB/s = 20). Design: one block per (output row, member). The block
// walks the window's rows in chunks; each chunk's field rows and kernel rows
// (all C channels) are staged in shared memory, so every field and kernel
// element is read from device memory once per output row. The field rows are
// stored skewed (one pad word every 32) so that the stride-8 windows of
// neighbouring outputs, read in step, fall in different banks. Each output
// (ox, c) is owned by S threads that split the window rows between them; the
// S partial sums are added in a fixed order at the end, so results do not
// change from run to run. The totals are a second small kernel, one block per
// member, with a fixed-order tree reduction.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__host__ __device__ __forceinline__ int skewed(int a) { return a + (a >> 5); }

__global__ void scores_kernel(const float* __restrict__ field, const float* __restrict__ ker,
                              float* __restrict__ grids, int fh, int fw, int khm, int kwm, int C,
                              size_t ker_batch_stride, int stride, int ny, int nx, int kc) {
    extern __shared__ float smem[];
    // [kc, fw] field rows, skewed: element a lives at a + a / 32, so the
    // stride-8 windows of neighbouring outputs fall in different banks
    float* field_s = smem;
    float* ker_s = smem + skewed(kc * fw);  // [kc, kwm, C]
    float* part_s = ker_s + (size_t)kc * kwm * C;  // [THREADS]

    const int oy = blockIdx.x;
    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    const float* fb = field + ((size_t)b * fh + (size_t)oy * stride) * fw;
    const float* kb = ker + b * ker_batch_stride;
    const int n_out = nx * C;

    for (int g0 = 0; g0 < n_out; g0 += THREADS) {
        const int G = min(n_out - g0, THREADS);
        const int S = THREADS / G;
        const int active = G * S;
        const int o = g0 + tid % G;
        const int s = tid / G;
        const int ox = o / C;
        const int c = o - ox * C;
        float acc = 0.0f;
        for (int ky0 = 0; ky0 < khm; ky0 += kc) {
            const int rows = min(kc, khm - ky0);
            __syncthreads();
            for (int t = tid; t < rows * fw; t += THREADS)
                field_s[skewed(t)] = fb[(size_t)ky0 * fw + t];
            const int kn = rows * kwm * C;
            for (int t = tid; t < kn; t += THREADS) ker_s[t] = kb[(size_t)ky0 * kwm * C + t];
            __syncthreads();
            if (tid < active) {
                for (int r = s; r < rows; r += S) {
                    const int a0 = r * fw + ox * stride;
                    const float* krow = ker_s + (size_t)r * kwm * C + c;
                    for (int kx = 0; kx < kwm; ++kx)
                        acc += field_s[skewed(a0 + kx)] * krow[kx * C];
                }
            }
        }
        part_s[tid] = acc;
        __syncthreads();
        if (tid < G) {
            float sum = 0.0f;
            for (int j = 0; j < S; ++j) sum += part_s[j * G + tid];
            const int oo = g0 + tid;
            grids[(((size_t)b * ny + oy) * nx) * C + oo] = sum;
        }
    }
}

__global__ void totals_kernel(const float* __restrict__ field, float* __restrict__ totals, size_t n) {
    __shared__ float red[THREADS];
    const float* fb = field + (size_t)blockIdx.x * n;
    float acc = 0.0f;
    for (size_t t = threadIdx.x; t < n; t += THREADS) acc += fb[t];
    red[threadIdx.x] = acc;
    __syncthreads();
    for (int w = THREADS / 2; w > 0; w >>= 1) {
        if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
        __syncthreads();
    }
    if (threadIdx.x == 0) totals[blockIdx.x] = red[0];
}

}  // namespace

// field [batch, fh, fw] f32; ker [kb, khm, kwm, C] f32 with kb == batch, or
// kb == 1 for one stack shared by every member (ker_shared != 0); grids
// [batch, ny, nx, C], totals [batch]. Returns cudaGetLastError() after the
// launches (or the shared-memory attribute error).
extern "C" int flyimg_candidate_scores(const float* field, const float* ker, float* grids,
                                       float* totals, int batch, int fh, int fw, int khm,
                                       int kwm, int C, int ker_shared, int stride, int ny,
                                       int nx, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    // chunk of window rows staged per step: fill up to 96 KB of shared memory
    const size_t row_floats = (size_t)fw + fw / 32 + 1 + (size_t)kwm * C;
    const size_t budget = (96 * 1024) / sizeof(float) - THREADS - 1;
    int kc = (int)(budget / row_floats);
    if (kc < 1) return (int)cudaErrorInvalidValue;
    if (kc > khm) kc = khm;
    const size_t smem =
        ((size_t)skewed(kc * fw) + (size_t)kc * kwm * C + THREADS + 1) * sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t err =
            cudaFuncSetAttribute(scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const size_t ker_stride = ker_shared ? 0 : (size_t)khm * kwm * C;
    dim3 grid(ny, batch);
    scores_kernel<<<grid, THREADS, smem, s>>>(field, ker, grids, fh, fw, khm, kwm, C, ker_stride,
                                              stride, ny, nx, kc);
    totals_kernel<<<batch, THREADS, 0, s>>>(field, totals, (size_t)fh * fw);
    return (int)cudaGetLastError();
}
