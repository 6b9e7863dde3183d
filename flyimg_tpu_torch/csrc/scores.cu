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
// f32 operands, f32 accumulation: a direct correlation, no tensor cores (TF32
// alone misses 1e-5 relative).
//
// What bounds it on an H100: operations. The flagship scores 13 x 19
// positions of a 150 x 150 window per member: ~2.8 GFLOP per 256-member batch
// against ~77 MB of field, above the f32 ridge. So the design feeds the FMA
// units with as few loads as it can:
//   - polyphase: with kx = stride * j + px, the correlation splits into
//     `stride` column phases, and for a fixed (ky, px) it is a stride-1 1-D
//     correlation g[m] = field[row, stride * m + px] with the taps
//     ker[ky, stride * j + px]. A thread holds R consecutive outputs in
//     registers and a rotating window of R field values: each tap step loads
//     ONE field value and ONE kernel value and does R FMAs (R = 19 at the
//     flagship: ~0.1 loads an FMA, where a direct loop needs two);
//   - the launch fills the card: threads map over (member, output row, run
//     of R outputs, channel) x (chunk of window rows, phase), so even the
//     serving shape (16 members, 3 x 7 outputs) gives thousands of threads.
//     Neighbouring lanes are neighbouring phases, so their field and kernel
//     loads are neighbouring words; the lanes of a warp share a window row
//     chunk, so a shared kernel is read from one row;
//   - the (row chunk, phase) partial sums of an output live in one block and
//     are added by a fixed pairwise tree, so results do not change from run
//     to run.
// The host chooses R (a compiled instance), the row chunks and the block
// shape (models/smartcrop.py k3_plan). The totals are a second small kernel,
// one block per member, with a fixed-order tree reduction.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K3_THREADS = 256;

// One thread per (group, part): group = (member, output row, run of R outputs,
// channel), part = (window-row chunk, phase px). Lanes are phases, then
// groups, then row chunks, so the lanes of a warp read one kernel row.
template <int R>
__global__ void __launch_bounds__(K3_THREADS)
scores_kernel(const float* __restrict__ field, const float* __restrict__ ker,
              float* __restrict__ grids, int fh, int fw, int khm, int kwm, int C,
              size_t ker_batch_stride, int stride, int ny, int nx, int n_xg, int ky_chunk,
              int n_parts, int groups_per_block, int n_groups, int n_steps) {
    __shared__ float part_s[R * K3_THREADS];  // [R][thread]
    const int tid = threadIdx.x;
    const int px = tid % stride;
    const int gl = (tid / stride) % groups_per_block;
    const int kyc = tid / (stride * groups_per_block);
    const int p = kyc * stride + px;
    const int g = blockIdx.x * groups_per_block + gl;
    const bool active = gl < groups_per_block && g < n_groups;
    int c = 0, xg = 0, oy = 0, b = 0;
    if (active) {
        int t = g;
        c = t % C;
        t /= C;
        xg = t % n_xg;
        t /= n_xg;
        oy = t % ny;
        b = t / ny;
    }
    const int x0 = xg * R;

    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
    if (active) {
        const int ky0 = kyc * ky_chunk;
        const int ky1 = min(khm, ky0 + ky_chunk);
        // g[m] = frow[min(stride * (x0 + m), lim)]: columns past the field
        // only ever meet a zero tap or an output beyond nx
        const int lim = fw - 1 - px;
        const float* kb = ker + b * ker_batch_stride + c;
        for (int ky = ky0; ky < ky1; ++ky) {
            const float* frow = field + ((size_t)b * fh + (size_t)oy * stride + ky) * fw + px;
            const float* krow = kb + (size_t)ky * kwm * C;
            float win[R];  // g[m] lives in slot m % R
#pragma unroll
            for (int j = 0; j < R - 1; ++j) win[j] = __ldg(frow + min(stride * (x0 + j), lim));
            for (int s0 = 0; s0 < n_steps; s0 += R) {
#pragma unroll
                for (int j = 0; j < R; ++j) {
                    const int step = s0 + j;
                    win[(j + R - 1) % R] = __ldg(frow + min(stride * (x0 + step + R - 1), lim));
                    const int kx = stride * step + px;
                    const float kv = kx < kwm ? __ldg(krow + (size_t)kx * C) : 0.0f;
#pragma unroll
                    for (int r = 0; r < R; ++r) acc[r] = fmaf(win[(r + j) % R], kv, acc[r]);
                }
            }
        }
    }

    // add the parts of each output by a fixed pairwise tree (the same for
    // every run): first part p + h into p for the largest power of two
    // h < n_parts, then halving
#pragma unroll
    for (int r = 0; r < R; ++r) part_s[r * K3_THREADS + gl * n_parts + p] = acc[r];
    __syncthreads();
    int h = 1;
    while (2 * h < n_parts) h *= 2;
    const int nthreads = blockDim.x;
    for (; h >= 1; h >>= 1) {
        for (int i = tid; i < groups_per_block * R * h; i += nthreads) {
            const int q = i % h;
            const int rest = i / h;
            const int r = rest % R;
            const int gq = rest / R;
            if (q + h < n_parts) {
                float* ps = part_s + r * K3_THREADS + gq * n_parts;
                ps[q] += ps[q + h];
            }
        }
        __syncthreads();
    }
    for (int i = tid; i < groups_per_block * R; i += nthreads) {
        const int gq = i / R;
        const int r = i - gq * R;
        int t = blockIdx.x * groups_per_block + gq;
        if (t >= n_groups) continue;
        const int cq = t % C;
        t /= C;
        const int xq = t % n_xg;
        t /= n_xg;
        const int oq = t % ny;
        const int bq = t / ny;
        const int ox = xq * R + r;
        if (ox < nx)
            grids[(((size_t)bq * ny + oq) * nx + ox) * C + cq] =
                part_s[r * K3_THREADS + gq * n_parts];
    }
}

// One block per member; 16-byte loads when the field allows them.
__global__ void totals_kernel(const float* __restrict__ field, float* __restrict__ totals, size_t n) {
    __shared__ float red[K3_THREADS];
    const float* fb = field + (size_t)blockIdx.x * n;
    float acc = 0.0f;
    if ((n & 3) == 0 && ((uintptr_t)field & 15) == 0) {
        const float4* f4 = reinterpret_cast<const float4*>(fb);
        for (size_t t = threadIdx.x; t < n / 4; t += K3_THREADS) {
            const float4 v = __ldg(f4 + t);
            acc += v.x;
            acc += v.y;
            acc += v.z;
            acc += v.w;
        }
    } else {
        for (size_t t = threadIdx.x; t < n; t += K3_THREADS) acc += fb[t];
    }
    red[threadIdx.x] = acc;
    __syncthreads();
    for (int w = K3_THREADS / 2; w > 0; w >>= 1) {
        if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
        __syncthreads();
    }
    if (threadIdx.x == 0) totals[blockIdx.x] = red[0];
}

template <int R>
void launch_scores(int blocks, cudaStream_t s, const float* field, const float* ker,
                   float* grids, int fh, int fw, int khm, int kwm, int C, size_t ker_stride,
                   int stride, int ny, int nx, int n_xg, int ky_chunk, int n_parts, int gpb,
                   int n_groups, int n_steps) {
    scores_kernel<R><<<blocks, gpb * n_parts, 0, s>>>(field, ker, grids, fh, fw, khm, kwm, C,
                                                     ker_stride, stride, ny, nx, n_xg, ky_chunk,
                                                     n_parts, gpb, n_groups, n_steps);
}

}  // namespace

// field [batch, fh, fw] f32; ker [kb, khm, kwm, C] f32 with kb == batch, or
// kb == 1 for one stack shared by every member (ker_shared != 0); grids
// [batch, ny, nx, C], totals [batch]. The plan (R, ky_chunk, groups a block)
// comes from the host. Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for a plan the kernel does not take.
extern "C" int flyimg_candidate_scores(const float* field, const float* ker, float* grids,
                                       float* totals, int batch, int fh, int fw, int khm,
                                       int kwm, int C, int ker_shared, int stride, int ny,
                                       int nx, int R, int ky_chunk, int groups_per_block,
                                       void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (stride < 1 || ky_chunk < 1 || R < 1 || groups_per_block < 1) return (int)cudaErrorInvalidValue;
    const int n_kyc = (khm + ky_chunk - 1) / ky_chunk;
    const int n_parts = n_kyc * stride;
    if (n_parts * groups_per_block > K3_THREADS) return (int)cudaErrorInvalidValue;
    const int n_xg = (nx + R - 1) / R;
    const int n_groups = batch * ny * n_xg * C;
    const int blocks = (n_groups + groups_per_block - 1) / groups_per_block;
    const int n_steps = (kwm + stride - 1) / stride;
    const size_t ker_stride = ker_shared ? 0 : (size_t)khm * kwm * C;
#define FLYIMG_K3_CASE(N)                                                                      \
    case N:                                                                                    \
        launch_scores<N>(blocks, s, field, ker, grids, fh, fw, khm, kwm, C, ker_stride, stride, \
                         ny, nx, n_xg, ky_chunk, n_parts, groups_per_block, n_groups, n_steps); \
        break;
    switch (R) {
        FLYIMG_K3_CASE(1)
        FLYIMG_K3_CASE(2)
        FLYIMG_K3_CASE(3)
        FLYIMG_K3_CASE(4)
        FLYIMG_K3_CASE(5)
        FLYIMG_K3_CASE(6)
        FLYIMG_K3_CASE(7)
        FLYIMG_K3_CASE(8)
        FLYIMG_K3_CASE(10)
        FLYIMG_K3_CASE(12)
        FLYIMG_K3_CASE(16)
        FLYIMG_K3_CASE(19)
    default:
        return (int)cudaErrorInvalidValue;
    }
#undef FLYIMG_K3_CASE
    totals_kernel<<<batch, K3_THREADS, 0, s>>>(field, totals, (size_t)fh * fw);
    return (int)cudaGetLastError();
}
