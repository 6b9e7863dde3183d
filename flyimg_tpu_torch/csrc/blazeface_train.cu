// K11-K14: the BlazeFace training step's backward, loss and optimizer,
// NHWC f32 throughout, kernels HWIO as flax stores them.
//
// K11 — the backward of K9 (a 5x5 convolution with SAME padding, stride 1
// or 2): the input gradient of a depthwise convolution (a transposed
// depthwise correlation of the output gradient), and the weight gradient
// [5, 5, 1, C] of a depthwise one or [5, 5, C_in, C_out] (+ the bias
// gradient) of the stem, whose ReLU it undoes from the saved output.
// K12 — the backward of K10 (out = relu(y . W + b + pad(pool2x2(res)))):
// the ReLU mask from the saved output, dy = g . W^T, dW = y^T . g,
// db = sum g, and the residual's gradient: the first C_res channels of g,
// at stride 2 routed to the first maximum of each 2x2 window in row-major
// order (what XLA's select-and-scatter with `ge` and torch's max_pool2d
// both do). With no ReLU and no residual it is the heads' backward.
// K13 — the heads' forward fused with the loss and its gradient: the raw
// logits and offsets of both anchor maps, sigmoid, the focal-weighted BCE
// with its 1e-7 terms and the masked smooth-L1, differentiated as JAX
// differentiates the written expression (d log(p + 1e-7) = 1 / (p + 1e-7),
// d logistic = ans (1 - ans)); two launches, the second once the reg
// normaliser sum(mask) * 4 + 1e-6 is known.
// K14 — optax.adam's update in one elementwise pass over the flat
// parameters with their first and second moments.
//
// Replaces what jax.value_and_grad and optax.adam(1e-3) make of the JAX
// package's flyimg_tpu/models/blazeface.py loss_fn (:347) and
// make_train_step (:366): XLA's fused backward convolutions, reductions
// and elementwise update.
//
// What bounds them on an H100: at batch 16 a step moves ~0.3 GB (the
// saved activations read back, their gradients written) and does ~2.5
// GFLOP, ~0.1 ms at the card's rates; ~140 launches a step make it
// launch-bound first. Design, simple and repeatable first: every sum over
// pixels is two-stage (per-chunk partials in a fixed order, then a
// reduction over chunks in a fixed order); no float atomics, so a gradient
// is the same bits from run to run. Every product and sum rounds as
// written (__f*_rn intrinsics), so the plain PyTorch versions agree to the
// order of summation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 25;
constexpr int kThreads = 256;
constexpr int kPwTile = 16;       // pixels of one K12 tile
constexpr int kPwMaxAcc = 37;     // ceil((96 * 96 + 96) / 256) dW partials a thread
constexpr int kAnchors = 896;

int blocks_for(long long total, int threads) {
    const long long want = (total + threads - 1) / threads;
    return (int)(want < 132 * 8 ? want : 132 * 8);
}

// Fixed-order block sum of one value a thread (blockDim.x == kThreads).
__device__ float block_sum(float v, float* red) {
    red[threadIdx.x] = v;
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {
        if (threadIdx.x < s) red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + s]);
        __syncthreads();
    }
    const float r = red[0];
    __syncthreads();
    return r;
}

// ---------------------------------------------------------------- K11

// dx of a depthwise 5x5 convolution: a thread an input element, the 25
// taps that reach it summed in (ky, kx) order.
__global__ void dw_input_grad_kernel(const float* __restrict__ g, const float* __restrict__ kernel,
                                     float* __restrict__ dx, int n, int h, int w, int c, int oh,
                                     int ow, int stride, int pad_top, int pad_left) {
    const long long total = (long long)n * h * w * c;
    for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < total;
         p += (long long)gridDim.x * blockDim.x) {
        const int ch = (int)(p % c);
        long long r = p / c;
        const int ix = (int)(r % w);
        r /= w;
        const int iy = (int)(r % h);
        const long long b = r / h;
        float acc = 0.0f;
        for (int ky = 0; ky < 5; ++ky) {
            const int ty = iy + pad_top - ky;
            if (ty < 0 || ty % stride != 0 || ty / stride >= oh) continue;
            const int oy = ty / stride;
            for (int kx = 0; kx < 5; ++kx) {
                const int tx = ix + pad_left - kx;
                if (tx < 0 || tx % stride != 0 || tx / stride >= ow) continue;
                const int ox = tx / stride;
                acc = __fadd_rn(acc, __fmul_rn(g[((b * oh + oy) * ow + ox) * c + ch],
                                               kernel[(ky * 5 + kx) * c + ch]));
            }
        }
        dx[p] = acc;
    }
}

// Per-chunk partial sums of the weight (and bias) gradient of a 5x5
// convolution. A chunk is `rows` output rows (n, oy). Thread t owns the
// (ci, co) pair q = t % Q (depthwise: ci = co = q; else q = ci * cout + co)
// and lane t / Q of `lanes`, which walks the chunk's columns ox = lane,
// lane + lanes, ...; the lanes are then summed in order. Partial layout:
// [chunk][25 Q (+ cout bias sums)], tap-major as HWIO stores the kernel.
__global__ void conv_wgrad_partial_kernel(const float* __restrict__ x, const float* __restrict__ g,
                                          const float* __restrict__ out, float* __restrict__ partial,
                                          int n, int h, int w, int cin, int oh, int ow, int cout,
                                          int stride, int pad_top, int pad_left, int depthwise,
                                          int has_bias, int rows, int q_count, int lanes, int m) {
    extern __shared__ float red[];  // [lanes][m]
    const int t = threadIdx.x;
    const int q = t % q_count;
    const int lane = t / q_count;
    const bool active = lane < lanes;
    const int ci = depthwise ? q : q / cout;
    const int co = depthwise ? q : q % cout;
    float acc[kTaps];
#pragma unroll
    for (int k = 0; k < kTaps; ++k) acc[k] = 0.0f;
    float accb = 0.0f;
    const long long row0 = (long long)blockIdx.x * rows;
    const long long row1 = min(row0 + rows, (long long)n * oh);
    if (active) {
        for (long long row = row0; row < row1; ++row) {
            const long long b = row / oh;
            const int oy = (int)(row % oh);
            for (int ox = lane; ox < ow; ox += lanes) {
                const long long gi = ((b * oh + oy) * ow + ox) * cout + co;
                float gv = g[gi];
                if (out != nullptr && !(out[gi] > 0.0f)) gv = 0.0f;
                accb = __fadd_rn(accb, gv);
#pragma unroll
                for (int ky = 0; ky < 5; ++ky) {
                    const int iy = oy * stride - pad_top + ky;
                    if (iy < 0 || iy >= h) continue;
#pragma unroll
                    for (int kx = 0; kx < 5; ++kx) {
                        const int ix = ox * stride - pad_left + kx;
                        if (ix < 0 || ix >= w) continue;
                        const float xv = x[((b * h + iy) * w + ix) * cin + ci];
                        acc[ky * 5 + kx] = __fadd_rn(acc[ky * 5 + kx], __fmul_rn(gv, xv));
                    }
                }
            }
        }
        float* mine = red + (long long)lane * m;
#pragma unroll
        for (int k = 0; k < kTaps; ++k) mine[k * q_count + q] = acc[k];
        if (has_bias && (depthwise || ci == 0)) mine[kTaps * q_count + co] = accb;
    }
    __syncthreads();
    for (int i = t; i < m; i += blockDim.x) {
        float s = 0.0f;
        for (int l = 0; l < lanes; ++l) s = __fadd_rn(s, red[(long long)l * m + i]);
        partial[(long long)blockIdx.x * m + i] = s;
    }
}

// out0[i] (i < m0) or out1[i - m0] = the sum over chunks, in chunk order,
// of partial[chunk][i].
__global__ void reduce_chunks_kernel(const float* __restrict__ partial, int chunks, int m,
                                     float* __restrict__ out0, int m0, float* __restrict__ out1) {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < m; i += gridDim.x * blockDim.x) {
        float s = 0.0f;
        for (int c = 0; c < chunks; ++c) s = __fadd_rn(s, partial[(long long)c * m + i]);
        if (i < m0) out0[i] = s; else out1[i - m0] = s;
    }
}

// ---------------------------------------------------------------- K12

// One chunk of `chunk_px` pixels a block, in tiles of kPwTile: the tile's
// masked output gradient and inputs are staged in shared memory with the
// transposed weights; dy and the residual gradient are written per tile,
// and the block's dW / db partial sums stay in registers (pair i = t +
// j kThreads of the m = cin cout + cout sums) until the chunk ends.
__global__ void pw_backward_kernel(const float* __restrict__ g, long long g_bstride,
                                   const float* __restrict__ gscale, const float* __restrict__ out,
                                   const float* __restrict__ y, const float* __restrict__ wt,
                                   const float* __restrict__ res, float* __restrict__ dy,
                                   float* __restrict__ dres, float* __restrict__ partial, int n,
                                   int h, int w, int cin, int cout, int res_c, int res_pool,
                                   int accumulate, int chunk_px) {
    extern __shared__ float sm[];
    float* swt = sm;                        // [cout][cin]
    float* sg = swt + cin * cout;           // [kPwTile][cout]
    float* sy = sg + kPwTile * cout;        // [kPwTile][cin]
    const int t = threadIdx.x;
    const int hw = h * w;
    const int m = cin * cout + cout;
    for (int i = t; i < cin * cout; i += blockDim.x) {
        const int ci = i / cout, co = i % cout;
        swt[co * cin + ci] = wt[i];
    }
    const float scale = gscale != nullptr ? *gscale : 1.0f;
    float acc[kPwMaxAcc];
#pragma unroll
    for (int j = 0; j < kPwMaxAcc; ++j) acc[j] = 0.0f;
    const long long pixels = (long long)n * hw;
    const long long c0 = (long long)blockIdx.x * chunk_px;
    const long long c1 = min(c0 + chunk_px, pixels);
    for (long long p0 = c0; p0 < c1; p0 += kPwTile) {
        const int np = (int)min((long long)kPwTile, c1 - p0);
        __syncthreads();  // the previous tile's readers are done (and swt is staged)
        for (int i = t; i < np * cout; i += blockDim.x) {
            const long long p = p0 + i / cout;
            const int co = i % cout;
            float gv = g[(p / hw) * g_bstride + (p % hw) * cout + co];
            if (gscale != nullptr) gv = __fmul_rn(gv, scale);
            if (out != nullptr && !(out[p * cout + co] > 0.0f)) gv = 0.0f;
            sg[i] = gv;
        }
        for (int i = t; i < np * cin; i += blockDim.x) sy[i] = y[p0 * cin + i];
        __syncthreads();
        for (int i = t; i < np * cin; i += blockDim.x) {
            const int pl = i / cin, ci = i % cin;
            const float* gs = sg + pl * cout;
            float s = 0.0f;
            for (int co = 0; co < cout; ++co) s = __fadd_rn(s, __fmul_rn(gs[co], swt[co * cin + ci]));
            const long long o = (p0 + pl) * cin + ci;
            dy[o] = accumulate ? __fadd_rn(dy[o], s) : s;
        }
        if (res != nullptr) {
            for (int i = t; i < np * res_c; i += blockDim.x) {
                const int pl = i / res_c, c = i % res_c;
                const long long p = p0 + pl;
                const float gv = sg[pl * cout + c];
                if (!res_pool) {
                    dres[p * res_c + c] = gv;
                    continue;
                }
                const int x = (int)(p % w);
                const long long q = p / w;
                const int yy = (int)(q % h);
                const long long b = q / h;
                const int rw = 2 * w;
                const long long i00 = ((b * (2 * h) + 2 * yy) * rw + 2 * x) * res_c + c;
                const long long idx[4] = {i00, i00 + res_c, i00 + (long long)rw * res_c,
                                          i00 + (long long)rw * res_c + res_c};
                int first = 0;
                float best = res[idx[0]];
                for (int k = 1; k < 4; ++k) {
                    const float v = res[idx[k]];
                    if (v > best) { best = v; first = k; }
                }
                for (int k = 0; k < 4; ++k) dres[idx[k]] = k == first ? gv : 0.0f;
            }
        }
#pragma unroll
        for (int j = 0; j < kPwMaxAcc; ++j) {
            const int i = t + j * kThreads;
            if (i < cin * cout) {
                const int ci = i / cout, co = i % cout;
                float s = acc[j];
                for (int pl = 0; pl < np; ++pl)
                    s = __fadd_rn(s, __fmul_rn(sy[pl * cin + ci], sg[pl * cout + co]));
                acc[j] = s;
            } else if (i < m) {
                const int co = i - cin * cout;
                float s = acc[j];
                for (int pl = 0; pl < np; ++pl) s = __fadd_rn(s, sg[pl * cout + co]);
                acc[j] = s;
            }
        }
    }
#pragma unroll
    for (int j = 0; j < kPwMaxAcc; ++j) {
        const int i = t + j * kThreads;
        if (i < m) partial[(long long)blockIdx.x * m + i] = acc[j];
    }
}

// ---------------------------------------------------------------- K13

struct HeadMap {
    const float* x;
    const float* wc;
    const float* bc;
    const float* wr;
    const float* br;
    int hw, cin, na;
};

// A thread a (member, anchor): the anchor's logit and four offsets, its
// focal BCE and masked smooth-L1 terms, dlogits, and the smooth-L1's
// gradient before the 1 / normaliser (written into draw); per block, the
// fixed-order sums of focal, masked smooth-L1 and mask.
__global__ void head_loss_partial_kernel(HeadMap m16, HeadMap m8, const float* __restrict__ tp,
                                         const float* __restrict__ tb,
                                         const float* __restrict__ mask, float* __restrict__ dlogits,
                                         float* __restrict__ draw, float* __restrict__ partial,
                                         int n, float inv_count) {
    __shared__ float red[kThreads];
    const long long total = (long long)n * kAnchors;
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    float focal = 0.0f, l1m = 0.0f, mv = 0.0f;
    if (i < total) {
        const long long b = i / kAnchors;
        const int k = (int)(i % kAnchors);
        const int k16 = m16.hw * m16.na;
        const HeadMap& hm = k < k16 ? m16 : m8;
        const int kk = k < k16 ? k : k - k16;
        const int pix = kk / hm.na, a = kk % hm.na;
        const float* xs = hm.x + (b * hm.hw + pix) * hm.cin;
        const int rc = 4 * hm.na;
        float logit = 0.0f, r[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int ci = 0; ci < hm.cin; ++ci) {
            const float v = xs[ci];
            logit = __fmaf_rn(v, hm.wc[ci * hm.na + a], logit);
            const float* wrow = hm.wr + ci * rc + 4 * a;
#pragma unroll
            for (int j = 0; j < 4; ++j) r[j] = __fmaf_rn(v, wrow[j], r[j]);
        }
        logit = __fadd_rn(logit, hm.bc[a]);
        const float t = tp[i];
        const float p = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-logit)));
        const float lp = logf(__fadd_rn(p, 1e-7f));
        const float omt = __fsub_rn(1.0f, t);
        const float lq = logf(__fadd_rn(__fsub_rn(1.0f, p), 1e-7f));
        const float bce = -__fadd_rn(__fmul_rn(t, lp), __fmul_rn(omt, lq));
        const float wgt = __fadd_rn(0.25f, __fmul_rn(0.75f, t));
        focal = __fmul_rn(bce, wgt);
        // d focal / d logit, as JAX's reverse pass forms it
        const float ct = -__fmul_rn(inv_count, wgt);
        const float dp = __fsub_rn(__fdiv_rn(__fmul_rn(ct, t), __fadd_rn(p, 1e-7f)),
                                   __fdiv_rn(__fmul_rn(ct, omt),
                                             __fadd_rn(__fsub_rn(1.0f, p), 1e-7f)));
        dlogits[i] = __fmul_rn(dp, __fmul_rn(p, __fsub_rn(1.0f, p)));
        mv = mask[i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float d = __fsub_rn(__fadd_rn(r[j], hm.br[4 * a + j]), tb[i * 4 + j]);
            const float ad = fabsf(d);
            const bool quad = ad < 1.0f;
            const float l1 = quad ? __fmul_rn(__fmul_rn(0.5f, d), d) : __fsub_rn(ad, 0.5f);
            l1m = __fadd_rn(l1m, __fmul_rn(l1, mv));
            const float slope = quad ? d : (d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f));
            draw[i * 4 + j] = __fmul_rn(mv, slope);
        }
    }
    const float s0 = block_sum(focal, red);
    const float s1 = block_sum(l1m, red);
    const float s2 = block_sum(mv, red);
    if (threadIdx.x == 0) {
        partial[3 * blockIdx.x + 0] = s0;
        partial[3 * blockIdx.x + 1] = s1;
        partial[3 * blockIdx.x + 2] = s2;
    }
}

// Every block sums the partials in the same order (so all agree on the
// normaliser), block 0 writes the loss, and the blocks scale draw by
// 1 / (sum(mask) * 4 + 1e-6).
__global__ void head_loss_final_kernel(const float* __restrict__ partial, int parts,
                                       float* __restrict__ draw, float* __restrict__ loss,
                                       long long total4, float count) {
    __shared__ float red[kThreads];
    float s[3];
    for (int j = 0; j < 3; ++j) {
        float v = 0.0f;
        for (int q = threadIdx.x; q < parts; q += blockDim.x) v = __fadd_rn(v, partial[3 * q + j]);
        s[j] = block_sum(v, red);
    }
    const float denom = __fadd_rn(__fmul_rn(s[2], 4.0f), 1e-6f);
    if (blockIdx.x == 0 && threadIdx.x == 0)
        *loss = __fadd_rn(__fdiv_rn(s[0], count), __fdiv_rn(s[1], denom));
    const float inv = __fdiv_rn(1.0f, denom);
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total4;
         i += (long long)gridDim.x * blockDim.x)
        draw[i] = __fmul_rn(draw[i], inv);
}

// ---------------------------------------------------------------- K14

__global__ void adam_kernel(float* __restrict__ params, const float* __restrict__ grads,
                            float* __restrict__ mu, float* __restrict__ nu, long long count,
                            float one_minus_b1, float b1, float one_minus_b2, float b2, float bc1,
                            float bc2, float eps, float neg_lr) {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < count;
         i += (long long)gridDim.x * blockDim.x) {
        const float gv = grads[i];
        const float m = __fadd_rn(__fmul_rn(one_minus_b1, gv), __fmul_rn(b1, mu[i]));
        const float v = __fadd_rn(__fmul_rn(one_minus_b2, __fmul_rn(gv, gv)), __fmul_rn(b2, nu[i]));
        mu[i] = m;
        nu[i] = v;
        const float u = __fdiv_rn(__fdiv_rn(m, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), eps));
        params[i] = __fadd_rn(params[i], __fmul_rn(neg_lr, u));
    }
}

}  // namespace

// K11 on `stream`. `x` f32 [n, h, w, cin], `g` the output gradient f32
// [n, oh, ow, cout], `out` the saved output (ReLU mask) or null, `kernel`
// HWIO f32. Writes `dx` (depthwise only; null skips it), `dk` (HWIO, the
// kernel's shape) and `db` [cout] (null: no bias); `partial` is scratch of
// chunks * (25 Q + (db ? cout : 0)) floats, chunks = ceil(n oh / rows).
extern "C" int flyimg_bf_conv5x5_backward(const float* x, const float* g, const float* out,
                                          const float* kernel, float* dx, float* dk, float* db,
                                          float* partial, int n, int h, int w, int cin, int oh,
                                          int ow, int cout, int stride, int pad_top, int pad_left,
                                          int depthwise, int rows, void* stream) {
    if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || oh <= 0 || ow <= 0 || cout <= 0 ||
        stride < 1 || rows <= 0 || (depthwise && cout != cin) || (dx != nullptr && !depthwise))
        return (int)cudaErrorInvalidValue;
    const int q_count = depthwise ? cin : cin * cout;
    if (q_count > kThreads) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dx != nullptr) {
        dw_input_grad_kernel<<<blocks_for((long long)n * h * w * cin, kThreads), kThreads, 0, s>>>(
            g, kernel, dx, n, h, w, cin, oh, ow, stride, pad_top, pad_left);
        const int rc = (int)cudaGetLastError();
        if (rc != 0) return rc;
    }
    const int lanes = kThreads / q_count;
    const int m = kTaps * q_count + (db != nullptr ? cout : 0);
    const size_t smem = sizeof(float) * (size_t)lanes * m;
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    const long long chunks = ((long long)n * oh + rows - 1) / rows;
    conv_wgrad_partial_kernel<<<(int)chunks, kThreads, smem, s>>>(
        x, g, out, partial, n, h, w, cin, oh, ow, cout, stride, pad_top, pad_left, depthwise,
        db != nullptr, rows, q_count, lanes, m);
    int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    reduce_chunks_kernel<<<blocks_for(m, kThreads), kThreads, 0, s>>>(partial, (int)chunks, m, dk,
                                                                       kTaps * q_count, db);
    return (int)cudaGetLastError();
}

// K12 on `stream`. `g` the output gradient [n, h, w, cout] with member
// stride `g_bstride` floats (pixels and channels dense), scaled by
// `*gscale` when not null; `out` the saved output (ReLU mask) or null;
// `y` f32 [n, h, w, cin]; `wt` [cin, cout]; `res` the block input
// [n, h, w, res_c] or, with `res_pool`, [n, 2h, 2w, res_c], or null. Writes
// (or with `accumulate` adds to) `dy`, writes `dres` (the residual's
// shape) and dW [cin, cout] into `dw`, db [cout] into `db`; `partial` is
// scratch of chunks * (cin cout + cout) floats, chunks = ceil(n h w /
// chunk_px), chunk_px a multiple of 16.
extern "C" int flyimg_bf_pointwise_backward(const float* g, long long g_bstride,
                                            const float* gscale, const float* out, const float* y,
                                            const float* wt, const float* res, float* dy,
                                            float* dres, float* dw, float* db, float* partial,
                                            int n, int h, int w, int cin, int cout, int res_c,
                                            int res_pool, int accumulate, int chunk_px,
                                            void* stream) {
    if (n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || chunk_px <= 0 ||
        chunk_px % kPwTile != 0 || (long long)cin * cout + cout > (long long)kPwMaxAcc * kThreads ||
        (res != nullptr && (res_c <= 0 || res_c > cout || dres == nullptr)))
        return (int)cudaErrorInvalidValue;
    const size_t smem = sizeof(float) * ((size_t)cin * cout + (size_t)kPwTile * (cin + cout));
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    int rc = (int)cudaFuncSetAttribute(pw_backward_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != 0) return rc;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long chunks = ((long long)n * h * w + chunk_px - 1) / chunk_px;
    pw_backward_kernel<<<(int)chunks, kThreads, smem, s>>>(
        g, g_bstride, gscale, out, y, wt, res, dy, dres, partial, n, h, w, cin, cout, res_c,
        res_pool, accumulate, chunk_px);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    const int m = cin * cout + cout;
    reduce_chunks_kernel<<<blocks_for(m, kThreads), kThreads, 0, s>>>(partial, (int)chunks, m, dw,
                                                                       cin * cout, db);
    return (int)cudaGetLastError();
}

// K13 on `stream`: maps x16 [n, hw16, c16] and x8 [n, hw8, c8] with their
// class (wc [c, na], bc [na]) and offset (wr [c, 4 na], br [4 na]) heads,
// targets tp [n, 896], tb [n, 896, 4], mask [n, 896]. Writes dlogits
// [n, 896], draw [n, 896, 4] and `loss` [1]; `partial` is scratch of
// 3 ceil(n 896 / 256) floats. inv_count = f32(1 / (n 896)), count = n 896.
extern "C" int flyimg_bf_head_loss(const float* x16, const float* wc16, const float* bc16,
                                   const float* wr16, const float* br16, int hw16, int c16,
                                   int na16, const float* x8, const float* wc8, const float* bc8,
                                   const float* wr8, const float* br8, int hw8, int c8, int na8,
                                   const float* tp, const float* tb, const float* mask,
                                   float* dlogits, float* draw, float* loss, float* partial, int n,
                                   float inv_count, float count, void* stream) {
    if (n <= 0 || hw16 * na16 + hw8 * na8 != kAnchors || c16 <= 0 || c8 <= 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const HeadMap m16{x16, wc16, bc16, wr16, br16, hw16, c16, na16};
    const HeadMap m8{x8, wc8, bc8, wr8, br8, hw8, c8, na8};
    const long long total = (long long)n * kAnchors;
    const int parts = (int)((total + kThreads - 1) / kThreads);
    head_loss_partial_kernel<<<parts, kThreads, 0, s>>>(m16, m8, tp, tb, mask, dlogits, draw,
                                                         partial, n, inv_count);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    head_loss_final_kernel<<<blocks_for(total * 4, kThreads), kThreads, 0, s>>>(
        partial, parts, draw, loss, total * 4, count);
    return (int)cudaGetLastError();
}

// K14 on `stream`: params, mu, nu updated in place from grads, `count`
// values each; bc1 = 1 - b1^t, bc2 = 1 - b2^t (f32, from the host).
extern "C" int flyimg_bf_adam(float* params, const float* grads, float* mu, float* nu,
                              long long count, float one_minus_b1, float b1, float one_minus_b2,
                              float b2, float bc1, float bc2, float eps, float neg_lr,
                              void* stream) {
    if (count <= 0) return (int)cudaErrorInvalidValue;
    adam_kernel<<<blocks_for(count, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        params, grads, mu, nu, count, one_minus_b1, b1, one_minus_b2, b2, bc1, bc2, eps, neg_lr);
    return (int)cudaGetLastError();
}
