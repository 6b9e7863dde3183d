// K1: banded K-tap windowed resample of a u8 batch, fused u8 load ->
// vertical band pass -> horizontal band pass -> round/clip/u8 store, or, in
// its f32-store form, the f32 result stored as it is for the program stages
// that follow the resample (the reference keeps the resample's f32 through
// every later stage and rounds once at the end).
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
// invariant, docs/kernels.md). A tap outside the source therefore carries
// zero weight, and the kernel skips it where the plain version gathers a
// clipped index and multiplies it by zero.
//
// What bounds it on an H100: instructions a byte. The bytes (each source
// byte the bands reach, read once, plus the output) take ~0.07 ms at the
// flagship (256 x 512x512x3 -> 300x250, K = 16); the ~2.5 G multiply-adds take
// about as long at the f32 rate, so the kernel has to spend little beside
// them. Design:
//   - a first small kernel evaluates every band weight once per member and
//     axis (the filter's sin/exp work) into f32 tables, a segment of lanes
//     per output sample on neighbouring taps;
//   - the main kernel runs one block per (member, tile of NX output
//     columns, run of tiles of T output rows): the run's row band starts and
//     weights and the column tile's are staged once. Each row tile's vertical
//     band weights are laid out in shared memory as a dense [source row][T]
//     table (zero off the band), so the vertical pass needs no index
//     arithmetic;
//   - vertical pass, register-blocked: a thread owns one 32-bit source word
//     (4 channel bytes) and the accumulators of 4 output rows. It streams the
//     source rows those 4 rows' bands cover, unpacks each word ONCE per
//     source row without the int->float unit (__byte_perm builds 2^23 + byte
//     as a float, one FADD makes it exact) and adds it into all 4 rows with
//     16 FMAs. The f32 result for the tile lands in shared memory;
//   - horizontal pass: threads map over (output row, output column) of the
//     tile, so all of them are busy; the member's column weights for the tile
//     are staged once per block when they fit;
//   - the u8 results are packed into 32-bit stores.
// Every choice of T, NX and the shared-memory chunks is made on the host
// (ops/resample.py k1_plan). The tile's source window is found on the card
// from the band starts; a window wider than the staged chunk is processed in
// column chunks (partial sums kept in shared memory, tap order kept) and a
// taller one in row chunks, so no source size is refused.
// Each output sums its taps in tap order, as the plain version does (the
// vertical pass adds exact zeros for the rows between bands).
// The tiled form (a lower valid row per member) is the per-rank resample of
// flyimg_tpu/parallel/tiling.py _build_tiled_program: a rank's member is its
// tile with the halo rows its neighbours sent, its geometry row the rank's
// span in local rows, and rows below `row_lo` (rank 0's zero-filled top
// halo) carry no weight, as rows at or past in_true never do. Its row
// sample positions round start + (i + .5) q once (an FMA), as XLA computes
// the jitted reference.
// No tensor cores: TF32 would move many outputs by one u8 level.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Method { LANCZOS3 = 0, TRIANGLE = 1, GAUSSIAN = 2, CUBIC = 3, BOX = 4, NEAREST = 5 };

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float sinc_f(float x) {
    // jnp.sinc: sin(pi x) / (pi x), 1 at 0; sinpif takes the product
    // exactly, with no slow range-reduction path
    if (x == 0.0f) return 1.0f;
    return sinpif(x) / __fmul_rn(3.14159265358979323846f, x);
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

// One segment of S lanes per (member, output sample) of one axis (S a power
// of two up to 32): K normalised weights and the unclipped band start j0.
// Lane l evaluates taps l, l + S, ...; the segment adds its partial sums by
// a fixed butterfly, so every lane holds the same total and consecutive
// lanes store consecutive taps. geom rows are [span_y(2), span_x(2),
// out_true(h, w), in_true(h, w)]; lo (or null: 0) is the lowest valid source
// index of each member on this axis.
__global__ void band_weights_kernel(const float* __restrict__ geom, const float* __restrict__ lo,
                                    int batch, int axis, int in_size, int out_size, int taps,
                                    int method, int S, float* __restrict__ w,
                                    int* __restrict__ j0_out) {
    const int gid = blockIdx.x * blockDim.x + threadIdx.x;
    const int idx = gid / S;
    const int lane = gid - idx * S;
    const bool valid = idx < batch * out_size;
    const int b = valid ? idx / out_size : 0;
    const int i = valid ? idx - b * out_size : 0;
    const float* g = geom + (size_t)b * 8;
    const float start = g[axis * 2 + 0];
    const float size = g[axis * 2 + 1];
    const float out_true = fmaxf(g[4 + axis], 1.0f);
    const float in_true = g[6 + axis];
    const float in_lo = lo != nullptr ? lo[b] : 0.0f;
    const float q = size / out_true;
    // the reference's operation order: floor(x) picks the band, so x must
    // round exactly as it does there — no FMA contraction, except in the
    // tiled form (lo given), whose reference program is jitted and has XLA
    // fuse start + (i + .5) q into one multiply-add
    const float iq = __fadd_rn((float)i, 0.5f);
    float x = __fsub_rn(lo != nullptr ? __fmaf_rn(iq, q, start)
                                      : __fadd_rn(start, __fmul_rn(iq, q)), 0.5f);
    x = fminf(fmaxf(x, 0.0f), fmaxf(in_true - 1.0f, 0.0f));
    const int j0 = taps >= in_size ? 0 : (int)floorf(x) - taps / 2 + 1;
    float* wr = w + (size_t)idx * taps;
    if (valid && lane == 0) j0_out[idx] = j0;
    if (method == NEAREST) {
        const float near = fminf(fmaxf(floorf(x + 0.5f), 0.0f), fmaxf(in_true - 1.0f, 0.0f));
        if (valid)
            for (int k = lane; k < taps; k += S)
                wr[k] = ((float)(j0 + k) == near && (float)(j0 + k) >= in_lo) ? 1.0f : 0.0f;
        return;
    }
    // with at most one tap a lane (taps <= S) the weight stays in a
    // register; otherwise the lane's taps are stored, then normalised
    const float s = fmaxf(q, 1.0f);
    float sum = 0.0f, own = 0.0f;
    for (int k = lane; k < taps; k += S) {
        const int j = j0 + k;
        float wk = filter_fn(method, ((float)j - x) / s);
        if (!(j >= 0 && (float)j >= in_lo && (float)j < in_true)) wk = 0.0f;
        if (valid && taps > S) wr[k] = wk;
        own = wk;
        sum += wk;
    }
    for (int off = S / 2; off >= 1; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float denom = sum == 0.0f ? 1.0f : sum;
    if (!valid) return;
    if (taps <= S) {
        if (lane < taps) wr[lane] = own / denom;
    } else {
        for (int k = lane; k < taps; k += S) wr[k] = wr[k] / denom;
    }
}

constexpr int K1_THREADS = 256;
constexpr int K1_SUB = 4;  // output rows a thread accumulates in the vertical pass

// 2^23 + b as a float bit pattern (b = byte `sel` of v), minus 2^23: exact
__device__ __forceinline__ float byte_to_float(uint32_t v, uint32_t sel) {
    return __int_as_float((int)__byte_perm(v, 0x4B000000u, 0x7650u | sel)) - 8388608.0f;
}

__device__ __forceinline__ uint32_t to_u8(float a) {
    return (uint32_t)fminf(fmaxf(rintf(a), 0.0f), 255.0f);
}

// Dense vertical weights of source rows [r0, r0 + RC) for the tile's T rows:
// wd[rr * T + t] = weight of row r0 + rr in output row t's band, else 0.
// wyb holds the tile's [T][ky] band weights, in shared or device memory.
__device__ __forceinline__ void build_wd(float* wd, const float* wyb, const int* jy_s, int r0,
                                         int r1, int RC, int T, int tn, int ky) {
    for (int i = threadIdx.x; i < RC * T; i += K1_THREADS) {
        const int rr = i / T, t = i - rr * T;
        const int k = r0 + rr - jy_s[t];
        float w = 0.0f;
        if (t < tn && r0 + rr < r1 && k >= 0 && k < ky) w = wyb[(size_t)t * ky + k];
        wd[i] = w;
    }
}

// Lanes of the weight kernel per output sample: K rounded up to a power of
// two, at most a warp.
inline int lanes_for(int taps) {
    int S = 1;
    while (S < taps && S < 32) S *= 2;
    return S;
}

// Row pitch (floats) of the vertical-pass buffer for WC staged source
// columns: whole source words from the chunk's first word, float4-aligned.
__host__ __device__ __forceinline__ int vs_pitch(int WC) { return (3 * WC + 8 + 3) & ~3; }

// Row pitch (bytes) of the u8 output staging for NX output columns: room for
// a row shifted by its destination's offset within a 32-bit word.
__host__ __device__ __forceinline__ int os_pitch(int NX) { return (3 * NX + 3 + 15) & ~15; }

// One block per (column tile, run of row tiles) x member; 3 channels,
// interleaved [h, w, 3]. KX > 0 fixes the horizontal band width at compile
// time (the tap loop unrolls); 0 reads it at run time. F32 stores the f32
// result to outf instead of u8 to out (its own instance, so the u8 instances
// compile as they did without it). The source width must be a multiple of 4,
// so a row is whole 32-bit words.
template <int KX, bool F32>
__global__ void __launch_bounds__(K1_THREADS)
resample_tile_kernel(const uint8_t* __restrict__ img, uint8_t* __restrict__ out,
                     float* __restrict__ outf, const float* __restrict__ wy, const int* __restrict__ jy,
                     const float* __restrict__ wx, const int* __restrict__ jx, int in_h,
                     int in_w, int out_h, int out_w, int ky, int kx_rt, int T, int NX, int WC,
                     int RC, int stage_wx, int stage_wy, int n_ct, int tiles_per_block) {
    const int kx = KX > 0 ? KX : kx_rt;
    const int VP = vs_pitch(WC);
    const int OP = os_pitch(NX);
    const int TR = tiles_per_block * T;  // output rows of the block's run
    extern __shared__ float4 smem4[];
    float* wd = reinterpret_cast<float*>(smem4);         // [RC][T]
    float* vs = wd + RC * T;                             // [T][VP] vertical pass
    float* hs = vs + T * VP;                             // [T][NX * 3] partial sums
    float* wy_s = hs + T * NX * 3;                       // [TR][ky] if staged
    uint8_t* os = reinterpret_cast<uint8_t*>(wy_s + (stage_wy ? TR * ky : 0));  // [T][OP]
    float* wx_s = reinterpret_cast<float*>(os + T * OP);  // [NX][kx | 1] if staged
    int* jy_s = reinterpret_cast<int*>(wx_s + (stage_wx ? NX * (kx | 1) : 0));  // [TR]
    int* jx_s = jy_s + TR;                                                       // [NX]

    const int b = blockIdx.y;
    const int rg = blockIdx.x / n_ct;
    const int cx = blockIdx.x - rg * n_ct;
    const int ox0 = cx * NX;
    const int nxn = min(NX, out_w - ox0);
    const int n_rt = (out_h + T - 1) / T;
    const int rt0 = rg * tiles_per_block;
    const int rt_end = min(n_rt, rt0 + tiles_per_block);
    const int tid = threadIdx.x;

    // the run's row band starts (rows past the output repeat the last one)
    // and, when staged, its row weights, loaded once for all its tiles
    const int oyr = rt0 * T;
    const int* jyb = jy + (size_t)b * out_h;
    const float* wyr = wy + ((size_t)b * out_h + oyr) * ky;
    for (int i = tid; i < TR; i += K1_THREADS) jy_s[i] = jyb[min(oyr + i, out_h - 1)];
    if (stage_wy)
        for (int i = tid; i < min(TR, out_h - oyr) * ky; i += K1_THREADS) wy_s[i] = __ldg(wyr + i);
    // the column tile's band starts and weights, staged once for every row
    // tile the block takes; staged rows get an odd pitch, so the neighbouring
    // columns that lanes read in step fall in different banks
    const int* jxb = jx + (size_t)b * out_w + ox0;
    const float* wxb = wx + ((size_t)b * out_w + ox0) * kx;
    const int wx_pitch = stage_wx ? (kx | 1) : kx;
    for (int i = tid; i < nxn; i += K1_THREADS) jx_s[i] = jxb[i];
    if (stage_wx)
        for (int i = tid; i < nxn * kx; i += K1_THREADS) {
            const int ox = i / kx;
            wx_s[ox * wx_pitch + (i - ox * kx)] = __ldg(wxb + i);
        }
    const float* wxp = stage_wx ? wx_s : wxb;
    __syncthreads();
    // the tile's source columns: band starts are monotone in the output
    // index, so the first and last columns bound them
    const int plo = clampi(jx_s[0], 0, in_w - 1);
    const int phi = clampi(jx_s[nxn - 1] + kx - 1, 0, in_w - 1) + 1;  // exclusive

    const int pitch_w = in_w * 3 / 4;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(img + (size_t)b * in_h * in_w * 3);
    for (int rt = rt0; rt < rt_end; ++rt) {
        const int oy0 = rt * T;
        const int tn = min(T, out_h - oy0);
        const int* jyt = jy_s + (oy0 - oyr);
        const float* wyb = (stage_wy ? wy_s : wyr) + (size_t)(oy0 - oyr) * ky;
        if (rt > rt0) __syncthreads();  // the previous tile is done with wd and os
        const int rlo = max(jyt[0], 0);
        const int rhi = min(jyt[tn - 1] + ky, in_h);  // exclusive
        const bool row_chunks = rhi - rlo > RC;
        if (!row_chunks) {
            build_wd(wd, wyb, jyt, rlo, rhi, RC, T, tn, ky);
            __syncthreads();
        }
        const int nsub = (tn + K1_SUB - 1) / K1_SUB;
        for (int p0 = plo; p0 < phi; p0 += WC) {
            const int p1 = min(p0 + WC, phi);
            const int w0 = (3 * p0) >> 2;
            const int nw = ((3 * p1 + 3) >> 2) - w0;
            const int tasks = nw * nsub;

            // vertical pass: task = (4-row subtile, source word); the word's 4
            // channel bytes land as one float4 at 4 * (word - w0)
            for (int base = 0; base < tasks; base += K1_THREADS) {
                const int task = base + tid;
                const bool active = task < tasks;
                const int sub = active ? task / nw : 0;
                const int wi = w0 + (active ? task - sub * nw : 0);
                const int t0 = sub * K1_SUB;
                const int ra = max(jyt[t0], 0);
                const int rb = min(jyt[min(t0 + K1_SUB - 1, tn - 1)] + ky, in_h);
                float acc[K1_SUB][4];
#pragma unroll
                for (int t = 0; t < K1_SUB; ++t)
#pragma unroll
                    for (int c = 0; c < 4; ++c) acc[t][c] = 0.0f;
                for (int r0 = rlo; r0 < rhi; r0 += RC) {
                    const int r1 = min(r0 + RC, rhi);
                    if (row_chunks) {
                        __syncthreads();
                        build_wd(wd, wyb, jyt, r0, r1, RC, T, tn, ky);
                        __syncthreads();
                    }
                    if (!active) continue;
                    const int e = min(r1, rb);
                    const uint32_t* sp = src + wi;
#pragma unroll 4
                    for (int r = max(r0, ra); r < e; ++r) {
                        const uint32_t v = __ldg(sp + (size_t)r * pitch_w);
                        const float4 w4 =
                            *reinterpret_cast<const float4*>(wd + (r - r0) * T + t0);
                        const float wt[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
                        for (int c = 0; c < 4; ++c) {
                            const float f = byte_to_float(v, c);
#pragma unroll
                            for (int t = 0; t < K1_SUB; ++t)
                                acc[t][c] = fmaf(wt[t], f, acc[t][c]);
                        }
                    }
                }
                if (active) {
#pragma unroll
                    for (int t = 0; t < K1_SUB; ++t)
                        *reinterpret_cast<float4*>(vs + (t0 + t) * VP + 4 * (wi - w0)) =
                            make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
                }
            }
            __syncthreads();

            // horizontal pass over this chunk's columns, taps in order;
            // partial sums carry over between chunks in hs
            const int org = 4 * w0;  // vs holds source byte B at B - org
            const bool first = p0 == plo, last = p1 == phi;
            for (int o = tid; o < tn * nxn; o += K1_THREADS) {
                const int t = o / nxn;
                const int ox = o - t * nxn;
                float* h = hs + t * NX * 3 + ox * 3;
                float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
                if (!first) {
                    a0 = h[0];
                    a1 = h[1];
                    a2 = h[2];
                }
                const int j0 = jx_s[ox];
                const float* w = wxp + (size_t)ox * wx_pitch;
                const float* v = vs + t * VP - org;
                const int ka = max(p0 - j0, 0), kb = min(p1 - j0, kx);
                if (ka == 0 && kb == kx) {
#pragma unroll
                    for (int k = 0; k < kx; ++k) {
                        const float wk = w[k];
                        const float* p = v + (j0 + k) * 3;
                        a0 = fmaf(wk, p[0], a0);
                        a1 = fmaf(wk, p[1], a1);
                        a2 = fmaf(wk, p[2], a2);
                    }
                } else {
                    for (int k = ka; k < kb; ++k) {
                        const float wk = w[k];
                        const float* p = v + (j0 + k) * 3;
                        a0 = fmaf(wk, p[0], a0);
                        a1 = fmaf(wk, p[1], a1);
                        a2 = fmaf(wk, p[2], a2);
                    }
                }
                if (F32 && last) {
                    // the f32-store form: every output row and column,
                    // those past out_true included, as computed
                    float* q = outf + ((size_t)(b * out_h + oy0 + t) * out_w + ox0 + ox) * 3;
                    q[0] = a0;
                    q[1] = a1;
                    q[2] = a2;
                } else if (last) {
                    // round/clip to u8, staged at the row's offset within a
                    // 32-bit word of its destination
                    const size_t at = ((size_t)(b * out_h + oy0 + t) * out_w + ox0) * 3;
                    uint8_t* q = os + t * OP + (int)(at & 3) + ox * 3;
                    q[0] = (uint8_t)to_u8(a0);
                    q[1] = (uint8_t)to_u8(a1);
                    q[2] = (uint8_t)to_u8(a2);
                } else {
                    h[0] = a0;
                    h[1] = a1;
                    h[2] = a2;
                }
            }
            __syncthreads();
        }

        // store each output row of the tile as 32-bit words (single bytes
        // only in a row's first and last word)
        if (F32) continue;
        const int nbytes = nxn * 3;
        const int nwr = (nbytes + 3 + 3) / 4;  // words a shifted row can touch
        for (int i = tid; i < tn * nwr; i += K1_THREADS) {
            const int t = i / nwr;
            const int j = i - t * nwr;
            const size_t at = ((size_t)(b * out_h + oy0 + t) * out_w + ox0) * 3;
            const int mis = (int)(at & 3);
            const int lo = max(4 * j, mis), hi = min(4 * j + 4, mis + nbytes);
            if (lo >= hi) continue;
            const uint8_t* q = os + t * OP;
            uint8_t* dst = out + at - mis;
            if (hi - lo == 4)
                *reinterpret_cast<uint32_t*>(dst + 4 * j) =
                    *reinterpret_cast<const uint32_t*>(q + 4 * j);
            else
                for (int k = lo; k < hi; ++k) dst[k] = q[k];
        }
    }
}

}  // namespace

// Shared-memory bytes of one block of the tile kernel for a plan (the
// wrapper's plan computes the same sum, ops/resample.py k1_smem_bytes; the
// launch checks they agree).
static size_t smem_bytes(int T, int NX, int WC, int RC, int ky, int kx, int stage_wx,
                         int stage_wy, int tiles_per_block) {
    const size_t TR = (size_t)tiles_per_block * T;
    return ((size_t)RC * T + (size_t)T * vs_pitch(WC) + (size_t)T * NX * 3 +
            (stage_wy ? TR * ky : 0) + (stage_wx ? (size_t)NX * (kx | 1) : 0) + TR + NX) * 4 +
           (size_t)T * os_pitch(NX);
}

// Launch both kernels on `stream`. img is u8 [batch, in_h, in_w, 3], geom f32
// [batch, 8] (above), row_lo f32 [batch] or null (the lowest valid source
// row of each member; null = 0). wy/jy and wx/jx are scratch tables of
// [batch, out_h, ky] / [batch, out_h] and [batch, out_w, kx] / [batch, out_w].
// The plan (T, NX, WC, RC, stage_wx, stage_wy, kx_static, tiles_per_block,
// smem) comes from the host;
// kx_static names the compiled instance (0 = run-time K). Exactly one of
// out (u8) and outf (f32) is non-null. Returns cudaGetLastError() after the
// launches, or cudaErrorInvalidValue for a plan the kernel does not take.
extern "C" int flyimg_resample_banded(const uint8_t* img, uint8_t* out, float* outf,
                                      const float* geom, const float* row_lo, float* wy,
                                      int* jy, float* wx, int* jx, int batch, int in_h,
                                      int in_w, int out_h, int out_w, int ky, int kx,
                                      int method, int T, int NX, int WC, int RC, int stage_wx,
                                      int stage_wy, int kx_static, int tiles_per_block,
                                      int smem, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if ((out == nullptr) == (outf == nullptr) || T <= 0 || T % K1_SUB || NX <= 0 || WC <= 0 || RC <= 0 || tiles_per_block <= 0 ||
        in_w % 4 ||
        (kx_static != 0 && kx_static != kx) ||
        (size_t)smem != smem_bytes(T, NX, WC, RC, ky, kx, stage_wx, stage_wy, tiles_per_block))
        return (int)cudaErrorInvalidValue;
    const int threads = 256;
    const int sy = lanes_for(ky), sx = lanes_for(kx);
    const long ny = (long)batch * out_h * sy;
    const long nx = (long)batch * out_w * sx;
    band_weights_kernel<<<(int)((ny + threads - 1) / threads), threads, 0, s>>>(
        geom, row_lo, batch, 0, in_h, out_h, ky, method, sy, wy, jy);
    band_weights_kernel<<<(int)((nx + threads - 1) / threads), threads, 0, s>>>(
        geom, nullptr, batch, 1, in_w, out_w, kx, method, sx, wx, jx);
    const int n_ct = (out_w + NX - 1) / NX;
    const int n_rt = (out_h + T - 1) / T;
    const int n_rg = (n_rt + tiles_per_block - 1) / tiles_per_block;
    dim3 grid(n_rg * n_ct, batch);
    void (*kern)(const uint8_t*, uint8_t*, float*, const float*, const int*, const float*,
                 const int*, int, int, int, int, int, int, int, int, int, int, int, int, int,
                 int);
    const bool f32 = outf != nullptr;
    switch (kx_static) {
    case 8: kern = f32 ? resample_tile_kernel<8, true> : resample_tile_kernel<8, false>; break;
    case 16: kern = f32 ? resample_tile_kernel<16, true> : resample_tile_kernel<16, false>; break;
    case 32: kern = f32 ? resample_tile_kernel<32, true> : resample_tile_kernel<32, false>; break;
    case 0: kern = f32 ? resample_tile_kernel<0, true> : resample_tile_kernel<0, false>; break;
    default: return (int)cudaErrorInvalidValue;
    }
    if (smem > 48 * 1024) {
        cudaError_t err =
            cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
    }
    kern<<<grid, K1_THREADS, smem, s>>>(img, out, outf, wy, jy, wx, jx, in_h, in_w, out_h,
                                       out_w, ky, kx, T, NX, WC, RC, stage_wx, stage_wy, n_ct,
                                       tiles_per_block);
    return (int)cudaGetLastError();
}
