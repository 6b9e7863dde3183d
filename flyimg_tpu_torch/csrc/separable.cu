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
// ~gain * thr * 255 levels). Every sum starts at 0 and adds the taps in
// order by fmaf, the H pass first: each output has one value, whichever
// form computes it.
//
// What bounds it on an H100: bytes (x read once, the output written once)
// for the tap counts a URL gives; the f32 rate only past ~100 taps.
//
// Form 0, the 2-D tile (ops/filters.py k5_plan picks it, at 16 x 128 output
// pixels, while two blocks fit an SM: up to 29 taps): one launch, a block
// of 256 threads a TH x TW-pixel output tile of one member, no scratch
// buffer.
//   - staging: the tile's (TH + K - 1) x (TW + K - 1)-pixel source window
//     is copied into shared memory once by cp.async, a warp a row: the
//     row's 16-byte words whole (the window's first float then sits at its
//     offset within its word, kept a row in `rofs`); where the window needs
//     an edge clamp in W, 4-byte copies from clamped source indices; rows
//     are clamped by their source index. Neighbouring tiles' windows overlap
//     by K - 1 pixels, which come from L2;
//   - the H pass: a thread walks one float column of the window down the
//     tile, 8 output rows a step, compile-time K keeping the K - 1 rows two
//     steps share and the taps in registers; the sums go to a second shared
//     buffer of TH rows;
//   - the W pass: a thread's item is a row and 8 output pixels, its three
//     channels in turn, the same register window along the row;
//     consecutive lanes take consecutive rows, and an odd row pitch puts
//     them in distinct banks;
//   - the unsharp epilogue reads x from the staged window's centre (the
//     same bits as a global read: the centre is never clamped);
//   - the outputs wait in registers until the window is read, are staged
//     in its space as whole words (an item's 24 values are consecutive in
//     the output row) and leave as 16-byte stores, each assembled by funnel
//     shifts where the row's bytes are not aligned, elements at the ends of
//     a row; a warp a row.
// What the design does not hide (builds with a part cut out, timed on an
// H100): each block copies its window, sums, then stores, and with three
// blocks an SM the copies overlap the sums only across blocks.
// Compile-time instances take K = 3 (unsh_0.25x0.25), 5 (sh_2x1) and 13
// (blr_0x2); one instance takes any K at run time, its sums a chunk of 8
// taps at a time with the chunk's taps and rows in registers (a tap a
// shared-memory load per multiply-add read 3.4x slower at 21 taps).
//
// Form 1, two passes through an f32 scratch buffer, past 29 taps (where the
// tile form's window leaves one block an SM and reads slower; it fits
// shared memory up to ~125 taps):
//   - vertical pass: a thread owns one float column of the row-major
//     [H, W * 3] plane and VR consecutive output rows; it streams the
//     VR + K - 1 source rows those need, each added into every accumulator
//     whose band holds it (taps in order);
//   - horizontal pass: a block stages one row segment of HX pixels plus the
//     (K - 1)-pixel halo, edge-clamped, in shared memory, and each thread
//     sums its outputs' taps from there, then applies the epilogue and
//     stores f32 or u8.
//
// The tiled form (halo > 0) replaces the per-device body of
// flyimg_tpu/parallel/tiling.py _build_tiled_filter: the input holds `halo`
// extra rows above and below each member (a rank's tile with the rows its
// neighbours sent), the H pass reads them instead of clamping (valid in H,
// halo = K / 2, so no clamp binds), the W pass keeps its edge clamp, and the
// unsharp epilogue reads x from the member's own rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ uint8_t to_u8(float a) {
    return (uint8_t)fminf(fmaxf(rintf(a), 0.0f), 255.0f);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}


// A warp stores bytes [0, n) of a staged row (shared words from `srow`, a
// word of room past them) to `grow`: 16-byte stores where the global address
// is aligned (each assembled from five words by funnel shifts), elements of
// ESZ bytes at the row's two ends; the lanes split all three.
template <int ESZ>
__device__ __forceinline__ void store_row(uint8_t* grow, const uint32_t* srow, int n, int lane) {
    const int head = min(n, (int)((16 - ((uintptr_t)grow & 15)) & 15));
    const int nb = (n - head) >> 4;
    for (int q = lane; q < nb; q += 32) {
        const int s = head + 16 * q;
        const uint32_t* w = srow + (s >> 2);
        uint4 v;
        if constexpr (ESZ == 4) {
            v = make_uint4(w[0], w[1], w[2], w[3]);  // s is a whole number of words
        } else {
            const int sh = 8 * (s & 3);
            v.x = __funnelshift_r(w[0], w[1], sh);
            v.y = __funnelshift_r(w[1], w[2], sh);
            v.z = __funnelshift_r(w[2], w[3], sh);
            v.w = __funnelshift_r(w[3], w[4], sh);
        }
        *reinterpret_cast<uint4*>(grow + s) = v;
    }
    const uint8_t* sb = reinterpret_cast<const uint8_t*>(srow);
    const int tail = head + 16 * nb;
    for (int i = ESZ * lane; i < n - tail + head; i += 32 * ESZ) {
        const int e = i < head ? i : tail + (i - head);
        if constexpr (ESZ == 1)
            grow[e] = sb[e];
        else
            *reinterpret_cast<uint32_t*>(grow + e) = *reinterpret_cast<const uint32_t*>(sb + e);
    }
}

// ---------------------------------------------------------------- form 0

constexpr int TVR = 8;     // output rows an H-pass step sums
constexpr int THR = 8;     // output pixels of a W-pass item
constexpr int KCH = 8;     // taps a chunk of the run-time-K sums

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// The shared-memory layout of a tile, in 4-byte words (ops/filters.py
// k5_smem_bytes is its twin): the taps; the window, TH + K - 1 rows of wp
// floats (a row's floats from its 16-byte-aligned start, so up to 3 floats
// of room; the space then stages the outputs, rows of spw words); each
// window row's first float (rofs); the H pass's sums, TH rows of vp floats.
struct TileLayout {
    int kpad, wp, vp, spw, win, rofs, total;
};

__host__ __device__ inline TileLayout tile_layout(int K, int TH, int TW, int esz) {
    TileLayout L;
    L.kpad = (K + 3) & ~3;
    L.wp = ((TW + K - 1) * 3 + 6) & ~3;
    L.vp = ((TW + K - 1) * 3) | 1;                    // odd: a warp's rows in 32 banks
    L.spw = ((TW * 3 * esz + 3) / 4 + 1) | 1;         // a staged output row and a word
    const int win = (TH + K - 1) * L.wp;
    const int stage = TH * L.spw;
    L.win = win > stage ? win : stage;
    L.rofs = (TH + K - 1 + 3) & ~3;
    L.total = L.kpad + L.win + L.rofs + TH * L.vp;
    return L;
}

// One warp copies window row r: floats [0, wf) of `row` (the window's
// first pixel), or with `clamp` the pixels x0 - half + j / 3 clamped to
// [0, W - 1] of the image row `img_row`. Unclamped, the row's 16-byte
// words are copied whole (those that cross `end` float by float) and the
// window's first float sits at its offset within its word; returns the
// window's first float in `win` (written to rofs by lane 0).
__device__ __forceinline__ void stage_row(float* win, int* rofs, int r, int wp, const float* img_row,
                                          int x0, int half, int W, int wf, bool clamp,
                                          const float* end, int lane) {
    float* drow = win + r * wp;
    if (clamp) {
        for (int j = lane; j < wf; j += 32) {
            const int p = j / 3;
            cp_async4(drow + j, img_row + clampi(x0 - half + p, 0, W - 1) * 3 + (j - 3 * p));
        }
        if (lane == 0) rofs[r] = r * wp;
        return;
    }
    const float* first = img_row + (x0 - half) * 3;
    const int sh = (int)(((uintptr_t)first >> 2) & 3);
    const float* g0 = first - sh;
    const int nw = (sh + wf + 3) >> 2;
    for (int q = lane; q < nw; q += 32) {
        const float* gw = g0 + 4 * q;
        if (gw + 4 <= end) {
            cp_async16(drow + 4 * q, gw);
        } else {
            for (int e = 0; e < 4 && gw + e < end; ++e) cp_async4(drow + 4 * q + e, gw + e);
        }
    }
    if (lane == 0) rofs[r] = r * wp + sh;
}

template <int KC, bool UNSHARP, bool U8>
__global__ void __launch_bounds__(THREADS)
tile_kernel(const float* __restrict__ x, float* __restrict__ out_f, uint8_t* __restrict__ out_u8,
            const float* __restrict__ taps, int H, int W, int k_rt, int halo, int TH, int th_shift,
            int TW, int tiles_x, float gain, float thr) {
    const int K = KC > 0 ? KC : k_rt;
    const int half = K / 2;
    constexpr int ESZ = U8 ? 1 : 4;
    const TileLayout L = tile_layout(K, TH, TW, ESZ);
    extern __shared__ __align__(16) float smem[];
    float* w_s = smem;
    float* win = smem + L.kpad;
    int* rofs = reinterpret_cast<int*>(win + L.win);
    float* vs = win + L.win + L.rofs;
    const int VP = L.vp;

    const int ty = blockIdx.x / tiles_x, tx = blockIdx.x - ty * tiles_x;
    const int b = blockIdx.y;
    const int y0 = ty * TH, x0 = tx * TW;
    const int th = min(TH, H - y0), tw = min(TW, W - x0);
    const int H_in = H + 2 * halo;  // input rows a member: its own and the halos
    const float* src = x + (size_t)b * H_in * W * 3;
    const float* end = x + (size_t)gridDim.y * H_in * W * 3;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    for (int k = tid; k < K; k += THREADS) w_s[k] = __ldg(taps + k);
    // the window: input rows y0 + halo - half + r, pixels x0 - half + j / 3;
    // rows past the tile's point into the window's space (never summed into
    // an output)
    const int rows = th + K - 1, wf = (tw + K - 1) * 3;
    const bool clamp = x0 - half < 0 || x0 + tw + half > W;
    for (int r = rows + tid; r < TH + K - 1; r += THREADS) rofs[r] = r * L.wp;
    for (int r = warp; r < rows; r += THREADS / 32)
        stage_row(win, rofs, r, L.wp, src + (size_t)clampi(y0 + halo - half + r, 0, H_in - 1) * W * 3,
                  x0, half, W, wf, clamp, end, lane);
    cp_async_wait_all();
    __syncthreads();

    // H pass: a thread walks one float column j of the window down the
    // tile, 8 output rows a step; compile-time K keeps the K - 1 rows two
    // steps share in registers. Rows past the tile's sum unstaged words
    // into sums that no output reads.
    const int ngr = (th + TVR - 1) / TVR;
    float wr[KC > 0 ? KC : 1];  // compile-time K: the taps in registers
    if constexpr (KC > 0) {
#pragma unroll
        for (int k = 0; k < KC; ++k) wr[k] = w_s[k];
        for (int j = tid; j < wf; j += THREADS) {
            float v[KC - 1 + TVR];
#pragma unroll
            for (int i = 0; i < KC - 1; ++i) v[i] = win[rofs[i] + j];
            for (int g = 0; g < ngr; ++g) {
#pragma unroll
                for (int i = 0; i < TVR; ++i) v[KC - 1 + i] = win[rofs[g * TVR + KC - 1 + i] + j];
                float* dst = vs + g * TVR * VP + j;
#pragma unroll
                for (int r = 0; r < TVR; ++r) {
                    float a = 0.0f;
#pragma unroll
                    for (int k = 0; k < KC; ++k) a = fmaf(wr[k], v[r + k], a);
                    dst[r * VP] = a;
                }
#pragma unroll
                for (int i = 0; i < KC - 1; ++i) v[i] = v[i + TVR];
            }
        }
    } else {
        // run-time K: the taps a chunk of KCH at a time, each chunk's taps
        // and the KCH + TVR - 1 rows it needs in registers; each sum still
        // takes its taps in order (chunks in order, taps in order within)
        for (int j = tid; j < wf; j += THREADS) {
            for (int g = 0; g < ngr; ++g) {
                float acc[TVR];
#pragma unroll
                for (int r = 0; r < TVR; ++r) acc[r] = 0.0f;
                const int* ro = rofs + g * TVR;
                for (int k0 = 0; k0 < K; k0 += KCH) {
                    const int nt = min(KCH, K - k0);  // taps of this chunk
                    float wk[KCH], v[KCH + TVR - 1];
#pragma unroll
                    for (int t = 0; t < KCH; ++t) wk[t] = t < nt ? w_s[k0 + t] : 0.0f;
#pragma unroll
                    for (int i = 0; i < KCH + TVR - 1; ++i)
                        v[i] = i < nt + TVR - 1 ? win[ro[k0 + i] + j] : 0.0f;
#pragma unroll
                    for (int t = 0; t < KCH; ++t)
                        if (t < nt)
#pragma unroll
                            for (int r = 0; r < TVR; ++r) acc[r] = fmaf(wk[t], v[r + t], acc[r]);
                }
                float* dst = vs + g * TVR * VP + j;
#pragma unroll
                for (int r = 0; r < TVR; ++r) dst[r * VP] = acc[r];
            }
        }
    }
    __syncthreads();

    // W pass: a thread's item is row r and output pixels [8q, 8q + 8), its
    // three channels one after another, from the sums' pixels
    // [8q, 8q + 8 + K - 1); consecutive lanes on consecutive rows (TH a
    // power of two, TH * TW / 8 <= THREADS)
    const int ngx = (tw + THR - 1) / THR;
    const int r = tid & (TH - 1), q = tid >> th_shift;
    const bool item = r < th && q < ngx;
    float o[3][THR];
    if (item) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            const float* row = vs + r * VP + q * THR * 3 + c;
            if constexpr (KC > 0) {
                float v[THR + KC - 1];
#pragma unroll
                for (int i = 0; i < THR + KC - 1; ++i) v[i] = row[3 * i];
#pragma unroll
                for (int p = 0; p < THR; ++p) {
                    float a = 0.0f;
#pragma unroll
                    for (int k = 0; k < KC; ++k) a = fmaf(wr[k], v[p + k], a);
                    o[c][p] = a;
                }
            } else {
#pragma unroll
                for (int p = 0; p < THR; ++p) o[c][p] = 0.0f;
                for (int k0 = 0; k0 < K; k0 += KCH) {  // as the H pass, by chunks
                    const int nt = min(KCH, K - k0);
                    float wk[KCH], v[KCH + THR - 1];
#pragma unroll
                    for (int t = 0; t < KCH; ++t) wk[t] = t < nt ? w_s[k0 + t] : 0.0f;
#pragma unroll
                    for (int i = 0; i < KCH + THR - 1; ++i)
                        v[i] = i < nt + THR - 1 ? row[3 * (k0 + i)] : 0.0f;
#pragma unroll
                    for (int t = 0; t < KCH; ++t)
                        if (t < nt)
#pragma unroll
                            for (int p = 0; p < THR; ++p) o[c][p] = fmaf(wk[t], v[p + t], o[c][p]);
                }
            }
            if constexpr (UNSHARP) {
                // x of output (r, 8q + p) is window row r + half, pixel 8q + p + half
                const float* xc = win + rofs[r + half] + (q * THR + half) * 3 + c;
#pragma unroll
                for (int p = 0; p < THR; ++p) {
                    const float xv = xc[3 * p];
                    const float diff = __fsub_rn(xv, o[c][p]);
                    const float amount = __fmul_rn(gain, diff);
                    o[c][p] = __fadd_rn(xv, fabsf(diff) >= thr ? amount : 0.0f);
                }
            }
        }
    }
    __syncthreads();  // the window is read: its space stages the outputs

    // the item's 24 outputs are consecutive in the output row: 6 words (u8)
    // or 24 (f32) at word 6q or 24q of the staged row (an odd word pitch:
    // the lanes' rows fall in distinct banks)
    uint32_t* stage = reinterpret_cast<uint32_t*>(win);
    if (item) {
        uint32_t* srow = stage + r * L.spw + q * 6 * ESZ;
        if constexpr (U8) {
#pragma unroll
            for (int k = 0; k < 6; ++k) {
                uint32_t word = 0;
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    word |= (uint32_t)to_u8(o[(4 * k + e) % 3][(4 * k + e) / 3]) << (8 * e);
                srow[k] = word;
            }
        } else {
#pragma unroll
            for (int j = 0; j < 24; ++j) srow[j] = __float_as_uint(o[j % 3][j / 3]);
        }
    }
    __syncthreads();

    uint8_t* gout = U8 ? out_u8 : reinterpret_cast<uint8_t*>(out_f);
    const size_t pix0 = ((size_t)b * H + y0) * W + x0;  // the tile's first output pixel
    for (int rr = warp; rr < th; rr += THREADS / 32)
        store_row<ESZ>(gout + (pix0 + (size_t)rr * W) * 3 * ESZ, stage + rr * L.spw,
                       tw * 3 * ESZ, lane);
}

template <int KC>
int launch_tile(const float* x, float* out_f, uint8_t* out_u8, const float* taps, int batch,
                int H, int W, int K, int halo, int mode, float gain, float thr, int TH, int TW,
                cudaStream_t s) {
    const bool u8 = out_u8 != nullptr;
    void (*kern)(const float*, float*, uint8_t*, const float*, int, int, int, int, int, int, int,
                 int, float, float);
    if (mode == 1)
        kern = u8 ? tile_kernel<KC, true, true> : tile_kernel<KC, true, false>;
    else
        kern = u8 ? tile_kernel<KC, false, true> : tile_kernel<KC, false, false>;
    const size_t smem = (size_t)tile_layout(K, TH, TW, u8 ? 1 : 4).total * sizeof(float);
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        cudaError_t err =
            cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    int th_shift = 0;
    while ((1 << th_shift) < TH) ++th_shift;
    const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
    kern<<<dim3(tiles_x * tiles_y, batch), THREADS, smem, s>>>(
        x, out_f, out_u8, taps, H, W, K, halo, TH, th_shift, TW, tiles_x, gain, thr);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- form 1

constexpr int VR = 8;    // output rows a thread of the vertical pass owns
constexpr int HX = 256;  // pixels of a horizontal-pass row segment

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

int launch_two_pass(const float* x, float* tmp, float* out_f, uint8_t* out_u8, const float* taps,
                    int batch, int H, int W, int K, int halo, int mode, float gain, float thr,
                    cudaStream_t s) {
    if (tmp == nullptr) return (int)cudaErrorInvalidValue;
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

}  // namespace

// Launch K5 on `stream`: x f32 [batch, H + 2 * halo, W, 3] -> out (exactly
// one of out_f f32 or out_u8 u8, [batch, H, W, 3]); taps f32 [K] on the
// card, K odd. mode 0 = blur, 1 = unsharp with gain and thr (the threshold
// in levels, thr * 255 of the reference). halo = 0 is the whole-image
// filter; the tiled form gives a rank's tile with halo (at most K / 2)
// neighbour rows above and below, and rows are clamped only within x, so
// with halo = K / 2 the H pass reads the supplied rows as they are.
// form 0 is the 2-D tile form (tile_h x tile_w output pixels a block:
// tile_h a power of two from 8 to 32, tile_w a multiple of 8,
// tile_h * tile_w <= 2048; tmp unused), form 1 the two
// passes through tmp f32 [batch, H, W, 3]. Returns cudaGetLastError()
// after the launches.
extern "C" int flyimg_separable(const float* x, float* tmp, float* out_f, uint8_t* out_u8,
                                const float* taps, int batch, int H, int W, int K, int halo,
                                int mode, float gain, float thr, int form, int tile_h,
                                int tile_w, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (batch <= 0 || H <= 0 || W <= 0 || K <= 0 || K % 2 == 0 || (mode != 0 && mode != 1) ||
        (out_f == nullptr) == (out_u8 == nullptr) || batch > 65535 || halo < 0 || halo > K / 2)
        return (int)cudaErrorInvalidValue;
    if (form == 1)
        return launch_two_pass(x, tmp, out_f, out_u8, taps, batch, H, W, K, halo, mode, gain,
                               thr, s);
    if (form != 0 || tile_h < TVR || tile_h > 32 || (tile_h & (tile_h - 1)) || tile_w <= 0 ||
        tile_w % THR || tile_h * tile_w / THR > THREADS)
        return (int)cudaErrorInvalidValue;
    switch (K) {
        case 3:
            return launch_tile<3>(x, out_f, out_u8, taps, batch, H, W, K, halo, mode, gain, thr,
                                  tile_h, tile_w, s);
        case 5:
            return launch_tile<5>(x, out_f, out_u8, taps, batch, H, W, K, halo, mode, gain, thr,
                                  tile_h, tile_w, s);
        case 13:
            return launch_tile<13>(x, out_f, out_u8, taps, batch, H, W, K, halo, mode, gain, thr,
                                   tile_h, tile_w, s);
        default:
            return launch_tile<0>(x, out_f, out_u8, taps, batch, H, W, K, halo, mode, gain, thr,
                                  tile_h, tile_w, s);
    }
}
