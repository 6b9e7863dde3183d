"""Plain PyTorch versions of the JPEG encoder's two kernels, and the
sample planes each one is fed.

- ``trellis_plain`` is kernel K16 (``csrc/jpeg_trellis.cu``): the JAX
  package's ``fc_jpeg_encode_trellis`` up to its coefficients (f32 JFIF
  colour conversion, chroma box mean, edge-replicated blocks, the float
  8x8 DCT, DC rounding and the rate-distortion trellis over each block's
  AC run), every float operation in the C++ code's order: no ``sum``,
  ``matmul`` or fused multiply-add, each product and sum its own op.
- ``fdct_islow_plain`` is kernel K17 (``csrc/jpeg_fdct.cu``): libjpeg's
  integer "islow" FDCT (``jfdctint.c``) and libjpeg-turbo's reciprocal
  quantization (``jcdctmgr.c``) over u8 planes laid out on the block grid
  as libjpeg's preprocessing leaves them (``grid_planes``,
  ``cmyk_grid_planes``).

Both give int16 coefficients [blocks, 64] in zigzag order, a
component's blocks row-major; ``jpeg_enc`` runs them on a CPU tensor and
the kernels on a CUDA one.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import torch

from flyimg_tpu_torch.codecs import jpeg_tables

def ycc_factors(sampling: Tuple[int, int]) -> List[Tuple[int, int]]:
    """Per-component (h, v) of a YCbCr encode with luma factors
    ``sampling`` (chroma 1x1, as the JAX package's encoders set them)."""
    return [(int(sampling[0]), int(sampling[1])), (1, 1), (1, 1)]


def component_blocks(width: int, height: int,
                     factors: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """libjpeg's (width_in_blocks, height_in_blocks) of each component."""
    hmax = max(f[0] for f in factors)
    vmax = max(f[1] for f in factors)
    return [(-(-width * h // (hmax * 8)), -(-height * v // (vmax * 8))) for h, v in factors]


def _f32(value: float, device=None) -> torch.Tensor:
    """A float32 constant on ``device`` (a 0-dim tensor: products and sums
    with it round as float32 ops; on a card a division by it is a true
    division, not a multiply by a host scalar's reciprocal)."""
    return torch.tensor(value, dtype=torch.float32, device=device)


def _replicate(plane: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``plane`` read at [0, rows) x [0, cols), edges replicated."""
    h, w = plane.shape
    ri = torch.arange(rows, device=plane.device).clamp_max(h - 1)
    ci = torch.arange(cols, device=plane.device).clamp_max(w - 1)
    return plane[ri][:, ci]


def _blocks(plane: torch.Tensor, bw: int, bh: int) -> torch.Tensor:
    """[bh * 8, bw * 8] -> [bh * bw, 8, 8], row-major blocks."""
    return plane.reshape(bh, 8, bw, 8).permute(0, 2, 1, 3).reshape(bh * bw, 8, 8)


def _to_zigzag(natural: torch.Tensor) -> torch.Tensor:
    return natural[:, list(jpeg_tables.ZIGZAG)]


# ---------------------------------------------------------------------------
# K16: the trellis encoder's coefficients
# ---------------------------------------------------------------------------


def trellis_planes(rgb: torch.Tensor, sampling: Tuple[int, int]) -> List[torch.Tensor]:
    """The JAX trellis encoder's f32 planes of a [H, W, 3] u8 image: Y at
    full size; Cb and Cr at ceil(W / h) x ceil(H / v), each the mean of
    the in-bounds samples of its h x v box (plain f32 adds in row order,
    then one division by the count)."""
    x = rgb.to(torch.float32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]

    def c(v):
        return _f32(v, x.device)

    y = (c(0.299) * r + c(0.587) * g) + c(0.114) * b
    cb = ((c(-0.168735892) * r - c(0.331264108) * g) + c(0.5) * b) + c(128.0)
    cr = ((c(0.5) * r - c(0.418687589) * g) - c(0.081312411) * b) + c(128.0)
    hf, vf = int(sampling[0]), int(sampling[1])
    if (hf, vf) == (1, 1):
        return [y, cb, cr]
    h, w = y.shape
    ch, cw = -(-h // vf), -(-w // hf)
    out = []
    for full in (cb, cr):
        acc = torch.zeros((ch, cw), dtype=torch.float32, device=x.device)
        cnt = torch.zeros((ch, cw), dtype=torch.float32, device=x.device)
        for dy in range(vf):
            for dx in range(hf):
                sy = torch.arange(ch, device=x.device) * vf + dy
                sx = torch.arange(cw, device=x.device) * hf + dx
                inside = (sy < h)[:, None] & (sx < w)[None, :]
                val = full[sy.clamp_max(h - 1)][:, sx.clamp_max(w - 1)]
                acc = torch.where(inside, acc + val, acc)
                cnt = cnt + inside.to(torch.float32)
        out.append(acc / cnt)
    return [y, *out]


def fdct8x8_plain(blocks: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """The JAX encoder's separable f32 DCT of [B, 8, 8] samples (rows: sum
    over x of in[y][x] * cos[u][x]; then columns), [B, 64] natural order."""
    tmp = blocks[:, :, 0:1] * cos[:, 0]                 # [B, y, u]
    for x in range(1, 8):
        tmp = tmp + blocks[:, :, x:x + 1] * cos[:, x]
    out = tmp[:, 0:1, :] * cos[:, 0][:, None]           # [B, v, u]
    for y in range(1, 8):
        out = out + tmp[:, y:y + 1, :] * cos[:, y][:, None]
    return out.reshape(-1, 64)


def _bit_size(v: torch.Tensor) -> torch.Tensor:
    size = torch.zeros_like(v)
    for bit in range(11):
        size = torch.where(v >= (1 << bit), bit + 1, size)
    return size


def trellis_ac_plain(cz: torch.Tensor, q: torch.Tensor, lrate: torch.Tensor,
                     lzrl: torch.Tensor, leob: torch.Tensor) -> torch.Tensor:
    """The JAX encoder's ``trellis_ac`` over [B, 64] zigzag f32
    coefficients: the exact dynamic program over the last-nonzero
    position, candidates round(|c| / q) and one less, a run's rate from
    ``lrate`` [11, 16] and ZRL escapes folded by residue. Returns int32
    [B, 64] (zigzag; position 0 left 0)."""
    nb = cz.shape[0]
    dev = cz.device
    big, half, limit, zero = (_f32(v, dev) for v in (1e30, 0.5, 1e29, 0.0))
    prefix = [torch.zeros(nb, dtype=torch.float32, device=dev)] * 2   # prefix[0], [1]
    for k in range(1, 64):
        prefix.append(prefix[k] + cz[:, k] * cz[:, k])
    w = [torch.zeros(nb, dtype=torch.float32, device=dev)]
    wj = [torch.zeros(nb, dtype=torch.int64, device=dev)]
    best, prev_nz, chosen = [None], [None], [None]
    rows = torch.arange(nb, device=dev)
    for k in range(1, 64):
        a = cz[:, k].abs()
        qk = q[k]
        v0 = (a / qk + half).to(torch.int64).clamp_max(1023)
        mmax = min(k - 1, 15)
        wk = torch.stack(w[k - 1 - mmax:k][::-1], 1)     # [B, m]: w[k - 1 - m]
        wjk = torch.stack(wj[k - 1 - mmax:k][::-1], 1)
        bk = torch.full((nb,), 1e30, dtype=torch.float32, device=dev)
        pk = torch.zeros(nb, dtype=torch.int64, device=dev)
        ck = torch.zeros(nb, dtype=torch.int64, device=dev)
        for dv in (0, 1):
            v = v0 - dv
            ok = v >= 1
            if not bool(ok.any()):
                break
            size = _bit_size(v.clamp_min(0))
            d = a - v.to(torch.float32) * qk
            fixed = d * d + prefix[k]
            rates = lrate[size.clamp_min(1)][:, :mmax + 1]   # [B, m]
            cands = wk + rates
            bm = torch.argmin(cands, 1)                       # the first minimum
            bc = cands[rows, bm]
            cost = fixed + bc
            better = ok & (cost < bk)
            bk = torch.where(better, cost, bk)
            pk = torch.where(better, wjk[rows, bm], pk)
            ck = torch.where(better, v, ck)
        best.append(bk)
        prev_nz.append(pk)
        chosen.append(ck)
        g = torch.where(bk < limit, bk - prefix[k + 1], big)
        if k >= 16:
            z = w[k - 16] + lzrl
            take = z < g
            w.append(torch.where(take, z, g))
            wj.append(torch.where(take, wj[k - 16], torch.full_like(pk, k)))
        else:
            w.append(g)
            wj.append(torch.full_like(pk, k))
    total = prefix[64] + leob
    last = torch.zeros(nb, dtype=torch.int64, device=dev)
    for k in range(1, 64):
        tail = prefix[64] - prefix[k + 1]
        cost = (best[k] + tail) + (leob if k < 63 else zero)
        better = (best[k] < limit) & (cost < total)
        total = torch.where(better, cost, total)
        last = torch.where(better, k, last)
    prev_t = torch.stack([torch.zeros_like(last)] + prev_nz[1:], 1)
    chosen_t = torch.stack([torch.zeros_like(last)] + chosen[1:], 1)
    out = torch.zeros((nb, 64), dtype=torch.int64, device=dev)
    cur = last
    for _ in range(63):
        live = cur > 0
        if not bool(live.any()):
            break
        val = chosen_t[rows, cur]
        val = torch.where(cz[rows, cur] < 0, -val, val)
        out[rows[live], cur[live]] = val[live]
        cur = torch.where(live, prev_t[rows, cur], cur)
    return out.to(torch.int32)


def trellis_plain(rgb: torch.Tensor, quality: int,
                  sampling: Tuple[int, int]) -> torch.Tensor:
    """K16's plain version: a [H, W, 3] u8 image -> int16 [blocks, 64]
    trellis-quantized coefficients (zigzag; Y's blocks, then Cb's, then
    Cr's, each component's width_in_blocks x height_in_blocks, row-major)."""
    h, w = rgb.shape[:2]
    params = jpeg_tables.trellis_params(quality)
    cos = torch.tensor(params["cos"], device=rgb.device)
    dims = component_blocks(w, h, ycc_factors(sampling))
    dev = rgb.device
    half = _f32(0.5, dev)
    out = []
    for c, plane in enumerate(trellis_planes(rgb, sampling)):
        t = 0 if c == 0 else 1
        bw, bh = dims[c]
        samples = _replicate(plane, bh * 8, bw * 8) - _f32(128.0, dev)
        cz = _to_zigzag(fdct8x8_plain(_blocks(samples, bw, bh), cos))
        q = torch.tensor(params["q"][t], device=dev)
        dc = cz[:, 0] / q[0]
        dc = torch.where(dc < 0, dc - half, dc + half).to(torch.int32)
        coef = trellis_ac_plain(
            cz, q, torch.tensor(params["lrate"][t], device=dev),
            _f32(float(params["lzrl"][t]), dev), _f32(float(params["leob"][t]), dev))
        coef[:, 0] = dc
        out.append(coef)
    return torch.cat(out).to(torch.int16)


# ---------------------------------------------------------------------------
# K17: libjpeg's islow FDCT and quantization
# ---------------------------------------------------------------------------


def _ycc_fixed(x: torch.Tensor):
    """jccolor.c's rgb_ycc_convert (16-bit fixed point) of int32 [H, W, 3]."""
    def fix(v: float) -> int:
        return int(v * 65536 + 0.5)

    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    half, offset = 1 << 15, 128 << 16
    y = (fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + offset + half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + offset + half - 1) >> 16
    return y, cb, cr


def downsample(plane: torch.Tensor, factors: Tuple[int, int], cols: int) -> torch.Tensor:
    """jcsample.c's downsampling of a full-size int32 plane by (h, v):
    the input's right edge replicated out to ``cols`` output columns and
    its bottom to whole row groups, then h2v1 and h2v2 with their
    alternating rounding biases (0, 1 / 1, 2), other factors
    int_downsample's rounded mean."""
    hf, vf = factors
    h, _w = plane.shape
    rows = -(-h // vf)
    full = _replicate(plane, rows * vf, cols * hf)
    sums = full.reshape(rows, vf, cols, hf).sum((1, 3))
    odd = torch.arange(cols, device=plane.device) % 2
    n = hf * vf
    if (hf, vf) == (2, 1):
        bias = odd
    elif (hf, vf) == (2, 2):
        bias = 1 + odd
    else:
        bias = torch.full_like(odd, n // 2)
    return (sums + bias) // n


def grid_planes(rgb: torch.Tensor, sampling: Tuple[int, int]) -> List[torch.Tensor]:
    """libjpeg's Y, Cb, Cr u8 planes of a [H, W, 3] u8 image, each laid out
    on its component's block grid [height_in_blocks * 8, width_in_blocks *
    8] as jcprepct.c and jcsample.c leave them: the colour-converted rows
    replicated right and down, the chroma downsampled from them, then its
    last row replicated down to the grid."""
    h, w = rgb.shape[:2]
    y, cb, cr = _ycc_fixed(rgb.to(torch.int32))
    factors = ycc_factors(sampling)
    dims = component_blocks(w, h, factors)
    out = [_replicate(y, dims[0][1] * 8, dims[0][0] * 8)]
    hf, vf = factors[0]
    for c, plane in ((1, cb), (2, cr)):
        bw, bh = dims[c]
        if (hf, vf) != (1, 1):
            plane = downsample(plane, (hf, vf), bw * 8)
        out.append(_replicate(plane, bh * 8, bw * 8))
    return [p.to(torch.uint8).contiguous() for p in out]


def cmyk_samples(rgb: torch.Tensor) -> torch.Tensor:
    """The JAX handler's ``_encode_cmyk_jpeg`` samples of a [H, W, 3] u8
    image: ImageMagick's black extraction in f32 (K = min(C, M, Y), the
    rest rescaled by 1 - K), rounded to u8, then inverted as Pillow's
    ``CMYK;I`` raw mode stores them. [H, W, 4] u8."""
    dev = rgb.device
    one = _f32(1.0, dev)
    f = rgb.to(torch.float32) / _f32(255.0, dev)
    cmy = one - f
    k = cmy.amin(2, keepdim=True)
    denom = torch.where(k < one, one - k, one)
    cmyk = torch.cat([(cmy - k) / denom, k], 2)
    u8 = (cmyk * _f32(255.0, dev) + _f32(0.5, dev)).clamp(0, 255)
    return 255 - u8.to(torch.uint8)


def cmyk_grid_planes(rgb: torch.Tensor) -> List[torch.Tensor]:
    """``cmyk_samples``'s four planes on the block grid (no subsampling;
    edges replicated)."""
    h, w = rgb.shape[:2]
    samples = cmyk_samples(rgb)
    bw, bh = -(-w // 8), -(-h // 8)
    return [_replicate(samples[..., c], bh * 8, bw * 8).contiguous() for c in range(4)]


@functools.lru_cache(maxsize=None)
def divisor_rows(qtable: Tuple[int, ...]) -> Tuple[Tuple[int, ...], ...]:
    """libjpeg-turbo's ``compute_reciprocal`` of each divisor q * 8 of a
    natural-order table (the islow FDCT's outputs are scaled by 8): the
    rows reciprocal, correction (rounding), shift. A coefficient t
    quantizes to sign(t) * (((|t| + corr) * recip) >> shift)."""
    rows = ([], [], [])
    for q in qtable:
        divisor = int(q) << 3
        r = 16 + divisor.bit_length() - 1
        fq, fr = divmod(1 << r, divisor)
        c = divisor // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= divisor // 2:
            c += 1
        else:
            fq += 1
        for row, v in zip(rows, (fq, c, r)):
            row.append(v)
    return tuple(tuple(row) for row in rows)


def quant_divisors(qtable: Sequence[int]) -> torch.Tensor:
    """``divisor_rows`` as an int64 [3, 64] tensor."""
    return torch.tensor(divisor_rows(tuple(int(q) for q in qtable)), dtype=torch.int64)


def _islow_pass(d: List[torch.Tensor], final: bool) -> List[torch.Tensor]:
    """One pass of jfdctint.c's jpeg_fdct_islow over 8 int64 lanes (a row
    or a column of every block)."""
    const_bits, pass1_bits = 13, 2

    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    if final:
        out[0] = descale(tmp10 + tmp11, pass1_bits)
        out[4] = descale(tmp10 - tmp11, pass1_bits)
        shift = const_bits + pass1_bits
    else:
        out[0] = (tmp10 + tmp11) << pass1_bits
        out[4] = (tmp10 - tmp11) << pass1_bits
        shift = const_bits - pass1_bits
    z1 = (tmp12 + tmp13) * 4433
    out[2] = descale(z1 + tmp13 * 6270, shift)
    out[6] = descale(z1 + tmp12 * -15137, shift)
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * 9633
    tmp4, tmp5, tmp6, tmp7 = tmp4 * 2446, tmp5 * 16819, tmp6 * 25172, tmp7 * 12299
    z1, z2, z3, z4 = z1 * -7373, z2 * -20995, z3 * -16069, z4 * -3196
    z3, z4 = z3 + z5, z4 + z5
    out[7] = descale(tmp4 + z1 + z3, shift)
    out[5] = descale(tmp5 + z2 + z4, shift)
    out[3] = descale(tmp6 + z2 + z3, shift)
    out[1] = descale(tmp7 + z1 + z4, shift)
    return out


def fdct_islow_plain(plane: torch.Tensor, qtable: Sequence[int]) -> torch.Tensor:
    """K17's plain version: a u8 plane on its block grid [bh * 8, bw * 8]
    -> int16 [bh * bw, 64] quantized coefficients in zigzag order
    (``qtable`` in natural order)."""
    rows, cols = plane.shape
    blocks = _blocks(plane.to(torch.int64) - 128, cols // 8, rows // 8)
    lanes = _islow_pass([blocks[:, :, x] for x in range(8)], final=False)  # [B, y] each
    data = torch.stack(lanes, 2)                                            # [B, y, u]
    cols_out = _islow_pass([data[:, y, :] for y in range(8)], final=True)  # [B, u] each
    coef = torch.stack(cols_out, 1).reshape(-1, 64)                         # [B, v, u]
    div = quant_divisors(qtable).to(plane.device)
    mag = ((coef.abs() + div[1]) * div[0]) >> div[2]
    return _to_zigzag(torch.where(coef < 0, -mag, mag)).to(torch.int16)
