"""Plain PyTorch versions of the JPEG decoder's kernels K18 and K19.

What ``csrc/jpeg_idct.cu`` (K18) and ``csrc/jpeg_color.cu`` (K19) compute,
on any device, in integer torch code with the same tables in and the same
bytes out: the CPU route of ``codecs/jpeg_dec.py`` and the yardstick the
card's kernels are held to (max difference 0). Both repeat libjpeg-turbo:

- K18, dequantization and the inverse DCT of every block a segment table
  names: ``jpeg_idct_islow`` (jidctint.c) for 8x8 output and
  ``jpeg_idct_4x4``, ``jpeg_idct_2x2``, ``jpeg_idct_1x1`` (jidctred.c) for
  the reduced sizes, each its own integer transform, in the lanes of the
  library's x86-64 SIMD versions where it has them (8x8, 4x4, 2x2) and
  with the C range-limit table's wrap at 1x1 (``idct_blocks`` says
  where the two differ: only on extreme coefficients of damaged files);
- K19, upsampling and colour conversion of each member's window to
  interleaved RGB: jdsample.c's fancy ``h2v1``, ``h1v2`` and ``h2v2``
  (alternating rounding biases, edge columns and rows replicated) or
  replication for the other ratios, jdcolor.c's ``ycc_rgb_convert``
  fixed-point tables, gray repeated, RGB passed through, YCCK to CMYK,
  and the JAX package's CMYK fold (``fastcodec.cpp``: ``c * k / 255``
  where the file is Adobe-inverted or YCCK, else on the inverted inks).

The tables are ``jpeg_dec.SEG_*`` (a row a segment: one component window
of one member, whose blocks K18 transforms into its own plane) and
``jpeg_dec.MEM_*`` (a row a member: its window, colour space and each
component's plane and upsampling method).
"""

from __future__ import annotations

import numpy as np
import torch

# segment table columns (int64; codecs/jpeg_dec.py build_tables, and idct_tiles
# cuts K18's tiles from it)
SEG_COEF, SEG_GRID_W, SEG_BX0, SEG_BY0, SEG_NBX, SEG_NBY, SEG_SCALE, SEG_QT, \
    SEG_OUT, SEG_PITCH, SEG_FIRST, SEG_PAD = range(12)
SEG_FIELDS = 12

# member table columns (csrc/jpeg_color.cu K19Member; int64): 8 of the
# member, then 8 a component
MEM_OUT, MEM_W, MEM_H, MEM_Y0, MEM_COLOR, MEM_INVERTED, MEM_NCOMP, MEM_FIRST = range(8)
COMP_PLANE, COMP_PITCH, COMP_ROW0, COMP_DW, COMP_DH, COMP_METHOD, COMP_HX, COMP_VX = range(8)
MEM_FIELDS = 8 + 4 * 8

# upsampling methods
UP_FULL, UP_H2V1, UP_H1V2, UP_H2V2, UP_REPLICATE = range(5)
# colour spaces (libjpeg's jpeg_color_space, as jpeg_reader.cpp reports it)
CS_GRAY, CS_YCC, CS_RGB, CS_CMYK, CS_YCCK = range(5)

CONST_BITS, PASS1_BITS = 13, 2
RANGE_MASK = 1023


def _fix13(x: float) -> int:
    return int(x * (1 << CONST_BITS) + 0.5)


F_0_211 = _fix13(0.211164243)
F_0_298 = _fix13(0.298631336)
F_0_390 = _fix13(0.390180644)
F_0_509 = _fix13(0.509795579)
F_0_541 = _fix13(0.541196100)
F_0_601 = _fix13(0.601344887)
F_0_720 = _fix13(0.720959822)
F_0_765 = _fix13(0.765366865)
F_0_850 = _fix13(0.850430095)
F_0_899 = _fix13(0.899976223)
F_1_061 = _fix13(1.061594337)
F_1_175 = _fix13(1.175875602)
F_1_272 = _fix13(1.272758580)
F_1_451 = _fix13(1.451774981)
F_1_501 = _fix13(1.501321110)
F_1_847 = _fix13(1.847759065)
F_1_961 = _fix13(1.961570560)
F_2_053 = _fix13(2.053119869)
F_2_172 = _fix13(2.172734803)
F_2_562 = _fix13(2.562915447)
F_3_072 = _fix13(3.072711026)
F_3_624 = _fix13(3.624509785)


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _i32(x):
    """The low 32 bits, signed (a 32-bit lane's wrap)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def range_limit(x):
    """``IDCT_range_limit(cinfo)[x & RANGE_MASK]`` (jdmaster.c
    prepare_range_limit_table): 0..127 -> 128..255, 128..511 -> 255,
    512..895 -> 0, 896..1023 -> 0..127."""
    y = x & RANGE_MASK
    return torch.where(y < 128, y + 128, torch.where(
        y < 512, torch.full_like(y, 255), torch.where(y < 896, torch.zeros_like(y), y - 896)))


def _w16(x):
    """The low 16 bits, signed (a 16-bit lane's wrap)."""
    return ((x + 32768) & 0xFFFF) - 32768


def _s16(x):
    """Signed saturation to 16 bits (packssdw)."""
    return x.clamp(-32768, 32767)


def _islow_1d(c, n: int):
    """One pass of the islow IDCT over the last axis (8 inputs in natural
    index order, 16-bit values), as libjpeg-turbo's SIMD code computes it
    (jidctint-avx2.asm): the sums in0 +- in4, in7 + in3 and in5 + in1 in
    16-bit lanes, every product and the rest in 32-bit lanes, the outputs
    descaled by ``n`` bits and saturated to 16 bits."""
    in0, in1, in2, in3 = c[..., 0], c[..., 1], c[..., 2], c[..., 3]
    in4, in5, in6, in7 = c[..., 4], c[..., 5], c[..., 6], c[..., 7]
    tmp3 = _i32(in2 * (F_0_541 + F_0_765) + in6 * F_0_541)
    tmp2 = _i32(in2 * F_0_541 + in6 * (F_0_541 - F_1_847))
    tmp0 = _w16(in0 + in4) << CONST_BITS
    tmp1 = _w16(in0 - in4) << CONST_BITS
    tmp10, tmp13 = _i32(tmp0 + tmp3), _i32(tmp0 - tmp3)
    tmp11, tmp12 = _i32(tmp1 + tmp2), _i32(tmp1 - tmp2)
    z3 = _w16(in7 + in3)
    z4 = _w16(in5 + in1)
    z3p = _i32(z3 * (F_1_175 - F_1_961) + z4 * F_1_175)
    z4p = _i32(z3 * F_1_175 + z4 * (F_1_175 - F_0_390))
    t0 = _i32(_i32(in7 * (F_0_298 - F_0_899) + in1 * -F_0_899) + z3p)
    t3 = _i32(_i32(in7 * -F_0_899 + in1 * (F_1_501 - F_0_899)) + z4p)
    t1 = _i32(_i32(in5 * (F_2_053 - F_2_562) + in3 * -F_2_562) + z4p)
    t2 = _i32(_i32(in5 * -F_2_562 + in3 * (F_3_072 - F_2_562)) + z3p)
    outs = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
    return torch.stack([_s16(_i32(_i32(v) + (1 << (n - 1))) >> n) for v in outs], -1)


def _red4_1d(c, n: int):
    """One pass of the 4x4 reduced IDCT (jidctred-sse2.asm) -> 4 outputs."""
    tmp0 = c[..., 0] << (CONST_BITS + 1)
    tmp2 = _i32(c[..., 2] * F_1_847 + c[..., 6] * -F_0_765)
    tmp10, tmp12 = _i32(tmp0 + tmp2), _i32(tmp0 - tmp2)
    z1, z2, z3, z4 = c[..., 7], c[..., 5], c[..., 3], c[..., 1]
    t0 = _i32(_i32(z4 * F_1_061 + z3 * -F_2_172) + _i32(z2 * F_1_451 + z1 * -F_0_211))
    t2 = _i32(_i32(z4 * F_2_562 + z3 * F_0_899) + _i32(z2 * -F_0_601 + z1 * -F_0_509))
    return torch.stack([_s16(_i32(_i32(v) + (1 << (n - 1))) >> n) for v in
                        (tmp10 + t2, tmp12 + t0, tmp12 - t0, tmp10 - t2)], -1)


def _red2_1d(c, n: int):
    """One pass of the 2x2 reduced IDCT (jidctred-sse2.asm) -> 2 outputs,
    in 32 bits (``idct_blocks`` saturates pass 1's odd columns)."""
    tmp10 = c[..., 0] << (CONST_BITS + 2)
    t0 = _i32(_i32(c[..., 1] * F_3_624 + c[..., 3] * -F_1_272)
              + _i32(c[..., 5] * F_0_850 + c[..., 7] * -F_0_720))
    return torch.stack([_i32(_i32(v) + (1 << (n - 1))) >> n
                        for v in (tmp10 + t0, tmp10 - t0)], -1)


#: each size's pass, its descale bits (pass 1, pass 2) and the AC rows
#: whose all-zero test takes the DC shortcut in pass 1 (None: no test)
_PASSES = {
    8: (_islow_1d, CONST_BITS - PASS1_BITS, CONST_BITS + PASS1_BITS + 3, (1, 2, 3, 4, 5, 6, 7)),
    4: (_red4_1d, CONST_BITS - PASS1_BITS + 1, CONST_BITS + PASS1_BITS + 3 + 1,
        (1, 2, 3, 5, 6, 7)),
    2: (_red2_1d, CONST_BITS - PASS1_BITS + 2, CONST_BITS + PASS1_BITS + 3 + 2, None),
}


def idct_blocks(blocks, quant, scale: int):
    """[n, 64] int16 coefficients (natural order) and [n, 64] quantization
    values -> [n, scale, scale] uint8 samples, as libjpeg-turbo computes
    that output size on an x86-64 host. 1x1 is its C ``jpeg_idct_1x1``:
    the DC dequantized in int, descaled, through the range-limit table
    (``x & RANGE_MASK`` wraps). 8x8, 4x4 and 2x2 are its SIMD versions of
    jidctint.c and jidctred.c, the same integer transforms in 16- and
    32-bit lanes: dequantization keeps the low 16 bits of each product, a
    block whose AC rows (all but row 4 at 4x4) are zero takes the DC
    shifted in 16 bits through pass 1, each pass's outputs saturate to 16
    bits (but for the 2x2 pass 1's column 0, kept in 32 bits and shifted in
    a 32-bit lane by pass 2), and the samples to -128..127 before +128 (so an
    extreme value
    saturates where the C table would wrap; the two agree on every value
    a valid file gives)."""
    q = quant.to(torch.int64)
    q = _w16(q)                                  # ISLOW_MULT_TYPE is short
    co = blocks.to(torch.int64).reshape(-1, 8, 8)  # [n, row v, column u]
    if scale == 1:
        z = co[:, 0, 0] * q.reshape(-1, 64)[:, 0]
        return range_limit(_descale(z, 3)).reshape(-1, 1, 1).to(torch.uint8)
    one, n1, n2, ac_rows = _PASSES[scale]
    z = _w16(co * q.reshape(-1, 8, 8))
    # pass 1: each column (inputs down the rows) -> workspace rows
    ws = one(z.transpose(1, 2), n1).transpose(1, 2)      # [n, out row, column u]
    if scale == 2:
        # the SIMD 2x2 packs the odd columns to words for pass 2's
        # multiplies and keeps column 0, which pass 2 only shifts, in 32 bits
        ws = torch.cat([ws[..., :1], _s16(ws[..., 1:])], -1)
    if ac_rows is not None:
        dc_only = (co[:, list(ac_rows), :] == 0).flatten(1).all(1)
        dc = _w16(z[:, 0, :] << PASS1_BITS)[:, None, :].expand(-1, scale, -1)
        ws = torch.where(dc_only[:, None, None], dc, ws)
    # pass 2: each workspace row -> the output row
    out = one(ws, n2)
    return (out.clamp(-128, 127) + 128).to(torch.uint8)


def k18(coefs, quant, segments, plane_bytes: int):
    """K18's plain version: ``coefs`` int16 [total blocks * 64], ``quant``
    int32 [tables * 64], ``segments`` int64 [n, SEG_FIELDS] -> uint8
    [plane_bytes], every segment's blocks transformed into its plane."""
    dev = coefs.device
    out = torch.zeros(plane_bytes, dtype=torch.uint8, device=dev)
    seg = segments.cpu().numpy().astype(np.int64)
    if len(seg) == 0:
        return out
    coefs = coefs.reshape(-1, 64)
    quant = quant.reshape(-1, 64)
    for scale in (1, 2, 4, 8):
        rows = seg[seg[:, SEG_SCALE] == scale]
        if len(rows) == 0:
            continue
        src, qidx, dst = [], [], []
        for r in rows:
            by, bx = np.meshgrid(np.arange(r[SEG_NBY]), np.arange(r[SEG_NBX]), indexing="ij")
            by, bx = by.ravel(), bx.ravel()
            src.append(r[SEG_COEF] + (r[SEG_BY0] + by) * r[SEG_GRID_W] + r[SEG_BX0] + bx)
            qidx.append(np.full(by.shape, r[SEG_QT]))
            # the first sample of each block in the plane
            dst.append(r[SEG_OUT] + by * scale * r[SEG_PITCH] + bx * scale)
            pitch = r[SEG_PITCH]
            dst[-1] = np.stack([dst[-1], np.full(by.shape, pitch)], 1)
        src = torch.from_numpy(np.concatenate(src)).to(dev)
        qidx = torch.from_numpy(np.concatenate(qidx)).to(dev)
        dst = np.concatenate(dst)
        samples = idct_blocks(coefs[src], quant[qidx], scale)   # [n, s, s]
        ii, jj = np.meshgrid(np.arange(scale), np.arange(scale), indexing="ij")
        pos = dst[:, :1] + ii.ravel()[None] * dst[:, 1:] + jj.ravel()[None]
        out[torch.from_numpy(pos.ravel()).to(dev)] = samples.reshape(-1)
    return out


def _fix16(x: float) -> int:
    return int(x * 65536 + 0.5)


def ycc_tables(device="cpu"):
    """jdcolor.c build_ycc_rgb_table: Cr->R, Cb->B (rounded), Cr->G and
    Cb->G (scaled by 2^16, ONE_HALF folded into Cb->G), indexed 0..255."""
    x = torch.arange(256, dtype=torch.int64, device=device) - 128
    cr_r = (_fix16(1.40200) * x + (1 << 15)) >> 16
    cb_b = (_fix16(1.77200) * x + (1 << 15)) >> 16
    cr_g = -_fix16(0.71414) * x
    cb_g = -_fix16(0.34414) * x + (1 << 15)
    return cr_r, cb_b, cr_g, cb_g


def _component(planes, mem, c: int, xs, ys):
    """Member ``mem``'s component ``c`` upsampled at window pixels (xs, ys)
    (int64 tensors; ys in frame rows)."""
    base = 8 + 8 * c
    off, pitch, row0, dw, dh, method, hx, vx = (int(mem[base + k]) for k in range(8))

    def at(r, col):
        return planes[off + (r - row0) * pitch + col].to(torch.int64)

    if method == UP_FULL:
        return at(ys, xs)
    if method == UP_REPLICATE:
        return at(ys // vx, xs // hx)
    if method == UP_H2V1:
        inc = xs >> 1
        odd = (xs & 1) == 1
        nb = torch.where(odd, torch.clamp(inc + 1, max=dw - 1), torch.clamp(inc - 1, min=0))
        return (3 * at(ys, inc) + at(ys, nb) + torch.where(odd, 2, 1)) >> 2
    inr = ys >> 1
    below = (ys & 1) == 1
    far = torch.where(below, torch.clamp(inr + 1, max=dh - 1), torch.clamp(inr - 1, min=0))
    if method == UP_H1V2:
        return (3 * at(inr, xs) + at(far, xs) + torch.where(below, 2, 1)) >> 2
    # UP_H2V2
    inc = xs >> 1
    odd = (xs & 1) == 1
    nb = torch.where(odd, torch.clamp(inc + 1, max=dw - 1), torch.clamp(inc - 1, min=0))

    def colsum(col):
        return 3 * at(inr, col) + at(far, col)

    return (3 * colsum(inc) + colsum(nb) + torch.where(odd, 7, 8)) >> 4


def k19(planes, members, out_bytes: int):
    """K19's plain version: ``planes`` uint8 (K18's output), ``members``
    int64 [n, MEM_FIELDS] -> uint8 [out_bytes], each member's window as
    interleaved RGB at its offset."""
    dev = planes.device
    out = torch.zeros(out_bytes, dtype=torch.uint8, device=dev)
    cr_r, cb_b, cr_g, cb_g = ycc_tables(dev)
    for mem in members.cpu().numpy().astype(np.int64):
        w, h = int(mem[MEM_W]), int(mem[MEM_H])
        if w == 0 or h == 0:
            continue
        ys, xs = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.int64),
                                torch.arange(w, device=dev, dtype=torch.int64), indexing="ij")
        ys = ys.reshape(-1) + int(mem[MEM_Y0])
        xs = xs.reshape(-1)
        comps = [_component(planes, mem, c, xs, ys) for c in range(int(mem[MEM_NCOMP]))]
        color = int(mem[MEM_COLOR])
        if color == CS_GRAY:
            rgb = [comps[0]] * 3
        elif color == CS_RGB:
            rgb = comps[:3]
        else:
            y, cb, cr = comps[:3]
            r = y + cr_r[cr]
            g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
            b = y + cb_b[cb]
            rgb = [v.clamp(0, 255) for v in (r, g, b)]
            if color in (CS_CMYK, CS_YCCK):
                if color == CS_YCCK:
                    inks = [(255 - (v + 0)).clamp(0, 255) for v in
                            (y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16), y + cb_b[cb])]
                else:
                    inks = comps[:3]
                k = comps[3]
                if int(mem[MEM_INVERTED]):
                    rgb = [v * k // 255 for v in inks]
                else:
                    rgb = [(255 - v) * (255 - k) // 255 for v in inks]
        px = torch.stack(rgb, -1).to(torch.uint8).reshape(-1)
        start = int(mem[MEM_OUT])
        out[start:start + px.numel()] = px
    return out
