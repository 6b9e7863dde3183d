// The port's JPEG file writer: quantized DCT coefficients in, a JPEG file
// out, byte for byte as libjpeg (libjpeg-turbo 2.x) writes the same
// coefficients with jpeg_write_coefficients / jpeg_write_scanlines.
//
// The card machine has no libjpeg, so the device kernels of the port's
// encoder (csrc/jpeg_trellis.cu K16, csrc/jpeg_fdct.cu K17) hand their
// coefficients to this host code, which does the entropy coding:
//
//   - markers as libjpeg writes them: SOI, a JFIF APP0 (YCbCr) or an Adobe
//     APP14 with transform 0 (CMYK), one DQT marker a table, SOF0 or SOF2,
//     DHT and SOS before each scan, EOI;
//   - a baseline sequential scan (all components interleaved) with the
//     standard tables (passed in) or optimized ones;
//   - progressive scans with jpeg_simple_progression's script for YCbCr,
//     coded as jcphuff.c codes them (EOB runs up to 0x7FFF, refinement
//     correction bits buffered up to 1000), each scan counted first and
//     its tables built from its own counts;
//   - optimal tables as jchuff.c's jpeg_gen_optimal_table builds them
//     (ties to the larger symbol, the reserved all-ones code point, code
//     lengths cut to 16);
//   - 0xFF00 stuffing and 1-bit padding at the end of a scan.
//
// Coefficients come as int16 [blocks][64] in zigzag order, a component's
// width_in_blocks x height_in_blocks blocks row-major, the components one
// after another. Interleaved scans pad each MCU row and column past a
// component's blocks with dummy blocks (AC 0, the DC of the block before),
// as jccoefct.c and jctrans.c do; non-interleaved scans code only the
// component's own blocks.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct HuffSpec {
  uint8_t bits[17];   // bits[1..16]
  uint8_t vals[256];
};

struct Derived {
  uint32_t code[256];
  uint8_t size[256];
};

void derive(const HuffSpec& t, Derived* d) {
  std::memset(d, 0, sizeof(*d));
  int p = 0;
  uint32_t code = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < t.bits[len]; ++i) {
      d->code[t.vals[p]] = code++;
      d->size[t.vals[p]] = static_cast<uint8_t>(len);
      ++p;
    }
    code <<= 1;
  }
}

// jchuff.c jpeg_gen_optimal_table: freq[257] is clobbered
void gen_optimal_table(long* freq, HuffSpec* t) {
  const int kMaxClen = 32;
  uint8_t bits[kMaxClen + 1];
  int codesize[257];
  int others[257];
  std::memset(bits, 0, sizeof(bits));
  std::memset(codesize, 0, sizeof(codesize));
  for (int i = 0; i < 257; ++i) others[i] = -1;
  freq[256] = 1;  // reserves the all-ones code point
  for (;;) {
    int c1 = -1, c2 = -1;
    long v = 1000000000L;
    for (int i = 0; i <= 256; ++i) {
      if (freq[i] && freq[i] <= v) {
        v = freq[i];
        c1 = i;
      }
    }
    v = 1000000000L;
    for (int i = 0; i <= 256; ++i) {
      if (freq[i] && freq[i] <= v && i != c1) {
        v = freq[i];
        c2 = i;
      }
    }
    if (c2 < 0) break;
    freq[c1] += freq[c2];
    freq[c2] = 0;
    codesize[c1]++;
    while (others[c1] >= 0) {
      c1 = others[c1];
      codesize[c1]++;
    }
    others[c1] = c2;
    codesize[c2]++;
    while (others[c2] >= 0) {
      c2 = others[c2];
      codesize[c2]++;
    }
  }
  for (int i = 0; i <= 256; ++i) {
    if (codesize[i]) bits[codesize[i]]++;
  }
  int i;
  for (i = kMaxClen; i > 16; --i) {
    while (bits[i] > 0) {
      int j = i - 2;
      while (bits[j] == 0) --j;
      bits[i] -= 2;
      bits[i - 1]++;
      bits[j + 1] += 2;
      bits[j]--;
    }
  }
  while (bits[i] == 0) --i;
  bits[i]--;
  std::memset(t, 0, sizeof(*t));
  std::memcpy(t->bits, bits, 17);
  int p = 0;
  for (int len = 1; len <= kMaxClen; ++len) {
    for (int j = 0; j <= 255; ++j) {
      if (codesize[j] == len) t->vals[p++] = static_cast<uint8_t>(j);
    }
  }
}

inline int nbits_of(int v) {  // v >= 0
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

struct Sink {
  std::vector<uint8_t> buf;
  uint64_t acc = 0;
  int nbits = 0;

  void byte(int b) { buf.push_back(static_cast<uint8_t>(b)); }
  void u16(int v) {
    byte(v >> 8);
    byte(v & 0xFF);
  }
  void bits(uint32_t v, int n) {
    if (n == 0) return;
    acc = (acc << n) | (v & ((1u << n) - 1));
    nbits += n;
    while (nbits >= 8) {
      const int c = static_cast<int>((acc >> (nbits - 8)) & 0xFF);
      byte(c);
      if (c == 0xFF) byte(0);
      nbits -= 8;
    }
    acc &= (1ull << nbits) - 1;
  }
  void flush() {  // pad the last byte with ones
    bits(0x7F, 7);
    acc = 0;
    nbits = 0;
  }
};

const int kMaxCorrBits = 1000;

struct Comp {
  int id, h, v, tbl;  // tbl: its quantization, DC and AC table number
  int bw, bh;             // width/height in blocks
  const int16_t* coef;
};

struct Scan {
  int n;
  int comp[4];
  int ss, se, ah, al;
};

class Encoder {
 public:
  Sink out;
  Comp comps[4];
  int ncomp = 0;
  int mcus_x = 0, mcus_y = 0;
  HuffSpec spec[2][4];  // [dc/ac][table]
  Derived der[2][4];
  bool sent[2][4] = {};

  // per scan
  bool gather = false;
  long counts[2][4][257];
  int last_dc[4] = {};
  int ac_tbl = 0;
  unsigned eobrun = 0;
  int be = 0;
  char corr[kMaxCorrBits];

  void symbol(int ac, int tbl, int s) {
    if (gather) {
      counts[ac][tbl][s]++;
    } else {
      out.bits(der[ac][tbl].code[s], der[ac][tbl].size[s]);
    }
  }
  void bits(uint32_t v, int n) {
    if (!gather) out.bits(v, n);
  }
  void buffered(const char* b, int n) {
    if (gather) return;
    for (int i = 0; i < n; ++i) out.bits(static_cast<uint32_t>(b[i]), 1);
  }
  void emit_eobrun() {
    if (eobrun == 0) return;
    const int nb = nbits_of(static_cast<int>(eobrun)) - 1;
    symbol(1, ac_tbl, nb << 4);
    if (nb) bits(eobrun, nb);
    eobrun = 0;
    buffered(corr, be);
    be = 0;
  }

  // -- block coders -------------------------------------------------------
  void baseline(const int16_t* b, int ci) {
    const int t = comps[ci].tbl;
    int temp = b[0] - last_dc[ci];
    last_dc[ci] = b[0];
    int temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    int nb = nbits_of(temp);
    symbol(0, t, nb);
    if (nb) bits(static_cast<uint32_t>(temp2), nb);
    int r = 0;
    for (int k = 1; k < 64; ++k) {
      temp = b[k];
      if (temp == 0) {
        ++r;
        continue;
      }
      while (r > 15) {
        symbol(1, t, 0xF0);
        r -= 16;
      }
      temp2 = temp;
      if (temp < 0) {
        temp = -temp;
        temp2--;
      }
      nb = nbits_of(temp);
      symbol(1, t, (r << 4) + nb);
      bits(static_cast<uint32_t>(temp2), nb);
      r = 0;
    }
    if (r > 0) symbol(1, t, 0);
  }

  void dc_first(const int16_t* b, int ci, int al) {
    int t2 = static_cast<int>(b[0]) >> al;
    int temp = t2 - last_dc[ci];
    last_dc[ci] = t2;
    t2 = temp;
    if (temp < 0) {
      temp = -temp;
      t2--;
    }
    const int nb = nbits_of(temp);
    symbol(0, comps[ci].tbl, nb);
    if (nb) bits(static_cast<uint32_t>(t2), nb);
  }

  void dc_refine(const int16_t* b, int al) {
    bits(static_cast<uint32_t>((static_cast<int>(b[0]) >> al) & 1), 1);
  }

  void ac_first(const int16_t* b, int ss, int se, int al) {
    int r = 0;
    for (int k = ss; k <= se; ++k) {
      int temp = b[k];
      if (temp == 0) {
        ++r;
        continue;
      }
      int temp2;
      if (temp < 0) {
        temp = (-temp) >> al;
        temp2 = ~temp;
      } else {
        temp >>= al;
        temp2 = temp;
      }
      if (temp == 0) {
        ++r;
        continue;
      }
      emit_eobrun();
      while (r > 15) {
        symbol(1, ac_tbl, 0xF0);
        r -= 16;
      }
      const int nb = nbits_of(temp);
      symbol(1, ac_tbl, (r << 4) + nb);
      bits(static_cast<uint32_t>(temp2), nb);
      r = 0;
    }
    if (r > 0) {
      ++eobrun;
      if (eobrun == 0x7FFF) emit_eobrun();
    }
  }

  void ac_refine(const int16_t* b, int ss, int se, int al) {
    int absv[64];
    int eob = 0;
    for (int k = ss; k <= se; ++k) {
      int temp = b[k];
      if (temp < 0) temp = -temp;
      temp >>= al;
      absv[k] = temp;
      if (temp == 1) eob = k;
    }
    int r = 0, br = 0;
    char* brbuf = corr + be;
    for (int k = ss; k <= se; ++k) {
      int temp = absv[k];
      if (temp == 0) {
        ++r;
        continue;
      }
      while (r > 15 && k <= eob) {
        emit_eobrun();
        symbol(1, ac_tbl, 0xF0);
        r -= 16;
        buffered(brbuf, br);
        brbuf = corr;
        br = 0;
      }
      if (temp > 1) {
        brbuf[br++] = static_cast<char>(temp & 1);
        continue;
      }
      emit_eobrun();
      symbol(1, ac_tbl, (r << 4) + 1);
      bits(b[k] < 0 ? 0u : 1u, 1);
      buffered(brbuf, br);
      brbuf = corr;
      br = 0;
      r = 0;
    }
    if (r > 0 || br > 0) {
      ++eobrun;
      be += br;
      if (eobrun == 0x7FFF || be > kMaxCorrBits - 64 + 1) emit_eobrun();
    }
  }

  // -- scans ----------------------------------------------------------------
  void code_block(const Scan& s, const int16_t* b, int ci) {
    if (s.ss == 0 && s.se == 63) {
      baseline(b, ci);
    } else if (s.ss == 0) {
      if (s.ah == 0) dc_first(b, ci, s.al);
      else dc_refine(b, s.al);
    } else if (s.ah == 0) {
      ac_first(b, s.ss, s.se, s.al);
    } else {
      ac_refine(b, s.ss, s.se, s.al);
    }
  }

  void run_scan(const Scan& s) {
    for (int i = 0; i < 4; ++i) last_dc[i] = 0;
    eobrun = 0;
    be = 0;
    if (s.n == 1) {
      const Comp& c = comps[s.comp[0]];
      ac_tbl = c.tbl;
      for (int by = 0; by < c.bh; ++by) {
        for (int bx = 0; bx < c.bw; ++bx) {
          code_block(s, c.coef + (static_cast<size_t>(by) * c.bw + bx) * 64, s.comp[0]);
        }
      }
    } else {
      int16_t dummy[64];
      for (int my = 0; my < mcus_y; ++my) {
        for (int mx = 0; mx < mcus_x; ++mx) {
          for (int i = 0; i < s.n; ++i) {
            const int ci = s.comp[i];
            const Comp& c = comps[ci];
            int16_t prev_dc = 0;  // the first block of an MCU is always real
            for (int yi = 0; yi < c.v; ++yi) {
              for (int xi = 0; xi < c.h; ++xi) {
                const int by = my * c.v + yi, bx = mx * c.h + xi;
                const int16_t* b;
                if (by < c.bh && bx < c.bw) {
                  b = c.coef + (static_cast<size_t>(by) * c.bw + bx) * 64;
                } else {
                  std::memset(dummy, 0, sizeof(dummy));
                  dummy[0] = prev_dc;
                  b = dummy;
                }
                code_block(s, b, ci);
                prev_dc = b[0];
              }
            }
          }
        }
      }
    }
    emit_eobrun();
  }

  bool needs_table(const Scan& s, int ac) const {
    return ac ? s.se > 0 : s.ss == 0 && s.ah == 0;
  }

  void write_dht(int ac, int tbl) {
    if (sent[ac][tbl]) return;
    const HuffSpec& t = spec[ac][tbl];
    int n = 0;
    for (int i = 1; i <= 16; ++i) n += t.bits[i];
    out.u16(0xFFC4);
    out.u16(2 + 1 + 16 + n);
    out.byte((ac ? 0x10 : 0) | tbl);
    for (int i = 1; i <= 16; ++i) out.byte(t.bits[i]);
    for (int i = 0; i < n; ++i) out.byte(t.vals[i]);
    sent[ac][tbl] = true;
  }

  void write_sos(const Scan& s, bool progressive) {
    out.u16(0xFFDA);
    out.u16(2 + 1 + 2 * s.n + 3);
    out.byte(s.n);
    for (int i = 0; i < s.n; ++i) {
      const Comp& c = comps[s.comp[i]];
      int td = c.tbl, ta = c.tbl;
      if (progressive) {
        if (s.ss == 0) {
          ta = 0;
          if (s.ah != 0) td = 0;
        } else {
          td = 0;
        }
      }
      out.byte(c.id);
      out.byte((td << 4) + ta);
    }
    out.byte(s.ss);
    out.byte(s.se);
    out.byte((s.ah << 4) + s.al);
  }

  // one scan: count and build tables when optimizing, write its tables,
  // its header and its data
  void scan(const Scan& s, bool optimize, bool progressive) {
    if (optimize && !(s.ss == 0 && s.ah != 0)) {
      std::memset(counts, 0, sizeof(counts));
      gather = true;
      run_scan(s);
      gather = false;
      bool did[2][4] = {};
      for (int i = 0; i < s.n; ++i) {
        const int t = comps[s.comp[i]].tbl;
        for (int ac = 0; ac < 2; ++ac) {
          if (!needs_table(s, ac) || did[ac][t]) continue;
          gen_optimal_table(counts[ac][t], &spec[ac][t]);
          derive(spec[ac][t], &der[ac][t]);
          sent[ac][t] = false;
          did[ac][t] = true;
        }
      }
    }
    for (int i = 0; i < s.n; ++i) {
      const int t = comps[s.comp[i]].tbl;
      if (needs_table(s, 0)) write_dht(0, t);
      if (needs_table(s, 1)) write_dht(1, t);
    }
    write_sos(s, progressive);
    run_scan(s);
    out.flush();
  }
};

const int kZigzagToNat[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

}  // namespace

// Write a JPEG file. coef: int16 [blocks][64] zigzag, the components'
// blocks one after another (each libjpeg's width_in_blocks x
// height_in_blocks, row-major). factors: (h, v) of each component.
// qtables: 64 values a table, natural order (table 0 for the first
// component; table 1 for the others unless cmyk). cmyk: four components
// C, M, Y, K on table 0 under an Adobe marker; else YCbCr under JFIF.
// huffman: the four standard tables (DC 0, AC 0, DC 1, AC 1; 16 BITS
// counts then 256 HUFFVAL bytes each) for a baseline encode with them, or
// null for optimized tables. progressive: jpeg_simple_progression's
// script (YCbCr, optimized tables only). Returns a malloc'd file (free
// with fl_jpeg_free) or null on bad arguments.
extern "C" uint8_t* fl_jpeg_write(const int16_t* coef, int width, int height, int ncomp,
                                  const int* factors, const uint16_t* qtables, int cmyk,
                                  int progressive, const uint8_t* huffman, size_t* out_len) {
  if (!coef || !factors || !qtables || !out_len || width < 1 || height < 1 ||
      width > 65535 || height > 65535 || ncomp != (cmyk ? 4 : 3) ||
      (progressive && (cmyk || huffman)))
    return nullptr;
  Encoder* enc = new Encoder();
  int hmax = 1, vmax = 1, sum = 0;
  for (int c = 0; c < ncomp; ++c) {
    const int h = factors[2 * c], v = factors[2 * c + 1];
    if (h < 1 || h > 4 || v < 1 || v > 4) {
      delete enc;
      return nullptr;
    }
    hmax = h > hmax ? h : hmax;
    vmax = v > vmax ? v : vmax;
    sum += h * v;
  }
  if (sum > 10) {
    delete enc;
    return nullptr;
  }
  enc->ncomp = ncomp;
  enc->mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
  enc->mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
  size_t offset = 0;
  for (int c = 0; c < ncomp; ++c) {
    Comp& cp = enc->comps[c];
    cp.h = factors[2 * c];
    cp.v = factors[2 * c + 1];
    cp.id = cmyk ? "CMYK"[c] : c + 1;
    cp.tbl = (cmyk || c == 0) ? 0 : 1;
    cp.bw = (width * cp.h + 8 * hmax - 1) / (8 * hmax);
    cp.bh = (height * cp.v + 8 * vmax - 1) / (8 * vmax);
    cp.coef = coef + offset;
    offset += static_cast<size_t>(cp.bw) * cp.bh * 64;
  }
  Sink& out = enc->out;
  out.u16(0xFFD8);
  if (cmyk) {  // Adobe APP14, transform 0
    out.u16(0xFFEE);
    out.u16(14);
    for (const char* p = "Adobe"; *p; ++p) out.byte(*p);
    out.u16(100);
    out.u16(0);
    out.u16(0);
    out.byte(0);
  } else {  // JFIF 1.01, no density units, 1:1
    out.u16(0xFFE0);
    out.u16(16);
    for (const char* p = "JFIF"; *p; ++p) out.byte(*p);
    out.byte(0);
    out.byte(1);
    out.byte(1);
    out.byte(0);
    out.u16(1);
    out.u16(1);
    out.byte(0);
    out.byte(0);
  }
  const int nq = cmyk ? 1 : 2;
  for (int t = 0; t < nq; ++t) {
    out.u16(0xFFDB);
    out.u16(67);
    out.byte(t);
    for (int k = 0; k < 64; ++k) out.byte(qtables[t * 64 + kZigzagToNat[k]]);
  }
  out.u16(progressive ? 0xFFC2 : 0xFFC0);
  out.u16(8 + 3 * ncomp);
  out.byte(8);
  out.u16(height);
  out.u16(width);
  out.byte(ncomp);
  for (int c = 0; c < ncomp; ++c) {
    const Comp& cp = enc->comps[c];
    out.byte(cp.id);
    out.byte((cp.h << 4) | cp.v);
    out.byte(cp.tbl);
  }
  if (huffman) {
    for (int t = 0; t < 2; ++t) {
      for (int ac = 0; ac < 2; ++ac) {
        const uint8_t* src = huffman + (t * 2 + ac) * 272;
        HuffSpec& spec = enc->spec[ac][t];
        std::memset(&spec, 0, sizeof(spec));
        std::memcpy(spec.bits + 1, src, 16);
        std::memcpy(spec.vals, src + 16, 256);
        derive(spec, &enc->der[ac][t]);
      }
    }
  }
  if (!progressive) {
    Scan s = {ncomp, {0, 1, 2, 3}, 0, 63, 0, 0};
    enc->scan(s, huffman == nullptr, false);
  } else {
    // jpeg_simple_progression's script for three YCbCr components
    const Scan script[] = {
        {3, {0, 1, 2}, 0, 0, 0, 1},  {1, {0}, 1, 5, 0, 2},  {1, {2}, 1, 63, 0, 1},
        {1, {1}, 1, 63, 0, 1},       {1, {0}, 6, 63, 0, 2}, {1, {0}, 1, 63, 2, 1},
        {3, {0, 1, 2}, 0, 0, 1, 0},  {1, {2}, 1, 63, 1, 0}, {1, {1}, 1, 63, 1, 0},
        {1, {0}, 1, 63, 1, 0},
    };
    for (const Scan& s : script) enc->scan(s, true, true);
  }
  out.u16(0xFFD9);
  *out_len = out.buf.size();
  uint8_t* blob = static_cast<uint8_t*>(std::malloc(out.buf.size()));
  if (blob) std::memcpy(blob, out.buf.data(), out.buf.size());
  delete enc;
  return blob;
}

extern "C" void fl_jpeg_free(void* p) { std::free(p); }
