// CCITT bilevel decoding for the port's TIFF sources: compression 2
// (modified Huffman, rows byte-aligned), 3 (T.4 Group 3, 1-D or, with
// T4Options bit 0, 2-D; EOLs with or without fill) and 4 (T.6 Group 4), as
// libtiff's tif_fax3.c decodes them under Pillow: the same code tables, the
// same bit reader (least significant bit first after the FillOrder's bit
// reversal, zero bits past the end of a strip until a code takes them), the
// same run bookkeeping (a bad code or an EOL inside a row ends the row,
// white to its end; runs past the row are cut; the reference line of a 2-D
// row keeps the runs as the fill cut them) and the same outcomes: a strip of
// modified Huffman or Group 3 2-D data that ends inside a row is a failed
// read, a Group 4 strip that ends early keeps the rows it decoded, and a
// Group 3 strip that ends between rows, or a 1-D one that ends anywhere, is
// answered (the rows after it white here; libtiff leaves bytes of its run
// buffer in some of them). Runs are written as
// libtiff fills them: black runs as 1 bits, most significant bit first, rows
// padded to whole bytes. Plain C interface for ctypes; no global state but
// the code tables, built once.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

enum State : uint8_t {
  S_Null = 0, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB, S_MakeUpW,
  S_MakeUpB, S_MakeUp, S_EOL
};

struct TabEnt {
  uint8_t state;
  uint8_t width;
  uint16_t param;
};

// (code as written, most significant bit first; length; run)
struct Code {
  uint16_t bits;
  uint8_t len;
  uint16_t run;
};

// T.4 terminating codes, runs 0-63
const Code kWhiteTerm[64] = {
    {0x35, 8, 0},  {0x7, 6, 1},   {0x7, 4, 2},   {0x8, 4, 3},   {0xB, 4, 4},   {0xC, 4, 5},
    {0xE, 4, 6},   {0xF, 4, 7},   {0x13, 5, 8},  {0x14, 5, 9},  {0x7, 5, 10},  {0x8, 5, 11},
    {0x8, 6, 12},  {0x3, 6, 13},  {0x34, 6, 14}, {0x35, 6, 15}, {0x2A, 6, 16}, {0x2B, 6, 17},
    {0x27, 7, 18}, {0xC, 7, 19},  {0x8, 7, 20},  {0x17, 7, 21}, {0x3, 7, 22},  {0x4, 7, 23},
    {0x28, 7, 24}, {0x2B, 7, 25}, {0x13, 7, 26}, {0x24, 7, 27}, {0x18, 7, 28}, {0x2, 8, 29},
    {0x3, 8, 30},  {0x1A, 8, 31}, {0x1B, 8, 32}, {0x12, 8, 33}, {0x13, 8, 34}, {0x14, 8, 35},
    {0x15, 8, 36}, {0x16, 8, 37}, {0x17, 8, 38}, {0x28, 8, 39}, {0x29, 8, 40}, {0x2A, 8, 41},
    {0x2B, 8, 42}, {0x2C, 8, 43}, {0x2D, 8, 44}, {0x4, 8, 45},  {0x5, 8, 46},  {0xA, 8, 47},
    {0xB, 8, 48},  {0x52, 8, 49}, {0x53, 8, 50}, {0x54, 8, 51}, {0x55, 8, 52}, {0x24, 8, 53},
    {0x25, 8, 54}, {0x58, 8, 55}, {0x59, 8, 56}, {0x5A, 8, 57}, {0x5B, 8, 58}, {0x4A, 8, 59},
    {0x4B, 8, 60}, {0x32, 8, 61}, {0x33, 8, 62}, {0x34, 8, 63}};
const Code kBlackTerm[64] = {
    {0x37, 10, 0}, {0x2, 3, 1},    {0x3, 2, 2},    {0x2, 2, 3},    {0x3, 3, 4},    {0x3, 4, 5},
    {0x2, 4, 6},   {0x3, 5, 7},    {0x5, 6, 8},    {0x4, 6, 9},    {0x4, 7, 10},   {0x5, 7, 11},
    {0x7, 7, 12},  {0x4, 8, 13},   {0x7, 8, 14},   {0x18, 9, 15},  {0x17, 10, 16}, {0x18, 10, 17},
    {0x8, 10, 18}, {0x67, 11, 19}, {0x68, 11, 20}, {0x6C, 11, 21}, {0x37, 11, 22}, {0x28, 11, 23},
    {0x17, 11, 24}, {0x18, 11, 25}, {0xCA, 12, 26}, {0xCB, 12, 27}, {0xCC, 12, 28}, {0xCD, 12, 29},
    {0x68, 12, 30}, {0x69, 12, 31}, {0x6A, 12, 32}, {0x6B, 12, 33}, {0xD2, 12, 34}, {0xD3, 12, 35},
    {0xD4, 12, 36}, {0xD5, 12, 37}, {0xD6, 12, 38}, {0xD7, 12, 39}, {0x6C, 12, 40}, {0x6D, 12, 41},
    {0xDA, 12, 42}, {0xDB, 12, 43}, {0x54, 12, 44}, {0x55, 12, 45}, {0x56, 12, 46}, {0x57, 12, 47},
    {0x64, 12, 48}, {0x65, 12, 49}, {0x52, 12, 50}, {0x53, 12, 51}, {0x24, 12, 52}, {0x37, 12, 53},
    {0x38, 12, 54}, {0x27, 12, 55}, {0x28, 12, 56}, {0x58, 12, 57}, {0x59, 12, 58}, {0x2B, 12, 59},
    {0x2C, 12, 60}, {0x5A, 12, 61}, {0x66, 12, 62}, {0x67, 12, 63}};
// make-up codes, runs 64-1728
const Code kWhiteMakeUp[27] = {
    {0x1B, 5, 64},   {0x12, 5, 128},  {0x17, 6, 192},  {0x37, 7, 256},  {0x36, 8, 320},
    {0x37, 8, 384},  {0x64, 8, 448},  {0x65, 8, 512},  {0x68, 8, 576},  {0x67, 8, 640},
    {0xCC, 9, 704},  {0xCD, 9, 768},  {0xD2, 9, 832},  {0xD3, 9, 896},  {0xD4, 9, 960},
    {0xD5, 9, 1024}, {0xD6, 9, 1088}, {0xD7, 9, 1152}, {0xD8, 9, 1216}, {0xD9, 9, 1280},
    {0xDA, 9, 1344}, {0xDB, 9, 1408}, {0x98, 9, 1472}, {0x99, 9, 1536}, {0x9A, 9, 1600},
    {0x18, 6, 1664}, {0x9B, 9, 1728}};
const Code kBlackMakeUp[27] = {
    {0xF, 10, 64},    {0xC8, 12, 128},  {0xC9, 12, 192},  {0x5B, 12, 256},  {0x33, 12, 320},
    {0x34, 12, 384},  {0x35, 12, 448},  {0x6C, 13, 512},  {0x6D, 13, 576},  {0x4A, 13, 640},
    {0x4B, 13, 704},  {0x4C, 13, 768},  {0x4D, 13, 832},  {0x72, 13, 896},  {0x73, 13, 960},
    {0x74, 13, 1024}, {0x75, 13, 1088}, {0x76, 13, 1152}, {0x77, 13, 1216}, {0x52, 13, 1280},
    {0x53, 13, 1344}, {0x54, 13, 1408}, {0x55, 13, 1472}, {0x5A, 13, 1536}, {0x5B, 13, 1600},
    {0x64, 13, 1664}, {0x65, 13, 1728}};
// extended make-up codes of both colours, runs 1792-2560
const Code kExtMakeUp[13] = {
    {0x8, 11, 1792},  {0xC, 11, 1856},  {0xD, 11, 1920},  {0x12, 12, 1984}, {0x13, 12, 2048},
    {0x14, 12, 2112}, {0x15, 12, 2176}, {0x16, 12, 2240}, {0x17, 12, 2304}, {0x1C, 12, 2368},
    {0x1D, 12, 2432}, {0x1E, 12, 2496}, {0x1F, 12, 2560}};

struct Tables {
  TabEnt main[128];
  TabEnt white[4096];
  TabEnt black[8192];
};

// every index of a `width`-bit table whose first `len` bits (read least
// significant first) are `bits` (written most significant first)
void put(TabEnt* tab, int width, uint16_t bits, int len, State st, int param) {
  unsigned rev = 0;
  for (int i = 0; i < len; ++i) rev |= ((bits >> (len - 1 - i)) & 1u) << i;
  for (unsigned rest = 0; rest < (1u << (width - len)); ++rest) {
    TabEnt& e = tab[rev | (rest << len)];
    e.state = st;
    e.width = static_cast<uint8_t>(len);
    e.param = static_cast<uint16_t>(param);
  }
}

Tables build_tables() {
  Tables t;
  std::memset(&t, 0, sizeof(t));
  {
    put(t.main, 7, 0x1, 4, S_Pass, 0);
    put(t.main, 7, 0x1, 3, S_Horiz, 0);
    put(t.main, 7, 0x1, 1, S_V0, 0);
    put(t.main, 7, 0x3, 3, S_VR, 1);
    put(t.main, 7, 0x3, 6, S_VR, 2);
    put(t.main, 7, 0x3, 7, S_VR, 3);
    put(t.main, 7, 0x2, 3, S_VL, 1);
    put(t.main, 7, 0x2, 6, S_VL, 2);
    put(t.main, 7, 0x2, 7, S_VL, 3);
    put(t.main, 7, 0x1, 7, S_Ext, 0);
    put(t.main, 7, 0x0, 7, S_EOL, 0);
    for (const Code& c : kWhiteTerm) put(t.white, 12, c.bits, c.len, S_TermW, c.run);
    for (const Code& c : kWhiteMakeUp) put(t.white, 12, c.bits, c.len, S_MakeUpW, c.run);
    for (const Code& c : kBlackTerm) put(t.black, 13, c.bits, c.len, S_TermB, c.run);
    for (const Code& c : kBlackMakeUp) put(t.black, 13, c.bits, c.len, S_MakeUpB, c.run);
    for (const Code& c : kExtMakeUp) {
      put(t.white, 12, c.bits, c.len, S_MakeUp, c.run);
      put(t.black, 13, c.bits, c.len, S_MakeUp, c.run);
    }
    // an EOL is recognised by its 11 zeros; its 1 bit is found by the next
    // row's synchronisation
    put(t.white, 12, 0x0, 11, S_EOL, 0);
    put(t.black, 13, 0x0, 11, S_EOL, 0);
  }
  return t;
}

// built once, at the first call (a function's static: thread-safe)
const Tables& tables() {
  static const Tables t = build_tables();
  return t;
}

enum Mode { kRle = 0, kRleWord = 1, kG3_1D = 2, kG3_2D = 3, kG4 = 4 };
// kEofSync: the data ended while looking for a row's EOL (between rows)
enum Status { kOk = 0, kEof = 1, kOverflow = 2, kEofSync = 3 };

// _TIFFFax3fillruns: alternate white (0) and black (1) runs into a row,
// each run cut at the row's end (the cut kept in the runs)
void fill_runs(uint8_t* buf, uint32_t* runs, uint32_t* erun, uint32_t lastx) {
  if ((erun - runs) & 1) *erun++ = 0;
  uint32_t x = 0;
  for (; runs < erun; runs += 2) {
    for (int k = 0; k < 2; ++k) {
      uint32_t run = runs[k];
      if (x + run > lastx || run > lastx) run = runs[k] = lastx - x;
      if (k == 1)
        for (uint32_t i = x; i < x + run; ++i) buf[i >> 3] |= static_cast<uint8_t>(0x80 >> (i & 7));
      else
        for (uint32_t i = x; i < x + run; ++i) buf[i >> 3] &= static_cast<uint8_t>(~(0x80 >> (i & 7)));
      x += run;
    }
  }
}

struct Decoder {
  const uint8_t* start;  // the strip's first byte (its buffer is aligned)
  const uint8_t* cp;
  const uint8_t* ep;
  uint8_t bitmap[256];
  uint32_t BitAcc = 0;
  int BitsAvail = 0;
  int EOLcnt = 0;
  std::vector<uint32_t> runs;  // 2 * nruns (+ slack for fill's extra slot)
  uint32_t nruns;
  uint32_t* curruns;
  uint32_t* refruns;
  int lastx;
  int mode;

  bool end() const { return cp >= ep; }
  // NeedBits8 / NeedBits16: false where the data has run out with no bit left
  bool need8(int n) {
    if (BitsAvail < n) {
      if (end()) {
        if (BitsAvail == 0) return false;
        BitsAvail = n;  // pad with zeros
      } else {
        BitAcc |= static_cast<uint32_t>(bitmap[*cp++]) << BitsAvail;
        BitsAvail += 8;
      }
    }
    return true;
  }
  bool need16(int n) {
    if (BitsAvail < n) {
      if (end()) {
        if (BitsAvail == 0) return false;
        BitsAvail = n;
      } else {
        BitAcc |= static_cast<uint32_t>(bitmap[*cp++]) << BitsAvail;
        if ((BitsAvail += 8) < n) {
          if (end()) {
            BitsAvail = n;
          } else {
            BitAcc |= static_cast<uint32_t>(bitmap[*cp++]) << BitsAvail;
            BitsAvail += 8;
          }
        }
      }
    }
    return true;
  }
  uint32_t get(int n) const { return BitAcc & ((1u << n) - 1); }
  void clr(int n) {
    BitsAvail -= n;
    BitAcc >>= n;
  }
  // LOOKUP8 / LOOKUP16: the entry of the next `width` bits, its code taken
  const TabEnt* lookup(const TabEnt* tab, int width, bool wide) {
    if (!(wide ? need16(width) : need8(width))) return nullptr;
    const TabEnt* e = tab + get(width);
    clr(e->width);
    return e;
  }
};

// one row's state (libtiff's a0, RunLength, pa, pb, b1)
struct Row {
  Decoder& d;
  uint32_t* thisrun;
  uint32_t* pa;
  uint32_t* pb;
  int a0 = 0;
  int RunLength = 0;
  int b1 = 0;
  bool overflow = false;

  bool setvalue(int x) {
    if (pa >= thisrun + d.nruns) {
      overflow = true;
      return false;
    }
    *pa++ = static_cast<uint32_t>(RunLength + x);
    a0 += x;
    RunLength = 0;
    return true;
  }
  // CLEANUP_RUNS: the row's runs made to end at lastx
  bool cleanup() {
    const int lastx = d.lastx;
    if (RunLength && !setvalue(0)) return false;
    if (a0 != lastx) {
      while (a0 > lastx && pa > thisrun) a0 -= static_cast<int>(*--pa);
      if (a0 < lastx) {
        if (a0 < 0) a0 = 0;
        if ((pa - thisrun) & 1)
          if (!setvalue(0)) return false;
        if (!setvalue(lastx - a0)) return false;
      } else if (a0 > lastx) {
        if (!setvalue(lastx)) return false;
        if (!setvalue(0)) return false;
      }
    }
    return true;
  }
  // CHECK_b1
  bool check_b1() {
    if (pa != thisrun)
      while (b1 <= a0 && b1 < d.lastx) {
        if (pb + 1 >= d.refruns + d.nruns) {
          overflow = true;
          return false;
        }
        b1 += static_cast<int>(pb[0] + pb[1]);
        pb += 2;
      }
    return true;
  }
};

// outcome of a row's expansion
enum Expand { kDone, kEofRow, kFail };

// EXPAND1D: white and black runs to the row's end; an EOL or a bad code
// ends the row (EOLcnt set for an EOL)
Expand expand1d(Row& r) {
  const Tables& t = tables();
  Decoder& d = r.d;
  for (;;) {
    for (int color = 0; color < 2; ++color) {
      for (;;) {
        const TabEnt* e = color == 0 ? d.lookup(t.white, 12, true) : d.lookup(t.black, 13, true);
        if (!e) {
          if (!r.cleanup()) return kFail;
          return kEofRow;
        }
        const State term = color == 0 ? S_TermW : S_TermB;
        const State makeup = color == 0 ? S_MakeUpW : S_MakeUpB;
        if (e->state == S_EOL) {
          d.EOLcnt = 1;
          return r.cleanup() ? kDone : kFail;
        }
        if (e->state == term) {
          if (!r.setvalue(e->param)) return kFail;
          break;
        }
        if (e->state == makeup || e->state == S_MakeUp) {
          r.a0 += e->param;
          r.RunLength += e->param;
          continue;
        }
        return r.cleanup() ? kDone : kFail;  // a bad code
      }
      if (r.a0 >= d.lastx) return r.cleanup() ? kDone : kFail;
    }
    if (r.pa - r.thisrun >= 2 && *(r.pa - 1) == 0 && *(r.pa - 2) == 0) r.pa -= 2;
  }
}

// the horizontal mode's two runs, `first` the colour of the first (0 white)
int horizontal(Row& r, int first) {
  const Tables& t = tables();
  Decoder& d = r.d;
  for (int k = 0; k < 2; ++k) {
    const int color = k == 0 ? first : 1 - first;
    for (;;) {
      const TabEnt* e = color == 0 ? d.lookup(t.white, 12, true) : d.lookup(t.black, 13, true);
      if (!e) return -1;  // end of data
      const State term = color == 0 ? S_TermW : S_TermB;
      const State makeup = color == 0 ? S_MakeUpW : S_MakeUpB;
      if (e->state == term) {
        if (!r.setvalue(e->param)) return -2;
        break;
      }
      if (e->state == makeup || e->state == S_MakeUp) {
        r.a0 += e->param;
        r.RunLength += e->param;
        continue;
      }
      return 0;  // a bad code
    }
  }
  return 1;
}

// EXPAND2D: the row coded against the reference line
Expand expand2d(Row& r) {
  const Tables& t = tables();
  Decoder& d = r.d;
  const int lastx = d.lastx;
  bool bad = false;
  while (r.a0 < lastx) {
    if (r.pa >= r.thisrun + d.nruns) return kFail;
    const TabEnt* e = d.lookup(t.main, 7, false);
    if (!e) {
      if (!r.cleanup()) return kFail;
      return kEofRow;
    }
    switch (e->state) {
      case S_Pass:
        if (!r.check_b1()) return kFail;
        if (r.pb + 1 >= d.refruns + d.nruns) return kFail;
        r.b1 += static_cast<int>(*r.pb++);
        r.RunLength += r.b1 - r.a0;
        r.a0 = r.b1;
        r.b1 += static_cast<int>(*r.pb++);
        break;
      case S_Horiz: {
        const int got = horizontal(r, ((r.pa - r.thisrun) & 1) ? 1 : 0);
        if (got == -2) return kFail;
        if (got == -1) {
          if (!r.cleanup()) return kFail;
          return kEofRow;
        }
        if (got == 0) {
          bad = true;
          break;
        }
        if (!r.check_b1()) return kFail;
        break;
      }
      case S_V0:
      case S_VR:
        if (!r.check_b1()) return kFail;
        if (!r.setvalue(r.b1 - r.a0 + (e->state == S_VR ? e->param : 0))) return kFail;
        if (r.pb >= d.refruns + d.nruns) return kFail;
        r.b1 += static_cast<int>(*r.pb++);
        break;
      case S_VL:
        if (!r.check_b1()) return kFail;
        if (r.b1 < r.a0 + e->param) {
          bad = true;
          break;
        }
        if (!r.setvalue(r.b1 - r.a0 - e->param)) return kFail;
        r.b1 -= static_cast<int>(*--r.pb);
        break;
      case S_Ext:
        *r.pa++ = static_cast<uint32_t>(lastx - r.a0);
        bad = true;  // uncompressed data: not supported
        break;
      case S_EOL:
        *r.pa++ = static_cast<uint32_t>(lastx - r.a0);
        if (!d.need8(4)) {
          if (!r.cleanup()) return kFail;
          return kEofRow;
        }
        d.clr(4);
        d.EOLcnt = 1;
        bad = true;
        break;
      default:
        bad = true;
    }
    if (bad) break;
  }
  if (!bad && r.RunLength) {
    if (r.RunLength + r.a0 < lastx) {
      // a final V0 is expected
      if (!d.need8(1)) {
        if (!r.cleanup()) return kFail;
        return kEofRow;
      }
      if (!d.get(1)) {
        return r.cleanup() ? kDone : kFail;
      }
      d.clr(1);
    }
    if (!r.setvalue(0)) return kFail;
  }
  return r.cleanup() ? kDone : kFail;
}

// SYNC_EOL: skip to the end of the next EOL (false: the data ended)
bool sync_eol(Decoder& d) {
  if (d.EOLcnt == 0) {
    for (;;) {
      if (!d.need16(11)) return false;
      if (d.get(11) == 0) break;
      d.clr(1);
    }
  }
  for (;;) {
    if (!d.need8(8)) return false;
    if (d.get(8)) break;
    d.clr(8);
  }
  while (d.get(1) == 0) d.clr(1);
  d.clr(1);
  d.EOLcnt = 0;
  return true;
}

// one strip (or tile) of `rows` rows into out (rowbytes a row); returns
// kOk, kEof (the read fails) or kOverflow (libtiff's run buffer would
// overflow: the read fails)
int decode_strip(Decoder& d, uint8_t* out, size_t rowbytes, int rows) {
  // Fax3PreDecode
  d.BitAcc = 0;
  d.BitsAvail = 0;
  d.EOLcnt = 0;
  d.curruns = d.runs.data();
  if (d.mode == kG3_2D || d.mode == kG4) {
    d.refruns = d.runs.data() + d.nruns;
    d.refruns[0] = static_cast<uint32_t>(d.lastx);
    d.refruns[1] = 0;
  }
  for (int line = 0; line < rows; ++line) {
    uint8_t* buf = out + static_cast<size_t>(line) * rowbytes;
    Row r{d, d.curruns, d.curruns, d.refruns};
    Expand got;
    if (d.mode == kRle || d.mode == kRleWord) {
      got = expand1d(r);
      if (got == kFail) return kOverflow;
      fill_runs(buf, r.thisrun, r.pa, d.lastx);
      if (got == kEofRow) return kEof;
      // the row ends on a byte (or 16-bit word) boundary
      if (d.mode == kRle) {
        d.clr(d.BitsAvail - (d.BitsAvail & ~7));
      } else {
        d.clr(d.BitsAvail - (d.BitsAvail & ~15));
        if (d.BitsAvail == 0 && ((d.cp - d.start) & 1)) ++d.cp;
      }
      continue;
    }
    if (d.mode == kG3_1D) {
      if (!sync_eol(d)) {
        if (!r.cleanup()) return kOverflow;
        fill_runs(buf, r.thisrun, r.pa, d.lastx);
        return kEofSync;
      }
      got = expand1d(r);
      if (got == kFail) return kOverflow;
      fill_runs(buf, r.thisrun, r.pa, d.lastx);
      if (got == kEofRow) return kEof;
      continue;
    }
    bool is1d = false;
    if (d.mode == kG3_2D) {
      if (!sync_eol(d) || !d.need8(1)) {
        if (!r.cleanup()) return kOverflow;
        fill_runs(buf, r.thisrun, r.pa, d.lastx);
        return kEofSync;
      }
      is1d = d.get(1) != 0;
      d.clr(1);
    }
    r.b1 = static_cast<int>(*r.pb++);
    got = is1d ? expand1d(r) : expand2d(r);
    if (got == kFail) return kOverflow;
    if (d.mode == kG4 && (got == kEofRow || d.EOLcnt)) {
      // the end of the data (EOFB): the row filled, the strip ends here
      d.need16(13);
      d.clr(13);
      fill_runs(buf, r.thisrun, r.pa, d.lastx);
      return line ? kOk : kEof;
    }
    fill_runs(buf, r.thisrun, r.pa, d.lastx);
    if (got == kEofRow) return kEof;
    if (d.mode == kG4 || r.pa < r.thisrun + d.nruns)
      if (!r.setvalue(0)) return kOverflow;  // imaginary change for reference
    uint32_t* tmp = d.curruns;
    d.curruns = d.refruns;
    d.refruns = tmp;
  }
  return kOk;
}

}  // namespace

extern "C" {

// Decodes a page's strips (or tiles) of CCITT data. mode: 0 compression 2,
// 1 compression 32771, 2 Group 3 1-D, 3 Group 3 2-D, 4 Group 4; lsb: the
// FillOrder is 2. Strip k is data[offs[k], offs[k] + lens[k]) and holds
// rows[k] rows of `width` pixels, written at out + outoffs[k] a row
// `rowbytes` apart (each row ceil(width / 8) bytes, black = 1). Returns the
// number of strips decoded; *status is kOk, or kEof / kOverflow /
// kEofSync for the strip that ended early or failed.
int fl_fax_decode(const uint8_t* data, const uint64_t* offs, const uint64_t* lens,
                  const int* rows, const uint64_t* outoffs, int nstrips, int width, int mode,
                  int lsb, uint8_t* out, size_t rowbytes, int* status) {
  Decoder d;
  for (int b = 0; b < 256; ++b) {
    int v = b;
    if (!lsb) {
      v = 0;
      for (int i = 0; i < 8; ++i) v |= ((b >> i) & 1) << (7 - i);
    }
    d.bitmap[b] = static_cast<uint8_t>(v);
  }
  uint32_t nruns = (static_cast<uint32_t>(width) + 1 + 31) & ~31u;
  if (mode == kG3_2D || mode == kG4) nruns *= 2;
  d.nruns = nruns;
  d.runs.assign(static_cast<size_t>(nruns) * 2 + 2, 0);
  d.refruns = nullptr;
  d.lastx = width;
  d.mode = mode;
  *status = kOk;
  for (int k = 0; k < nstrips; ++k) {
    d.start = d.cp = data + offs[k];
    d.ep = d.cp + lens[k];
    const int st = decode_strip(d, out + outoffs[k], rowbytes, rows[k]);
    if (st != kOk) {
      *status = st;
      return k;
    }
  }
  return nstrips;
}

}  // extern "C"
