// The port's JPEG reader: a JPEG file in, each component's quantized DCT
// coefficients and quantization table out -- the counterpart of libjpeg's
// jpeg_read_coefficients, with libjpeg-turbo 2.x's markers, entropy
// decoding and tolerance of damaged data, so the kernels that follow
// (csrc/jpeg_idct.cu K18, csrc/jpeg_color.cu K19) give the pixels
// libjpeg-turbo gives.
//
//   - markers: SOI, APP0 (JFIF), APP14 (Adobe transform), DQT, DHT, DAC,
//     DRI, SOF0/1/2, SOF9/10, SOS, RSTn and EOI; other APPn and COM are
//     skipped; SOF3 and the other lossless and hierarchical frames
//     (SOF11, SOF13-15 among them), 12-bit frames and a second SOF are
//     errors, as in libjpeg's 8-bit build;
//   - Huffman scans: baseline and extended sequential (interleaved or
//     not) and progressive (DC first and refine, AC first and refine,
//     EOB runs), restart intervals, libjpeg's standard tables where a
//     scan names a table no DHT defined;
//   - arithmetic-coded scans (SOF9 sequential, SOF10 progressive), as
//     libjpeg-turbo's jdarith.c decodes them: the Q-coder with the
//     probability estimation of T.81 Table D.3 (jaricom.c), the DC and AC
//     statistics areas and their conditioning by DAC (L, U and Kx), every
//     progressive scan kind, the statistics reset at each restart marker,
//     and at a marker inside a scan zero data to its end; a bad code
//     (a magnitude or spectral overflow) leaves the rest of the restart
//     interval as it stands;
//   - damaged data as libjpeg-turbo reads it (jdhuff.c, jdphuff.c,
//     jdmarker.c): past the end of the data or at a marker inside a scan
//     the bit reader feeds zero bits, and once it has, the rest of that
//     restart interval is left as zeros (a progressive scan leaves the
//     coefficients of earlier scans); a code longer than 16 bits decodes
//     as 0; a coefficient index past 63 writes coefficient 63; a restart
//     marker out of sequence resyncs as jpeg_resync_to_restart does; a
//     progressive file whose coefficients are not all known to full
//     precision (a file cut before its last scans) gets libjpeg-turbo's
//     block smoothing (smooth_blocks). These are libjpeg's warnings: the
//     decode goes on. Its errors fail the decode.
//
// Coefficients are written int16, natural order, 64 a block, each
// component's blocks row-major over its padded block grid (alloc_w x
// alloc_h: the grid of an interleaved scan's MCUs), components one after
// another. A baseline file whose first scan holds every component may stop
// after a number of MCU rows (a window decode needs no rows below it).
// fl_jpeg_decode_batch decodes many files on threads.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries for safety in decoder (jutils.c)
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// libjpeg's standard Huffman tables (jstdhuff.c), used where a scan names
// table 0 or 1 and no DHT defined it
const uint8_t kStdBits[4][17] = {
    {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},      // DC luma
    {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0},      // DC chroma
    {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},   // AC luma
    {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};  // AC chroma
const uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcLuma[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kStdAcChroma[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// jaricom.c jpeg_aritab, T.81 Table D.3 in one word a state: Qe_Value << 16
// | Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS; state 113 is the
// fixed probability 0.5 (libjpeg's fixed_bin)
const long kAriTab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171};

constexpr int kArithTables = 16;  // NUM_ARITH_TBLS
constexpr int kDcStatBins = 64, kAcStatBins = 256;

enum Status { kOk = 0, kUnsupported = 1, kCorrupt = 2 };

struct Fail {
  int status;
};

}  // namespace

// The frame as the header gives it; filled by fl_jpeg_header, read by
// fl_jpeg_decode (which writes error and warnings).
extern "C" struct FlJpegFrame {
  int32_t width, height, ncomp, progressive;
  // 0 gray, 1 YCbCr, 2 RGB, 3 CMYK, 4 YCCK (libjpeg's jpeg_color_space)
  int32_t color;
  int32_t adobe;  // an Adobe APP14 marker was seen (CMYK stored inverted)
  int32_t max_h, max_v, mcus_x, mcus_y;
  // the first scan holds every component (libjpeg's single-scan case)
  int32_t single_scan;
  int32_t comp_id[4], comp_h[4], comp_v[4];
  int32_t blocks_w[4], blocks_h[4];  // width_in_blocks, height_in_blocks
  int32_t alloc_w[4], alloc_h[4];    // the padded grid coefficients fill
  int32_t warnings;
  char error[160];
};

namespace {

struct Huff {
  bool defined = false;
  uint8_t bits[17];
  uint8_t vals[256];
  // derived (jdhuff.c jpeg_make_d_derived_tbl)
  int32_t maxcode[18];
  int32_t valoffset[17];
  // codes of up to 8 bits by their next 8 bits: length (0: longer) and symbol
  uint8_t look_nbits[256];
  uint8_t look_sym[256];
};

struct Comp {
  int id, h, v, tq;
  int bw, bh, aw, ah;
  int16_t* coef;
  bool latched;
  int dc_tbl, ac_tbl;
};

struct Reader {
  const uint8_t* d;
  size_t n;
  size_t pos;
  FlJpegFrame* f;
  // marker state
  uint16_t qt[4][64];
  bool qt_defined[4];
  Huff dc[4], ac[4];
  int restart_interval;
  bool saw_jfif, saw_adobe, saw_sof;
  int adobe_transform;
  bool progressive;
  bool arith;
  int precision;
  // arithmetic conditioning (DAC; jdmarker.c get_soi's defaults)
  uint8_t arith_dc_L[kArithTables], arith_dc_U[kArithTables], arith_ac_K[kArithTables];
  // the arithmetic decoder (jdarith.c arith_entropy_decoder)
  long ac_c, ac_a;
  int ac_ct;
  int dc_context[4];
  uint8_t dc_stats[kArithTables][kDcStatBins];
  uint8_t ac_stats[kArithTables][kAcStatBins];
  uint8_t fixed_bin[4];
  Comp comp[4];
  int ncomp;
  int max_h, max_v;
  uint16_t* qt_out;
  int max_mcu_rows;
  int scan_number;
  // bit reader
  uint64_t buf;
  int bits;
  int unread_marker;
  bool insufficient;
  // scan state
  int comps_in_scan;
  int scan_comp[4];
  int Ss, Se, Ah, Al;
  int last_dc[4];
  unsigned eobrun;
  int restarts_to_go;
  int next_restart_num;
  // progression status (jdinput.c coef_bits, and jdphuff.c's copy of it as
  // it stood before each scan) and the last iMCU row decoded with data
  // (jdcoefct.c last_good_iMCU_row): block smoothing reads them
  int coef_bits[4][64];
  int prev_bits[4][64];
  int last_good_imcu;

  [[noreturn]] void fail(int status, const char* msg) {
    std::snprintf(f->error, sizeof(f->error), "%s", msg);
    throw Fail{status};
  }
  void warn() { ++f->warnings; }

  // --- byte input (jdmarker.c; the memory source's fake EOI past the end)
  int read_byte() {
    if (pos < n) return d[pos++];
    // jdatasrc.c: a fake EOI (0xFF 0xD9) past the end of the data
    warn();
    static const uint8_t eoi[2] = {0xFF, 0xD9};
    // once past the end, hand out FF D9 pairs
    int k = static_cast<int>((pos - n) & 1);
    ++pos;
    return eoi[k];
  }
  int read_u16() {
    int a = read_byte();
    return (a << 8) | read_byte();
  }
  // next_marker: skip anything but FF, swallow FF padding, FF00 is data
  int next_marker() {
    for (;;) {
      int c = read_byte();
      while (c != 0xFF) {
        warn();
        c = read_byte();
      }
      do {
        c = read_byte();
      } while (c == 0xFF);
      if (c != 0) return c;
      warn();
    }
  }

  // --- marker segments
  void skip_variable() {
    int len = read_u16();
    if (len < 2) fail(kCorrupt, "bad marker length");
    for (int i = 0; i < len - 2; ++i) read_byte();
  }
  void get_app(int marker) {
    int len = read_u16();
    if (len < 2) fail(kCorrupt, "bad marker length");
    int datalen = len - 2;
    uint8_t head[14];
    int keep = std::min(datalen, 14);
    for (int i = 0; i < keep; ++i) head[i] = static_cast<uint8_t>(read_byte());
    for (int i = keep; i < datalen; ++i) read_byte();
    if (marker == 0xE0 && datalen >= 14 && head[0] == 'J' && head[1] == 'F' &&
        head[2] == 'I' && head[3] == 'F' && head[4] == 0)
      saw_jfif = true;
    if (marker == 0xEE && datalen >= 12 && head[0] == 'A' && head[1] == 'd' &&
        head[2] == 'o' && head[3] == 'b' && head[4] == 'e') {
      saw_adobe = true;
      adobe_transform = head[11];
    }
  }
  void get_dqt() {
    long length = read_u16() - 2;
    while (length > 0) {
      length--;
      int c = read_byte();
      int prec = c >> 4, t = c & 15;
      if (t >= 4) fail(kCorrupt, "bad DQT table index");
      int count;
      if (prec) {
        if (length < 128) {
          for (int i = 0; i < 64; ++i) qt[t][i] = 1;
          count = static_cast<int>(length >> 1);
        } else {
          count = 64;
        }
      } else {
        if (length < 64) {
          for (int i = 0; i < 64; ++i) qt[t][i] = 1;
          count = static_cast<int>(length);
        } else {
          count = 64;
        }
      }
      for (int i = 0; i < count; ++i) {
        int v = prec ? read_u16() : read_byte();
        qt[t][kNatural[i]] = static_cast<uint16_t>(v);
      }
      qt_defined[t] = true;
      length -= count;
      if (prec) length -= count;
    }
    if (length != 0) fail(kCorrupt, "bad DQT length");
  }
  void get_dht() {
    long length = read_u16() - 2;
    while (length > 16) {
      int index = read_byte();
      uint8_t bits[17];
      bits[0] = 0;
      int count = 0;
      for (int i = 1; i <= 16; ++i) {
        bits[i] = static_cast<uint8_t>(read_byte());
        count += bits[i];
      }
      length -= 1 + 16;
      if (count > 256 || count > length) fail(kCorrupt, "bad Huffman table");
      Huff* h;
      if (index & 0x10) {
        index -= 0x10;
        if (index < 0 || index >= 4) fail(kCorrupt, "bad DHT index");
        h = &ac[index];
      } else {
        if (index < 0 || index >= 4) fail(kCorrupt, "bad DHT index");
        h = &dc[index];
      }
      std::memcpy(h->bits, bits, 17);
      std::memset(h->vals, 0, 256);
      for (int i = 0; i < count; ++i) h->vals[i] = static_cast<uint8_t>(read_byte());
      length -= count;
      h->defined = true;
    }
    if (length != 0) fail(kCorrupt, "bad DHT length");
  }
  void get_dri() {
    if (read_u16() != 4) fail(kCorrupt, "bad DRI length");
    restart_interval = read_u16();
  }
  void get_dac() {
    long length = read_u16() - 2;
    while (length > 0) {
      int index = read_byte();
      int val = read_byte();
      length -= 2;
      if (index < 0 || index >= 2 * kArithTables) fail(kCorrupt, "bad DAC index");
      if (index >= kArithTables) {
        arith_ac_K[index - kArithTables] = static_cast<uint8_t>(val);
      } else {
        arith_dc_L[index] = static_cast<uint8_t>(val & 0x0F);
        arith_dc_U[index] = static_cast<uint8_t>(val >> 4);
        if (arith_dc_L[index] > arith_dc_U[index]) fail(kCorrupt, "bad DAC value");
      }
    }
    if (length != 0) fail(kCorrupt, "bad DAC length");
  }
  void get_sof(int marker) {
    if (saw_sof) fail(kCorrupt, "duplicate SOF");
    progressive = marker == 0xC2 || marker == 0xCA;
    arith = marker == 0xC9 || marker == 0xCA;
    int length = read_u16();
    precision = read_byte();
    int height = read_u16();
    int width = read_u16();
    int nc = read_byte();
    length -= 8;
    if (height <= 0 || width <= 0 || nc <= 0) fail(kCorrupt, "empty image");
    if (length != nc * 3) fail(kCorrupt, "bad SOF length");
    if (precision != 8)
      fail(kUnsupported, "a JPEG of 12-bit samples (libjpeg's 8-bit build refuses it)");
    if (nc > 4) fail(kUnsupported, "a JPEG of more than 4 components");
    ncomp = nc;
    for (int i = 0; i < nc; ++i) {
      Comp& c = comp[i];
      c.id = read_byte();
      int hv = read_byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = read_byte();
      c.latched = false;
      c.coef = nullptr;
    }
    f->width = width;
    f->height = height;
    saw_sof = true;
  }

  void setup_frame() {
    if (ncomp > 4) fail(kUnsupported, "a JPEG of more than 4 components");
    max_h = max_v = 1;
    for (int i = 0; i < ncomp; ++i) {
      Comp& c = comp[i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail(kCorrupt, "bad sampling factors");
      if (c.tq >= 4) fail(kCorrupt, "bad quantization table index");
      max_h = std::max(max_h, c.h);
      max_v = std::max(max_v, c.v);
    }
    const int W = f->width, H = f->height;
    f->mcus_x = (W + max_h * 8 - 1) / (max_h * 8);
    f->mcus_y = (H + max_v * 8 - 1) / (max_v * 8);
    for (int i = 0; i < ncomp; ++i) {
      Comp& c = comp[i];
      c.bw = static_cast<int>((static_cast<long>(W) * c.h + max_h * 8 - 1) / (max_h * 8));
      c.bh = static_cast<int>((static_cast<long>(H) * c.v + max_v * 8 - 1) / (max_v * 8));
      c.aw = f->mcus_x * c.h;
      c.ah = f->mcus_y * c.v;
      f->comp_id[i] = c.id;
      f->comp_h[i] = c.h;
      f->comp_v[i] = c.v;
      f->blocks_w[i] = c.bw;
      f->blocks_h[i] = c.bh;
      f->alloc_w[i] = c.aw;
      f->alloc_h[i] = c.ah;
    }
    f->ncomp = ncomp;
    f->max_h = max_h;
    f->max_v = max_v;
    f->progressive = progressive ? 1 : 0;
  }

  // jdapimin.c default_decompress_parms
  void color_space() {
    int cs = -1;
    if (ncomp == 1) {
      cs = 0;
    } else if (ncomp == 3) {
      if (saw_jfif) {
        cs = 1;
      } else if (saw_adobe) {
        cs = adobe_transform == 0 ? 2 : 1;
        if (adobe_transform != 0 && adobe_transform != 1) warn();
      } else {
        int a = comp[0].id, b = comp[1].id, c = comp[2].id;
        if (a == 1 && b == 2 && c == 3) cs = 1;
        else if (a == 82 && b == 71 && c == 66) cs = 2;
        else cs = 1;
      }
    } else if (ncomp == 4) {
      if (saw_adobe) {
        cs = adobe_transform == 0 ? 3 : 4;
        if (adobe_transform != 0 && adobe_transform != 2) warn();
      } else {
        cs = 3;
      }
    }
    f->color = cs;
    f->adobe = saw_adobe ? 1 : 0;
  }

  // reads markers up to (and including) the next SOS or EOI; returns the
  // marker (0xDA or 0xD9)
  int read_markers() {
    for (;;) {
      int m = unread_marker ? unread_marker : next_marker();
      unread_marker = 0;
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
        case 0xC9:
        case 0xCA:
          get_sof(m);
          break;
        case 0xC3:
        case 0xC5:
        case 0xC6:
        case 0xC7:
        case 0xC8:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          fail(kUnsupported, "a lossless or hierarchical JPEG (libjpeg refuses it)");
        case 0xDA:
          if (!saw_sof) fail(kCorrupt, "SOS before SOF");
          return m;
        case 0xD9:
          return m;
        case 0xC4:
          get_dht();
          break;
        case 0xCC:
          get_dac();
          break;
        case 0xDB:
          get_dqt();
          break;
        case 0xDD:
          get_dri();
          break;
        case 0xD8:
          fail(kCorrupt, "SOI inside the file");
        case 0xD0: case 0xD1: case 0xD2: case 0xD3:
        case 0xD4: case 0xD5: case 0xD6: case 0xD7:
        case 0x01:
          break;
        case 0xDC:  // DNL: ignored
          skip_variable();
          break;
        default:
          if ((m >= 0xE0 && m <= 0xEF)) {
            if (m == 0xE0 || m == 0xEE) get_app(m);
            else skip_variable();
          } else if (m == 0xFE) {
            skip_variable();
          } else {
            fail(kCorrupt, "unknown marker");
          }
      }
    }
  }

  void derive(Huff* h, bool is_dc, int index) {
    Huff& t = *h;
    if (!t.defined) {
      // jpeg_std_huff_table
      if (index > 1) fail(kCorrupt, "a scan names an undefined Huffman table");
      int k = (is_dc ? 0 : 2) + index;
      std::memcpy(t.bits, kStdBits[k], 17);
      std::memset(t.vals, 0, 256);
      if (is_dc) std::memcpy(t.vals, kStdDcVals, 12);
      else std::memcpy(t.vals, index ? kStdAcChroma : kStdAcLuma, 162);
      t.defined = true;
    }
    // jpeg_make_d_derived_tbl
    int huffsize[257];
    unsigned huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
      int i = t.bits[l];
      if (p + i > 256) fail(kCorrupt, "bad Huffman table");
      while (i--) huffsize[p++] = l;
    }
    huffsize[p] = 0;
    int numsymbols = p;
    unsigned code = 0;
    int si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) {
        huffcode[p++] = code;
        code++;
      }
      if (static_cast<long>(code) >= (1L << si)) fail(kCorrupt, "bad Huffman table");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (t.bits[l]) {
        t.valoffset[l] = p - static_cast<int>(huffcode[p]);
        p += t.bits[l];
        t.maxcode[l] = static_cast<int32_t>(huffcode[p - 1]);
      } else {
        t.maxcode[l] = -1;
      }
    }
    t.valoffset[0] = 0;
    t.maxcode[0] = -1;
    t.maxcode[17] = 0xFFFFF;
    std::memset(t.look_nbits, 0, 256);
    p = 0;
    for (int l = 1; l <= 8; ++l) {
      for (int i = 1; i <= t.bits[l]; ++i, ++p) {
        int look = static_cast<int>(huffcode[p]) << (8 - l);
        for (int ctr = 1 << (8 - l); ctr > 0; --ctr, ++look) {
          t.look_nbits[look] = static_cast<uint8_t>(l);
          t.look_sym[look] = t.vals[p];
        }
      }
    }
    if (is_dc)
      for (int i = 0; i < numsymbols; ++i)
        if (t.vals[i] > 15) fail(kCorrupt, "bad Huffman table");
  }

  // --- bit reader (jdhuff.c jpeg_fill_bit_buffer): bits of the current
  // segment; at a marker or the end of the data, zero bits, and the first
  // bit that is not data sets `insufficient`
  bool fill_byte() {
    if (unread_marker) return false;
    int c = read_byte();
    if (c == 0xFF) {
      do {
        c = read_byte();
      } while (c == 0xFF);
      if (c == 0) {
        c = 0xFF;
      } else {
        unread_marker = c;
        return false;
      }
    }
    buf = (buf << 8) | static_cast<uint64_t>(c);
    bits += 8;
    return true;
  }
  inline void need(int nb) {
    while (bits < nb) {
      if (!fill_byte()) {
        if (!insufficient) {
          warn();
          insufficient = true;
        }
        // zero bits: as many as the caller needs
        buf <<= 8;
        bits += 8;
      }
    }
  }
  inline int get_bits(int nb) {
    need(nb);
    bits -= nb;
    return static_cast<int>((buf >> bits) & ((1u << nb) - 1));
  }
  inline int get_bit() { return get_bits(1); }
  // HUFF_DECODE: with 8 bits of data at hand, a code of up to 8 bits by
  // lookup and a longer one from its first 9 bits; else bit by bit
  int decode(const Huff& t) {
    while (bits < 8 && fill_byte()) {
    }
    int l = 1;
    int32_t code;
    if (bits >= 8) {
      int look = static_cast<int>((buf >> (bits - 8)) & 0xFF);
      int nb = t.look_nbits[look];
      if (nb) {
        bits -= nb;
        return t.look_sym[look];
      }
      l = 9;
      code = get_bits(9);
    } else {
      code = get_bit();
    }
    while (code > t.maxcode[l]) {
      code = (code << 1) | get_bit();
      ++l;
    }
    if (l > 16) {
      warn();
      return 0;
    }
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
  static inline int extend(int r, int s) {
    return r < (1 << (s - 1)) ? r + static_cast<int>((~0u) << s) + 1 : r;
  }

  // --- restarts (process_restart, read_restart_marker, resync_to_restart)
  void process_restart() {
    bits = 0;
    buf = 0;
    if (unread_marker == 0) unread_marker = next_marker();
    if (unread_marker == 0xD0 + next_restart_num) {
      unread_marker = 0;
    } else {
      resync(next_restart_num);
    }
    next_restart_num = (next_restart_num + 1) & 7;
    for (int i = 0; i < 4; ++i) last_dc[i] = 0;
    eobrun = 0;
    restarts_to_go = restart_interval;
    if (unread_marker == 0) insufficient = false;
  }
  void resync(int desired) {
    int marker = unread_marker;
    warn();
    for (;;) {
      int action;
      if (marker < 0xC0) {
        action = 2;
      } else if (marker < 0xD0 || marker > 0xD7) {
        action = 3;
      } else {
        if (marker == 0xD0 + ((desired + 1) & 7) || marker == 0xD0 + ((desired + 2) & 7))
          action = 3;
        else if (marker == 0xD0 + ((desired - 1) & 7) || marker == 0xD0 + ((desired - 2) & 7))
          action = 2;
        else
          action = 1;
      }
      if (action == 1) {
        unread_marker = 0;
        return;
      }
      if (action == 3) return;
      unread_marker = next_marker();
      marker = unread_marker;
    }
  }

  int16_t* block_at(int ci, int by, int bx) {
    Comp& c = comp[ci];
    return c.coef + (static_cast<size_t>(by) * c.aw + bx) * 64;
  }

  // --- MCU decoders
  void mcu_sequential(int16_t** blocks, const int* bcomp, int nblocks) {
    if (insufficient) return;  // leave the MCU zero
    for (int b = 0; b < nblocks; ++b) {
      int ci = bcomp[b];
      Comp& c = comp[ci];
      int16_t* blk = blocks[b];
      int s = decode(dc[c.dc_tbl]);
      if (s) {
        int r = get_bits(s);
        s = extend(r, s);
      }
      int slot = scan_slot(ci);
      s = static_cast<int>(static_cast<unsigned>(s) + static_cast<unsigned>(last_dc[slot]));
      last_dc[slot] = s;
      blk[0] = static_cast<int16_t>(s);
      const Huff& at = ac[c.ac_tbl];
      for (int k = 1; k < 64; ++k) {
        int rs = decode(at);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          int v = get_bits(s);
          blk[kNatural[k]] = static_cast<int16_t>(extend(v, s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
  }
  void mcu_dc_first(int16_t** blocks, const int* bcomp, int nblocks) {
    if (insufficient) return;
    for (int b = 0; b < nblocks; ++b) {
      int ci = bcomp[b];
      int s = decode(dc[comp[ci].dc_tbl]);
      if (s) {
        int r = get_bits(s);
        s = extend(r, s);
      }
      int slot = scan_slot(ci);
      s = static_cast<int>(static_cast<unsigned>(s) + static_cast<unsigned>(last_dc[slot]));
      last_dc[slot] = s;
      blocks[b][0] = static_cast<int16_t>(static_cast<unsigned>(s) << Al);
    }
  }
  void mcu_dc_refine(int16_t** blocks, int nblocks) {
    // jdphuff.c reads on past the data here (zero bits change nothing)
    int p1 = 1 << Al;
    for (int b = 0; b < nblocks; ++b)
      if (get_bit()) blocks[b][0] = static_cast<int16_t>(blocks[b][0] | p1);
  }
  void mcu_ac_first(int16_t* blk, const Huff& t) {
    if (insufficient) return;
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    for (int k = Ss; k <= Se; ++k) {
      int rs = decode(t);
      int r = rs >> 4;
      int s = rs & 15;
      if (s) {
        k += r;
        int v = get_bits(s);
        blk[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(extend(v, s)) << Al);
      } else {
        if (r == 15) {
          k += 15;
        } else {
          eobrun = 1u << r;
          if (r) eobrun += static_cast<unsigned>(get_bits(r));
          eobrun--;
          break;
        }
      }
    }
  }
  void mcu_ac_refine(int16_t* blk, const Huff& t) {
    if (insufficient) return;
    const int p1 = 1 << Al;
    const int m1 = -1 * (1 << Al);
    int k = Ss;
    if (eobrun == 0) {
      for (; k <= Se; ++k) {
        int rs = decode(t);
        int r = rs >> 4;
        int s = rs & 15;
        if (s) {
          if (s != 1) warn();
          s = get_bit() ? p1 : m1;
        } else {
          if (r != 15) {
            eobrun = 1u << r;
            if (r) eobrun += static_cast<unsigned>(get_bits(r));
            break;
          }
        }
        do {
          int16_t* c = blk + kNatural[k];
          if (*c != 0) {
            if (get_bit()) {
              if ((*c & p1) == 0) {
                if (*c >= 0) *c = static_cast<int16_t>(*c + p1);
                else *c = static_cast<int16_t>(*c + m1);
              }
            }
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= Se);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= Se; ++k) {
        int16_t* c = blk + kNatural[k];
        if (*c != 0) {
          if (get_bit()) {
            if ((*c & p1) == 0) {
              if (*c >= 0) *c = static_cast<int16_t>(*c + p1);
              else *c = static_cast<int16_t>(*c + m1);
            }
          }
        }
      }
      eobrun--;
    }
  }

  // --- arithmetic decoding (jdarith.c)
  // arith_decode: one binary decision in statistics bin *st (T.81 D.2)
  int arith_decode(uint8_t* st) {
    // renormalization and data input (D.2.6)
    while (ac_a < 0x8000L) {
      if (--ac_ct < 0) {
        int data;
        if (unread_marker) {
          data = 0;  // zero data to the end of the scan
        } else {
          data = read_byte();
          if (data == 0xFF) {
            do {
              data = read_byte();
            } while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {
              unread_marker = data;
              data = 0;
            }
          }
        }
        ac_c = (ac_c << 8) | data;
        if ((ac_ct += 8) < 0)
          if (++ac_ct == 0) ac_a = 0x8000L;  // two initial bytes read
      }
      ac_a <<= 1;
    }
    int sv = *st;
    long qe = kAriTab[sv & 0x7F];
    const uint8_t nl = static_cast<uint8_t>(qe & 0xFF);
    qe >>= 8;
    const uint8_t nm = static_cast<uint8_t>(qe & 0xFF);
    qe >>= 8;
    // decoding and estimation (D.2.4, D.2.5)
    long temp = ac_a - qe;
    ac_a = temp;
    temp <<= ac_ct;
    if (ac_c >= temp) {
      ac_c -= temp;
      if (ac_a < qe) {  // conditional LPS exchange
        ac_a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        ac_a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (ac_a < 0x8000L) {
      if (ac_a < qe) {  // conditional MPS exchange
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
  void arith_reset_stats() {
    for (int i = 0; i < comps_in_scan; ++i) {
      const Comp& c = comp[scan_comp[i]];
      if (!progressive || (Ss == 0 && Ah == 0)) {
        std::memset(dc_stats[c.dc_tbl], 0, kDcStatBins);
        last_dc[i] = 0;
        dc_context[i] = 0;
      }
      if (!progressive || Ss) std::memset(ac_stats[c.ac_tbl], 0, kAcStatBins);
    }
    ac_c = 0;
    ac_a = 0;
    ac_ct = -16;  // read two initial bytes into C
  }
  // process_restart: the RSTn marker (as the Huffman decoder reads it),
  // then fresh statistics and coder
  void arith_restart() {
    if (unread_marker == 0) unread_marker = next_marker();
    if (unread_marker == 0xD0 + next_restart_num) {
      unread_marker = 0;
    } else {
      resync(next_restart_num);
    }
    next_restart_num = (next_restart_num + 1) & 7;
    arith_reset_stats();
    restarts_to_go = restart_interval;
  }
  // a DC difference (F.1.4.4.1, figures F.19-F.24) into last_dc[slot]
  // (false: a magnitude overflow, the coder stops)
  bool arith_dc_diff(int slot, int tbl) {
    uint8_t* st = dc_stats[tbl] + dc_context[slot];
    if (arith_decode(st) == 0) {
      dc_context[slot] = 0;
      return true;
    }
    const int sign = arith_decode(st + 1);
    st += 2 + sign;
    int m = arith_decode(st);
    if (m != 0) {
      st = dc_stats[tbl] + 20;
      while (arith_decode(st)) {
        if ((m <<= 1) == 0x8000) {
          warn();
          ac_ct = -1;
          return false;
        }
        st += 1;
      }
    }
    if (m < static_cast<int>((1L << arith_dc_L[tbl]) >> 1))
      dc_context[slot] = 0;
    else if (m > static_cast<int>((1L << arith_dc_U[tbl]) >> 1))
      dc_context[slot] = 12 + sign * 4;
    else
      dc_context[slot] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (arith_decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    last_dc[slot] = (last_dc[slot] + v) & 0xffff;
    return true;
  }
  // an AC value after its nonzero decision at index k (figures F.21-F.24);
  // st points at the bin triple of k (false: a magnitude overflow)
  bool arith_ac_value(uint8_t* st, int k, int tbl, int* out) {
    const int sign = arith_decode(fixed_bin);
    st += 2;
    int m = arith_decode(st);
    if (m != 0) {
      if (arith_decode(st)) {
        m <<= 1;
        st = ac_stats[tbl] + (k <= arith_ac_K[tbl] ? 189 : 217);
        while (arith_decode(st)) {
          if ((m <<= 1) == 0x8000) {
            warn();
            ac_ct = -1;
            return false;
          }
          st += 1;
        }
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (arith_decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    *out = v;
    return true;
  }
  void arith_sequential(int16_t** blocks, const int* bcomp, int nblocks) {
    if (ac_ct == -1) return;
    for (int b = 0; b < nblocks; ++b) {
      const int ci = bcomp[b];
      const int slot = scan_slot(ci);
      if (!arith_dc_diff(slot, comp[ci].dc_tbl)) return;
      int16_t* blk = blocks[b];
      blk[0] = static_cast<int16_t>(last_dc[slot]);
      const int tbl = comp[ci].ac_tbl;
      for (int k = 1; k <= 63; ++k) {
        uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
        if (arith_decode(st)) break;  // EOB
        while (arith_decode(st + 1) == 0) {
          st += 3;
          if (++k > 63) {
            warn();
            ac_ct = -1;  // spectral overflow
            return;
          }
        }
        int v;
        if (!arith_ac_value(st, k, tbl, &v)) return;
        blk[kNatural[k]] = static_cast<int16_t>(v);
      }
    }
  }
  void arith_dc_first(int16_t** blocks, const int* bcomp, int nblocks) {
    if (ac_ct == -1) return;
    for (int b = 0; b < nblocks; ++b) {
      const int slot = scan_slot(bcomp[b]);
      if (!arith_dc_diff(slot, comp[bcomp[b]].dc_tbl)) return;
      blocks[b][0] = static_cast<int16_t>(static_cast<unsigned>(last_dc[slot]) << Al);
    }
  }
  void arith_dc_refine(int16_t** blocks, int nblocks) {
    // jdarith.c decodes a refinement bit even after a bad code
    const int p1 = 1 << Al;
    for (int b = 0; b < nblocks; ++b)
      if (arith_decode(fixed_bin)) blocks[b][0] = static_cast<int16_t>(blocks[b][0] | p1);
  }
  void arith_ac_first(int16_t* blk, int tbl) {
    if (ac_ct == -1) return;
    for (int k = Ss; k <= Se; ++k) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (arith_decode(st)) break;  // EOB
      while (arith_decode(st + 1) == 0) {
        st += 3;
        if (++k > Se) {
          warn();
          ac_ct = -1;
          return;
        }
      }
      int v;
      if (!arith_ac_value(st, k, tbl, &v)) return;
      blk[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(v) << Al);
    }
  }
  void arith_ac_refine(int16_t* blk, int tbl) {
    if (ac_ct == -1) return;
    const int p1 = 1 << Al;
    const int m1 = -1 * (1 << Al);
    int kex;  // the previous stage's end of block
    for (kex = Se; kex > 0; kex--)
      if (blk[kNatural[kex]]) break;
    for (int k = Ss; k <= Se; ++k) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (k > kex)
        if (arith_decode(st)) break;  // EOB
      for (;;) {
        int16_t* c = blk + kNatural[k];
        if (*c) {  // a coefficient nonzero before
          if (arith_decode(st + 2)) {
            if (*c < 0) *c = static_cast<int16_t>(*c + m1);
            else *c = static_cast<int16_t>(*c + p1);
          }
          break;
        }
        if (arith_decode(st + 1)) {  // newly nonzero
          *c = static_cast<int16_t>(arith_decode(fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > Se) {
          warn();
          ac_ct = -1;
          return;
        }
      }
    }
  }

  int scan_slot(int ci) const {
    for (int i = 0; i < comps_in_scan; ++i)
      if (scan_comp[i] == ci) return i;
    return 0;
  }

  void get_sos() {
    int length = read_u16();
    int n = read_byte();
    if (length != n * 2 + 6 || n < 1 || n > 4) fail(kCorrupt, "bad SOS length");
    comps_in_scan = n;
    for (int i = 0; i < n; ++i) {
      int cc = read_byte();
      int tables = read_byte();
      for (int j = 0; j < i; ++j)
        if (comp[scan_comp[j]].id == cc) fail(kCorrupt, "bad component id");
      int ci = -1;
      for (int k = 0; k < ncomp; ++k)
        if (comp[k].id == cc) ci = k;
      if (ci < 0) fail(kCorrupt, "bad component id");
      scan_comp[i] = ci;
      comp[ci].dc_tbl = tables >> 4;
      comp[ci].ac_tbl = tables & 15;
      // 16 arithmetic conditioning tables, 4 Huffman tables
      if (!arith && (comp[ci].dc_tbl >= 4 || comp[ci].ac_tbl >= 4))
        fail(kCorrupt, "bad table index");
    }
    Ss = read_byte();
    Se = read_byte();
    int a = read_byte();
    Ah = a >> 4;
    Al = a & 15;
    next_restart_num = 0;
  }

  // one scan: returns false when the baseline decode may stop (row limit)
  void run_scan() {
    scan_number++;
    // latch quantization tables at a component's first scan (jdinput.c)
    for (int i = 0; i < comps_in_scan; ++i) {
      Comp& c = comp[scan_comp[i]];
      if (c.latched) continue;
      if (!qt_defined[c.tq]) fail(kCorrupt, "a component's quantization table is not defined");
      std::memcpy(qt_out + 64 * scan_comp[i], qt[c.tq], sizeof(uint16_t) * 64);
      c.latched = true;
    }
    if (progressive) {
      bool bad = false;
      bool is_dc = Ss == 0;
      if (is_dc) {
        if (Se != 0) bad = true;
      } else {
        if (Ss > Se || Se >= 64) bad = true;
        if (comps_in_scan != 1) bad = true;
      }
      if (Ah != 0 && Al != Ah - 1) bad = true;
      if (Al > 13) bad = true;
      if (bad) fail(kCorrupt, "bad progression parameters");
      for (int i = 0; i < comps_in_scan; ++i) {
        int* bitsp = coef_bits[scan_comp[i]];
        int* prevp = prev_bits[scan_comp[i]];
        for (int k = std::min(Ss, 1); k <= std::max(Se, 9); ++k)
          prevp[k] = scan_number > 1 ? bitsp[k] : 0;
        for (int k = Ss; k <= Se; ++k) bitsp[k] = Al;
      }
      for (int i = 0; i < comps_in_scan && !arith; ++i) {
        Comp& c = comp[scan_comp[i]];
        if (is_dc) {
          if (Ah == 0) derive(&dc[c.dc_tbl], true, c.dc_tbl);
        } else {
          derive(&ac[c.ac_tbl], false, c.ac_tbl);
        }
      }
    } else {
      if (Ss != 0 || Se != 63 || Ah != 0 || Al != 0) warn();
      for (int i = 0; i < comps_in_scan && !arith; ++i) {
        Comp& c = comp[scan_comp[i]];
        derive(&dc[c.dc_tbl], true, c.dc_tbl);
        derive(&ac[c.ac_tbl], false, c.ac_tbl);
      }
    }
    // start of scan: bit buffer, DC predictions, EOB run, restarts
    buf = 0;
    bits = 0;
    insufficient = false;
    for (int i = 0; i < 4; ++i) last_dc[i] = 0;
    eobrun = 0;
    restarts_to_go = restart_interval;
    if (arith) arith_reset_stats();

    int16_t* blocks[10];
    int bcomp[10];
    static thread_local int16_t dummy[64];
    if (comps_in_scan == 1) {
      int ci = scan_comp[0];
      Comp& c = comp[ci];
      int rows = c.bh;
      if (max_mcu_rows >= 0 && !progressive && f->single_scan)
        rows = std::min(rows, max_mcu_rows);
      for (int by = 0; by < rows; ++by) {
        for (int bx = 0; bx < c.bw; ++bx) {
          if (restart_interval) {
            if (restarts_to_go == 0) arith ? arith_restart() : process_restart();
          }
          if (!insufficient) last_good_imcu = by / c.v;
          int16_t* blk = block_at(ci, by, bx);
          if (arith) {
            blocks[0] = blk;
            bcomp[0] = ci;
            if (!progressive) {
              std::memset(blk, 0, 128);
              arith_sequential(blocks, bcomp, 1);
            } else if (Ss == 0) {
              if (Ah == 0) arith_dc_first(blocks, bcomp, 1);
              else arith_dc_refine(blocks, 1);
            } else if (Ah == 0) {
              arith_ac_first(blk, c.ac_tbl);
            } else {
              arith_ac_refine(blk, c.ac_tbl);
            }
          } else if (!progressive) {
            std::memset(blk, 0, 128);
            blocks[0] = blk;
            bcomp[0] = ci;
            mcu_sequential(blocks, bcomp, 1);
          } else if (Ss == 0) {
            blocks[0] = blk;
            bcomp[0] = ci;
            if (Ah == 0) mcu_dc_first(blocks, bcomp, 1);
            else mcu_dc_refine(blocks, 1);
          } else if (Ah == 0) {
            mcu_ac_first(blk, ac[c.ac_tbl]);
          } else {
            mcu_ac_refine(blk, ac[c.ac_tbl]);
          }
          if (restart_interval) restarts_to_go--;
        }
      }
    } else {
      int nblocks = 0;
      for (int i = 0; i < comps_in_scan; ++i)
        nblocks += comp[scan_comp[i]].h * comp[scan_comp[i]].v;
      if (nblocks > 10) fail(kCorrupt, "bad MCU size");
      int rows = f->mcus_y;
      if (max_mcu_rows >= 0 && !progressive && f->single_scan)
        rows = std::min(rows, max_mcu_rows);
      for (int my = 0; my < rows; ++my) {
        for (int mx = 0; mx < f->mcus_x; ++mx) {
          if (restart_interval) {
            if (restarts_to_go == 0) arith ? arith_restart() : process_restart();
          }
          if (!insufficient) last_good_imcu = my;
          int b = 0;
          for (int i = 0; i < comps_in_scan; ++i) {
            int ci = scan_comp[i];
            Comp& c = comp[ci];
            for (int y = 0; y < c.v; ++y)
              for (int x = 0; x < c.h; ++x) {
                int by = my * c.v + y, bx = mx * c.h + x;
                int16_t* blk = block_at(ci, by, bx);
                // blocks past the component's own are dummies: decoded,
                // and (single-pass) never shown
                if (!progressive && (by >= c.bh || bx >= c.bw)) blk = dummy;
                if (!progressive) std::memset(blk, 0, 128);
                blocks[b] = blk;
                bcomp[b] = ci;
                ++b;
              }
          }
          if (arith) {
            if (!progressive) arith_sequential(blocks, bcomp, nblocks);
            else if (Ah == 0) arith_dc_first(blocks, bcomp, nblocks);
            else arith_dc_refine(blocks, nblocks);
          } else if (!progressive) {
            mcu_sequential(blocks, bcomp, nblocks);
          } else if (Ah == 0) {
            mcu_dc_first(blocks, bcomp, nblocks);
          } else {
            mcu_dc_refine(blocks, nblocks);
          }
          if (restart_interval) restarts_to_go--;
        }
      }
    }
  }
};


// --- block smoothing (jdcoefct.c smoothing_ok, decompress_smooth_data):
// libjpeg-turbo estimates the first AC coefficients of a progressive
// file's blocks that are not known to full precision (a file cut before
// its last scans) from the DC values of the 5x5 blocks around each, and,
// where no AC data came at all, the DC too. first_col[c] is the first
// block column a window decode transforms (jpeg_crop_scanline's
// first_MCU_col: the DC window replicates there as at the frame's left).

constexpr int kSaved = 10;  // SAVED_COEFS
// natural positions of the first 9 zigzag coefficients
constexpr int kQ01 = 1, kQ10 = 8, kQ20 = 16, kQ11 = 9, kQ02 = 2, kQ03 = 3, kQ12 = 10,
              kQ21 = 17, kQ30 = 24;

inline int estimate(long q00, long qk, long sum, int al, bool clamp) {
  const long num = q00 * sum;
  int pred;
  if (num >= 0) {
    pred = static_cast<int>(((qk << 7) + num) / (qk << 8));
    if (clamp && al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  } else {
    pred = static_cast<int>(((qk << 7) - num) / (qk << 8));
    if (clamp && al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    pred = -pred;
  }
  return pred;
}

void smooth_blocks(Reader& r, const int* first_col) {
  if (!r.progressive) return;
  int latch[4][kSaved], prev_latch[4][kSaved];
  bool useful = false;
  static const int qpos[10] = {0, kQ01, kQ10, kQ20, kQ11, kQ02, kQ03, kQ12, kQ21, kQ30};
  for (int c = 0; c < r.ncomp; ++c) {
    const uint16_t* q = r.qt_out + 64 * c;
    if (!r.comp[c].latched) return;  // a quantization table not latched
    for (int k = 0; k < 10; ++k)
      if (q[qpos[k]] == 0) return;
    if (r.coef_bits[c][0] < 0) return;
    latch[c][0] = r.coef_bits[c][0];
    for (int k = 1; k < kSaved; ++k) {
      prev_latch[c][k] = r.scan_number > 1 ? r.prev_bits[c][k] : -1;
      latch[c][k] = r.coef_bits[c][k];
      if (r.coef_bits[c][k] != 0) useful = true;
    }
  }
  if (!useful) return;
  for (int c = 0; c < r.ncomp; ++c) {
    Comp& cp = r.comp[c];
    const long Q00 = r.qt_out[64 * c], Q01 = r.qt_out[64 * c + kQ01],
               Q10 = r.qt_out[64 * c + kQ10], Q20 = r.qt_out[64 * c + kQ20],
               Q11 = r.qt_out[64 * c + kQ11], Q02 = r.qt_out[64 * c + kQ02],
               Q03 = r.qt_out[64 * c + kQ03], Q12 = r.qt_out[64 * c + kQ12],
               Q21 = r.qt_out[64 * c + kQ21], Q30 = r.qt_out[64 * c + kQ30];
    // the DC values as decoded (the estimates read these, never their own)
    std::vector<int> dcv(static_cast<size_t>(cp.aw) * cp.ah);
    for (int y = 0; y < cp.ah; ++y)
      for (int x = 0; x < cp.aw; ++x)
        dcv[static_cast<size_t>(y) * cp.aw + x] = r.block_at(c, y, x)[0];
    auto dc = [&](int y, int x) { return dcv[static_cast<size_t>(y) * cp.aw + x]; };
    const int v = cp.v;
    const int total_imcu = r.f->mcus_y;
    const int last_col = cp.bw - 1;
    const int x0 = first_col ? first_col[c] : 0;
    for (int imcu = 0; imcu < total_imcu; ++imcu) {
      int block_rows = v;
      if (imcu == total_imcu - 1) {
        block_rows = cp.bh % v;
        if (block_rows == 0) block_rows = v;
      }
      const int* cb = imcu > r.last_good_imcu ? prev_latch[c] : latch[c];
      const bool change_dc = cb[1] == -1 && cb[2] == -1 && cb[3] == -1 && cb[4] == -1 &&
                             cb[5] == -1 && cb[6] == -1 && cb[7] == -1 && cb[8] == -1 &&
                             cb[9] == -1;
      const int last_imcu = total_imcu - 1;
      for (int br = 0; br < block_rows; ++br) {
        const int row = imcu * v + br;
        // the rows around, as decompress_smooth_data picks them: by the
        // block row within the iMCU row and the iMCU row apart (so with 2
        // block rows an iMCU row, the second iMCU row's rows 2 above are
        // the row above, and likewise below the second-to-last one)
        const int rp = (br > 0 || imcu > 0) ? row - 1 : row;
        const int rpp = (br > 1 || imcu > 1) ? row - 2 : rp;
        const int rn = (br < block_rows - 1 || imcu < last_imcu) ? row + 1 : row;
        const int rnn = (br < block_rows - 2 || imcu + 1 < last_imcu) ? row + 2 : rn;
        const int rowsv[5] = {rpp, rp, row, rn, rnn};
        int D[5][5];  // [row -2..2][column -2..2]
        for (int k = 0; k < 5; ++k)
          for (int j = 0; j < 5; ++j) D[k][j] = dc(rowsv[k], x0);
        for (int bx = x0; bx <= last_col; ++bx) {
          if (bx == x0 && bx < last_col)
            for (int k = 0; k < 5; ++k) D[k][3] = dc(rowsv[k], bx + 1);
          if (bx + 1 < last_col)
            for (int k = 0; k < 5; ++k) D[k][4] = dc(rowsv[k], bx + 2);
          int16_t* w = r.block_at(c, row, bx);
#define DCV(n) D[((n) - 1) / 5][((n) - 1) % 5]
          const long DC01 = DCV(1), DC02 = DCV(2), DC03 = DCV(3), DC04 = DCV(4), DC05 = DCV(5),
                     DC06 = DCV(6), DC07 = DCV(7), DC08 = DCV(8), DC09 = DCV(9),
                     DC10 = DCV(10), DC11 = DCV(11), DC12 = DCV(12), DC13 = DCV(13),
                     DC14 = DCV(14), DC15 = DCV(15), DC16 = DCV(16), DC17 = DCV(17),
                     DC18 = DCV(18), DC19 = DCV(19), DC20 = DCV(20), DC21 = DCV(21),
                     DC22 = DCV(22), DC23 = DCV(23), DC24 = DCV(24), DC25 = DCV(25);
#undef DCV
          int al;
          if ((al = cb[1]) != 0 && w[1] == 0)
            w[1] = static_cast<int16_t>(estimate(Q00, Q01, change_dc ?
                (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 + 3 * DC10 -
                 3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 -
                 13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25) :
                (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15), al, true));
          if ((al = cb[2]) != 0 && w[8] == 0)
            w[8] = static_cast<int16_t>(estimate(Q00, Q10, change_dc ?
                (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 +
                 38 * DC08 + 13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 +
                 DC20 + DC21 + 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25) :
                (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23), al, true));
          if ((al = cb[3]) != 0 && w[16] == 0)
            w[16] = static_cast<int16_t>(estimate(Q00, Q20, change_dc ?
                (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 - 5 * DC14 +
                 2 * DC17 + 7 * DC18 + 2 * DC19 + DC23) :
                (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23), al, true));
          if ((al = cb[4]) != 0 && w[9] == 0)
            w[9] = static_cast<int16_t>(estimate(Q00, Q11, change_dc ?
                (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 - DC25) :
                (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 + DC04 -
                 DC06 + 10 * DC07 - 10 * DC09), al, true));
          if ((al = cb[5]) != 0 && w[2] == 0)
            w[2] = static_cast<int16_t>(estimate(Q00, Q02, change_dc ?
                (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 + 7 * DC14 +
                 DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19) :
                (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15), al, true));
          if (change_dc) {
            if ((al = cb[6]) != 0 && w[3] == 0)
              w[3] = static_cast<int16_t>(estimate(
                  Q00, Q03, DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19, al, true));
            if ((al = cb[7]) != 0 && w[10] == 0)
              w[10] = static_cast<int16_t>(estimate(
                  Q00, Q12, DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19, al, true));
            if ((al = cb[8]) != 0 && w[17] == 0)
              w[17] = static_cast<int16_t>(estimate(
                  Q00, Q21, DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19, al, true));
            if ((al = cb[9]) != 0 && w[24] == 0)
              w[24] = static_cast<int16_t>(estimate(
                  Q00, Q30, DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19, al, true));
            w[0] = static_cast<int16_t>(estimate(Q00, Q00,
                -2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 +
                6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 +
                152 * DC13 + 42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 +
                6 * DC19 - 6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 -
                2 * DC25, 0, false));
          }
          // the next column: the window slides left
          for (int k = 0; k < 5; ++k)
            for (int j = 0; j < 4; ++j) D[k][j] = D[k][j + 1];
        }
      }
    }
  }
}

int parse_to_first_scan(Reader& r) {
  if (r.n < 2 || r.d[0] != 0xFF || r.d[1] != 0xD8) r.fail(kCorrupt, "not a JPEG (no SOI)");
  r.pos = 2;
  int m = r.read_markers();
  if (m != 0xDA) r.fail(kCorrupt, "no image in the file");
  r.setup_frame();
  r.color_space();
  return m;
}

void init_reader(Reader& r, const uint8_t* data, size_t len, FlJpegFrame* f) {
  std::memset(static_cast<void*>(&r), 0, sizeof(Reader));
  r.d = data;
  r.n = len;
  r.f = f;
  r.max_mcu_rows = -1;
  for (int i = 0; i < kArithTables; ++i) {
    r.arith_dc_L[i] = 0;
    r.arith_dc_U[i] = 1;
    r.arith_ac_K[i] = 5;
  }
  r.fixed_bin[0] = 113;
}

int decode_one(const uint8_t* data, size_t len, FlJpegFrame* f, int max_mcu_rows,
               const int* first_col, int16_t* coefs, uint16_t* qt_out) {
  Reader* rp = new Reader;
  Reader& r = *rp;
  int status = kOk;
  try {
    init_reader(r, data, len, f);
    f->warnings = 0;
    f->error[0] = 0;
    r.max_mcu_rows = max_mcu_rows;
    r.qt_out = qt_out;
    parse_to_first_scan(r);
    size_t off = 0;
    for (int i = 0; i < r.ncomp; ++i) {
      if (r.comp[i].aw != f->alloc_w[i] || r.comp[i].ah != f->alloc_h[i])
        r.fail(kCorrupt, "the frame differs from its header");
      r.comp[i].coef = coefs + off;
      off += static_cast<size_t>(r.comp[i].aw) * r.comp[i].ah * 64;
    }
    std::memset(coefs, 0, off * sizeof(int16_t));
    std::memset(qt_out, 0, sizeof(uint16_t) * 64 * r.ncomp);
    for (int i = 0; i < 4; ++i)
      for (int k = 0; k < 64; ++k) r.coef_bits[i][k] = -1;
    for (;;) {
      r.get_sos();
      r.run_scan();
      if (!r.progressive && f->single_scan) {
        // one scan has it all; a whole-image decode reads on to EOI as
        // jpeg_finish_decompress does, where a second scan or an unknown
        // marker is an error (a window decode aborts instead)
        if (max_mcu_rows < 0 && r.read_markers() != 0xD9)
          r.fail(kCorrupt, "EOI expected after the only scan");
        break;
      }
      int m = r.read_markers();
      if (m == 0xD9) break;
    }
    // a component no scan named keeps zero coefficients and a zero table
    // (jddctmgr.c leaves its multiplier table zero)
    smooth_blocks(r, first_col);
  } catch (const Fail& e) {
    status = e.status;
  }
  delete rp;
  return status;
}

}  // namespace

extern "C" {

// Reads the markers up to the first scan: the frame's size, components,
// sampling factors, colour space and coefficient grid. Returns 0, or 1
// (unsupported: lossless or hierarchical, 12-bit, more than 4 components)
// or 2 (not a decodable JPEG), with f->error saying why.
int fl_jpeg_header(const uint8_t* data, size_t len, FlJpegFrame* f) {
  std::memset(f, 0, sizeof(*f));
  Reader* rp = new Reader;
  Reader& r = *rp;
  int status = kOk;
  try {
    init_reader(r, data, len, f);
    parse_to_first_scan(r);
    r.get_sos();
    // libjpeg's has_multiple_scans is false for a sequential file whose
    // first scan holds every component
    f->single_scan = (!r.progressive && r.comps_in_scan == r.ncomp) ? 1 : 0;
  } catch (const Fail& e) {
    status = e.status;
  }
  delete rp;
  return status;
}

// Entropy-decodes a file whose frame fl_jpeg_header read into `f`:
// coefficients into `coefs` (sum of alloc_w * alloc_h * 64 int16 over the
// components), each component's quantization table (natural order) into
// `qt` (ncomp x 64). `max_mcu_rows` >= 0 stops a single-scan file after
// that many MCU rows (-1: all). first_col (4 ints, or null for 0) is each
// component's first block column a window decode transforms (block
// smoothing replicates its DC window there). Returns 0, 1 or 2 as
// fl_jpeg_header.
int fl_jpeg_decode(const uint8_t* data, size_t len, FlJpegFrame* f, int max_mcu_rows,
                   const int* first_col, int16_t* coefs, uint16_t* qt) {
  return decode_one(data, len, f, max_mcu_rows, first_col, coefs, qt);
}

// fl_jpeg_decode for n files on up to `threads` threads (first_cols: 4
// ints a file, or null); rcs[i] is file i's return code.
void fl_jpeg_decode_batch(int n, const uint8_t* const* datas, const size_t* lens,
                          FlJpegFrame* frames, const int* max_mcu_rows,
                          const int* first_cols, int16_t* const* coefs,
                          uint16_t* const* qts, int* rcs, int threads) {
  std::atomic<int> next{0};
  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      rcs[i] = decode_one(datas[i], lens[i], &frames[i], max_mcu_rows[i],
                          first_cols ? first_cols + 4 * i : nullptr, coefs[i], qts[i]);
    }
  };
  int t = std::max(1, std::min(threads, n));
  std::vector<std::thread> pool;
  for (int k = 1; k < t; ++k) pool.emplace_back(work);
  work();
  for (auto& th : pool) th.join();
}

}  // extern "C"
