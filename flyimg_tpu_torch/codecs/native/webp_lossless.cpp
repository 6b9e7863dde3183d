// Lossless WebP (VP8L) encode and decode for the port's host codec layer.
//
// The machine with the card has no libwebp, so the port carries its own
// codec for the WebP container's lossless bitstream (the WebP Lossless
// Bitstream Specification, RFC 9649). Its entries (webp_lossless.h) are
// called by webp_lossy.cpp, built into the same library, which reads and
// writes the container and holds the plain C interface for ctypes. No global
// state, so calls may run from many threads at once.
//
// Encoder: the subtract-green transform, then the predictor transform over
// 16x16 tiles (each tile takes the one of the 14 predictors whose residuals
// on every fourth row have the least sum of magnitudes), then the residuals as literals under
// one group of five canonical prefix codes (lengths limited to 15, built
// from the image's own histograms; a code with one symbol is the 0-bit
// simple code). No backward references and no colour cache.
//
// Decoder: the whole bitstream (all four transforms, colour cache, meta
// prefix codes, backward references) of a "VP8L" chunk, and the headerless
// stream of an ALPH chunk. The container is read by webp_lossy.cpp, which
// is built into the same library and also holds the lossy codec.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <queue>
#include <vector>

#include "webp_lossless.h"

namespace {

// ------------------------------------------------------------------ common

constexpr int kNumLiteral = 256;
constexpr int kNumLengthCodes = 24;
constexpr int kNumDistanceCodes = 40;
constexpr int kMaxCodeLength = 15;
constexpr int kCodeLengthCodes = 19;
constexpr int kCodeLengthOrder[kCodeLengthCodes] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                                    7,  8,  9, 10, 11, 12, 13, 14, 15};
constexpr uint32_t kBlack = 0xff000000u;

enum { kPredictor = 0, kCrossColor = 1, kSubtractGreen = 2, kColorIndexing = 3 };

inline uint32_t argb(uint32_t a, uint32_t r, uint32_t g, uint32_t b) {
    return (a << 24) | (r << 16) | (g << 8) | b;
}
inline uint32_t ch(uint32_t p, int shift) { return (p >> shift) & 0xff; }

// per-channel (a + b) / 2, truncated
inline uint32_t average2(uint32_t a, uint32_t b) {
    return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline uint32_t clamp255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : (uint32_t)v); }

uint32_t select_pred(uint32_t L, uint32_t T, uint32_t TL) {
    int pl = 0, pt = 0;
    for (int s = 0; s < 32; s += 8) {
        const int p = (int)ch(L, s) + (int)ch(T, s) - (int)ch(TL, s);
        pl += std::abs(p - (int)ch(L, s));
        pt += std::abs(p - (int)ch(T, s));
    }
    return pl < pt ? L : T;
}

uint32_t clamp_add_sub_full(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8)
        out |= clamp255((int)ch(a, s) + (int)ch(b, s) - (int)ch(c, s)) << s;
    return out;
}

uint32_t clamp_add_sub_half(uint32_t a, uint32_t b) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
        const int x = (int)ch(a, s), y = (int)ch(b, s);
        out |= clamp255(x + (x - y) / 2) << s;
    }
    return out;
}

// the prediction of mode `mode` from the left, top, top-left and top-right
// pixels (the caller handles the first row and column)
uint32_t predict(int mode, uint32_t L, uint32_t T, uint32_t TL, uint32_t TR) {
    switch (mode) {
        case 1: return L;
        case 2: return T;
        case 3: return TR;
        case 4: return TL;
        case 5: return average2(average2(L, TR), T);
        case 6: return average2(L, TL);
        case 7: return average2(L, T);
        case 8: return average2(TL, T);
        case 9: return average2(T, TR);
        case 10: return average2(average2(L, TL), average2(T, TR));
        case 11: return select_pred(L, T, TL);
        case 12: return clamp_add_sub_full(L, T, TL);
        case 13: return clamp_add_sub_half(average2(L, T), TL);
        default: return kBlack;
    }
}

// per-channel a + b and a - b, mod 256
inline uint32_t add_pixels(uint32_t a, uint32_t b) {
    const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
    const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
    return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t sub_pixels(uint32_t a, uint32_t b) {
    const uint32_t ag = 0x00ff00ffu + (a & 0xff00ff00u) - (b & 0xff00ff00u);
    const uint32_t rb = 0xff00ff00u + (a & 0x00ff00ffu) - (b & 0x00ff00ffu);
    return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

// the prediction of pixel i (x, y) of a w-wide image from decoded pixels
inline uint32_t predict_at(const uint32_t* px, int w, int x, int y, long long i, int mode) {
    if (y == 0) return x == 0 ? kBlack : px[i - 1];
    if (x == 0) return px[i - w];
    // on the last column the top-right pixel is the first of this row (the
    // pixel right after the top neighbour in memory)
    return predict(mode, px[i - 1], px[i - w], px[i - w - 1], px[i - w + 1]);
}

inline int div_round_up(int n, int bits) { return (n + (1 << bits) - 1) >> bits; }

// ------------------------------------------------------------------ encoder

struct BitWriter {
    std::vector<uint8_t> buf;
    uint64_t acc = 0;
    int n = 0;
    void put(uint32_t bits, int nbits) {
        acc |= (uint64_t)bits << n;
        n += nbits;
        while (n >= 8) {
            buf.push_back((uint8_t)acc);
            acc >>= 8;
            n -= 8;
        }
    }
    void flush() {
        if (n > 0) buf.push_back((uint8_t)acc);
        acc = 0, n = 0;
    }
};

// code lengths of a Huffman code for `hist`, none longer than `limit`
// (counts raised to a floor that doubles until the tree is shallow enough)
std::vector<int> code_lengths(const std::vector<uint32_t>& hist, int limit) {
    const int n = (int)hist.size();
    std::vector<int> len(n, 0);
    std::vector<int> used;
    for (int s = 0; s < n; ++s)
        if (hist[s]) used.push_back(s);
    if (used.size() == 1) {
        len[used[0]] = 1;
        return len;
    }
    for (uint64_t floor = 1;; floor *= 2) {
        // nodes: leaves first, then inner nodes; parent links give depths
        std::vector<int> parent(2 * used.size(), -1);
        using Item = std::pair<uint64_t, int>;  // (weight, node), ties by node
        std::priority_queue<Item, std::vector<Item>, std::greater<Item>> pq;
        for (size_t k = 0; k < used.size(); ++k)
            pq.push({std::max<uint64_t>(hist[used[k]], floor), (int)k});
        int next = (int)used.size();
        while (pq.size() > 1) {
            const Item a = pq.top();
            pq.pop();
            const Item b = pq.top();
            pq.pop();
            parent[a.second] = parent[b.second] = next;
            pq.push({a.first + b.first, next++});
        }
        int deepest = 0;
        for (size_t k = 0; k < used.size(); ++k) {
            int d = 0;
            for (int v = (int)k; parent[v] >= 0; v = parent[v]) ++d;
            len[used[k]] = d;
            deepest = std::max(deepest, d);
        }
        if (deepest <= limit) return len;
    }
}

// canonical codes of `len`, bit-reversed so they go out LSB first
std::vector<uint32_t> canonical_codes(const std::vector<int>& len) {
    int count[kMaxCodeLength + 2] = {0};
    for (int l : len) count[l]++;
    count[0] = 0;
    uint32_t next[kMaxCodeLength + 2] = {0};
    uint32_t code = 0;
    for (int b = 1; b <= kMaxCodeLength; ++b) {
        code = (code + count[b - 1]) << 1;
        next[b] = code;
    }
    std::vector<uint32_t> out(len.size(), 0);
    for (size_t s = 0; s < len.size(); ++s) {
        const int l = len[s];
        if (!l) continue;
        uint32_t c = next[l]++, r = 0;
        for (int b = 0; b < l; ++b) r |= ((c >> b) & 1u) << (l - 1 - b);
        out[s] = r;
    }
    return out;
}

struct PrefixCode {
    std::vector<int> len;
    std::vector<uint32_t> code;
    bool zero_bits = false;  // one symbol: nothing is written for it
    void put(BitWriter& bw, int sym) const {
        if (!zero_bits) bw.put(code[sym], len[sym]);
    }
};

// write the prefix code of `hist` (an alphabet of hist.size() symbols) and
// return it
PrefixCode write_code(BitWriter& bw, const std::vector<uint32_t>& hist) {
    PrefixCode pc;
    std::vector<int> used;
    for (int s = 0; s < (int)hist.size(); ++s)
        if (hist[s]) used.push_back(s);
    if (used.empty()) used.push_back(0);
    if (used.size() <= 2 && used.back() < 256) {
        // simple code: one symbol (0 bits) or two (1 bit each)
        bw.put(1, 1);
        bw.put((uint32_t)used.size() - 1, 1);
        const int first_8 = used[0] > 1 ? 1 : 0;
        bw.put(first_8, 1);
        bw.put(used[0], first_8 ? 8 : 1);
        pc.len.assign(hist.size(), 0);
        if (used.size() == 2) {
            bw.put(used[1], 8);
            pc.len[used[0]] = pc.len[used[1]] = 1;
            pc.code = canonical_codes(pc.len);
        } else {
            pc.zero_bits = true;
        }
        return pc;
    }
    pc.len = code_lengths(hist, kMaxCodeLength);
    pc.code = canonical_codes(pc.len);
    // the lengths as tokens: 0-15 literally, runs of zeros as 17 / 18
    std::vector<std::pair<int, int>> tokens;  // (symbol, extra bits value)
    const int n = (int)pc.len.size();
    for (int s = 0; s < n;) {
        if (pc.len[s] == 0) {
            int run = 0;
            while (s + run < n && pc.len[s + run] == 0) ++run;
            int left = run;
            while (left >= 11) {
                const int r = std::min(left, 138);
                tokens.push_back({18, r - 11});
                left -= r;
            }
            while (left >= 3) {
                const int r = std::min(left, 10);
                tokens.push_back({17, r - 3});
                left -= r;
            }
            for (; left > 0; --left) tokens.push_back({0, 0});
            s += run;
        } else {
            tokens.push_back({pc.len[s], 0});
            ++s;
        }
    }
    std::vector<uint32_t> th(kCodeLengthCodes, 0);
    for (auto& t : tokens) th[t.first]++;
    std::vector<int> tlen = code_lengths(th, 7);
    int distinct = 0;
    for (int l : tlen) distinct += l > 0;
    const std::vector<uint32_t> tcode = canonical_codes(tlen);
    int num = kCodeLengthCodes;
    while (num > 4 && tlen[kCodeLengthOrder[num - 1]] == 0) --num;
    bw.put(0, 1);  // normal code
    bw.put(num - 4, 4);
    for (int k = 0; k < num; ++k) bw.put(tlen[kCodeLengthOrder[k]], 3);
    bw.put(0, 1);  // the tokens fill the whole alphabet
    for (auto& t : tokens) {
        if (distinct > 1) bw.put(tcode[t.first], tlen[t.first]);
        if (t.first == 17) bw.put(t.second, 3);
        if (t.first == 18) bw.put(t.second, 7);
    }
    return pc;
}

// an entropy-coded image of literals: five prefix codes, then the pixels
void write_image_data(BitWriter& bw, const std::vector<uint32_t>& px) {
    std::vector<uint32_t> hg(kNumLiteral + kNumLengthCodes, 0), hr(256, 0), hb(256, 0),
        ha(256, 0), hd(kNumDistanceCodes, 0);
    for (uint32_t p : px) {
        hg[ch(p, 8)]++, hr[ch(p, 16)]++, hb[ch(p, 0)]++, ha[ch(p, 24)]++;
    }
    const PrefixCode g = write_code(bw, hg), r = write_code(bw, hr), b = write_code(bw, hb),
                     a = write_code(bw, ha);
    write_code(bw, hd);
    for (uint32_t p : px) {
        g.put(bw, ch(p, 8));
        r.put(bw, ch(p, 16));
        b.put(bw, ch(p, 0));
        a.put(bw, ch(p, 24));
    }
}

constexpr int kTileBits = 4;
// a tile's predictor is chosen from every fourth row's residuals: nearly
// the size of a search over every row, at about a third of its time
constexpr int kCostRowStep = 4;

// the image stream after the header: the transforms (subtract green when
// `subtract_green`, then the predictor per tile) and the residuals of the
// w x h ARGB pixels `px`
void write_stream(BitWriter& bw, std::vector<uint32_t> px, int w, int h, bool subtract_green) {
    const long long n = (long long)w * h;
    if (subtract_green)  // red and blue minus green
        for (uint32_t& p : px)
            p = (p & 0xff00ff00u) | (((ch(p, 16) - ch(p, 8)) & 0xff) << 16) |
                ((ch(p, 0) - ch(p, 8)) & 0xff);
    // the predictor per tile
    const int tw = div_round_up(w, kTileBits), tht = div_round_up(h, kTileBits);
    std::vector<uint32_t> modes((size_t)tw * tht);
    std::vector<uint32_t> res(n);
    for (int ty = 0; ty < tht; ++ty)
        for (int tx = 0; tx < tw; ++tx) {
            const int x0 = tx << kTileBits, y0 = ty << kTileBits;
            const int x1 = std::min(w, x0 + (1 << kTileBits));
            const int y1 = std::min(h, y0 + (1 << kTileBits));
            int best = 0;
            long long best_cost = -1;
            for (int mode = 0; mode < 14; ++mode) {
                long long cost = 0;
                for (int y = y0; y < y1; y += kCostRowStep)
                    for (int x = x0; x < x1; ++x) {
                        const long long i = (long long)y * w + x;
                        const uint32_t d = sub_pixels(px[i], predict_at(px.data(), w, x, y, i, mode));
                        for (int s = 0; s < 32; s += 8) {
                            const int v = (int)ch(d, s);
                            cost += v < 128 ? v : 256 - v;
                        }
                    }
                if (best_cost < 0 || cost < best_cost) best = mode, best_cost = cost;
            }
            modes[(size_t)ty * tw + tx] = (uint32_t)best << 8;
            for (int y = y0; y < y1; ++y)
                for (int x = x0; x < x1; ++x) {
                    const long long i = (long long)y * w + x;
                    res[i] = sub_pixels(px[i], predict_at(px.data(), w, x, y, i, best));
                }
        }
    // transforms, inverted by the decoder in reverse order
    if (subtract_green) {
        bw.put(1, 1);
        bw.put(kSubtractGreen, 2);
    }
    bw.put(1, 1);
    bw.put(kPredictor, 2);
    bw.put(kTileBits - 2, 3);
    bw.put(0, 1);  // the tile image: no colour cache
    write_image_data(bw, modes);
    bw.put(0, 1);  // no more transforms
    bw.put(0, 1);  // no colour cache
    bw.put(0, 1);  // no meta prefix codes
    write_image_data(bw, res);
}

// ------------------------------------------------------------------ decoder

// LSB-first bits; past the end it reads zeros and sets `eos`
struct BitReader {
    const uint8_t* p;
    size_t len, pos = 0;
    uint64_t acc = 0, consumed = 0;
    int n = 0;
    bool eos = false;
    BitReader(const uint8_t* data, size_t size) : p(data), len(size) {}
    void fill() {
        for (; n <= 56; n += 8, ++pos) acc |= (uint64_t)(pos < len ? p[pos] : 0) << n;
    }
    uint32_t peek(int bits) {
        if (n < bits) fill();
        return (uint32_t)(acc & ((1ull << bits) - 1));
    }
    void skip(int bits) {
        if (n < bits) fill();
        acc >>= bits;
        n -= bits;
        consumed += bits;
        if (consumed > (uint64_t)len * 8) eos = true;
    }
    uint32_t get(int bits) {
        if (bits == 0) return 0;
        const uint32_t v = peek(bits);
        skip(bits);
        return v;
    }
};

constexpr int kLookBits = 8;

struct Decoder {
    // canonical decode: a table for codes up to kLookBits, then by length
    std::vector<uint16_t> table;  // (symbol << 4) | length, length 0 = longer
    int first[kMaxCodeLength + 1] = {0}, count[kMaxCodeLength + 1] = {0},
        offset[kMaxCodeLength + 1] = {0};
    std::vector<int> sorted;
    int single = -1;  // the symbol of a 0-bit code
    bool ok = false;

    bool build(const std::vector<int>& len) {
        ok = false;
        std::vector<int> used;
        for (int s = 0; s < (int)len.size(); ++s)
            if (len[s]) used.push_back(s);
        if (used.empty()) return false;
        if (used.size() == 1) {
            single = used[0];
            return ok = true;
        }
        std::fill(count, count + kMaxCodeLength + 1, 0);
        for (int s : used) count[len[s]]++;
        // a complete code only
        long long left = 1;
        for (int b = 1; b <= kMaxCodeLength; ++b) {
            left = left * 2 - count[b];
            if (left < 0) return false;
        }
        if (left != 0) return false;
        int code = 0, idx = 0;
        for (int b = 1; b <= kMaxCodeLength; ++b) {
            first[b] = code;
            offset[b] = idx;
            idx += count[b];
            code = (code + count[b]) << 1;
        }
        sorted.assign(used.size(), 0);
        int fill[kMaxCodeLength + 1];
        std::copy(offset, offset + kMaxCodeLength + 1, fill);
        for (int s : used) sorted[fill[len[s]]++] = s;
        table.assign(1 << kLookBits, 0);
        for (int b = 1; b <= kLookBits; ++b)
            for (int k = 0; k < count[b]; ++k) {
                const int c = first[b] + k, s = sorted[offset[b] + k];
                int r = 0;
                for (int j = 0; j < b; ++j) r |= ((c >> j) & 1) << (b - 1 - j);
                for (int f = r; f < (1 << kLookBits); f += 1 << b)
                    table[f] = (uint16_t)((s << 4) | b);
            }
        return ok = true;
    }

    int read(BitReader& br) const {
        if (single >= 0) return single;
        const uint16_t e = table[br.peek(kLookBits)];
        if (e & 15) {
            br.skip(e & 15);
            return e >> 4;
        }
        int code = 0;
        for (int b = 1; b <= kMaxCodeLength; ++b) {
            code = (code << 1) | (int)br.get(1);
            if (code - first[b] < count[b]) return sorted[offset[b] + code - first[b]];
        }
        br.eos = true;
        return 0;
    }
};

bool read_code(BitReader& br, int alphabet, Decoder& dec) {
    std::vector<int> len(alphabet, 0);
    if (br.get(1)) {  // simple
        const int num = (int)br.get(1) + 1;
        const int first_8 = (int)br.get(1);
        const int s0 = (int)br.get(first_8 ? 8 : 1);
        if (s0 >= alphabet) return false;
        len[s0] = 1;
        if (num == 2) {
            const int s1 = (int)br.get(8);
            if (s1 >= alphabet) return false;
            len[s1] = 1;
        }
    } else {
        std::vector<int> clen(kCodeLengthCodes, 0);
        const int num = 4 + (int)br.get(4);
        if (num > kCodeLengthCodes) return false;
        for (int k = 0; k < num; ++k) clen[kCodeLengthOrder[k]] = (int)br.get(3);
        Decoder cdec;
        if (!cdec.build(clen)) return false;
        int max_symbol = alphabet;
        if (br.get(1)) {
            const int nbits = 2 + 2 * (int)br.get(3);
            max_symbol = 2 + (int)br.get(nbits);
            if (max_symbol > alphabet) return false;
        }
        int prev = 8;
        for (int s = 0; s < alphabet;) {
            if (max_symbol-- == 0) break;
            const int t = cdec.read(br);
            if (br.eos) return false;
            if (t < 16) {
                len[s++] = t;
                if (t) prev = t;
            } else {
                static const int extra[3] = {2, 3, 7}, base[3] = {3, 3, 11};
                const int repeat = base[t - 16] + (int)br.get(extra[t - 16]);
                if (s + repeat > alphabet) return false;
                const int v = t == 16 ? prev : 0;
                for (int k = 0; k < repeat; ++k) len[s++] = v;
            }
        }
    }
    return dec.build(len) && !br.eos;
}

// (x, y) offsets of distance codes 1..120
constexpr int8_t kDistanceMap[120][2] = {
    {0, 1},  {1, 0},  {1, 1},  {-1, 1}, {0, 2},  {2, 0},  {1, 2},  {-1, 2}, {2, 1},  {-2, 1},
    {2, 2},  {-2, 2}, {0, 3},  {3, 0},  {1, 3},  {-1, 3}, {3, 1},  {-3, 1}, {2, 3},  {-2, 3},
    {3, 2},  {-3, 2}, {0, 4},  {4, 0},  {1, 4},  {-1, 4}, {4, 1},  {-4, 1}, {3, 3},  {-3, 3},
    {2, 4},  {-2, 4}, {4, 2},  {-4, 2}, {0, 5},  {3, 4},  {-3, 4}, {4, 3},  {-4, 3}, {5, 0},
    {1, 5},  {-1, 5}, {5, 1},  {-5, 1}, {2, 5},  {-2, 5}, {5, 2},  {-5, 2}, {4, 4},  {-4, 4},
    {3, 5},  {-3, 5}, {5, 3},  {-5, 3}, {0, 6},  {6, 0},  {1, 6},  {-1, 6}, {6, 1},  {-6, 1},
    {2, 6},  {-2, 6}, {6, 2},  {-6, 2}, {4, 5},  {-4, 5}, {5, 4},  {-5, 4}, {3, 6},  {-3, 6},
    {6, 3},  {-6, 3}, {0, 7},  {7, 0},  {1, 7},  {-1, 7}, {5, 5},  {-5, 5}, {7, 1},  {-7, 1},
    {4, 6},  {-4, 6}, {6, 4},  {-6, 4}, {2, 7},  {-2, 7}, {7, 2},  {-7, 2}, {3, 7},  {-3, 7},
    {7, 3},  {-7, 3}, {5, 6},  {-5, 6}, {6, 5},  {-6, 5}, {8, 0},  {4, 7},  {-4, 7}, {7, 4},
    {-7, 4}, {8, 1},  {8, 2},  {6, 6},  {-6, 6}, {8, 3},  {5, 7},  {-5, 7}, {7, 5},  {-7, 5},
    {8, 4},  {6, 7},  {-6, 7}, {7, 6},  {-7, 6}, {8, 5},  {7, 7},  {-7, 7}, {8, 6},  {8, 7}};

int prefix_value(BitReader& br, int prefix) {
    if (prefix < 4) return prefix + 1;
    const int extra = (prefix - 2) >> 1;
    const int offset = (2 + (prefix & 1)) << extra;
    return offset + (int)br.get(extra) + 1;
}

struct Group {
    Decoder g, r, b, a, d;
};

// an entropy-coded image of w x h pixels; `top` allows meta prefix codes
bool decode_image(BitReader& br, int w, int h, bool top, std::vector<uint32_t>& out) {
    int cache_bits = 0;
    if (br.get(1)) {
        cache_bits = (int)br.get(4);
        if (cache_bits < 1 || cache_bits > 11) return false;
    }
    int meta_bits = 0;
    std::vector<uint32_t> meta;
    int groups = 1;
    if (top && br.get(1)) {
        meta_bits = (int)br.get(3) + 2;
        if (!decode_image(br, div_round_up(w, meta_bits), div_round_up(h, meta_bits), false,
                          meta))
            return false;
        for (uint32_t& m : meta) {
            m = (m >> 8) & 0xffff;
            groups = std::max(groups, (int)m + 1);
        }
    }
    const int cache_size = cache_bits ? 1 << cache_bits : 0;
    std::vector<Group> gs(groups);
    for (Group& grp : gs) {
        if (!read_code(br, kNumLiteral + kNumLengthCodes + cache_size, grp.g) ||
            !read_code(br, 256, grp.r) || !read_code(br, 256, grp.b) ||
            !read_code(br, 256, grp.a) || !read_code(br, kNumDistanceCodes, grp.d))
            return false;
    }
    std::vector<uint32_t> cache(cache_size ? cache_size : 1, 0);
    const long long n = (long long)w * h;
    out.assign(n, 0);
    const int mw = meta_bits ? div_round_up(w, meta_bits) : 0;
    long long i = 0, inserted = 0;
    auto insert_upto = [&](long long end) {
        if (!cache_bits) return;
        for (; inserted < end; ++inserted)
            cache[(0x1e35a7bdu * out[inserted]) >> (32 - cache_bits)] = out[inserted];
    };
    while (i < n) {
        const int x = (int)(i % w), y = (int)(i / w);
        const Group& grp = gs[meta_bits ? meta[(size_t)(y >> meta_bits) * mw + (x >> meta_bits)] : 0];
        const int s = grp.g.read(br);
        if (br.eos) return false;
        if (s < kNumLiteral) {
            const uint32_t r = (uint32_t)grp.r.read(br), b = (uint32_t)grp.b.read(br),
                           a = (uint32_t)grp.a.read(br);
            out[i++] = argb(a, r, (uint32_t)s, b);
        } else if (s < kNumLiteral + kNumLengthCodes) {
            const int length = prefix_value(br, s - kNumLiteral);
            const int dcode = prefix_value(br, grp.d.read(br));
            long long dist;
            if (dcode > 120) {
                dist = dcode - 120;
            } else {
                dist = kDistanceMap[dcode - 1][0] + (long long)kDistanceMap[dcode - 1][1] * w;
                if (dist < 1) dist = 1;
            }
            if (dist > i || i + length > n) return false;
            for (int k = 0; k < length; ++k, ++i) out[i] = out[i - dist];
        } else {
            insert_upto(i);
            out[i++] = cache[s - kNumLiteral - kNumLengthCodes];
        }
        if (br.eos) return false;
    }
    return true;
}

struct Transform {
    int type, bits = 0, table_size = 0;
    std::vector<uint32_t> data;
    int width;  // the image width before this transform's inverse
};

// the image stream after the header (transforms, then the entropy-coded
// image) of a w x h image
bool decode_stream(BitReader& br, int w, int h, std::vector<uint32_t>& px) {
    std::vector<Transform> ts;
    int xsize = w;
    int seen = 0;
    while (br.get(1)) {
        Transform t;
        t.type = (int)br.get(2);
        if (seen & (1 << t.type)) return false;
        seen |= 1 << t.type;
        t.width = xsize;
        if (t.type == kPredictor || t.type == kCrossColor) {
            t.bits = (int)br.get(3) + 2;
            if (!decode_image(br, div_round_up(xsize, t.bits), div_round_up(h, t.bits), false,
                              t.data))
                return false;
        } else if (t.type == kColorIndexing) {
            t.table_size = (int)br.get(8) + 1;
            if (!decode_image(br, t.table_size, 1, false, t.data)) return false;
            for (int k = 1; k < t.table_size; ++k) t.data[k] = add_pixels(t.data[k], t.data[k - 1]);
            t.bits = t.table_size <= 2 ? 3 : t.table_size <= 4 ? 2 : t.table_size <= 16 ? 1 : 0;
            xsize = div_round_up(xsize, t.bits);
        }
        ts.push_back(std::move(t));
        if (br.eos) return false;
    }
    std::vector<uint32_t> img;
    if (!decode_image(br, xsize, h, true, img)) return false;
    for (int k = (int)ts.size() - 1; k >= 0; --k) {
        const Transform& t = ts[k];
        const int tw = t.width;
        if (t.type == kSubtractGreen) {
            for (uint32_t& v : img) {
                const uint32_t g = ch(v, 8);
                v = (v & 0xff00ff00u) | (((ch(v, 16) + g) & 0xff) << 16) | ((ch(v, 0) + g) & 0xff);
            }
        } else if (t.type == kPredictor) {
            const int mw = div_round_up(tw, t.bits);
            for (int y = 0; y < h; ++y)
                for (int x = 0; x < tw; ++x) {
                    const long long i = (long long)y * tw + x;
                    int mode = (int)ch(t.data[(size_t)(y >> t.bits) * mw + (x >> t.bits)], 8) & 15;
                    img[i] = add_pixels(img[i], predict_at(img.data(), tw, x, y, i, mode));
                }
        } else if (t.type == kCrossColor) {
            const int mw = div_round_up(tw, t.bits);
            for (int y = 0; y < h; ++y)
                for (int x = 0; x < tw; ++x) {
                    const long long i = (long long)y * tw + x;
                    const uint32_t m = t.data[(size_t)(y >> t.bits) * mw + (x >> t.bits)];
                    const int g2r = (int8_t)ch(m, 0), g2b = (int8_t)ch(m, 8),
                              r2b = (int8_t)ch(m, 16);
                    const uint32_t v = img[i];
                    const int g = (int8_t)ch(v, 8);
                    const int r = ((int)ch(v, 16) + ((g2r * g) >> 5)) & 0xff;
                    const int b = ((int)ch(v, 0) + ((g2b * g) >> 5) + ((r2b * (int8_t)r) >> 5)) & 0xff;
                    img[i] = (v & 0xff00ff00u) | ((uint32_t)r << 16) | (uint32_t)b;
                }
        } else {  // colour indexing: unpack `bits` and look up the table
            const int packed_w = div_round_up(tw, t.bits);
            const int per = 1 << t.bits, bpp = 8 >> t.bits, mask = (1 << bpp) - 1;
            std::vector<uint32_t> out((size_t)tw * h);
            for (int y = 0; y < h; ++y)
                for (int x = 0; x < tw; ++x) {
                    const uint32_t g = ch(img[(size_t)y * packed_w + x / per], 8);
                    const int idx = (int)(g >> (bpp * (x % per))) & mask;
                    out[(size_t)y * tw + x] = idx < t.table_size ? t.data[idx] : 0u;
                }
            img.swap(out);
        }
    }
    px.swap(img);
    return true;
}

}  // namespace

namespace webp_lossless {

bool decode_headerless(const uint8_t* p, size_t len, int w, int h, std::vector<uint32_t>& argb) {
    BitReader br(p, len);
    return decode_stream(br, w, h, argb);
}

bool decode_chunk(const uint8_t* p, size_t len, int& w, int& h, bool& alpha,
                  std::vector<uint32_t>& px) {
    if (len < 5 || p[0] != 0x2f) return false;
    BitReader br(p + 1, len - 1);
    w = (int)br.get(14) + 1;
    h = (int)br.get(14) + 1;
    alpha = br.get(1) != 0;
    if (br.get(3) != 0) return false;
    return decode_stream(br, w, h, px);
}

std::vector<uint8_t> encode_chunk(const uint8_t* src, int w, int h, int channels) {
    const long long n = (long long)w * h;
    std::vector<uint32_t> px(n);
    bool alpha_used = false;
    for (long long i = 0; i < n; ++i) {
        const uint8_t* s = src + i * channels;
        const uint32_t a = channels == 4 ? s[3] : 255;
        alpha_used |= a != 255;
        px[i] = argb(a, s[0], s[1], s[2]);
    }
    BitWriter bw;
    bw.put(0x2f, 8);
    bw.put(w - 1, 14);
    bw.put(h - 1, 14);
    bw.put(alpha_used ? 1 : 0, 1);
    bw.put(0, 3);
    write_stream(bw, std::move(px), w, h, true);
    bw.flush();
    return bw.buf;
}

std::vector<uint8_t> encode_alpha(const uint8_t* alpha, int w, int h) {
    std::vector<uint32_t> px((size_t)w * h);
    for (size_t i = 0; i < px.size(); ++i) px[i] = kBlack | ((uint32_t)alpha[i] << 8);
    BitWriter bw;
    write_stream(bw, std::move(px), w, h, false);
    bw.flush();
    return bw.buf;
}

}  // namespace webp_lossless
