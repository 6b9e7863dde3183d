// LZW and the median-cut quantizer for the port's GIF and TIFF codecs.
//
// The machine with the card has no giflib, libtiff or Pillow, so the port
// carries the loops that a pixel-by-pixel Python version would spend seconds
// on: the LZW decoders of GIF (codes packed from the least significant bit)
// and TIFF (from the most significant bit, one code early in widening), the
// GIF LZW encoder, and an adaptive palette by median cut. The containers are
// read and written in Python (codecs/gif.py, codecs/tiff.py). Built with
// raster.cpp into one library with a plain C interface for ctypes; no global
// state, so calls may run from many threads at once.
//
// The quantizer follows Pillow's libImaging/Quant.c, method 0 (median cut,
// no dither, no k-means), which is what Image.convert("P",
// palette=ADAPTIVE) runs:
//   - a histogram of the colours, each channel shifted right by the least
//     scale that leaves at most 65536 distinct colours;
//   - boxes split in a max-heap on their pixel count; a box of one colour is
//     never split; the axis is the largest of the channel ranges weighted
//     77 : 150 : 29; the split leaves the higher values on the left, up to
//     the first entry past half the pixels, with every entry of that value;
//   - the palette is the rounded mean of the full-precision pixels of each
//     box, boxes numbered left to right;
//   - each pixel maps to the nearest palette colour (squared RGB distance),
//     its own box's colour winning a tie.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// ------------------------------------------------------------------ LZW

struct LzwTable {
    // entry -> (prefix entry, last byte, length); strings rebuilt backwards
    std::vector<int32_t> prefix;
    std::vector<uint8_t> suffix;
    std::vector<uint8_t> first;
    std::vector<int32_t> length;
    explicit LzwTable(int roots) : prefix(4096), suffix(4096), first(4096), length(4096) {
        for (int i = 0; i < roots; ++i) prefix[i] = -1, suffix[i] = first[i] = (uint8_t)i, length[i] = 1;
    }
    // write the string of `code` to out[pos..]; returns its length. The
    // string is clipped to `cap` bytes from pos.
    int emit(int code, uint8_t* out, size_t pos, size_t cap) const {
        const int len = length[code];
        int c = code;
        for (int k = len - 1; k >= 0; --k) {
            if (pos + k < cap) out[pos + k] = suffix[c];
            c = prefix[c];
        }
        return len;
    }
};

}  // namespace

extern "C" {

// GIF LZW: `data` (the image's sub-blocks already joined) -> up to `cap`
// palette indices in out. Returns the count written; *status 0 when the
// stream reached its end code or filled `cap`, 1 when the data ran out
// first, 2 for a code that is not in the table.
long fl_gif_lzw_decode(const uint8_t* data, size_t len, int min_code_size, uint8_t* out,
                       size_t cap, int* status) {
    *status = 2;
    if (min_code_size < 1 || min_code_size > 11) return 0;
    const int clear = 1 << min_code_size, eoi = clear + 1;
    LzwTable t(clear);
    int width = min_code_size + 1, next = eoi + 1, prev = -1;
    uint32_t acc = 0;
    int nacc = 0;
    size_t pos = 0, in = 0;
    while (pos < cap) {
        while (nacc < width && in < len) acc |= (uint32_t)data[in++] << nacc, nacc += 8;
        if (nacc < width) {
            *status = 1;
            return (long)pos;
        }
        const int code = (int)(acc & ((1u << width) - 1));
        acc >>= width, nacc -= width;
        if (code == clear) {
            width = min_code_size + 1, next = eoi + 1, prev = -1;
            continue;
        }
        if (code == eoi) break;
        if (prev < 0) {
            if (code >= clear) return (long)pos;
            out[pos++] = (uint8_t)code;
            prev = code;
            continue;
        }
        int emitted;
        uint8_t head;
        if (code < next) {
            head = t.first[code];
            emitted = t.emit(code, out, pos, cap);
        } else if (code == next) {  // KwKwK: prev's string + its first byte
            head = t.first[prev];
            emitted = t.emit(prev, out, pos, cap);
            if (pos + emitted < cap) out[pos + emitted] = head;
            ++emitted;
        } else {
            return (long)pos;
        }
        if (next < 4096) {
            t.prefix[next] = prev, t.suffix[next] = head, t.first[next] = t.first[prev];
            t.length[next] = t.length[prev] + 1;
            ++next;
            if (next == (1 << width) && width < 12) ++width;
        }
        pos = std::min(cap, pos + (size_t)emitted);
        prev = code;
    }
    *status = 0;
    return (long)pos;
}

// TIFF LZW (codes from the most significant bit, widening one code early,
// as libtiff reads it) -> up to `cap` bytes. Same return and *status as
// fl_gif_lzw_decode; *status 3 for the old-style (LSB-first) variant.
long fl_tiff_lzw_decode(const uint8_t* data, size_t len, uint8_t* out, size_t cap, int* status) {
    *status = 2;
    if (len >= 2 && data[0] == 0 && (data[1] & 1)) {
        *status = 3;
        return 0;
    }
    const int clear = 256, eoi = 257;
    LzwTable t(256);
    int width = 9, next = 258, prev = -1;
    uint64_t acc = 0;
    int nacc = 0;
    size_t pos = 0, in = 0;
    while (pos < cap) {
        while (nacc < width && in < len) acc = (acc << 8) | data[in++], nacc += 8;
        if (nacc < width) {
            *status = 1;
            return (long)pos;
        }
        const int code = (int)((acc >> (nacc - width)) & ((1u << width) - 1));
        nacc -= width;
        if (code == clear) {
            width = 9, next = 258, prev = -1;
            continue;
        }
        if (code == eoi) break;
        if (prev < 0) {
            if (code >= 256) return (long)pos;
            out[pos++] = (uint8_t)code;
            prev = code;
            continue;
        }
        int emitted;
        uint8_t head;
        if (code < next) {
            head = t.first[code];
            emitted = t.emit(code, out, pos, cap);
        } else if (code == next) {
            head = t.first[prev];
            emitted = t.emit(prev, out, pos, cap);
            if (pos + emitted < cap) out[pos + emitted] = head;
            ++emitted;
        } else {
            return (long)pos;
        }
        if (next < 4096) {
            t.prefix[next] = prev, t.suffix[next] = head, t.first[next] = t.first[prev];
            t.length[next] = t.length[prev] + 1;
            ++next;
            if (next == (1 << width) - 1 && width < 12) ++width;
        }
        pos = std::min(cap, pos + (size_t)emitted);
        prev = code;
    }
    *status = 0;
    return (long)pos;
}

// indices [n] -> the GIF image data that follows an image descriptor: the
// minimum code size byte, the LZW stream in sub-blocks of at most 255 bytes
// and the zero-length terminator; malloc'd, its size in *out_len. The
// stream starts with a clear code and clears again when the table is full.
uint8_t* fl_gif_lzw_encode(const uint8_t* idx, size_t n, int min_code_size, size_t* out_len) {
    if (min_code_size < 2 || min_code_size > 8) return nullptr;
    const int clear = 1 << min_code_size, eoi = clear + 1;
    // child[code * 256 + byte] would be 4 MiB; an open hash of (prefix, byte)
    constexpr int kHash = 1 << 14;
    std::vector<int32_t> key(kHash), val(kHash);
    auto reset = [&]() { std::fill(key.begin(), key.end(), -1); };
    reset();
    std::vector<uint8_t> bytes;
    bytes.reserve(n / 2 + 64);
    uint32_t acc = 0;
    int nacc = 0, width = min_code_size + 1, next = eoi + 1;
    auto put = [&](int code) {
        acc |= (uint32_t)code << nacc;
        nacc += width;
        while (nacc >= 8) bytes.push_back((uint8_t)acc), acc >>= 8, nacc -= 8;
    };
    put(clear);
    if (n) {
        int cur = idx[0];
        for (size_t i = 1; i < n; ++i) {
            const int b = idx[i];
            const int32_t k = (cur << 8) | b;
            uint32_t h = ((uint32_t)k * 2654435761u) >> (32 - 14);
            while (key[h] != -1 && key[h] != k) h = (h + 1) & (kHash - 1);
            if (key[h] == k) {
                cur = val[h];
                continue;
            }
            put(cur);
            if (next < 4096) {
                key[h] = k, val[h] = next++;
                // the decoder widens after adding the entry that reaches 1 << width
                if (next > (1 << width) && width < 12) ++width;
            } else {
                put(clear);
                reset();
                width = min_code_size + 1, next = eoi + 1;
            }
            cur = b;
        }
        put(cur);
        // the decoder adds an entry after this code too
        if (next < 4096 && ++next > (1 << width) && width < 12) ++width;
    }
    put(eoi);
    if (nacc > 0) bytes.push_back((uint8_t)acc);
    const size_t blocks = (bytes.size() + 254) / 255;
    const size_t total = 1 + bytes.size() + blocks + 1;
    auto* buf = static_cast<uint8_t*>(std::malloc(total));
    if (!buf) return nullptr;
    size_t o = 0;
    buf[o++] = (uint8_t)min_code_size;
    for (size_t p = 0; p < bytes.size(); p += 255) {
        const size_t m = std::min<size_t>(255, bytes.size() - p);
        buf[o++] = (uint8_t)m;
        std::memcpy(buf + o, bytes.data() + p, m);
        o += m;
    }
    buf[o++] = 0;
    *out_len = o;
    return buf;
}

}  // extern "C"

// ------------------------------------------------------------ median cut

namespace {

struct Entry {
    uint8_t c[3];   // the colour, each channel shifted right by the scale
    uint32_t count;
};

struct Box {
    std::vector<int32_t> members;  // indices into the entries
    uint32_t pixels = 0;
    int volume = -1;
    int left = -1, right = -1;
};

// Quant.c's heap: a binary max-heap on the box's pixel count, in its order
// of sifting (ties resolve as that heap resolves them)
struct Heap {
    std::vector<int> h{0};  // 1-based
    const std::vector<Box>* boxes;
    int cmp(int a, int b) const {
        return (int)(*boxes)[a].pixels - (int)(*boxes)[b].pixels;
    }
    void add(int v) {
        h.push_back(0);
        size_t k = h.size() - 1;
        while (k != 1) {
            if (cmp(v, h[k / 2]) <= 0) break;
            h[k] = h[k / 2];
            k >>= 1;
        }
        h[k] = v;
    }
    bool remove(int* r) {
        const size_t count = h.size() - 1;
        if (!count) return false;
        *r = h[1];
        const int v = h[count];
        h.pop_back();
        const size_t c = count - 1;
        size_t k = 1, l;
        for (; k * 2 <= c; k = l) {
            l = k * 2;
            if (l < c && cmp(h[l], h[l + 1]) < 0) ++l;
            if (cmp(v, h[l]) > 0) break;
            h[k] = h[l];
        }
        if (c) h[k] = v;
        return true;
    }
};

}  // namespace

extern "C" {

// rgb [n, 3] -> at most `max_colors` palette colours in palette [256, 3]
// (the count returned) and one index per pixel in idx [n].
int fl_quantize(const uint8_t* rgb, size_t n, int max_colors, uint8_t* palette, uint8_t* idx) {
    if (n == 0 || max_colors < 1 || max_colors > 256) return 0;
    // the histogram at the least scale with at most 65536 colours
    std::vector<uint32_t> keys(n);
    for (size_t i = 0; i < n; ++i)
        keys[i] = ((uint32_t)rgb[3 * i] << 16) | ((uint32_t)rgb[3 * i + 1] << 8) | rgb[3 * i + 2];
    std::vector<uint32_t> sorted(keys);
    std::sort(sorted.begin(), sorted.end());
    int scale = 0;
    std::vector<uint32_t> uniq;
    for (;; ++scale) {
        const uint32_t m = (0xFFu >> scale) * 0x010101u;
        uniq.clear();
        for (uint32_t k : sorted) {
            const uint32_t s = (k >> scale) & m;
            if (uniq.empty() || uniq.back() != s) uniq.push_back(s);
        }
        // shifting keeps the order within each channel only; sort again
        if (scale) {
            std::sort(uniq.begin(), uniq.end());
            uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
        }
        if (uniq.size() <= 65536) break;
    }
    const uint32_t mask = (0xFFu >> scale) * 0x010101u;
    auto entry_of = [&](uint32_t k) -> int32_t {
        const uint32_t s = (k >> scale) & mask;
        return (int32_t)(std::lower_bound(uniq.begin(), uniq.end(), s) - uniq.begin());
    };
    std::vector<Entry> entries(uniq.size());
    for (size_t e = 0; e < uniq.size(); ++e) {
        entries[e].c[0] = (uint8_t)(uniq[e] >> 16), entries[e].c[1] = (uint8_t)(uniq[e] >> 8);
        entries[e].c[2] = (uint8_t)uniq[e], entries[e].count = 0;
    }
    std::vector<int32_t> pixel_entry(n);
    for (size_t i = 0; i < n; ++i) {
        pixel_entry[i] = entry_of(keys[i]);
        ++entries[pixel_entry[i]].count;
    }

    std::vector<Box> boxes(1);
    boxes[0].members.resize(entries.size());
    for (size_t e = 0; e < entries.size(); ++e) boxes[0].members[e] = (int32_t)e;
    boxes[0].pixels = (uint32_t)n;
    auto range = [&](const Box& b, int axis, int* lo, int* hi) {
        *lo = 255, *hi = 0;
        for (int32_t m : b.members) *lo = std::min<int>(*lo, entries[m].c[axis]),
                                    *hi = std::max<int>(*hi, entries[m].c[axis]);
    };
    auto volume = [&](Box& b) {
        if (b.volume < 0) {
            int v = 1;
            for (int a = 0; a < 3; ++a) {
                int lo, hi;
                range(b, a, &lo, &hi);
                v *= hi - lo + 1;
            }
            b.volume = v;
        }
        return b.volume;
    };
    Heap heap;
    heap.boxes = &boxes;
    heap.add(0);
    for (int splits = max_colors - 1; splits > 0; --splits) {
        int b;
        bool found = false;
        while (heap.remove(&b)) {
            if (volume(boxes[b]) != 1) {
                found = true;
                break;
            }
        }
        if (!found) break;
        int f[3], axis = 0;
        for (int a = 0; a < 3; ++a) {
            int lo, hi;
            range(boxes[b], a, &lo, &hi);
            f[a] = (hi - lo) * (a == 0 ? 77 : a == 1 ? 150 : 29);
        }
        for (int a = 1; a < 3; ++a)
            if (f[axis] < f[a]) axis = a;
        std::vector<int32_t> order(boxes[b].members);
        std::stable_sort(order.begin(), order.end(), [&](int32_t x, int32_t y) {
            return entries[x].c[axis] > entries[y].c[axis];
        });
        // the left side: from the highest value up to the first entry past
        // half the pixels, with every entry of that entry's value
        const uint32_t total = boxes[b].pixels;
        uint64_t acc = 0;
        size_t cut = 0;
        while (cut < order.size()) {
            acc += entries[order[cut]].count;
            ++cut;
            if (acc * 2 > total) break;
        }
        if (cut < order.size()) {
            const int v = entries[order[cut - 1]].c[axis];
            while (cut < order.size() && entries[order[cut]].c[axis] == v) ++cut;
        }
        if (cut == order.size()) {  // nothing right: the lowest value goes right
            const int v = entries[order.back()].c[axis];
            while (cut > 0 && entries[order[cut - 1]].c[axis] == v) --cut;
        }
        Box l, r;
        l.members.assign(order.begin(), order.begin() + cut);
        r.members.assign(order.begin() + cut, order.end());
        for (int32_t m : l.members) l.pixels += entries[m].count;
        for (int32_t m : r.members) r.pixels += entries[m].count;
        const int li = (int)boxes.size();
        boxes.push_back(std::move(l));
        boxes.push_back(std::move(r));
        boxes[b].left = li, boxes[b].right = li + 1;
        boxes[b].members.clear();
        boxes[b].members.shrink_to_fit();
        heap.add(li);
        heap.add(li + 1);
    }
    // leaves, left to right, number the palette
    std::vector<int32_t> entry_box(entries.size());
    int ncolors = 0;
    std::vector<int> stack = {0};
    while (!stack.empty()) {
        const int b = stack.back();
        stack.pop_back();
        if (boxes[b].left >= 0) {
            stack.push_back(boxes[b].right);
            stack.push_back(boxes[b].left);
            continue;
        }
        for (int32_t m : boxes[b].members) entry_box[m] = ncolors;
        ++ncolors;
    }
    std::vector<uint64_t> sum(3 * ncolors, 0), cnt(ncolors, 0);
    for (size_t i = 0; i < n; ++i) {
        const int p = entry_box[pixel_entry[i]];
        for (int a = 0; a < 3; ++a) sum[3 * p + a] += rgb[3 * i + a];
        ++cnt[p];
    }
    std::memset(palette, 0, 256 * 3);
    std::vector<int> pal(3 * ncolors);
    for (int p = 0; p < ncolors; ++p)
        for (int a = 0; a < 3; ++a) {
            const int v = (int)(0.5 + (double)sum[3 * p + a] / (double)cnt[p]);
            pal[3 * p + a] = v;
            palette[3 * p + a] = (uint8_t)v;
        }
    auto dist = [&](const int* a, const int* b) {
        const int d0 = a[0] - b[0], d1 = a[1] - b[1], d2 = a[2] - b[2];
        return (uint32_t)(d0 * d0 + d1 * d1 + d2 * d2);
    };
    // per palette entry, the others by their distance from it (a stable
    // order: equal distances by index)
    std::vector<uint32_t> pd((size_t)ncolors * ncolors);
    std::vector<int> near((size_t)ncolors * ncolors);
    for (int p = 0; p < ncolors; ++p) {
        for (int q = 0; q < ncolors; ++q) pd[(size_t)p * ncolors + q] = dist(&pal[3 * p], &pal[3 * q]);
        int* row = &near[(size_t)p * ncolors];
        for (int q = 0; q < ncolors; ++q) row[q] = q;
        const uint32_t* d = &pd[(size_t)p * ncolors];
        std::stable_sort(row, row + ncolors, [&](int a, int b) { return d[a] < d[b]; });
    }
    // one search per distinct colour
    std::vector<int16_t> memo;
    const bool dense = n > 4096;
    if (dense) memo.assign(1u << 24, -1);
    for (size_t i = 0; i < n; ++i) {
        if (dense && memo[keys[i]] >= 0) {
            idx[i] = (uint8_t)memo[keys[i]];
            continue;
        }
        const int px[3] = {rgb[3 * i], rgb[3 * i + 1], rgb[3 * i + 2]};
        const int own = entry_box[pixel_entry[i]];
        uint32_t best = dist(&pal[3 * own], px);
        int match = own;
        const uint32_t bound = best << 2;
        const int* row = &near[(size_t)own * ncolors];
        const uint32_t* d = &pd[(size_t)own * ncolors];
        for (int j = 0; j < ncolors; ++j) {
            const int q = row[j];
            if (d[q] > bound) break;
            const uint32_t dq = dist(&pal[3 * q], px);
            if (dq < best) best = dq, match = q;
        }
        idx[i] = (uint8_t)match;
        if (dense) memo[keys[i]] = (int16_t)match;
    }
    return ncolors;
}

}  // extern "C"
