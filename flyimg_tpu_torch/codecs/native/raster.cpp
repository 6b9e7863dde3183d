// Run-length decoders for the port's BMP and TIFF sources: PackBits (TIFF
// compression 32773) and BMP's RLE8 and RLE4. Built with gif.cpp into one
// library with a plain C interface for ctypes; no global state.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

void fl_raster_free(void* ptr) { std::free(ptr); }

// PackBits -> up to `cap` bytes in out; returns the count written.
long fl_packbits_decode(const uint8_t* data, size_t len, uint8_t* out, size_t cap) {
    size_t in = 0, pos = 0;
    while (in < len && pos < cap) {
        const int n = (int8_t)data[in++];
        if (n >= 0) {
            const size_t m = std::min<size_t>({(size_t)n + 1, len - in, cap - pos});
            std::memcpy(out + pos, data + in, m);
            in += (size_t)n + 1, pos += m;
        } else if (n != -128) {
            if (in >= len) break;
            const size_t m = std::min<size_t>((size_t)(1 - n), cap - pos);
            std::memset(out + pos, data[in++], m);
            pos += m;
        }
    }
    return (long)pos;
}

// A BMP's RLE8 or RLE4 pixel data (from the file's pixel offset `base` to
// its end) -> one palette index per pixel, rows in file order, as Pillow's
// BmpRleDecoder writes them: an encoded run is clipped at the row's end, an
// absolute run is not; a delta skips the two bytes after its escape and
// reads its offsets from the next two; an absolute run of RLE4 yields two
// pixels per byte it reads (count / 2 bytes); absolute runs end on an even
// file offset. Returns malloc'd bytes, their count in *out_len (they may
// fall short of or run past w * h).
uint8_t* fl_bmp_rle_decode(const uint8_t* data, size_t len, size_t base, int w, int h, int rle4,
                           size_t* out_len) {
    if (w <= 0 || h <= 0) return nullptr;
    const size_t xs = (size_t)w, dest = xs * (size_t)h;
    std::vector<uint8_t> o;
    o.reserve(dest);
    size_t in = 0, x = 0;
    while (o.size() < dest) {
        if (in + 2 > len) break;
        size_t count = data[in];
        const uint8_t byte = data[in + 1];
        in += 2;
        if (count) {
            if (x + count > xs) count = x < xs ? xs - x : 0;
            if (rle4) {
                for (size_t k = 0; k < count; ++k) o.push_back(k % 2 == 0 ? byte >> 4 : byte & 0x0F);
            } else {
                o.insert(o.end(), count, byte);
            }
            x += count;
        } else if (byte == 0) {
            while (o.size() % xs) o.push_back(0);
            x = 0;
        } else if (byte == 1) {
            break;
        } else if (byte == 2) {
            if (in + 2 > len) break;
            in += 2;
            if (in + 2 > len) break;  // Python unpacks two bytes or raises
            const size_t right = data[in], up = data[in + 1];
            in += 2;
            o.insert(o.end(), right + up * xs, 0);
            x = o.size() % xs;
        } else {
            const size_t want = rle4 ? byte / 2 : byte;
            const size_t got = std::min(want, len - in);
            for (size_t k = 0; k < got; ++k) {
                const uint8_t b = data[in + k];
                if (rle4) {
                    o.push_back(b >> 4);
                    o.push_back(b & 0x0F);
                } else {
                    o.push_back(b);
                }
            }
            in += got;
            if (got < want) break;
            x += byte;
            if ((base + in) % 2 != 0) ++in;
        }
    }
    auto* buf = static_cast<uint8_t*>(std::malloc(std::max<size_t>(o.size(), 1)));
    if (!buf) return nullptr;
    if (!o.empty()) std::memcpy(buf, o.data(), o.size());
    *out_len = o.size();
    return buf;
}

}  // extern "C"
