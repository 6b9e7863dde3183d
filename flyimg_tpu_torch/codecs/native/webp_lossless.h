// What webp_lossy.cpp takes from the lossless (VP8L) codec: a VP8L chunk's
// encoder and decoder, and the headerless image stream of an ALPH chunk
// (compression 1), whose green channel carries the alpha plane.

#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

namespace webp_lossless {

// a "VP8L" chunk's payload -> its size, its alpha bit and w * h ARGB pixels;
// false for a damaged stream
bool decode_chunk(const uint8_t* p, size_t len, int& w, int& h, bool& alpha,
                  std::vector<uint32_t>& argb);

// [h, w, channels] uint8 (channels 3 or 4) -> a "VP8L" chunk's payload
std::vector<uint8_t> encode_chunk(const uint8_t* pixels, int w, int h, int channels);

// an image stream without the signature and size header, of a w x h image
bool decode_headerless(const uint8_t* p, size_t len, int w, int h, std::vector<uint32_t>& argb);

// the w x h alpha plane as such a stream, the alpha in the green channel
std::vector<uint8_t> encode_alpha(const uint8_t* alpha, int w, int h);

}  // namespace webp_lossless
