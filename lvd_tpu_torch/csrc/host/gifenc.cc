// Fast GIF89a encoder for video frames.
//
// Native replacement for the Python gif path (PIL quantize + LZW), which
// costs 1-2 s per 24-frame video on the host and serializes against TPU
// work. Uses a fixed 6x7x6 RGB color cube (252 colors) with optional
// Floyd-Steinberg dithering and a straightforward LZW implementation.
//
// Exposed via a C ABI for ctypes (no pybind11 in the image):
//   int gif_encode(const uint8_t* rgb, int frames, int h, int w,
//                  int delay_cs, int dither, const char* path);
// Returns 0 on success.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr int kRLevels = 6, kGLevels = 7, kBLevels = 6;  // 252 colors

inline int quant_index(int r, int g, int b) {
  int ri = (r * kRLevels) >> 8;
  int gi = (g * kGLevels) >> 8;
  int bi = (b * kBLevels) >> 8;
  return (ri * kGLevels + gi) * kBLevels + bi;
}

struct ByteSink {
  std::vector<uint8_t> buf;
  void u8(uint8_t v) { buf.push_back(v); }
  void u16(uint16_t v) {
    buf.push_back(v & 0xFF);
    buf.push_back(v >> 8);
  }
  void bytes(const void* p, size_t n) {
    const uint8_t* b = static_cast<const uint8_t*>(p);
    buf.insert(buf.end(), b, b + n);
  }
};

// LZW with variable code width, emitting GIF sub-blocks.
class LzwWriter {
 public:
  LzwWriter(ByteSink& out, int min_code_size) : out_(out), min_(min_code_size) {
    out_.u8(static_cast<uint8_t>(min_));
    reset_table();
  }

  void put_code(int code) {
    acc_ |= static_cast<uint64_t>(code) << nbits_;
    nbits_ += width_;
    while (nbits_ >= 8) {
      block_[blen_++] = acc_ & 0xFF;
      acc_ >>= 8;
      nbits_ -= 8;
      if (blen_ == 255) flush_block();
    }
  }

  void encode(const uint8_t* data, size_t n) {
    put_code(clear_);
    if (n == 0) {
      put_code(end_);
      finish();
      return;
    }
    int cur = data[0];
    for (size_t i = 1; i < n; ++i) {
      int c = data[i];
      int key = (cur << 8) | c;
      int found = table_[key];
      if (found >= 0) {
        cur = found;
      } else {
        put_code(cur);
        if (next_ < 4096) {
          table_[key] = next_;
          if (next_ == (1 << width_) && width_ < 12) ++width_;
          ++next_;
        } else {
          put_code(clear_);
          reset_table();
        }
        cur = c;
      }
    }
    put_code(cur);
    put_code(end_);
    finish();
  }

 private:
  void reset_table() {
    table_.assign(4096 << 8, -1);
    clear_ = 1 << min_;
    end_ = clear_ + 1;
    next_ = end_ + 1;
    width_ = min_ + 1;
  }

  void flush_block() {
    out_.u8(static_cast<uint8_t>(blen_));
    out_.bytes(block_, blen_);
    blen_ = 0;
  }

  void finish() {
    if (nbits_ > 0) {
      block_[blen_++] = acc_ & 0xFF;
      acc_ = 0;
      nbits_ = 0;
      if (blen_ == 255) flush_block();
    }
    if (blen_) flush_block();
    out_.u8(0);  // block terminator
  }

  ByteSink& out_;
  int min_;
  std::vector<int> table_;  // (prefix_code << 8 | byte) -> code
  int clear_ = 0, end_ = 0, next_ = 0, width_ = 0;
  uint64_t acc_ = 0;
  int nbits_ = 0;
  uint8_t block_[256];
  int blen_ = 0;
};

void build_palette(uint8_t* pal /* 256*3 */) {
  int idx = 0;
  for (int r = 0; r < kRLevels; ++r)
    for (int g = 0; g < kGLevels; ++g)
      for (int b = 0; b < kBLevels; ++b) {
        pal[idx * 3 + 0] = static_cast<uint8_t>(r * 255 / (kRLevels - 1));
        pal[idx * 3 + 1] = static_cast<uint8_t>(g * 255 / (kGLevels - 1));
        pal[idx * 3 + 2] = static_cast<uint8_t>(b * 255 / (kBLevels - 1));
        ++idx;
      }
  for (; idx < 256; ++idx) {
    pal[idx * 3] = pal[idx * 3 + 1] = pal[idx * 3 + 2] = 0;
  }
}

inline uint8_t clamp_u8(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

void quantize_frame(const uint8_t* rgb, int h, int w, bool dither,
                    uint8_t* out_idx, const uint8_t* pal) {
  if (!dither) {
    const int n = h * w;
    for (int i = 0; i < n; ++i) {
      out_idx[i] =
          static_cast<uint8_t>(quant_index(rgb[3 * i], rgb[3 * i + 1], rgb[3 * i + 2]));
    }
    return;
  }
  // Floyd-Steinberg with two error rows.
  std::vector<int16_t> err((w + 2) * 3 * 2, 0);
  int16_t* cur = err.data();
  int16_t* nxt = err.data() + (w + 2) * 3;
  for (int y = 0; y < h; ++y) {
    std::memset(nxt, 0, (w + 2) * 3 * sizeof(int16_t));
    for (int x = 0; x < w; ++x) {
      const uint8_t* px = rgb + 3 * (y * w + x);
      int r = clamp_u8(px[0] + cur[(x + 1) * 3 + 0] / 16);
      int g = clamp_u8(px[1] + cur[(x + 1) * 3 + 1] / 16);
      int b = clamp_u8(px[2] + cur[(x + 1) * 3 + 2] / 16);
      int qi = quant_index(r, g, b);
      out_idx[y * w + x] = static_cast<uint8_t>(qi);
      int er = r - pal[qi * 3 + 0];
      int eg = g - pal[qi * 3 + 1];
      int eb = b - pal[qi * 3 + 2];
      cur[(x + 2) * 3 + 0] += 7 * er;
      cur[(x + 2) * 3 + 1] += 7 * eg;
      cur[(x + 2) * 3 + 2] += 7 * eb;
      nxt[(x + 0) * 3 + 0] += 3 * er;
      nxt[(x + 0) * 3 + 1] += 3 * eg;
      nxt[(x + 0) * 3 + 2] += 3 * eb;
      nxt[(x + 1) * 3 + 0] += 5 * er;
      nxt[(x + 1) * 3 + 1] += 5 * eg;
      nxt[(x + 1) * 3 + 2] += 5 * eb;
      nxt[(x + 2) * 3 + 0] += 1 * er;
      nxt[(x + 2) * 3 + 1] += 1 * eg;
      nxt[(x + 2) * 3 + 2] += 1 * eb;
    }
    std::swap(cur, nxt);
  }
}

}  // namespace

extern "C" int gif_encode(const uint8_t* rgb, int frames, int h, int w,
                          int delay_cs, int dither, const char* path) {
  if (!rgb || frames <= 0 || h <= 0 || w <= 0 || !path) return 1;

  uint8_t pal[256 * 3];
  build_palette(pal);

  ByteSink out;
  out.bytes("GIF89a", 6);
  out.u16(static_cast<uint16_t>(w));
  out.u16(static_cast<uint16_t>(h));
  out.u8(0xF7);  // global color table, 8 bits/pixel, 256 entries
  out.u8(0);     // background color
  out.u8(0);     // aspect
  out.bytes(pal, sizeof(pal));

  // Netscape looping extension
  out.u8(0x21);
  out.u8(0xFF);
  out.u8(11);
  out.bytes("NETSCAPE2.0", 11);
  out.u8(3);
  out.u8(1);
  out.u16(0);  // loop forever
  out.u8(0);

  std::vector<uint8_t> indexed(static_cast<size_t>(h) * w);
  for (int f = 0; f < frames; ++f) {
    quantize_frame(rgb + static_cast<size_t>(f) * h * w * 3, h, w, dither != 0,
                   indexed.data(), pal);

    // Graphic control extension (per-frame delay)
    out.u8(0x21);
    out.u8(0xF9);
    out.u8(4);
    out.u8(0x04);  // disposal: do not dispose
    out.u16(static_cast<uint16_t>(delay_cs));
    out.u8(0);  // no transparent color
    out.u8(0);

    // Image descriptor
    out.u8(0x2C);
    out.u16(0);
    out.u16(0);
    out.u16(static_cast<uint16_t>(w));
    out.u16(static_cast<uint16_t>(h));
    out.u8(0);  // no local color table

    LzwWriter lzw(out, 8);
    lzw.encode(indexed.data(), indexed.size());
  }
  out.u8(0x3B);  // trailer

  std::FILE* fp = std::fopen(path, "wb");
  if (!fp) return 2;
  size_t written = std::fwrite(out.buf.data(), 1, out.buf.size(), fp);
  std::fclose(fp);
  return written == out.buf.size() ? 0 : 3;
}
