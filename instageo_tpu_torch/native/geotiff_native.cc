// Native GeoTIFF decoder: the host path that feeds the card with chips.
//
// The port's own copy of the JAX package's decoder (instageo_tpu/native/
// geotiff_native.cc): TIFF parsing, zlib/LZW decompression, predictor undo,
// and a thread pool for batch chip decode. Exposed through a C ABI consumed
// via ctypes (instageo_tpu_torch/native/__init__.py, which builds it with g++
// at first use); the pure-Python codec (instageo_tpu_torch/data/geotiff.py) is
// the reference implementation and the fallback.
//
// Supported subset (everything the framework writes + HLS/S2 COGs):
// little-endian classic TIFF, striped & tiled, chunky & planar, compressions
// none/LZW/deflate/packbits, horizontal predictor, u8/i8/u16/i16/u32/i32/
// f32/f64 samples.
//
// zlib: only uncompress() is called. Where zlib's header is not installed
// (a machine with the runtime library libz.so.1 but no development files),
// the two declarations it needs stand in for it; the library is linked
// either way.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <thread>
#include <atomic>
#include <mutex>

#if __has_include(<zlib.h>)
#include <zlib.h>
#else
extern "C" int uncompress(unsigned char* dest, unsigned long* dest_len,
                          const unsigned char* source, unsigned long source_len);
typedef unsigned long uLongf;
typedef unsigned long uLong;
#define Z_OK 0
#endif

namespace {

thread_local std::string g_error;

void set_error(const std::string& msg) { g_error = msg; }

struct Tag {
  uint16_t id;
  uint16_t type;
  uint32_t count;
  std::vector<uint64_t> ivals;
  std::vector<double> dvals;
};

struct TiffInfo {
  int64_t width = 0, height = 0, bands = 1;
  int bits = 8, sample_format = 1, compression = 1, planar = 1, predictor = 1;
  int64_t rows_per_strip = 0;
  int64_t tile_w = 0, tile_h = 0;
  std::vector<uint64_t> offsets, counts;
  bool tiled = false;
};

inline uint16_t rd16(const uint8_t* p) { return (uint16_t)(p[0] | p[1] << 8); }
inline uint32_t rd32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

size_t type_size(uint16_t t) {
  switch (t) {
    case 1: case 2: case 6: case 7: return 1;
    case 3: case 8: return 2;
    case 4: case 9: case 11: return 4;
    case 5: case 10: case 12: case 16: case 17: return 8;
    default: return 1;
  }
}

bool parse_tag(const uint8_t* data, size_t size, const uint8_t* entry,
               Tag* tag) {
  tag->id = rd16(entry);
  tag->type = rd16(entry + 2);
  tag->count = rd32(entry + 4);
  size_t esz = type_size(tag->type);
  size_t total = esz * tag->count;
  const uint8_t* src;
  if (total <= 4) {
    src = entry + 8;
  } else {
    uint32_t off = rd32(entry + 8);
    if ((size_t)off + total > size) return false;
    src = data + off;
  }
  tag->ivals.reserve(tag->count);
  for (uint32_t i = 0; i < tag->count; ++i) {
    const uint8_t* p = src + i * esz;
    switch (tag->type) {
      case 1: case 2: case 6: case 7: tag->ivals.push_back(p[0]); break;
      case 3: case 8: tag->ivals.push_back(rd16(p)); break;
      case 4: case 9: case 11: tag->ivals.push_back(rd32(p)); break;
      case 5: {  // rational
        uint32_t num = rd32(p), den = rd32(p + 4);
        tag->dvals.push_back(den ? (double)num / den : 0.0);
        tag->ivals.push_back(num);
        break;
      }
      case 12: {
        double d;
        memcpy(&d, p, 8);
        tag->dvals.push_back(d);
        tag->ivals.push_back((uint64_t)d);
        break;
      }
      default: tag->ivals.push_back(0);
    }
  }
  return true;
}

// --- LZW (TIFF variant, MSB-first, libtiff width-change convention) --------
bool lzw_decode(const uint8_t* in, size_t in_len, uint8_t* out,
                size_t out_len) {
  constexpr int kClear = 256, kEoi = 257;
  // Table entries store (prev_code, last_byte, length).
  std::vector<int> prev(4096), length(4096);
  std::vector<uint8_t> last(4096);
  auto reset = [&]() {
    for (int i = 0; i < 256; ++i) {
      prev[i] = -1;
      last[i] = (uint8_t)i;
      length[i] = 1;
    }
  };
  reset();
  int next_code = 258, code_bits = 9;
  uint32_t buf = 0;
  int nbits = 0;
  int prev_code = -1;
  size_t out_pos = 0;
  std::vector<uint8_t> scratch(4096);

  auto emit = [&](int code) -> bool {
    int n = length[code];
    if (out_pos + (size_t)n > out_len) n = (int)(out_len - out_pos);
    int c = code;
    for (int i = length[code] - 1; i >= 0; --i) {
      if (i < n) scratch[i] = last[c];
      else (void)last[c];
      c = prev[c];
    }
    memcpy(out + out_pos, scratch.data(), n);
    out_pos += n;
    return true;
  };

  for (size_t i = 0; i < in_len; ++i) {
    buf = (buf << 8) | in[i];
    nbits += 8;
    while (nbits >= code_bits) {
      nbits -= code_bits;
      int code = (int)((buf >> nbits) & ((1u << code_bits) - 1));
      if (code == kClear) {
        reset();
        next_code = 258;
        code_bits = 9;
        prev_code = -1;
        continue;
      }
      if (code == kEoi) return true;
      if (prev_code < 0) {
        if (code >= 256) return false;
        emit(code);
        prev_code = code;
      } else {
        int entry;
        if (code < next_code) {
          entry = code;
        } else if (code == next_code) {
          entry = -1;  // KwKwK case
        } else {
          return false;
        }
        // add new entry prev_code + first(entry)
        int first_src = entry >= 0 ? entry : prev_code;
        int c = first_src;
        while (prev[c] >= 0) c = prev[c];
        uint8_t first_byte = last[c];
        if (next_code < 4096) {
          prev[next_code] = prev_code;
          last[next_code] = first_byte;
          length[next_code] = length[prev_code] + 1;
          if (entry < 0) entry = next_code;
          next_code++;
        } else if (entry < 0) {
          return false;
        }
        emit(entry);
        prev_code = entry;
        if (next_code + 1 >= (1 << code_bits) && code_bits < 12) code_bits++;
      }
      if (out_pos >= out_len) return true;
    }
  }
  return true;
}

bool packbits_decode(const uint8_t* in, size_t in_len, uint8_t* out,
                     size_t out_len) {
  size_t i = 0, o = 0;
  while (i < in_len && o < out_len) {
    uint8_t h = in[i++];
    if (h < 128) {
      size_t n = h + 1;
      if (i + n > in_len) n = in_len - i;
      if (o + n > out_len) n = out_len - o;
      memcpy(out + o, in + i, n);
      i += n;
      o += n;
    } else if (h > 128) {
      size_t n = 257 - h;
      if (i >= in_len) break;
      if (o + n > out_len) n = out_len - o;
      memset(out + o, in[i], n);
      i += 1;
      o += n;
    }
  }
  return true;
}

bool decompress(int compression, const uint8_t* in, size_t in_len,
                uint8_t* out, size_t out_len) {
  switch (compression) {
    case 1:
      memcpy(out, in, in_len < out_len ? in_len : out_len);
      return true;
    case 8:
    case 32946: {
      uLongf dst = (uLongf)out_len;
      return uncompress(out, &dst, in, (uLong)in_len) == Z_OK;
    }
    case 5:
      return lzw_decode(in, in_len, out, out_len);
    case 32773:
      return packbits_decode(in, in_len, out, out_len);
    default:
      return false;
  }
}

template <typename T>
void undo_predictor_rows(T* data, int64_t rows, int64_t cols, int64_t comps) {
  for (int64_t r = 0; r < rows; ++r) {
    T* row = data + r * cols * comps;
    for (int64_t c = 1; c < cols; ++c)
      for (int64_t k = 0; k < comps; ++k)
        row[c * comps + k] = (T)(row[c * comps + k] + row[(c - 1) * comps + k]);
  }
}

void undo_predictor(uint8_t* data, int bits, int64_t rows, int64_t cols,
                    int64_t comps) {
  if (bits == 8) undo_predictor_rows((uint8_t*)data, rows, cols, comps);
  else if (bits == 16) undo_predictor_rows((uint16_t*)data, rows, cols, comps);
  else if (bits == 32) undo_predictor_rows((uint32_t*)data, rows, cols, comps);
}

struct FileBuf {
  std::vector<uint8_t> data;
  bool load(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return false;
    fseek(f, 0, SEEK_END);
    long n = ftell(f);
    fseek(f, 0, SEEK_SET);
    data.resize(n);
    size_t got = fread(data.data(), 1, n, f);
    fclose(f);
    return got == (size_t)n;
  }
};

bool parse_info(const uint8_t* d, size_t n, TiffInfo* info) {
  if (n < 8 || d[0] != 'I' || d[1] != 'I' || rd16(d + 2) != 42) {
    set_error("not a little-endian classic TIFF");
    return false;
  }
  uint32_t off = rd32(d + 4);
  if ((size_t)off + 2 > n) return false;
  uint16_t count = rd16(d + off);
  const uint8_t* entries = d + off + 2;
  if ((size_t)off + 2 + count * 12 + 4 > n) return false;
  for (int i = 0; i < count; ++i) {
    Tag tag;
    if (!parse_tag(d, n, entries + i * 12, &tag)) return false;
    switch (tag.id) {
      case 256: info->width = tag.ivals[0]; break;
      case 257: info->height = tag.ivals[0]; break;
      case 258: info->bits = (int)tag.ivals[0]; break;
      case 259: info->compression = (int)tag.ivals[0]; break;
      case 277: info->bands = tag.ivals[0]; break;
      case 278: info->rows_per_strip = tag.ivals[0]; break;
      case 273: case 324:
        info->offsets.assign(tag.ivals.begin(), tag.ivals.end());
        if (tag.id == 324) info->tiled = true;
        break;
      case 279: case 325:
        info->counts.assign(tag.ivals.begin(), tag.ivals.end());
        break;
      case 284: info->planar = (int)tag.ivals[0]; break;
      case 317: info->predictor = (int)tag.ivals[0]; break;
      case 322: info->tile_w = tag.ivals[0]; break;
      case 323: info->tile_h = tag.ivals[0]; break;
      case 339: info->sample_format = (int)tag.ivals[0]; break;
    }
  }
  if (info->rows_per_strip == 0) info->rows_per_strip = info->height;
  // Malformed files must fail parsing, not index out of bounds later:
  // every offset needs a matching byte count, and each referenced range
  // must lie inside the file (uint64 sums cannot wrap for n <= SIZE_MAX).
  if (info->counts.size() < info->offsets.size()) {
    set_error("byte-count tag shorter than offsets tag");
    return false;
  }
  return info->width > 0 && info->height > 0 && !info->offsets.empty();
}

// Decode the first IFD of `d` into out (bands, h, w) planar layout.
bool decode_tiff(const uint8_t* d, size_t n, uint8_t* out, size_t out_bytes) {
  TiffInfo info;
  if (!parse_info(d, n, &info)) return false;
  if (info.predictor != 1 && info.predictor != 2) {
    // e.g. 3 = floating-point predictor: decoding without undoing it
    // returns silently corrupt pixels — fail like unsupported
    // compression does (callers fall back to the Python reader, which
    // raises the same way).
    set_error("TIFF predictor not supported");
    return false;
  }
  int64_t bs = info.bits / 8;
  size_t need = (size_t)(info.width * info.height * info.bands * bs);
  if (out_bytes < need) {
    set_error("output buffer too small");
    return false;
  }
  int64_t W = info.width, H = info.height, S = info.bands;

  // block: (rows, cols, S) interleaved -> out planar (S, H, W). Typed
  // strided loops (not per-pixel memcpy) so the compiler vectorizes the
  // de-interleave — this is the hot transpose of the input pipeline.
  auto place_typed = [&](auto* typed_out, const auto* typed_block,
                         int64_t rows, int64_t cols, int64_t row0,
                         int64_t col0) {
    for (int64_t s = 0; s < S; ++s) {
      auto* plane = typed_out + (size_t)s * H * W;
      for (int64_t r = 0; r < rows; ++r) {
        int64_t out_r = row0 + r;
        if (out_r >= H) break;
        const auto* src = typed_block + (size_t)r * cols * S + s;
        auto* dst = plane + (size_t)out_r * W + col0;
        int64_t ncols = cols;
        if (col0 + ncols > W) ncols = W - col0;
        if (S == 1) {
          memcpy(dst, src, (size_t)ncols * sizeof(*dst));
        } else {
          for (int64_t c = 0; c < ncols; ++c) dst[c] = src[c * S];
        }
      }
    }
  };
  auto place_chunky = [&](const uint8_t* block, int64_t rows, int64_t cols,
                          int64_t row0, int64_t col0) {
    switch (bs) {
      case 1:
        place_typed((uint8_t*)out, block, rows, cols, row0, col0);
        break;
      case 2:
        place_typed((uint16_t*)out, (const uint16_t*)block, rows, cols, row0,
                    col0);
        break;
      case 4:
        place_typed((uint32_t*)out, (const uint32_t*)block, rows, cols, row0,
                    col0);
        break;
      case 8:
        place_typed((uint64_t*)out, (const uint64_t*)block, rows, cols, row0,
                    col0);
        break;
    }
  };

  std::vector<uint8_t> block;
  if (!info.tiled) {
    int64_t strips_per_band =
        (H + info.rows_per_strip - 1) / info.rows_per_strip;
    // Extra offsets beyond the image geometry (malformed file) would
    // otherwise index bands past the output buffer or make `rows` go
    // negative (size_t-wrapping resize) — clamp to the valid count.
    int64_t expect =
        strips_per_band * (info.planar == 2 ? S : 1);
    int64_t total = std::min<int64_t>((int64_t)info.offsets.size(), expect);
    for (int64_t idx = 0; idx < total; ++idx) {
      int64_t band = 0, strip = idx;
      if (info.planar == 2) {
        band = idx / strips_per_band;
        strip = idx % strips_per_band;
      }
      int64_t row0 = strip * info.rows_per_strip;
      int64_t rows = std::min<int64_t>(info.rows_per_strip, H - row0);
      if (band >= S || rows <= 0) return false;
      int64_t comps = info.planar == 1 ? S : 1;
      size_t raw = (size_t)(rows * W * comps * bs);
      block.resize(raw);
      if (info.offsets[idx] > n || info.counts[idx] > n - info.offsets[idx])
        return false;  // overflow-safe range check
      if (!decompress(info.compression, d + info.offsets[idx],
                      info.counts[idx], block.data(), raw)) {
        set_error("decompress failed");
        return false;
      }
      if (info.predictor == 2)
        undo_predictor(block.data(), info.bits, rows, W, comps);
      if (info.planar == 1) {
        place_chunky(block.data(), rows, W, row0, 0);
      } else {
        uint8_t* plane = out + (size_t)band * H * W * bs;
        memcpy(plane + (size_t)row0 * W * bs, block.data(), raw);
      }
    }
  } else {
    int64_t tw = info.tile_w, th = info.tile_h;
    if (tw <= 0 || th <= 0) return false;
    int64_t tiles_x = (W + tw - 1) / tw, tiles_y = (H + th - 1) / th;
    int64_t per_band = tiles_x * tiles_y;
    // Clamp to the geometry-implied tile count (see strip path above).
    int64_t expect = per_band * (info.planar == 2 ? S : 1);
    int64_t total = std::min<int64_t>((int64_t)info.offsets.size(), expect);
    for (int64_t idx = 0; idx < total; ++idx) {
      int64_t band = 0, t = idx;
      if (info.planar == 2) {
        band = idx / per_band;
        t = idx % per_band;
      }
      if (band >= S) return false;
      int64_t ty = t / tiles_x, tx = t % tiles_x;
      int64_t comps = info.planar == 1 ? S : 1;
      size_t raw = (size_t)(th * tw * comps * bs);
      block.resize(raw);
      if (info.offsets[idx] > n || info.counts[idx] > n - info.offsets[idx])
        return false;  // overflow-safe range check
      if (!decompress(info.compression, d + info.offsets[idx],
                      info.counts[idx], block.data(), raw)) {
        set_error("decompress failed");
        return false;
      }
      if (info.predictor == 2)
        undo_predictor(block.data(), info.bits, th, tw, comps);
      if (info.planar == 1) {
        place_chunky(block.data(), std::min(th, H - ty * th), tw, ty * th,
                     tx * tw);
      } else {
        uint8_t* plane = out + (size_t)band * H * W * bs;
        int64_t rows = std::min(th, H - ty * th);
        int64_t cols = std::min(tw, W - tx * tw);
        for (int64_t r = 0; r < rows; ++r)
          memcpy(plane + ((size_t)(ty * th + r) * W + tx * tw) * bs,
                 block.data() + (size_t)r * tw * bs, (size_t)cols * bs);
      }
    }
  }
  return true;
}

int dtype_code(const TiffInfo& info) {
  // 1=u8 2=u16 3=i16 4=i32 5=f32 6=f64 7=i8 8=u32
  if (info.sample_format == 3) return info.bits == 64 ? 6 : 5;
  if (info.sample_format == 2) {
    if (info.bits == 8) return 7;
    if (info.bits == 16) return 3;
    return 4;
  }
  if (info.bits == 8) return 1;
  if (info.bits == 16) return 2;
  return 8;
}

}  // namespace

extern "C" {

const char* igt_version() { return "instageo-native 0.1.0"; }

const char* igt_last_error() { return g_error.c_str(); }

int igt_open_info(const char* path, int64_t* width, int64_t* height,
                  int64_t* bands, int32_t* dtype) {
  FileBuf fb;
  if (!fb.load(path)) {
    set_error(std::string("cannot read ") + path);
    return 1;
  }
  TiffInfo info;
  if (!parse_info(fb.data.data(), fb.data.size(), &info)) return 2;
  *width = info.width;
  *height = info.height;
  *bands = info.bands;
  *dtype = dtype_code(info);
  return 0;
}

int igt_read_full(const char* path, void* out, int64_t out_bytes) {
  FileBuf fb;
  if (!fb.load(path)) {
    set_error(std::string("cannot read ") + path);
    return 1;
  }
  return decode_tiff(fb.data.data(), fb.data.size(), (uint8_t*)out,
                     (size_t)out_bytes)
             ? 0
             : 2;
}

// Batch decode: n same-shape rasters into a contiguous output buffer,
// decoded concurrently on a thread pool. Returns number of failures;
// failed slots are zero-filled.
int igt_read_batch(const char** paths, int n, void* out,
                   int64_t bytes_per_item, int n_threads) {
  std::atomic<int> next(0), failures(0);
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads > n) n_threads = n;
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      uint8_t* dst = (uint8_t*)out + (size_t)i * bytes_per_item;
      FileBuf fb;
      if (!fb.load(paths[i]) ||
          !decode_tiff(fb.data.data(), fb.data.size(), dst,
                       (size_t)bytes_per_item)) {
        memset(dst, 0, (size_t)bytes_per_item);
        failures.fetch_add(1);
      }
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return failures.load();
}

}  // extern "C"
