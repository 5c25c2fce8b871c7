// deadtrees_io: the native reader of the training data path.
//
// The port's own copy of the JAX package's shard reader (the same tar
// index and TIFF decoder). The reference decodes TIFF samples with PIL on
// Python DataLoader workers (its deadtrees/data/deadtreedata.py:91-125,
// 348-370). This library does the host side of that work in native code,
// bound with ctypes by deadtrees_tpu_torch/data/native.py:
//
//   - tar_index():        parse ustar headers of a webdataset shard into an
//                         entry table (offset/size/name) without reading data
//   - tiff_decode():      baseline TIFF decoder for the shard sample format
//                         (classic little-endian TIFF, 8-bit, 1/3/4 samples,
//                         strips or tiles, compression none (1), LZW (5),
//                         deflate/zlib (8 and the legacy 32946 code) or
//                         PackBits (32773), horizontal predictor 2);
//                         planar (band-interleaved) files are refused
//   - decode_batch():     thread-pool batched decode of N tar members into
//                         one contiguous (N, H, W, C) uint8 buffer, ready for
//                         an upload to the card
//
// Build: data/native.py compiles this file with g++ at first use into
// build/torch_native/ (no make step, nothing at import).

#include <fcntl.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// tar index
// ---------------------------------------------------------------------------

struct TarEntry {
  int64_t offset;  // payload offset in file
  int64_t size;    // payload size in bytes
  char name[200];
};

static int64_t octal_field(const char* p, int len) {
  int64_t v = 0;
  for (int i = 0; i < len && p[i]; ++i) {
    if (p[i] >= '0' && p[i] <= '7') v = v * 8 + (p[i] - '0');
  }
  return v;
}

// Returns number of file entries found (<= max_entries), or -1 on error.
int64_t tar_index(const char* path, TarEntry* out, int64_t max_entries) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char header[512];
  int64_t n = 0;
  int64_t pos = 0;
  while (fread(header, 1, 512, f) == 512) {
    pos += 512;
    if (header[0] == '\0') break;  // end-of-archive blocks
    int64_t size = octal_field(header + 124, 12);
    char type = header[156];
    if ((type == '0' || type == '\0') && n < max_entries) {
      out[n].offset = pos;
      out[n].size = size;
      std::memset(out[n].name, 0, sizeof(out[n].name));
      std::memcpy(out[n].name, header, 100);  // the ustar name field
      ++n;
    }
    int64_t padded = (size + 511) & ~511LL;
    if (fseek(f, (long)padded, SEEK_CUR) != 0) break;
    pos += padded;
  }
  fclose(f);
  return n;
}

// ---------------------------------------------------------------------------
// TIFF decode (classic little-endian baseline subset)
// ---------------------------------------------------------------------------

static uint16_t rd16(const uint8_t* p) { return (uint16_t)(p[0] | p[1] << 8); }
static uint32_t rd32(const uint8_t* p) {
  return (uint32_t)(p[0] | p[1] << 8 | p[2] << 16 | ((uint32_t)p[3]) << 24);
}

struct TiffInfo {
  uint32_t width = 0, height = 0;
  uint16_t samples = 1, bits = 8, compression = 1, predictor = 1;
  uint16_t planar = 1;  // tag 284: only chunky (1) is supported
  uint32_t rows_per_strip = 0xFFFFFFFF;
  std::vector<uint32_t> strip_offsets, strip_counts;
  // tiled layout (tags 322-325) — GDAL's default for orthophotos and what
  // infer/geotiff.py write_geotiff(tiled=True) emits via rasterio
  uint32_t tile_width = 0, tile_length = 0;
  std::vector<uint32_t> tile_offsets, tile_counts;
};

static bool parse_ifd(const uint8_t* d, int64_t size, TiffInfo* info) {
  if (size < 8 || d[0] != 'I' || d[1] != 'I' || rd16(d + 2) != 42) return false;
  uint32_t ifd = rd32(d + 4);
  if (ifd + 2 > size) return false;
  uint16_t n = rd16(d + ifd);
  for (uint16_t i = 0; i < n; ++i) {
    const uint8_t* e = d + ifd + 2 + 12 * i;
    if (e + 12 > d + size) return false;
    uint16_t tag = rd16(e), type = rd16(e + 2);
    uint32_t count = rd32(e + 4);
    uint32_t value = (type == 3) ? rd16(e + 8) : rd32(e + 8);
    auto read_array = [&](std::vector<uint32_t>* out) -> bool {
      out->resize(count);
      if (count == 1) {
        (*out)[0] = value;
        return true;
      }
      uint32_t off = rd32(e + 8);
      int64_t elem = (type == 3) ? 2 : 4;
      if ((int64_t)off + elem * (int64_t)count > size) return false;
      for (uint32_t k = 0; k < count; ++k) {
        const uint8_t* q = d + off + elem * k;
        (*out)[k] = (type == 3) ? rd16(q) : rd32(q);
      }
      return true;
    };
    switch (tag) {
      case 256: info->width = value; break;
      case 257: info->height = value; break;
      case 258: {  // BitsPerSample: count>2 shorts live at an offset
        if (count == 1) {
          info->bits = (uint16_t)value;
        } else if (count == 2 && type == 3) {
          info->bits = rd16(e + 8);  // two shorts fit inline
        } else {
          uint32_t off = rd32(e + 8);
          if ((int64_t)off + 2 <= size) info->bits = rd16(d + off);
        }
        break;
      }
      case 259: info->compression = (uint16_t)value; break;
      case 273: if (!read_array(&info->strip_offsets)) return false; break;
      case 277: info->samples = (uint16_t)value; break;
      case 278: info->rows_per_strip = value; break;
      case 279: if (!read_array(&info->strip_counts)) return false; break;
      case 284: info->planar = (uint16_t)value; break;
      case 317: info->predictor = (uint16_t)value; break;
      case 322: info->tile_width = value; break;
      case 323: info->tile_length = value; break;
      case 324: if (!read_array(&info->tile_offsets)) return false; break;
      case 325: if (!read_array(&info->tile_counts)) return false; break;
      default: break;
    }
  }
  return info->width && info->height &&
         (!info->strip_offsets.empty() || !info->tile_offsets.empty());
}

// TIFF-variant LZW (MSB-first bit order, early code change).
static bool lzw_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                       int64_t cap, int64_t* written) {
  const int CLEAR = 256, EOI = 257;
  std::vector<std::pair<int, uint8_t>> table;  // (prev_code, byte)
  table.reserve(4096);
  auto reset = [&]() {
    table.clear();
    for (int i = 0; i < 256; ++i) table.push_back({-1, (uint8_t)i});
    table.push_back({-1, 0});  // CLEAR
    table.push_back({-1, 0});  // EOI
  };
  reset();
  int code_size = 9;
  uint64_t bits = 0;
  int nbits = 0;
  int64_t si = 0, di = 0;
  int prev = -1;
  std::vector<uint8_t> scratch;
  scratch.reserve(4096);

  auto expand = [&](int code, std::vector<uint8_t>* out) {
    out->clear();
    while (code >= 0) {
      out->push_back(table[code].second);
      code = table[code].first;
    }
    std::reverse(out->begin(), out->end());
  };

  while (true) {
    while (nbits < code_size && si < n) {
      bits = (bits << 8) | src[si++];
      nbits += 8;
    }
    if (nbits < code_size) break;
    int code = (int)((bits >> (nbits - code_size)) & ((1 << code_size) - 1));
    nbits -= code_size;

    if (code == EOI) break;
    if (code == CLEAR) {
      reset();
      code_size = 9;
      prev = -1;
      continue;
    }
    if (prev < 0) {
      if (code >= (int)table.size()) return false;
      expand(code, &scratch);
    } else {
      if (code < (int)table.size()) {
        expand(code, &scratch);
        table.push_back({prev, scratch[0]});
      } else if (code == (int)table.size()) {
        expand(prev, &scratch);
        scratch.push_back(scratch[0]);
        table.push_back({prev, scratch[0]});
      } else {
        return false;
      }
    }
    if (di + (int64_t)scratch.size() > cap) return false;
    std::memcpy(dst + di, scratch.data(), scratch.size());
    di += (int64_t)scratch.size();
    prev = code;
    // early change: grow code size one code before the table fills
    if ((int)table.size() + 1 >= (1 << code_size) && code_size < 12)
      ++code_size;
  }
  *written = di;
  return true;
}

// TIFF deflate (zlib stream per strip; compression tag 8, legacy 32946).
static bool deflate_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                           int64_t cap, int64_t* written) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = const_cast<Bytef*>(src);
  zs.avail_in = (uInt)n;
  zs.next_out = dst;
  zs.avail_out = (uInt)cap;
  int rc = inflate(&zs, Z_FINISH);
  *written = (int64_t)zs.total_out;
  inflateEnd(&zs);
  // Z_STREAM_END: clean strip. Z_OK/Z_BUF_ERROR with all input consumed can
  // occur on writers that omit the final flush; accept if bytes were made.
  return rc == Z_STREAM_END || (rc == Z_OK && *written > 0);
}

static bool packbits_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                            int64_t cap, int64_t* written) {
  int64_t si = 0, di = 0;
  while (si < n) {
    int8_t h = (int8_t)src[si++];
    if (h >= 0) {
      int64_t cnt = h + 1;
      if (si + cnt > n || di + cnt > cap) return false;
      std::memcpy(dst + di, src + si, cnt);
      si += cnt;
      di += cnt;
    } else if (h != -128) {
      int64_t cnt = 1 - h;
      if (si >= n || di + cnt > cap) return false;
      std::memset(dst + di, src[si++], cnt);
      di += cnt;
    }
  }
  *written = di;
  return true;
}

// Decompress one strip/tile payload. Returns 0 or the tiff_decode error
// code. `expect` is the exact decoded size required.
static int decompress_segment(uint16_t compression, const uint8_t* src,
                              int64_t cnt, uint8_t* dst, int64_t expect) {
  int64_t written = 0;
  if (compression == 1) {
    if (cnt < expect) return -4;
    std::memcpy(dst, src, expect);
    written = expect;
  } else if (compression == 5) {
    if (!lzw_decode(src, cnt, dst, expect, &written)) return -5;
  } else if (compression == 32773) {
    if (!packbits_decode(src, cnt, dst, expect, &written)) return -6;
  } else if (compression == 8 || compression == 32946) {
    if (!deflate_decode(src, cnt, dst, expect, &written)) return -10;
  } else {
    return -7;  // unsupported compression
  }
  return written == expect ? 0 : -8;
}

// horizontal-differencing predictor (tag 317 == 2) over a row-major
// buffer of `rows` rows x `row_bytes` (predictor resets per row)
static void undo_predictor2(uint8_t* buf, int64_t rows, int64_t row_bytes,
                            int samples) {
  for (int64_t y = 0; y < rows; ++y) {
    uint8_t* row = buf + y * row_bytes;
    for (int64_t x = samples; x < row_bytes; ++x)
      row[x] = (uint8_t)(row[x] + row[x - samples]);
  }
}

// Tiled layout (tags 322-325): decode each tile (always padded to full
// tile size in the file), undo the predictor per TILE row, then copy the
// clipped region into the image. Tile order: across, then down (TIFF 6.0).
static int decode_tiled(const uint8_t* data, int64_t size,
                        const TiffInfo& info, uint8_t* out) {
  uint32_t tw = info.tile_width, th = info.tile_length;
  if (!tw || !th) return -11;
  uint32_t across = (info.width + tw - 1) / tw;
  uint32_t down = (info.height + th - 1) / th;
  if (info.tile_offsets.size() < (size_t)across * down) return -12;
  int64_t tile_row_bytes = (int64_t)tw * info.samples;
  int64_t tile_bytes = tile_row_bytes * th;
  int64_t img_row_bytes = (int64_t)info.width * info.samples;
  std::vector<uint8_t> tile(tile_bytes);

  for (uint32_t ty = 0; ty < down; ++ty) {
    for (uint32_t tx = 0; tx < across; ++tx) {
      size_t idx = (size_t)ty * across + tx;
      uint32_t off = info.tile_offsets[idx];
      uint32_t cnt =
          idx < info.tile_counts.size() ? info.tile_counts[idx] : 0;
      if ((int64_t)off + cnt > size) return -3;
      int rc = decompress_segment(info.compression, data + off, cnt,
                                  tile.data(), tile_bytes);
      if (rc != 0) return rc;
      if (info.predictor == 2)
        undo_predictor2(tile.data(), th, tile_row_bytes, info.samples);

      int64_t rows = std::min<int64_t>(th, info.height - (int64_t)ty * th);
      int64_t col_bytes =
          std::min<int64_t>(tw, info.width - (int64_t)tx * tw) *
          info.samples;
      for (int64_t r = 0; r < rows; ++r) {
        std::memcpy(out + ((int64_t)ty * th + r) * img_row_bytes +
                        (int64_t)tx * tw * info.samples,
                    tile.data() + r * tile_row_bytes, col_bytes);
      }
    }
  }
  return 0;
}

// Decode a TIFF byte buffer into `out` (H*W*C uint8, row-major).
// Returns 0 on success; fills h/w/c. Pass out=null to only query dims.
int tiff_decode(const uint8_t* data, int64_t size, uint8_t* out, int32_t* h,
                int32_t* w, int32_t* c) {
  TiffInfo info;
  if (!parse_ifd(data, size, &info)) return -1;
  if (info.bits != 8) return -2;
  // Band-interleaved (PlanarConfiguration=2) files have samples x
  // ceil(h/rps) strips laid out per plane; this chunky-only decoder would
  // mis-size every strip. Refuse so the Python caller falls back to PIL.
  if (info.planar != 1) return -13;
  *h = (int32_t)info.height;
  *w = (int32_t)info.width;
  *c = (int32_t)info.samples;
  if (!out) return 0;

  if (!info.tile_offsets.empty()) return decode_tiled(data, size, info, out);

  int64_t row_bytes = (int64_t)info.width * info.samples;
  uint32_t rps = std::min<uint32_t>(info.rows_per_strip, info.height);
  if (rps == 0) rps = info.height;
  // The strip table must cover the image exactly: one strip per rps rows.
  // Anything else (e.g. a planar file that lied about tag 284, or a
  // truncated table) would walk `di` past the caller's H*W*C buffer.
  int64_t expect_strips = ((int64_t)info.height + rps - 1) / rps;
  if ((int64_t)info.strip_offsets.size() != expect_strips) return -14;

  int64_t di = 0;
  for (size_t s = 0; s < info.strip_offsets.size(); ++s) {
    uint32_t off = info.strip_offsets[s];
    uint32_t cnt = s < info.strip_counts.size() ? info.strip_counts[s] : 0;
    if ((int64_t)off + cnt > size) return -3;
    int64_t strip_rows =
        std::min<int64_t>(rps, info.height - (int64_t)s * rps);
    if (strip_rows <= 0) return -14;
    int64_t expect = strip_rows * row_bytes;
    int rc = decompress_segment(info.compression, data + off, cnt, out + di,
                                expect);
    if (rc != 0) return rc;
    di += expect;
  }

  if (info.predictor == 2)
    undo_predictor2(out, info.height, row_bytes, info.samples);
  return 0;
}

// ---------------------------------------------------------------------------
// threaded batch decode
// ---------------------------------------------------------------------------

// Read `size` bytes at `off` of `fd` into `dst`; false on a short read.
static bool read_span(int fd, int64_t off, int64_t size, uint8_t* dst) {
  while (size > 0) {
    ssize_t r = pread(fd, dst, (size_t)size, (off_t)off);
    if (r < 0 && errno == EINTR) continue;
    if (r <= 0) return false;
    dst += r;
    off += r;
    size -= r;
  }
  return true;
}

// Decode n TIFF members of one tar file (given payload offsets/sizes) into a
// contiguous (n, h, w, c) uint8 buffer. All members must share dims.
// Returns 0 on success, else the first nonzero member status. Each worker
// reads its members with pread into one buffer of its own, reused member to
// member: no copy of the whole batch is held, and no memory is taken anew
// for each member.
int decode_batch(const char* tar_path, const int64_t* offsets,
                 const int64_t* sizes, int64_t n, uint8_t* out, int32_t h,
                 int32_t w, int32_t c, int32_t n_threads) {
  int fd = open(tar_path, O_RDONLY);
  if (fd < 0) return -100;
  int64_t sample_bytes = (int64_t)h * w * c;
  std::atomic<int64_t> next(0);
  std::atomic<int> status(0);
  auto fail = [&](int rc) {
    int expected = 0;
    status.compare_exchange_strong(expected, rc);
  };
  auto worker = [&]() {
    std::vector<uint8_t> blob;
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= n || status.load() != 0) return;
      if (blob.size() < (size_t)sizes[i]) blob.resize((size_t)sizes[i]);
      if (!read_span(fd, offsets[i], sizes[i], blob.data())) {
        fail(-101);
        return;
      }
      int32_t hh, ww, cc;
      // dims first: a member of other dims must not write past its slot
      int rc = tiff_decode(blob.data(), sizes[i], nullptr, &hh, &ww, &cc);
      if (rc == 0 && hh == h && ww == w && cc == c)
        rc = tiff_decode(blob.data(), sizes[i], out + i * sample_bytes, &hh,
                         &ww, &cc);
      if (rc != 0 || hh != h || ww != w || cc != c) fail(rc != 0 ? rc : -9);
    }
  };
  int t = (int)std::max<int64_t>(1, std::min<int64_t>(n_threads, n));
  std::vector<std::thread> pool;
  for (int i = 0; i < t; ++i) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  close(fd);
  return status.load();
}

}  // extern "C"
