// igsio — the host data plane of igs_tpu_torch.
//
// The port's own copy of native/igsio.cpp (the JAX package's data plane):
// a zlib PNG decoder (8/16-bit grey, grey+alpha, RGB, RGBA, non-interlaced,
// all five scanline filters) with a thread pool for batch decode into a
// pre-allocated NCHW float32 buffer, and the binary PLY vertex reader. A
// plain C interface, loaded with ctypes by igs_tpu_torch/data/native.py.
// Beside the JAX copy's batch call, igsio_load_png_batch_status reports
// each path's result, so that a refused file can be named.
//
// Built at first use by igs_tpu_torch/ops/host_build.py:
//   g++ -O3 -march=native -fPIC -std=c++17 -shared igsio.cpp -lz -lpthread

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <thread>
#include <atomic>
#include <zlib.h>

namespace {

struct Buf {
  std::vector<uint8_t> data;
};

static uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

static bool read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out.resize(size_t(n));
  size_t got = fread(out.data(), 1, size_t(n), f);
  fclose(f);
  return got == size_t(n);
}

static int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Decode a PNG into raw (h, w, channels) samples at the file's bit depth.
// Returns 0 on success. out is malloc'd (bitdepth 16 → uint16 big-endian
// already converted to host order).
// With want_w > 0, a size other than (want_w, want_h) returns -101 before
// anything is allocated.
static int decode_png(const std::vector<uint8_t>& file, uint8_t** out,
                      int* W, int* H, int* C, int* bitdepth,
                      int want_w = 0, int want_h = 0) {
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (file.size() < 8 || memcmp(file.data(), sig, 8) != 0) return -1;
  size_t pos = 8;
  int w = 0, h = 0, depth = 0, color = 0, interlace = 0;
  std::vector<uint8_t> idat;
  while (pos + 8 <= file.size()) {
    uint32_t len = be32(&file[pos]);
    const char* type = reinterpret_cast<const char*>(&file[pos + 4]);
    const uint8_t* data = &file[pos + 8];
    if (pos + 12 + len > file.size()) return -2;
    if (memcmp(type, "IHDR", 4) == 0) {
      w = int(be32(data));
      h = int(be32(data + 4));
      depth = data[8];
      color = data[9];
      interlace = data[12];
    } else if (memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), data, data + len);
    } else if (memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + len;
  }
  if (w <= 0 || h <= 0 || interlace != 0) return -3;
  if (want_w > 0 && (w != want_w || h != want_h)) return -101;
  int ch;
  switch (color) {
    case 0: ch = 1; break;  // gray
    case 2: ch = 3; break;  // rgb
    case 4: ch = 2; break;  // gray+alpha
    case 6: ch = 4; break;  // rgba
    default: return -4;     // palette unsupported
  }
  if (depth != 8 && depth != 16) return -5;

  int bpp = ch * depth / 8;               // bytes per pixel
  size_t stride = size_t(w) * bpp;        // bytes per scanline (no filter)
  std::vector<uint8_t> raw(size_t(h) * (stride + 1));
  uLongf raw_len = uLongf(raw.size());
  if (uncompress(raw.data(), &raw_len, idat.data(), uLong(idat.size())) != Z_OK)
    return -6;

  uint8_t* img = static_cast<uint8_t*>(malloc(size_t(h) * stride));
  if (!img) return -7;
  std::vector<uint8_t> prev(stride, 0);
  for (int y = 0; y < h; y++) {
    const uint8_t* src = &raw[size_t(y) * (stride + 1)];
    uint8_t filter = src[0];
    const uint8_t* line = src + 1;
    uint8_t* dst = img + size_t(y) * stride;
    for (size_t x = 0; x < stride; x++) {
      int a = (x >= size_t(bpp)) ? dst[x - bpp] : 0;
      int b = prev[x];
      int c = (x >= size_t(bpp)) ? prev[x - bpp] : 0;
      int v = line[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: free(img); return -8;
      }
      dst[x] = uint8_t(v);
    }
    memcpy(prev.data(), dst, stride);
  }
  if (depth == 16) {
    // big-endian → host-order uint16 in place
    for (size_t i = 0; i + 1 < size_t(h) * stride; i += 2) {
      uint8_t hi = img[i], lo = img[i + 1];
      uint16_t v = uint16_t(hi) << 8 | lo;
      memcpy(img + i, &v, 2);
    }
  }
  *out = img;
  *W = w;
  *H = h;
  *C = ch;
  *bitdepth = depth;
  return 0;
}

}  // namespace

extern "C" {

int igsio_load_png(const char* path, uint8_t** out, int* w, int* h,
                   int* c, int* bitdepth) {
  std::vector<uint8_t> file;
  if (!read_file(path, file)) return -100;
  return decode_png(file, out, w, h, c, bitdepth);
}

void igsio_free(void* p) { free(p); }

// Batch-decode PNGs into a pre-allocated NCHW float32 buffer of shape
// (n, out_c, h, w), scaled by `scale` (1/255 for images, 1/1000 for depth
// after the uint16 read). Returns the number of failed paths; when
// `status` is not null, status[i] receives path i's result: 0, the
// decoder's negative code, -100 for an unreadable file or -101 for a size
// other than (h, w). Threads default to hardware concurrency.
int igsio_load_png_batch_status(const char** paths, int n, float* out,
                                int h, int w, int out_c, float scale,
                                int threads, int* status) {
  if (threads <= 0) threads = int(std::thread::hardware_concurrency());
  if (threads <= 0) threads = 4;
  std::atomic<int> next(0), failed(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      uint8_t* img = nullptr;
      int iw = 0, ih = 0, ic = 0, depth = 0;
      std::vector<uint8_t> file;
      int rc = read_file(paths[i], file) ? 0 : -100;
      if (rc == 0) rc = decode_png(file, &img, &iw, &ih, &ic, &depth, w, h);
      if (status) status[i] = rc;
      if (rc != 0) {
        if (img) free(img);
        failed.fetch_add(1);
        continue;
      }
      float* dst = out + size_t(i) * out_c * h * w;
      size_t hw = size_t(h) * w;
      for (int cc = 0; cc < out_c; cc++) {
        int src_c = cc < ic ? cc : ic - 1;  // broadcast gray → rgb
        if (depth == 8) {
          const uint8_t* s = img;
          for (size_t p = 0; p < hw; p++)
            dst[cc * hw + p] = float(s[p * ic + src_c]) * scale;
        } else {
          const uint16_t* s = reinterpret_cast<const uint16_t*>(img);
          for (size_t p = 0; p < hw; p++)
            dst[cc * hw + p] = float(s[p * ic + src_c]) * scale;
        }
      }
      free(img);
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; t++) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return failed.load();
}

int igsio_load_png_batch_f32(const char** paths, int n, float* out,
                             int h, int w, int out_c, float scale,
                             int threads) {
  return igsio_load_png_batch_status(paths, n, out, h, w, out_c, scale,
                                     threads, nullptr);
}

// --- PLY ------------------------------------------------------------------
// Parses a binary_little_endian PLY header; copies the vertex block into a
// caller-provided buffer (already sized count*stride). Property metadata is
// returned as a packed string "name:dtype;name:dtype;...".
int igsio_ply_info(const char* path, long* vertex_count, int* stride,
                   char* props, int props_cap, long* data_offset) {
  std::vector<uint8_t> file;
  if (!read_file(path, file)) return -100;
  const char* end_tag = "end_header\n";
  std::string head(reinterpret_cast<const char*>(file.data()),
                   std::min<size_t>(file.size(), 65536));
  size_t he = head.find(end_tag);
  if (he == std::string::npos) return -1;
  *data_offset = long(he + strlen(end_tag));
  std::string out_props;
  long count = 0;
  int st = 0;
  bool in_vertex = false;
  size_t ls = 0;
  while (ls < he) {
    size_t le = head.find('\n', ls);
    std::string line = head.substr(ls, le - ls);
    ls = le + 1;
    if (line.rfind("element ", 0) == 0) {
      in_vertex = line.rfind("element vertex ", 0) == 0;
      if (in_vertex) count = atol(line.c_str() + 15);
    } else if (in_vertex && line.rfind("property ", 0) == 0) {
      char typ[32], name[64];
      if (sscanf(line.c_str(), "property %31s %63s", typ, name) == 2) {
        int sz = 4;
        const char* dt = "f4";
        std::string t(typ);
        if (t == "float" || t == "float32") { sz = 4; dt = "f4"; }
        else if (t == "double" || t == "float64") { sz = 8; dt = "f8"; }
        else if (t == "uchar" || t == "uint8") { sz = 1; dt = "u1"; }
        else if (t == "char" || t == "int8") { sz = 1; dt = "i1"; }
        else if (t == "short") { sz = 2; dt = "i2"; }
        else if (t == "ushort") { sz = 2; dt = "u2"; }
        else if (t == "int" || t == "int32") { sz = 4; dt = "i4"; }
        else if (t == "uint" || t == "uint32") { sz = 4; dt = "u4"; }
        else return -2;
        st += sz;
        out_props += std::string(name) + ":" + dt + ";";
      }
    }
  }
  if (int(out_props.size()) + 1 > props_cap) return -3;
  strcpy(props, out_props.c_str());
  *vertex_count = count;
  *stride = st;
  return 0;
}

int igsio_ply_read(const char* path, long data_offset, uint8_t* out,
                   long nbytes) {
  FILE* f = fopen(path, "rb");
  if (!f) return -100;
  fseek(f, data_offset, SEEK_SET);
  size_t got = fread(out, 1, size_t(nbytes), f);
  fclose(f);
  return got == size_t(nbytes) ? 0 : -1;
}

}  // extern "C"
