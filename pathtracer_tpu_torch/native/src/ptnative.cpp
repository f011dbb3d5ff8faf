// Native host runtime of pathtracer_tpu_torch: the OBJ parser and the PNG
// encoder, behind a plain C interface loaded with ctypes
// (pathtracer_tpu_torch/native/bindings.py). Device work stays in PyTorch
// and the CUDA kernels of csrc/.
//
// The port's own copy of the reference's pathtracer_tpu/native/src/
// ptnative.cpp, with one difference: a line is read whole (getline), where
// the reference cuts it into pieces of 4,095 bytes (fgets into char[4096]).
// Everything else parses and encodes as the reference does, so
// io/obj.load_obj_python and io/png.encode_png are its plain twins.
//
// Build (native/build.py): g++ -O3 -shared -fPIC -std=c++17 ptnative.cpp
//   -o libptnative_<hash>.so -lz

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <zlib.h>

namespace {

struct ObjData {
  std::vector<float> verts;    // xyz triples
  std::vector<int32_t> faces;  // triangle index triples (0-based)
};

// A record is a line whose first byte is 'v' or 'f' and whose second is a
// space or a tab. "v": sscanf's "%lf %lf %lf", each number rounded to
// float; fewer than three numbers skip the record. "f": tokens split by
// spaces and tabs, each read as far as its leading strtol integer (the
// rest, such as /vt/vn, skipped); the first token without one ends the
// record. i > 0 is vertex i - 1, any other i is nverts + i (nverts: the
// vertices read so far). Polygons are fan-triangulated.
bool parse_obj(const char* path, ObjData* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  char* line = nullptr;
  size_t cap = 0;
  std::vector<long> face_idx;
  while (getline(&line, &cap, f) != -1) {
    if (line[0] == 'v' && (line[1] == ' ' || line[1] == '\t')) {
      double x = 0, y = 0, z = 0;
      if (std::sscanf(line + 2, "%lf %lf %lf", &x, &y, &z) == 3) {
        out->verts.push_back((float)x);
        out->verts.push_back((float)y);
        out->verts.push_back((float)z);
      }
    } else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
      face_idx.clear();
      const char* p = line + 2;
      long nverts = (long)out->verts.size() / 3;
      while (*p) {
        while (*p == ' ' || *p == '\t') ++p;
        if (*p == '\0' || *p == '\n' || *p == '\r') break;
        char* end = nullptr;
        long idx = std::strtol(p, &end, 10);
        if (end == p) break;
        p = end;
        // skip /vt/vn part of the token
        while (*p && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r') ++p;
        face_idx.push_back(idx > 0 ? idx - 1 : nverts + idx);
      }
      for (size_t k = 1; k + 1 < face_idx.size(); ++k) {
        out->faces.push_back((int32_t)face_idx[0]);
        out->faces.push_back((int32_t)face_idx[k]);
        out->faces.push_back((int32_t)face_idx[k + 1]);
      }
    }
  }
  bool ok = !std::ferror(f);
  std::free(line);
  std::fclose(f);
  return ok;
}

void put_be32(std::vector<uint8_t>& buf, uint32_t v) {
  buf.push_back((uint8_t)(v >> 24));
  buf.push_back((uint8_t)(v >> 16));
  buf.push_back((uint8_t)(v >> 8));
  buf.push_back((uint8_t)v);
}

void put_chunk(std::vector<uint8_t>& out, const char tag[4],
               const uint8_t* data, size_t len) {
  put_be32(out, (uint32_t)len);
  size_t start = out.size();
  out.insert(out.end(), tag, tag + 4);
  if (len) out.insert(out.end(), data, data + len);
  uLong crc = crc32(0L, out.data() + start, (uInt)(len + 4));
  put_be32(out, (uint32_t)crc);
}

}  // namespace

extern "C" {

// First pass: count vertices and (triangulated) faces. 0 on success, 1
// when the file cannot be opened or read (errno says why).
int pt_obj_counts(const char* path, long* n_verts, long* n_faces) {
  ObjData data;
  if (!parse_obj(path, &data)) return 1;
  *n_verts = (long)(data.verts.size() / 3);
  *n_faces = (long)(data.faces.size() / 3);
  return 0;
}

// Second pass: fill caller-allocated arrays; 2 when the counts differ from
// the first pass's (the file changed in between).
int pt_obj_load(const char* path, float* verts, long n_verts, int32_t* faces,
                long n_faces) {
  ObjData data;
  if (!parse_obj(path, &data)) return 1;
  if ((long)(data.verts.size() / 3) != n_verts ||
      (long)(data.faces.size() / 3) != n_faces)
    return 2;
  std::memcpy(verts, data.verts.data(), data.verts.size() * sizeof(float));
  std::memcpy(faces, data.faces.data(), data.faces.size() * sizeof(int32_t));
  return 0;
}

// RGBA8 (h rows of w pixels, top row first) -> PNG file: filter byte 0 on
// every row, zlib level 6, one IDAT chunk. 1 when compression or the
// file's write fails.
int pt_write_png(const char* path, const uint8_t* rgba, int w, int h) {
  std::vector<uint8_t> raw((size_t)h * (1 + (size_t)w * 4));
  for (int y = 0; y < h; ++y) {
    uint8_t* row = raw.data() + (size_t)y * (1 + (size_t)w * 4);
    row[0] = 0;
    std::memcpy(row + 1, rgba + (size_t)y * w * 4, (size_t)w * 4);
  }
  uLongf comp_cap = compressBound((uLong)raw.size());
  std::vector<uint8_t> comp(comp_cap);
  if (compress2(comp.data(), &comp_cap, raw.data(), (uLong)raw.size(), 6) !=
      Z_OK)
    return 1;
  comp.resize(comp_cap);

  std::vector<uint8_t> out;
  const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  out.insert(out.end(), sig, sig + 8);
  uint8_t ihdr[13];
  ihdr[0] = (uint8_t)(w >> 24); ihdr[1] = (uint8_t)(w >> 16);
  ihdr[2] = (uint8_t)(w >> 8);  ihdr[3] = (uint8_t)w;
  ihdr[4] = (uint8_t)(h >> 24); ihdr[5] = (uint8_t)(h >> 16);
  ihdr[6] = (uint8_t)(h >> 8);  ihdr[7] = (uint8_t)h;
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 6;   // RGBA
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  put_chunk(out, "IHDR", ihdr, sizeof ihdr);
  put_chunk(out, "IDAT", comp.data(), comp.size());
  put_chunk(out, "IEND", nullptr, 0);

  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  size_t written = std::fwrite(out.data(), 1, out.size(), f);
  bool closed = std::fclose(f) == 0;
  return written == out.size() && closed ? 0 : 1;
}

}  // extern "C"
