// Native data-loader core: COLMAP binary parsing.
//
// The runtime counterpart of the reference's native IO layer (its
// scene/colmap_loader.py parses points3D.bin point-by-point in Python —
// minutes for multi-million-point reconstructions; simple-knn is CUDA).
// The port's own copy of fovsplat/native/fastio.cpp. Exposed through
// ctypes (fovsplat_torch/native/__init__.py, which builds it with g++ at
// first use into build/native/); the pure-Python readers of
// fovsplat_torch/data/colmap.py take any file this parser rejects.

#include <cstdint>
#include <cstring>

extern "C" {

// points3D.bin layout per record:
//   uint64 id; double xyz[3]; uint8 rgb[3]; double error;
//   uint64 track_len; { int32 image_id; int32 point2D_idx; } * track_len
// Returns number of points parsed, or -1 on truncation.
int64_t parse_points3d(const uint8_t* buf, int64_t size,
                       double* xyz, uint8_t* rgb, double* err,
                       int64_t max_points) {
  const uint8_t* p = buf;
  const uint8_t* end = buf + size;
  if (p + 8 > end) return -1;
  uint64_t num;
  std::memcpy(&num, p, 8);
  p += 8;
  if ((int64_t)num > max_points) num = (uint64_t)max_points;
  for (uint64_t i = 0; i < num; ++i) {
    if (p + 8 + 24 + 3 + 8 + 8 > end) return -1;
    p += 8;                              // id
    std::memcpy(xyz + 3 * i, p, 24);
    p += 24;
    std::memcpy(rgb + 3 * i, p, 3);
    p += 3;
    std::memcpy(err + i, p, 8);
    p += 8;
    uint64_t track;
    std::memcpy(&track, p, 8);
    p += 8;
    if (p + (int64_t)track * 8 > end) return -1;
    p += track * 8;
  }
  return (int64_t)num;
}

// Count points without copying (to size the arrays).
int64_t count_points3d(const uint8_t* buf, int64_t size) {
  if (size < 8) return -1;
  uint64_t num;
  std::memcpy(&num, buf, 8);
  return (int64_t)num;
}

// images.bin: per record
//   int32 id; double qvec[4]; double tvec[3]; int32 camera_id;
//   char name[] (NUL-terminated); uint64 n_pts; {double,double,int64}*n
// Parses ids/qvecs/tvecs/camera_ids and copies names into a packed
// NUL-separated buffer. Returns count or -1.
int64_t parse_images(const uint8_t* buf, int64_t size,
                     int32_t* ids, double* qvecs, double* tvecs,
                     int32_t* cam_ids, char* names, int64_t names_cap,
                     int64_t max_images) {
  const uint8_t* p = buf;
  const uint8_t* end = buf + size;
  if (p + 8 > end) return -1;
  uint64_t num;
  std::memcpy(&num, p, 8);
  p += 8;
  if ((int64_t)num > max_images) num = (uint64_t)max_images;
  char* np_out = names;
  char* names_end = names + names_cap;
  for (uint64_t i = 0; i < num; ++i) {
    if (p + 4 + 32 + 24 + 4 > end) return -1;
    std::memcpy(ids + i, p, 4);
    p += 4;
    std::memcpy(qvecs + 4 * i, p, 32);
    p += 32;
    std::memcpy(tvecs + 3 * i, p, 24);
    p += 24;
    std::memcpy(cam_ids + i, p, 4);
    p += 4;
    while (p < end && *p != 0) {
      if (np_out >= names_end - 1) return -1;
      *np_out++ = (char)*p++;
    }
    if (p >= end) return -1;
    ++p;                                 // NUL
    *np_out++ = '\0';
    if (p + 8 > end) return -1;
    uint64_t n2d;
    std::memcpy(&n2d, p, 8);
    p += 8;
    if (p + (int64_t)n2d * 24 > end) return -1;
    p += n2d * 24;
  }
  return (int64_t)num;
}

}  // extern "C"
