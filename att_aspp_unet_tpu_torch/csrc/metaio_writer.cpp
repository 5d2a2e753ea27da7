// Independent MetaIO (.mha) writer/reader, implemented directly from the
// MetaIO file-format description (text "Key = Value" header, x-fastest raw
// or zlib-deflated LOCAL payload) the way ITK's MetaImage emits it.
//
// Purpose: a cross-implementation check for the port's Python codec
// (att_aspp_unet_tpu_torch/io/mha.py): two codecs written separately, in
// different languages, agreeing byte for byte in both directions
// (tests/test_torch_native.py).  A copy of the JAX package's
// native/metaio_writer.cpp.
//
// Header field order follows what itk::MetaImageIO writes for a 3-D image:
//   ObjectType = Image
//   NDims = 3
//   BinaryData = True
//   BinaryDataByteOrderMSB = False
//   CompressedData = True|False
//   [CompressedDataSize = N]
//   TransformMatrix = 1 0 0 0 1 0 0 0 1
//   Offset = ox oy oz
//   CenterOfRotation = 0 0 0
//   AnatomicalOrientation = ???
//   ElementSpacing = sx sy sz
//   DimSize = nx ny nz
//   ElementType = MET_UCHAR
//   ElementDataFile = LOCAL

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

std::string fmt_double(double v) {
  // ITK prints floating header values with %g-style shortest form
  char buf[64];
  std::snprintf(buf, sizeof(buf), "%g", v);
  return std::string(buf);
}

}  // namespace

extern "C" {

// Writes a 3-D MET_UCHAR volume (z-slowest in memory, so nx=W ny=H nz=N in
// the header's x-fastest convention).  Returns 0 on success.
int ho_write_mha_u8(const char* path, const uint8_t* data,
                    int nx, int ny, int nz,
                    double sx, double sy, double sz,
                    double ox, double oy, double oz,
                    int compress_payload) {
  const long long n = (long long)nx * ny * nz;
  std::vector<uint8_t> packed;
  const uint8_t* payload = data;
  long long payload_len = n;
  if (compress_payload) {
    uLongf cap = compressBound((uLong)n);
    packed.resize(cap);
    if (compress2(packed.data(), &cap, data, (uLong)n, 6) != Z_OK) return -2;
    packed.resize(cap);
    payload = packed.data();
    payload_len = (long long)cap;
  }

  std::string h;
  h += "ObjectType = Image\n";
  h += "NDims = 3\n";
  h += "BinaryData = True\n";
  h += "BinaryDataByteOrderMSB = False\n";
  h += std::string("CompressedData = ") +
       (compress_payload ? "True" : "False") + "\n";
  if (compress_payload)
    h += "CompressedDataSize = " + std::to_string(payload_len) + "\n";
  h += "TransformMatrix = 1 0 0 0 1 0 0 0 1\n";
  h += "Offset = " + fmt_double(ox) + " " + fmt_double(oy) + " " +
       fmt_double(oz) + "\n";
  h += "CenterOfRotation = 0 0 0\n";
  h += "AnatomicalOrientation = ???\n";
  h += "ElementSpacing = " + fmt_double(sx) + " " + fmt_double(sy) + " " +
       fmt_double(sz) + "\n";
  h += "DimSize = " + std::to_string(nx) + " " + std::to_string(ny) + " " +
       std::to_string(nz) + "\n";
  h += "ElementType = MET_UCHAR\n";
  h += "ElementDataFile = LOCAL\n";

  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  int rc = 0;
  if (std::fwrite(h.data(), 1, h.size(), f) != h.size()) rc = -3;
  if (rc == 0 &&
      std::fwrite(payload, 1, (size_t)payload_len, f) != (size_t)payload_len)
    rc = -3;
  std::fclose(f);
  return rc;
}

// Minimal reader for the same layout.  Parses the header line by line until
// ElementDataFile, then inflates/copies the payload into `out` (caller
// allocates nx*ny*nz bytes, obtained from a first ho_read_mha_dims call).
int ho_read_mha_dims_u8(const char* path, int* nx, int* ny, int* nz,
                        double* sx, double* sy, double* sz) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char line[512];
  int dims[3] = {0, 0, 0};
  double sp[3] = {1.0, 1.0, 1.0};
  int ok = 0;
  while (std::fgets(line, sizeof(line), f)) {
    if (std::sscanf(line, "DimSize = %d %d %d", &dims[0], &dims[1],
                    &dims[2]) == 3)
      ok |= 1;
    if (std::sscanf(line, "ElementSpacing = %lf %lf %lf", &sp[0], &sp[1],
                    &sp[2]) == 3)
      ok |= 2;
    if (std::strncmp(line, "ElementDataFile", 15) == 0) break;
  }
  std::fclose(f);
  if (!(ok & 1)) return -4;
  *nx = dims[0]; *ny = dims[1]; *nz = dims[2];
  *sx = sp[0]; *sy = sp[1]; *sz = sp[2];
  return 0;
}

int ho_read_mha_u8(const char* path, uint8_t* out, long long out_len) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char line[512];
  int compressed = 0;
  long long header_end = 0;
  while (std::fgets(line, sizeof(line), f)) {
    if (std::strncmp(line, "CompressedData = True", 21) == 0) compressed = 1;
    if (std::strncmp(line, "ElementDataFile", 15) == 0) {
      header_end = std::ftell(f);
      break;
    }
  }
  if (header_end == 0) { std::fclose(f); return -4; }
  std::fseek(f, 0, SEEK_END);
  long long total = std::ftell(f);
  long long payload_len = total - header_end;
  std::fseek(f, (long)header_end, SEEK_SET);
  std::vector<uint8_t> payload((size_t)payload_len);
  if (std::fread(payload.data(), 1, (size_t)payload_len, f) !=
      (size_t)payload_len) {
    std::fclose(f);
    return -3;
  }
  std::fclose(f);
  if (!compressed) {
    if (payload_len != out_len) return -5;
    std::memcpy(out, payload.data(), (size_t)out_len);
    return 0;
  }
  uLongf dst_len = (uLongf)out_len;
  if (uncompress(out, &dst_len, payload.data(), (uLong)payload_len) != Z_OK)
    return -6;
  return dst_len == (uLongf)out_len ? 0 : -5;
}

}  // extern "C"
