// Native host-side ops of att_aspp_unet_tpu_torch (a copy of the JAX
// package's native/host_ops.cpp), loaded through ctypes by
// att_aspp_unet_tpu_torch/utils/native.py:
//
//   - zlib inflate/deflate for the MetaImage (.mha) codec hot path
//   - CLAHE (cv2-faithful) and 3x3 median for host-side preprocessing
//   - two-pass union-find connected components + largest component
//   - border-background flood fill (hole filling)
//   - Moore contour tracing (ordered border pixels for arc length / <5-point
//     ellipse fallback)
//
// Build (utils/native.py does it at first use):
//   g++ -O3 -fPIC -std=c++17 -Wall -shared host_ops.cpp metaio_writer.cpp
//       -o libhostops.so -lz
// Plain C ABI; all images are row-major uint8 H*W.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>
#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// zlib
// ---------------------------------------------------------------------------

// Returns 0 on success.
int ho_inflate(const uint8_t* src, long long src_len,
               uint8_t* dst, long long dst_len) {
  uLongf out_len = (uLongf)dst_len;
  int rc = uncompress(dst, &out_len, src, (uLong)src_len);
  return (rc == Z_OK && (long long)out_len == dst_len) ? 0 : rc == Z_OK ? -1 : rc;
}

// Returns compressed size, or negative zlib error.
long long ho_deflate(const uint8_t* src, long long src_len,
                     uint8_t* dst, long long dst_cap, int level) {
  uLongf out_len = (uLongf)dst_cap;
  int rc = compress2(dst, &out_len, src, (uLong)src_len, level);
  return rc == Z_OK ? (long long)out_len : (long long)rc;
}

long long ho_deflate_bound(long long src_len) {
  return (long long)compressBound((uLong)src_len);
}

// ---------------------------------------------------------------------------
// CLAHE (cv2.createCLAHE semantics; see ops/clahe.py for the algorithm notes)
// ---------------------------------------------------------------------------

void ho_clahe_u8(const uint8_t* img, int H, int W, float clip_limit,
                 int tiles_x, int tiles_y, uint8_t* out) {
  int pad_h = (tiles_y - H % tiles_y) % tiles_y;
  int pad_w = (tiles_x - W % tiles_x) % tiles_x;
  int He = H + pad_h, We = W + pad_w;
  int th = He / tiles_y, tw = We / tiles_x;
  long tile_area = (long)th * tw;
  int clip = std::max((int)(clip_limit * tile_area / 256), 1);

  // REFLECT_101 bottom/right extension
  std::vector<uint8_t> ext((size_t)He * We);
  for (int y = 0; y < He; ++y) {
    int sy = y < H ? y : 2 * H - 2 - y;
    for (int x = 0; x < We; ++x) {
      int sx = x < W ? x : 2 * W - 2 - x;
      ext[(size_t)y * We + x] = img[(size_t)sy * W + sx];
    }
  }

  std::vector<int32_t> luts((size_t)tiles_y * tiles_x * 256);
  std::vector<int64_t> hist(256);
  for (int ty = 0; ty < tiles_y; ++ty) {
    for (int tx = 0; tx < tiles_x; ++tx) {
      std::fill(hist.begin(), hist.end(), 0);
      for (int y = ty * th; y < (ty + 1) * th; ++y)
        for (int x = tx * tw; x < (tx + 1) * tw; ++x)
          hist[ext[(size_t)y * We + x]]++;
      int64_t excess = 0;
      for (int b = 0; b < 256; ++b)
        if (hist[b] > clip) { excess += hist[b] - clip; hist[b] = clip; }
      int64_t batch = excess / 256;
      int residual = (int)(excess % 256);
      for (int b = 0; b < 256; ++b) hist[b] += batch;
      if (residual) {
        int step = std::max(256 / residual, 1);
        for (int i = 0; i < 256 && residual > 0; i += step, --residual)
          hist[i]++;
      }
      double scale = 255.0 / tile_area;
      int64_t cum = 0;
      int32_t* lut = &luts[((size_t)ty * tiles_x + tx) * 256];
      for (int b = 0; b < 256; ++b) {
        cum += hist[b];
        double v = std::nearbyint(cum * scale);
        lut[b] = (int32_t)std::min(std::max(v, 0.0), 255.0);
      }
    }
  }

  float inv_th = 1.0f / th, inv_tw = 1.0f / tw;
  for (int y = 0; y < H; ++y) {
    float tyf = (float)y * inv_th - 0.5f;
    int ty1 = (int)std::floor(tyf);
    float ya = tyf - ty1;
    int ty2 = std::min(ty1 + 1, tiles_y - 1);
    ty1 = std::max(ty1, 0);
    for (int x = 0; x < W; ++x) {
      float txf = (float)x * inv_tw - 0.5f;
      int tx1 = (int)std::floor(txf);
      float xa = txf - tx1;
      int tx2 = std::min(tx1 + 1, tiles_x - 1);
      tx1 = std::max(tx1, 0);
      int v = img[(size_t)y * W + x];
      float r = luts[((size_t)ty1 * tiles_x + tx1) * 256 + v] * ((1 - ya) * (1 - xa))
              + luts[((size_t)ty1 * tiles_x + tx2) * 256 + v] * ((1 - ya) * xa)
              + luts[((size_t)ty2 * tiles_x + tx1) * 256 + v] * (ya * (1 - xa))
              + luts[((size_t)ty2 * tiles_x + tx2) * 256 + v] * (ya * xa);
      float rr = std::nearbyintf(r);
      out[(size_t)y * W + x] = (uint8_t)std::min(std::max(rr, 0.0f), 255.0f);
    }
  }
}

// ---------------------------------------------------------------------------
// 3x3 median (replicated border)
// ---------------------------------------------------------------------------

void ho_median3_u8(const uint8_t* img, int H, int W, uint8_t* out) {
  uint8_t win[9];
  for (int y = 0; y < H; ++y) {
    for (int x = 0; x < W; ++x) {
      int k = 0;
      for (int dy = -1; dy <= 1; ++dy) {
        int yy = std::min(std::max(y + dy, 0), H - 1);
        for (int dx = -1; dx <= 1; ++dx) {
          int xx = std::min(std::max(x + dx, 0), W - 1);
          win[k++] = img[(size_t)yy * W + xx];
        }
      }
      std::nth_element(win, win + 4, win + 9);
      out[(size_t)y * W + x] = win[4];
    }
  }
}

// ---------------------------------------------------------------------------
// connected components (two-pass union-find), conn = 4 or 8
// ---------------------------------------------------------------------------

static int uf_find(std::vector<int>& parent, int i) {
  while (parent[i] != i) { parent[i] = parent[parent[i]]; i = parent[i]; }
  return i;
}

// labels: 0 background, 1..n components.  Returns n.
int ho_label(const uint8_t* mask, int H, int W, int conn, int32_t* labels) {
  std::vector<int> parent(1, 0);
  std::memset(labels, 0, sizeof(int32_t) * (size_t)H * W);
  int next = 1;
  for (int y = 0; y < H; ++y) {
    for (int x = 0; x < W; ++x) {
      if (!mask[(size_t)y * W + x]) continue;
      int neigh[4];
      int nn = 0;
      if (x > 0 && labels[(size_t)y * W + x - 1]) neigh[nn++] = labels[(size_t)y * W + x - 1];
      if (y > 0 && labels[(size_t)(y - 1) * W + x]) neigh[nn++] = labels[(size_t)(y - 1) * W + x];
      if (conn == 8 && y > 0) {
        if (x > 0 && labels[(size_t)(y - 1) * W + x - 1]) neigh[nn++] = labels[(size_t)(y - 1) * W + x - 1];
        if (x + 1 < W && labels[(size_t)(y - 1) * W + x + 1]) neigh[nn++] = labels[(size_t)(y - 1) * W + x + 1];
      }
      if (nn == 0) {
        parent.push_back(next);
        labels[(size_t)y * W + x] = next++;
      } else {
        int m = neigh[0];
        for (int i = 1; i < nn; ++i) m = std::min(m, neigh[i]);
        labels[(size_t)y * W + x] = m;
        for (int i = 0; i < nn; ++i) {
          int ra = uf_find(parent, m), rb = uf_find(parent, neigh[i]);
          if (ra != rb) parent[std::max(ra, rb)] = std::min(ra, rb);
        }
      }
    }
  }
  // second pass: flatten + densify
  std::vector<int> remap(next, 0);
  int n = 0;
  for (long long i = 0; i < (long long)H * W; ++i) {
    if (!labels[i]) continue;
    int r = uf_find(parent, labels[i]);
    if (!remap[r]) remap[r] = ++n;
    labels[i] = remap[r];
  }
  return n;
}

// Keep only the largest component (ties: smallest label).  Returns its size.
long long ho_largest_component(const uint8_t* mask, int H, int W, int conn,
                               uint8_t* out) {
  std::vector<int32_t> labels((size_t)H * W);
  int n = ho_label(mask, H, W, conn, labels.data());
  if (n == 0) { std::memset(out, 0, (size_t)H * W); return 0; }
  std::vector<long long> sizes(n + 1, 0);
  for (long long i = 0; i < (long long)H * W; ++i) sizes[labels[i]]++;
  sizes[0] = 0;
  int best = 1;
  for (int l = 2; l <= n; ++l) if (sizes[l] > sizes[best]) best = l;
  for (long long i = 0; i < (long long)H * W; ++i)
    out[i] = labels[i] == best ? 1 : 0;
  return sizes[best];
}

// scipy.binary_fill_holes equivalent (4-connected background flood).
void ho_fill_holes(const uint8_t* mask, int H, int W, uint8_t* out) {
  std::vector<uint8_t> reach((size_t)H * W, 0);
  std::vector<int> stack;
  auto push = [&](int y, int x) {
    size_t i = (size_t)y * W + x;
    if (!mask[i] && !reach[i]) { reach[i] = 1; stack.push_back(y * W + x); }
  };
  for (int x = 0; x < W; ++x) { push(0, x); push(H - 1, x); }
  for (int y = 0; y < H; ++y) { push(y, 0); push(y, W - 1); }
  while (!stack.empty()) {
    int p = stack.back();
    stack.pop_back();
    int y = p / W, x = p % W;
    if (y > 0) push(y - 1, x);
    if (y + 1 < H) push(y + 1, x);
    if (x > 0) push(y, x - 1);
    if (x + 1 < W) push(y, x + 1);
  }
  for (long long i = 0; i < (long long)H * W; ++i)
    out[i] = (mask[i] || !reach[i]) ? 1 : 0;
}

// ---------------------------------------------------------------------------
// Moore contour tracing (matches measure/contour.py)
// ---------------------------------------------------------------------------

// out_xy: interleaved x,y pairs; returns point count (<= max_pts).
int ho_trace_contour(const uint8_t* mask, int H, int W,
                     int32_t* out_xy, int max_pts) {
  static const int DX[8] = {-1, -1, 0, 1, 1, 1, 0, -1};
  static const int DY[8] = {0, -1, -1, -1, 0, 1, 1, 1};
  int sx = -1, sy = -1;
  for (int y = 0; y < H && sy < 0; ++y)
    for (int x = 0; x < W; ++x)
      if (mask[(size_t)y * W + x]) { sy = y; sx = x; break; }
  if (sy < 0) return 0;

  auto fg = [&](int x, int y) {
    return x >= 0 && x < W && y >= 0 && y < H && mask[(size_t)y * W + x];
  };

  int count = 0;
  auto emit = [&](int x, int y) {
    if (count < max_pts) { out_xy[2 * count] = x; out_xy[2 * count + 1] = y; }
    ++count;
  };
  emit(sx, sy);

  int cx = sx, cy = sy, backtrack = 0;
  int first_cx = -1, first_cy = -1, first_d = -1;
  long long fgsum = 0;
  for (long long i = 0; i < (long long)H * W; ++i) fgsum += mask[i] ? 1 : 0;
  long long max_steps = 8 * fgsum + 8;

  for (long long step = 0; step < max_steps; ++step) {
    int d = -1, nx = 0, ny = 0;
    for (int k = 0; k < 8; ++k) {
      int dd = (backtrack + k) % 8;
      int tx = cx + DX[dd], ty = cy + DY[dd];
      if (fg(tx, ty)) { d = dd; nx = tx; ny = ty; break; }
    }
    if (d < 0) break;                       // isolated pixel
    if (first_d < 0) {
      first_cx = cx; first_cy = cy; first_d = d;
    } else if (cx == first_cx && cy == first_cy && d == first_d) {
      break;                                // Jacob's stopping criterion
    }
    cx = nx; cy = ny;
    emit(cx, cy);
    backtrack = (d + 5) % 8;
  }
  // drop duplicated closing start pixel
  if (count > 1 && count <= max_pts &&
      out_xy[2 * (count - 1)] == out_xy[0] &&
      out_xy[2 * (count - 1) + 1] == out_xy[1])
    --count;
  return std::min(count, max_pts);
}

}  // extern "C"
