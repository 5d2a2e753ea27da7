// The Swin UNETR network's normalisations and its stem on channel-last
// bf16 maps: the LayerNorm over each token's channels (with an optional
// residual added first), the InstanceNorm over each (image, channel) plane
// with the LeakyReLU and the residual of MONAI's UnetResBlock folded into
// its pass, and the first conv block's two convs of the 1-channel input.
//
// No TPU kernel is replaced: the JAX package has no such network.  Both are
// bound by bytes.  PyTorch's LayerNorm runs one 128-thread block per row,
// which at 48 channels leaves most of its threads idle and the card at a
// tenth of its bandwidth; here a group of 4 to 32 threads takes a row, each
// thread 16-byte vectors of 8 channels, a block holding many rows.  The
// InstanceNorm reads the activation once for its statistics (per block the
// sums over a run of pixels, summed over the runs in a fixed order: no
// atomics, the same result in every run) and once more to write the
// normalised, activated map, where PyTorch's ops take two reductions, the
// affine, the residual add and the activation as five passes.  The stem's
// 3x3 and 1x1 convs of the 1-channel input (48 output channels each) are
// bound by the bytes they write; cuDNN runs the 1x1 one as an unaligned
// GEMM into a channel-first map that then has to be transposed, and the
// 3x3 one at a fifth of the bandwidth.  Here one pass writes both,
// channel-last, each thread 8 channels of one pixel.
//
// Plain C interface, loaded with ctypes (att_aspp_unet_tpu_torch/ops/
// kernels/swin_ops.py); every launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // bf16 values in one 16-byte load

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One row of C = CV * 8 channels per group of TPR threads, NV vectors per
// thread.  With ``res``: s = bf16(x + res) is written to ``sum_out`` and
// normed.  ``w`` / ``b`` null: no affine.
template <int TPR, int NV>
__global__ void __launch_bounds__(kThreads) layer_norm_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ res,
    __nv_bfloat16* __restrict__ sum_out, const __nv_bfloat16* __restrict__ w,
    const __nv_bfloat16* __restrict__ b, __nv_bfloat16* __restrict__ y,
    long long rows, int C, float eps) {
  const int CV = C / kVec;
  const int lane = threadIdx.x % TPR;
  const long long row =
      (long long)blockIdx.x * (kThreads / TPR) + threadIdx.x / TPR;
  const bool live = row < rows;
  const long long base = live ? row * C : 0;
  float v[NV][kVec];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int vi = lane + k * TPR;
    if (live && vi < CV) {
      load8(x + base + vi * kVec, v[k]);
      if (res != nullptr) {
        float r[kVec];
        load8(res + base + vi * kVec, r);
#pragma unroll
        for (int i = 0; i < kVec; ++i) v[k][i] = round_bf16(v[k][i] + r[i]);
        store8(sum_out + base + vi * kVec, v[k]);
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) sum += v[k][i];
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) v[k][i] = 0.f;
    }
  }
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float mean = sum / C;
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (lane + k * TPR < CV) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float d = v[k][i] - mean;
        sq += d * d;
      }
    }
  }
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  const float rstd = rsqrtf(sq / C + eps);
  if (!live) return;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int vi = lane + k * TPR;
    if (vi < CV) {
      float out[kVec];
      if (w != nullptr) {
        float wf[kVec], bf[kVec];
        load8(w + vi * kVec, wf);
        load8(b + vi * kVec, bf);
#pragma unroll
        for (int i = 0; i < kVec; ++i) out[i] = (v[k][i] - mean) * rstd * wf[i] + bf[i];
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) out[i] = (v[k][i] - mean) * rstd;
      }
      store8(y + base + vi * kVec, out);
    }
  }
}

template <int TPR, int NV>
cudaError_t launch_ln(const void* x, const void* res, void* sum_out,
                      const void* w, const void* b, void* y, long long rows,
                      int C, float eps, cudaStream_t stream) {
  const long long per_block = kThreads / TPR;
  const long long blocks = (rows + per_block - 1) / per_block;
  layer_norm_kernel<TPR, NV><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)res,
      (__nv_bfloat16*)sum_out, (const __nv_bfloat16*)w,
      (const __nv_bfloat16*)b, (__nv_bfloat16*)y, rows, C, eps);
  return cudaGetLastError();
}

// InstanceNorm statistics: block (run, image) sums each channel over its
// run of ``run`` pixels; P = 256 / CV pixel lanes of CV channel vectors.
__global__ void __launch_bounds__(kThreads) instance_stats_kernel(
    const __nv_bfloat16* __restrict__ x, float* __restrict__ part_sum,
    float* __restrict__ part_sq, long long hw, int C, long long run) {
  extern __shared__ float smem[];
  const int CV = C / kVec;
  const int P = kThreads / CV;
  const int runs = gridDim.x;
  const int img = blockIdx.y;
  const int t = threadIdx.x;
  const int cv = t % CV, p = t / CV;
  float s[kVec], q[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) s[i] = q[i] = 0.f;
  const long long px0 = (long long)blockIdx.x * run;
  const long long px1 = px0 + run < hw ? px0 + run : hw;
  if (p < P) {
    const __nv_bfloat16* src = x + (long long)img * hw * C + cv * kVec;
    for (long long px = px0 + p; px < px1; px += P) {
      float f[kVec];
      load8(src + px * C, f);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        s[i] += f[i];
        q[i] += f[i] * f[i];
      }
    }
    float* ss = smem + (p * CV + cv) * kVec;
    float* sq = smem + P * C + (p * CV + cv) * kVec;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      ss[i] = s[i];
      sq[i] = q[i];
    }
  }
  __syncthreads();
  for (int c = t; c < C; c += kThreads) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < P; ++k) {
      a += smem[k * C + c];
      b += smem[P * C + k * C + c];
    }
    const long long o = ((long long)img * runs + blockIdx.x) * C + c;
    part_sum[o] = a;
    part_sq[o] = b;
  }
}

// Per (image, channel): the runs' sums in order -> the folded affine
// scale = rsqrt(var + eps) * w, shift = b - mean * scale, with
// var = E[x^2] - mean^2 (clamped at 0).
__global__ void instance_finalize_kernel(
    const float* __restrict__ part_sum, const float* __restrict__ part_sq,
    const float* __restrict__ w, const float* __restrict__ b,
    float* __restrict__ scale, float* __restrict__ shift, int runs, int C,
    long long hw, float eps) {
  const int img = blockIdx.x;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int r = 0; r < runs; ++r) {
      const long long o = ((long long)img * runs + r) * C + c;
      a += part_sum[o];
      q += part_sq[o];
    }
    const float mean = a / (float)hw;
    const float var = fmaxf(q / (float)hw - mean * mean, 0.f);
    const float sc = rsqrtf(var + eps) * w[c];
    scale[img * C + c] = sc;
    shift[img * C + c] = b[c] - mean * sc;
  }
}

// y = act(x * scale + shift + r'), r' = r * rscale + rshift (rscale given),
// r (r given), else 0; act = LeakyReLU(slope) where ``act``.  I: the
// index type (32 bits where the map allows, a cheaper division).
template <typename I>
__global__ void __launch_bounds__(kThreads) instance_apply_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ shift, const __nv_bfloat16* __restrict__ r,
    const float* __restrict__ rscale, const float* __restrict__ rshift,
    __nv_bfloat16* __restrict__ y, I vecs, I hw, int C, int act,
    float slope) {
  const I CV = (I)(C / kVec);
  const I per_img = hw * CV;
  for (I v = (I)blockIdx.x * kThreads + threadIdx.x; v < vecs;
       v += (I)gridDim.x * kThreads) {
    const I img = v / per_img;
    const int c0 = (int)(v % CV) * kVec;
    const float* sc = scale + img * C + c0;
    const float* sh = shift + img * C + c0;
    float f[kVec];
    load8(x + v * kVec, f);
#pragma unroll
    for (int i = 0; i < kVec; ++i) f[i] = fmaf(f[i], sc[i], sh[i]);
    if (r != nullptr) {
      float g[kVec];
      load8(r + v * kVec, g);
      if (rscale != nullptr) {
        const float* rs = rscale + img * C + c0;
        const float* rh = rshift + img * C + c0;
#pragma unroll
        for (int i = 0; i < kVec; ++i) f[i] += fmaf(g[i], rs[i], rh[i]);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) f[i] += g[i];
      }
    }
    if (act) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) f[i] = f[i] > 0.f ? f[i] : f[i] * slope;
    }
    store8(y + v * kVec, f);
  }
}

// y = conv3x3(x, w3) (zero padding 1), r = x * w1 (1x1) where r is given:
// x images x H x W bf16 (one channel), w3 9 x Cout f32 (tap-major, taps in
// row-major order), w1 Cout f32; y, r images x H x W x Cout bf16.  Sums in
// f32 over the taps in row-major order, rounded once.
template <typename I>
__global__ void __launch_bounds__(kThreads) stem_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ w3,
    const float* __restrict__ w1, __nv_bfloat16* __restrict__ y,
    __nv_bfloat16* __restrict__ r, I vecs, int H, int W, int Cout) {
  const I CV = (I)(Cout / kVec);
  const I hw = (I)H * W;
  for (I v = (I)blockIdx.x * kThreads + threadIdx.x; v < vecs;
       v += (I)gridDim.x * kThreads) {
    const I px = v / CV;
    const int c0 = (int)(v % CV) * kVec;
    const I img = px / hw;
    const int rem = (int)(px % hw);
    const int py = rem / W, pw = rem % W;
    const __nv_bfloat16* src = x + img * hw;
    float acc[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
      const int yy = py + dy;
      if (yy < 0 || yy >= H) continue;
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const int xx = pw + dx;
        if (xx < 0 || xx >= W) continue;
        const float xv = __bfloat162float(src[yy * W + xx]);
        const float* wt = w3 + ((dy + 1) * 3 + dx + 1) * Cout + c0;
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[i] = fmaf(xv, wt[i], acc[i]);
      }
    }
    store8(y + v * kVec, acc);
    if (r != nullptr) {
      const float xc = __bfloat162float(src[rem]);
      float o[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) o[i] = xc * w1[c0 + i];
      store8(r + v * kVec, o);
    }
  }
}

}  // namespace

extern "C" {

// See stem_kernel; Cout a multiple of 8; ``w1`` / ``r`` null: no 1x1 conv.
int swin_stem_launch(const void* x, const void* w3, const void* w1, void* y,
                     void* r, long long images, int H, int W, int Cout,
                     int sms, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (Cout % kVec != 0 || Cout <= 0) return (int)cudaErrorInvalidValue;
  const long long vecs = images * H * W * (Cout / kVec);
  long long blocks = (vecs + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * 16;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  if (vecs + (long long)blocks * kThreads < (1LL << 31)) {
    stem_kernel<unsigned><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)w3, (const float*)w1,
        (__nv_bfloat16*)y, (__nv_bfloat16*)r, (unsigned)vecs, H, W, Cout);
  } else {
    stem_kernel<long long><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)w3, (const float*)w1,
        (__nv_bfloat16*)y, (__nv_bfloat16*)r, vecs, H, W, Cout);
  }
  return (int)cudaGetLastError();
}

// rows x C bf16 (C a multiple of 8, at most 3072) -> y; see layer_norm_kernel.
int swin_layer_norm_launch(const void* x, const void* res, void* sum_out,
                           const void* w, const void* b, void* y,
                           long long rows, int C, float eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (C % kVec != 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const int CV = C / kVec;
  if (CV <= 4) return (int)launch_ln<4, 1>(x, res, sum_out, w, b, y, rows, C, eps, s);
  if (CV <= 8) return (int)launch_ln<8, 1>(x, res, sum_out, w, b, y, rows, C, eps, s);
  if (CV <= 16) return (int)launch_ln<16, 1>(x, res, sum_out, w, b, y, rows, C, eps, s);
  if (CV <= 32) return (int)launch_ln<32, 1>(x, res, sum_out, w, b, y, rows, C, eps, s);
  if (CV <= 64) return (int)launch_ln<32, 2>(x, res, sum_out, w, b, y, rows, C, eps, s);
  if (CV <= 96) return (int)launch_ln<32, 3>(x, res, sum_out, w, b, y, rows, C, eps, s);
  if (CV <= 128) return (int)launch_ln<32, 4>(x, res, sum_out, w, b, y, rows, C, eps, s);
  if (CV <= 192) return (int)launch_ln<32, 6>(x, res, sum_out, w, b, y, rows, C, eps, s);
  if (CV <= 256) return (int)launch_ln<32, 8>(x, res, sum_out, w, b, y, rows, C, eps, s);
  if (CV <= 384) return (int)launch_ln<32, 12>(x, res, sum_out, w, b, y, rows, C, eps, s);
  return (int)cudaErrorInvalidValue;
}

// x: images x hw x C bf16 (C a multiple of 8, at most 2048); part_sum /
// part_sq: images x runs x C f32 scratch; scale / shift: images x C f32.
int swin_instance_stats_launch(const void* x, void* part_sum, void* part_sq,
                               const void* w, const void* b, void* scale,
                               void* shift, long long images, long long hw,
                               int C, long long run, int runs, float eps,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (C % kVec != 0 || C <= 0 || C / kVec > kThreads) return (int)cudaErrorInvalidValue;
  const int P = kThreads / (C / kVec);
  const size_t smem = 2 * (size_t)P * C * sizeof(float);
  dim3 grid((unsigned)runs, (unsigned)images);
  instance_stats_kernel<<<grid, kThreads, smem, s>>>(
      (const __nv_bfloat16*)x, (float*)part_sum, (float*)part_sq, hw, C, run);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  instance_finalize_kernel<<<(unsigned)images, kThreads, 0, s>>>(
      (const float*)part_sum, (const float*)part_sq, (const float*)w,
      (const float*)b, (float*)scale, (float*)shift, runs, C, hw, eps);
  return (int)cudaGetLastError();
}

int swin_instance_apply_launch(const void* x, const void* scale,
                               const void* shift, const void* r,
                               const void* rscale, const void* rshift, void* y,
                               long long images, long long hw, int C, int act,
                               float slope, int sms, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (C % kVec != 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const long long vecs = images * hw * (C / kVec);
  long long blocks = (vecs + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * 16;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  if (vecs + (long long)blocks * kThreads < (1LL << 31)) {
    instance_apply_kernel<unsigned><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)scale, (const float*)shift,
        (const __nv_bfloat16*)r, (const float*)rscale, (const float*)rshift,
        (__nv_bfloat16*)y, (unsigned)vecs, (unsigned)hw, C, act, slope);
  } else {
    instance_apply_kernel<long long><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)scale, (const float*)shift,
        (const __nv_bfloat16*)r, (const float*)rscale, (const float*)rshift,
        (__nv_bfloat16*)y, vecs, hw, C, act, slope);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
