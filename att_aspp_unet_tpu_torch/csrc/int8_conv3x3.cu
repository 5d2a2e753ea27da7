// int8_conv3x3: one 3x3 stride-1 SAME conv (zero pad 1, no bias) on the int8
// tensor cores, with the quantization of its input and the dequantization,
// folded BN and ReLU of its output in the same kernel.
//
// Replaces the int8 serving conv of the JAX package, which XLA computes
// outside any Pallas kernel: att_aspp_unet_tpu/nn/quant.py::int8_conv3x3_pre
// (:54) with the BatchNorm and ReLU of nn/blocks.py::ConvBNReLU (:79-93).
// Same function, in the same order of roundings:
//   xq  = clip(round_half_even(x / s_x), -127, 127)          int8
//   acc = conv3x3(xq, wq)                                     int32, exact
//   y   = bf16(f32(acc) * (s_x * s_w[c]))                     dequant
//   out = bf16(relu(fma(y, scale[c], bias[c])))               folded BN
// x and out are (N, C, H, W) bf16 tensors in channel-last memory (NHWC
// strides); wq arrives prepacked (ops/kernels/int8_conv.py); s_x is one f32
// on the device, s_w / scale / bias f32 per output channel.  A second output
// mode writes the int32 accumulators instead (the check that they are exact).
//
// What bounds it on an H100.  The model's convs do 10^2-10^3 int8 operations
// per byte they must move, above the card's ~590 op/byte int8 ridge for all
// but the narrowest, so the bound is the int8 tensor-core rate (1,979 TOP/s
// dense).  This first version is the simple one: mma.sync (m16n8k32, s8 x s8
// -> s32), which reaches a fraction of that rate (wgmma is the full rate;
// ROADMAP Queue B).
//
// One CTA (8 warps) owns an 8 x 16 output tile of one frame and 64 output
// channels: an implicit GEMM with M = 64 channels, N = 128 pixels and K = 9
// taps x Cin.  K runs in steps of 32 input channels over two shared-memory
// stages: the step's input tile with its 1-pixel halo (10 x 18 pixels x 32
// channels) is loaded from the bf16 input into registers while the previous
// step multiplies, quantized, and stored as int8; the step's weight chunk
// ([tap][64 rows][32], contiguous in the prepacked weights) arrives by 16-byte
// cp.async.  Each warp owns 32 rows x 32 pixels (2 x 4 mma tiles); fragments
// come by ldmatrix.x4 (a 16-byte row holds 16 int8 values, so the b16 matrix
// layout is the s8 fragment layout).  Every smem row pitch is 48 bytes, so
// the eight 16-byte rows of a matrix fall on distinct banks.  Where Cin = 1
// (the model's first conv) the nine taps are the K dimension: one K-step
// whose B tile is the im2col of the input.  The epilogue parks the tile in
// shared memory, [pixel][64 channels] bf16, and stores it 16 bytes a thread.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TH = 8, TW = 16;                 // output tile
constexpr int IN_H = TH + 2, IN_W = TW + 2;    // with the 1-pixel halo
constexpr int IN_P = IN_H * IN_W;              // 180 input pixels
constexpr int P = TH * TW;                     // 128 output pixels
constexpr int MC = 64;                         // output channels per CTA
constexpr int KC = 32;                         // input channels per K-step
constexpr int KP = KC + 16;                    // smem row pitch, bytes
constexpr int NTHREADS = 256;
constexpr int IN_STAGE = IN_P * KP;            // bytes per input stage
constexpr int W_STAGE = 9 * MC * KP;           // bytes per weight stage
constexpr int OP = MC + 8;                     // parked output pitch, bf16
constexpr int GROUPS = KC / 8;                 // 8-channel groups per pixel
constexpr int ITEMS = (IN_P * GROUPS + NTHREADS - 1) / NTHREADS;
constexpr size_t SMEM = 2 * IN_STAGE + 2 * W_STAGE;
static_assert(P * OP * 2 <= 2 * W_STAGE, "the parked tile reuses the weights");
static_assert(P * KP <= IN_STAGE, "the im2col tile fits one input stage");

struct Params {
  const bf16* x;
  const int8_t* wp;     // prepacked
  const float* sx;      // one value
  const float* sw;
  const float* scale;
  const float* bias;
  bf16* out;            // the bf16 result, or
  int32_t* acc_out;     // the raw accumulators (then out is null)
  int N, Cin, Cout, H, W;
  int ntaps, nk;        // 9 and ceil(Cin / 32), or 1 and 1 (Cin = 1)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// clip(round_half_even(v / s), -127, 127) as one byte; a true division, as
// the JAX package quantizes
__device__ __forceinline__ uint32_t quant(float v, float s) {
  float t = rintf(__fdiv_rn(v, s));
  t = fminf(fmaxf(t, -127.f), 127.f);
  return (uint32_t)(uint8_t)(int8_t)(int)t;
}

__device__ __forceinline__ uint32_t quant4(const bf16* v, float s) {
  return quant(__bfloat162float(v[0]), s) |
         quant(__bfloat162float(v[1]), s) << 8 |
         quant(__bfloat162float(v[2]), s) << 16 |
         quant(__bfloat162float(v[3]), s) << 24;
}

// Channels [c, c + 8) of one input pixel, zero past Cin or outside the frame.
__device__ __forceinline__ uint4 load8(const Params& p, const bf16* xn, int gy,
                                       int gx, int c) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (gy < 0 || gy >= p.H || gx < 0 || gx >= p.W || c >= p.Cin) return v;
  const bf16* src = xn + ((size_t)gy * p.W + gx) * p.Cin + c;
  if (p.Cin % 8 == 0) return *reinterpret_cast<const uint4*>(src);
  bf16* e = reinterpret_cast<bf16*>(&v);
  for (int i = 0; i < 8 && c + i < p.Cin; ++i) e[i] = src[i];
  return v;
}

__global__ void __launch_bounds__(NTHREADS, 2)
int8_conv3x3_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* in_s = smem;                        // 2 x [pixel][KP]
  unsigned char* w_s = smem + 2 * IN_STAGE;          // 2 x [tap][row][KP]
  bf16* out_s = reinterpret_cast<bf16*>(w_s);        // after the last step

  const int nmb = (p.Cout + MC - 1) / MC;
  const int n = blockIdx.z / nmb, m0 = (blockIdx.z % nmb) * MC;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;           // 32 rows x 32 pixels
  const int g = lane / 4, t = lane % 4;
  const bf16* xn = p.x + (size_t)n * p.H * p.W * p.Cin;
  const float sx = *p.sx;
  const bool im2col = p.ntaps == 1;

  // the weight chunk of step s: ntaps x 64 rows x 32 bytes, contiguous
  auto load_w = [&](int s) {
    unsigned char* dst = w_s + (s & 1) * W_STAGE;
    const int8_t* src =
        p.wp + ((size_t)(m0 / MC) * p.nk + s) * p.ntaps * MC * KC;
    const int pieces = p.ntaps * MC * 2;
    for (int i = threadIdx.x; i < pieces; i += NTHREADS)
      cp_async16(dst + (i / 2) * KP + (i % 2) * 16, src + i * 16);
    cp_async_commit();
  };
  // the input tile's channels [32 s, 32 s + 32): to registers, then
  // quantized into a stage
  uint4 regs[ITEMS];
  auto load_x = [&](int s) {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int i = threadIdx.x + k * NTHREADS;
      const int pix = i / GROUPS;
      regs[k] = i < IN_P * GROUPS
                    ? load8(p, xn, y0 - 1 + pix / IN_W, x0 - 1 + pix % IN_W,
                            s * KC + (i % GROUPS) * 8)
                    : make_uint4(0, 0, 0, 0);
    }
  };
  auto store_x = [&](int s) {
    unsigned char* dst = in_s + (s & 1) * IN_STAGE;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int i = threadIdx.x + k * NTHREADS;
      if (i >= IN_P * GROUPS) continue;
      const bf16* v = reinterpret_cast<const bf16*>(&regs[k]);
      *reinterpret_cast<uint2*>(dst + (i / GROUPS) * KP + (i % GROUPS) * 8) =
          make_uint2(quant4(v, sx), quant4(v + 4, sx));
    }
  };

  // prologue: step 0 staged
  load_w(0);
  if (im2col) {
    // B[q][k] = xq at output pixel q shifted by tap k, zero for k >= 9
    for (int i = threadIdx.x; i < P * KC; i += NTHREADS) {
      const int q = i / KC, k = i % KC;
      uint32_t v = 0;
      if (k < 9) {
        const int gy = y0 + q / TW + k / 3 - 1, gx = x0 + q % TW + k % 3 - 1;
        if (gy >= 0 && gy < p.H && gx >= 0 && gx < p.W)
          v = quant(__bfloat162float(xn[(size_t)gy * p.W + gx]), sx);
      }
      in_s[q * KP + k] = (unsigned char)v;
    }
  } else {
    load_x(0);
    store_x(0);
  }
  cp_async_wait_all();
  __syncthreads();

  int acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][j][r] = 0;

  for (int s = 0; s < p.nk; ++s) {
    const bool more = s + 1 < p.nk;
    if (more) {          // lands while this step multiplies
      load_w(s + 1);
      load_x(s + 1);
    }
    const unsigned char* is = in_s + (s & 1) * IN_STAGE;
    const unsigned char* ws = w_s + (s & 1) * W_STAGE;
    for (int tap = 0; tap < p.ntaps; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm4(a[mt], smem_u32(ws + (tap * MC + 32 * wm + 16 * mt +
                                    (lane & 15)) * KP + (lane >> 4) * 16));
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        const int q = 32 * wn + 8 * (2 * jp + (lane >> 4)) + (lane & 7);
        const int pix =
            im2col ? q : (q / TW + ky) * IN_W + q % TW + kx;
        ldsm4(b[jp], smem_u32(is + pix * KP + ((lane >> 3) & 1) * 16));
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(acc[mt][j], a[mt], b[j / 2][2 * (j % 2)],
                 b[j / 2][2 * (j % 2) + 1]);
    }
    if (more) store_x(s + 1);
    cp_async_wait_all();
    __syncthreads();
  }

  // accumulator (mt, j, r): channel m0 + 32 wm + 16 mt + g + 8 (r / 2),
  // pixel 32 wn + 8 j + 2 t + r % 2
  if (p.acc_out != nullptr) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int m = m0 + 32 * wm + 16 * mt + g + 8 * (r / 2);
          const int q = 32 * wn + 8 * j + 2 * t + r % 2;
          const int gy = y0 + q / TW, gx = x0 + q % TW;
          if (m < p.Cout && gy < p.H && gx < p.W)
            p.acc_out[(((size_t)n * p.H + gy) * p.W + gx) * p.Cout + m] =
                acc[mt][j][r];
        }
    return;
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ml = 32 * wm + 16 * mt + g + 8 * h, m = m0 + ml;
      const bool ok = m < p.Cout;
      const float fac = ok ? __fmul_rn(sx, p.sw[m]) : 0.f;
      const float sc = ok ? p.scale[m] : 0.f, bi = ok ? p.bias[m] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float y = __bfloat162float(__float2bfloat16_rn(
              __fmul_rn(__int2float_rn(acc[mt][j][2 * h + e]), fac)));
          const int q = 32 * wn + 8 * j + 2 * t + e;
          out_s[q * OP + ml] = __float2bfloat16_rn(fmaxf(fmaf(y, sc, bi), 0.f));
        }
    }
  __syncthreads();
  const int mrows = min(MC, p.Cout - m0);
  bf16* outn = p.out + (size_t)n * p.H * p.W * p.Cout;
  if (p.Cout % 8 == 0) {
    const int parts = mrows / 8;
    for (int i = threadIdx.x; i < P * parts; i += NTHREADS) {
      const int q = i / parts, part = i % parts;
      const int gy = y0 + q / TW, gx = x0 + q % TW;
      if (gy < p.H && gx < p.W)
        *reinterpret_cast<uint4*>(outn + ((size_t)gy * p.W + gx) * p.Cout +
                                  m0 + part * 8) =
            *reinterpret_cast<const uint4*>(out_s + q * OP + part * 8);
    }
  } else {  // ragged channel count: scalar stores
    for (int i = threadIdx.x; i < P * mrows; i += NTHREADS) {
      const int q = i / mrows, ml = i % mrows;
      const int gy = y0 + q / TW, gx = x0 + q % TW;
      if (gy < p.H && gx < p.W)
        outn[((size_t)gy * p.W + gx) * p.Cout + m0 + ml] = out_s[q * OP + ml];
    }
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched).  x is channel-last (N, H, W, Cin)
// bf16 aligned to 16 bytes; wp the weights prepacked for this Cin and Cout;
// sx a device pointer to one f32; exactly one of out (bf16, channel-last) and
// acc_out (int32, channel-last) is non-null; the stream is a cudaStream_t.
int int8_conv3x3_launch(const void* x, const void* wp, const void* sx,
                        const void* sw, const void* scale, const void* bias,
                        void* out, void* acc_out, int N, int Cin, int Cout,
                        int H, int W, void* stream) {
  Params p;
  p.x = (const bf16*)x;
  p.wp = (const int8_t*)wp;
  p.sx = (const float*)sx;
  p.sw = (const float*)sw;
  p.scale = (const float*)scale;
  p.bias = (const float*)bias;
  p.out = (bf16*)out;
  p.acc_out = (int32_t*)acc_out;
  p.N = N;
  p.Cin = Cin;
  p.Cout = Cout;
  p.H = H;
  p.W = W;
  p.ntaps = Cin == 1 ? 1 : 9;
  p.nk = Cin == 1 ? 1 : (Cin + KC - 1) / KC;
  if ((out == nullptr) == (acc_out == nullptr) || N <= 0 || Cin <= 0 ||
      Cout <= 0)
    return (int)cudaErrorInvalidValue;
  const int nmb = (Cout + MC - 1) / MC;
  if ((long long)N * nmb > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(
      int8_conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N * nmb);
  int8_conv3x3_kernel<<<grid, NTHREADS, SMEM, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
