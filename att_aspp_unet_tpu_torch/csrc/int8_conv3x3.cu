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
// x and out are (N, C, H, W) tensors in channel-last memory (NHWC strides);
// wq arrives prepacked for the path that runs (ops/kernels/int8_conv.py);
// s_x is one f32 on the device, s_w / scale / bias f32 per output channel.
// Modes, all of the same function:
//   * input: bf16 x, quantized in the kernel; or int8 x, already quantized
//     with s_x (xq itself: no division);
//   * output: bf16 out; or int8 quantize(out, s_out) with the next conv's
//     scale (a pair's intermediate: conv2 of the pair quantized exactly this
//     value before, so the pair's numbers do not change); or the raw int32
//     accumulators (the check that they are exact).
//
// What bounds it on an H100.  By operations the model's convs need the int8
// tensor cores (1,979 TOP/s dense) at 10^2-10^3 operations per byte; the
// card's int8 ridge is ~590 op/byte, so the 48- and 96-channel convs at 512^2
// and 256^2 are bound by the bytes they must move (the activations in and
// out), the wider ones by the tensor cores.  So the design moves each
// activation byte once, in as few bits as the function allows (int8 between
// the two convs of a pair), and feeds the tensor cores through wgmma.  What
// a CTA waits for, as measured on the card (builds with parts of the kernel
// compiled out by throwaway macros, timed per conv): neither the multiplies
// nor the weight copies but the per-element work on the CUDA cores, the
// quantization of a bf16 tile (halo included) and the epilogue, so both are
// written for few instructions per value.
//
// Two paths compute it, chosen by shape in the wrapper (never as a fallback):
//
//  * the wgmma path (second half of this file) for input channels that are
//    whole 16-byte groups (or one channel) and output channels that are a
//    multiple of 48, wherever its tile fits (plan_wgmma alone decides the
//    plan and the layout; the wrapper asks int8_conv3x3_wgmma_rows how to
//    pack the weights): wgmma.mma_async m64nNk32 s8 x s8 -> s32, operands
//    in shared memory.  Design:
//    - Roles.  The pixels are M (64 per wgmma: one output row of a 64-wide
//      tile, or 64 flat indices of a narrower frame) and the output channels
//      are N (48, 96 or 192 per instruction: all legal s8 widths, so no row
//      is padded).  Both operands are then K-major in the channel-last
//      layout, as 8-bit wgmma requires (it takes no transpose): a core
//      matrix is 8 pixels (or 8 output channels) x 16 int8 channels, 128
//      contiguous bytes, no swizzle.
//    - The input tile, quantized once.  A CTA owns a tile of TH output rows x
//      64 columns (frames narrower than 64: TH rows x the whole width) and
//      every output channel.  Before any multiply it brings the tile with its
//      1-pixel halo, all Cin channels, into shared memory as int8, laid out
//      [Cin/16][pixel][16 channels]: TMA boxes of 64 bytes a pixel (32 bf16
//      or 64 int8 channels; boxes of one 16-byte group ran at a fraction of
//      the rate) land in two staging slots, and all threads move each chunk
//      into the group slots, quantizing a bf16 chunk on the way, while the
//      next chunk lands.  A tap (ky, kx) then moves the A descriptor's start
//      by ky * row + kx pixels; M chunk c starts at pixel c * cs (cs = the
//      tile's row pitch: one output row per chunk, or 64 flat indices whose
//      wrapped columns the epilogue drops).  An odd number of 16-channel
//      groups is padded to whole k32 steps with zeros.
//    - Quantization is exact and cheap: v * (1/s) rounds to the integer that
//      the true division rounds to unless it lies within 3e-5 of a
//      half-integer; such a value sends its group (8 values, or a row block
//      of the epilogue) through __fdiv_rn and rintf.  One rarely taken
//      branch per group instead of a division per value.
//    - The weights stream through a ring of stages in shared memory (as
//      many as the steps use and the block's shared memory holds, up to
//      16), one bulk copy per stage counted by the stage's mbarrier, issued
//      by one thread; a stage holds one k32 step of three taps (or one tap,
//      where the tile is large) x the pass's output channels, prepacked
//      [tap][2][rows][16] in step order.  Step s queues its wgmma behind
//      those of step s-1, waits for s-1 only, and one __syncthreads frees the
//      stage that step s-1 read.  The steps of a pass run straight, with the
//      epilogue after them: an epilogue branch inside the loop made the
//      compiler wait for every step's multiplies.
//    - Output channels.  Each of the two warpgroups owns its own M chunks
//      (or, for the widest input, where the tile holds one row of 64 pixels,
//      its own half of the output channels) and N = 48, 96 or 192 channels
//      per pass: at most 96 int32 accumulators a thread.  Wider outputs
//      (384, 768) loop over passes of N channels, each re-reading the same
//      quantized tile.  Narrow plans (N x M chunks <= 96) fit two blocks to
//      an SM.
//    - One input channel (the model's first conv): the raw tile is staged and
//      quantized in shared memory, and its 9-tap im2col (K = 9 taps, padded
//      to one k32 step) is built from there.
//    - Epilogue: dequant, folded BN and ReLU in registers, two channels at a
//      time (the bf16 roundings paired); each warp parks 8 pixels x N
//      channels (bf16, or int8 quantized with s_out) in a slot of its own
//      and stores them 16 (8) bytes a thread, a pixel's channels contiguous
//      in the channel-last output.
//
//  * the mma.sync path (first half) for every shape: one CTA (8 warps) owns
//    an 8 x 16 output tile and 64 output channels, an implicit GEMM with
//    M = 64 channels, N = 128 pixels and K = 9 taps x Cin in steps of 32
//    input channels over two stages (mma.sync m16n8k32 s8, fragments by
//    ldmatrix.x4, 48-byte smem row pitch so the eight 16-byte rows of a
//    matrix fall on distinct banks); each CTA re-reads and re-quantizes its
//    input tile per 64-channel block.  Where Cin = 1 the nine taps are the K
//    dimension.  The epilogue parks the tile in shared memory, [pixel][64
//    channels] bf16, and stores it 16 bytes (int8: 8) a thread.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NTHREADS = 256;

struct Params {
  const void* x;        // bf16, or int8 (in_int8)
  const int8_t* wp;     // prepacked for the path that runs
  const float* sx;      // one value
  const float* sw;
  const float* scale;
  const float* bias;
  const float* sout;    // int8 output: its scale (one value), else null
  void* out;            // the result (bf16, or int8 with sout), or
  int32_t* acc_out;     // the raw accumulators (then out is null)
  int N, Cin, Cout, H, W;
  int in_int8;
  // mma.sync path
  int ntaps, nk;        // 9 and ceil(Cin / 32), or 1 and 1 (Cin = 1)
  // wgmma path: the plan (N per instruction, M chunks per warpgroup,
  // warpgroups splitting N, taps per weight stage, stages; plan_wgmma) and
  // the geometry
  int bn, mw, nbp, tps, stages;
  int th, tw, in_w, cs, nch, in_pix, ng, tiles_x, tiles_y, spp, passes;
  uint32_t stage_bytes, off_stage, off_stg, off_bar, pitch;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// A quantization scale s with its reciprocal r = 1/s (rounded).
struct Scale {
  float s, r;
};
__device__ __forceinline__ Scale make_scale(float s) {
  return {s, __frcp_rn(s)};
}

// clip(round_half_even(v / s), -127, 127) as one byte, the quotient the
// correctly rounded true division, as the JAX package quantizes.  v * r
// lies within 3 * 2^-24 |v / s| of that quotient, so the two round to the
// same integer unless v * r lies that close to a half-integer (below 130:
// within 2.4e-5; above, both clip).  quant_fast rounds v * r and flags
// `near` where it lies within 3e-5 of a half-integer; the callers then
// recompute their group of values with quant_exact, the true division
// (__fdiv_rn) and rintf: one rarely taken branch per group, not per value.
__device__ __forceinline__ uint32_t quant_fast(float v, Scale q, bool& near) {
  const float t = __fmul_rn(v, q.r);
  const float i = rintf(t);
  near |= fabsf(t - i) > 0.49997f;
  return (uint32_t)(uint8_t)(int8_t)(int)fminf(fmaxf(i, -127.f), 127.f);
}
__device__ __forceinline__ uint32_t quant_exact(float v, Scale q) {
  const float i = rintf(__fdiv_rn(v, q.s));
  return (uint32_t)(uint8_t)(int8_t)(int)fminf(fmaxf(i, -127.f), 127.f);
}
__device__ __forceinline__ uint32_t quant(float v, Scale q) {
  bool near = false;
  const uint32_t b = quant_fast(v, q, near);
  return near ? quant_exact(v, q) : b;
}

// Eight bf16 values as eight bytes.
__device__ __forceinline__ uint2 quant8(const bf16* v, Scale q) {
  bool near = false;
  uint32_t w[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    w[h] = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[h] |= quant_fast(__bfloat162float(v[4 * h + k]), q, near) << (8 * k);
  }
  if (near) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      w[h] = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[h] |= quant_exact(__bfloat162float(v[4 * h + k]), q) << (8 * k);
    }
  }
  return make_uint2(w[0], w[1]);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The epilogue of one accumulator: dequant, folded BN, ReLU, bf16 (as f32)
__device__ __forceinline__ float epilogue_value(int acc, float fac, float sc,
                                                float bi) {
  const float y = bf16_round(__fmul_rn(__int2float_rn(acc), fac));
  return bf16_round(fmaxf(fmaf(y, sc, bi), 0.f));
}

// The same for two accumulators of adjacent channels, the roundings to bf16
// two at a time; the result as a bf16 pair (the stored bf16 output).
__device__ __forceinline__ __nv_bfloat162 epilogue_pair(int a0, int a1,
                                                        float2 fac, float2 sc,
                                                        float2 bi) {
  const float2 y = __bfloat1622float2(
      __floats2bfloat162_rn(__fmul_rn(__int2float_rn(a0), fac.x),
                            __fmul_rn(__int2float_rn(a1), fac.y)));
  return __floats2bfloat162_rn(fmaxf(fmaf(y.x, sc.x, bi.x), 0.f),
                               fmaxf(fmaf(y.y, sc.y, bi.y), 0.f));
}

// ---------------------------------------------------------------------------
// The mma.sync path.

constexpr int TH = 8, TW = 16;                 // output tile
constexpr int IN_H = TH + 2, IN_W = TW + 2;    // with the 1-pixel halo
constexpr int IN_P = IN_H * IN_W;              // 180 input pixels
constexpr int P = TH * TW;                     // 128 output pixels
constexpr int MC = 64;                         // output channels per CTA
constexpr int KC = 32;                         // input channels per K-step
constexpr int KP = KC + 16;                    // smem row pitch, bytes
constexpr int IN_STAGE = IN_P * KP;            // bytes per input stage
constexpr int W_STAGE = 9 * MC * KP;           // bytes per weight stage
constexpr int OP = MC + 8;                     // parked output pitch, bf16
constexpr int GROUPS = KC / 8;                 // 8-channel groups per pixel
constexpr int ITEMS = (IN_P * GROUPS + NTHREADS - 1) / NTHREADS;
constexpr size_t SMEM = 2 * IN_STAGE + 2 * W_STAGE;
static_assert(P * OP * 2 <= 2 * W_STAGE, "the parked tile reuses the weights");
static_assert(P * KP <= IN_STAGE, "the im2col tile fits one input stage");

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

// Channels [c, c + 8) of one input pixel, zero past Cin or outside the frame:
// 8 bf16, or (an int8 input) 8 bytes in .x and .y
__device__ __forceinline__ uint4 load8(const Params& p, int n, int gy, int gx,
                                       int c) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (gy < 0 || gy >= p.H || gx < 0 || gx >= p.W || c >= p.Cin) return v;
  const size_t off = (((size_t)n * p.H + gy) * p.W + gx) * p.Cin + c;
  if (p.in_int8) {
    const int8_t* src = (const int8_t*)p.x + off;
    if (p.Cin % 8 == 0) {
      const uint2 u = *reinterpret_cast<const uint2*>(src);
      v.x = u.x;
      v.y = u.y;
      return v;
    }
    int8_t* e = reinterpret_cast<int8_t*>(&v);
    for (int i = 0; i < 8 && c + i < p.Cin; ++i) e[i] = src[i];
    return v;
  }
  const bf16* src = (const bf16*)p.x + off;
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
  const float sx = *p.sx;
  const Scale qx = make_scale(sx);
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
  // quantized (a bf16 input) into a stage
  uint4 regs[ITEMS];
  auto load_x = [&](int s) {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int i = threadIdx.x + k * NTHREADS;
      const int pix = i / GROUPS;
      regs[k] = i < IN_P * GROUPS
                    ? load8(p, n, y0 - 1 + pix / IN_W, x0 - 1 + pix % IN_W,
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
          p.in_int8 ? make_uint2(regs[k].x, regs[k].y)
                    : quant8(v, qx);
    }
  };

  // prologue: step 0 staged
  load_w(0);
  if (im2col) {
    // B[q][k] = xq at output pixel q shifted by tap k, zero for k >= 9
    const size_t base = (size_t)n * p.H * p.W;
    for (int i = threadIdx.x; i < P * KC; i += NTHREADS) {
      const int q = i / KC, k = i % KC;
      uint32_t v = 0;
      if (k < 9) {
        const int gy = y0 + q / TW + k / 3 - 1, gx = x0 + q % TW + k % 3 - 1;
        if (gy >= 0 && gy < p.H && gx >= 0 && gx < p.W) {
          const size_t at = base + (size_t)gy * p.W + gx;
          v = p.in_int8 ? (uint32_t)(uint8_t)((const int8_t*)p.x)[at]
                        : quant(__bfloat162float(((const bf16*)p.x)[at]), qx);
        }
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
          const int q = 32 * wn + 8 * j + 2 * t + e;
          out_s[q * OP + ml] = __float2bfloat16_rn(
              epilogue_value(acc[mt][j][2 * h + e], fac, sc, bi));
        }
    }
  __syncthreads();
  const int mrows = min(MC, p.Cout - m0);
  const size_t outn = (size_t)n * p.H * p.W * p.Cout;
  if (p.sout != nullptr) {      // int8: quantized with the next conv's scale
    const Scale so = make_scale(*p.sout);
    int8_t* o8 = (int8_t*)p.out + outn;
    if (p.Cout % 8 == 0) {
      const int parts = mrows / 8;
      for (int i = threadIdx.x; i < P * parts; i += NTHREADS) {
        const int q = i / parts, part = i % parts;
        const int gy = y0 + q / TW, gx = x0 + q % TW;
        if (gy < p.H && gx < p.W) {
          const bf16* v = out_s + q * OP + part * 8;
          *reinterpret_cast<uint2*>(o8 + ((size_t)gy * p.W + gx) * p.Cout +
                                    m0 + part * 8) =
              quant8(v, so);
        }
      }
    } else {
      for (int i = threadIdx.x; i < P * mrows; i += NTHREADS) {
        const int q = i / mrows, ml = i % mrows;
        const int gy = y0 + q / TW, gx = x0 + q % TW;
        if (gy < p.H && gx < p.W)
          o8[((size_t)gy * p.W + gx) * p.Cout + m0 + ml] = (int8_t)quant(
              __bfloat162float(out_s[q * OP + ml]), so);
      }
    }
    return;
  }
  bf16* o16 = (bf16*)p.out + outn;
  if (p.Cout % 8 == 0) {
    const int parts = mrows / 8;
    for (int i = threadIdx.x; i < P * parts; i += NTHREADS) {
      const int q = i / parts, part = i % parts;
      const int gy = y0 + q / TW, gx = x0 + q % TW;
      if (gy < p.H && gx < p.W)
        *reinterpret_cast<uint4*>(o16 + ((size_t)gy * p.W + gx) * p.Cout +
                                  m0 + part * 8) =
            *reinterpret_cast<const uint4*>(out_s + q * OP + part * 8);
    }
  } else {  // ragged channel count: scalar stores
    for (int i = threadIdx.x; i < P * mrows; i += NTHREADS) {
      const int q = i / mrows, ml = i % mrows;
      const int gy = y0 + q / TW, gx = x0 + q % TW;
      if (gy < p.H && gx < p.W)
        o16[((size_t)gy * p.W + gx) * p.Cout + m0 + ml] = out_s[q * OP + ml];
    }
  }
}

int launch_mma(Params& p, cudaStream_t stream) {
  p.ntaps = p.Cin == 1 ? 1 : 9;
  p.nk = p.Cin == 1 ? 1 : (p.Cin + KC - 1) / KC;
  const int nmb = (p.Cout + MC - 1) / MC;
  if ((long long)p.N * nmb > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(
      int8_conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.W + TW - 1) / TW, (p.H + TH - 1) / TH, p.N * nmb);
  int8_conv3x3_kernel<<<grid, NTHREADS, SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The wgmma path (design notes at the top of the file).

constexpr int WG_MAX_STAGES = 16;
// The input tile arrives by TMA in chunks of 64 bytes a pixel (32 bf16 or
// 64 int8 channels: rows of whole sectors; 16-byte rows, one per channel
// group, ran at a fraction of the rate), WG_NBUF chunks in flight.
constexpr int WG_NBUF = 2;
constexpr int WG_CHUNK = 64;

template <int N>
struct Wgmma;
template <>
struct Wgmma<48> {
  static __device__ __forceinline__ void run(int (&d)[24], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
        "}, %24, %25, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <>
struct Wgmma<96> {
  static __device__ __forceinline__ void run(int (&d)[48], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
        " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <>
struct Wgmma<192> {
  static __device__ __forceinline__ void run(int (&d)[96], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
        " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
        " %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
        " %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
        " %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
          "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
          "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
          "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
          "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
          "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes to shared memory (the quantized tile) -> visible to
// the asynchronous proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE_%=;\n"
      "bra WAIT_%=;\n"
      "DONE_%=:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// bytes global -> shared, reported to the mbarrier as complete_tx
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// one box of a 4-d tensor map (channel, x, y, frame) -> shared, dense in that
// order; what lies outside the tensor arrives as zeros
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c, int x, int y,
                                            int n) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c), "r"(x),
      "r"(y), "r"(n)
      : "memory");
}

template <int R>
__device__ __forceinline__ void fence_operand(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// K-major no-swizzle descriptor: start address, LBO (the next 16 bytes of K)
// and SBO (the next 8 rows), in bytes here and in 16-byte units in the fields
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

template <int BN, int MW, int TPS>
__global__ void __launch_bounds__(NTHREADS, BN * MW <= 96 ? 2 : 1)
int8_conv3x3_wgmma_kernel(const Params p,
                          const __grid_constant__ CUtensorMap xmap) {
  extern __shared__ __align__(128) unsigned char wsm[];
  unsigned char* tile = wsm;                         // [ng][in_pix][16]
  unsigned char* wst = wsm + p.off_stage;            // ring of [tap][2][rows][16]
  unsigned char* stg = wsm + p.off_stg + (threadIdx.x / 32) * 8 * p.pitch;
  uint64_t* full = reinterpret_cast<uint64_t*>(wsm + p.off_bar);
  uint64_t* cbar = full + p.stages;                  // the tile's chunks

  int blk = blockIdx.x;
  const int tx = blk % p.tiles_x;
  blk /= p.tiles_x;
  const int ty = blk % p.tiles_y, n = blk / p.tiles_y;
  const int x0 = tx * p.tw, y0 = ty * p.th;
  const int wgi = threadIdx.x / 128, wiw = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const float sx = *p.sx;
  const Scale qx = make_scale(sx);
  const int rows = p.nbp * BN;                       // weight rows per stage
  const int steps = p.passes * p.spp;
  const uint32_t G = (uint32_t)p.in_pix * 16;        // bytes per group slot
  // this warpgroup's first M chunk and its first row of a stage's weights
  const int c0 = p.nbp == 1 ? wgi * MW : 0;
  const int boff = p.nbp == 1 ? 0 : wgi * BN;
  const int in_h = p.th + 2, in_p = in_h * p.in_w;

  // the weight stage of step s: one bulk copy (stages lie in step order),
  // issued by one thread; nobody reads the stage any more when it is called
  auto load = [&](int s) {
    if (s >= steps || threadIdx.x != 0) return;
    const int st = s % p.stages;
    mbar_expect_tx(full + st, p.stage_bytes);
    bulk_copy(wst + st * p.stage_bytes, p.wp + (size_t)s * p.stage_bytes,
              p.stage_bytes, full + st);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages + WG_NBUF; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // The tile's copies go first, then the weights': chunk c of the tile is
  // one TMA box (channels [c * cch, (c + 1) * cch), the tile's pixels with
  // halo, zeros outside the tensor) into staging slot c % WG_NBUF (the
  // epilogue's slots, free until then).
  const int cch = p.in_int8 ? WG_CHUNK : WG_CHUNK / 2;
  const int nchunks = (p.Cin + cch - 1) / cch;
  unsigned char* sbuf = wsm + p.off_stg;
  const uint32_t slot = (uint32_t)p.in_pix * WG_CHUNK;
  auto fetch = [&](int c) {
    if (TPS == 0 || c >= nchunks || threadIdx.x != 0) return;
    uint64_t* bar = cbar + c % WG_NBUF;
    mbar_expect_tx(bar, (uint32_t)in_p * WG_CHUNK);
    tma_load_4d(sbuf + (c % WG_NBUF) * slot, &xmap, bar, c * cch, x0 - 1,
                y0 - 1, n);
  };
  for (int c = 0; c < WG_NBUF; ++c) fetch(c);
  for (int s = 0; s + 1 < p.stages; ++s) load(s);

  // the input tile with its halo, every channel, int8, quantized once
  if (TPS == 0) {
    // the raw tile quantized, then its im2col: row r of chunk c is output
    // flat index q = c * cs + r % 64, K = the nine taps (k >= 9 zero), the
    // second 16-byte group of K all zero
    unsigned char* raw = tile + 2 * p.nch * 64 * 16;
    const size_t base = (size_t)n * p.H * p.W;
    for (int i = threadIdx.x; i < in_p; i += NTHREADS) {
      const int gy = y0 - 1 + i / p.in_w, gx = x0 - 1 + i % p.in_w;
      uint32_t v = 0;
      if (gy >= 0 && gy < p.H && gx >= 0 && gx < p.W) {
        const size_t at = base + (size_t)gy * p.W + gx;
        v = p.in_int8 ? (uint32_t)(uint8_t)((const int8_t*)p.x)[at]
                      : quant(__bfloat162float(((const bf16*)p.x)[at]), qx);
      }
      raw[i] = (unsigned char)v;
    }
    __syncthreads();
    for (int r = threadIdx.x; r < p.nch * 64; r += NTHREADS) {
      const int q = (r / 64) * p.cs + r % 64;
      uint32_t w4[4] = {0, 0, 0, 0};
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const int at = q + (k / 3) * p.in_w + k % 3;
        const uint32_t b = at < in_p ? raw[at] : 0u;
        w4[k / 4] |= b << (8 * (k % 4));
      }
      *reinterpret_cast<uint4*>(tile + r * 16) =
          make_uint4(w4[0], w4[1], w4[2], w4[3]);
      *reinterpret_cast<uint4*>(tile + (p.nch * 64 + r) * 16) =
          make_uint4(0, 0, 0, 0);
    }
  } else {
    // each chunk, as it lands, into the tile's 16-channel group slots by all
    // threads, 16 staged bytes a thread (a bf16 chunk quantized on the way);
    // its staging slot then takes the chunk WG_NBUF ahead
    const int gpc = cch / 16;                        // groups per chunk
    for (int c = 0; c < nchunks; ++c) {
      mbar_wait(cbar + c % WG_NBUF, (c / WG_NBUF) & 1);
      const unsigned char* src = sbuf + (c % WG_NBUF) * slot;
      for (int i = threadIdx.x; i < in_p * 4; i += NTHREADS) {
        const int pix = i / 4, piece = i % 4;
        const uint4 v =
            *reinterpret_cast<const uint4*>(src + pix * WG_CHUNK + piece * 16);
        if (p.in_int8) {
          const int g = c * gpc + piece;
          if (g < p.ng)
            *reinterpret_cast<uint4*>(tile + g * G + pix * 16) = v;
        } else {
          const int g = c * gpc + piece / 2;
          const bf16* e = reinterpret_cast<const bf16*>(&v);
          if (g < p.ng)
            *reinterpret_cast<uint2*>(tile + g * G + pix * 16 +
                                      (piece % 2) * 8) =
                quant8(e, qx);
        }
      }
      __syncthreads();
      fetch(c + WG_NBUF);
    }
  }
  fence_proxy_async();
  __syncthreads();
  mbar_wait(full, 0);

  // The epilogue of pass ps for this warpgroup's chunks.  Accumulator
  // acc[j][4 jn + 2 h + e] is pixel row 16 wiw + 8 h + lane / 4 of chunk
  // c0 + j, output channel cb + 8 jn + 2 (lane % 4) + e.  A warp parks its
  // 8 rows of an h in its slot, then stores them row by row.
  int acc[MW][BN / 2] = {};
  auto epilogue = [&](int ps) {
    const int cb = ps * rows + boff;
    const int t = lane % 4, r8 = lane / 4;
    const bool q8 = p.sout != nullptr;
    const Scale so = make_scale(q8 ? __ldg(p.sout) : 1.f);
    constexpr int per_row = BN / 8;      // 8 (int8) or 16 (bf16) bytes each
    constexpr int rounds = (8 * per_row + 31) / 32;
#pragma unroll
    for (int j = 0; j < MW; ++j) {
      const int c = c0 + j;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // lane r < 8: the output pixel of the warp's row r, -1 outside the
        // tile or the frame
        int mypix = -1;
        if (lane < 8) {
          const int q = c * p.cs + 16 * wiw + 8 * h + lane;
          const int oy = q / p.in_w, ox = q % p.in_w;
          const int gy = y0 + oy, gx = x0 + ox;
          if (ox < p.tw && oy < p.th && gy < p.H && gx < p.W)
            mypix = (n * p.H + gy) * p.W + gx;
        }
        if (p.acc_out != nullptr) {
          const int px = __shfl_sync(0xffffffffu, mypix, r8);
          if (px >= 0) {
            int32_t* o = p.acc_out + (size_t)px * p.Cout + cb;
#pragma unroll
            for (int jn = 0; jn < BN / 8; ++jn)
              *reinterpret_cast<int2*>(o + 8 * jn + 2 * t) =
                  make_int2(acc[j][4 * jn + 2 * h], acc[j][4 * jn + 2 * h + 1]);
          }
          continue;
        }
        bool near = false;
#pragma unroll
        for (int jn = 0; jn < BN / 8; ++jn) {
          const int co = cb + 8 * jn + 2 * t;
          const float2 sw = __ldg(reinterpret_cast<const float2*>(p.sw + co));
          const __nv_bfloat162 v = epilogue_pair(
              acc[j][4 * jn + 2 * h], acc[j][4 * jn + 2 * h + 1],
              make_float2(__fmul_rn(sx, sw.x), __fmul_rn(sx, sw.y)),
              __ldg(reinterpret_cast<const float2*>(p.scale + co)),
              __ldg(reinterpret_cast<const float2*>(p.bias + co)));
          if (q8) {
            const float2 f = __bfloat1622float2(v);
            *reinterpret_cast<uint16_t*>(stg + r8 * p.pitch + 8 * jn + 2 * t) =
                (uint16_t)(quant_fast(f.x, so, near) |
                           quant_fast(f.y, so, near) << 8);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(stg + r8 * p.pitch +
                                               2 * (8 * jn + 2 * t)) = v;
          }
        }
        if (near) {           // rare: the row block again, by true division
#pragma unroll
          for (int jn = 0; jn < BN / 8; ++jn) {
            const int co = cb + 8 * jn + 2 * t;
            const float2 sw = __ldg(reinterpret_cast<const float2*>(p.sw + co));
            const float2 f = __bfloat1622float2(epilogue_pair(
                acc[j][4 * jn + 2 * h], acc[j][4 * jn + 2 * h + 1],
                make_float2(__fmul_rn(sx, sw.x), __fmul_rn(sx, sw.y)),
                __ldg(reinterpret_cast<const float2*>(p.scale + co)),
                __ldg(reinterpret_cast<const float2*>(p.bias + co))));
            *reinterpret_cast<uint16_t*>(stg + r8 * p.pitch + 8 * jn + 2 * t) =
                (uint16_t)(quant_exact(f.x, so) | quant_exact(f.y, so) << 8);
          }
        }
        __syncwarp();
        // the 8 rows, a row's channels contiguous in the output
#pragma unroll
        for (int k = 0; k < rounds; ++k) {
          const int i = lane + 32 * k;
          const int r = i / per_row < 8 ? i / per_row : 7, part = i % per_row;
          const int px = __shfl_sync(0xffffffffu, mypix, r);
          if (i >= 8 * per_row || px < 0) continue;
          const size_t at = (size_t)px * p.Cout + cb + 8 * part;
          if (q8)
            *reinterpret_cast<uint2*>((int8_t*)p.out + at) =
                *reinterpret_cast<const uint2*>(stg + r * p.pitch + 8 * part);
          else
            *reinterpret_cast<uint4*>((bf16*)p.out + at) =
                *reinterpret_cast<const uint4*>(stg + r * p.pitch + 16 * part);
        }
        __syncwarp();
      }
    }
  };

  // Passes of N output channels, each a straight run of steps (no branch
  // on the sums inside it, so that the compiler keeps the multiplies of
  // consecutive steps in flight), then the pass's epilogue.
  const uint32_t tile_a = smem_u32(tile);
  for (int ps = 0, s = 0; ps < p.passes; ++ps) {
    for (int st = 0; st < p.spp; ++st, ++s) {
      // here the weights of step s have landed, the wgmma of step s-2 are
      // done everywhere, those of step s-1 may still run
      const uint32_t wb = smem_u32(wst + (s % p.stages) * p.stage_bytes);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < MW; ++j) fence_operand(acc[j]);
      if (TPS == 0) {       // Cin = 1: one k32 step of the im2col per pass
        const uint64_t bd = wg_desc(wb + boff * 16, rows * 16, 128);
#pragma unroll
        for (int j = 0; j < MW; ++j)
          Wgmma<BN>::run(acc[j],
                         wg_desc(tile_a + (c0 + j) * 64 * 16,
                                 p.nch * 64 * 16, 128),
                         bd, 0);
      } else {
        const int ks = st / (9 / TPS), tg = st % (9 / TPS);
        const uint32_t ab = tile_a + 2 * ks * G;
#pragma unroll
        for (int i = 0; i < TPS; ++i) {
          const int tap = tg * TPS + i;
          const int toff = (tap / 3) * p.in_w + tap % 3;
          const uint64_t bd =
              wg_desc(wb + (i * 2 * rows + boff) * 16, rows * 16, 128);
#pragma unroll
          for (int j = 0; j < MW; ++j)
            Wgmma<BN>::run(
                acc[j], wg_desc(ab + ((c0 + j) * p.cs + toff) * 16, G, 128),
                bd, st > 0 || i > 0);
        }
      }
      wgmma_commit();
      // step s-1 done here, whose stage the copy of step s-1 + stages takes
      // once every warpgroup is past this point
      wgmma_wait<1>();
      if (s + 1 < steps)
        mbar_wait(full + (s + 1) % p.stages, ((s + 1) / p.stages) & 1);
      __syncthreads();
      load(s - 1 + p.stages);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < MW; ++j) fence_operand(acc[j]);
    epilogue(ps);
  }
}

// cuTensorMapEncodeTiled through the runtime, so that the library needs no
// link against the driver.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The channel-last input as a 4-d tensor (C, W, H, N) with a box of one
// chunk (64 int8 or 32 bf16 channels) x the tile's width and height with
// halo.
int make_input_map(CUtensorMap* map, const Params& p) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                            cudaEnableDefault, &q);
    if (e != cudaSuccess) return (int)e;
    if (q != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorNotSupported;
    encode = (EncodeTiled)fn;
  }
  const cuuint64_t es = p.in_int8 ? 1 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)p.Cin, (cuuint64_t)p.W,
                              (cuuint64_t)p.H, (cuuint64_t)p.N};
  const cuuint64_t strides[3] = {es * p.Cin, es * p.W * p.Cin,
                                 es * p.H * p.W * p.Cin};
  const cuuint32_t box[4] = {(cuuint32_t)(WG_CHUNK / es), (cuuint32_t)p.in_w,
                             (cuuint32_t)(p.th + 2), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = encode(map,
                      p.in_int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      4, const_cast<void*>(p.x), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                      CU_TENSOR_MAP_L2_PROMOTION_NONE,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

uint32_t round_up(uint32_t v, uint32_t m) { return (v + m - 1) / m * m; }

// The tile geometry and the shared-memory layout of the plan in p (bn, mw,
// nbp, tps, stages) for a frame of p.W x p.H; returns the bytes.
size_t layout_wgmma(Params& p) {
  const int bn = p.bn;
  p.nch = p.nbp == 1 ? 2 * p.mw : p.mw;
  if (p.W >= 64) {          // one output row of 64 pixels per M chunk
    p.tw = 64;
    p.in_w = 66;
    p.cs = 66;
    p.th = p.nch;
  } else {                  // 64 flat indices of the whole width per chunk
    p.tw = p.W;
    p.in_w = p.W + 2;
    p.cs = 64;
    p.th = (64 * p.nch - p.W) / p.in_w + 1;
  }
  if (p.th > p.H) p.th = p.H;
  const int in_p = (p.th + 2) * p.in_w;
  uint32_t tile;
  if (p.Cin == 1) {
    p.ng = 2;
    p.in_pix = 0;
    tile = 2 * p.nch * 64 * 16 + round_up(in_p, 16);
    p.spp = 1;
    p.stage_bytes = 32 * p.nbp * bn;
  } else {
    // pixels a chunk's last tap reads
    const int reach = (p.nch - 1) * p.cs + 64 + 2 * p.in_w + 2;
    p.in_pix = round_up(in_p > reach ? in_p : reach, 8);
    p.ng = round_up(p.Cin / 16, 2);
    tile = (uint32_t)p.ng * p.in_pix * 16;
    p.spp = p.ng / 2 * (9 / p.tps);
    p.stage_bytes = p.tps * 32 * p.nbp * bn;
  }
  p.passes = p.Cout / (p.nbp * bn);
  p.pitch = 2 * bn + 16;
  p.off_stage = round_up(tile, 128);
  p.off_stg = round_up(p.off_stage + p.stages * p.stage_bytes, 128);
  // the warps' parking slots, which stage the tile's chunks before
  const uint32_t slots = 8 * 8 * p.pitch;
  const uint32_t staging = WG_NBUF * (uint32_t)p.in_pix * WG_CHUNK;
  p.off_bar = round_up(p.off_stg + (slots > staging ? slots : staging), 8);
  p.tiles_x = (p.W + p.tw - 1) / p.tw;
  p.tiles_y = (p.H + p.th - 1) / p.th;
  return p.off_bar + (p.stages + WG_NBUF) * sizeof(uint64_t);
}

// Shared memory a block may use (optin) and a block's share where two share
// an SM (two), on the current device.
int smem_limits(size_t* optin, size_t* two) {
  int dev = 0, opt = 0, per_sm = 0, reserved = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&opt, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&reserved,
                               cudaDevAttrReservedSharedMemoryPerBlock, dev);
  *optin = (size_t)opt;
  *two = (size_t)(per_sm / 2 - reserved);
  return (int)e;
}

// The wgmma path's plan for p's shape, the one place it is decided; returns
// the bytes of shared memory, 0 where the path does not take the shape.
//  * N per instruction (bn): the widest of 192, 96, 48 that divides Cout;
//    M chunks per warpgroup (mw): 2 for N = 48, else 1 (the instantiations).
//  * The key (nbp, tps): the warpgroups split the pixels with three taps per
//    weight stage where the widest tile (a frame 64 or more wide) fits the
//    block's shared memory with the least ring (three stages; two for one
//    input channel, whose passes are one step each), else they split the
//    output channels, with three taps per stage, else one.  The weights'
//    packing depends on nbp * bn alone (rows per pass), which the wrapper
//    gets from int8_conv3x3_wgmma_rows; the key does not depend on the frame.
//  * The ring: as many stages as the steps use (at most WG_MAX_STAGES) and
//    the budget holds for this frame: a block's share where two share an SM
//    if the accumulators leave registers for two (bn * mw <= 96) and the
//    least ring fits it, else the block's whole shared memory.
size_t plan_wgmma(Params& p, size_t optin, size_t two) {
  if (!(p.Cin == 1 || p.Cin % 16 == 0) || p.Cout % 48) return 0;
  p.bn = p.Cout % 192 == 0 ? 192 : p.Cout % 96 == 0 ? 96 : 48;
  p.mw = p.bn == 48 ? 2 : 1;
  const int least = p.Cin == 1 ? 2 : 3;
  static const int keys[3][2] = {{1, 3}, {2, 3}, {2, 1}};
  bool found = false;
  for (int k = 0; k < 3 && !found; ++k) {
    if (p.Cout % (keys[k][0] * p.bn)) continue;
    Params q = p;
    q.nbp = keys[k][0];
    q.tps = keys[k][1];
    q.stages = least;
    q.W = 64;
    q.H = 64;
    if (layout_wgmma(q) <= optin) {
      p.nbp = q.nbp;
      p.tps = q.tps;
      found = true;
    }
  }
  if (!found) return 0;
  p.stages = least;
  layout_wgmma(p);
  int most = p.passes * p.spp;
  most = most < WG_MAX_STAGES ? most : WG_MAX_STAGES;
  most = most > least ? most : least;
  const size_t budgets[2] = {two, optin};
  for (int b = p.bn * p.mw <= 96 ? 0 : 1; b < 2; ++b)
    for (int s = most; s >= least; --s) {
      p.stages = s;
      const size_t bytes = layout_wgmma(p);
      if (bytes <= budgets[b]) return bytes;
    }
  return 0;
}

template <int BN, int MW, int TPS>
int launch_wgmma_as(const Params& p, size_t smem, const CUtensorMap& xmap,
                    cudaStream_t stream) {
  auto kern = int8_conv3x3_wgmma_kernel<BN, MW, TPS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long ctas = (long long)p.N * p.tiles_x * p.tiles_y;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kern<<<(unsigned)ctas, NTHREADS, smem, stream>>>(p, xmap);
  return (int)cudaGetLastError();
}

// The instantiations: (N, M chunks per warpgroup) as plan_wgmma pairs them,
// with three taps per stage, one, or the im2col of one input channel (TPS 0).
template <int BN, int MW>
int launch_wgmma_tps(const Params& p, size_t smem, const CUtensorMap& xmap,
                     cudaStream_t stream) {
  if (p.Cin == 1) return launch_wgmma_as<BN, MW, 0>(p, smem, xmap, stream);
  if (p.tps == 3) return launch_wgmma_as<BN, MW, 3>(p, smem, xmap, stream);
  return launch_wgmma_as<BN, MW, 1>(p, smem, xmap, stream);
}

// rows: the rows per pass of the weights' packing, which must be this plan's
int launch_wgmma(Params& p, int rows, cudaStream_t stream) {
  size_t optin = 0, two = 0;
  const int e = smem_limits(&optin, &two);
  if (e != 0) return e;
  const size_t smem = plan_wgmma(p, optin, two);
  if (smem == 0 || p.nbp * p.bn != rows) return (int)cudaErrorInvalidValue;
  CUtensorMap xmap = {};
  if (p.Cin > 1) {
    const int me = make_input_map(&xmap, p);
    if (me != 0) return me;
  }
  if (p.bn == 48) return launch_wgmma_tps<48, 2>(p, smem, xmap, stream);
  if (p.bn == 96) return launch_wgmma_tps<96, 1>(p, smem, xmap, stream);
  return launch_wgmma_tps<192, 1>(p, smem, xmap, stream);
}

}  // namespace

extern "C" {

// The wgmma path's weight packing for Cin -> Cout on the current device:
// *rows = its rows per pass (the plan's nbp * bn), 0 where the path does not
// take the shape.  Returns a cudaError_t.
int int8_conv3x3_wgmma_rows(int Cin, int Cout, int* rows) {
  size_t optin = 0, two = 0;
  const int e = smem_limits(&optin, &two);
  *rows = 0;
  if (e != 0) return e;
  Params p = {};
  p.Cin = Cin;
  p.Cout = Cout;
  p.W = 64;
  p.H = 64;
  if (Cin > 0 && Cout > 0 && plan_wgmma(p, optin, two) != 0)
    *rows = p.nbp * p.bn;
  return 0;
}

// Returns a cudaError_t (0 = launched).  x is channel-last (N, H, W, Cin),
// bf16, or int8 already quantized with sx (in_int8), aligned to 16 bytes; wp
// the weights prepacked for the path: rows = 0 the mma.sync path, else the
// wgmma path, packed with the rows per pass that int8_conv3x3_wgmma_rows
// gives; sx a device pointer to one f32; exactly one of out and acc_out
// (int32) is non-null, out bf16 or, where sout (one f32 on the device) is
// non-null, int8, both channel-last; the stream is a cudaStream_t.
int int8_conv3x3_launch(const void* x, const void* wp, const void* sx,
                        const void* sw, const void* scale, const void* bias,
                        const void* sout, void* out, void* acc_out, int N,
                        int Cin, int Cout, int H, int W, int in_int8, int rows,
                        void* stream) {
  Params p = {};
  p.x = x;
  p.wp = (const int8_t*)wp;
  p.sx = (const float*)sx;
  p.sw = (const float*)sw;
  p.scale = (const float*)scale;
  p.bias = (const float*)bias;
  p.sout = (const float*)sout;
  p.out = out;
  p.acc_out = (int32_t*)acc_out;
  p.N = N;
  p.Cin = Cin;
  p.Cout = Cout;
  p.H = H;
  p.W = W;
  p.in_int8 = in_int8;
  if ((out == nullptr) == (acc_out == nullptr) || N <= 0 || Cin <= 0 ||
      Cout <= 0 || H <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return rows == 0 ? launch_mma(p, st) : launch_wgmma(p, rows, st);
}

}  // extern "C"
