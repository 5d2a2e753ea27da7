// fused_double_cbr: two chained Conv3x3(zero pad 1, no bias) + folded-BN + ReLU
// in one kernel, the intermediate activation kept in shared memory.
//
// Replaces the TPU kernel att_aspp_unet_tpu/ops/pallas/fused_conv.py
// ::fused_double_cbr (body _make_kernel / _conv3x3).  Same function:
//   h = bf16(relu(s1 * conv3x3(x, w1) + b1))   zeroed outside the true frame
//   y = relu(s2 * conv3x3(h, w2) + b2)         written in bf16
// x and y are (N, C, H, W) bf16 tensors in channel-last memory (NHWC strides);
// the weights arrive prepacked (ops/kernels/fused_conv.py); scale/bias are f32
// per channel; sums are f32.
//
// What bounds it on an H100.  By the shapes alone every pair does 10^2-10^3
// bf16 operations per byte it must move, far above the card's ~295 op/byte
// ridge, so the bound is the tensor-core rate (989 TFLOP/s dense bf16).  What
// a CTA actually waits for, as measured on the card: every CTA streams the
// whole weight set from L2 for its 16 x 16 (or 8 x 16) pixels, and that
// traffic, not device memory, is the nearest ceiling of the wide pairs; the
// narrow pairs at 512^2 spend as long in per-tile work (epilogues, the first
// copies of a tile) as in the multiply.
//
// One CTA (8 warps, one per SM) owns a TH x 16 output tile of one frame and
// all its channels.  conv1 is an implicit GEMM (M = 64 mid channels per pass,
// N = the halo'd intermediate pixels, K = 9 taps x Cin); its epilogue applies
// scale/bias/ReLU, zeroes pixels outside the frame (conv2's zero padding),
// rounds to bf16 and keeps the whole intermediate tile, all Cmid channels, in
// shared memory.  conv2 is the same GEMM read in place from that tile; its
// epilogue parks each 64-channel result tile in shared memory and stores it to
// the channel-last output 16 bytes per thread.  conv1 and conv2 form one flat
// sequence of K-steps (64-row block x K-chunk) over a ring of stages.  Both
// epilogues leave the registers through stmatrix (8 pixels x 8 channels a
// block, transposed).
//
// Two paths compute it, chosen per pair by the caller:
//
//  * the wgmma path (second half of this file; design notes there): operands
//    in the channel-group-major layout that a wgmma descriptor can walk, the
//    input tile by TMA, the weight chunk by one bulk copy, mbarriers, two
//    warpgroups on wgmma.mma_async.  It takes channel counts that are whole
//    16-channel K-steps.
//
//  * the mma.sync path (first half), which takes every shape:
//    - operands reach shared memory by 16-byte cp.async only: a pixel's KC
//      channels are KC*2 contiguous bytes of the channel-last input (zero
//      filled outside the frame through cp.async's source size), and a
//      K-step's weight chunk is one contiguous run of the prepacked weights;
//      a two-stage ring with one __syncthreads per step: the copies of step
//      s+1 are issued right after the barrier of step s and land while step
//      s multiplies;
//    - fragments come from shared memory by ldmatrix.x4, the fragments of
//      k-step i+1 loaded before the mma of k-step i issue; every row pitch is
//      (channels + 8) bf16, so the eight 16-byte rows of a matrix fall on
//      distinct banks.  A warp owns all 64 rows x up to 6 pixel groups of 8
//      (96 f32 accumulators): 7 ldmatrix.x4 feed 24 mma.sync;
//    - where Cin = 1 (the model's first pair) the nine taps are the K
//      dimension: the staged tile is the im2col of the input, one mma K-step
//      instead of nine zero-padded ones;
//    - channel counts that are not multiples of 8 take scalar staging loads
//      and scalar output stores (same ring, same barriers); multiples of 8
//      never do;
//    - prepacked weights: rows padded to a multiple of 16, cut into blocks of
//      up to 64 rows; K (channels, or 9 on the tap-as-K path) padded to a
//      multiple of KC and cut into chunks; block-major, then chunk, each
//      chunk [tap][row][KC] contiguous;
//    - shared memory decides (TH, KC) per Cmid (the caller picks, the launch
//      checks): (16, 32) up to Cmid 96, (16, 16) up to 192, (8, 16) up to 384.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TW = 16;              // output tile width in pixels
constexpr int MC = 64;              // output channels per accumulator pass
constexpr int SKEW = 8;             // bf16 elements added to each smem row
constexpr int OP = MC + SKEW;       // pitch of the parked output tile
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;

struct Params {
  const bf16* x;
  const bf16* w1p;
  const float* s1;
  const float* b1;
  const bf16* w2p;
  const float* s2;
  const float* b2;
  bf16* out;
  int Cin, Cmid, Cout, H, W;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy global -> shared; zero fill when !valid.
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n)
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

// Four (two) 8x8 bf16 blocks of an accumulator, transposed on the way: the
// thread's register k holds D[channel lane/4][pixel 2 (lane%4), +1] of block
// k, and lane 8 k + r gives the address of pixel r's 16 bytes (8 channels).
__device__ __forceinline__ void stmatrix4_t(uint32_t addr, uint32_t r0,
                                            uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1,%2,%3,%4};\n" ::
          "r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}
__device__ __forceinline__ void stmatrix2_t(uint32_t addr, uint32_t r0,
                                            uint32_t r1) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x2.trans.shared.b16 [%0], {%1,%2};\n" ::"r"(
          addr), "r"(r0), "r"(r1)
      : "memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__host__ __device__ inline int round16(int c) { return (c + 15) / 16 * 16; }

template <int TH, int KC>
struct Tile {
  static constexpr int IN_W = TW + 4, IN_H = TH + 4, IN_P = IN_W * IN_H;
  static constexpr int MID_W = TW + 2, MID_H = TH + 2, P1 = MID_W * MID_H;
  static constexpr int P2 = TH * TW;
  static constexpr int NT1 = (P1 + 7) / 8, NT2 = P2 / 8;
  static constexpr int NTW1 = (NT1 + NWARPS - 1) / NWARPS;
  static constexpr int NTW2 = (NT2 + NWARPS - 1) / NWARPS;
  static constexpr int NTW = NTW1 > NTW2 ? NTW1 : NTW2;   // pixel groups/warp
  static constexpr int KP = KC + SKEW;                    // staged row pitch
  static constexpr int IN_STAGE = IN_P * KP;              // bf16 per stage
  static constexpr int W_STAGE = 9 * MC * KP;
  static_assert(P2 * OP <= 2 * IN_STAGE,
                "the parked output tile reuses the input stages");
  static_assert(KC % 16 == 0, "a K-chunk is whole mma k-steps");
  static_assert(P1 * KP + IN_P <= IN_STAGE,
                "the tap-as-K tile and the raw tile share one input stage");
};

template <int TH, int KC>
__host__ __device__ inline size_t smem_bytes(int cmid) {
  using T = Tile<TH, KC>;
  return ((size_t)T::P1 * (round16(cmid) + SKEW) + 2 * T::IN_STAGE +
          2 * T::W_STAGE) * sizeof(bf16) + 16;   // + the 16-byte dump slot
}

// One conv of the pair as the flat loop sees it.
struct Conv {
  const bf16* wp;   // prepacked weights
  int ntaps;        // 9, or 1 on the tap-as-K path
  int mpad;         // output channels rounded up to 16
  int kpad16;       // K per tap rounded up to 16
  int nk;           // K-chunks per row block
  int steps;        // row blocks * nk
};

__device__ __forceinline__ Conv make_conv(const bf16* wp, int ntaps, int m,
                                          int k, int kc) {
  Conv c;
  c.wp = wp;
  c.ntaps = ntaps;
  c.mpad = round16(m);
  c.kpad16 = round16(k);
  c.nk = (c.kpad16 + kc - 1) / kc;
  c.steps = ((c.mpad + MC - 1) / MC) * c.nk;
  return c;
}

// The asynchronous copies of one K-step: the
// weight chunk (one contiguous run of the prepacked weights ->
// w_s[tap][row][KP]) and, for conv1, channels [c0, c0+KC) of the input tile
// with its 2-pixel halo -> in_s[pixel][KP]; 16-byte cp.async each.
template <int TH, int KC>
struct Copies {
  using T = Tile<TH, KC>;
  static constexpr int PARTS = KC / 8;

  static __device__ __forceinline__ void weights(bf16* w_s, const Conv& c,
                                                 int mb, int kc) {
    const int rows = min(MC, c.mpad - mb * MC);
    const bf16* src = c.wp + (size_t)mb * MC * c.ntaps * c.nk * KC +
                      (size_t)kc * c.ntaps * rows * KC;
    const int pieces = c.ntaps * rows * PARTS;
    for (int i = threadIdx.x; i < pieces; i += NTHREADS)
      cp_async16(w_s + (i / PARTS) * T::KP + (i % PARTS) * 8, src + i * 8,
                 true);
  }
  static __device__ __forceinline__ void input(bf16* in_s, const Params& p,
                                               const bf16* xn, int y0, int x0,
                                               int c0) {
    for (int i = threadIdx.x; i < T::IN_P * PARTS; i += NTHREADS) {
      const int pix = i / PARTS, c = c0 + (i % PARTS) * 8;
      const int gy = y0 - 2 + pix / T::IN_W, gx = x0 - 2 + pix % T::IN_W;
      const bool ok = c < p.Cin && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
      const bf16* src = ok ? xn + ((size_t)gy * p.W + gx) * p.Cin + c : xn;
      cp_async16(in_s + pix * T::KP + (i % PARTS) * 8, src, ok);
    }
  }
};

// Input staging for a channel count that is no multiple of 8: scalar loads.
template <int TH, int KC>
__device__ __forceinline__ void stage_input_ragged(bf16* in_s, const Params& p,
                                                   const bf16* xn, int y0,
                                                   int x0, int c0) {
  using T = Tile<TH, KC>;
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < T::IN_P * KC; i += NTHREADS) {
    const int pix = i / KC, c = c0 + i % KC;
    const int gy = y0 - 2 + pix / T::IN_W, gx = x0 - 2 + pix % T::IN_W;
    bf16 v = zero;
    if (c < p.Cin && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W)
      v = xn[((size_t)gy * p.W + gx) * p.Cin + c];
    in_s[pix * T::KP + i % KC] = v;
  }
}

// Tap-as-K path (Cin = 1): in_s[q][k] = x at intermediate pixel q shifted by
// tap k (the weights' (ky, kx) order), zero for k >= 9.  The raw tile goes
// through shared memory first (raw, IN_P values), so every global load is
// independent of the others.  Contains a __syncthreads.
template <int TH, int KC>
__device__ __forceinline__ void stage_im2col(bf16* in_s, bf16* raw,
                                             const Params& p, const bf16* xn,
                                             int y0, int x0) {
  using T = Tile<TH, KC>;
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < T::IN_P; i += NTHREADS) {
    const int gy = y0 - 2 + i / T::IN_W, gx = x0 - 2 + i % T::IN_W;
    raw[i] = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W
                 ? xn[(size_t)gy * p.W + gx] : zero;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < T::P1 * 16; i += NTHREADS) {
    const int q = i / 16, k = i % 16;
    in_s[q * T::KP + k] =
        k < 9 ? raw[(q / T::MID_W + k / 3) * T::IN_W + q % T::MID_W + k % 3]
              : zero;
  }
}

// One K-step (ntaps taps x ksub mma k-steps of 16) of the implicit GEMM for
// this warp's pixel groups.  src: channel-last tile in shared memory whose
// pixel (r, c) lives at src + (r * src_w + c) * pitch; output pixel
// q = (qy, qx) of an out_w-wide grid reads src pixel (qy + ky, qx + kx).
// The fragments of k-step i+1 are loaded before the mma of k-step i issue
// (two register sets), so ldmatrix latency hides behind the tensor cores.
// MT (16-row tiles of this row block) and NG (pixel groups per warp) are
// template parameters and every warp runs all NG groups, padding groups on a
// clamped address: a predicate on a .sync instruction costs a warp
// synchronisation before each one.
template <int NTW, int KP, int MT, int NG>
__device__ __forceinline__ void mma_step(float acc[4][NTW][4], const bf16* w_s,
                                         const bf16* src, int pitch, int src_w,
                                         int out_w, int P, int ntaps,
                                         int ksub) {
  static_assert(NG <= NTW, "accumulators for every group");
  constexpr int NGP = (NG + 1) / 2;  // ldmatrix.x4 loads two groups
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // A (weights): matrices (rows 0-7, k 0-7) (rows 8-15, k 0-7) (rows 0-7,
  // k 8-15) (rows 8-15, k 8-15) -> a0..a3 of mma.m16n8k16
  const uint32_t a_base =
      smem_u32(w_s) + 2 * ((lane & 15) * KP + (lane >> 4) * 8);
  // B (pixels): matrices (group j, k 0-7) (j, k 8-15) (j+1, k 0-7)
  // (j+1, k 8-15) -> b0, b1 of groups j and j+1
  uint32_t b_base[NGP];
#pragma unroll
  for (int jp = 0; jp < NGP; ++jp) {
    int q = (warp + NWARPS * (2 * jp + (lane >> 4))) * 8 + (lane & 7);
    if (q >= P) q = 0;  // padding: any valid address, result unused
    b_base[jp] = smem_u32(src) +
                 2 * (((q / out_w) * src_w + q % out_w) * pitch +
                      ((lane >> 3) & 1) * 8);
  }

  int tap_n = 0, kk_n = 0;  // the k-step whose fragments are loaded next
  auto load_frag = [&](uint32_t (&a)[MT][4], uint32_t (&b)[NGP][4]) {
    const uint32_t a_at = a_base + 2 * (tap_n * MT * 16 * KP + kk_n * 16);
    const uint32_t b_off =
        2 * (((tap_n / 3) * src_w + tap_n % 3) * pitch + kk_n * 16);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) ldsm4(a[mt], a_at + 2 * mt * 16 * KP);
#pragma unroll
    for (int jp = 0; jp < NGP; ++jp) ldsm4(b[jp], b_base[jp] + b_off);
    if (++kk_n == ksub) {
      kk_n = 0;
      ++tap_n;
    }
  };
  auto multiply = [&](const uint32_t (&a)[MT][4], const uint32_t (&b)[NGP][4]) {
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        mma16816(acc[mt][j], a[mt], b[j / 2][2 * (j % 2)],
                 b[j / 2][2 * (j % 2) + 1]);
  };

  const int iters = ntaps * ksub;
  uint32_t a0[MT][4], b0[NGP][4], a1[MT][4], b1[NGP][4];
  load_frag(a0, b0);
  int it = 1;  // fragment sets loaded so far; a0/b0 is not multiplied yet
#pragma unroll 1
  for (; it + 1 < iters; it += 2) {
    load_frag(a1, b1);
    multiply(a0, b0);
    load_frag(a0, b0);
    multiply(a1, b1);
  }
  if (it < iters) {
    load_frag(a1, b1);
    multiply(a0, b0);
    multiply(a1, b1);
  } else {
    multiply(a0, b0);
  }
}

// mma_step for a runtime count of row tiles.
template <int NTW, int KP, int NG>
__device__ __forceinline__ void mma_step_mt(int m_tiles, float acc[4][NTW][4],
                                            const bf16* w_s, const bf16* src,
                                            int pitch, int src_w, int out_w,
                                            int P, int ntaps, int ksub) {
  switch (m_tiles) {
    case 4:
      mma_step<NTW, KP, 4, NG>(acc, w_s, src, pitch, src_w, out_w, P, ntaps,
                               ksub);
      break;
    case 3:
      mma_step<NTW, KP, 3, NG>(acc, w_s, src, pitch, src_w, out_w, P, ntaps,
                               ksub);
      break;
    case 2:
      mma_step<NTW, KP, 2, NG>(acc, w_s, src, pitch, src_w, out_w, P, ntaps,
                               ksub);
      break;
    default:
      mma_step<NTW, KP, 1, NG>(acc, w_s, src, pitch, src_w, out_w, P, ntaps,
                               ksub);
  }
}

template <int TH, int KC>
__global__ void __launch_bounds__(NTHREADS, 1)
fused_double_cbr_kernel(const Params p) {
  using T = Tile<TH, KC>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* mid_s = reinterpret_cast<bf16*>(smem_raw);
  const int cmid_pad = round16(p.Cmid);
  const int mpitch = cmid_pad + SKEW;
  bf16* in_s = mid_s + (size_t)T::P1 * mpitch;   // two stages
  bf16* w_s = in_s + 2 * T::IN_STAGE;            // two stages
  bf16* out_s = in_s;                            // free once conv1 is done
  // where the epilogues' stmatrix rows of padding pixels go (16 bytes)
  const uint32_t dump = smem_u32(w_s + 2 * T::W_STAGE);

  const int n = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const bf16* xn = p.x + (size_t)n * p.H * p.W * p.Cin;
  bf16* outn = p.out + (size_t)n * p.H * p.W * p.Cout;

  const bool im2col = p.Cin == 1;
  const Conv c1 = make_conv(p.w1p, im2col ? 1 : 9, p.Cmid,
                            im2col ? 16 : p.Cin, KC);
  const Conv c2 = make_conv(p.w2p, 9, p.Cout, p.Cmid, KC);
  const int steps = c1.steps + c2.steps;

  // The copies of step s (all threads issue them; one commit group) and
  // the input staging that is no asynchronous copy.
  using CP = Copies<TH, KC>;
  const bool ragged = !im2col && p.Cin % 8 != 0;
  auto load = [&](int s) {
    bf16* ws = w_s + (s & 1) * T::W_STAGE;
    if (s < c1.steps) {
      const int mb = s / c1.nk, kc = s % c1.nk;
      bf16* is = in_s + (s & 1) * T::IN_STAGE;
      CP::weights(ws, c1, mb, kc);
      if (ragged)
        stage_input_ragged<TH, KC>(is, p, xn, y0, x0, kc * KC);
      else if (!im2col)
        CP::input(is, p, xn, y0, x0, kc * KC);
    } else {
      const int s2 = s - c1.steps;
      CP::weights(ws, c2, s2 / c2.nk, s2 % c2.nk);
    }
    cp_async_commit();
  };

  float acc[4][T::NTW][4];

  // tap-as-K: one K-chunk, staged once into stage 0 for every row block
  if (im2col)
    stage_im2col<TH, KC>(in_s, in_s + T::P1 * T::KP, p, xn, y0, x0);
  load(0);
  for (int s = 0; s < steps; ++s) {
    // step s has landed and is visible; everyone is done with step s-1, so
    // its stage is free for the copies of step s+1, which land while step s
    // multiplies
    cp_async_wait_all();
    __syncthreads();
    if (s + 1 < steps) load(s + 1);

    const bool first = s < c1.steps;
    const int nk = first ? c1.nk : c2.nk;
    const int sc = first ? s : s - c1.steps;
    const int mb = sc / nk, kc = sc % nk;
    const int m0 = mb * MC;
    const int rows = min(MC, (first ? c1.mpad : c2.mpad) - m0);
    const int m_tiles = rows / 16;
    const int ksub =
        KC == 16 ? 1 : min(KC, (first ? c1.kpad16 : c2.kpad16) - kc * KC) / 16;
    const bf16* ws = w_s + (s & 1) * T::W_STAGE;

    if (kc == 0) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int j = 0; j < T::NTW; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mt][j][r] = 0.f;
    }

    if (first)
      mma_step_mt<T::NTW, T::KP, T::NTW1>(
          m_tiles, acc, ws, in_s + (im2col ? 0 : (s & 1) * T::IN_STAGE), T::KP,
          im2col ? T::MID_W : T::IN_W, T::MID_W, T::P1, c1.ntaps, ksub);
    else
      mma_step_mt<T::NTW, T::KP, T::NTW2>(m_tiles, acc, ws, mid_s + kc * KC,
                                          mpitch, T::MID_W, TW, T::P2, 9,
                                          ksub);
    if (kc != nk - 1) continue;

    // this row block's folded BN, 0 for rows past the last channel
    float sc_r[4][2], bi_r[4][2];
    {
      const float* sp = first ? p.s1 : p.s2;
      const float* bp = first ? p.b1 : p.b2;
      const int M = first ? p.Cmid : p.Cout;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + mt * 16 + g + 8 * h;
          sc_r[mt][h] = m < M ? sp[m] : 0.f;
          bi_r[mt][h] = m < M ? bp[m] : 0.f;
        }
    }

    // The accumulators go to shared memory eight pixels x eight channels at
    // a time (stmatrix, transposed: a pixel's 8 channels are its 16 bytes).
    // Block k of a store is (pixel group jj + k / 2, row half k % 2); lane
    // 8 k + r addresses pixel r of block k, padding pixels the dump slot.
    const int blk = lane >> 3;
    if (first) {
      // folded BN + ReLU, zero outside the frame, bf16 into mid_s
#pragma unroll
      for (int jj = 0; jj < T::NTW1; jj += 2) {
        bool in[2][2];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int q = (warp + NWARPS * (jj + k / 2)) * 8 + 2 * t + k % 2;
          const int gy = y0 - 1 + q / T::MID_W, gx = x0 - 1 + q % T::MID_W;
          in[k / 2][k % 2] = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
        }
        const int ql = (warp + NWARPS * (jj + blk / 2)) * 8 + (lane & 7);
        const bool keep = jj + blk / 2 < T::NTW1 && ql < T::P1;
        const uint32_t row =
            smem_u32(mid_s) + (ql * mpitch + m0 + (blk % 2) * 8) * 2;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          if (mt >= m_tiles) continue;
          uint32_t r[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = jj + k / 2 < T::NTW1 ? jj + k / 2 : jj, h = k % 2;
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              v[e] = in[k / 2][e]
                         ? fmaxf(fmaf(acc[mt][j][2 * h + e], sc_r[mt][h],
                                      bi_r[mt][h]), 0.f)
                         : 0.f;
            r[k] = pack_bf16(v[0], v[1]);
          }
          const uint32_t addr = keep ? row + mt * 32 : dump;
          if (jj + 1 < T::NTW1)
            stmatrix4_t(addr, r[0], r[1], r[2], r[3]);
          else
            stmatrix2_t(addr, r[0], r[1]);
        }
      }
    } else {
      // folded BN + ReLU in bf16 into out_s[pixel][channel - m0] ...
#pragma unroll
      for (int jj = 0; jj < T::NTW2; jj += 2) {
        const int ql = (warp + NWARPS * (jj + blk / 2)) * 8 + (lane & 7);
        const bool keep = jj + blk / 2 < T::NTW2;
        const uint32_t row = smem_u32(out_s) + (ql * OP + (blk % 2) * 8) * 2;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          if (mt >= m_tiles) continue;
          uint32_t r[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = jj + k / 2 < T::NTW2 ? jj + k / 2 : jj, h = k % 2;
            r[k] = pack_bf16(
                fmaxf(fmaf(acc[mt][j][2 * h], sc_r[mt][h], bi_r[mt][h]), 0.f),
                fmaxf(fmaf(acc[mt][j][2 * h + 1], sc_r[mt][h], bi_r[mt][h]),
                      0.f));
          }
          const uint32_t addr = keep ? row + mt * 32 : dump;
          if (jj + 1 < T::NTW2)
            stmatrix4_t(addr, r[0], r[1], r[2], r[3]);
          else
            stmatrix2_t(addr, r[0], r[1]);
        }
      }
      __syncthreads();
      // ... and from there to the channel-last output
      const int mrows = min(MC, p.Cout - m0);
      if (p.Cout % 8 == 0) {
        const int parts = mrows / 8;
        for (int i = threadIdx.x; i < T::P2 * parts; i += NTHREADS) {
          const int q = i / parts, part = i % parts;
          const int gy = y0 + q / TW, gx = x0 + q % TW;
          if (gy < p.H && gx < p.W)
            *reinterpret_cast<uint4*>(outn + ((size_t)gy * p.W + gx) * p.Cout +
                                      m0 + part * 8) =
                *reinterpret_cast<const uint4*>(out_s + q * OP + part * 8);
        }
      } else {  // ragged channel count: scalar stores
        for (int i = threadIdx.x; i < T::P2 * mrows; i += NTHREADS) {
          const int q = i / mrows, ml = i % mrows;
          const int gy = y0 + q / TW, gx = x0 + q % TW;
          if (gy < p.H && gx < p.W)
            outn[((size_t)gy * p.W + gx) * p.Cout + m0 + ml] =
                out_s[q * OP + ml];
        }
      }
      // the next write to out_s comes after the next step's barrier
    }
  }
}

template <int TH, int KC>
int launch(const Params& p, int N, cudaStream_t stream) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = smem_bytes<TH, KC>(p.Cmid);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidConfiguration;
  auto kern = fused_double_cbr_kernel<TH, KC>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.W + TW - 1) / TW, (p.H + TH - 1) / TH, N);
  kern<<<grid, NTHREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The wgmma path: the same pair on Hopper's warpgroup matrix multiply.
//
// Both operands of wgmma.mma_async come from shared memory through a matrix
// descriptor with two strides, which fixes the layout: in the no-swizzle
// K-major form a core matrix is 8 rows x 16 bytes stored as one contiguous
// 128 bytes; SBO steps to the next 8 rows, LBO to the next 16 bytes of K.  So
// every tile here is channel-group-major, [C/8][pixel][8 channels]: a pixel's
// 8 channels are 16 bytes, 8 pixels that follow each other in memory are one
// core matrix (SBO = 128 bytes), LBO = pixels x 16 bytes, and a conv tap moves
// the start address by whole pixels.  The weights' chunk is prepacked the same
// way, [tap][K/8][64 rows][8].
//
// N of the GEMM is a run of flat pixel indices, not a rectangle: conv1
// computes intermediate "pixel" q = my * 20 + mx for every q in [0, 18 * 20)
// from input flat index q + ky * 20 + kx of the 20-wide input tile; columns
// mx = 18, 19 wrap into the next row and are dropped by the epilogue, which
// writes the 18-wide intermediate tile.  conv2 does the same over that tile
// (q = oy * 18 + ox, columns 16, 17 dropped).  The price is 11-25 % more
// multiply-adds than the rectangle; it buys one descriptor per tap with no
// gaps.  The two warpgroups take the two halves of the flat range (n184 and
// n144 at 16 rows, n104 and n72 at 8), sharing the 64-row weight chunk.
//
// K-steps are 16 channels over a three-stage ring with one __syncthreads per
// step.  One thread issues a step's copies: the weight chunk as one bulk copy
// and the input tile's 16 channels as two boxes of a 4-d tensor map over the
// channel-last input (TMA; what lies outside the frame arrives as zeros), all
// counted in bytes by the stage's mbarrier, so no other thread spends an
// instruction on a copy.  Step s queues its wgmma behind those of step s-1,
// waits for s-1 only, and then issues the copies of step s+2 into the stage
// step s-1 read: the tensor cores always have a step queued and a copy has a
// whole step to land.  Rows are padded to 64 per block (wgmma's M), so a
// 48-channel pair multiplies a quarter more than it needs.

template <int N>
struct Wgmma;
template <>
struct Wgmma<184> {
  static __device__ __forceinline__ void run(float (&d)[92], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %94, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n184k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
        " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
        " %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
        " %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
        " %84, %85, %86, %87, %88, %89, %90, %91"
        "}, %92, %93, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <>
struct Wgmma<144> {
  static __device__ __forceinline__ void run(float (&d)[72], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
        " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
        " %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71"
        "}, %72, %73, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <>
struct Wgmma<104> {
  static __device__ __forceinline__ void run(float (&d)[52], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %54, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
        " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51"
        "}, %52, %53, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <>
struct Wgmma<72> {
  static __device__ __forceinline__ void run(float (&d)[36], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35"
        "}, %36, %37, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// generic-proxy writes to shared memory (st.shared, stmatrix) -> visible to
// the asynchronous proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// mbarrier (one per stage) and the copies that report to it
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
__device__ __forceinline__ void bulk_copy(bf16* dst, const bf16* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// one box of a 4-d tensor map (channel, x, y, frame) -> shared, dense in that
// order; what lies outside the tensor arrives as zeros
__device__ __forceinline__ void tma_load_4d(bf16* dst, const CUtensorMap* map,
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
__device__ __forceinline__ void fence_operand(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// K-major no-swizzle descriptor: start address, LBO (next 16 bytes of K) and
// SBO (next 8 rows), all in bytes here and in 16-byte units in the fields.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

constexpr int WG_KC = 16;       // channels per K-step
constexpr int WG_STAGES = 3;
constexpr int WG_WCHUNK = 9 * 2 * MC * 8;  // bf16 per weight chunk

template <int TH>
struct WgTile {
  static constexpr int IN_W = TW + 4, IN_H = TH + 4;
  static constexpr int MID_W = TW + 2, MID_H = TH + 2;
  static constexpr int N1 = MID_H * IN_W;              // conv1 flat outputs
  static constexpr int NH1 = ((N1 + 1) / 2 + 7) / 8 * 8;   // per warpgroup
  static constexpr int N2 = TH * MID_W;                // conv2 flat outputs
  static constexpr int NH2 = N2 / 2;
  // pixels a tile holds: what the last flat output's last tap reads
  static constexpr int IN_PIX = (2 * NH1 + 2 * IN_W + 2 + 7) / 8 * 8;
  static constexpr int MID_PIX = (2 * NH2 + 2 * MID_W + 2 + 7) / 8 * 8;
  static constexpr int IN_STAGE = 2 * IN_PIX * 8;      // bf16 per stage
  static constexpr int P2 = TH * TW;
  static_assert(NH2 % 8 == 0 && 2 * NH2 == N2, "conv2 halves are whole");
  static_assert(MID_PIX >= MID_H * MID_W, "the intermediate tile fits");
  static_assert(P2 * OP <= WG_STAGES * IN_STAGE,
                "the parked output tile reuses the input stages");
};

__host__ __device__ inline int round64(int c) { return (c + 63) / 64 * 64; }

template <int TH>
__host__ __device__ inline size_t wg_smem_bytes(int cmid) {
  using T = WgTile<TH>;
  return ((size_t)round64(cmid) * T::MID_PIX +
          WG_STAGES * (T::IN_STAGE + WG_WCHUNK)) * sizeof(bf16) +
         WG_STAGES * sizeof(uint64_t) + 40;  // barriers, 16-byte dump slot
}

template <int TH>
__global__ void __launch_bounds__(NTHREADS, 1)
fused_double_cbr_wgmma_kernel(const Params p,
                              const __grid_constant__ CUtensorMap xmap) {
  using T = WgTile<TH>;
  extern __shared__ __align__(128) unsigned char wg_smem[];
  bf16* mid_s = reinterpret_cast<bf16*>(wg_smem);    // [Cmid64/8][MID_PIX][8]
  bf16* in_s = mid_s + (size_t)round64(p.Cmid) * T::MID_PIX;  // 3 x [2][IN_PIX][8]
  bf16* w_s = in_s + WG_STAGES * T::IN_STAGE;        // 3 x [9][2][64][8]
  uint64_t* full = reinterpret_cast<uint64_t*>(w_s + WG_STAGES * WG_WCHUNK);
  bf16* out_s = in_s;                                // free once conv1 is done
  // where the epilogues' stmatrix rows of dropped pixels go (16 bytes)
  const uint32_t dump = (smem_u32(full + WG_STAGES) + 15) & ~15u;

  const int n = blockIdx.z;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int wgi = threadIdx.x / 128;                 // warpgroup
  const int lane = threadIdx.x % 32;
  const int row0 = ((threadIdx.x % 128) / 32) * 16 + lane / 4;  // and row0 + 8
  const int col0 = 2 * (lane % 4);                   // + 8 j, + 1
  bf16* outn = p.out + (size_t)n * p.H * p.W * p.Cout;

  const int nk1 = p.Cin / WG_KC, nk2 = round16(p.Cmid) / WG_KC;
  const int steps1 = (round64(p.Cmid) / MC) * nk1;
  const int steps = steps1 + (round64(p.Cout) / MC) * nk2;

  // the copies of step s, all issued by one thread and counted in bytes by
  // the stage's mbarrier: the weight chunk (chunks lie in step order), one
  // bulk copy; and, for conv1, 16 channels of the input tile with its halo,
  // one tensor-map box per 8-channel group, zero-filled outside the frame.
  // Nobody reads the stage any more when this is called.
  auto load = [&](int s) {
    if (s >= steps || threadIdx.x != 0) return;
    const int st = s % WG_STAGES;
    constexpr uint32_t WBYTES = WG_WCHUNK * sizeof(bf16);
    constexpr uint32_t GBYTES = T::IN_H * T::IN_W * 8 * sizeof(bf16);
    mbar_expect_tx(full + st, WBYTES + (s < steps1 ? 2 * GBYTES : 0));
    bulk_copy(w_s + st * WG_WCHUNK,
              s < steps1 ? p.w1p + (size_t)s * WG_WCHUNK
                         : p.w2p + (size_t)(s - steps1) * WG_WCHUNK,
              WBYTES, full + st);
    if (s < steps1) {
      const int c0 = (s % nk1) * WG_KC;
      bf16* idst = in_s + st * T::IN_STAGE;
#pragma unroll
      for (int g8 = 0; g8 < 2; ++g8)
        tma_load_4d(idst + g8 * T::IN_PIX * 8, &xmap, full + st, c0 + g8 * 8,
                    x0 - 2, y0 - 2, n);
    }
  };

  // one accumulator set: conv1's n-half is the wider, conv2 uses the front
  float acc1[T::NH1 / 2];
  float (&acc2)[T::NH2 / 2] = reinterpret_cast<float (&)[T::NH2 / 2]>(acc1);
  static_assert(T::NH2 <= T::NH1, "conv2's accumulators fit in conv1's");

  // end of a step: the copies of step `next` have landed, this thread's
  // writes to shared memory are visible to wgmma, and nobody reads the
  // stage of step next-2 any more
  auto step_sync = [&](int next) {
    if (next < steps) mbar_wait(full + next % WG_STAGES, (next / WG_STAGES) & 1);
    fence_proxy_async();
    __syncthreads();
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < WG_STAGES; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  load(0);
  load(1);
  step_sync(0);
  for (int s = 0; s < steps; ++s) {
    // here the copies of step s have landed and are visible, the wgmma of
    // step s-2 are done everywhere (stage (s+1) % 3 is being filled), and
    // those of step s-1 may still run: step s queues behind them
    const bool first = s < steps1;
    const int nk = first ? nk1 : nk2;
    const int sc = first ? s : s - steps1;
    const int m0 = (sc / nk) * MC, kc = sc % nk;
    const uint32_t a0 = smem_u32(w_s + (s % WG_STAGES) * WG_WCHUNK);

    wgmma_fence();
    if (first) {
      const uint32_t b0 =
          smem_u32(in_s + (s % WG_STAGES) * T::IN_STAGE) + wgi * T::NH1 * 16;
      fence_operand(acc1);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        Wgmma<T::NH1>::run(
            acc1, wg_desc(a0 + tap * 2048, MC * 16, 128),
            wg_desc(b0 + ((tap / 3) * T::IN_W + tap % 3) * 16, T::IN_PIX * 16,
                    128),
            kc > 0 || tap > 0);
    } else {
      const uint32_t b0 = smem_u32(mid_s) + kc * 2 * T::MID_PIX * 16 +
                          wgi * T::NH2 * 16;
      fence_operand(acc2);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        Wgmma<T::NH2>::run(
            acc2, wg_desc(a0 + tap * 2048, MC * 16, 128),
            wg_desc(b0 + ((tap / 3) * T::MID_W + tap % 3) * 16,
                    T::MID_PIX * 16, 128),
            kc > 0 || tap > 0);
    }
    wgmma_commit();
    // a row block's last step needs its sums now; any other step only
    // needs step s-1 done, whose stage the copies of step s+2 take
    const bool last = kc == nk - 1;
    if (last)
      wgmma_wait_all();
    else
      wgmma_wait_one();
    if (!last) {
      step_sync(s + 1);
      load(s + 2);
      continue;
    }

    // this thread's two rows of the block: folded BN, 0 past the last channel
    float sc_r[2], bi_r[2];
    {
      const float* sp = first ? p.s1 : p.s2;
      const float* bp = first ? p.b1 : p.b2;
      const int M = first ? p.Cmid : p.Cout;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + row0 + 8 * h;
        sc_r[h] = m < M ? sp[m] : 0.f;
        bi_r[h] = m < M ? bp[m] : 0.f;
      }
    }
    // The accumulator goes to shared memory eight pixels x eight channels at
    // a time (stmatrix, transposed: a pixel's 8 channels are its 16 bytes).
    // Block k of a store is (pixel group jj + k / 2, row half k % 2); lane
    // 8 k + r addresses pixel r of block k, dropped pixels the dump slot.
    const int blk = lane >> 3;
    if (first) {
      // folded BN + ReLU, zero outside the frame, bf16 into the 18-wide
      // intermediate tile; flat columns 18, 19 are the wrapped ones
      fence_operand(acc1);
      const uint32_t mid0 =
          smem_u32(mid_s) + ((m0 >> 3) + 2 * ((threadIdx.x % 128) / 32)) *
                                T::MID_PIX * 16;
      constexpr int NJ = T::NH1 / 8;
#pragma unroll
      for (int jj = 0; jj < NJ; jj += 2) {
        uint32_t r[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = jj + k / 2, h = k % 2;
          if (j >= NJ) continue;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int q = wgi * T::NH1 + 8 * j + col0 + e;
            const int gy = y0 - 1 + q / T::IN_W, gx = x0 - 1 + q % T::IN_W;
            const bool in = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
            v[e] = in ? fmaxf(fmaf(acc1[4 * j + 2 * h + e], sc_r[h], bi_r[h]),
                              0.f)
                      : 0.f;
          }
          r[k] = pack_bf16(v[0], v[1]);
        }
        // this lane's row: pixel lane % 8 of block lane / 8
        const int q = wgi * T::NH1 + 8 * (jj + blk / 2) + (lane & 7);
        const int my = q / T::IN_W, mx = q % T::IN_W;
        const bool keep = q < T::N1 && mx < T::MID_W;
        const uint32_t addr =
            keep ? mid0 + ((blk % 2) * T::MID_PIX + my * T::MID_W + mx) * 16
                 : dump;
        if (jj + 1 < NJ)
          stmatrix4_t(addr, r[0], r[1], r[2], r[3]);
        else
          stmatrix2_t(addr, r[0], r[1]);
      }
    } else {
      fence_operand(acc2);
      const uint32_t out0 =
          smem_u32(out_s) + ((threadIdx.x % 128) / 32) * 16 * sizeof(bf16);
      constexpr int NJ = T::NH2 / 8;
#pragma unroll
      for (int jj = 0; jj < NJ; jj += 2) {
        uint32_t r[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = jj + k / 2, h = k % 2;
          if (j >= NJ) continue;
          r[k] = pack_bf16(
              fmaxf(fmaf(acc2[4 * j + 2 * h], sc_r[h], bi_r[h]), 0.f),
              fmaxf(fmaf(acc2[4 * j + 2 * h + 1], sc_r[h], bi_r[h]), 0.f));
        }
        const int q = wgi * T::NH2 + 8 * (jj + blk / 2) + (lane & 7);
        const int oy = q / T::MID_W, ox = q % T::MID_W;
        const uint32_t addr =
            ox < TW ? out0 + ((oy * TW + ox) * OP + (blk % 2) * 8) * 2 : dump;
        if (jj + 1 < NJ)
          stmatrix4_t(addr, r[0], r[1], r[2], r[3]);
        else
          stmatrix2_t(addr, r[0], r[1]);
      }
      __syncthreads();
      const int parts = min(MC, p.Cout - m0) / 8;
      for (int i = threadIdx.x; i < T::P2 * parts; i += NTHREADS) {
        const int q = i / parts, part = i % parts;
        const int gy = y0 + q / TW, gx = x0 + q % TW;
        if (gy < p.H && gx < p.W)
          *reinterpret_cast<uint4*>(outn + ((size_t)gy * p.W + gx) * p.Cout +
                                    m0 + part * 8) =
              *reinterpret_cast<const uint4*>(out_s + q * OP + part * 8);
      }
    }
    step_sync(s + 1);   // also: out_s is read before anyone writes it again
    load(s + 2);
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

// The channel-last input as a 4-d tensor (C, W, H, N) with a box of
// 8 channels x the tile's width and height with halo.
int make_input_map(CUtensorMap* map, const Params& p, int N, int box_w,
                   int box_h) {
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
  const cuuint64_t dims[4] = {(cuuint64_t)p.Cin, (cuuint64_t)p.W,
                              (cuuint64_t)p.H, (cuuint64_t)N};
  const cuuint64_t strides[3] = {
      (cuuint64_t)p.Cin * sizeof(bf16), (cuuint64_t)p.W * p.Cin * sizeof(bf16),
      (cuuint64_t)p.H * p.W * p.Cin * sizeof(bf16)};
  const cuuint32_t box[4] = {8, (cuuint32_t)box_w, (cuuint32_t)box_h, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                      const_cast<bf16*>(p.x), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                      CU_TENSOR_MAP_L2_PROMOTION_NONE,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int TH>
int launch_wgmma(const Params& p, int N, cudaStream_t stream) {
  using T = WgTile<TH>;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = wg_smem_bytes<TH>(p.Cmid);
  if (smem > (size_t)optin || p.Cin % 16 || p.Cmid % 16 || p.Cout % 8)
    return (int)cudaErrorInvalidConfiguration;
  CUtensorMap xmap;
  int me = make_input_map(&xmap, p, N, T::IN_W, T::IN_H);
  if (me != 0) return me;
  auto kern = fused_double_cbr_wgmma_kernel<TH>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.W + TW - 1) / TW, (p.H + TH - 1) / TH, N);
  kern<<<grid, NTHREADS, smem, stream>>>(p, xmap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched).  x and out are channel-last
// (N, H, W, C) device pointers aligned to 16 bytes; w1p and w2p are the
// weights prepacked for this kc and path (wgmma: 1 for the warpgroup path and
// its weight order, 0 for the mma.sync path); the stream is a cudaStream_t.
int fused_double_cbr_launch(const void* x, const void* w1p, const void* s1,
                            const void* b1, const void* w2p, const void* s2,
                            const void* b2, void* out, int N, int Cin,
                            int Cmid, int Cout, int H, int W, int th, int kc,
                            int wgmma, void* stream) {
  Params p;
  p.x = (const bf16*)x;
  p.w1p = (const bf16*)w1p;
  p.s1 = (const float*)s1;
  p.b1 = (const float*)b1;
  p.w2p = (const bf16*)w2p;
  p.s2 = (const float*)s2;
  p.b2 = (const float*)b2;
  p.out = (bf16*)out;
  p.Cin = Cin;
  p.Cmid = Cmid;
  p.Cout = Cout;
  p.H = H;
  p.W = W;
  cudaStream_t st = (cudaStream_t)stream;
  if (wgmma) {
    if (th == 16 && kc == WG_KC) return launch_wgmma<16>(p, N, st);
    if (th == 8 && kc == WG_KC) return launch_wgmma<8>(p, N, st);
    return (int)cudaErrorInvalidConfiguration;
  }
  if (th == 16 && kc == 32) return launch<16, 32>(p, N, st);
  if (th == 16 && kc == 16) return launch<16, 16>(p, N, st);
  if (th == 8 && kc == 16) return launch<8, 16>(p, N, st);
  return (int)cudaErrorInvalidConfiguration;
}

}  // extern "C"
