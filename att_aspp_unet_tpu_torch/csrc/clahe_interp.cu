// clahe_interp: CLAHE's dual-grid LUT interpolation.
//
// Replaces the TPU kernels att_aspp_unet_tpu/ops/pallas/clahe_interp.py
// ::clahe_interp_pallas_batched (body _kernel_batched) and
// ::clahe_interp_pallas (body _kernel), which compute the same function:
// for every dual-grid block b of frame n,
//   out[n, b, p] = sum_c LUT[n, b, v, c] * wts[p, c],   v = blocks[n, b, p]
// with v outside [0, 255] (padding) giving 0.
//
// What bounds it on an H100: per pixel it reads a 4-byte value and writes a
// 4-byte result, with 7 flops, so it is bound by device-memory bytes
// (3.35 TB/s).  The TPU version turned the lookup into a one-hot MXU matmul;
// here it is a direct gather: one CTA per (frame, block) copies that block's
// 256 x 4 f32 corner LUT (4 KB) into shared memory, and the threads stride
// over the block's pixels with coalesced loads of v and the weights.  The
// blend is the explicit chain fma(g3, w3, fma(g2, w2, fma(g1, w1, g0 * w0)))
// with __fmul_rn / __fmaf_rn, so nvcc has no freedom left: that is the order
// in which the JAX package's XLA path evaluates sum(g * w, -1) on the CPU
// (it contracts the reduction into FMAs), and the plain PyTorch version
// computes the same chain exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;

__global__ void __launch_bounds__(NTHREADS)
clahe_interp_kernel(const int32_t* __restrict__ blocks,
                    const float* __restrict__ luts,
                    const float* __restrict__ wts, float* __restrict__ out,
                    int P) {
  __shared__ float4 lut_s[256];
  const size_t nb = blockIdx.x;
  const float4* lut = reinterpret_cast<const float4*>(luts) + nb * 256;
  for (int i = threadIdx.x; i < 256; i += NTHREADS) lut_s[i] = lut[i];
  __syncthreads();

  const int32_t* v = blocks + nb * P;
  float* o = out + nb * P;
  const float4* w4 = reinterpret_cast<const float4*>(wts);
  for (int p = threadIdx.x; p < P; p += NTHREADS) {
    const int val = v[p];
    float r = 0.f;
    if (val >= 0 && val < 256) {
      const float4 g = lut_s[val];
      const float4 w = w4[p];
      r = __fmaf_rn(g.w, w.w,
                    __fmaf_rn(g.z, w.z, __fmaf_rn(g.y, w.y,
                                                  __fmul_rn(g.x, w.x))));
    }
    o[p] = r;
  }
}

}  // namespace

extern "C" {

// blocks (NB, P) int32, luts (NB, 256, 4) f32, wts (P, 4) f32 -> out (NB, P)
// f32, NB = frames x blocks.  Returns a cudaError_t (0 = launched).
int clahe_interp_launch(const void* blocks, const void* luts, const void* wts,
                        void* out, long long nb, int P, void* stream) {
  if (nb <= 0 || P <= 0) return 0;
  clahe_interp_kernel<<<(unsigned)nb, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)blocks, (const float*)luts, (const float*)wts,
      (float*)out, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
