// Half-precision bilinear warp for Hopper (sm_90a): the Liquid Warping
// Block's grid sample (align_corners=True, zero padding) in one pass.
//
// Replaces no TPU kernel: the JAX package's grid_sample and
// grid_sample_patched (impersonator_tpu/ops/sampler.py) are plain jnp. The
// port computed the same arithmetic in plain PyTorch (the twin,
// ops/cuda_warp.warp_bilinear_plain): float32 coordinates, one gather that
// writes all four corners at full size, then about eight full-size
// elementwise passes, ~48 launches a warp. This kernel was added because
// those warps took 22.9% of an imitation batch's device time (4.47 of
// 19.51 ms for 16 frames at 256² on an H100) at 1.7% of their byte bound.
//
// What it computes, bit for bit the twin's, one rounding to T per
// operation:
//
//   fx = ((g.x + 1) * 0.5) * (w - 1), fy likewise, in float32; x0 =
//   floor(fx), y0 = floor(fy); tx = T(fx - x0), ty = T(fy - y0); a = T(1 -
//   tx), b = T(1 - ty). A corner (x0 or x0 + 1, y0 or y0 + 1) outside the
//   image gets weight 0 (a or tx times 0), and its value is still read at
//   the clamped index and multiplied by that 0, as the twin's gather does:
//   the sign of a zero on the background flow (-2) and inf / NaN follow
//   the value read. Then top = T(T(v00 w00) + T(v01 w01)), bot likewise,
//   out = T(T(top b) + T(bot ty)).
//
// The twin's PyTorch ops compute each operation in float32 and round the
// result to T; the coordinates here do the same. The per-channel lerp
// runs in T's own arithmetic (__hmul_rn, __hadd_rn: one correct rounding
// each), which gives the same bits: the product of two values of T is
// exact in float32, and for a sum, rounding to float32 and then to T is
// one correct rounding to T because float32 carries more than twice T's
// precision plus two bits (Figueroa, "When is double rounding
// innocuous?", SIGNUM 1995); a NaN is the card's one canonical pattern on
// both routes. Build with --fmad=false and never with fast math: a
// contracted multiply-add rounds once where the twin rounds twice.
//
// What bounds it: bytes. For a batch of 16 at the published widths the
// five warps of an imitation step (the source image, 3 channels at 256²;
// the encoder's 128, 256 and 512 channels at 128², 64², 32²; the six
// residual blocks' 3,072 at 32²) write 112.2 M values (224 MB), read the
// float32 flows (11.3 MB) and the batch-1 source features (14 MB, which
// stay in the 50 MB L2): ~250 MB, 0.075 ms at 3.35 TB/s. The twin moves
// about 20 full-size passes through device memory.
//
// What the design does about it:
//
//   * every output value is written once and nothing else goes to device
//     memory; the source is read with its batch stride (0 for a batch-1
//     source: no expanded copy) and the grid through its strides
//     (resize_flow's permuted view is not copied);
//   * a thread owns one output pixel of one batch item: it computes the
//     coordinates, the four clamped corner offsets and the four masked
//     weights once, and reuses them over a chunk of kChunk channels, at
//     four loads, six operations in T and one store a channel;
//   * neighbouring threads take neighbouring pixels of one channel plane,
//     so each store of a warp is 64 contiguous bytes, and the corner reads
//     of a smooth flow fall on few sectors;
//   * the grid is (pixel blocks, channel chunks, batch items): the 32²
//     stages have 1,024 pixels an item, 16,384 a batch, and their channel
//     chunks fill the 132 SMs (1,024 to 6,144 blocks of 256 threads for
//     each of the five warps).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // output pixels of a block
constexpr int kChunk = 32;     // channels of a block

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

// v rounded to T
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

// v rounded once to T, back in float32
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_float(from_float<T>(v));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    warp_bilinear_kernel(const T* __restrict__ x,
                         const float* __restrict__ grid, T* __restrict__ out,
                         int c, int h, int w, int ho, int wo, int64_t sxb,
                         int64_t sxc, int64_t sxh, int64_t sxw, int64_t sgn,
                         int64_t sgh, int64_t sgw, int64_t sgk) {
  const int hw = ho * wo;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= hw) return;
  const int n = blockIdx.z;
  const int c0 = blockIdx.y * kChunk;
  const int c1 = min(c, c0 + kChunk);
  const int oy = p / wo;
  const int ox = p - oy * wo;

  const float* g = grid + n * sgn + oy * sgh + ox * sgw;
  const float wm = static_cast<float>(w - 1);
  const float hm = static_cast<float>(h - 1);
  const float fx = __fmul_rn(__fmul_rn(__fadd_rn(g[0], 1.0f), 0.5f), wm);
  const float fy = __fmul_rn(__fmul_rn(__fadd_rn(g[sgk], 1.0f), 0.5f), hm);
  const float x0 = floorf(fx);
  const float y0 = floorf(fy);
  const float x1 = __fadd_rn(x0, 1.0f);
  const float y1 = __fadd_rn(y0, 1.0f);
  const float tx = rnd<T>(__fsub_rn(fx, x0));
  const float ty = rnd<T>(__fsub_rn(fy, y0));
  const float a = rnd<T>(__fsub_rn(1.0f, tx));
  const float b = rnd<T>(__fsub_rn(1.0f, ty));
  const bool in_x0 = x0 >= 0.0f && x0 <= wm;
  const bool in_x1 = x1 >= 0.0f && x1 <= wm;
  const bool in_y0 = y0 >= 0.0f && y0 <= hm;
  const bool in_y1 = y1 >= 0.0f && y1 <= hm;
  // weight times validity, exact (times 1 or 0): the zero signed by the
  // weight, NaN kept
  const float w00 = __fmul_rn(a, in_x0 && in_y0 ? 1.0f : 0.0f);
  const float w01 = __fmul_rn(tx, in_x1 && in_y0 ? 1.0f : 0.0f);
  const float w10 = __fmul_rn(a, in_x0 && in_y1 ? 1.0f : 0.0f);
  const float w11 = __fmul_rn(tx, in_x1 && in_y1 ? 1.0f : 0.0f);
  // clamped corners, read whatever their weight (fmaxf sends NaN to 0;
  // the twin cannot index with a NaN coordinate at all)
  const int64_t cx0 = static_cast<int64_t>(fminf(fmaxf(x0, 0.0f), wm)) * sxw;
  const int64_t cx1 = static_cast<int64_t>(fminf(fmaxf(x1, 0.0f), wm)) * sxw;
  const int64_t cy0 = static_cast<int64_t>(fminf(fmaxf(y0, 0.0f), hm)) * sxh;
  const int64_t cy1 = static_cast<int64_t>(fminf(fmaxf(y1, 0.0f), hm)) * sxh;
  const int64_t o00 = cy0 + cx0, o01 = cy0 + cx1;
  const int64_t o10 = cy1 + cx0, o11 = cy1 + cx1;

  const T h00 = from_float<T>(w00), h01 = from_float<T>(w01);
  const T h10 = from_float<T>(w10), h11 = from_float<T>(w11);
  const T hb = from_float<T>(b), hty = from_float<T>(ty);

  const T* xp = x + n * sxb + c0 * sxc;
  T* op = out + (static_cast<int64_t>(n) * c + c0) * hw + p;
#pragma unroll 4
  for (int ch = c0; ch < c1; ++ch) {
    const T top = __hadd_rn(__hmul_rn(xp[o00], h00), __hmul_rn(xp[o01], h01));
    const T bot = __hadd_rn(__hmul_rn(xp[o10], h10), __hmul_rn(xp[o11], h11));
    *op = __hadd_rn(__hmul_rn(top, hb), __hmul_rn(bot, hty));
    xp += sxc;
    op += hw;
  }
}

template <typename T>
int launch(const void* x, const float* grid, void* out, int n, int c, int h,
           int w, int ho, int wo, int64_t sxb, int64_t sxc, int64_t sxh,
           int64_t sxw, int64_t sgn, int64_t sgh, int64_t sgw, int64_t sgk,
           void* stream) {
  const int hw = ho * wo;
  const dim3 blocks((hw + kThreads - 1) / kThreads, (c + kChunk - 1) / kChunk,
                    n);
  warp_bilinear_kernel<T><<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), grid, static_cast<T*>(out), c, h, w, ho, wo,
      sxb, sxc, sxh, sxw, sgn, sgh, sgw, sgk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Both entry points launch on `stream`, do not synchronise, allocate
// nothing and return cudaGetLastError() of the launch (0 = cudaSuccess).
// x (N or 1, c, h, w) in bf16 / fp16 at element strides sxb (0 for a
// batch-1 source), sxc, sxh, sxw; grid (n, ho, wo, 2) float32 at element
// strides sgn, sgh, sgw and sgk between its x and y; out (n, c, ho, wo)
// contiguous. The caller checks shapes: n, c, ho * wo >= 1, n <= 65,535,
// c <= 65,535 * kChunk.

int warp_bilinear_bf16(const void* x, const float* grid, void* out, int n,
                       int c, int h, int w, int ho, int wo, int64_t sxb,
                       int64_t sxc, int64_t sxh, int64_t sxw, int64_t sgn,
                       int64_t sgh, int64_t sgw, int64_t sgk, void* stream) {
  return launch<__nv_bfloat16>(x, grid, out, n, c, h, w, ho, wo, sxb, sxc,
                               sxh, sxw, sgn, sgh, sgw, sgk, stream);
}

int warp_bilinear_f16(const void* x, const float* grid, void* out, int n,
                      int c, int h, int w, int ho, int wo, int64_t sxb,
                      int64_t sxc, int64_t sxh, int64_t sxw, int64_t sgn,
                      int64_t sgh, int64_t sgw, int64_t sgk, void* stream) {
  return launch<__half>(x, grid, out, n, c, h, w, ho, wo, sxb, sxc, sxh, sxw,
                        sgn, sgh, sgw, sgk, stream);
}

}  // extern "C"
