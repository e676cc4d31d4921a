// Fixed-slot tiled z-buffer kernel for Hopper (sm_90a): the rasterizer's
// face-index map (fim) and barycentric weights (wim) over a dense
// per-tile candidate-slot array.
//
// Replaces the Pallas TPU kernel zbuffer_tiles
// (impersonator_tpu/ops/pallas_raster.py:146, body _make_kernel :47-141).
// Semantics are the same:
//
//   * every tile t of the tile x tile grid owns `slots` candidate slots:
//     cand[b, t, k] is a face id, valid[b, t, k] != 0 marks a live slot
//     (the wrapper ops.rasterizer.rasterize_fim_wim_tiled builds them:
//     the oversized faces first, then the tile's own faces by ascending
//     id, then padding);
//   * per (pixel, live slot): inside test at the pixel centre
//     xp=(2xi+1-S)/S, clipped barycentrics at integer pixel coordinates
//     renormalised by a DIVISION by their sum, perspective depth
//     inv_z = w0/z0 + w1/z1 + w2/z2 (divisions, as the Pallas body writes
//     them) and zp = 1/inv_z, then the near/far reject;
//   * the winner is the lexicographic (z, slot) minimum: slots are walked
//     in order with a strict <, which is the Pallas kernel's "lowest lane
//     within a chunk, earliest chunk across chunks" rule. Ties go to the
//     lower SLOT, not the lower face id: the oversized faces sit first;
//   * background: fim -1, weights 0.
//
// Every float operation follows the Pallas body's order so that face ids
// match bit for bit on shared-edge ties: build with --fmad=false and never
// with fast math (zbuffer_bucket.cu says why).
//
// Design. The Pallas pipeline gathered each slot's nine vertex floats into
// a (B, T, 9, slots) array before the kernel (226 MB at batch 16, 256²);
// here the kernel reads the (B, nf, 9) face table itself. A CTA has 256
// threads, one per pixel: with 8-px tiles it covers four tiles, with
// 16-px tiles one, and larger tiles are split over several CTAs. The CTA
// first finds each of its tiles' last live slot, then walks the slots in
// chunks: each thread stages one slot of one tile into shared memory,
// already reduced to the constants every pixel needs (vertex xy, edge
// deltas, barycentric rows times 1/denom, vertex depths) plus its face id
// (-1 for a dead slot), so the per-pixel loop reads shared-memory
// broadcasts. Slots past
// a tile's last live slot are never staged: the live slots form two short
// runs (the oversized faces, then the tile's faces) at the front of a
// mostly empty array.
//
// What bounds it. Each live (pixel, slot) pair costs ~38 float operations;
// a 256² body at batch 16 has a few times 10^8 of them at most. The bytes
// that must move are the face table, the cand/valid arrays (8 bytes per
// slot, 40 MB at batch 16 with 304 slots and 1024 tiles) and the outputs
// (16 bytes per pixel). Both bounds are tens of microseconds; what the
// kernel spends beyond them goes to the serial per-slot loop and the
// staging barriers.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads per CTA, one pixel each
constexpr int kGeom = 24;      // 6 vertex xy, 6 edge deltas, 9 bary rows, 3 z

__device__ __forceinline__ float clip01(float v) {
  // jnp.clip(v, 0, 1) = minimum(maximum(v, 0), 1): NaN propagates
  return v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
}

__global__ void zbuffer_tiles_kernel(
    const float* __restrict__ packed,  // (B, nf, 9) face verts, xyz per vertex
    const int* __restrict__ cand,      // (B, T, slots) face id of each slot
    const int* __restrict__ valid,     // (B, T, slots) slot is live
    int* __restrict__ fim,             // (B, S, S)
    float* __restrict__ wim,           // (B, S, S, 3)
    int nf, int s, int tile, int slots, int tpc, int gpt, float near,
    float far) {
  __shared__ float sg[kGeom * kThreads];
  __shared__ int sid[kThreads];   // face id of a live staged slot, else -1
  __shared__ int send[kThreads];   // last live slot + 1, per tile of the CTA

  const int g = s / tile;
  const int n_tiles = g * g;
  const int tpx = tile * tile;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tile0 = (blockIdx.x / gpt) * tpc;
  const int grp = blockIdx.x % gpt;
  const int ch = kThreads / tpc;     // slots per tile per staged chunk

  // this thread's pixel
  const int lt = tpc > 1 ? tid / tpx : 0;
  const int p = tpc > 1 ? tid % tpx : grp * kThreads + tid;
  const int t = tile0 + lt;
  const bool active = t < n_tiles && p < tpx;
  const int ty = t / g, tx = t % g;
  const int xi_i = tx * tile + p % tile;
  const int yi_i = ty * tile + p / tile;
  const float sf = static_cast<float>(s);
  const float xi = static_cast<float>(xi_i);
  const float yi = static_cast<float>(yi_i);
  const float xp = (2.0f * xi + 1.0f - sf) / sf;
  const float yp = (2.0f * yi + 1.0f - sf) / sf;

  // this thread's staging role: slot j of local tile ls
  const int ls = tid / ch;
  const int js = tid % ch;
  const int ts = tile0 + ls;
  const size_t row = (static_cast<size_t>(b) * n_tiles + ts) * slots;

  // end of each tile's live slots
  if (tid < tpc) send[tid] = 0;
  __syncthreads();
  if (ts < n_tiles) {
    int last = 0;
    for (int k = js; k < slots; k += ch)
      if (valid[row + k] != 0) last = k + 1;
    if (last > 0) atomicMax(&send[ls], last);
  }
  __syncthreads();
  int loop_end = 0;
  for (int i = 0; i < tpc; ++i) loop_end = max(loop_end, send[i]);
  const int my_end = active ? send[lt] : 0;
  const int stage_end = ts < n_tiles ? send[ls] : 0;

  const float* pb = packed + static_cast<size_t>(b) * nf * 9;
  float best_z = far;
  int best_i = -1;
  float bw0 = 0.0f, bw1 = 0.0f, bw2 = 0.0f;

  for (int c0 = 0; c0 < loop_end; c0 += ch) {
    __syncthreads();                   // previous chunk fully consumed
    const int k = c0 + js;
    int id = -1;
    if (k < stage_end && valid[row + k] != 0) {
      const int f = cand[row + k];
      if (f >= 0 && f < nf) {
        id = f;
        const float* d = pb + static_cast<size_t>(f) * 9;
        const float fx0 = d[0], fy0 = d[1], fz0 = d[2];
        const float fx1 = d[3], fy1 = d[4], fz1 = d[5];
        const float fx2 = d[6], fy2 = d[7], fz2 = d[8];
        const float p0x = 0.5f * (fx0 * sf + sf - 1.0f);
        const float p0y = 0.5f * (fy0 * sf + sf - 1.0f);
        const float p1x = 0.5f * (fx1 * sf + sf - 1.0f);
        const float p1y = 0.5f * (fy1 * sf + sf - 1.0f);
        const float p2x = 0.5f * (fx2 * sf + sf - 1.0f);
        const float p2y = 0.5f * (fy2 * sf + sf - 1.0f);
        const float denom = p2x * (p0y - p1y) + p0x * (p1y - p2y)
                            + p1x * (p2y - p0y);
        const float rden = 1.0f / (denom == 0.0f ? 1.0f : denom);
        float* q = sg + tid;
        q[0 * kThreads] = fx0;  q[1 * kThreads] = fy0;
        q[2 * kThreads] = fx1;  q[3 * kThreads] = fy1;
        q[4 * kThreads] = fx2;  q[5 * kThreads] = fy2;
        q[6 * kThreads] = fx1 - fx0;  q[7 * kThreads] = fy1 - fy0;
        q[8 * kThreads] = fx2 - fx1;  q[9 * kThreads] = fy2 - fy1;
        q[10 * kThreads] = fx0 - fx2; q[11 * kThreads] = fy0 - fy2;
        q[12 * kThreads] = (p1y - p2y) * rden;
        q[13 * kThreads] = (p2x - p1x) * rden;
        q[14 * kThreads] = (p1x * p2y - p2x * p1y) * rden;
        q[15 * kThreads] = (p2y - p0y) * rden;
        q[16 * kThreads] = (p0x - p2x) * rden;
        q[17 * kThreads] = (p2x * p0y - p0x * p2y) * rden;
        q[18 * kThreads] = (p0y - p1y) * rden;
        q[19 * kThreads] = (p1x - p0x) * rden;
        q[20 * kThreads] = (p0x * p1y - p1x * p0y) * rden;
        q[21 * kThreads] = fz0;
        q[22 * kThreads] = fz1;
        q[23 * kThreads] = fz2;
      }
    }
    sid[tid] = id;
    __syncthreads();
    const int n = min(ch, my_end - c0);
    const int base = lt * ch;
    for (int j = 0; j < n; ++j) {
      const int id = sid[base + j];
      if (id < 0) continue;
      const float* q = sg + base + j;
      const float t0 = (yp - q[1 * kThreads]) * q[6 * kThreads]
                       - (xp - q[0 * kThreads]) * q[7 * kThreads];
      const float t1 = (yp - q[3 * kThreads]) * q[8 * kThreads]
                       - (xp - q[2 * kThreads]) * q[9 * kThreads];
      const float t2 = (yp - q[5 * kThreads]) * q[10 * kThreads]
                       - (xp - q[4 * kThreads]) * q[11 * kThreads];
      if (!(t0 >= 0.0f && t1 >= 0.0f && t2 >= 0.0f)) continue;
      float w0 = clip01(q[12 * kThreads] * xi + q[13 * kThreads] * yi
                        + q[14 * kThreads]);
      float w1 = clip01(q[15 * kThreads] * xi + q[16 * kThreads] * yi
                        + q[17 * kThreads]);
      float w2 = clip01(q[18 * kThreads] * xi + q[19 * kThreads] * yi
                        + q[20 * kThreads]);
      float wsum = w0 + w1 + w2;
      wsum = wsum == 0.0f ? 1.0f : wsum;
      w0 = w0 / wsum;
      w1 = w1 / wsum;
      w2 = w2 / wsum;
      const float inv_z = w0 / q[21 * kThreads] + w1 / q[22 * kThreads]
                          + w2 / q[23 * kThreads];
      const float zp = 1.0f / inv_z;
      if (!(zp > near && zp < far)) continue;
      if (zp < best_z) {               // strict: the earlier slot keeps ties
        best_z = zp;
        best_i = id;
        bw0 = w0;
        bw1 = w1;
        bw2 = w2;
      }
    }
  }

  if (!active) return;
  // raster rows run bottom-up: write row s-1-yi (the vertical flip)
  const size_t o = (static_cast<size_t>(b) * s + (s - 1 - yi_i)) * s + xi_i;
  fim[o] = best_i;
  wim[o * 3 + 0] = bw0;
  wim[o * 3 + 1] = bw1;
  wim[o * 3 + 2] = bw2;
}

}  // namespace

extern "C" {

// Launches on `stream`, does not synchronise, allocates nothing and
// returns cudaGetLastError() of the launch (0 = cudaSuccess). The caller
// checks shapes: s % tile == 0, cand/valid (B, (s/tile)^2, slots).

int zbuffer_tiles(const float* packed, const int* cand, const int* valid,
                  int* fim, float* wim, int b, int nf, int s, int tile,
                  int slots, float near, float far, void* stream) {
  const int g = s / tile;
  const int n_tiles = g * g;
  const int tpx = tile * tile;
  const int tpc = (tpx <= kThreads && kThreads % tpx == 0) ? kThreads / tpx
                                                           : 1;
  const int gpt = tpc > 1 ? 1 : (tpx + kThreads - 1) / kThreads;
  dim3 grid(((n_tiles + tpc - 1) / tpc) * gpt, b);
  zbuffer_tiles_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      packed, cand, valid, fim, wim, nf, s, tile, slots, tpc, gpt, near,
      far);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
