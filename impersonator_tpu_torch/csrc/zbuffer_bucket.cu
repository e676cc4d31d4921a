// Bucket z-buffer kernels for Hopper (sm_90a): the rasterizer's
// face-index map with either barycentric weights (FLOW=false) or the
// liquid-warping correspondence flow T (FLOW=true).
//
// Replaces the Pallas TPU kernels zbuffer_bucket_rows and
// zbuffer_bucket_flow (impersonator_tpu/ops/pallas_raster.py:365, :413,
// shared body _make_bucket_kernel :196-360). Semantics are the same:
//
//   * faces arrive sorted by the tile holding the top-left corner of their
//     pixel bbox ("bucket"); starts[t] is the first sorted face of bucket t,
//     starts[T] the first oversized face (shared by every tile) and
//     starts[T+1] the end sentinel (culled faces lie past it);
//   * a tile's candidates are `span` row ranges of buckets (the tile's own
//     row and span-1 rows above, columns tx-(span-1)..tx) plus the
//     oversized range;
//   * per candidate: inside test at pixel centres xp=(2xi+1-S)/S, clipped
//     and renormalised barycentrics at integer pixel coordinates,
//     perspective-correct z, near/far reject, and a running (z, face id)
//     lexicographic minimum, so exact z ties go to the lowest face id;
//   * background: fim -1, weights 0, flow -2.
//
// Every float operation of the per-pixel test is written in the order of
// the Pallas body so that face ids match it bit for bit on shared-edge
// ties: build with --fmad=false and never with fast math (a contracted
// multiply-add or an approximate reciprocal moves the last ulp and flips
// those ties).
//
// What bounds it. Of the (pixel, candidate) pairs of a tile's ranges,
// about 0.3% have the pixel in the face's pixel bbox and 0.1% pass the
// inside test (the bench bodies at 256², tile 16, span 2). A kernel that
// tests every pair, as the first port of this body did, spends its time
// on shared-memory loads of faces that cannot touch the pixel. This
// design makes the per-pixel work follow the pairs that can pass:
//
//   * one CTA per (batch item, tile), one thread per pixel, the tile cut
//     into warps of 8x4 pixels (a 16-px tile: 2 x 4 warps). Batch items
//     vary fastest in the grid, so the costly tiles of every item (where
//     the mesh is dense) start early, not those of the last item last;
//   * each thread reads one candidate of a chunk and tests it against the
//     whole tile with the exact cull below. The survivors (about a
//     quarter on the bench bodies) are packed (__ballot_sync and a prefix
//     over the warps) into a staging buffer of one face per thread,
//     already reduced to the per-pixel constants. The buffer is walked
//     when the next chunk's survivors would not fit, and at the end;
//   * before a walk, one thread per staged face works out the face's 8-bit
//     warp mask with the same test on each warp's rectangle. Each warp then
//     reads the masks of 32 faces at a time, takes a __ballot_sync of its
//     own bit and walks only the faces set in it (__ffs): about 4% of the
//     (warp, face) pairs of the tile's ranges on the bench bodies;
//   * the per-face constants are laid out as structures of float4: the
//     inside test reads three 128-bit broadcasts (vertex xy, edge delta).
//     A lane queues the faces whose test it passes and later reads their
//     barycentric rows and 1/z (three more float4), the face id and the
//     flow's source xy, so a warp runs that longer path (two divisions)
//     once per hit of its busiest lane, not once per face any lane hits.
//
// What is left: the outputs (12 or 16 bytes per pixel, written once in the
// final (B,S,S[,C]) layout with the raster's vertical flip folded into the
// row index), the faces read once per tile that lists them (each batch
// item's sorted table, 0.46 MB at 12,880 faces, stays in L2), and the few
// tiles where the mesh is densest: they stage, mask and walk in rounds,
// one after the other inside one CTA, and set the kernel's length while
// most of the card has finished.
//
// Staging is not overlapped with the previous walk: most tiles stage once
// (a tile has 291 candidates on average, a quarter of them survive), and
// at four CTAs per SM the other CTAs' warps fill a CTA's barrier stalls;
// a second buffer would cost shared memory, and so occupancy, for the few
// tiles that stage more than once.
//
// The cull is exact: it drops a face from a tile or a warp only when no
// pixel centre there can pass the inside test AS THE FLOAT CODE COMPUTES
// IT, so the results are the same bits as without it. The argument
// (u = 2^-24, fl = one float32 rounding, no subnormals; the 2^-100 floors
// below cover rounding in the subnormal range):
//
//   (a) The per-pixel test for edge k, from vertex (fx, fy) with stored
//       deltas (a, b), computes t = fl(fl(fl(yp-fy)*a) - fl(fl(xp-fx)*b)).
//       Its exact counterpart T(xp, yp) = (yp-fy)*a - (xp-fx)*b is affine
//       in the pixel centre, and three roundings give
//       |t - T| <= 3.0001u (|yp-fy||a| + |xp-fx||b|) <= 3.0001u M, where
//       M = Ymax|a| + Xmax|b| over the tile's extreme pixel centres. M is
//       computed in float (relative error < 4u), and err = 32u*M + 2^-100.
//       A pixel that passes (t >= 0) has T >= -3.001u M.
//   (b) Edge test, for a rectangle of pixel centres inside the tile (the
//       tile itself, or a warp's). T's largest value over the rectangle is
//       at one of its four corner centres, and each corner's computed t is
//       within 3.001u M of T there. If the largest computed corner t is
//       below -err (< -6.01u M), T < -3.001u M at every pixel of the
//       rectangle, so none passes.
//   (c) Axis tests. A triangle can miss a rectangle while every edge's
//       half-plane meets it; then the rectangle's x or y axis separates
//       them. The vertices' bbox is no exact test of that: a face whose
//       three vertices coincide on a pixel centre has t = 0 everywhere and
//       passes outside it (the accepted bucket-vs-brute divergence of
//       ops/rasterizer.py), and a sliver can pass, after rounding, beyond
//       its bbox near an acute vertex. Instead, for edges k and j = k+1
//       whose deltas a_k, a_j are not of one strict sign, the weights
//       (l_k, l_j) = (|a_j|, |a_k|) make l_k T_k + l_j T_j free of yp,
//       exactly, so over the rectangle it is largest on the left or the
//       right corner column. A passing pixel has this sum >= -(l_k + l_j)-
//       weighted (a)-error, and the sum computed at a corner adds two
//       roundings of at most 2.001u (l_k M_k + l_j M_j). If it is below
//       -(l_k err_k + l_j err_j + 2^-100) at both columns (31.9u per unit
//       of l*M against the 8.01u needed), no pixel of the rectangle
//       passes.
//       The same with the b deltas bounds the rows. For a well-shaped
//       face the four sums give its bbox; for a sliver they widen as far
//       as rounding can carry a pass. A degenerate face (a = b = 0)
//       has every test at 0 against a slack above 0 and is never culled.
//   (d) A face with M or a delta of 2^40 or more (or NaN) keeps the tile
//       and every warp, so every value in (a)-(c) is finite.
//
// ops/cuda_raster.bucket_warp_masks_plain computes the same masks in the
// same float order; tests/test_torch_cull.py holds it to the inside test
// on bodies, random, fuzz and degenerate scenes.

#include <cuda_runtime.h>

// Three parts of the design can be switched off at build time (-D...=0),
// each leaving the results the same bits, so that each is timed against
// the kernel without it (ablate_bucket.py): the whole-tile cull before
// staging, the lanes' hit queues, and the grid with batch items fastest.
#ifndef ZB_TILE_CULL
#define ZB_TILE_CULL 1
#endif
#ifndef ZB_HIT_QUEUE
#define ZB_HIT_QUEUE 1
#endif
#ifndef ZB_ITEMS_FASTEST
#define ZB_ITEMS_FASTEST 1
#endif

namespace {

constexpr int kWarpW = 8, kWarpH = 4;   // a warp's pixels: 8 wide, 4 tall
constexpr int kQueue = 8;               // a thread's queued hits
constexpr float kCullRel = 0x1p-19f;    // 32u
constexpr float kCullAbs = 0x1p-100f;
constexpr float kCullMax = 0x1p40f;

__device__ __forceinline__ float clip01(float v) {
  // jnp.clip(v, 0, 1) = minimum(maximum(v, 0), 1): NaN propagates
  return v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
}

__device__ __forceinline__ float centre(int i, float sf) {
  return (2.0f * static_cast<float>(i) + 1.0f - sf) / sf;
}

__device__ __forceinline__ bool same_sign(float p, float q) {
  return (p > 0.0f && q > 0.0f) || (p < 0.0f && q < 0.0f);
}

// Is the weighted sum of edges k and j not below its slack at both
// corners (a, b)? (the axis test (c) above)
__device__ __forceinline__ bool pair_keeps(float lk, float lj, float ek,
                                           float ej, float tak, float taj,
                                           float tbk, float tbj) {
  const float bound = lk * ek + lj * ej + kCullAbs;
  const float va = lk * tak + lj * taj;
  const float vb = lk * tbk + lj * tbj;
  return !(fmaxf(va, vb) < -bound);
}

// The slack err of each edge over the tile ((a) above) from the tile's
// extreme pixel centres; false when the face is not cullable ((d) above).
__device__ __forceinline__ bool face_slack(const float fx[3],
                                           const float fy[3],
                                           const float ex[3],
                                           const float ey[3], float cx0,
                                           float cx1, float cy0, float cy1,
                                           float err[3]) {
  bool cullable = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float ymax = fmaxf(fabsf(cy0 - fy[k]), fabsf(cy1 - fy[k]));
    const float xmax = fmaxf(fabsf(cx0 - fx[k]), fabsf(cx1 - fx[k]));
    const float mag = ymax * fabsf(ex[k]) + xmax * fabsf(ey[k]);
    err[k] = mag * kCullRel + kCullAbs;
    cullable = cullable && mag < kCullMax && fabsf(ex[k]) < kCullMax &&
               fabsf(ey[k]) < kCullMax;
  }
  return cullable;
}

// Can the face pass its inside test at a pixel centre of the rectangle
// whose corner pixel centres are (xl | xh, yl | yh)? ((b) and (c) above)
// fx, fy: vertex xy; ex, ey: the edge deltas the per-pixel test reads.
__device__ __forceinline__ bool rect_keeps(const float fx[3],
                                           const float fy[3],
                                           const float ex[3],
                                           const float ey[3],
                                           const float err[3], float xl,
                                           float xh, float yl, float yh) {
  float tll[3], thl[3], tlh[3];
  bool keep = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float ayl = (yl - fy[k]) * ex[k], ayh = (yh - fy[k]) * ex[k];
    const float bxl = (xl - fx[k]) * ey[k], bxh = (xh - fx[k]) * ey[k];
    tll[k] = ayl - bxl;
    thl[k] = ayl - bxh;
    tlh[k] = ayh - bxl;
    const float thh = ayh - bxh;
    const float top = fmaxf(fmaxf(tll[k], thl[k]), fmaxf(tlh[k], thh));
    keep = keep && !(top < -err[k]);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int j = (k + 1) % 3;
    if (!same_sign(ex[k], ex[j]))     // no yp term: left vs right column
      keep = keep && pair_keeps(fabsf(ex[j]), fabsf(ex[k]), err[k], err[j],
                                tll[k], tll[j], thl[k], thl[j]);
    if (!same_sign(ey[k], ey[j]))     // no xp term: top vs bottom row
      keep = keep && pair_keeps(fabsf(ey[j]), fabsf(ey[k]), err[k], err[j],
                                tll[k], tll[j], tlh[k], tlh[j]);
  }
  return keep;
}

template <bool FLOW, int TILE>
__global__ void __launch_bounds__(256, 4) zbuffer_bucket_kernel(
    const float* __restrict__ verts,   // (B, nf, 9) sorted, vertex-major xyz
    const int* __restrict__ fid,       // (B, nf) original face ids
    const float* __restrict__ srcxy,   // (B, nf, 6) sorted source xy (FLOW)
    const int* __restrict__ starts,    // (B, T+2) bucket range starts
    int* __restrict__ fim,             // (B, S, S)
    float* __restrict__ out,           // (B, S, S, 3) weights | (B, S, S, 2) flow
    int nf, int s, int span, float near, float far) {
  constexpr int kCh = TILE * TILE;     // threads = most faces staged at once
  constexpr int kCols = TILE / kWarpW, kRows = TILE / kWarpH;
  constexpr int kWarps = kCols * kRows;
  // per staged face: edge k = (vertex k xy, delta to vertex k+1), hit k =
  // (barycentric row k times 1/denom, 1/z_k), source xy k, face id, and
  // the bits of the warps that walk it
  __shared__ float4 se[3 * kCh];
  __shared__ float4 sh[3 * kCh];
  __shared__ float2 ss[FLOW ? 3 * kCh : 1];
  __shared__ int sid[kCh];
  __shared__ unsigned char smask[kCh];
  __shared__ int swc[2][kWarps];       // survivors per warp, two rounds
  __shared__ unsigned char squeue[kQueue][kCh];   // each thread's hits
  // pixel centres of each warp column's first and last column and of each
  // warp row's first and last row: the tile's extremes are the first and
  // last entries
  __shared__ float scx[2 * kCols], scy[2 * kRows];

  const int g = s / TILE;
  // batch items vary fastest, so every item's costly tiles (where the mesh
  // is dense) are scheduled early, not those of the last item last
  const int b = ZB_ITEMS_FASTEST ? blockIdx.x : blockIdx.z;
  const int tx = ZB_ITEMS_FASTEST ? blockIdx.y : blockIdx.x;
  const int ty = ZB_ITEMS_FASTEST ? blockIdx.z : blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int xi_i = tx * TILE + (warp % kCols) * kWarpW + lane % kWarpW;
  const int yi_i = ty * TILE + (warp / kCols) * kWarpH + lane / kWarpW;
  const float sf = static_cast<float>(s);
  const float xi = static_cast<float>(xi_i);
  const float yi = static_cast<float>(yi_i);
  const float xp = centre(xi_i, sf);
  const float yp = centre(yi_i, sf);

  const float* vb = verts + static_cast<size_t>(b) * nf * 9;
  const int* fb = fid + static_cast<size_t>(b) * nf;
  const float* sb = FLOW ? srcxy + static_cast<size_t>(b) * nf * 6 : nullptr;
  const int* st = starts + static_cast<size_t>(b) * (g * g + 2);

  if (tid < 2 * kCols)
    scx[tid] = centre(tx * TILE + (tid >> 1) * kWarpW
                      + (tid & 1) * (kWarpW - 1), sf);
  if (tid < 2 * kRows)
    scy[tid] = centre(ty * TILE + (tid >> 1) * kWarpH
                      + (tid & 1) * (kWarpH - 1), sf);
  __syncthreads();
  const float cx0 = scx[0], cx1 = scx[2 * kCols - 1];
  const float cy0 = scy[0], cy1 = scy[2 * kRows - 1];

  const float bg = FLOW ? -2.0f : 0.0f;
  float best_z = far;
  int best_i = -1;
  float bw0 = bg, bw1 = bg, bw2 = 0.0f;

  // The staged faces' warp masks, then each warp's walk over its faces.
  int count = 0;                       // faces staged (uniform over the CTA)
  auto walk = [&]() {
    __syncthreads();                   // the staged faces are written
    if (tid < count) {
      float fx[3], fy[3], ex[3], ey[3], err[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float4 e = se[3 * tid + k];
        fx[k] = e.x;
        fy[k] = e.y;
        ex[k] = e.z;
        ey[k] = e.w;
      }
      unsigned mask = (1u << kWarps) - 1u;
      if (face_slack(fx, fy, ex, ey, cx0, cx1, cy0, cy1, err)) {
        mask = 0;
#pragma unroll 1
        for (int w = 0; w < kWarps; ++w) {
          const int c = w % kCols, r = w / kCols;
          if (rect_keeps(fx, fy, ex, ey, err, scx[2 * c], scx[2 * c + 1],
                         scy[2 * r], scy[2 * r + 1]))
            mask |= 1u << w;
        }
      }
      smask[tid] = static_cast<unsigned char>(mask);
    }
    __syncthreads();
    // A lane queues the faces whose inside test it passes and works out
    // their weights and depth later, so a warp runs that longer path once
    // per hit of its busiest lane, not once per face that any lane hits.
    auto hit = [&](const int f) {
      const float4 h0 = sh[3 * f], h1 = sh[3 * f + 1], h2 = sh[3 * f + 2];
      float w0 = clip01(h0.x * xi + h0.y * yi + h0.z);
      float w1 = clip01(h1.x * xi + h1.y * yi + h1.z);
      float w2 = clip01(h2.x * xi + h2.y * yi + h2.z);
      float wsum = w0 + w1 + w2;
      wsum = wsum == 0.0f ? 1.0f : wsum;
      const float rws = 1.0f / wsum;
      w0 = w0 * rws;
      w1 = w1 * rws;
      w2 = w2 * rws;
      const float inv_z = w0 * h0.w + w1 * h1.w + w2 * h2.w;
      const float zp = 1.0f / inv_z;
      if (!(zp > near && zp < far)) return;
      const int id = sid[f];
      if (zp < best_z || (zp == best_z && best_i >= 0 && id < best_i)) {
        best_z = zp;
        best_i = id;
        if (FLOW) {
          const float2 s0 = ss[3 * f], s1 = ss[3 * f + 1], s2 = ss[3 * f + 2];
          bw0 = w0 * s0.x + w1 * s1.x + w2 * s2.x;
          bw1 = w0 * s0.y + w1 * s1.y + w2 * s2.y;
        } else {
          bw0 = w0;
          bw1 = w1;
          bw2 = w2;
        }
      }
    };
    int queued = 0;
    for (int g0 = 0; g0 < count; g0 += 32) {
      const int j = g0 + lane;
      unsigned bits = __ballot_sync(
          0xffffffffu, j < count && ((smask[j] >> warp) & 1u));
      while (bits) {
        const int f = g0 + __ffs(bits) - 1;
        bits &= bits - 1u;
        const float4 e0 = se[3 * f], e1 = se[3 * f + 1], e2 = se[3 * f + 2];
        const float t0 = (yp - e0.y) * e0.z - (xp - e0.x) * e0.w;
        const float t1 = (yp - e1.y) * e1.z - (xp - e1.x) * e1.w;
        const float t2 = (yp - e2.y) * e2.z - (xp - e2.x) * e2.w;
        if (t0 >= 0.0f && t1 >= 0.0f && t2 >= 0.0f) {
          if (!ZB_HIT_QUEUE) {
            hit(f);
            continue;
          }
          squeue[queued++][tid] = static_cast<unsigned char>(f);
          if (queued == kQueue) {
            for (int q = 0; q < kQueue; ++q) hit(squeue[q][tid]);
            queued = 0;
          }
        }
      }
    }
    for (int q = 0; q < queued; ++q) hit(squeue[q][tid]);
    __syncthreads();                   // walked: the buffer may be restaged
    count = 0;
  };

  // Each thread reads one candidate of a chunk and tests it against the
  // whole tile; the survivors are packed into the staging buffer, which is
  // walked when the next chunk's survivors would not fit, and at the end.
  int round = 0;
  for (int dy = 0; dy <= span; ++dy) {
    int lo, hi;
    if (dy < span) {
      const int row = ty - dy;
      if (row < 0) continue;             // uniform over the CTA
      lo = row * g + max(tx - (span - 1), 0);
      hi = row * g + tx;
    } else {
      lo = g * g;                        // the shared oversized range
      hi = g * g;
    }
    const int r0 = st[lo];
    const int r1 = st[hi + 1];
    for (int c0 = r0; c0 < r1; c0 += kCh) {
      const int n = min(kCh, r1 - c0);
      float fx[3], fy[3], fz[3];
      bool keep = false;
      if (tid < n) {
        const float* d = vb + static_cast<size_t>(c0 + tid) * 9;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          fx[k] = d[3 * k];
          fy[k] = d[3 * k + 1];
          fz[k] = d[3 * k + 2];
        }
        const float ex[3] = {fx[1] - fx[0], fx[2] - fx[1], fx[0] - fx[2]};
        const float ey[3] = {fy[1] - fy[0], fy[2] - fy[1], fy[0] - fy[2]};
        float err[3];
        keep = !ZB_TILE_CULL ||
               !face_slack(fx, fy, ex, ey, cx0, cx1, cy0, cy1, err) ||
               rect_keeps(fx, fy, ex, ey, err, cx0, cx1, cy0, cy1);
      }
      const unsigned vote = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) swc[round][warp] = __popc(vote);
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int c = swc[round][w];
        before += w < warp ? c : 0;
        total += c;
      }
      round ^= 1;                        // the next chunk counts in the other
      if (count + total > kCh) walk();
      if (keep) {
        const int at = count + before + __popc(vote & ((1u << lane) - 1u));
        const float p0x = 0.5f * (fx[0] * sf + sf - 1.0f);
        const float p0y = 0.5f * (fy[0] * sf + sf - 1.0f);
        const float p1x = 0.5f * (fx[1] * sf + sf - 1.0f);
        const float p1y = 0.5f * (fy[1] * sf + sf - 1.0f);
        const float p2x = 0.5f * (fx[2] * sf + sf - 1.0f);
        const float p2y = 0.5f * (fy[2] * sf + sf - 1.0f);
        const float denom = p2x * (p0y - p1y) + p0x * (p1y - p2y)
                            + p1x * (p2y - p0y);
        const float rden = 1.0f / (denom == 0.0f ? 1.0f : denom);
        se[3 * at + 0] = make_float4(fx[0], fy[0], fx[1] - fx[0],
                                     fy[1] - fy[0]);
        se[3 * at + 1] = make_float4(fx[1], fy[1], fx[2] - fx[1],
                                     fy[2] - fy[1]);
        se[3 * at + 2] = make_float4(fx[2], fy[2], fx[0] - fx[2],
                                     fy[0] - fy[2]);
        sh[3 * at + 0] = make_float4((p1y - p2y) * rden, (p2x - p1x) * rden,
                                     (p1x * p2y - p2x * p1y) * rden,
                                     1.0f / fz[0]);
        sh[3 * at + 1] = make_float4((p2y - p0y) * rden, (p0x - p2x) * rden,
                                     (p2x * p0y - p0x * p2y) * rden,
                                     1.0f / fz[1]);
        sh[3 * at + 2] = make_float4((p0y - p1y) * rden, (p1x - p0x) * rden,
                                     (p0x * p1y - p1x * p0y) * rden,
                                     1.0f / fz[2]);
        sid[at] = fb[c0 + tid];
        if (FLOW) {
          const float* e = sb + static_cast<size_t>(c0 + tid) * 6;
#pragma unroll
          for (int k = 0; k < 3; ++k)
            ss[3 * at + k] = make_float2(e[2 * k], e[2 * k + 1]);
        }
      }
      count += total;
    }
  }
  if (count > 0) walk();

  // raster rows run bottom-up: write row s-1-yi (the vertical flip)
  const size_t o = (static_cast<size_t>(b) * s + (s - 1 - yi_i)) * s + xi_i;
  fim[o] = best_i;
  if (FLOW) {
    out[o * 2 + 0] = bw0;
    out[o * 2 + 1] = bw1;
  } else {
    out[o * 3 + 0] = bw0;
    out[o * 3 + 1] = bw1;
    out[o * 3 + 2] = bw2;
  }
}

template <bool FLOW, int TILE>
int launch_tile(const float* verts, const int* fid, const float* srcxy,
                const int* starts, int* fim, float* out, int b, int nf, int s,
                int span, float near, float far, void* stream) {
  const int g = s / TILE;
  const dim3 grid = ZB_ITEMS_FASTEST ? dim3(b, g, g) : dim3(g, g, b);
  zbuffer_bucket_kernel<FLOW, TILE><<<grid, TILE * TILE, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      verts, fid, srcxy, starts, fim, out, nf, s, span, near, far);
  return static_cast<int>(cudaGetLastError());
}

template <bool FLOW>
int launch(const float* verts, const int* fid, const float* srcxy,
           const int* starts, int* fim, float* out, int b, int nf, int s,
           int tile, int span, float near, float far, void* stream) {
  if (tile == 16)
    return launch_tile<FLOW, 16>(verts, fid, srcxy, starts, fim, out, b, nf,
                                 s, span, near, far, stream);
  if (tile == 8)
    return launch_tile<FLOW, 8>(verts, fid, srcxy, starts, fim, out, b, nf,
                                s, span, near, far, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Both entry points launch on `stream`, do not synchronise, allocate
// nothing and return cudaGetLastError() of the launch (0 = cudaSuccess).
// The caller checks shapes: s % tile == 0, tile 8 or 16 (the staged
// chunk then fits the default 48 KB of static shared memory).

int zbuffer_bucket_rows(const float* verts, const int* fid,
                        const int* starts, int* fim, float* wim, int b,
                        int nf, int s, int tile, int span, float near,
                        float far, void* stream) {
  return launch<false>(verts, fid, nullptr, starts, fim, wim, b, nf, s, tile,
                       span, near, far, stream);
}

int zbuffer_bucket_flow(const float* verts, const int* fid,
                        const float* srcxy, const int* starts, int* fim,
                        float* flow, int b, int nf, int s, int tile, int span,
                        float near, float far, void* stream) {
  return launch<true>(verts, fid, srcxy, starts, fim, flow, b, nf, s, tile,
                      span, near, far, stream);
}

}  // extern "C"
