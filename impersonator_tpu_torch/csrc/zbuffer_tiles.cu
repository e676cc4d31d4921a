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
//     id, then padding; the kernel takes any pattern of live slots);
//   * per (pixel, live slot): inside test at the pixel centre
//     xp=(2xi+1-S)/S, clipped barycentrics at integer pixel coordinates
//     renormalised by a DIVISION by their sum, perspective depth
//     inv_z = w0/z0 + w1/z1 + w2/z2 (divisions, as the Pallas body writes
//     them) and zp = 1/inv_z, then the near/far reject;
//   * the winner is the lexicographic (z, slot) minimum: ties go to the
//     lower SLOT, not the lower face id (the oversized faces sit first);
//   * background: fim -1, weights 0.
//
// Every float operation follows the Pallas body's order so that face ids
// match bit for bit on shared-edge ties: build with --fmad=false and never
// with fast math (zbuffer_bucket.cu says why).
//
// What bounds it. The bytes: `valid` read once (4 bytes a slot, 19.9 MB
// at batch 16, 256², tile 8, 304 slots), cand and the face rows only
// where a slot is live (about a fifth of the face table's rows are named
// at all), fim and the weights written once (16 bytes a pixel): 45 MB,
// 0.0135 ms. Most of a tile's 304 slots are dead and 86% of the tiles on
// the 63,480-face bodies have no live slot at all, so what costs is
// structure: CTAs that find nothing, chains of dependent loads, and the
// few dense tiles (median 84, p90 205, max 288 live slots) that set the
// kernel's length. The design:
//
//   * A CTA of 8 warps scans a group of 8 consecutive tiles of one batch
//     item, one warp a tile (batch items vary fastest in the grid, so the
//     dense tiles of every item start early). Each warp reads its tile's
//     valid words once, coalesced, and turns them with __ballot_sync and a
//     prefix over 32-slot chunks into the list of live slots in slot
//     order, reading each live slot's face id while the CTA's one barrier
//     waits. An empty tile writes background there and is done; a group
//     with no live slot ends after that barrier. One CTA a tile would
//     launch 16,384 CTAs of which 86% find nothing.
//   * Teams. A team is one warp for an 8x8 tile (two pixels a thread,
//     rows r and r+4, so every staged face is read once for two pixels).
//     Every tile with live slots gets a team, and the group's spare teams
//     go, one by one, to the tile whose share would stay longest, while a
//     share keeps kMinShare = 16 entries: a group of the bodies holds one
//     or two live tiles, so a dense tile is walked by 4-8 warps, each a
//     contiguous share of its list. Teams run on their own: a team
//     synchronises only its own warps, and a split tile's teams only
//     each other, on a named barrier.
//   * A team stages its share a chunk of 32 entries at a time, one entry
//     a lane (one dependent load: the face's nine floats), reduced to the
//     constants the per-pixel test reads as float4 broadcasts: vertex xy
//     and edge deltas; barycentric rows times 1/denom and the vertex
//     depths. A dead entry stages an edge of NaNs, which fails every
//     inside test, so the walk needs no branch on it.
//   * A lane queues the hits of its two pixels (entry, pixel) and runs
//     the weights-and-depth path (six divisions) for them afterwards, so a
//     warp pays it once per hit of its busiest lane, not once per entry
//     that any lane hits: a tile's hits are spread over many faces, rarely
//     two lanes on one.
//   * Merge. Each team keeps a running (z, list position) minimum with a
//     strict < over its share in list order, which is slot order, so it
//     holds the first slot reaching its least z. A split tile's teams are
//     merged by (z, position): the least z, and among equal z the lower
//     slot. That is the serial walk's winner bit for bit, equal z across a
//     share boundary included.
//
// Slots beyond kList (a cap above 304) follow the list as further entries,
// each checked against valid when it is staged; the renderer's caps at
// 256² need none. Larger tiles take teams of up to 8 warps (and a tile of
// more than 512 pixels several CTAs).
//
// ops/cuda_raster.zbuffer_tiles_split_plain mirrors the split and merge;
// tests/test_torch_tiles_split.py holds it to the serial twin.

#include <climits>
#include <cuda_runtime.h>

// Each part of the design above (the group of tiles a CTA, the compacted
// list, the split of dense tiles, the hit queue, batch items fastest in
// the grid) beat the kernel without it by 1.1-2.8x on an H100, with the
// same bits.

namespace {

constexpr int kThreads = 256;      // threads of a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kList = 320;         // slots of `valid` a tile lists at once
constexpr int kChunks = kList / 32;
constexpr int kMinShare = 16;      // fewest list entries a team walks
constexpr int kQueue = 8;          // hits a thread queues

__device__ __forceinline__ float clip01(float v) {
  // jnp.clip(v, 0, 1) = minimum(maximum(v, 0), 1): NaN propagates
  return v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
}

// Synchronise `count` threads on named barrier `id` (1..15).
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// One pixel's running (z, slot) minimum; `at` is the slot's place in the
// tile's list, which orders the slots as their indices do.
struct Best {
  float z;
  int at, id;
  float w0, w1, w2;
};

__global__ void __launch_bounds__(kThreads, 4) zbuffer_tiles_kernel(
    const float* __restrict__ packed,  // (B, nf, 9) face verts, xyz per vertex
    const int* __restrict__ cand,      // (B, T, slots) face id of each slot
    const int* __restrict__ valid,     // (B, T, slots) slot is live
    int* __restrict__ fim,             // (B, S, S)
    float* __restrict__ wim,           // (B, S, S, 3)
    int nb, int nf, int s, int tile, int slots, int np, int gpt, int tw,
    int group, float near, float far) {
  // staged slots, one per thread: thread k's team stages into entries of
  // its own warps; after a team's walk its entries hold its minima
  __shared__ float4 se[3 * kThreads];  // edge k: vertex k xy, delta to k+1
  __shared__ float4 sh[3 * kThreads];  // row k: bary row k / denom, z_k
  __shared__ int2 sis[kThreads];       // face id (-1: none), list position
  __shared__ int slist[kWarps][kList]; // face ids of each tile's live slots
  __shared__ int scnt[kWarps][kChunks];  // its live slots per 32-slot chunk
  __shared__ int sn[kWarps];           // its list length
  __shared__ unsigned short squeue[kQueue][kThreads];  // queued hits

  const int g = s / tile;
  const int n_tiles = g * g;
  const int tpx = tile * tile;
  const int b = blockIdx.x % nb;
  const int cta = blockIdx.x / nb;
  const int gi = cta / gpt, grp = cta % gpt;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int team_threads = 32 * tw;
  const float sf = static_cast<float>(s);
  const float* pb = packed + static_cast<size_t>(b) * nf * 9;
  const size_t item_row = static_cast<size_t>(b) * n_tiles * slots;
  // tile w of the group, -1 past the grid
  auto tile_of = [&](const int w) {
    const int tt = gi * group + w;
    return tt < n_tiles ? tt : -1;
  };
  // pixel index of the tile -> output offset; raster rows run bottom-up:
  // row s-1-yi (the vertical flip)
  auto out_of = [&](const int t, const int p) {
    const int xi = (t % g) * tile + p % tile;
    const int yi = (t / g) * tile + p / tile;
    return (static_cast<size_t>(b) * s + (s - 1 - yi)) * s + xi;
  };

  // -- 1. one coalesced pass over each tile's first kList valid words,
  // --    spt warps a tile: the tiles' lists of live slots, in slot order,
  // --    each with its face id (read here, while the barrier waits)
  const int spt = kWarps / group;
  const int ws = warp / spt, sub = warp % spt;
  const int t_s = tile_of(ws);
  const int width0 = min(kList, slots);
  unsigned live = 0;                    // bit i: chunk sub + i*spt
  int fids[kChunks];
  if (t_s >= 0) {
    const size_t row_s = item_row + static_cast<size_t>(t_s) * slots;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int j = (sub + i * spt) * 32 + lane;
      if (j < width0 && valid[row_s + j] != 0) live |= 1u << i;
    }
#pragma unroll
    for (int i = 0; i < kChunks; ++i)
      fids[i] = (live >> i) & 1u
                    ? cand[row_s + (sub + i * spt) * 32 + lane]
                    : -1;
  }
  unsigned vote[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    vote[i] = __ballot_sync(0xffffffffu, (live >> i) & 1u);
    const int c = sub + i * spt;
    if (lane == 0 && c < kChunks) scnt[ws][c] = __popc(vote[i]);
  }
  __syncthreads();
  int n_s = 0;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) n_s += scnt[ws][c];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    if (!((live >> i) & 1u)) continue;
    const int c = sub + i * spt;
    int at = __popc(vote[i] & ((1u << lane) - 1u));
    for (int q = 0; q < c; ++q) at += scnt[ws][q];
    slist[ws][at] = fids[i] >= 0 && fids[i] < nf ? fids[i] : -1;
  }
  // list length: the live slots of the first kList, then every later slot
  const int rest = slots > kList ? slots - kList : 0;
  const int len_s = t_s < 0 ? 0 : n_s + rest;
  if (sub == 0 && lane == 0) sn[ws] = len_s;
  if (t_s >= 0 && len_s == 0) {         // an empty tile: background
    for (int p = sub * 32 + lane; p < np; p += spt * 32) {
      if (grp * np + p >= tpx) break;
      const size_t o = out_of(t_s, grp * np + p);
      fim[o] = -1;
      wim[o * 3 + 0] = 0.0f;
      wim[o * 3 + 1] = 0.0f;
      wim[o * 3 + 2] = 0.0f;
    }
  }
  __syncthreads();

  // -- 2. teams: a team of tw warps walks one contiguous share of one
  // --    tile's list; every live tile has a team, and the spare teams go
  // --    to the tiles with the longest shares
  int n[kWarps], q[kWarps];
  int used = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    n[w] = w < group ? sn[w] : 0;
    q[w] = n[w] > 0 ? 1 : 0;
    used += q[w];
  }
  if (used == 0) return;                // uniform: the group is empty
  const int teams = kWarps / tw;
  for (; used < teams; ++used) {
    int pick = -1, pn = 0, pq = 1;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const bool ok = q[w] > 0 && n[w] >= kMinShare * (q[w] + 1);
      if (ok && (pick < 0 || n[w] * (pq + 1) > pn * (q[w] + 1))) {
        pick = w;
        pn = n[w];
        pq = q[w];
      }
    }
    if (pick < 0) break;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) q[w] += w == pick ? 1 : 0;
  }
  const int tm = warp / tw;             // this thread's team
  int mt = -1, share = 0, shares = 1, len = 0, lead = 0;
  {
    int c = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (mt < 0 && tm >= c && tm < c + q[w]) {
        mt = w;
        share = tm - c;
        shares = q[w];
        len = n[w];
        lead = c;
      }
      c += q[w];
    }
  }
  if (mt < 0) return;                   // a spare team with no share
  const int t = tile_of(mt);
  const size_t row = item_row + static_cast<size_t>(t) * slots;
  int n0 = 0;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) n0 += scnt[mt][c];
  const int k = tid - tm * team_threads;   // thread within the team
  auto team_sync = [&]() {
    if (tw == 1)
      __syncwarp();
    else
      bar_sync(9 + tm, team_threads);
  };

  // this thread's two pixels of the tile
  float xi[2], yi[2], xp[2], yp[2];
  bool own[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = grp * np + k + h * team_threads;
    own[h] = k + h * team_threads < np && p < tpx;
    xi[h] = static_cast<float>((t % g) * tile + p % tile);
    yi[h] = static_cast<float>((t / g) * tile + p / tile);
    xp[h] = (2.0f * xi[h] + 1.0f - sf) / sf;
    yp[h] = (2.0f * yi[h] + 1.0f - sf) / sf;
  }
  Best best[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) best[h] = {far, INT_MAX, -1, 0.0f, 0.0f, 0.0f};

  // A lane queues the (entry, pixel) pairs whose inside test passes and
  // works out their weights and depth later, so a warp runs that longer
  // path (six divisions) once per hit of its busiest lane, not once per
  // entry that any lane hits. Each pixel's hits stay in slot order.
  auto hit = [&](const int ej, const int h) {
    const float4 h0 = sh[3 * ej], h1 = sh[3 * ej + 1], h2 = sh[3 * ej + 2];
    const float x = h ? xi[1] : xi[0], y = h ? yi[1] : yi[0];
    float w0 = clip01(h0.x * x + h0.y * y + h0.z);
    float w1 = clip01(h1.x * x + h1.y * y + h1.z);
    float w2 = clip01(h2.x * x + h2.y * y + h2.z);
    float wsum = w0 + w1 + w2;
    wsum = wsum == 0.0f ? 1.0f : wsum;
    w0 = w0 / wsum;
    w1 = w1 / wsum;
    w2 = w2 / wsum;
    const float inv_z = w0 / h0.w + w1 / h1.w + w2 / h2.w;
    const float zp = 1.0f / inv_z;
    if (!(zp > near && zp < far)) return;
    if (zp < (h ? best[1].z : best[0].z)) {  // strict: earlier slot keeps ties
      const int2 is = sis[ej];
      const Best nb = {zp, is.y, is.x, w0, w1, w2};
      if (h)
        best[1] = nb;
      else
        best[0] = nb;
    }
  };

  // -- 3. the share, a chunk of team_threads entries at a time: stage
  // --    (one entry a thread), then walk it for both pixels
  const int pos0 = share * len / shares, pos1 = (share + 1) * len / shares;
  const int e0 = tm * team_threads;     // the team's staging entries
  // face id of list entry pos (-1 for none): window 0's from the list,
  // a later slot's read here
  auto face_at = [&](const int pos) {
    if (pos < n0) return slist[mt][pos];
    const int slot = kList + (pos - n0);
    if (valid[row + slot] == 0) return -1;
    const int f = cand[row + slot];
    return f >= 0 && f < nf ? f : -1;
  };
  for (int c0 = pos0; c0 < pos1; c0 += team_threads) {
    const int pos = c0 + k;
    const int f = pos < pos1 ? face_at(pos) : -1;
    float d[9];
    if (f >= 0) {
      const float* r = pb + static_cast<size_t>(f) * 9;
#pragma unroll
      for (int i = 0; i < 9; ++i) d[i] = r[i];
    }
    const int e = e0 + k;
    if (f >= 0) {
      const float p0x = 0.5f * (d[0] * sf + sf - 1.0f);
      const float p0y = 0.5f * (d[1] * sf + sf - 1.0f);
      const float p1x = 0.5f * (d[3] * sf + sf - 1.0f);
      const float p1y = 0.5f * (d[4] * sf + sf - 1.0f);
      const float p2x = 0.5f * (d[6] * sf + sf - 1.0f);
      const float p2y = 0.5f * (d[7] * sf + sf - 1.0f);
      const float denom = p2x * (p0y - p1y) + p0x * (p1y - p2y)
                          + p1x * (p2y - p0y);
      const float rden = 1.0f / (denom == 0.0f ? 1.0f : denom);
      se[3 * e + 0] = make_float4(d[0], d[1], d[3] - d[0], d[4] - d[1]);
      se[3 * e + 1] = make_float4(d[3], d[4], d[6] - d[3], d[7] - d[4]);
      se[3 * e + 2] = make_float4(d[6], d[7], d[0] - d[6], d[1] - d[7]);
      sh[3 * e + 0] = make_float4((p1y - p2y) * rden, (p2x - p1x) * rden,
                                  (p1x * p2y - p2x * p1y) * rden, d[2]);
      sh[3 * e + 1] = make_float4((p2y - p0y) * rden, (p0x - p2x) * rden,
                                  (p2x * p0y - p0x * p2y) * rden, d[5]);
      sh[3 * e + 2] = make_float4((p0y - p1y) * rden, (p1x - p0x) * rden,
                                  (p0x * p1y - p1x * p0y) * rden, d[8]);
      sis[e] = make_int2(f, pos);
    } else {
      // no face: an edge of NaNs fails every inside test
      se[3 * e] = make_float4(__int_as_float(0x7fc00000), 0.0f, 0.0f, 0.0f);
    }
    team_sync();
    const int m = min(team_threads, pos1 - c0);
    int queued = 0;
    for (int j = 0; j < m; ++j) {
      const int ej = e0 + j;
      const float4 a0 = se[3 * ej], a1 = se[3 * ej + 1], a2 = se[3 * ej + 2];
      bool in[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float t0 = (yp[h] - a0.y) * a0.z - (xp[h] - a0.x) * a0.w;
        const float t1 = (yp[h] - a1.y) * a1.z - (xp[h] - a1.x) * a1.w;
        const float t2 = (yp[h] - a2.y) * a2.z - (xp[h] - a2.x) * a2.w;
        in[h] = own[h] && t0 >= 0.0f && t1 >= 0.0f && t2 >= 0.0f;
      }
      if (!(in[0] || in[1])) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!in[h]) continue;
        squeue[queued++][tid] = static_cast<unsigned short>(j << 1 | h);
        if (queued == kQueue) {
          for (int i = 0; i < kQueue; ++i) {
            const unsigned v = squeue[i][tid];
            hit(e0 + (v >> 1), v & 1u);
          }
          queued = 0;
        }
      }
    }
    for (int i = 0; i < queued; ++i) {
      const unsigned v = squeue[i][tid];
      hit(e0 + (v >> 1), v & 1u);
    }
    team_sync();                        // walked: the entries may be restaged
  }

  // -- 4. merge a split tile's shares by (z, slot): each team leaves its
  // --    minima in its own entries, the lead team reads them in order
  if (shares > 1) {
    float* mine = reinterpret_cast<float*>(&se[3 * (e0 + k)]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mine[6 * h + 0] = best[h].z;
      mine[6 * h + 1] = __int_as_float(best[h].at);
      mine[6 * h + 2] = __int_as_float(best[h].id);
      mine[6 * h + 3] = best[h].w0;
      mine[6 * h + 4] = best[h].w1;
      mine[6 * h + 5] = best[h].w2;
    }
    bar_sync(1 + mt, shares * team_threads);
    if (share != 0) return;
    for (int r = 1; r < shares; ++r) {
      const float* other = reinterpret_cast<const float*>(
          &se[3 * ((lead + r) * team_threads + k)]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float z = other[6 * h];
        const int sl = __float_as_int(other[6 * h + 1]);
        if (z < best[h].z || (z == best[h].z && sl < best[h].at))
          best[h] = {z, sl, __float_as_int(other[6 * h + 2]),
                     other[6 * h + 3], other[6 * h + 4], other[6 * h + 5]};
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!own[h]) continue;
    const size_t o = out_of(t, grp * np + k + h * team_threads);
    fim[o] = best[h].id;
    wim[o * 3 + 0] = best[h].w0;
    wim[o * 3 + 1] = best[h].w1;
    wim[o * 3 + 2] = best[h].w2;
  }
}

}  // namespace

extern "C" {

// Launches on `stream`, does not synchronise, allocates nothing and
// returns cudaGetLastError() of the launch (0 = cudaSuccess). The caller
// checks shapes: s % tile == 0, cand/valid (B, (s/tile)^2, slots).

int zbuffer_tiles(const float* packed, const int* cand, const int* valid,
                  int* fim, float* wim, int b, int nf, int s, int tile,
                  int slots, float near, float far, void* stream) {
  // a team of tw warps covers np pixels of a tile, two a thread; a tile
  // of more than 2 * kThreads pixels takes gpt CTAs
  const int tpx = tile * tile;
  const int np = tpx < 2 * kThreads ? tpx : 2 * kThreads;
  const int gpt = (tpx + np - 1) / np;
  const int tw = (np + 63) / 64 <= 1 ? 1
                 : (np + 63) / 64 <= 2 ? 2
                 : (np + 63) / 64 <= 4 ? 4 : 8;
  // a CTA scans one tile per team
  const int group = kWarps / tw;
  const int n_tiles = (s / tile) * (s / tile);
  const int ngroups = (n_tiles + group - 1) / group;
  const long long blocks = static_cast<long long>(b) * ngroups * gpt;
  if (blocks == 0) return 0;
  zbuffer_tiles_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      packed, cand, valid, fim, wim, b, nf, s, tile, slots, np, gpt, tw,
      group, near, far);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
