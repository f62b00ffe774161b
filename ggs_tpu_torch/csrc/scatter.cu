// K5, pair-scatter binning for Hopper (sm_90a): the per-tile ascending
// splat lists of a canvas with many tiles, from the pixel boxes, without
// the dense [B, T, N] sort.
//
//   K5 (ggs_scatter_bands, ggs_scatter_tiles) replaces the Pallas kernel
//      _scatter_bin_kernel (ggs_tpu/ops/render_pallas.py:750, pallas_call
//      at :986 in _bin_splats_scatter), which render_pallas runs from 256
//      tiles on, together with what the JAX package left to XLA around it:
//      the band lists (_band_lists_xla, :698) and the corner cull's band
//      column ranges (_corner_band_xranges, :489).
//
// The function (render_cuda.scatter_args then bin_splats_scatter_plain
// compute the same). With the tile bounds tx0 = x0 // tile_w, tx1, ty0,
// ty1 (floor division: a dead box's x1 = -1 is column -1), tile (row ty,
// column tx) of candidate b keeps splat s iff ty0 <= ty <= ty1 and
// lo(s) <= tx <= hi(s), where [lo, hi] is the box's tile columns or, under
// the band-level corner cull, the band's [txl, txh] for band ty / rpg
// (render_cuda._corner_band_xranges, whose expressions band_xrange repeats
// in their order). The list is ascending, its first cap entries kept and
// the rest of its cap slots the sentinel N; cnt = min(count, cap); tmax =
// the largest true count over the batch. The overflow rule
// (render_pallas.py:1012-1035): with the band cull under a budget list
// length cap_s < cap, a batch whose tmax exceeds cap_s takes the dense
// lists with the per-tile corner test instead (render_cuda._corner_keep,
// repeated by corner_keep). Every float expression is rounded as PyTorch
// rounds it: the library is built with -fmad=false, IEEE `/` and sqrtf.
//
// Three stages, each one launch:
// (a) band_kernel, a block per (candidate, band, chunk of 256 splats): the
//     chunk's row list of the band, in ascending order (a ballot and a
//     block prefix rank the entries; no atomic on a slot). An entry holds
//     the splat, its tile rows within the band and two tile-column ranges
//     (the band's under the cull, else the box's; and the box's), each
//     clamped to the grid and packed in one word. The whole row list is
//     kept, also a splat the cull drops from the whole band (its band
//     range is empty, so every tile test fails): the fallback needs it.
//     It also zeroes tmax.
// (b) tile_kernel<false>, a block per (candidate, tile row, group of up to
//     8 tile columns), a warp per column: the block stages its band's
//     entries in shared memory 512 at a time (the chunks' counts summed by
//     one warp), and each warp walks them 32 at a time, appending its
//     tile's kept entries in order by __ballot_sync/__popc, counting past
//     cap for the true count; then it pads its list with N by 16-byte
//     stores, unless (c) follows. tmax takes the block's largest count by
//     one atomicMax. Without bands (one row group, or a pass above 8192
//     splats) the block stages entries made from every splat's box instead.
// (c) tile_kernel<true>, the overflow fallback, launched after (b) where
//     it can apply: it reads tmax, and where tmax <= cap_s it only pads
//     (b)'s lists; else it rebuilds the lists from the same row lists with
//     the box's columns and the per-tile corner test, the six corner
//     parameters and the box staged beside the entries, and pads them. A
//     splat whose box covers tile (ty, tx) lies in the row list of band
//     ty / rpg, so the lists are the dense per-tile corner lists. Either
//     way the padding, most of the bytes, is written once.
//
// What bounds K5 on this card: bytes, the lists padded to cap written once
// (B * T * cap * 4 bytes: 328 MB for 32 candidates, 512 tiles and a
// 5,000-splat pass). The design reads each band entry once per block of
// up to 8 tiles from shared memory instead of once per tile from L2, runs
// the range arithmetic once per (band, splat) instead of in ~230 PyTorch
// ops, and writes the padding with coalesced 16-byte stores. Where the grid
// of (b) would hold fewer than two blocks a SM (B = 1), a block serves
// fewer columns, so the card still fills.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace ggs_scatter {

constexpr int kThreads = 256;  // a band-stage block, one thread per splat
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads;  // splats of a band-stage block
constexpr int kMaxChunks = 32;    // two-level passes hold at most 8192 splats
constexpr int kBands = 8;         // coarse row bands (render_pallas._N_COARSE)
constexpr int kMaxCols = 8;       // tile columns (warps) of a tile-stage block
constexpr int kStage = 512;       // entries a tile-stage block stages at once
constexpr int kMaxPacked = 32767;  // a packed range's bound: 15 bits

// The splats' inputs, each a [B, N] row by pointer and batch stride (the
// last stride is 1): the pixel boxes, and under the cull the six corner
// parameters (null without it).
struct Splats {
  const int* box[4];  // x0, x1, y0, y1
  long long box_bs[4];
  const float* cpar[6];  // cx, cy, nsxx, nsxy, nsyy, log2a
  long long cpar_bs[6];
  float log2eps;
};

struct Geometry {
  int B, N, n_tx, n_ty, tile_h, tile_w;
  int rpg;       // tile rows a band holds (n_ty without bands)
  int n_bands;   // ceil(n_ty / rpg)
  int n_chunks;  // ceil(N / kChunk), at least 1
  int cap, cap_s;
};

__device__ __forceinline__ int floordiv(int a, int d) {  // d > 0
  const int q = a / d;
  return q - ((a % d) < 0 ? 1 : 0);
}

// [lo, hi] within [0, n): lo | (hi + 1) << 16, each clamped to [0, n], so
// that for 0 <= v < n, lo <= v <= hi iff in_range(packed, v)
__device__ __forceinline__ int pack_range(int lo, int hi, int n) {
  lo = min(max(lo, 0), n);
  const int hi1 = min(max(hi, -1), n - 1) + 1;
  return lo | (hi1 << 16);
}

__device__ __forceinline__ bool in_range(int packed, int v) {
  return (packed & 0xffff) <= v && v < (packed >> 16);
}

// This thread's rank among the block's kept entries, in thread order;
// `total` gets the block's count. Every thread of the block calls it.
__device__ __forceinline__ int block_rank(bool keep, int* wsum, int& total) {
  const unsigned ball = __ballot_sync(0xffffffffu, keep);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) wsum[warp] = __popc(ball);
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = wsum[w];
    before += w < warp ? c : 0;
    total += c;
  }
  return before + __popc(ball & ((1u << lane) - 1u));
}

// render_cuda._corner_band_xranges for band k and one splat, its
// expressions in its order: the tile columns [txl, txh] where the splat's
// peak log2-contribution over (band strip ∩ box) can reach log2(eps);
// txh = txl - 1 where the interval is empty.
__device__ void band_xrange(float cx, float cy, float nxx, float nxy, float nyy, float log2a,
                            float log2eps, int x0, int x1, int y0, int y1, int k, int band_px,
                            int tile_w, int& txl, int& txh) {
  const float big = 1e30f;
  const float c = (float)k;
  const float dyl = fmaxf(c * (float)band_px, (float)y0) - cy;
  const float dyh = fminf(c * (float)band_px + (float)(band_px - 1), (float)y1) - cy;
  const float L = log2eps - log2a;  // need n(dx, dy) >= L
  // {dx : nxx dx^2 + (nxy dyc) dx + nyy dyc^2 - L >= 0}, nxx < 0
  auto quad_interval = [&](float dyc, float& lo, float& hi) {
    const float A = -nxx;
    const float Bq = -nxy * dyc;
    const float Cq = L - nyy * dyc * dyc;
    const float D = Bq * Bq - 4.0f * A * Cq;
    const float sq = sqrtf(fmaxf(D, 0.0f));
    const float inv2A = 0.5f / fmaxf(A, 1e-30f);
    const bool empty = D < 0.0f;
    lo = empty ? big : (-Bq - sq) * inv2A;
    hi = empty ? -big : (-Bq + sq) * inv2A;
  };
  const float ry = nxy / (-2.0f * fminf(nyy, -1e-30f));  // dy*(dx) = ry dx
  // the interval of {dx : ry dx >= cval} (ge) or {ry dx <= cval}
  auto halfplane = [&](float cval, bool ge, float& lo, float& hi) {
    const float rsafe = fabsf(ry) > 1e-20f ? ry : 1.0f;
    const float q = fminf(fmaxf(cval / rsafe, -1e30f), 1e30f);
    const bool pos = ry > 1e-20f;
    const bool neg = ry < -1e-20f;
    const bool zero = !(pos || neg);
    bool dead;
    if (ge) {
      lo = pos ? q : -big;
      hi = neg ? q : big;
      dead = zero && cval > 0.0f;
    } else {
      lo = neg ? q : -big;
      hi = pos ? q : big;
      dead = zero && cval < 0.0f;
    }
    if (dead) {
      lo = big;
      hi = -big;
    }
  };
  float ql[3], qh[3], dl[3], dh[3];
  quad_interval(dyl, ql[0], qh[0]);  // piece 0: dy clamped at dyl
  halfplane(dyl, false, dl[0], dh[0]);
  quad_interval(dyh, ql[2], qh[2]);  // piece 2: dy clamped at dyh
  halfplane(dyh, true, dl[2], dh[2]);
  // piece 1: the interior vertex, m = qi dx^2 with qi = nxx - nxy^2/(4 nyy)
  const float qi = nxx - nxy * nxy / (4.0f * fminf(nyy, -1e-30f));
  const float R = sqrtf(fmaxf(L / fminf(qi, -1e-30f), 0.0f));
  ql[1] = L <= 0.0f ? -R : big;
  qh[1] = L <= 0.0f ? R : -big;
  float d1l0, d1h0, d1l1, d1h1;
  halfplane(dyl, true, d1l0, d1h0);
  halfplane(dyh, false, d1l1, d1h1);
  dl[1] = fmaxf(d1l0, d1l1);
  dh[1] = fminf(d1h0, d1h1);
  float ulo = big, uhi = -big;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float plo = fmaxf(ql[i], dl[i]);
    const float phi = fminf(qh[i], dh[i]);
    const bool keep = plo <= phi;
    ulo = fminf(ulo, keep ? plo : big);
    uhi = fmaxf(uhi, keep ? phi : -big);
  }
  if (!(dyl <= dyh)) {  // box ∩ band strip is empty
    ulo = big;
    uhi = -big;
  }
  const float xlo = fminf(fmaxf(fmaxf((float)x0, floorf(cx + ulo)), 0.0f), 3.0e7f);
  const float xhi = fminf(fmaxf(fminf((float)x1, ceilf(cx + uhi)), -2.0f), 3.0e7f);
  txl = floordiv((int)xlo, tile_w);
  txh = xhi < xlo ? txl - 1 : floordiv((int)xhi, tile_w);
}

// render_cuda._corner_keep for one (tile, splat) pair, its expressions in
// its order
__device__ __forceinline__ bool corner_keep(float cx, float cy, float nxx, float nxy, float nyy,
                                            float log2a, int x0, int x1, int y0, int y1, int tx,
                                            int ty, int tile_h, int tile_w, float log2eps) {
  const float dx0 = fmaxf((float)(tx * tile_w), (float)x0) - cx;
  const float dx1 = fminf((float)(tx * tile_w + (tile_w - 1)), (float)x1) - cx;
  const float dy0 = fmaxf((float)(ty * tile_h), (float)y0) - cy;
  const float dy1 = fminf((float)(ty * tile_h + (tile_h - 1)), (float)y1) - cy;
  const float rx = (-0.5f * nxy) / fminf(nxx, -1e-30f);
  const float ry = (-0.5f * nxy) / fminf(nyy, -1e-30f);
  const float dxc = fminf(fmaxf(dx0, 0.0f), dx1);
  const float dyv = fminf(fmaxf(ry * dxc, dy0), dy1);
  const float v1 = (nxx * dxc + nxy * dyv) * dxc + (nyy * dyv) * dyv;
  const float dyc = fminf(fmaxf(dy0, 0.0f), dy1);
  const float dxv = fminf(fmaxf(rx * dyc, dx0), dx1);
  const float v2 = (nyy * dyc + nxy * dxv) * dyc + (nxx * dxv) * dxv;
  return log2a + fmaxf(v1, v2) >= log2eps;
}

__device__ __forceinline__ int box_at(const Splats& sp, int i, int b, int s) {
  return sp.box[i][b * sp.box_bs[i] + s];
}

__device__ __forceinline__ float cpar_at(const Splats& sp, int i, int b, int s) {
  return sp.cpar[i][b * sp.cpar_bs[i] + s];
}

// Splat s's entry for band k: (s, its tile rows within the band, the
// band's tile columns, the box's tile columns), or false where its tile
// rows miss the band (_band_lists' a <= k <= b).
__device__ __forceinline__ bool make_entry(const Splats& sp, const Geometry& g, int b, int s, int k,
                                           bool cull, int4& e) {
  const int ty0 = floordiv(box_at(sp, 2, b, s), g.tile_h);
  const int ty1 = floordiv(box_at(sp, 3, b, s), g.tile_h);
  const int a = floordiv(max(ty0, 0), g.rpg);
  const int z = floordiv(min(ty1, g.n_ty - 1), g.rpg);
  if (!(a <= k && k <= z)) return false;
  const int x0 = box_at(sp, 0, b, s), x1 = box_at(sp, 1, b, s);
  const int tx0 = floordiv(x0, g.tile_w), tx1 = floordiv(x1, g.tile_w);
  int lo = tx0, hi = tx1;
  if (cull)
    band_xrange(cpar_at(sp, 0, b, s), cpar_at(sp, 1, b, s), cpar_at(sp, 2, b, s),
                cpar_at(sp, 3, b, s), cpar_at(sp, 4, b, s), cpar_at(sp, 5, b, s), sp.log2eps, x0,
                x1, box_at(sp, 2, b, s), box_at(sp, 3, b, s), k, g.rpg * g.tile_h, g.tile_w, lo,
                hi);
  const int base = k * g.rpg;
  e = make_int4(s, pack_range(ty0 - base, ty1 - base, g.rpg), pack_range(lo, hi, g.n_tx),
                pack_range(tx0, tx1, g.n_tx));
  return true;
}

// (a) grid (n_chunks, n_bands, B): chunk c's entries of band k, ascending,
// at ent[b, k, c, 0..count), and count at ent_cnt[b, k, c].
__global__ void __launch_bounds__(kThreads)
    band_kernel(Splats sp, Geometry g, bool cull, int4* ent, int* ent_cnt, int* tmax) {
  __shared__ int wsum[kWarps];
  const int c = blockIdx.x, k = blockIdx.y, b = blockIdx.z;
  if ((c | k | b) == 0 && threadIdx.x == 0) *tmax = 0;  // (b) runs after this launch
  const int s = c * kChunk + threadIdx.x;
  int4 e;
  const bool in_row = s < g.N && make_entry(sp, g, b, s, k, cull, e);
  int total;
  const int rank = block_rank(in_row, wsum, total);
  const size_t seg = ((size_t)b * g.n_bands + k) * g.n_chunks + c;
  if (in_row) ent[seg * kChunk + rank] = e;
  if (threadIdx.x == 0) ent_cnt[seg] = total;
}

// out[from, to) = val by one warp, 16-byte stores between a scalar head
// and tail
__device__ __forceinline__ void warp_fill(int* out, int from, int to, int val, int lane) {
  if (from >= to) return;
  const int head = min((int)((16 - ((uintptr_t)(out + from) & 15)) & 15) / 4, to - from);
  if (lane < head) out[from + lane] = val;
  from += head;
  int4* q = reinterpret_cast<int4*>(out + from);
  const int nv = (to - from) / 4;
  const int4 v4 = make_int4(val, val, val, val);
  for (int j = lane; j < nv; j += 32) q[j] = v4;
  from += 4 * nv;
  if (lane < to - from) out[from + lane] = val;
}

// (b) and (c): grid (column groups, n_ty, B), blockDim 32 * columns a
// group. ent null: no bands, every splat's entry made from its box. pad:
// (b) pads its lists (false where (c) follows and pads them).
template <bool kFallback>
__global__ void __launch_bounds__(32 * kMaxCols)
    tile_kernel(Splats sp, Geometry g, const int4* ent, const int* ent_cnt, int* idx, int* cnt,
                int* tmax, bool pad) {
  __shared__ int4 s_ent[kStage];
  __shared__ int s_box[kFallback ? 4 : 1][kStage];
  __shared__ float s_cp[kFallback ? 6 : 1][kStage];
  __shared__ int s_off[kMaxChunks + 1];
  __shared__ int s_count[kMaxCols];
  const int cols = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.z, ty = blockIdx.y;
  const int tx = blockIdx.x * cols + warp;
  const bool col_ok = tx < g.n_tx;  // warp-uniform
  const int k = ty / g.rpg, r = ty - k * g.rpg;
  const int T = g.n_tx * g.n_ty;
  const size_t bt = (size_t)b * T + (size_t)ty * g.n_tx + tx;
  int* out = idx + bt * g.cap;
  if (kFallback && *tmax <= g.cap_s) {  // the band lists stand: pad them
    if (col_ok) warp_fill(out, cnt[bt], g.cap, g.N, lane);
    return;
  }
  const size_t seg0 = ((size_t)b * g.n_bands + k) * g.n_chunks;
  int n = g.N;
  if (ent) {  // the chunks' offsets in the band's row list
    if (warp == 0) {
      int v = lane < g.n_chunks ? ent_cnt[seg0 + lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      s_off[lane + 1] = v;
      if (lane == 0) s_off[0] = 0;
    }
    __syncthreads();
    n = s_off[g.n_chunks];
  }
  int count = 0;
  for (int base = 0; base < n; base += kStage) {
    const int m = min(kStage, n - base);
    __syncthreads();  // the previous window is walked
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
      const int e = base + j;
      int4 v;
      if (ent) {
        int lo = 0, hi = g.n_chunks - 1;  // the last chunk starting at or before e
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (s_off[mid] <= e) lo = mid;
          else hi = mid - 1;
        }
        v = ent[(seg0 + lo) * kChunk + (e - s_off[lo])];
      } else if (!make_entry(sp, g, b, e, 0, false, v)) {
        v = make_int4(e, 0, 0, 0);  // its rows miss the canvas: an empty range
      }
      s_ent[j] = v;
      if (kFallback) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s_box[i][j] = box_at(sp, i, b, v.x);
#pragma unroll
        for (int i = 0; i < 6; ++i) s_cp[i][j] = cpar_at(sp, i, b, v.x);
      }
    }
    __syncthreads();
    if (!col_ok) continue;
    for (int j0 = 0; j0 < m; j0 += 32) {
      const int j = j0 + lane;
      bool keep = false;
      int s = 0;
      if (j < m) {
        const int4 v = s_ent[j];
        s = v.x;
        keep = in_range(v.y, r) && in_range(kFallback ? v.w : v.z, tx);
        if (kFallback && keep)
          keep = corner_keep(s_cp[0][j], s_cp[1][j], s_cp[2][j], s_cp[3][j], s_cp[4][j],
                             s_cp[5][j], s_box[0][j], s_box[1][j], s_box[2][j], s_box[3][j], tx,
                             ty, g.tile_h, g.tile_w, sp.log2eps);
      }
      const unsigned ball = __ballot_sync(0xffffffffu, keep);
      const int pos = count + __popc(ball & ((1u << lane) - 1u));
      if (keep && pos < g.cap) out[pos] = s;
      count += __popc(ball);
    }
  }
  if (col_ok) {
    if (pad) warp_fill(out, min(count, g.cap), g.cap, g.N, lane);
    if (lane == 0) cnt[bt] = min(count, g.cap);
  }
  if (!kFallback) {  // tmax: the block's largest true count, one atomic
    if (lane == 0) s_count[warp] = col_ok ? count : 0;
    __syncthreads();
    if (threadIdx.x == 0) {
      int mx = 0;
      for (int w = 0; w < cols; ++w) mx = max(mx, s_count[w]);
      atomicMax(tmax, mx);
    }
  }
}

Splats splats(const void* const* box, const long long* box_bs, const void* const* cpar,
              const long long* cpar_bs, float log2eps) {
  Splats sp{};
  for (int i = 0; i < 4; ++i) {
    sp.box[i] = (const int*)box[i];
    sp.box_bs[i] = box_bs[i];
  }
  for (int i = 0; i < 6; ++i) {
    sp.cpar[i] = cpar ? (const float*)cpar[i] : nullptr;
    sp.cpar_bs[i] = cpar ? cpar_bs[i] : 0;
  }
  sp.log2eps = log2eps;
  return sp;
}

// The geometry, or false where a launch cannot take it.
bool geometry(int B, int N, int n_tx, int n_ty, int tile_h, int tile_w, int rpg, bool bands,
              int cap, int cap_s, Geometry& g) {
  if (B < 0 || N < 0 || n_tx <= 0 || n_ty <= 0 || tile_h <= 0 || tile_w <= 0 || cap < 0)
    return false;
  if (!bands) rpg = n_ty;
  const int n_bands = rpg > 0 ? (n_ty + rpg - 1) / rpg : 0;
  const int n_chunks = N > 0 ? (N + kChunk - 1) / kChunk : 1;
  if (rpg <= 0 || rpg > kMaxPacked || n_tx > kMaxPacked || B > 65535 || n_ty > 65535) return false;
  if (bands && (n_bands > kBands || n_chunks > kMaxChunks)) return false;
  if ((long long)B * n_tx * n_ty > 0x7fffffffLL) return false;
  g = Geometry{B, N, n_tx, n_ty, tile_h, tile_w, rpg, n_bands, n_chunks, cap, cap_s};
  return true;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 132;
  return n;
}

}  // namespace ggs_scatter

extern "C" {

// (a) The band stage: ent [B, n_bands, n_chunks, 256] int4 and ent_cnt
// [B, n_bands, n_chunks], n_chunks = max(1, ceil(N / 256)); zeroes *tmax.
// box: 4 pointers to [B, N] int32 rows, box_bs their batch strides; cpar:
// 6 pointers to [B, N] f32 rows (the corner parameters) or null without
// the band cull.
int ggs_scatter_bands(const void* const* box, const long long* box_bs, const void* const* cpar,
                      const long long* cpar_bs, float log2eps, void* ent, int* ent_cnt, int* tmax,
                      int B, int N, int n_tx, int n_ty, int tile_h, int tile_w, int rpg,
                      void* stream) {
  using namespace ggs_scatter;
  Geometry g;
  if (!geometry(B, N, n_tx, n_ty, tile_h, tile_w, rpg, true, 0, 0, g))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const dim3 grid(g.n_chunks, g.n_bands, B);
  band_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      splats(box, box_bs, cpar, cpar_bs, log2eps), g, cpar != nullptr, (int4*)ent, ent_cnt, tmax);
  return (int)cudaGetLastError();
}

// (b), then (c) where fallback: the lists idx [B, T, cap], cnt [B, T] and
// tmax (zeroed by (a), or by the caller without bands). ent/ent_cnt from
// ggs_scatter_bands, or null: no bands, every splat walked. The fallback
// needs the bands and cpar.
int ggs_scatter_tiles(const void* const* box, const long long* box_bs, const void* const* cpar,
                      const long long* cpar_bs, float log2eps, const void* ent,
                      const int* ent_cnt, int* idx, int* cnt, int* tmax, int B, int N, int n_tx,
                      int n_ty, int tile_h, int tile_w, int rpg, int cap, int cap_s, int fallback,
                      void* stream) {
  using namespace ggs_scatter;
  Geometry g;
  const bool bands = ent != nullptr;
  if (!geometry(B, N, n_tx, n_ty, tile_h, tile_w, rpg, bands, cap, cap_s, g) ||
      (bands && !ent_cnt) || (fallback && (!bands || !cpar)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  // columns a block: the most (up to 8) that still give two blocks a SM
  int cols = std::min(kMaxCols, n_tx);
  const long long want = 2LL * sm_count();
  while (cols > 1 && (long long)B * n_ty * ((n_tx + cols - 1) / cols) < want) cols >>= 1;
  const dim3 grid((n_tx + cols - 1) / cols, n_ty, B);
  cudaStream_t s = (cudaStream_t)stream;
  const Splats sp = splats(box, box_bs, cpar, cpar_bs, log2eps);
  tile_kernel<false><<<grid, 32 * cols, 0, s>>>(sp, g, (const int4*)ent, ent_cnt, idx, cnt, tmax,
                                                 !fallback);
  if (fallback) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    tile_kernel<true><<<grid, 32 * cols, 0, s>>>(sp, g, (const int4*)ent, ent_cnt, idx, cnt, tmax,
                                                true);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
