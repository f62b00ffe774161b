// K5, pair-scatter binning for Hopper (sm_90a): the per-tile ascending
// splat lists of a canvas with many tiles, without the dense [B, T, N] sort.
//
//   K5 (ggs_scatter_bin, and ggs_scatter_fallback for the overflow case)
//      replaces the Pallas kernel _scatter_bin_kernel
//      (ggs_tpu/ops/render_pallas.py:750, pallas_call at :986 in
//      _bin_splats_scatter), which render_pallas runs from 256 tiles on.
//
// The function (render_cuda.bin_splats_scatter_plain computes the same).
// Tile (row ty, column tx) of candidate b keeps splat s iff
//   rng[b,2,s] <= ty <= rng[b,3,s]    (the box's tile rows)    and
//   lo(s) <= tx <= hi(s),
// where [lo, hi] is the box's tile columns rng[b,0..1,s] or, under the
// band-level corner cull, the band's [txl, txh] = cxr[b, ty / rpg, 0..1, s]
// (render_cuda._corner_band_xranges). The list is ascending, its first cap
// entries kept and the rest of its cap slots the sentinel N; cnt =
// min(count, cap); tmax = the largest true count over the batch. A band's
// list gl[b, band] (render_cuda._band_lists) holds, ascending, every splat
// that can pass the row test of a tile in the band, less those the band cull
// drops whole, so walking it instead of all N splats changes no list. The
// rng bounds come from floor division in PyTorch: a dead box's x1 = -1 is
// column -1, where C's `/` would give column 0.
//
// The overflow rule (render_pallas.py:1012-1035): with the band cull under a
// budget list length cap_s < cap, a batch whose tmax exceeds cap_s takes the
// dense lists with the per-tile corner test instead (render_cuda._corner_keep,
// whose expressions ggs_scatter_fallback repeats in the same order, so its
// decisions equal PyTorch's on the card). The decision stays on the device:
// the walk takes tmax by atomicMax, and the fallback launch reads it and
// returns at once where it does not exceed cap_s. Without the band cull the
// band lists already equal the dense ones.
//
// What bounds K5: bytes. Per (candidate, tile) it reads its band's list and,
// per entry, 4 tile bounds and 2 column bounds (the same few KB for every
// tile of a band, so mostly from L2), and it writes its list padded with N
// to cap entries: B * T * cap * 4 bytes, 328 MB for 32 candidates, 512 tiles
// and a 5,000-splat pass, which dominates. The design: one block of 256
// threads per (candidate, tile) walks the band list 256 entries at a time,
// each thread testing one entry; a warp ballot and popcount rank the kept
// entries within a warp and a block prefix over the 8 warp counts ranks the
// warps, so the kept entries land in ascending order with no atomic on a
// list slot, and the same bits on every launch. The walk goes on past cap to
// count the true length. The padding is written with coalesced stores.

#include <cuda_runtime.h>

namespace ggs_scatter {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBands = 8;  // coarse row bands (render_pallas._N_COARSE)

struct ScatterParams {
  const int* rng;   // [B, 4, N] tile bounds tx0, tx1, ty0, ty1
  const int* gl;    // [B, 8, Lg] band lists, or null: every splat is walked
  const int* gcnt;  // [B, 8] band list lengths
  const int* cxr;   // [B, 8, 2, N] band column ranges, or null: the box's columns
  int* idx;         // [B, T, cap]
  int* cnt;         // [B, T]
  int* tmax;        // the largest true count, zeroed by the caller
  int N, T, n_tx, rpg, Lg, cap;
};

struct FallbackParams {
  const int* rng;    // [B, 4, N] tile bounds
  const int* box;    // [B, 4, N] pixel box x0, x1, y0, y1
  const float* cpar;  // [B, 6, N] cx, cy, nsxx, nsxy, nsyy, log2a
  float log2eps;
  const int* tmax;
  int cap_s;
  int* idx;
  int* cnt;
  int N, T, n_tx, tile_h, tile_w, cap;
};

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
  __syncthreads();  // wsum is written again by the next call
  return before + __popc(ball & ((1u << lane) - 1u));
}

// Walks entries 0..n-1 of `list` (the splat index itself where list is
// null), writes the kept ones ascending to out[0..cap), pads out[count..cap)
// with N, and returns the true count.
template <class Keep>
__device__ __forceinline__ int compact(int n, const int* list, const Keep& keep, int* out, int cap,
                                       int N, int* wsum) {
  int count = 0;
  for (int base = 0; base < n; base += kThreads) {
    const int e = base + threadIdx.x;
    const int s = e < n ? (list ? list[e] : e) : 0;
    const bool k = e < n && keep(s);
    int total;
    const int pos = count + block_rank(k, wsum, total);
    if (k && pos < cap) out[pos] = s;
    count += total;
  }
  for (int j = min(count, cap) + threadIdx.x; j < cap; j += kThreads) out[j] = N;
  return count;
}

__global__ void __launch_bounds__(kThreads) scatter_kernel(ScatterParams p) {
  __shared__ int wsum[kWarps];
  const int bt = blockIdx.x;  // b * T + t
  const int b = bt / p.T;
  const int t = bt - b * p.T;
  const int tx = t % p.n_tx;
  const int ty = t / p.n_tx;
  const int band = ty / p.rpg;
  const size_t N = p.N;
  const int* r = p.rng + (size_t)b * 4 * N;
  const int* lo = p.cxr ? p.cxr + ((size_t)b * kBands + band) * 2 * N : r;
  const int* hi = lo + N;
  const int* list = p.gl ? p.gl + ((size_t)b * kBands + band) * p.Lg : nullptr;
  const int n = p.gl ? p.gcnt[b * kBands + band] : p.N;
  auto keep = [&](int s) {
    return r[2 * N + s] <= ty && r[3 * N + s] >= ty && lo[s] <= tx && hi[s] >= tx;
  };
  const int count = compact(n, list, keep, p.idx + (size_t)bt * p.cap, p.cap, p.N, wsum);
  if (threadIdx.x == 0) {
    p.cnt[bt] = min(count, p.cap);
    atomicMax(p.tmax, count);
  }
}

// render_cuda._corner_keep for one (tile, splat) pair, its expressions in
// its order (each product and sum rounded on its own: -fmad=false)
__device__ __forceinline__ bool corner_keep(const float* c, size_t N, int s, int x0, int x1, int y0,
                                            int y1, int tx, int ty, int tile_h, int tile_w,
                                            float log2eps) {
  const float cx = c[s], cy = c[N + s];
  const float nxx = c[2 * N + s], nxy = c[3 * N + s], nyy = c[4 * N + s];
  const float log2a = c[5 * N + s];
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

// The overflow fallback: where tmax > cap_s, the dense lists with the
// per-tile corner test (render_cuda.bin_splats_dense with corner).
__global__ void __launch_bounds__(kThreads) fallback_kernel(FallbackParams p) {
  __shared__ int wsum[kWarps];
  if (*p.tmax <= p.cap_s) return;  // the band lists stand
  const int bt = blockIdx.x;
  const int b = bt / p.T;
  const int t = bt - b * p.T;
  const int tx = t % p.n_tx;
  const int ty = t / p.n_tx;
  const size_t N = p.N;
  const int* r = p.rng + (size_t)b * 4 * N;
  const int* bx = p.box + (size_t)b * 4 * N;
  const float* c = p.cpar + (size_t)b * 6 * N;
  auto keep = [&](int s) {
    return r[s] <= tx && r[N + s] >= tx && r[2 * N + s] <= ty && r[3 * N + s] >= ty &&
           corner_keep(c, N, s, bx[s], bx[N + s], bx[2 * N + s], bx[3 * N + s], tx, ty, p.tile_h,
                       p.tile_w, p.log2eps);
  };
  const int count = compact(p.N, nullptr, keep, p.idx + (size_t)bt * p.cap, p.cap, p.N, wsum);
  if (threadIdx.x == 0) p.cnt[bt] = min(count, p.cap);
}

}  // namespace ggs_scatter

extern "C" {

// The band walk: lists, counts and tmax. gl/gcnt may be null (no bands: every
// splat walked), cxr may be null (the box's columns); Lg is gl's row length.
int ggs_scatter_bin(const int* rng, const int* gl, const int* gcnt, const int* cxr, int* idx,
                    int* cnt, int* tmax, int B, int N, int n_tx, int n_ty, int rpg, int Lg, int cap,
                    void* stream) {
  const long long blocks = (long long)B * n_tx * n_ty;
  if (blocks == 0) return 0;
  const bool bands_ok = !gl || (gcnt && (n_ty + rpg - 1) / rpg <= ggs_scatter::kBands);
  if (N < 0 || cap < 0 || rpg <= 0 || !bands_ok || (cxr && !gl) || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  ggs_scatter::ScatterParams p{rng, gl, gcnt, cxr, idx, cnt, tmax, N, n_tx * n_ty, n_tx, rpg, Lg,
                               cap};
  cudaStream_t s = (cudaStream_t)stream;
  ggs_scatter::scatter_kernel<<<(unsigned)blocks, ggs_scatter::kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

// The overflow fallback, launched after ggs_scatter_bin on the same stream.
int ggs_scatter_fallback(const int* rng, const int* box, const float* cpar, float log2eps,
                         const int* tmax, int cap_s, int* idx, int* cnt, int B, int N, int n_tx,
                         int n_ty, int tile_h, int tile_w, int cap, void* stream) {
  const long long blocks = (long long)B * n_tx * n_ty;
  if (blocks == 0) return 0;
  if (N < 0 || cap < 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ggs_scatter::FallbackParams p{rng, box, cpar, log2eps, tmax, cap_s, idx, cnt,
                                N,   n_tx * n_ty, n_tx, tile_h, tile_w, cap};
  cudaStream_t s = (cudaStream_t)stream;
  ggs_scatter::fallback_kernel<<<(unsigned)blocks, ggs_scatter::kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
