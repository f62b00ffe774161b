// Tile walk kernels for Hopper (sm_90a): the exact painter-order "over"
// composite of one (candidate, tile) splat list, with two epilogues.
//
//   K1 (ggs_walk_fitness) replaces the Pallas kernel _fitness_tile_kernel
//      (ggs_tpu/ops/render_pallas.py, pallas_call in _fitness_partials):
//      writes sum_px w * ((r-tr)^2 + (g-tg)^2 + (b-tb)^2) per (candidate, tile).
//   K2 (ggs_walk_render) replaces _render_tile_kernel (pallas_call in
//      _render_padded): writes the clamped canvas [B, 3, Hp, Wp].
//
// Both share the walk of _composite_tile.blend_one: for k < cnt[b,t] with
// s = idx[b,t,k], per pixel (x, y):
//   qx = x - cx, qy = y - cy
//   f  = exp(nsxx*(qx*qx) + nsxy*(qx*qy) + nsyy*(qy*qy)) * a   (summed left to right)
//   f  = 0 unless x0 <= x <= x1 && y0 <= y <= y1
//   C  = (1 - f)*C + f*c, per channel; finally C is clamped to [0, 1].
// A pixel outside the AABB skips the blend: with f = 0 it is an exact
// no-op, so skipping changes no bit. Build with -fmad=false and without
// fast math: every product and sum is then rounded on its own, as in the
// plain PyTorch version, and expf is the accurate one.
//
// What bounds it on the card: the arithmetic of the walk, about 30 f32
// operations and one exp per (splat, pixel) pair inside the box, against
// a few KB of list and table per tile. The design keeps every pixel's
// canvas in registers for the whole walk (one block per (candidate,
// tile), each thread owning one column and tile_h / (256 / tile_w) rows),
// stages the list's splat parameters through shared memory 256 at a time
// so each is read from device memory once per tile, and hoists the
// per-column terms (qx, nsxx*qx*qx, the x test) out of the row loop. The
// K1 reduction is fixed-order (rows in order, a warp shuffle tree, then
// the warps in order), with no atomics, so fitness is the same bits on
// every run.

#include <cuda_runtime.h>

namespace ggs {

constexpr int kThreads = 256;  // threads per block (one block per tile)
constexpr int kMaxRows = 32;   // tile rows one thread owns, at most
constexpr int kChunk = 256;    // list entries staged per pass
constexpr int kNFeat = 13;     // rows of the parameter table

// rows of the parameter table (render_pallas._splat_feats_fast)
enum { F_CX, F_CY, F_SXX, F_SXY, F_SYY, F_R, F_G, F_B, F_A, F_X0, F_X1, F_Y0, F_Y1 };

struct WalkParams {
  const int* cnt;      // [B, T]
  const int* idx;      // [B, T, L] ascending splat indices
  const float* feats;  // [B, 13, N1]
  int T, L, N1;
  int n_tx, tile_h, tile_w, Hp, Wp;
  float bg0, bg1, bg2;
};

// Walks the tile's list; leaves the clamped canvas of this thread's pixels
// in cr/cg/cb[j] for rows j < nrows.
__device__ __forceinline__ void walk_tile(const WalkParams& p, int bt, int b, float xf,
                                          float ybase, int rstride, int nrows,
                                          float (&cr)[kMaxRows], float (&cg)[kMaxRows],
                                          float (&cb)[kMaxRows]) {
  __shared__ float sf[kNFeat][kChunk];

#pragma unroll
  for (int j = 0; j < kMaxRows; ++j) {
    cr[j] = p.bg0;
    cg[j] = p.bg1;
    cb[j] = p.bg2;
  }

  const int n = p.cnt[bt];
  const int* list = p.idx + (size_t)bt * p.L;
  const float* fb = p.feats + (size_t)b * kNFeat * p.N1;

  for (int base = 0; base < n; base += kChunk) {
    const int m = min(kChunk, n - base);
    __syncthreads();  // the previous chunk is consumed
    for (int e = threadIdx.x; e < m; e += blockDim.x) {
      const int s = list[base + e];
#pragma unroll
      for (int r = 0; r < kNFeat; ++r) sf[r][e] = fb[(size_t)r * p.N1 + s];
    }
    __syncthreads();

    for (int k = 0; k < m; ++k) {
      const float x0 = sf[F_X0][k];
      const float x1 = sf[F_X1][k];
      if (!(xf >= x0 && xf <= x1)) continue;  // this column is outside the box
      const float cx = sf[F_CX][k];
      const float cy = sf[F_CY][k];
      const float nsxx = sf[F_SXX][k];
      const float nsxy = sf[F_SXY][k];
      const float nsyy = sf[F_SYY][k];
      const float rc = sf[F_R][k];
      const float gc = sf[F_G][k];
      const float bc = sf[F_B][k];
      const float a = sf[F_A][k];
      const float y0 = sf[F_Y0][k];
      const float y1 = sf[F_Y1][k];
      const float qx = xf - cx;
      const float txx = nsxx * (qx * qx);
#pragma unroll
      for (int j = 0; j < kMaxRows; ++j) {
        if (j < nrows) {
          const float yf = ybase + (float)(j * rstride);
          if (yf >= y0 && yf <= y1) {
            const float qy = yf - cy;
            float quad = txx + nsxy * (qx * qy);
            quad = quad + nsyy * (qy * qy);
            const float f = expf(quad) * a;
            const float omf = 1.0f - f;
            cr[j] = omf * cr[j] + f * rc;
            cg[j] = omf * cg[j] + f * gc;
            cb[j] = omf * cb[j] + f * bc;
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kMaxRows; ++j) {
    cr[j] = fminf(fmaxf(cr[j], 0.0f), 1.0f);
    cg[j] = fminf(fmaxf(cg[j], 0.0f), 1.0f);
    cb[j] = fminf(fmaxf(cb[j], 0.0f), 1.0f);
  }
}

struct TileGeom {
  int bt, b, col, row0, rstride, nrows, tx0, ty0;
};

__device__ __forceinline__ TileGeom tile_geom(const WalkParams& p) {
  TileGeom g;
  g.bt = blockIdx.x;  // b * T + t
  g.b = g.bt / p.T;
  const int t = g.bt - g.b * p.T;
  g.tx0 = (t % p.n_tx) * p.tile_w;
  g.ty0 = (t / p.n_tx) * p.tile_h;
  g.rstride = kThreads / p.tile_w;
  g.col = threadIdx.x % p.tile_w;
  g.row0 = threadIdx.x / p.tile_w;
  g.nrows = p.tile_h / g.rstride;
  return g;
}

__global__ void __launch_bounds__(kThreads) render_kernel(WalkParams p, float* __restrict__ out) {
  const TileGeom g = tile_geom(p);
  float cr[kMaxRows], cg[kMaxRows], cb[kMaxRows];
  walk_tile(p, g.bt, g.b, (float)(g.tx0 + g.col), (float)(g.ty0 + g.row0), g.rstride, g.nrows,
            cr, cg, cb);
  const size_t plane = (size_t)p.Hp * p.Wp;
  float* ob = out + (size_t)g.b * 3 * plane;
  const int x = g.tx0 + g.col;
#pragma unroll
  for (int j = 0; j < kMaxRows; ++j) {
    if (j < g.nrows) {
      const size_t o = (size_t)(g.ty0 + g.row0 + j * g.rstride) * p.Wp + x;
      ob[o] = cr[j];
      ob[plane + o] = cg[j];
      ob[2 * plane + o] = cb[j];
    }
  }
}

__global__ void __launch_bounds__(kThreads) fitness_kernel(WalkParams p,
                                                           const float* __restrict__ target,
                                                           const float* __restrict__ w,
                                                           float* __restrict__ partials) {
  __shared__ float red[kThreads / 32];
  const TileGeom g = tile_geom(p);
  float cr[kMaxRows], cg[kMaxRows], cb[kMaxRows];
  walk_tile(p, g.bt, g.b, (float)(g.tx0 + g.col), (float)(g.ty0 + g.row0), g.rstride, g.nrows,
            cr, cg, cb);
  const size_t plane = (size_t)p.Hp * p.Wp;
  const int x = g.tx0 + g.col;
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxRows; ++j) {
    if (j < g.nrows) {
      const size_t o = (size_t)(g.ty0 + g.row0 + j * g.rstride) * p.Wp + x;
      const float dr = cr[j] - target[o];
      const float dg = cg[j] - target[plane + o];
      const float db = cb[j] - target[2 * plane + o];
      acc = acc + (dr * dr + dg * dg + db * db) * w[o];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc = acc + __shfl_xor_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int i = 0; i < kThreads / 32; ++i) s = s + red[i];
    partials[g.bt] = s;
  }
}

// tile_w must divide the block, and the block's rows must tile tile_h
// within kMaxRows rows a thread.
bool geometry_ok(int tile_h, int tile_w) {
  if (tile_w <= 0 || tile_h <= 0 || kThreads % tile_w != 0) return false;
  const int rstride = kThreads / tile_w;
  return tile_h % rstride == 0 && tile_h / rstride <= kMaxRows;
}

}  // namespace ggs

extern "C" {

int ggs_walk_geometry_ok(int tile_h, int tile_w) { return ggs::geometry_ok(tile_h, tile_w) ? 1 : 0; }

const char* ggs_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int ggs_walk_render(const int* cnt, const int* idx, const float* feats, float* canvas, int B, int T,
                    int L, int N1, int n_tx, int tile_h, int tile_w, int Hp, int Wp, float bg0,
                    float bg1, float bg2, void* stream) {
  if (!ggs::geometry_ok(tile_h, tile_w)) return (int)cudaErrorInvalidValue;
  if (B * T == 0) return 0;
  ggs::WalkParams p{cnt, idx, feats, T, L, N1, n_tx, tile_h, tile_w, Hp, Wp, bg0, bg1, bg2};
  ggs::render_kernel<<<B * T, ggs::kThreads, 0, (cudaStream_t)stream>>>(p, canvas);
  return (int)cudaGetLastError();
}

int ggs_walk_fitness(const int* cnt, const int* idx, const float* feats, const float* target,
                     const float* w, float* partials, int B, int T, int L, int N1, int n_tx,
                     int tile_h, int tile_w, int Hp, int Wp, float bg0, float bg1, float bg2,
                     void* stream) {
  if (!ggs::geometry_ok(tile_h, tile_w)) return (int)cudaErrorInvalidValue;
  if (B * T == 0) return 0;
  ggs::WalkParams p{cnt, idx, feats, T, L, N1, n_tx, tile_h, tile_w, Hp, Wp, bg0, bg1, bg2};
  ggs::fitness_kernel<<<B * T, ggs::kThreads, 0, (cudaStream_t)stream>>>(p, target, w, partials);
  return (int)cudaGetLastError();
}

}  // extern "C"
