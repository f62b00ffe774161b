// Tile walk kernels for Hopper (sm_90a): the painter-order "over" composite
// of one (candidate, tile) splat list, with two epilogues, in three blend
// modes; and the fast tier's fused table builder.
//
//   K1 (ggs_walk_fitness, mode 0) replaces the Pallas kernel
//      _fitness_tile_kernel (ggs_tpu/ops/render_pallas.py, pallas_call in
//      _fitness_partials): writes sum_px w * ((r-tr)^2 + (g-tg)^2 + (b-tb)^2)
//      per (candidate, tile).
//   K2 (ggs_walk_render, mode 0) replaces _render_tile_kernel (pallas_call in
//      _render_padded): writes the clamped canvas [B, 3, Hp, Wp].
//   K3 (mode 1 of both) replaces the same two pallas_calls with turbo=True,
//      the walk _composite_tile.blend_one_turbo over _splat_feats_turbo.
//   K1-bf16 (ggs_walk_fitness, mode 2) replaces _fitness_tile_kernel with
//      compute_dtype=bfloat16 (blend_one with dt=bf16).
//   K4 (ggs_prep_fast) replaces _prep_turbo_kernel (pallas_call in
//      _prep_turbo_pallas): renderer genome -> fast table + eps-tight boxes.
//
// Every walk starts from the background or, where the caller passes one, from
// an init canvas [B, 3, Hp, Wp] (has_init, render_pallas.py:1149-1158): the
// previous pass of a render or fitness chained in passes of at most 8000
// splats. Mode 2 rounds the init to bf16 where it enters, as
// init_ref[...].astype(bf16) does. The init is a pointer that may be null,
// not a second copy of the walk.
//
// The walks, for k < cnt[b,t] with s = idx[b,t,k], per pixel (x, y):
//   mode 0 (exact):  qx = x - cx, qy = y - cy
//     f = exp(nsxx*(qx*qx) + nsxy*(qx*qy) + nsyy*(qy*qy)) * a   (left to right)
//     f = 0 unless x0 <= x <= x1 && y0 <= y <= y1;  C = (1 - f)*C + f*c
//   mode 1 (fast, the table holds log2e-folded precisions, log2(a) and the
//     open-interval thresholds x0-1, x1+1, y0-1, y1+1):
//     f = exp2(nsxx*(qx*qx) + (nsxy*(qx*qy) + (nsyy*(qy*qy) + log2a)))
//     f = 0 unless x0 < x < x1 && y0 < y < y1;      C = C + f*(c - C)
//   mode 2 (bf16): mode 0's walk with qx, qy rounded to bf16 after the f32
//     subtraction, the table's entries rounded to bf16 where they enter, and
//     every product, sum, exp and blend rounded to bf16 (as torch rounds each
//     bf16 operation; expf of the bf16 value, then rounded); the canvas
//     starts as the bf16 background (or init) and is carried in bf16.
// Finally C is clamped to [0, 1] in f32. A pixel outside the box skips the
// blend: with f = 0 it is an exact no-op in every mode, so skipping changes
// no bit (mode 1: exp2f(-inf) = 0 for alpha 0 and the sentinel, which is
// why no ex2.approx). Build with -fmad=false and without fast math: every
// product and sum is rounded on its own, as in the plain PyTorch versions,
// and expf/exp2f/logf/log2f are the accurate ones.
//
// What bounds the walks on the card: their arithmetic, about 20-30
// operations and one exp per (splat, pixel) pair inside the box, against a
// few KB of list and table per tile. The design keeps every pixel's canvas
// in registers for the whole walk (one block per (candidate, tile), each
// thread owning one column and tile_h / (256 / tile_w) rows), stages the
// list's splat parameters through shared memory 256 at a time so each is
// read from device memory once per tile, and hoists the per-column terms
// (qx, nsxx*qx*qx, the x test) out of the row loop (in mode 1 that term is
// the last add of the sum, so hoisting changes no bit). The K1 reduction is
// fixed-order (rows in order, a warp shuffle tree, then the warps in order),
// with no atomics, so fitness is the same bits on every run.
//
// K4 is elementwise, one thread per (candidate, splat), reading the
// [B, N, 9] genome in place (no transpose copy): a few dozen operations
// against 36 bytes in and 68 out a splat, so bytes and the launch bound it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ggs {

constexpr int kThreads = 256;  // threads per block (one block per tile)
constexpr int kMaxRows = 32;   // tile rows one thread owns, at most
constexpr int kChunk = 256;    // list entries staged per pass
constexpr int kNFeat = 13;     // rows of the parameter table

// rows of the parameter table (render_pallas._splat_feats_fast / _turbo)
enum { F_CX, F_CY, F_SXX, F_SXY, F_SYY, F_R, F_G, F_B, F_A, F_X0, F_X1, F_Y0, F_Y1 };
enum { kExact = 0, kFast = 1, kBf16 = 2 };

struct WalkParams {
  const int* cnt;      // [B, T]
  const int* idx;      // [B, T, L] ascending splat indices
  const float* feats;  // [B, 13, N1]
  const float* init;   // [B, 3, Hp, Wp] the canvas to start from, or null: the background
  int T, L, N1;
  int n_tx, tile_h, tile_w, Hp, Wp;
  float bg0, bg1, bg2;
};

// f32 -> bf16 (round to nearest even) -> f32: one bf16 rounding
__device__ __forceinline__ float bf(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// one bf16 rounding in mode 2, the identity in the f32 modes
template <int kMode>
__device__ __forceinline__ float R(float x) { return kMode == kBf16 ? bf(x) : x; }

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

// canvas offset of this thread's pixel in row j
__device__ __forceinline__ size_t pixel(const WalkParams& p, const TileGeom& g, int j) {
  return (size_t)(g.ty0 + g.row0 + j * g.rstride) * p.Wp + g.tx0 + g.col;
}

// Walks the tile's list; leaves the clamped canvas of this thread's pixels
// in cr/cg/cb[j] for rows j < nrows.
template <int kMode>
__device__ __forceinline__ void walk_tile(const WalkParams& p, const TileGeom& g,
                                          float (&cr)[kMaxRows], float (&cg)[kMaxRows],
                                          float (&cb)[kMaxRows]) {
  __shared__ float sf[kNFeat][kChunk];

  const float xf = (float)(g.tx0 + g.col);
  const float ybase = (float)(g.ty0 + g.row0);
  const int rstride = g.rstride, nrows = g.nrows;
  if (p.init) {
    const size_t plane = (size_t)p.Hp * p.Wp;
    const float* ib = p.init + (size_t)g.b * 3 * plane;
#pragma unroll
    for (int j = 0; j < kMaxRows; ++j) {
      if (j < nrows) {
        const size_t o = pixel(p, g, j);
        cr[j] = R<kMode>(ib[o]);
        cg[j] = R<kMode>(ib[plane + o]);
        cb[j] = R<kMode>(ib[2 * plane + o]);
      }
    }
  } else {
    const float bg0 = R<kMode>(p.bg0), bg1 = R<kMode>(p.bg1), bg2 = R<kMode>(p.bg2);
#pragma unroll
    for (int j = 0; j < kMaxRows; ++j) {
      cr[j] = bg0;
      cg[j] = bg1;
      cb[j] = bg2;
    }
  }

  const int n = p.cnt[g.bt];
  const int* list = p.idx + (size_t)g.bt * p.L;
  const float* fb = p.feats + (size_t)g.b * kNFeat * p.N1;

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
      // this column is outside the box
      if (kMode == kFast ? !(xf > x0 && xf < x1) : !(xf >= x0 && xf <= x1)) continue;
      const float cx = sf[F_CX][k];
      const float cy = sf[F_CY][k];
      const float nsxx = sf[F_SXX][k];
      const float nsxy = sf[F_SXY][k];
      const float nsyy = sf[F_SYY][k];
      const float rc = sf[F_R][k];
      const float gc = sf[F_G][k];
      const float bc = sf[F_B][k];
      const float a = sf[F_A][k];  // mode 1: log2(alpha), -inf for alpha 0
      const float y0 = sf[F_Y0][k];
      const float y1 = sf[F_Y1][k];
      if (kMode == kFast) {
        const float qx = xf - cx;
        const float txx = nsxx * (qx * qx);
#pragma unroll
        for (int j = 0; j < kMaxRows; ++j) {
          if (j < nrows) {
            const float yf = ybase + (float)(j * rstride);
            if (yf > y0 && yf < y1) {
              const float qy = yf - cy;
              const float inner = nsxy * (qx * qy) + (nsyy * (qy * qy) + a);
              const float f = exp2f(txx + inner);
              cr[j] = cr[j] + f * (rc - cr[j]);
              cg[j] = cg[j] + f * (gc - cg[j]);
              cb[j] = cb[j] + f * (bc - cb[j]);
            }
          }
        }
      } else {
        // the exact walk; mode 2 rounds to bf16 after each operation, as
        // the JAX body's bf16 arithmetic does (R<kExact> is the identity)
        const float qx = R<kMode>(xf - cx);
        const float txx = R<kMode>(R<kMode>(nsxx) * R<kMode>(qx * qx));
        const float bxy = R<kMode>(nsxy), byy = R<kMode>(nsyy), ba = R<kMode>(a);
        const float brc = R<kMode>(rc), bgc = R<kMode>(gc), bbc = R<kMode>(bc);
#pragma unroll
        for (int j = 0; j < kMaxRows; ++j) {
          if (j < nrows) {
            const float yf = ybase + (float)(j * rstride);
            if (yf >= y0 && yf <= y1) {
              const float qy = R<kMode>(yf - cy);
              float quad = R<kMode>(txx + R<kMode>(bxy * R<kMode>(qx * qy)));
              quad = R<kMode>(quad + R<kMode>(byy * R<kMode>(qy * qy)));
              const float f = R<kMode>(R<kMode>(expf(quad)) * ba);
              const float omf = R<kMode>(1.0f - f);
              cr[j] = R<kMode>(R<kMode>(omf * cr[j]) + R<kMode>(f * brc));
              cg[j] = R<kMode>(R<kMode>(omf * cg[j]) + R<kMode>(f * bgc));
              cb[j] = R<kMode>(R<kMode>(omf * cb[j]) + R<kMode>(f * bbc));
            }
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

template <int kMode>
__global__ void __launch_bounds__(kThreads) render_kernel(WalkParams p, float* __restrict__ out) {
  const TileGeom g = tile_geom(p);
  float cr[kMaxRows], cg[kMaxRows], cb[kMaxRows];
  walk_tile<kMode>(p, g, cr, cg, cb);
  const size_t plane = (size_t)p.Hp * p.Wp;
  float* ob = out + (size_t)g.b * 3 * plane;
#pragma unroll
  for (int j = 0; j < kMaxRows; ++j) {
    if (j < g.nrows) {
      const size_t o = pixel(p, g, j);
      ob[o] = cr[j];
      ob[plane + o] = cg[j];
      ob[2 * plane + o] = cb[j];
    }
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) fitness_kernel(WalkParams p,
                                                           const float* __restrict__ target,
                                                           const float* __restrict__ w,
                                                           float* __restrict__ partials) {
  __shared__ float red[kThreads / 32];
  const TileGeom g = tile_geom(p);
  float cr[kMaxRows], cg[kMaxRows], cb[kMaxRows];
  walk_tile<kMode>(p, g, cr, cg, cb);
  const size_t plane = (size_t)p.Hp * p.Wp;
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxRows; ++j) {
    if (j < g.nrows) {
      const size_t o = pixel(p, g, j);
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

// K4: one thread per (candidate, splat n <= N); n == N writes the sentinel
// column. The expressions and their order are _prep_turbo_kernel's.
__global__ void prep_fast_kernel(const float* __restrict__ g9, float* __restrict__ ff,
                                 int* __restrict__ fi, int B, int N, float maxx, float maxy,
                                 float k_sigma, float cull_eps, float log_eps) {
  const int N1 = N + 1;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * N1) return;
  const int b = (int)(i / N1);
  const int n = (int)(i - (long long)b * N1);
  float* fb = ff + (size_t)b * kNFeat * N1;
  const float neg_inf = __int_as_float(0xff800000);
  if (n == N) {  // exact no-op under the fast walk
#pragma unroll
    for (int r = 0; r < kNFeat; ++r) {
      fb[(size_t)r * N1 + N] = r == F_A ? neg_inf
                               : (r == F_X0 || r == F_Y0) ? 1e9f
                               : (r == F_X1 || r == F_Y1) ? -1e9f
                                                          : 0.0f;
    }
    return;
  }
  const float* g = g9 + ((size_t)b * N + n) * 9;
  const float inv255 = (float)(1.0 / 255.0);  // as the JAX package folds (1.0 / 255.0)
  const float cx = fminf(fmaxf(g[0], 0.0f), 1.0f) * maxx;
  const float cy = fminf(fmaxf(g[1], 0.0f), 1.0f) * maxy;
  const float l11 = fmaxf(expf(g[2]), 1e-6f);
  const float l22 = fmaxf(expf(g[3]), 1e-6f);
  const float l21 = g[4];
  const float a = fminf(fmaxf(g[8], 0.0f), 255.0f) * inv255;
  const float r2 = 2.0f * (logf(fmaxf(a, 1e-38f)) - log_eps);
  const float r = fminf(sqrtf(fmaxf(r2, 0.0f)), k_sigma);
  const float hx = fmaxf(r * l11, 1.0f);
  const float hy = fmaxf(r * sqrtf(l21 * l21 + l22 * l22), 1.0f);
  const bool live = a > cull_eps;
  // dead splats: x0 = 1 > x1 = -1 empties the tile range too
  const float x0 = live ? floorf(fminf(fmaxf(cx - hx, 0.0f), maxx)) : 1.0f;
  const float x1 = live ? ceilf(fminf(fmaxf(cx + hx, 0.0f), maxx)) : -1.0f;
  const float y0 = floorf(fminf(fmaxf(cy - hy, 0.0f), maxy));
  const float y1 = ceilf(fminf(fmaxf(cy + hy, 0.0f), maxy));
  const float inv11 = 1.0f / l11;
  const float inv22 = 1.0f / l22;
  const float inv21 = -l21 * (inv11 * inv22);
  // the constants rounded from double, as the JAX package folds them
  const float half_log2e = (float)(-0.5 * 1.4426950408889634);
  const float neg_log2e = (float)(-1.4426950408889634);
  const float rows[kNFeat] = {
      cx,
      cy,
      half_log2e * (inv11 * inv11 + inv21 * inv21),
      neg_log2e * (inv21 * inv22),
      half_log2e * (inv22 * inv22),
      fminf(fmaxf(g[5], 0.0f), 255.0f) * inv255,
      fminf(fmaxf(g[6], 0.0f), 255.0f) * inv255,
      fminf(fmaxf(g[7], 0.0f), 255.0f) * inv255,
      a > 0.0f ? log2f(fmaxf(a, 1e-38f)) : neg_inf,
      x0 - 1.0f,
      x1 + 1.0f,
      y0 - 1.0f,
      y1 + 1.0f,
  };
#pragma unroll
  for (int r = 0; r < kNFeat; ++r) fb[(size_t)r * N1 + n] = rows[r];
  int* ib = fi + (size_t)b * 4 * N;
  ib[n] = (int)x0;
  ib[N + n] = (int)x1;
  ib[2 * N + n] = (int)y0;
  ib[3 * N + n] = (int)y1;
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

// mode: 0 exact (K2), 1 fast (K3); the canvas has no bf16 mode. init may be
// null (start from the background); it must not alias canvas.
int ggs_walk_render(int mode, const int* cnt, const int* idx, const float* feats, const float* init,
                    float* canvas, int B, int T, int L, int N1, int n_tx, int tile_h, int tile_w,
                    int Hp, int Wp, float bg0, float bg1, float bg2, void* stream) {
  if (!ggs::geometry_ok(tile_h, tile_w)) return (int)cudaErrorInvalidValue;
  if (B * T == 0) return 0;
  ggs::WalkParams p{cnt, idx, feats, init, T, L, N1, n_tx, tile_h, tile_w, Hp, Wp, bg0, bg1, bg2};
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case ggs::kExact: ggs::render_kernel<ggs::kExact><<<B * T, ggs::kThreads, 0, s>>>(p, canvas); break;
    case ggs::kFast: ggs::render_kernel<ggs::kFast><<<B * T, ggs::kThreads, 0, s>>>(p, canvas); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// mode: 0 exact (K1), 1 fast (K3), 2 bf16 (K1-bf16); init may be null
int ggs_walk_fitness(int mode, const int* cnt, const int* idx, const float* feats,
                     const float* init, const float* target, const float* w, float* partials,
                     int B, int T, int L, int N1, int n_tx, int tile_h, int tile_w, int Hp, int Wp,
                     float bg0, float bg1, float bg2, void* stream) {
  if (!ggs::geometry_ok(tile_h, tile_w)) return (int)cudaErrorInvalidValue;
  if (B * T == 0) return 0;
  ggs::WalkParams p{cnt, idx, feats, init, T, L, N1, n_tx, tile_h, tile_w, Hp, Wp, bg0, bg1, bg2};
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case ggs::kExact:
      ggs::fitness_kernel<ggs::kExact><<<B * T, ggs::kThreads, 0, s>>>(p, target, w, partials);
      break;
    case ggs::kFast:
      ggs::fitness_kernel<ggs::kFast><<<B * T, ggs::kThreads, 0, s>>>(p, target, w, partials);
      break;
    case ggs::kBf16:
      ggs::fitness_kernel<ggs::kBf16><<<B * T, ggs::kThreads, 0, s>>>(p, target, w, partials);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int ggs_prep_fast(const float* g9, float* ff, int* fi, int B, int N, float maxx, float maxy,
                  float k_sigma, float cull_eps, float log_eps, void* stream) {
  const long long n = (long long)B * (N + 1);
  if (n == 0) return 0;
  const int threads = 256;
  const int blocks = (int)((n + threads - 1) / threads);
  ggs::prep_fast_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      g9, ff, fi, B, N, maxx, maxy, k_sigma, cull_eps, log_eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
