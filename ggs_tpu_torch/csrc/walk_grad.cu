// Backward tile walks for Hopper (sm_90a): the exact analytic gradient of
// the painter-order "over" composite, per (image, tile), with two heads.
//
//   K6 (ggs_grad_walk, fused = 0) replaces the Pallas kernel
//      _bwd_tile_kernel(fused=False) (ggs_tpu/ops/render_grad.py, pallas_call
//      in _make_screen_render.bwd_grads): takes the image cotangent
//      g [B, 3, Hp, Wp] and writes the 9 parameter gradients of every listed
//      splat. A chained pass (render_cuda.MAX_SPLATS splats at a time) starts
//      from the previous pass's canvas, init [B, 3, Hp, Wp], and then also
//      writes that canvas's cotangent dinit = g * T_total, T_total the
//      transmittance through the pass's whole list at the pixel
//      (render_grad.py:76-79, 289-292), again with no division.
//   K7 (ggs_grad_walk, fused = 1) replaces _bwd_tile_kernel(fused=True)
//      (pallas_call in _make_screen_lossgrad.run): renders the tile, forms
//      the weighted-SSE partial num = sum_px w * |clip(C) - target|^2 and
//      the cotangent g = scale * w * (clip(C) - target) on chip (straight
//      through the clamp, as the Pallas head does), then runs the same
//      backward walk.
//
// The walk (raw table, render_pallas._splat_feats): for k < cnt[b,t] with
// s = idx[b,t,k], per pixel (x, y) inside the splat's integer box,
//   qx = x - cx, qy = y - cy
//   e  = exp(-0.5 * (sxx*(qx*qx) + 2*sxy*(qx*qy) + syy*(qy*qy))), f = a*e
//   C_k = (1 - f) C_{k-1} + f c.
// This is K2's walk with the power-of-two fold undone, so every f32 value
// equals K2's. The gradients (render_grad.py:249-277), with the suffix
// transmittance T_k = prod_{j>k} (1 - f_j) carried multiplicatively:
//   gT = g*T;  dL/df = sum_ch gT_ch (c_ch - C_{k-1,ch})
//   d rc,gc,bc = sum gT_ch f;  d a = sum dL/df e;  dq = -0.5 f dL/df
//   d cx = sum dq*(-2)*(sxx qx + sxy qy);  d cy = sum dq*(-2)*(syy qy + sxy qx)
//   d sxx = sum dq qx qx;  d sxy = sum dq*2 qx qy;  d syy = sum dq qy qy.
// No division anywhere: f is exactly 1 for alpha 255 at a centre, so the
// prefix canvas C_{k-1} is not recovered from C_k by dividing by (1 - f).
// Instead a two-level replay: pass A walks forward and stores the canvas
// at every kChunk-splat boundary; then, chunk by chunk from the last, B1
// replays the chunk from its boundary storing each splat's prefix canvas,
// and B2 walks the chunk backward.
//
// Design. One block of 256 threads per (image, 16x128 tile); a thread owns
// one column and kRows = 8 rows (rows row0 + 2r), and keeps their canvas,
// T and g in registers. Boundary and prefix canvases do not fit shared
// memory (the boundaries of one tile take 24 KB per 32 splats), so they
// live in device-memory scratch that the wrapper sizes from the lists'
// length L (>= every cnt, known to the host without a sync): one slot per
// resident block, the grid strides over the (image, tile)
// items, so scratch grows with the card, not with B. Prefix canvases are
// stored and read only inside the splat's box. Each (splat, tile) gives 9
// sums over the tile's pixels: per thread over its rows, a warp shuffle
// tree, then the 8 warps in order through shared memory, written to
// per-tile partials [B, T, 9, N] that the wrapper zeroes; a second kernel
// sums them over T in order. No atomics: the same bits on every launch.
//
// What bounds it: the arithmetic of three walks (pass A, B1, B2: about 23 +
// 23 + 58 f32 operations and three exps per (splat, pixel) pair in the box)
// and the prefix-canvas round trip through device memory (12 bytes written
// and read per pair). Build with -fmad=false and without fast math, as
// walk.cu: K7's num then equals K1's partial on the same lists.

#include <cuda_runtime.h>

namespace ggs_grad {

constexpr int kThreads = 256;  // threads per block
constexpr int kTileW = 128;    // tile width: one column per thread, 2 rows per pass
constexpr int kRowStride = kThreads / kTileW;
constexpr int kRows = 8;       // rows a thread owns
constexpr int kTileH = kRows * kRowStride;  // 16
constexpr int kTilePx = kTileH * kTileW;
constexpr int kChunk = 32;     // splats per stored boundary canvas
constexpr int kNFeat = 13;
constexpr int kNGrad = 9;
constexpr int kWarps = kThreads / 32;

// rows of the raw parameter table (render_pallas._splat_feats)
enum { F_CX, F_CY, F_SXX, F_SXY, F_SYY, F_R, F_G, F_B, F_A, F_X0, F_X1, F_Y0, F_Y1 };

struct GradParams {
  const int* cnt;       // [B, T]
  const int* idx;       // [B, T, L] ascending splat indices
  const float* feats;   // [B, 13, N1] raw table
  const float* gimg;    // K6: image cotangent [B, 3, Hp, Wp]
  const float* init;    // K6: the canvas to start from [B, 3, Hp, Wp], or null: the background
  float* dinit;         // K6 with init: its cotangent [B, 3, Hp, Wp]
  const float* target;  // K7: [3, Hp, Wp]
  const float* w;       // K7: [Hp, Wp], 0 on the padding
  float scale;          // K7: cotangent scale
  float* num;           // K7: [B, T] weighted-SSE partials
  float* gpart;         // [B, T, 9, N] per-tile gradients, zeroed by the caller
  float* scratch;       // per slot: max_chunks boundary + kChunk prefix canvases
  int max_chunks;
  int B, T, L, N1, N, n_tx, Hp, Wp;
  float bg0, bg1, bg2;
};

struct Splat {
  float cx, cy, sxx, sxy, syy, rc, gc, bc, a, x0, x1, y0, y1;
};

__device__ __forceinline__ Splat load_splat(const float (&sf)[kNFeat][kChunk], int j) {
  return Splat{sf[F_CX][j], sf[F_CY][j], sf[F_SXX][j], sf[F_SXY][j], sf[F_SYY][j],
               sf[F_R][j],  sf[F_G][j],  sf[F_B][j],   sf[F_A][j],   sf[F_X0][j],
               sf[F_X1][j], sf[F_Y0][j], sf[F_Y1][j]};
}

// e = exp(-0.5 * quad) in the unfolded form of render_grad's masked_exp
__device__ __forceinline__ float splat_exp(const Splat& s, float qx, float txx, float qy) {
  float quad = txx + (2.0f * s.sxy) * (qx * qy);
  quad = quad + s.syy * (qy * qy);
  return expf(-0.5f * quad);
}

template <bool kFused>
__global__ void __launch_bounds__(kThreads) grad_kernel(GradParams p) {
  __shared__ float sf[kNFeat][kChunk];
  __shared__ int ss[kChunk];
  __shared__ float red[kWarps][kChunk][kNGrad];
  __shared__ float nred[kWarps];

  const int col = threadIdx.x % kTileW;
  const int row0 = threadIdx.x / kTileW;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t plane = (size_t)p.Hp * p.Wp;
  float* bound = p.scratch + (size_t)blockIdx.x * (size_t)(p.max_chunks + kChunk) * 3 * kTilePx;
  float* cprev = bound + (size_t)p.max_chunks * 3 * kTilePx;

  for (int bt = blockIdx.x; bt < p.B * p.T; bt += gridDim.x) {
    const int b = bt / p.T;
    const int t = bt - b * p.T;
    const int tx0 = (t % p.n_tx) * kTileW;
    const int ty0 = (t / p.n_tx) * kTileH;
    const float xf = (float)(tx0 + col);
    const float ybase = (float)(ty0 + row0);
    const int n = p.cnt[bt];
    const int n_chunks = (n + kChunk - 1) / kChunk;
    const int* list = p.idx + (size_t)bt * p.L;
    const float* fb = p.feats + (size_t)b * kNFeat * p.N1;

    // stage chunk c's splat parameters; returns its length
    auto stage = [&](int c) -> int {
      const int m = min(kChunk, n - c * kChunk);
      __syncthreads();  // the previous chunk (and red / nred) are consumed
      for (int e = threadIdx.x; e < kNFeat * kChunk; e += kThreads) {
        const int r = e / kChunk;
        const int j = e - r * kChunk;
        if (j < m) {
          const int s = list[c * kChunk + j];
          sf[r][j] = fb[(size_t)r * p.N1 + s];
          if (r == 0) ss[j] = s;
        }
      }
      __syncthreads();
      return m;
    };

    // ---- pass A: forward from the background or the init canvas,
    // boundary canvas per chunk
    float cr[kRows], cg[kRows], cb[kRows];
    const float* ib = p.init ? p.init + (size_t)b * 3 * plane : nullptr;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (ib) {
        const size_t o = (size_t)(ty0 + row0 + r * kRowStride) * p.Wp + tx0 + col;
        cr[r] = ib[o];
        cg[r] = ib[plane + o];
        cb[r] = ib[2 * plane + o];
      } else {
        cr[r] = p.bg0;
        cg[r] = p.bg1;
        cb[r] = p.bg2;
      }
    }
    for (int c = 0; c < n_chunks; ++c) {
      float* bc0 = bound + (size_t)c * 3 * kTilePx;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int o = (row0 + r * kRowStride) * kTileW + col;
        bc0[o] = cr[r];
        bc0[kTilePx + o] = cg[r];
        bc0[2 * kTilePx + o] = cb[r];
      }
      const int m = stage(c);
      for (int j = 0; j < m; ++j) {
        const Splat s = load_splat(sf, j);
        if (!(xf >= s.x0 && xf <= s.x1)) continue;
        const float qx = xf - s.cx;
        const float txx = s.sxx * (qx * qx);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float yf = ybase + (float)(r * kRowStride);
          if (yf >= s.y0 && yf <= s.y1) {
            const float f = s.a * splat_exp(s, qx, txx, yf - s.cy);
            const float omf = 1.0f - f;
            cr[r] = omf * cr[r] + f * s.rc;
            cg[r] = omf * cg[r] + f * s.gc;
            cb[r] = omf * cb[r] + f * s.bc;
          }
        }
      }
    }

    // ---- the image cotangent: K7's loss head, or K6's input
    float g0[kRows], g1[kRows], g2[kRows], T[kRows];
    if constexpr (kFused) {
      float acc = 0.0f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const size_t o = (size_t)(ty0 + row0 + r * kRowStride) * p.Wp + tx0 + col;
        const float dr = fminf(fmaxf(cr[r], 0.0f), 1.0f) - p.target[o];
        const float dg = fminf(fmaxf(cg[r], 0.0f), 1.0f) - p.target[plane + o];
        const float db = fminf(fmaxf(cb[r], 0.0f), 1.0f) - p.target[2 * plane + o];
        const float wo = p.w[o];
        acc = acc + (dr * dr + dg * dg + db * db) * wo;
        const float sw = p.scale * wo;
        g0[r] = sw * dr;
        g1[r] = sw * dg;
        g2[r] = sw * db;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc = acc + __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) nred[warp] = acc;
      __syncthreads();
      if (threadIdx.x == 0) {
        float s = 0.0f;
        for (int i = 0; i < kWarps; ++i) s = s + nred[i];
        p.num[bt] = s;
      }
    } else {
      const float* gb = p.gimg + (size_t)b * 3 * plane;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const size_t o = (size_t)(ty0 + row0 + r * kRowStride) * p.Wp + tx0 + col;
        g0[r] = gb[o];
        g1[r] = gb[plane + o];
        g2[r] = gb[2 * plane + o];
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) T[r] = 1.0f;

    // ---- pass B: the chunks from the last to the first
    float* gout = p.gpart + (size_t)bt * kNGrad * p.N;
    for (int c = n_chunks - 1; c >= 0; --c) {
      const int m = stage(c);
      const float* bc0 = bound + (size_t)c * 3 * kTilePx;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int o = (row0 + r * kRowStride) * kTileW + col;
        cr[r] = bc0[o];
        cg[r] = bc0[kTilePx + o];
        cb[r] = bc0[2 * kTilePx + o];
      }
      // B1: replay, storing each splat's prefix canvas inside its box
      for (int j = 0; j < m; ++j) {
        const Splat s = load_splat(sf, j);
        if (!(xf >= s.x0 && xf <= s.x1)) continue;
        const float qx = xf - s.cx;
        const float txx = s.sxx * (qx * qx);
        float* cp = cprev + (size_t)j * 3 * kTilePx;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float yf = ybase + (float)(r * kRowStride);
          if (yf >= s.y0 && yf <= s.y1) {
            const int o = (row0 + r * kRowStride) * kTileW + col;
            cp[o] = cr[r];
            cp[kTilePx + o] = cg[r];
            cp[2 * kTilePx + o] = cb[r];
            const float f = s.a * splat_exp(s, qx, txx, yf - s.cy);
            const float omf = 1.0f - f;
            cr[r] = omf * cr[r] + f * s.rc;
            cg[r] = omf * cg[r] + f * s.gc;
            cb[r] = omf * cb[r] + f * s.bc;
          }
        }
      }
      // B2: walk the chunk backward
      for (int j = m - 1; j >= 0; --j) {
        const Splat s = load_splat(sf, j);
        float acc[kNGrad];
#pragma unroll
        for (int i = 0; i < kNGrad; ++i) acc[i] = 0.0f;
        bool any = false;
        if (xf >= s.x0 && xf <= s.x1) {
          const float qx = xf - s.cx;
          const float txx = s.sxx * (qx * qx);
          const float* cp = cprev + (size_t)j * 3 * kTilePx;
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float yf = ybase + (float)(r * kRowStride);
            if (yf >= s.y0 && yf <= s.y1) {
              any = true;
              const int o = (row0 + r * kRowStride) * kTileW + col;
              const float qy = yf - s.cy;
              const float e = splat_exp(s, qx, txx, qy);
              const float f = s.a * e;
              const float gT0 = g0[r] * T[r];
              const float gT1 = g1[r] * T[r];
              const float gT2 = g2[r] * T[r];
              const float dLdf = (gT0 * (s.rc - cp[o]) + gT1 * (s.gc - cp[kTilePx + o])) +
                                 gT2 * (s.bc - cp[2 * kTilePx + o]);
              const float dLdq = (-0.5f * f) * dLdf;
              acc[0] = acc[0] + (dLdq * -2.0f) * (s.sxx * qx + s.sxy * qy);
              acc[1] = acc[1] + (dLdq * -2.0f) * (s.syy * qy + s.sxy * qx);
              acc[2] = acc[2] + (dLdq * qx) * qx;
              acc[3] = acc[3] + ((dLdq * 2.0f) * qx) * qy;
              acc[4] = acc[4] + (dLdq * qy) * qy;
              acc[5] = acc[5] + gT0 * f;
              acc[6] = acc[6] + gT1 * f;
              acc[7] = acc[7] + gT2 * f;
              acc[8] = acc[8] + dLdf * e;
              T[r] = T[r] * (1.0f - f);
            }
          }
        }
        if (__any_sync(0xffffffffu, any)) {
#pragma unroll
          for (int i = 0; i < kNGrad; ++i) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              acc[i] = acc[i] + __shfl_xor_sync(0xffffffffu, acc[i], off);
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int i = 0; i < kNGrad; ++i) red[warp][j][i] = acc[i];
        }
      }
      __syncthreads();
      for (int e = threadIdx.x; e < m * kNGrad; e += kThreads) {
        const int j = e / kNGrad;
        const int i = e - j * kNGrad;
        float s = 0.0f;
        for (int w = 0; w < kWarps; ++w) s = s + red[w][j][i];
        gout[(size_t)i * p.N + ss[j]] = s;
      }
    }
    if (p.dinit) {  // T now holds T_total
      float* db = p.dinit + (size_t)b * 3 * plane;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const size_t o = (size_t)(ty0 + row0 + r * kRowStride) * p.Wp + tx0 + col;
        db[o] = g0[r] * T[r];
        db[plane + o] = g1[r] * T[r];
        db[2 * plane + o] = g2[r] * T[r];
      }
    }
    __syncthreads();  // nred and red are free for the next item
  }
}

// out[b, m] = sum_t gpart[b, t, m], t in order
__global__ void tile_sum_kernel(const float* __restrict__ gpart, float* __restrict__ out, int B,
                                int T, int M) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * M) return;
  const size_t b = i / M;
  const size_t m = i - b * M;
  const float* src = gpart + b * (size_t)T * M + m;
  float s = 0.0f;
  for (int t = 0; t < T; ++t) s = s + src[(size_t)t * M];
  out[i] = s;
}

}  // namespace ggs_grad

extern "C" {

int ggs_grad_tile_h() { return ggs_grad::kTileH; }

int ggs_grad_tile_w() { return ggs_grad::kTileW; }

int ggs_grad_chunk() { return ggs_grad::kChunk; }

// Blocks of the walk kernel the current card holds at once (the scratch
// slots the caller allocates); <= 0 is a CUDA error code, negated.
int ggs_grad_resident_blocks(int fused) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = fused ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &per_sm, ggs_grad::grad_kernel<true>, ggs_grad::kThreads, 0)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &per_sm, ggs_grad::grad_kernel<false>, ggs_grad::kThreads, 0);
  if (err != cudaSuccess) return -(int)err;
  return sms * per_sm;
}

// K6 (fused = 0: gimg, and init -> dinit where init is not null) or K7
// (fused = 1: target, w, scale -> num; no init), then the in-order sum over
// tiles: grads [B, 9, N] = sum_t gpart[:, t].
int ggs_grad_walk(int fused, const int* cnt, const int* idx, const float* feats, const float* gimg,
                  const float* init, float* dinit, const float* target, const float* w,
                  float scale, float* num, float* gpart,
                  float* grads, float* scratch, int slots, int max_chunks, int B, int T, int L,
                  int N1, int N, int n_tx, int Hp, int Wp, float bg0, float bg1, float bg2,
                  void* stream) {
  if (B * T == 0) return 0;
  if (slots <= 0 || N <= 0 || Hp % ggs_grad::kTileH || Wp % ggs_grad::kTileW ||
      (fused && init) || (!init != !dinit))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  ggs_grad::GradParams p{cnt,   idx,   feats,   gimg,       init, dinit, target, w,
                         scale, num,   gpart,   scratch,    max_chunks, B, T, L,
                         N1,    N,     n_tx,    Hp,         Wp,   bg0,   bg1,    bg2};
  const int grid = B * T < slots ? B * T : slots;
  if (fused)
    ggs_grad::grad_kernel<true><<<grid, ggs_grad::kThreads, 0, st>>>(p);
  else
    ggs_grad::grad_kernel<false><<<grid, ggs_grad::kThreads, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int M = ggs_grad::kNGrad * N;
  const long long total = (long long)B * M;
  ggs_grad::tile_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(gpart, grads, B, T, M);
  return (int)cudaGetLastError();
}

}  // extern "C"
