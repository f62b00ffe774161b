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
// Finally C is clamped to [0, 1] in f32. With f = 0 the blend is an exact
// no-op in every mode ((1-0)*C + 0*c == C, C + 0*(c-C) == C), so a pixel
// outside the box may take it or skip it without changing a bit. f is taken
// as 0 outside the box by a select, never by a multiply with a 0/1 mask,
// which would turn an inf from exp of a badly cancelled quadratic into NaN
// (mode 1: exp2f(-inf) = 0 for alpha 0 and the sentinel, which is why no
// ex2.approx). Build with -fmad=false and without fast math: every product
// and sum is rounded on its own, as in the plain PyTorch versions, and
// expf/exp2f/logf/log2f are the accurate ones.
//
// Mode 2 runs on packed bf16x2: a thread's rows (0, 1) and (2, 3) share one
// register per channel, and every bf16 product, sum and difference is one
// mul/add/sub.rn.bf16x2 (the _rn intrinsics: never contracted into an fma,
// so R(R(omf*C) + R(f*c)) keeps its roundings). For bf16 operands the
// correctly rounded bf16 result of +, - and * equals the f32 result rounded
// to bf16, since f32's 24 bits are at least 2*8 + 2 (double rounding is
// innocuous, subnormals included: tests/test_torch_bf16_pairs.py), which is
// what torch computes for the plain version. qy is formed in f32 and packed
// with one rounding, and exp stays f32 per pixel on the bf16 value.
//
// What bounds the walks on the card: instruction issue, then latency. Each
// (splat, pixel) pair inside the box costs one exp and about 20-30 other
// operations, and under -fmad=false each multiply and add is an instruction
// of its own, so a SM issues at most 128 of them a clock: about half the f32
// peak, which counts an FMA as two. Against that a tile's list and table are
// a few KB. The SMs issue on roughly three clocks in four; in the rest every
// warp waits on its splat's loads or branches, all the more where few blocks
// share a SM (PERF.md). So the design takes out of the pixel slot whatever is
// the same for a whole warp or block, and gives a splat one wait on shared
// memory. The work unit is a sub-tile, not the
// list tile: a block of 128 threads walks kRows = 4 rows x 128 columns of one
// list tile (tile_h a multiple of 4: S = tile_h / 4 sub-tiles, B * T * S
// blocks), each thread one column and four rows, carrying their canvas (12
// floats, 6 bf16x2 registers in mode 2) in registers for the whole walk, so
// many blocks are resident on a SM. Every sub-tile of a tile walks the
// tile's whole list, but a splat whose rows miss the sub-tile's four is
// dropped while it is staged (a ballot compaction that keeps ascending
// order: measured faster than a block-uniform test per splat, PERF.md), and
// one whose columns miss a warp's 32 costs that warp a warp-uniform test.
// A kept splat's row terms (qy and the quadratic's qy^2 part for each of the
// four rows) depend only on the splat and the sub-tile, so they are computed
// once while it is staged, with the walk's own operations in its order, and
// the pixels read them. The four rows then run without a branch, in one of
// three forms chosen per splat: where the box holds the sub-tile's rows
// (block-uniform) and the warp's 32 columns (warp-uniform), f = e with no
// test; where it holds the rows only, a select on the column; elsewhere the
// select per pixel, f = 0 outside the box. The arithmetic and its rounding
// are the same in all three, so the canvas keeps its bits whichever runs,
// and the four rows' dependent chains interleave in each. The
// list's splat parameters are staged through shared memory kChunk splats at
// a time, in records that each thread reads whole by 16-byte loads before
// any test, so a splat costs one round trip to shared memory, not two;
// double-buffered and two deep: each thread loads its share of the next
// chunk's parameters, and the list entry of the one after, while the block
// walks the current one.
//
// K1's sum is fixed-order, with no atomics on values: each thread sums its
// rows in order, then a warp shuffle tree, then the 4 warps in order give the
// sub-tile's partial; the S sub-tiles of a tile are summed in index order in
// the same launch by the block that finishes last, which a per-tile ticket
// counter names (an atomic on the counter, which that block resets to 0 for
// the next launch). So fitness is the same bits on every launch.
//
// ptxas (sm_90a, -O3 -fmad=false) on the H100 run recorded in PERF.md:
// fitness_kernel<0/1/2> 63/64/59 registers and render_kernel<0/1> 63/64 (the
// launch bound caps them at 64 for 8 blocks a SM), 5 KB of static shared
// memory (4 KB in mode 2), no spills.
//
// K4 is elementwise, one thread per (candidate, splat), reading the
// [B, N, 9] genome in place (no transpose copy): a few dozen operations
// against 36 bytes in and 68 out a splat, so bytes and the launch bound it.
// Staging a block's contiguous genome rows in shared memory by 16-byte
// loads instead was measured slower on the H100 (device time 2.96 against
// 1.98 us at B=32, 10.46 against 9.19 us at B=512, where this kernel is at
// 89% of its bound; PERF.md): the strided loads of neighbouring threads
// already share their cache lines.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ggs {

constexpr int kTileW = 128;        // list tile width: one column per thread
constexpr int kThreads = kTileW;   // threads per block
constexpr int kRows = 4;           // rows a thread owns: the sub-tile's height
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;         // list entries staged per pass
constexpr int kNFeat = 13;         // rows of the parameter table
constexpr int kPer = (kNFeat + kWarps - 1) / kWarps;  // table rows a thread stages
constexpr int kMinBlocks = 8;      // resident blocks a SM the registers must allow

// rows of the parameter table (render_pallas._splat_feats_fast / _turbo)
enum { F_CX, F_CY, F_SXX, F_SXY, F_SYY, F_R, F_G, F_B, F_A, F_X0, F_X1, F_Y0, F_Y1 };
enum { kExact = 0, kFast = 1, kBf16 = 2 };

static_assert(kChunk == 32 && kThreads % kChunk == 0, "a warp stages one chunk's entries");

struct WalkParams {
  const int* cnt;      // [B, T]
  const int* idx;      // [B, T, L] ascending splat indices
  const float* feats;  // [B, 13, N1]
  const float* init;   // [B, 3, Hp, Wp] the canvas to start from, or null: the background
  int T, S, L, N1;
  int n_tx, tile_h, Hp, Wp;
  float bg0, bg1, bg2;
};

// A kept splat's shared-memory record, in float4s: the box (x0 x1 y0 y1);
// then (cx nsxx nsxy a) and (r g b -); then its row terms over the
// sub-tile's four rows, which only the splat and the row decide
// (row_terms): modes 0 and 1 a float4 of qy and one of the quadratic's row
// part, mode 2 one float4 of their bf16x2 pairs. cy and nsyy enter the row
// terms only.
template <int kMode>
constexpr int kRec = kMode == kBf16 ? 4 : 5;
enum { R_BOX, R_SPLAT, R_COLOUR, R_ROWS };
// a table row's float slot in the record, or -1 (cy, nsyy)
__host__ __device__ constexpr int slot(int r) {
  return r >= F_X0 ? r - F_X0 : r == F_CX ? 4 : r == F_SXX || r == F_SXY ? r + 3 : r == F_A ? 7
       : r >= F_R ? r + 3 : -1;
}
static_assert(slot(F_SXX) == 5 && slot(F_SXY) == 6 && slot(F_R) == 8 && slot(F_B) == 10,
              "(cx nsxx nsxy a) and (r g b -) are the record's float4s 1 and 2");

// Which rows and columns of a warp's 4 x 32 pixels a splat's box covers:
// all of them (f = e, no select), all 4 rows but not every column (a
// select on the column), or not every row (the select per pixel).
enum Cover { kAll, kRowsIn, kPartial };

// This block's sub-tile: list tile bt = b * T + t, sub-tile `sub` of its S,
// rows ry0 .. ry0 + 3; the thread's column col, its pixel in row 0 at px.
struct SubTile {
  int bt, b, sub, col, lane, warp, tx0, ry0;
  size_t px;
};

__device__ __forceinline__ SubTile sub_tile(const WalkParams& p) {
  SubTile g;
  g.bt = blockIdx.x / p.S;
  g.sub = blockIdx.x - g.bt * p.S;
  g.b = g.bt / p.T;
  const int t = g.bt - g.b * p.T;
  g.col = threadIdx.x;
  g.lane = g.col & 31;
  g.warp = g.col >> 5;
  g.tx0 = (t % p.n_tx) * kTileW;
  g.ry0 = (t / p.n_tx) * p.tile_h + g.sub * kRows;
  g.px = (size_t)g.ry0 * p.Wp + g.tx0 + g.col;
  return g;
}

using bf2 = __nv_bfloat162;

// bf16x2 arithmetic, each half correctly rounded; never contracted
__device__ __forceinline__ bf2 bmul(bf2 a, bf2 b) { return __hmul2_rn(a, b); }
__device__ __forceinline__ bf2 badd(bf2 a, bf2 b) { return __hadd2_rn(a, b); }
__device__ __forceinline__ bf2 bsub(bf2 a, bf2 b) { return __hsub2_rn(a, b); }

// each half of v where its flag is set, +0 elsewhere: a select of bits
__device__ __forceinline__ bf2 bsel(bf2 v, bool lo, bool hi) {
  unsigned u = *reinterpret_cast<const unsigned*>(&v);
  u &= (lo ? 0x0000ffffu : 0u) | (hi ? 0xffff0000u : 0u);
  return *reinterpret_cast<const bf2*>(&u);
}

__device__ __forceinline__ bf2 bsplat(float x) { return __float2bfloat162_rn(x); }

// a bf16x2 pair carried in a float's bits through shared memory, and back
__device__ __forceinline__ float bfloat(bf2 v) { return *reinterpret_cast<const float*>(&v); }
__device__ __forceinline__ bf2 bpair(float v) { return *reinterpret_cast<const bf2*>(&v); }

// The canvas of a thread's four rows: f32 in modes 0 and 1, rows (0, 1) and
// (2, 3) packed in mode 2.
template <int kMode>
struct Canvas {
  float r[kRows], g[kRows], b[kRows];
};
template <>
struct Canvas<kBf16> {
  bf2 r[2], g[2], b[2];
};

// A kept splat's row terms over rows yb .. yb + 3, in the record's float4s
// from R_ROWS on: the walk's own operations in its own order, so each
// pixel's quadratic keeps its bits. Mode 0: qy = y - cy and nsyy*(qy*qy);
// mode 1: qy and (nsyy*(qy*qy) + log2a), the exp2's innermost sum; mode 2:
// qy rounded to bf16 (rows (0, 1) and (2, 3) packed) and bf16
// nsyy*(qy*qy).
template <int kMode>
__device__ __forceinline__ void row_terms(float4* rec, float cy, float syy, float a, float yb) {
  if constexpr (kMode == kBf16) {
    const bf2 byy = bsplat(syy);
    float4 t;
    float* w = &t.x;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float ylo = yb + (float)(2 * h), yhi = ylo + 1.0f;  // the pair's rows
      const bf2 qy = __floats2bfloat162_rn(ylo - cy, yhi - cy);
      w[h] = bfloat(qy);
      w[2 + h] = bfloat(bmul(byy, bmul(qy, qy)));
    }
    rec[R_ROWS] = t;
  } else {
    float4 q, t;
    float* qv = &q.x;
    float* tv = &t.x;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      qv[r] = (yb + (float)r) - cy;
      tv[r] = syy * (qv[r] * qv[r]);
      if constexpr (kMode == kFast) tv[r] = tv[r] + a;
    }
    rec[R_ROWS] = q;
    rec[R_ROWS + 1] = t;
  }
}

// One splat over the thread's four rows (rows yb .. yb + 3 of column xf),
// from its record; bx is its box. Outside the box f = 0 by a select; kAll
// and kRowsIn drop the tests their cover makes true.
template <Cover kCover>
__device__ __forceinline__ void blend(Canvas<kExact>& C, const float4* rec, float4 bx, float xf,
                                      float yb) {
  const float4 s = rec[R_SPLAT], c = rec[R_COLOUR], qy = rec[R_ROWS], yy = rec[R_ROWS + 1];
  const float* qyr = &qy.x;
  const float* yyr = &yy.x;
  const bool inx = xf >= bx.x && xf <= bx.y;
  const float qx = xf - s.x;
  const float txx = s.y * (qx * qx);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float quad = txx + s.z * (qx * qyr[r]);
    quad = quad + yyr[r];
    const float e = expf(quad) * s.w;
    float f = e;
    if constexpr (kCover == kRowsIn) f = inx ? e : 0.0f;
    if constexpr (kCover == kPartial) {
      const float yf = yb + (float)r;
      f = (inx && yf >= bx.z && yf <= bx.w) ? e : 0.0f;
    }
    const float omf = 1.0f - f;
    C.r[r] = omf * C.r[r] + f * c.x;
    C.g[r] = omf * C.g[r] + f * c.y;
    C.b[r] = omf * C.b[r] + f * c.z;
  }
}

template <Cover kCover>
__device__ __forceinline__ void blend(Canvas<kFast>& C, const float4* rec, float4 bx, float xf,
                                      float yb) {
  const float4 s = rec[R_SPLAT], c = rec[R_COLOUR], qy = rec[R_ROWS], yt = rec[R_ROWS + 1];
  const float* qyr = &qy.x;
  const float* ytr = &yt.x;
  const bool inx = xf > bx.x && xf < bx.y;
  const float qx = xf - s.x;
  const float txx = s.y * (qx * qx);  // the sum's last add: hoisting changes no bit
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float inner = s.z * (qx * qyr[r]) + ytr[r];
    const float e = exp2f(txx + inner);
    float f = e;
    if constexpr (kCover == kRowsIn) f = inx ? e : 0.0f;
    if constexpr (kCover == kPartial) {
      const float yf = yb + (float)r;
      f = (inx && yf > bx.z && yf < bx.w) ? e : 0.0f;
    }
    C.r[r] = C.r[r] + f * (c.x - C.r[r]);
    C.g[r] = C.g[r] + f * (c.y - C.g[r]);
    C.b[r] = C.b[r] + f * (c.z - C.b[r]);
  }
}

template <Cover kCover>
__device__ __forceinline__ void blend(Canvas<kBf16>& C, const float4* rec, float4 bx, float xf,
                                      float yb) {
  const float4 s = rec[R_SPLAT], c = rec[R_COLOUR], rt = rec[R_ROWS];
  const float* rw = &rt.x;
  const bool inx = xf >= bx.x && xf <= bx.y;
  const bf2 qx = bsplat(xf - s.x);
  const bf2 txx = bmul(bsplat(s.y), bmul(qx, qx));
  const bf2 bxy = bsplat(s.z), ba = bsplat(s.w);
  const bf2 brc = bsplat(c.x), bgc = bsplat(c.y), bbc = bsplat(c.z);
  const bf2 one = bsplat(1.0f);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bf2 qy = bpair(rw[h]);
    bf2 quad = badd(txx, bmul(bxy, bmul(qx, qy)));
    quad = badd(quad, bpair(rw[2 + h]));
    const bf2 e = __floats2bfloat162_rn(expf(__low2float(quad)), expf(__high2float(quad)));
    bf2 f = bmul(e, ba);
    if constexpr (kCover == kRowsIn) f = bsel(f, inx, inx);
    if constexpr (kCover == kPartial) {
      const float ylo = yb + (float)(2 * h), yhi = ylo + 1.0f;  // the pair's rows
      f = bsel(f, inx && ylo >= bx.z && ylo <= bx.w, inx && yhi >= bx.z && yhi <= bx.w);
    }
    const bf2 omf = bsub(one, f);
    C.r[h] = badd(bmul(omf, C.r[h]), bmul(f, brc));
    C.g[h] = badd(bmul(omf, C.g[h]), bmul(f, bgc));
    C.b[h] = badd(bmul(omf, C.b[h]), bmul(f, bbc));
  }
}

template <int kMode>
__device__ __forceinline__ void start(Canvas<kMode>& C, const WalkParams& p, const SubTile& g) {
  const size_t plane = (size_t)p.Hp * p.Wp;
  const float* ib = p.init ? p.init + (size_t)g.b * 3 * plane + g.px : nullptr;
  if constexpr (kMode == kBf16) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (ib) {
        const float* i0 = ib + (size_t)(2 * h) * p.Wp;
        const float* i1 = i0 + p.Wp;
        C.r[h] = __floats2bfloat162_rn(i0[0], i1[0]);
        C.g[h] = __floats2bfloat162_rn(i0[plane], i1[plane]);
        C.b[h] = __floats2bfloat162_rn(i0[2 * plane], i1[2 * plane]);
      } else {
        C.r[h] = bsplat(p.bg0);
        C.g[h] = bsplat(p.bg1);
        C.b[h] = bsplat(p.bg2);
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (ib) {
        const float* ir = ib + (size_t)r * p.Wp;
        C.r[r] = ir[0];
        C.g[r] = ir[plane];
        C.b[r] = ir[2 * plane];
      } else {
        C.r[r] = p.bg0;
        C.g[r] = p.bg1;
        C.b[r] = p.bg2;
      }
    }
  }
}

// the clamped canvas of the thread's row r as f32
template <int kMode>
__device__ __forceinline__ float3 clamped(const Canvas<kMode>& C, int r) {
  float cr, cg, cb;
  if constexpr (kMode == kBf16) {
    const int h = r >> 1;
    cr = (r & 1) ? __high2float(C.r[h]) : __low2float(C.r[h]);
    cg = (r & 1) ? __high2float(C.g[h]) : __low2float(C.g[h]);
    cb = (r & 1) ? __high2float(C.b[h]) : __low2float(C.b[h]);
  } else {
    cr = C.r[r];
    cg = C.g[r];
    cb = C.b[r];
  }
  return make_float3(fminf(fmaxf(cr, 0.0f), 1.0f), fminf(fmaxf(cg, 0.0f), 1.0f),
                     fminf(fmaxf(cb, 0.0f), 1.0f));
}

// A splat's record, n float4s of shared memory at p, into r by 16-byte
// loads that stay where they stand, ahead of the skip test: one round trip to
// shared memory a splat. The compiler would sink plain loads below the test,
// into the paths that use them, so each splat would wait on two (measured
// slower, most where few warps share a SM to hide it; PERF.md).
template <int n>
__device__ __forceinline__ void load_record(float4* r, const float4* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
#pragma unroll
  for (int i = 0; i < n; ++i)
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(r[i].x), "=f"(r[i].y), "=f"(r[i].z), "=f"(r[i].w)
                 : "r"(a + 16u * i)
                 : "memory");
}

// Walks the tile's list over this block's sub-tile, leaving the canvas of
// the thread's four rows in C (unclamped).
template <int kMode>
__device__ __forceinline__ void walk_sub_tile(const WalkParams& p, const SubTile& g,
                                              Canvas<kMode>& C) {
  __shared__ float4 sf[2][kChunk][kRec<kMode>];

  start(C, p, g);
  const float xf = (float)(g.tx0 + g.col);
  const float yb = (float)g.ry0;
  const float ye = yb + (float)(kRows - 1);
  const float wx0 = (float)(g.tx0 + 32 * g.warp), wx1 = wx0 + 31.0f;  // the warp's columns
  const int n = p.cnt[g.bt];
  const int nch = (n + kChunk - 1) / kChunk;
  const int* list = p.idx + (size_t)g.bt * p.L;
  const float* fb = p.feats + (size_t)g.b * kNFeat * p.N1;

  // Staging, two deep: lane k of warp w stages table rows w, w + 4, ...
  // of the chunk's splat k, and only if the splat's rows meet the
  // sub-tile's: a ballot over the chunk's 32 entries gives each kept splat
  // its slot, in ascending order (every warp computes the same ballot from
  // the same entries). Every thread holds the splat's y0 and y1 for that
  // test, so warp 0, whose rows are cx, nsyy, a and y1, loads cy in y1's
  // place and writes the splat's row terms. entry(c) loads splat k's index
  // in chunk c; fetch() loads the parameters of the chunk whose index is
  // loaded; put(buf) stores the kept ones to shared memory and returns
  // their count. So neither load stalls the walk.
  int next = -1, cur = -1;
  float pv[kPer], ky0 = 0.0f, ky1 = 0.0f;
  auto entry = [&](int c) {
    const int k = c * kChunk + g.lane;
    next = (c < nch && k < n) ? list[k] : -1;
  };
  auto fetch = [&]() {
    cur = next;
    if (cur >= 0) {
      ky0 = fb[(size_t)F_Y0 * p.N1 + cur];
      ky1 = fb[(size_t)F_Y1 * p.N1 + cur];
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int r = g.warp + q * kWarps;
      if (cur >= 0 && r < kNFeat && r != F_Y0)
        pv[q] = fb[(size_t)(r == F_Y1 ? F_CY : r) * p.N1 + cur];
    }
  };
  auto put = [&](int buf) {
    const bool keep =
        cur >= 0 && (kMode == kFast ? ky0 < ye && ky1 > yb : !(ky1 < yb || ky0 > ye));
    const unsigned bal = __ballot_sync(0xffffffffu, keep);
    const int pos = __popc(bal & ((1u << g.lane) - 1u));
    float4* rec = sf[buf][pos];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int r = g.warp + q * kWarps;
      const float v = r == F_Y0 ? ky0 : r == F_Y1 ? ky1 : pv[q];
      if (keep && r < kNFeat && slot(r) >= 0) reinterpret_cast<float*>(rec)[slot(r)] = v;
    }
    static_assert(F_CX % kWarps == 0 && F_SYY % kWarps == 0 && F_A % kWarps == 0 &&
                      F_Y1 % kWarps == 0 && F_Y1 / kWarps == 3 && kPer == 4,
                  "warp 0 holds cx, nsyy, a and (in y1's place) cy");
    if (keep && g.warp == 0) row_terms<kMode>(rec, pv[3], pv[1], pv[2], yb);
    return __popc(bal);
  };

  entry(0);
  fetch();
  entry(1);
  for (int c = 0; c < nch; ++c) {
    const int buf = c & 1;
    const int m = put(buf);
    __syncthreads();  // chunk c is staged; chunk c - 1's walk is done with buf ^ 1
    fetch();
    entry(c + 2);
    for (int j = 0; j < m; ++j) {
      float4 rec[kRec<kMode>];
      load_record<kRec<kMode>>(rec, sf[buf][j]);
      const float4 bx = rec[R_BOX];  // x0 x1 y0 y1
      // warp-uniform: none of the warp's columns is in the box
      if (kMode == kFast ? !(bx.x < wx1 && bx.y > wx0) : bx.y < wx0 || bx.x > wx1) continue;
      // block-uniform: the box holds the sub-tile's 4 rows; warp-uniform:
      // and the warp's 32 columns
      const bool rows_in = kMode == kFast ? bx.z < yb && bx.w > ye : bx.z <= yb && bx.w >= ye;
      const bool cols_in = kMode == kFast ? bx.x < wx0 && bx.y > wx1 : bx.x <= wx0 && bx.y >= wx1;
      if (!rows_in)
        blend<kPartial>(C, rec, bx, xf, yb);
      else if (cols_in)
        blend<kAll>(C, rec, bx, xf, yb);
      else
        blend<kRowsIn>(C, rec, bx, xf, yb);
    }
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, kMinBlocks) render_kernel(WalkParams p,
                                                                      float* __restrict__ out) {
  const SubTile g = sub_tile(p);
  Canvas<kMode> C;
  walk_sub_tile<kMode>(p, g, C);
  const size_t plane = (size_t)p.Hp * p.Wp;
  float* ob = out + (size_t)g.b * 3 * plane + g.px;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float3 c = clamped(C, r);
    float* o = ob + (size_t)r * p.Wp;
    o[0] = c.x;
    o[plane] = c.y;
    o[2 * plane] = c.z;
  }
}

// sub [B * T * S]: the sub-tiles' partials; tickets [B * T]: 0 before the
// launch, and 0 again after it.
template <int kMode>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    fitness_kernel(WalkParams p, const float* __restrict__ target, const float* __restrict__ w,
                   float* __restrict__ partials, float* __restrict__ sub,
                   int* __restrict__ tickets) {
  __shared__ float red[kWarps];
  const SubTile g = sub_tile(p);
  Canvas<kMode> C;
  walk_sub_tile<kMode>(p, g, C);
  const size_t plane = (size_t)p.Hp * p.Wp;
  float acc = 0.0f;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float3 c = clamped(C, r);
    const size_t o = g.px + (size_t)r * p.Wp;
    const float dr = c.x - target[o];
    const float dg = c.y - target[plane + o];
    const float db = c.z - target[2 * plane + o];
    acc = acc + (dr * dr + dg * dg + db * db) * w[o];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc = acc + __shfl_xor_sync(0xffffffffu, acc, off);
  if (g.lane == 0) red[g.warp] = acc;
  __syncthreads();
  if (g.col == 0) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s = s + red[i];
    float* ts = sub + (size_t)g.bt * p.S;
    ts[g.sub] = s;
    __threadfence();  // the partial is visible before the ticket is taken
    if (atomicAdd(&tickets[g.bt], 1) == p.S - 1) {  // every sub-tile of the tile is in
      __threadfence();
      float total = 0.0f;
      for (int u = 0; u < p.S; ++u) total = total + __ldcg(&ts[u]);
      partials[g.bt] = total;
      tickets[g.bt] = 0;
    }
  }
}

// bf16x2 add (op 0), subtract (1) or multiply (2) of n pairs, by the
// walk's own helpers: for checking on the card that each half is the
// correctly rounded bf16 result, subnormals kept.
__global__ void bf16x2_probe_kernel(int op, const bf2* __restrict__ a, const bf2* __restrict__ b,
                                    bf2* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = op == 0 ? badd(a[i], b[i]) : op == 1 ? bsub(a[i], b[i]) : bmul(a[i], b[i]);
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

__global__ void empty_kernel() {}

// a list tile is 128 columns, one per thread, and a whole number of sub-tiles
bool geometry_ok(int tile_h, int tile_w) {
  return tile_w == kTileW && tile_h > 0 && tile_h % kRows == 0;
}

bool frame_ok(int T, int n_tx, int tile_h, int Hp, int Wp) {
  return n_tx > 0 && T % n_tx == 0 && Hp == (T / n_tx) * tile_h && Wp == n_tx * kTileW;
}

template <typename K>
int blocks_per_sm(K kernel) {
  int per_sm = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return err == cudaSuccess ? per_sm : -(int)err;
}

}  // namespace ggs

extern "C" {

int ggs_walk_geometry_ok(int tile_h, int tile_w) { return ggs::geometry_ok(tile_h, tile_w) ? 1 : 0; }

int ggs_walk_sub_rows() { return ggs::kRows; }

const char* ggs_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Blocks of the walk one SM holds at once: fitness (1) or canvas (0)
// epilogue in blend mode `mode`; <= 0 is a CUDA error code, negated.
int ggs_walk_blocks_per_sm(int fitness, int mode) {
  using namespace ggs;
  if (fitness) {
    switch (mode) {
      case kExact: return blocks_per_sm(fitness_kernel<kExact>);
      case kFast: return blocks_per_sm(fitness_kernel<kFast>);
      case kBf16: return blocks_per_sm(fitness_kernel<kBf16>);
    }
  } else {
    switch (mode) {
      case kExact: return blocks_per_sm(render_kernel<kExact>);
      case kFast: return blocks_per_sm(render_kernel<kFast>);
    }
  }
  return -(int)cudaErrorInvalidValue;
}

// mode: 0 exact (K2), 1 fast (K3); the canvas has no bf16 mode. init may be
// null (start from the background); it must not alias canvas.
int ggs_walk_render(int mode, const int* cnt, const int* idx, const float* feats, const float* init,
                    float* canvas, int B, int T, int L, int N1, int n_tx, int tile_h, int tile_w,
                    int Hp, int Wp, float bg0, float bg1, float bg2, void* stream) {
  if (!ggs::geometry_ok(tile_h, tile_w) || !ggs::frame_ok(T, n_tx, tile_h, Hp, Wp))
    return (int)cudaErrorInvalidValue;
  if (B * T == 0) return 0;
  const int S = tile_h / ggs::kRows;
  ggs::WalkParams p{cnt, idx, feats, init, T, S, L, N1, n_tx, tile_h, Hp, Wp, bg0, bg1, bg2};
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = B * T * S;
  switch (mode) {
    case ggs::kExact: ggs::render_kernel<ggs::kExact><<<grid, ggs::kThreads, 0, s>>>(p, canvas); break;
    case ggs::kFast: ggs::render_kernel<ggs::kFast><<<grid, ggs::kThreads, 0, s>>>(p, canvas); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// mode: 0 exact (K1), 1 fast (K3), 2 bf16 (K1-bf16); init may be null.
// sub: scratch of B * T * tile_h / 4 floats; tickets: B * T ints, 0 on
// entry (the kernel leaves them 0).
int ggs_walk_fitness(int mode, const int* cnt, const int* idx, const float* feats,
                     const float* init, const float* target, const float* w, float* partials,
                     float* sub, int* tickets, int B, int T, int L, int N1, int n_tx, int tile_h,
                     int tile_w, int Hp, int Wp, float bg0, float bg1, float bg2, void* stream) {
  if (!ggs::geometry_ok(tile_h, tile_w) || !ggs::frame_ok(T, n_tx, tile_h, Hp, Wp))
    return (int)cudaErrorInvalidValue;
  if (B * T == 0) return 0;
  const int S = tile_h / ggs::kRows;
  ggs::WalkParams p{cnt, idx, feats, init, T, S, L, N1, n_tx, tile_h, Hp, Wp, bg0, bg1, bg2};
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = B * T * S;
  switch (mode) {
    case ggs::kExact:
      ggs::fitness_kernel<ggs::kExact><<<grid, ggs::kThreads, 0, s>>>(p, target, w, partials, sub,
                                                                       tickets);
      break;
    case ggs::kFast:
      ggs::fitness_kernel<ggs::kFast><<<grid, ggs::kThreads, 0, s>>>(p, target, w, partials, sub,
                                                                      tickets);
      break;
    case ggs::kBf16:
      ggs::fitness_kernel<ggs::kBf16><<<grid, ggs::kThreads, 0, s>>>(p, target, w, partials, sub,
                                                                      tickets);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// n pairs of bf16x2 (4 bytes each) in a and b -> out; op 0 add, 1 sub, 2 mul
int ggs_bf16x2_probe(int op, const void* a, const void* b, void* out, int n, void* stream) {
  if (op < 0 || op > 2 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  ggs::bf16x2_probe_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      op, (const ggs::bf2*)a, (const ggs::bf2*)b, (ggs::bf2*)out, n);
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

// A kernel that does nothing: its device time is the launch floor that
// K4's time is read against.
int ggs_empty_launch(void* stream) {
  ggs::empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
