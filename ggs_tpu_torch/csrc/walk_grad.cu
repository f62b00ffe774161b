// Backward tile walks for Hopper (sm_90a): the exact analytic gradient of
// the painter-order "over" composite, per (image, list tile), with two heads.
//
//   K6 (ggs_grad_walk, fused = 0) replaces the Pallas kernel
//      _bwd_tile_kernel(fused=False) (ggs_tpu/ops/render_grad.py:436,
//      pallas_call in _make_screen_render.bwd_grads): takes the image
//      cotangent g [B, 3, Hp, Wp] and writes the 9 parameter gradients of
//      every listed splat. A chained pass (render_cuda.MAX_SPLATS splats at a
//      time) starts from the previous pass's canvas, init [B, 3, Hp, Wp], and
//      then also writes that canvas's cotangent dinit = g * T_total, T_total
//      the transmittance through the pass's whole list at the pixel
//      (render_grad.py:76-79, 289-292), again with no division.
//   K7 (ggs_grad_walk, fused = 1) replaces _bwd_tile_kernel(fused=True)
//      (render_grad.py:556, pallas_call in _make_screen_lossgrad.run):
//      renders the tile, forms the weighted-SSE partial num = sum_px w *
//      |clip(C) - target|^2 and the cotangent g = scale * w * (clip(C) -
//      target) on chip (straight through the clamp, as the Pallas head does),
//      then runs the same backward walk.
//
// The walk (raw table, render_pallas._splat_feats): for k < cnt[b,t] with
// s = idx[b,t,k], per pixel (x, y) inside the splat's integer box,
//   qx = x - cx, qy = y - cy
//   e  = exp(-0.5 * (sxx*(qx*qx) + 2*sxy*(qx*qy) + syy*(qy*qy))), f = a*e
//   C_k = (1 - f) C_{k-1} + f c.
// This is K2's walk with the power-of-two fold undone, so every f32 value
// equals K2's. The gradients (render_grad.py:249-277), with the suffix
// transmittance T_k = prod_{j>k} (1 - f_j) multiplied from the last splat:
//   gT = g*T_k;  dL/df = sum_ch gT_ch (c_ch - C_{k-1,ch})
//   d rc,gc,bc = sum gT_ch f;  d a = sum dL/df e;  dq = -0.5 f dL/df
//   d cx = sum dq*(-2)*(sxx qx + sxy qy);  d cy = sum dq*(-2)*(syy qy + sxy qx)
//   d sxx = sum dq qx qx;  d sxy = sum dq*2 qx qy;  d syy = sum dq qy qy.
// No division anywhere: f is exactly 1 for alpha 255 at a centre, so neither
// C_{k-1} from C_k nor T_k from T_{k-1} is recovered by dividing by (1 - f).
//
// The order: transmittance checkpoints, then a forward gradient walk.
//   T pass: walk the list once backward, T = 1 times (1 - f) splat by splat,
//     storing T at every kChunk-splat boundary (4 bytes a pixel); its end
//     is T_total, so dinit = g * T_total.
//   G pass: chunk by chunk from the first, replay the chunk backward from its
//     stored T, keeping each splat's T_k and e in shared memory (a float2, 8
//     bytes a pair-pixel), then walk the chunk forward carrying C_{k-1} in registers
//     from the init canvas or the background, forming the 9 sums from the
//     stored T_k and e (no third exp).
// Each f, T_k and C_{k-1} is the same operation in the same order as in the
// plain version's two-level replay (render_grad._grad_walk_plain), so every
// per-pixel value is the same bits; only the order of the sums over pixels
// differs. K6 walks the list three times with two exps a pair-pixel; K7 first
// walks forward for its loss head, four walks and three exps.
//
// The work unit is a sub-tile, not the list tile. A block of 128 threads
// walks kRows = 4 rows x 128 columns of one list tile (128 wide, tile_h = 8,
// 16, 32 or 64 rows: tile_h / 4 sub-tiles), each thread one column and four
// consecutive rows, carrying their canvas, g and T in registers. Every
// sub-tile of a tile walks the tile's whole list: a splat whose rows miss the
// sub-tile costs a block-uniform test, one whose columns miss a warp's 32 a
// warp-uniform test (on grad-10k-1024's last pass 3.3% of the list slots and
// 19% of the kept (slot, warp) visits; PERF.md). The list's splat
// parameters are staged through shared memory kChunk at a time,
// double-buffered and two deep: each thread loads its share of the next
// chunk's parameters, and the list entries of the one after, while the block
// walks the current one. A splat's record is 7 float4s for 16-byte loads:
// its box (x0 x1 y0 y1), (cx sxx sxy a), its row terms over the sub-tile's
// four rows qy = (yb + r) - cy and the quadratic's syy*(qy*qy), (rc gc bc -),
// and the G walk's row terms sxy*qy and syy*qy. The row terms depend only on
// the splat and the sub-tile, so they are computed once a chunk while it is
// staged, by warp 0 (whose staging slots are cy, sxy, syy and cx: a lane a
// (splat, row), the three taken by shuffles), with the walk's own operations
// in its order, before the barrier that stages the rest; the pixels read
// them. The walks then run the four rows without a branch in one of two
// forms chosen per splat and warp (by_cover): where the box holds the
// sub-tile's rows (block-uniform) and the warp's 32 columns (warp-uniform),
// e with no test; elsewhere a select per pixel, e = 0 outside the box. The
// arithmetic and its rounding are the same in both, so every value keeps its
// bits whichever runs, and the four rows' dependent chains interleave in
// each (on that pass 83% of the visits take the first form). A third form,
// for boxes that hold the rows only (a select on the column alone; 16% of
// the visits there, 43% on run_grad's default lists), made K7 4-6% slower
// than two forms on those lists, slower than with no forms at all, and
// gained nothing elsewhere (PERF.md §6 PR 27). The G replay writes e = 0 for
// the warp's pixels outside the box, so the G forward walk needs no test of
// its own. Per (splat, warp) the 9 sums reduce
// by a halving butterfly (16 shuffles instead of 9 x 5: lane l ends with the
// sum of value l >> 1), then the 4 warps in order; per (sub-tile, list slot)
// they go to spart [B, T, S, L, 9]. A second kernel sums the S sub-tiles in
// order and scatters each slot to its splat in the per-tile partials gpart
// [B, T, 9, N] (zeroed by the wrapper), and a third sums the tiles in order.
// No atomics on values: the same bits on every launch. The T checkpoints do
// not fit shared memory for long lists (L up to 8,000 is 1,000 boundaries of
// 2 KB), so they live in device memory, each loaded a chunk ahead of its use,
// one slot per resident block: a block per item would need a slot per item.
// So the launch has at most as many blocks as the card holds at once, and a
// block may walk several items. Block i walks item i first; where the items
// outnumber the blocks, each block then takes its next item from a counter in
// device memory (one atomicAdd by thread 0, broadcast through shared memory)
// until the counter passes the items, so a block that drew short lists walks
// more of them. Every sub-tile walks its tile's whole list, and list lengths
// vary ~3x across tiles (adam1024-n10k: 236-784), so a fixed stride left
// blocks idle while the longest finished (2,048 items on 660 blocks). Each
// item writes only its own slots, so the outputs keep their bits whichever
// block walks it. The counter starts at 0, and the block that takes the
// launch's last ticket sets it back to 0, so a launch or a graph replay needs
// no zeroing node. Where the items fit the blocks, one item a block: no
// counter. On an H100 80GB HBM3 at 700 W (CUDA events, mean of 20 launches,
// fixed stride -> queue): K6 with d(init) on a 5,000-splat pass at 1024x1024
// (2,048 items) 3.394 -> 3.174 ms; K6 and K7 at B=8, N=512, 512x512 (4,096
// items) 0.896 -> 0.823 and 1.073 -> 1.005 ms; at B=1, N=2000 (512 items)
// unchanged. The row terms and cover forms (same card, CUDA events, mean of
// two runs a side; PERF.md §6 PR 27): K6 with d(init) on that pass 3.191 ->
// 2.837 ms, K6 and K7 at B=8 0.821 -> 0.735 and 1.003 -> 0.899 ms, at B=1
// 0.468 -> 0.428 and 0.567 -> 0.522 ms, K7 on run_grad's default lists
// (adam512-n2000's window) 0.321 -> 0.310 ms, every output the same bits.
// SASS instructions a covered (splat, pixel) pair, the loop's shared tests
// counted in (cuobjdump -sass, tools/grad_walk_times.py --sass): the T pass
// 29.25 -> 22.5 (27.75 in the form with the select), the G replay 34.25 ->
// 25.5 (30.25), the G forward walk 89.75 -> 77.5 (its reduction counted in),
// K7's forward walk 36.5 -> 30.75 (36.0): K6 153.25 -> 125.5.
//
// What bounds it: operations. Per pair-pixel the function needs one forward
// step (23) and one backward step (45); this kernel runs 2 (K6) or 3 (K7)
// forward steps besides, built with -fmad=false and without fast math (as
// walk.cu, so K7's num equals K1's partial on the same lists within rounding
// of the sums), so it cannot come closer than ~4x the f32 bound, which
// counts an FMA as 2.
//
// What the design does about the earlier kernel's limits (one 256-thread
// block per 16x128 tile, 8 warps a SM at B=1 512x512; prefix canvases
// through device memory; three walks; 9 x 5 shuffles per splat; per-tile
// partials): 4x the blocks
// at any tile height (B=1, 512x512: 512 blocks of 4 warps, up to 5 resident
// a SM); the prefix canvases (12 bytes a pair-pixel written and read in
// device memory) become T_k and e in shared memory, the boundary canvases
// (12 bytes a pixel a chunk) T checkpoints (4); K6 keeps three walks but
// drops one exp; 16 shuffles a splat; the partials stay [B, T, 9, N], the
// sub-tiles summed per list slot first.
//
// ptxas (sm_90a, -O3 -fmad=false) on the H100 run recorded in PERF.md:
// grad_kernel<false> (K6) 93 registers and <true> (K7) 91 (the launch bound
// caps them at 96 for 5 blocks a SM), 36,612 and 36,628 bytes of static
// shared memory (the records 1,792, T_k and e 32,768, the sums 2,048), no
// spills: 5 blocks a SM; sub_sum_kernel and tile_sum_kernel 32 registers.

#include <cuda_runtime.h>

namespace ggs_grad {

constexpr int kTileW = 128;        // list tile width: one column per thread
constexpr int kThreads = kTileW;   // threads per block
constexpr int kRows = 4;           // rows a thread owns: the sub-tile's height
constexpr int kChunk = 8;          // splats per transmittance checkpoint
constexpr int kNFeat = 13;
constexpr int kNGrad = 9;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = (kNFeat * kChunk + kThreads - 1) / kThreads;  // staged entries a thread
constexpr int kMinBlocks = 5;      // resident blocks a SM the registers must allow

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
  float* nsub;          // K7: [B, T, S] weighted-SSE partials of each sub-tile
  float* spart;         // [B, T, S, L, 9] gradients of each (sub-tile, list slot)
  float* bound;         // per grid block: max_chunks x kRows x kThreads T checkpoints
  int* queue;           // the next item less gridDim.x, 0 between launches; null: one item a block
  int max_chunks;
  int B, T, S, L, N1, n_tx, tile_h, Hp, Wp;
  float bg0, bg1, bg2;
};

// A splat's shared-memory record, in float4s: its box (x0 x1 y0 y1), then
// (cx sxx sxy a); its row terms over the sub-tile's four rows, which only the
// splat and the row decide (a float4 each over rows yb .. yb + 3): qy =
// (yb + r) - cy and the quadratic's syy*(qy*qy); then (rc gc bc -); then the
// G walk's row terms sxy*qy and syy*qy. cy and syy enter the row terms only.
// The T pass and the G replay read the first four, K7's forward walk five.
enum { R_BOX, R_SPLAT, R_QY, R_YY, R_COLOUR, R_XY, R_RY, kRec };

// The table row a staging slot s (entry e = s * kChunk + splat) loads: warp
// 0's slots 0-3 hold cy, sxy, syy and cx, so warp 0 holds in registers
// whatever the row terms need.
__host__ __device__ constexpr int stage_row(int s) {
  return s == 0 ? F_CY : s == 1 ? F_SXY : s == 2 ? F_SYY : s == 3 ? F_CX : s == 4 ? F_SXX : s;
}
// a table row's float slot in the record, or -1 (cy, syy)
__host__ __device__ constexpr int rec_slot(int r) {
  return r >= F_X0 ? r - F_X0 : r == F_CX ? 4 : r == F_SXX ? 5 : r == F_SXY ? 6 : r == F_A ? 7
       : r >= F_R && r <= F_B ? 4 * R_COLOUR + r - F_R : -1;
}
static_assert(stage_row(4) == F_SXX && stage_row(5) == F_R && stage_row(12) == F_Y1 &&
                  rec_slot(F_R) == 16 && rec_slot(F_B) == 18 && rec_slot(F_A) == 7,
              "every row but cy and syy has one slot");

// A splat's first n float4s of shared memory at p into r, by 16-byte loads.
template <int n>
__device__ __forceinline__ void load_record(float4 (&r)[n], const float4* p) {
#pragma unroll
  for (int i = 0; i < n; ++i) r[i] = p[i];
}

// Whether a splat's box covers all of the sub-tile's rows and a warp's
// columns (e with no test) or not (a select per pixel).
enum Cover { kAll, kPartial };
template <Cover k>
struct Form {
  static constexpr Cover value = k;
};

// block-uniform: the box bx (x0 x1 y0 y1) misses the sub-tile's rows yb ..
// ye; warp-uniform: it misses the warp's columns wx0 .. wx1
__device__ __forceinline__ bool misses(float4 bx, float yb, float ye, float wx0, float wx1) {
  return bx.w < yb || bx.z > ye || bx.y < wx0 || bx.x > wx1;
}

// walk(Form<kCover>) for a splat whose box bx meets the sub-tile and the
// warp: kAll where it holds the sub-tile's rows (block-uniform) and the
// warp's columns (warp-uniform), else kPartial; nothing where it misses
// either. So each walk is written once and compiled in two forms; the
// commoner, kAll, is tested first.
template <typename F>
__device__ __forceinline__ void by_cover(float4 bx, float yb, float ye, float wx0, float wx1,
                                         F&& walk) {
  if (bx.z <= yb && bx.w >= ye && bx.x <= wx0 && bx.y >= wx1)
    walk(Form<kAll>{});
  else if (!misses(bx, yb, ye, wx0, wx1))
    walk(Form<kPartial>{});
}

// e = exp(-0.5 * quad) (the unfolded form of render_grad's masked_exp) at
// the thread's four rows yb .. yb + 3 of column xf, from the record's
// (cx sxx sxy a) sp and row terms qy and yy, and 0 outside the box bx by a
// select: e is finite (quad >= 0 up to rounding), and with e = 0 f = 0, so
// every update of the walks leaves its value as it was bit for bit (T * (1 -
// 0), (1 - 0) * C + 0 * c, acc + 0 * x). kAll drops the tests its cover
// makes true. The four rows run without a branch, so their dependent chains
// interleave.
template <Cover kCover>
__device__ __forceinline__ void row_e(float (&e)[kRows], float4 bx, float4 sp, float4 qy4,
                                      float4 yy4, float xf, float yb) {
  const float* qy = &qy4.x;
  const float* yy = &yy4.x;
  const float qx = xf - sp.x;
  const float txx = sp.y * (qx * qx);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float quad = txx + (2.0f * sp.z) * (qx * qy[r]);
    quad = quad + yy[r];
    const float ex = expf(-0.5f * quad);
    e[r] = ex;
    if constexpr (kCover == kPartial) {
      const float yf = yb + (float)r;
      e[r] = (xf >= bx.x && xf <= bx.y && yf >= bx.z && yf <= bx.w) ? ex : 0.0f;
    }
  }
}

// One step of warp_sum9: lanes with bit 2H set keep the upper half of
// v[0..2H), the others the lower, each adding its partner's copy.
template <int H>
__device__ __forceinline__ void halve(float (&v)[16], int lane) {
  const bool upper = lane & (2 * H);
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float keep = upper ? v[i + H] : v[i];
    const float send = upper ? v[i] : v[i + H];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * H);
  }
}

// Sums v[0..9) over the warp: a halving butterfly over 16 values (the last
// 7 zero), 8 + 4 + 2 + 1 + 1 shuffles. Returns in lane l the warp's sum of
// value l >> 1 (lanes 0-17 hold values 0-8). The same order on every launch.
__device__ __forceinline__ float warp_sum9(const float (&acc)[kNGrad], int lane) {
  float v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = i < kNGrad ? acc[i] : 0.0f;
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

template <bool kFused>
__global__ void __launch_bounds__(kThreads, kMinBlocks) grad_kernel(GradParams p) {
  __shared__ float4 sf[2][kChunk][kRec];
  __shared__ float2 tek[kChunk][kRows][kThreads];  // the chunk's T_k and e (0 outside the box)
  static_assert(kNGrad <= 16 && kThreads == 32 * kWarps, "a (splat, warp)'s sums in 16 slots");
  __shared__ float red[kChunk][kWarps][16];  // a (splat, warp)'s 9 sums: lane l's at col / 2
  __shared__ float nred[kWarps];
  __shared__ int next_item;  // the block's next item, from the queue

  const int col = threadIdx.x;
  const int lane = col & 31;
  const int warp = col >> 5;
  const size_t plane = (size_t)p.Hp * p.Wp;
  float* bnd = p.bound + (size_t)blockIdx.x * p.max_chunks * kRows * kThreads;
  const int items = p.B * p.T * p.S;
  // The table row this thread stages and its slot in the record, once: worked
  // out again each chunk, they cost K7 more than the row terms saved.
  static_assert(kPer == 1, "one staged entry a thread");
  const int srow = col < kNFeat * kChunk ? stage_row(col / kChunk) : 0;
  const int sslot = rec_slot(srow);

  for (int it = blockIdx.x; it < items; it = next_item) {
    const int bt = it / p.S;
    const int sub = it - bt * p.S;
    const int b = bt / p.T;
    const int t = bt - b * p.T;
    const int tx0 = (t % p.n_tx) * kTileW;
    const int ry0 = (t / p.n_tx) * p.tile_h + sub * kRows;  // the sub-tile's first row
    const float xf = (float)(tx0 + col);
    const float yb = (float)ry0;
    const float ye = (float)(ry0 + kRows - 1);
    const float wx0 = (float)(tx0 + 32 * warp), wx1 = wx0 + 31.0f;  // the warp's columns
    const size_t px = (size_t)ry0 * p.Wp + tx0 + col;  // this thread's pixel in row 0
    const int n = p.cnt[bt];
    const int nch = (n + kChunk - 1) / kChunk;
    const int* list = p.idx + (size_t)bt * p.L;
    const float* fb = p.feats + (size_t)b * kNFeat * p.N1;

    // chunk staging, two deep: entries(c) loads this thread's share of
    // chunk c's list entries; fetch(cn) loads the parameters of the chunk
    // whose entries are loaded, then chunk cn's entries; put(buf) stores the
    // parameters to shared memory. So neither load stalls the walk.
    float pv[kPer];
    int ps[kPer], pn[kPer];
    auto entries = [&](int c) {
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int e = col + q * kThreads;
        const int k = c * kChunk + e % kChunk;
        pn[q] = (e < kNFeat * kChunk && c >= 0 && c < nch && k < n) ? list[k] : -1;
      }
    };
    auto fetch = [&](int cn) {
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        ps[q] = pn[q];
        if (ps[q] >= 0) pv[q] = fb[(size_t)srow * p.N1 + ps[q]];
      }
      entries(cn);
    };
    // put(buf) stores the staged parameters into the chunk's records, and
    // warp 0 (which holds cy, sxy and syy of the chunk's splats in lanes
    // 0-7, 8-15 and 16-23) their row terms, lane l those of splat l / 4 at
    // row yb + l % 4, with the walk's own operations in its order.
    auto put = [&](int buf) {
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int e = col + q * kThreads;
        if (ps[q] >= 0 && sslot >= 0) reinterpret_cast<float*>(sf[buf][e % kChunk])[sslot] = pv[q];
      }
      static_assert(kPer == 1 && kChunk * kRows == 32 && stage_row(0) == F_CY &&
                        stage_row(1) == F_SXY && stage_row(2) == F_SYY,
                    "warp 0 stages cy, sxy and syy, and a lane a (splat, row)");
      if (warp == 0) {
        const int j = lane / kRows, r = lane % kRows;
        const float cy = __shfl_sync(0xffffffffu, pv[0], j);
        const float sxy = __shfl_sync(0xffffffffu, pv[0], kChunk + j);
        const float syy = __shfl_sync(0xffffffffu, pv[0], 2 * kChunk + j);
        const float qy = (yb + (float)r) - cy;
        float* rec = reinterpret_cast<float*>(sf[buf][j]);
        rec[4 * R_QY + r] = qy;
        rec[4 * R_YY + r] = syy * (qy * qy);
        rec[4 * R_XY + r] = sxy * qy;
        rec[4 * R_RY + r] = syy * qy;
      }
    };
    // body(c, buf, m) for every chunk, forward (fwd) or from the last; the
    // next chunks' loads are in flight while body runs
    auto pass = [&](bool fwd, auto&& body) {
      const int d = fwd ? 1 : -1;
      const int c0 = fwd ? 0 : nch - 1;
      __syncthreads();  // the previous pass is done with sf, red and nred
      entries(c0);
      fetch(c0 + d);
      for (int i = 0; i < nch; ++i) {
        const int c = c0 + i * d;
        put(i & 1);
        __syncthreads();
        fetch(c + 2 * d);
        body(c, i & 1, min(kChunk, n - c * kChunk));
      }
    };

    float cr[kRows], cg[kRows], cb[kRows];
    auto start_canvas = [&]() {
      const float* ib = p.init ? p.init + (size_t)b * 3 * plane : nullptr;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (ib) {
          const size_t o = px + (size_t)r * p.Wp;
          cr[r] = ib[o];
          cg[r] = ib[plane + o];
          cb[r] = ib[2 * plane + o];
        } else {
          cr[r] = p.bg0;
          cg[r] = p.bg1;
          cb[r] = p.bg2;
        }
      }
    };

    // ---- the image cotangent: K7's forward walk and loss head, or K6's input
    float g0[kRows], g1[kRows], g2[kRows];
    if constexpr (kFused) {
      start_canvas();
      pass(true, [&](int c, int buf, int m) {
        for (int j = 0; j < m; ++j) {
          float4 rec[R_COLOUR + 1];
          load_record(rec, sf[buf][j]);
          by_cover(rec[R_BOX], yb, ye, wx0, wx1, [&](auto form) {
            float e[kRows];
            row_e<decltype(form)::value>(e, rec[R_BOX], rec[R_SPLAT], rec[R_QY], rec[R_YY], xf,
                                         yb);
            const float a = rec[R_SPLAT].w;
            const float4 c = rec[R_COLOUR];
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              const float f = a * e[r];
              const float omf = 1.0f - f;
              cr[r] = omf * cr[r] + f * c.x;
              cg[r] = omf * cg[r] + f * c.y;
              cb[r] = omf * cb[r] + f * c.z;
            }
          });
        }
      });
      float acc = 0.0f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const size_t o = px + (size_t)r * p.Wp;
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
      if (col == 0) {
        float s = 0.0f;
        for (int i = 0; i < kWarps; ++i) s = s + nred[i];
        p.nsub[it] = s;
      }
    } else {
      const float* gb = p.gimg + (size_t)b * 3 * plane;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const size_t o = px + (size_t)r * p.Wp;
        g0[r] = gb[o];
        g1[r] = gb[plane + o];
        g2[r] = gb[2 * plane + o];
      }
    }

    // ---- T pass: the list backward, T stored at every chunk boundary
    float T[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) T[r] = 1.0f;
    pass(false, [&](int c, int buf, int m) {
      float* bc = bnd + (size_t)c * kRows * kThreads + col;
#pragma unroll
      for (int r = 0; r < kRows; ++r) bc[r * kThreads] = T[r];
      for (int j = m - 1; j >= 0; --j) {
        float4 rec[R_YY + 1];
        load_record(rec, sf[buf][j]);
        by_cover(rec[R_BOX], yb, ye, wx0, wx1, [&](auto form) {
          float e[kRows];
          row_e<decltype(form)::value>(e, rec[R_BOX], rec[R_SPLAT], rec[R_QY], rec[R_YY], xf, yb);
#pragma unroll
          for (int r = 0; r < kRows; ++r) T[r] = T[r] * (1.0f - rec[R_SPLAT].w * e[r]);
        });
      }
    });
    if (p.dinit) {  // T is T_total
      float* db = p.dinit + (size_t)b * 3 * plane;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const size_t o = px + (size_t)r * p.Wp;
        db[o] = g0[r] * T[r];
        db[plane + o] = g1[r] * T[r];
        db[2 * plane + o] = g2[r] * T[r];
      }
    }

    // ---- G pass: each chunk replayed backward for its T_k, then walked
    // forward from the canvas before it, forming the 9 sums
    start_canvas();
    float* sp = p.spart + (size_t)it * p.L * kNGrad;
    float tn[kRows];  // the next chunk's checkpoint, loaded a chunk ahead
#pragma unroll
    for (int r = 0; r < kRows; ++r) tn[r] = nch ? bnd[r * kThreads + col] : 1.0f;
    pass(true, [&](int c, int buf, int m) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) T[r] = tn[r];
      if (c + 1 < nch) {
        const float* bc = bnd + (size_t)(c + 1) * kRows * kThreads + col;
#pragma unroll
        for (int r = 0; r < kRows; ++r) tn[r] = bc[r * kThreads];
      }
      for (int j = m - 1; j >= 0; --j) {
        float4 rec[R_YY + 1];
        load_record(rec, sf[buf][j]);
        by_cover(rec[R_BOX], yb, ye, wx0, wx1, [&](auto form) {
          float e[kRows];
          row_e<decltype(form)::value>(e, rec[R_BOX], rec[R_SPLAT], rec[R_QY], rec[R_YY], xf, yb);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            tek[j][r][col] = make_float2(T[r], e[r]);
            T[r] = T[r] * (1.0f - rec[R_SPLAT].w * e[r]);
          }
        });
      }
      // The replay wrote e = 0 for every pixel of the warp outside the box,
      // so the forward walk needs no test of its own: f = 0 there, and its
      // sums and canvas keep their bits.
      for (int j = 0; j < m; ++j) {
        float4 rec[kRec];
        load_record(rec, sf[buf][j]);
        if (misses(rec[R_BOX], yb, ye, wx0, wx1)) {  // block- or warp-uniform: not walked
          if (lane < kNGrad) red[j][warp][lane] = 0.0f;
          continue;
        }
        const float4 sp = rec[R_SPLAT], c = rec[R_COLOUR];
        const float* qyr = &rec[R_QY].x;
        const float* xyr = &rec[R_XY].x;
        const float* ryr = &rec[R_RY].x;
        float acc[kNGrad];
#pragma unroll
        for (int i = 0; i < kNGrad; ++i) acc[i] = 0.0f;
        const float qx = xf - sp.x;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float qy = qyr[r];
          const float2 te = tek[j][r][col];
          const float tkr = te.x, e = te.y;
          const float f = sp.w * e;
          const float gT0 = g0[r] * tkr;
          const float gT1 = g1[r] * tkr;
          const float gT2 = g2[r] * tkr;
          const float dLdf = (gT0 * (c.x - cr[r]) + gT1 * (c.y - cg[r])) +
                             gT2 * (c.z - cb[r]);
          const float dLdq = (-0.5f * f) * dLdf;
          const float d2 = dLdq * 2.0f;  // dLdq * -2 is -d2 in every bit
          acc[0] = acc[0] + (-d2) * (sp.y * qx + xyr[r]);
          acc[1] = acc[1] + (-d2) * (ryr[r] + sp.z * qx);
          acc[2] = acc[2] + (dLdq * qx) * qx;
          acc[3] = acc[3] + (d2 * qx) * qy;
          acc[4] = acc[4] + (dLdq * qy) * qy;
          acc[5] = acc[5] + gT0 * f;
          acc[6] = acc[6] + gT1 * f;
          acc[7] = acc[7] + gT2 * f;
          acc[8] = acc[8] + dLdf * e;
          const float omf = 1.0f - f;
          cr[r] = omf * cr[r] + f * c.x;
          cg[r] = omf * cg[r] + f * c.y;
          cb[r] = omf * cb[r] + f * c.z;
        }
        const float v = warp_sum9(acc, lane);
        if (!(lane & 1) && lane < 2 * kNGrad) (&red[j][0][0])[col >> 1] = v;
      }
      __syncthreads();
      for (int e = col; e < m * kNGrad; e += kThreads) {
        const int j = e / kNGrad;
        const int q = e - j * kNGrad;
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s = s + red[j][w][q];
        sp[(size_t)(c * kChunk) * kNGrad + e] = s;
      }
    });

    if (!p.queue) break;
    // The launch takes tickets 0 .. items - 1, one each: items - gridDim.x
    // that name an item and one a block that ends it. The block that takes
    // the last leaves the counter 0. Every thread read the last next_item
    // before this item's first __syncthreads.
    if (col == 0) {
      const int ticket = atomicAdd(p.queue, 1);
      if (ticket == items - 1) *p.queue = 0;
      next_item = ticket + gridDim.x;
    }
    __syncthreads();
  }
}

// gpart[b, t, q, idx[b, t, k]] = sum_s spart[b, t, s, k, q], s in order, for
// k < cnt[b, t]; K7: num[b, t] = sum_s nsub[b, t, s]. One block per (b, t).
__global__ void sub_sum_kernel(const int* __restrict__ cnt, const int* __restrict__ idx,
                               const float* __restrict__ spart, const float* __restrict__ nsub,
                               float* __restrict__ gpart, float* __restrict__ num, int S, int L,
                               int N) {
  const int bt = blockIdx.x;
  const int n = cnt[bt];
  const float* src = spart + (size_t)bt * S * L * kNGrad;
  float* dst = gpart + (size_t)bt * kNGrad * N;
  for (int e = threadIdx.x; e < n * kNGrad; e += blockDim.x) {
    const int k = e / kNGrad;
    const int q = e - k * kNGrad;
    float s = 0.0f;
    for (int u = 0; u < S; ++u) s = s + src[(size_t)u * L * kNGrad + e];
    dst[(size_t)q * N + idx[(size_t)bt * L + k]] = s;
  }
  if (num && threadIdx.x == 0) {
    float s = 0.0f;
    for (int u = 0; u < S; ++u) s = s + nsub[(size_t)bt * S + u];
    num[bt] = s;
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

int ggs_grad_sub_rows() { return ggs_grad::kRows; }

int ggs_grad_chunk() { return ggs_grad::kChunk; }

// Blocks of the walk kernel one SM holds at once; <= 0 is a CUDA error
// code, negated.
int ggs_grad_blocks_per_sm(int fused) {
  int per_sm = 0;
  cudaError_t err = fused ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                                &per_sm, ggs_grad::grad_kernel<true>, ggs_grad::kThreads, 0)
                          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                                &per_sm, ggs_grad::grad_kernel<false>, ggs_grad::kThreads, 0);
  if (err != cudaSuccess) return -(int)err;
  return per_sm;
}

// Blocks of the walk kernel the current card holds at once (the checkpoint
// slots the caller allocates); <= 0 is a CUDA error code, negated.
int ggs_grad_resident_blocks(int fused) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  const int per_sm = ggs_grad_blocks_per_sm(fused);
  return per_sm <= 0 ? per_sm : sms * per_sm;
}

// K6 (fused = 0: gimg, and init -> dinit where init is not null) or K7
// (fused = 1: target, w, scale -> num; no init) on list tiles of tile_h x 128
// (tile_h a multiple of 4), then the in-order sums over sub-tiles and tiles:
// grads [B, 9, N] = sum_t gpart[:, t]. gpart [B, T, 9, N] must be zero.
// bound holds `slots` checkpoint slots. queue is one int, 0 on entry and
// left 0, where the B * T * tile_h / 4 items outnumber the slots; else it may
// be null: one item a block.
int ggs_grad_walk(int fused, const int* cnt, const int* idx, const float* feats, const float* gimg,
                  const float* init, float* dinit, const float* target, const float* w,
                  float scale, float* num, float* nsub, float* spart, float* gpart, float* grads,
                  float* bound, int* queue, int slots, int max_chunks, int B, int T, int L, int N1,
                  int N, int n_tx, int tile_h, int Hp, int Wp, float bg0, float bg1, float bg2,
                  void* stream) {
  if (B * T == 0) return 0;
  if (slots <= 0 || N <= 0 || tile_h <= 0 || tile_h % ggs_grad::kRows ||
      Hp != (T / n_tx) * tile_h || Wp != n_tx * ggs_grad::kTileW ||
      max_chunks * ggs_grad::kChunk < L || (fused && (init || !num || !nsub)) ||
      (!init != !dinit))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int S = tile_h / ggs_grad::kRows;
  ggs_grad::GradParams p{cnt,   idx,   feats, gimg,  init,       dinit, target, w,
                         scale, nsub,  spart, bound, queue,      max_chunks, B,  T,
                         S,     L,     N1,    n_tx,  tile_h,     Hp,   Wp,   bg0, bg1, bg2};
  const int items = B * T * S;
  const int grid = items < slots ? items : slots;
  if (items > grid && !queue) return (int)cudaErrorInvalidValue;
  if (fused)
    ggs_grad::grad_kernel<true><<<grid, ggs_grad::kThreads, 0, st>>>(p);
  else
    ggs_grad::grad_kernel<false><<<grid, ggs_grad::kThreads, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ggs_grad::sub_sum_kernel<<<B * T, 256, 0, st>>>(cnt, idx, spart, fused ? nsub : nullptr, gpart,
                                                   fused ? num : nullptr, S, L, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int M = ggs_grad::kNGrad * N;
  const long long total = (long long)B * M;
  ggs_grad::tile_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(gpart, grads, B, T, M);
  return (int)cudaGetLastError();
}

}  // extern "C"
