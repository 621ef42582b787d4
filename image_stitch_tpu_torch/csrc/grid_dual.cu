// The fused uniform-grid step on Hopper: a tile stack read once, in place,
// into both the PNG filter select and the JPEG colour, FDCT and quantize.
//
// Replaces the XLA program of image_stitch_tpu/ops/fused.py:57
// fused_grid_dual_step (and :37, :49, its PNG and JPEG halves; sharded in
// parallel/mesh.py:85), which the port first ran as a composition: the
// canvas assembled by a permute/reshape copy, filter_select (filter.cu) and
// fdct_quant (fdct_quant.cu) reading that copy, and a cast of the types: the
// band's bytes crossed device memory four times in four launches. Here one
// launch reads each tile byte once, from the tile stack where it lies
// (grid_dual.cuh: canvas pixel (r, x) at tiles[r / th, x / tw, r % th, x %
// tw]), and writes each output once: types as int32, the filtered rows, the
// last raw row (a gather across gx tiles), and the 4:4:4 blocks.
//
// What bounds it on the H100: a 256 x 8192 band moves 29.4 MB (8.4 MB read;
// 8.4 MB filtered, 12.6 MB of blocks written), 8.8 us at 3.35 TB/s; and its
// pixels cost the filter's ~70 and the quantizer's ~100 integer instructions
// each, which at four warp instructions a cycle on 132 SMs is of the same
// order. So the design reads the bytes once and keeps them on chip between
// the two halves, and spends the filter's and the quantizer's own per-word
// arithmetic (filter.cuh, fdct_quant.cuh) on them:
// - the two halves split work in ways that do not meet (filter.cu: a CTA per
//   row, since a row's five candidate sums decide its filter; fdct_quant.cu:
//   a CTA per 8-row strip tile). This kernel takes the quantizer's: a CTA
//   of 512 threads per 8-row strip and column chunk (grid_dual_split: an
//   8192-pixel band is 8 chunks of 1024 pixels, one tile each in the
//   smoke's shape), so that each pixel is loaded once;
// - each of the CTA's 16 warps takes a slice of the chunk (64 pixels) and
//   works alone until the exchange, so that no CTA barrier stalls the
//   loads or the arithmetic: it copies its slice of the strip's rows and of
//   the row above (canvas row r0 - 1 from the tile stack, so that a mesh
//   slab's halo costs no copy, or the carry row at the image start) into
//   its own shared memory with cp.async, 16 B at a time where a tile row's
//   bytes and the addresses allow (kVec16) and 4 B otherwise (kWords; the
//   wrapper chooses, ops/kernels.py grid_dual_variant), a commit group per
//   step of 32 pixels, so that the first step's arithmetic overlaps the
//   later steps' loads;
// - per step, lane l takes row l % 8 of block l / 8: colour and the row
//   passes (fdct_row_444) into the warp's planes, then a block column
//   (fdct_column, the reciprocal quantizer), then 16 B stores of the staged
//   blocks, as fdct_quant.cu's threads do; and lane l scores 8 words of row
//   l / 4 (filter_word_scores: SIMD-in-a-word candidates, the left word by
//   __shfl_up_sync), on the same bytes;
// - a row's five sums: the warp's four lanes by shuffles, the CTA's warps
//   through shared memory, then the strip's CTAs through a scratch buffer
//   in global memory (L2): each CTA publishes its sums behind a flag, then
//   quantizes its last window's blocks (their bytes still in shared memory)
//   while the strip's other CTAs catch up, then waits for their flags, reads
//   their sums in rank order and reaches the same first minimum under `<` as
//   they do (grid_dual_choose); the first CTA writes the types;
// - the chosen residues are written from the rows still in shared memory
//   with 16 B stores; a chunk wider than one window (1024 pixels) reads its
//   windows again in the write phase, from L2, never twice by design.
// Why not a thread block cluster per strip, adding the sums through
// distributed shared memory: a cluster's 8 CTAs must sit in one GPC, 4 SMs'
// worth at two CTAs an SM, and the H100's GPCs hold fewer such clusters at
// once than the 32 strips of a 256-row band, so the last strips run as a
// second wave as long as the first (PERF.md). The tickets need no
// placement: a CTA takes its strip and rank from a ticket counter when it
// starts, so it only ever waits for CTAs that started before it or that
// take the next tickets, and a CTA that waits never holds back one that has
// not started (the layout kernel, layout.cu, waits the same way). Counter
// and flags live in a scratch buffer per stream, zeroed once, when made:
// the wrapper passes the tickets taken by earlier launches on it and a flag
// value no earlier launch wrote.
//
// chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W: 0.0246 ms for the
// 256 x 8192 band, 36% of its bytes bound, against 0.0459 ms for the
// composition; 128 rows, one CTA an SM, take 0.0159 ms: a CTA's own
// latency, not the SMs' issue or the bytes, bounds it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fdct_quant.cuh"
#include "filter.cuh"
#include "grid_dual.cuh"

namespace {

constexpr int kThreads = GRID_DUAL_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = GRID_DUAL_ROWS;
constexpr int kStepPx = GRID_DUAL_STEP_PX;
constexpr int kStepBlocks = kStepPx / 8;   // blocks of a component a warp takes a step
constexpr int kPlaneStride = kStepPx + 4;  // words of a plane row in shared memory
constexpr int kPlaneWords = kRows * kPlaneStride;
constexpr int kStageStride = 72;           // int16 of a staged block (64 and 8 of padding)
constexpr int kPad = GRID_DUAL_PAD;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kStepBlocks * kRows == 32, "a lane takes one row of a block");
static_assert(kRows * 4 == 32 && kStepPx == 4 * 8, "a lane scores 8 words of one row");

// How the tile stack is read: 4 B or 16 B copies (ops/kernels.py
// GRID_DUAL_VARIANTS; 0 is the composition, which launches no grid_dual).
enum { kWords = 1, kVec16 = 2 };

struct Args {
  const uint8_t* tiles;
  const uint8_t* prev;
  const int32_t* lq;
  const int32_t* cq;
  int32_t* types;
  uint8_t* filtered;
  uint8_t* last;
  int16_t* y;
  int16_t* cb;
  int16_t* cr;
  uint32_t* scratch;          // the exchange (grid_dual_scratch_words(cap)), PNG only
  unsigned long long base;    // tickets taken on it by earlier launches
  uint32_t tag;               // the flag value of this launch
  int cap;                    // CTAs the scratch holds
  int gx, th, tw, w;          // w: canvas pixels a row
  int r0, rows;               // the range's first canvas row and its row count
  int ctas, chunk_px, win_px, windows;
};

// Shared memory, carved from the dynamic allocation in this order; each
// warp has its own raw rows, planes and staged blocks.
struct Smem {
  uint32_t* raw;      // [kWarps][kRows + 1][stride]: the row above, then the strip's rows
  int32_t* plane;     // [kWarps][3][kPlaneWords]: Y, Cb, Cr after the row passes, then
                      // the quantized blocks, [3][kStepBlocks * kStageStride] int16
  int32_t* q;         // [2][64]: luma, chroma tables
  uint32_t* m;        // [2][64]: their reciprocals
  uint32_t* wsums;    // [kWarps][kRows][FILTER_COUNT]: each warp's sums
  uint32_t* partial;  // [kRows][FILTER_COUNT]: this CTA's sums
  uint32_t* gather;   // [GRID_DUAL_MAX_CTAS][GRID_DUAL_SUMS]: the strip's CTAs' sums
  int* choice;        // [kRows]
  int* ticket;        // [1]
};

constexpr size_t kPlaneBytes = (size_t)kWarps * 3 * kPlaneWords * 4;
static_assert(3 * kStepBlocks * kStageStride * 2 <= 3 * kPlaneWords * 4,
              "the staged blocks fit in the planes they replace");
constexpr size_t kFixedBytes = kPlaneBytes + 2 * 64 * 4 + 2 * 64 * 4 +
                               (size_t)kWarps * kRows * FILTER_COUNT * 4 +
                               kRows * FILTER_COUNT * 4 + GRID_DUAL_MAX_CTAS * GRID_DUAL_SUMS * 4 +
                               kRows * 4 + 16;

size_t smem_bytes(int stride) { return (size_t)kWarps * (kRows + 1) * stride * 4 + kFixedBytes; }

__device__ __forceinline__ Smem carve(uint8_t* base, int stride) {
  Smem s;
  s.raw = reinterpret_cast<uint32_t*>(base);
  base += (size_t)kWarps * (kRows + 1) * stride * 4;
  s.plane = reinterpret_cast<int32_t*>(base);
  base += kPlaneBytes;
  s.q = reinterpret_cast<int32_t*>(base);
  base += 2 * 64 * 4;
  s.m = reinterpret_cast<uint32_t*>(base);
  base += 2 * 64 * 4;
  s.wsums = reinterpret_cast<uint32_t*>(base);
  base += (size_t)kWarps * kRows * FILTER_COUNT * 4;
  s.partial = reinterpret_cast<uint32_t*>(base);
  base += kRows * FILTER_COUNT * 4;
  s.gather = reinterpret_cast<uint32_t*>(base);
  base += GRID_DUAL_MAX_CTAS * GRID_DUAL_SUMS * 4;
  s.choice = reinterpret_cast<int*>(base);
  base += kRows * 4;
  s.ticket = reinterpret_cast<int*>(base);
  return s;
}

__device__ __forceinline__ void cp_async16(uint32_t* dst, const uint8_t* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint8_t* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most n of this thread's copy groups are in flight (n < 4:
// a warp's slice has at most GRID_DUAL_WIN_PX / 16 / GRID_DUAL_STEP_PX steps).
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}
static_assert(GRID_DUAL_WIN_PX / (GRID_DUAL_THREADS / 32) / GRID_DUAL_STEP_PX <= 4,
              "cp_async_wait takes 0..3");

__device__ __forceinline__ uint32_t load_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Queues one warp's copies of its slice [xs, x_end) into its raw rows:
// raw row j is canvas row row_first + j (row 0, the row above, only with
// kAbove), j <= n_rows; one commit group per step of kStepPx pixels, the
// left words (the pixel before xs, 0 at the canvas's edge) in the first.
template <int kVariant, bool kAbove>
__device__ __forceinline__ void load_slice(const Args& a, uint32_t* raw, int stride,
                                           int row_first, int n_rows, int xs, int x_end,
                                           int n_steps, int lane) {
  constexpr int j0 = kAbove ? 0 : 1;
  if (lane >= j0 && lane <= n_rows) {
    uint32_t* dst = raw + lane * stride + kPad - 1;
    if (xs > 0) {
      cp_async4(dst, grid_pixel(a.tiles, a.prev, row_first + lane, xs - 1, a.gx, a.th, a.tw));
    } else {
      *dst = 0u;
    }
  }
  // 16 B copies: lane l takes quad l % 8 of a step's rows l / 8, l / 8 + 4
  // and l / 8 + 8, the same rows every step.
  constexpr int kQuads = kStepPx / 4;
  constexpr int kLaneRows = (kRows + 1 + 32 / kQuads - 1) / (32 / kQuads);
  const uint8_t* rows[kLaneRows];  // the row's pixel 0, or null for a row not copied
  bool carry[kLaneRows];            // the row is the carry row, read at x * 4
#pragma unroll
  for (int m = 0; m < kLaneRows; ++m) {
    const int j = lane / kQuads + m * (32 / kQuads);
    const int r = row_first + j;
    carry[m] = r < 0;
    rows[m] = j < j0 || j > n_rows ? nullptr
              : carry[m]           ? a.prev
                                   : a.tiles + grid_row_offset(r, a.gx, a.th, a.tw);
  }
  for (int step = 0; step < n_steps; ++step) {
    const int xp = xs + step * kStepPx;
    if (kVariant == kVec16) {
      const int x = xp + 4 * (lane % kQuads);
      if (x < x_end) {
        const size_t col = grid_col_offset(x, a.th, a.tw);
#pragma unroll
        for (int m = 0; m < kLaneRows; ++m) {
          if (rows[m] == nullptr) continue;
          const int j = lane / kQuads + m * (32 / kQuads);
          cp_async16(raw + j * stride + kPad + (x - xs),
                     rows[m] + (carry[m] ? (size_t)x * 4u : col));
        }
      }
    } else {
      const int x = xp + lane;
      if (x < x_end) {
        const size_t col = grid_col_offset(x, a.th, a.tw);
        for (int j = j0; j <= n_rows; ++j) {
          const int r = row_first + j;
          const uint8_t* src =
              r < 0 ? a.prev + (size_t)x * 4u : a.tiles + grid_row_offset(r, a.gx, a.th, a.tw) + col;
          cp_async4(raw + j * stride + kPad + (x - xs), src);
        }
      }
    }
    cp_async_commit();
  }
}

// Eight words of a raw row from canvas pixel x0 (x0 - xs a multiple of 8)
// and the eight words to their left: the lane before's last word, or for
// the row's first lane (qd == 0) the word before x0 from shared memory.
// Every lane calls this together.
struct Octet {
  uint32_t w[8];
};

__device__ __forceinline__ void octet_and_left(const uint32_t* row, int at, int qd, Octet& x,
                                               Octet& left) {
  const uint4 lo = *reinterpret_cast<const uint4*>(row + at);
  const uint4 hi = *reinterpret_cast<const uint4*>(row + at + 4);
  x.w[0] = lo.x;
  x.w[1] = lo.y;
  x.w[2] = lo.z;
  x.w[3] = lo.w;
  x.w[4] = hi.x;
  x.w[5] = hi.y;
  x.w[6] = hi.z;
  x.w[7] = hi.w;
  uint32_t before = __shfl_up_sync(kFull, hi.w, 1);
  if (qd == 0) before = row[at - 1];
  left.w[0] = before;
#pragma unroll
  for (int i = 1; i < 8; ++i) left.w[i] = x.w[i - 1];
}

// Lane (row k, quarter qd)'s scores of its 8 words of the step at xp.
__device__ __forceinline__ void score_step(const uint32_t* raw, int stride, int k, int qd,
                                           bool live, int xs, int xp, int x_end,
                                           uint32_t sums[FILTER_COUNT]) {
  const int x0 = xp + 8 * qd;
  Octet x, a, u, c;
  octet_and_left(raw + (k + 1) * stride + kPad, x0 - xs, qd, x, a);
  octet_and_left(raw + k * stride + kPad, x0 - xs, qd, u, c);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (live && x0 + i < x_end) filter_word_scores(x.w[i], a.w[i], u.w[i], c.w[i], sums);
  }
}

// The same lane's residues with filter `choice`, into out (the row's
// filtered bytes).
template <int kVariant>
__device__ __forceinline__ void write_step(const uint32_t* raw, int stride, int k, int qd,
                                           bool live, int xs, int xp, int x_end, int choice,
                                           uint8_t* out) {
  const int x0 = xp + 8 * qd;
  Octet x, a, u, c;
  octet_and_left(raw + (k + 1) * stride + kPad, x0 - xs, qd, x, a);
  octet_and_left(raw + k * stride + kPad, x0 - xs, qd, u, c);
  if (!live) return;
  uint32_t r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = filter_word_residue(choice, x.w[i], a.w[i], u.w[i], c.w[i]);
  if (kVariant == kVec16) {
    // x_end is a multiple of 4 here (tw % 4 == 0).
    uint4* o = reinterpret_cast<uint4*>(out) + (x0 >> 2);
    if (x0 < x_end) o[0] = make_uint4(r[0], r[1], r[2], r[3]);
    if (x0 + 4 < x_end) o[1] = make_uint4(r[4], r[5], r[6], r[7]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (x0 + i < x_end) reinterpret_cast<uint32_t*>(out)[x0 + i] = r[i];
    }
  }
}

__device__ __forceinline__ void store8(int32_t* dst, const int32_t v[8]) {
  *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<int4*>(dst + 4) = make_int4(v[4], v[5], v[6], v[7]);
}

// Row k of block b of the step: colour and the row passes into the planes.
__device__ __forceinline__ void row_task(const uint32_t* raw, int stride, int at, int b, int k,
                                         int32_t* plane) {
  const uint32_t* p = raw + (k + 1) * stride + kPad + at;
  const uint4 lo = *reinterpret_cast<const uint4*>(p);
  const uint4 hi = *reinterpret_cast<const uint4*>(p + 4);
  const uint32_t px8[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  int32_t r[8], g[8], bl[8], y[8], cb[8], cr[8];
  grid_rgb8(px8, r, g, bl);
  fdct_row_444(r, g, bl, y, cb, cr);
  const int o = k * kPlaneStride + b * 8;
  store8(plane + o, y);
  store8(plane + kPlaneWords + o, cb);
  store8(plane + 2 * kPlaneWords + o, cr);
}

// Column c of block b of each component: the column pass and the quantizer
// into the staged blocks, which take the planes' place once every lane of
// the warp has read its columns. Every lane calls this together.
__device__ __forceinline__ void column_tasks(int32_t* plane, const int32_t* q,
                                             const uint32_t* m, int b, int c, bool live) {
  int32_t v[3][8];
#pragma unroll
  for (int comp = 0; comp < 3; ++comp) {
#pragma unroll
    for (int r = 0; r < 8; ++r) v[comp][r] = plane[comp * kPlaneWords + r * kPlaneStride + b * 8 + c];
  }
  __syncwarp();
  int16_t* stage = reinterpret_cast<int16_t*>(plane);
  if (!live) return;
#pragma unroll
  for (int comp = 0; comp < 3; ++comp) {
    const int t = comp != 0;
    fdct_column(v[comp], c, q + 64 * t, m + 64 * t,
                stage + (comp * kStepBlocks + b) * kStageStride + c, 8);
  }
}

// 16 B number `part` of each component's staged block b to block `index`.
__device__ __forceinline__ void store_parts(const int16_t* stage, const Args& a, int b, int part,
                                            size_t index) {
  int16_t* outs[3] = {a.y, a.cb, a.cr};
#pragma unroll
  for (int comp = 0; comp < 3; ++comp) {
    reinterpret_cast<int4*>(outs[comp] + index * 64)[part] = *reinterpret_cast<const int4*>(
        stage + (comp * kStepBlocks + b) * kStageStride + part * 8);
  }
}

template <bool kPng, bool kJpeg, int kVariant>
__global__ void __launch_bounds__(kThreads, 2) grid_dual_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int stride = grid_dual_stride(a.win_px);
  const int slice_px = grid_dual_slice_px(a.win_px);
  const Smem s = carve(smem, stride);
  uint32_t* flags = a.scratch + 2;
  uint32_t* published = flags + a.cap;
  if (kJpeg && threadIdx.x < 128) {
    // The tables and their reciprocals, once per CTA: [0] luma, [1] chroma.
    const int t = threadIdx.x >> 6, i = threadIdx.x & 63;
    const int32_t q = (t ? a.cq : a.lq)[i];
    s.q[64 * t + i] = q;
    s.m[64 * t + i] = fdct_recip(q);
  }
  // The PNG half's CTAs take their work from tickets (see the head comment).
  if (kPng && threadIdx.x == 0) {
    *s.ticket = (int)(atomicAdd(reinterpret_cast<unsigned long long*>(a.scratch), 1ull) - a.base);
  }
  __syncthreads();
  const int id = kPng ? *s.ticket : (int)blockIdx.x;
  const int ranks = a.ctas;
  const int rank = id % ranks;
  const int strip = id / ranks;
  const int x_lo = rank * a.chunk_px;
  const int x_hi = min(a.w, x_lo + a.chunk_px);
  const int n_rows = min(kRows, a.rows - strip * kRows);
  const int row_first = a.r0 + strip * kRows - 1;  // canvas row of raw row 0
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* raw = s.raw + (size_t)warp * (kRows + 1) * stride;
  int32_t* plane = s.plane + (size_t)warp * 3 * kPlaneWords;
  const int16_t* stage = reinterpret_cast<const int16_t*>(plane);
  const int jb = lane >> 3, jk = lane & 7;  // JPEG: block of the step; row, then column
  const int pk = lane >> 2, qd = lane & 3;  // PNG: row of the strip; quarter of the step
  const bool png_live = pk < n_rows;

  // The JPEG half of step `step` of the slice [xs, x_end): the bytes are in
  // the warp's raw rows.
  auto jpeg_step = [&](int xs, int x_end, int step) {
    const int px = xs + step * kStepPx + 8 * jb;
    const bool live = px < x_end;
    if (live) row_task(raw, stride, px - xs, jb, jk, plane);
    __syncwarp();
    column_tasks(plane, s.q, s.m, jb, jk, live);
    __syncwarp();
    if (live) store_parts(stage, a, jb, jk, (size_t)strip * (a.w / 8) + px / 8);
    __syncwarp();
  };

  // Each window: the slice's copies, then per step the PNG scores and the
  // JPEG blocks. In the last window of the PNG half the JPEG blocks wait
  // until the CTA has published its sums, so that they run while the other
  // CTAs of the strip catch up.
  uint32_t sums[FILTER_COUNT] = {0u, 0u, 0u, 0u, 0u};
  int last_xs = 0, last_end = 0;
  for (int win = 0; win < a.windows; ++win) {
    const int xs = x_lo + win * a.win_px + warp * slice_px;
    const int x_end = min(x_hi, xs + slice_px);
    const bool defer = kPng && win == a.windows - 1;
    if (defer) last_xs = xs, last_end = x_end;
    if (x_end <= xs) continue;
    const int n_steps = (x_end - xs + kStepPx - 1) / kStepPx;
    __syncwarp();  // the previous window's readers are done
    load_slice<kVariant, kPng>(a, raw, stride, row_first, n_rows, xs, x_end, n_steps, lane);
    for (int step = 0; step < n_steps; ++step) {
      cp_async_wait(n_steps - 1 - step);
      __syncwarp();
      if (kPng) score_step(raw, stride, pk, qd, png_live, xs, xs + step * kStepPx, x_end, sums);
      if (kJpeg && !defer) jpeg_step(xs, x_end, step);
    }
    if (kPng && strip * kRows + n_rows == a.rows) {
      // The range's last raw row: this slice of it.
      const uint32_t* last = raw + n_rows * stride + kPad;
      for (int i = lane; i < x_end - xs; i += 32) {
        reinterpret_cast<uint32_t*>(a.last)[xs + i] = last[i];
      }
    }
  }

  if (kPng) {
    // Each row's sums: the warp's four lanes of the row, the CTA's warps,
    // published; later the strip's CTAs in rank order.
#pragma unroll
    for (int f = 0; f < FILTER_COUNT; ++f) {
      sums[f] += __shfl_xor_sync(kFull, sums[f], 1);
      sums[f] += __shfl_xor_sync(kFull, sums[f], 2);
    }
    if (qd == 0) {
#pragma unroll
      for (int f = 0; f < FILTER_COUNT; ++f) {
        s.wsums[(warp * kRows + pk) * FILTER_COUNT + f] = sums[f];
      }
    }
    __syncthreads();
    if (threadIdx.x < GRID_DUAL_SUMS) {
      uint32_t t = 0u;
      for (int w = 0; w < kWarps; ++w) t += s.wsums[w * GRID_DUAL_SUMS + threadIdx.x];
      s.partial[threadIdx.x] = t;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      uint32_t* mine = published + (size_t)id * GRID_DUAL_SUMS;
      for (int i = 0; i < GRID_DUAL_SUMS; ++i) mine[i] = s.partial[i];
      store_release(flags + id, a.tag);
    }
    if (kJpeg && last_end > last_xs) {
      for (int step = 0; step * kStepPx < last_end - last_xs; ++step) {
        jpeg_step(last_xs, last_end, step);
      }
    }
    if ((int)threadIdx.x < ranks) {
      // The sums of the strip's CTA of rank threadIdx.x, once its flag is up.
      const int other = strip * ranks + threadIdx.x;
      while (load_acquire(flags + other) != a.tag) {
      }
      for (int i = 0; i < GRID_DUAL_SUMS; ++i) {
        s.gather[threadIdx.x * GRID_DUAL_SUMS + i] =
            __ldcg(published + (size_t)other * GRID_DUAL_SUMS + i);
      }
    }
    __syncthreads();
    if ((int)threadIdx.x < n_rows) {
      const uint32_t* parts[GRID_DUAL_MAX_CTAS];
      for (int q = 0; q < ranks; ++q) parts[q] = s.gather + q * GRID_DUAL_SUMS;
      const int choice = grid_dual_choose(parts, ranks, threadIdx.x);
      s.choice[threadIdx.x] = choice;
      if (rank == 0) a.types[strip * kRows + threadIdx.x] = choice;
    }
    __syncthreads();

    const int choice = s.choice[pk < n_rows ? pk : 0];
    uint8_t* out = a.filtered + (size_t)(strip * kRows + pk) * (size_t)a.w * 4u;
    for (int win = 0; win < a.windows; ++win) {
      const int xs = x_lo + win * a.win_px + warp * slice_px;
      const int x_end = min(x_hi, xs + slice_px);
      if (x_end <= xs) continue;
      const int n_steps = (x_end - xs + kStepPx - 1) / kStepPx;
      if (a.windows > 1) {
        // The slice again, from L2: shared memory held the last window's.
        __syncwarp();
        load_slice<kVariant, true>(a, raw, stride, row_first, n_rows, xs, x_end, n_steps, lane);
        cp_async_wait(0);
        __syncwarp();
      }
      for (int step = 0; step < n_steps; ++step) {
        write_step<kVariant>(raw, stride, pk, qd, png_live, xs, xs + step * kStepPx, x_end,
                             choice, out);
      }
    }
  }
}

template <bool kPng, bool kJpeg, int kVariant>
int launch(const Args& a, int grid, cudaStream_t stream) {
  const auto kernel = grid_dual_kernel<kPng, kJpeg, kVariant>;
  const size_t smem = smem_bytes(grid_dual_stride(a.win_px));
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int kVariant>
int launch_halves(const Args& a, int png, int jpeg, int grid, cudaStream_t stream) {
  if (png && jpeg) return launch<true, true, kVariant>(a, grid, stream);
  if (png) return launch<true, false, kVariant>(a, grid, stream);
  return launch<false, true, kVariant>(a, grid, stream);
}

}  // namespace

// Launches the step over canvas rows [r0, r1) of the tile stack on `stream`
// and returns cudaGetLastError() (0 = launched), or cudaErrorInvalidValue
// for what the kernel does not take. tiles: (gy, gx, th, tw, 4) uint8,
// contiguous; prev: the (gx * tw * 4,) carry row, read for r0 = 0 (row r0 - 1
// comes from the tiles otherwise); lq, cq: (64,) int32 natural-order tables,
// each entry from 1 to 2^28. png: types (rows,) int32, filtered (rows, W * 4)
// uint8 and last (W * 4,) uint8, the range's last raw row; jpeg (rows and W
// multiples of 8): y, cb, cr (rows / 8 * W / 8, 64) int16 each, strip-major,
// 16 B aligned. variant: 1 4 B copies (tiles, prev 4 B aligned), 2 16 B
// copies (tw % 4 == 0; tiles, prev, filtered and last 16 B aligned).
// With png, scratch: grid_dual_scratch_words(cap) uint32 words, 8 B aligned,
// zeroed when made and from then on written by these launches only, all of
// them on one stream; cap: at least grid_dual_ctas(...) of this launch;
// base: the CTAs that earlier launches on it ran; tag: a value no earlier
// launch on it passed.
extern "C" int grid_dual_launch(const uint8_t* tiles, const uint8_t* prev, int gx, int th,
                                int tw, int r0, int r1, const int32_t* lq, const int32_t* cq,
                                int png, int jpeg, int variant, int32_t* types,
                                uint8_t* filtered, uint8_t* last, int16_t* y, int16_t* cb,
                                int16_t* cr, uint32_t* scratch, int cap,
                                unsigned long long base, uint32_t tag, void* stream) {
  const int w = gx * tw;
  const int rows = r1 - r0;
  if (rows <= 0 || w <= 0 || r0 < 0 || (!png && !jpeg)) return (int)cudaErrorInvalidValue;
  if (jpeg && (rows % kRows || w % 8)) return (int)cudaErrorInvalidValue;
  uintptr_t addr = (uintptr_t)tiles;
  if (png) addr |= (uintptr_t)filtered | (uintptr_t)last | (r0 == 0 ? (uintptr_t)prev : 0u);
  if (variant == kVec16) {
    if (tw % 4 || addr % 16) return (int)cudaErrorInvalidValue;
  } else if (variant != kWords || addr % 4) {
    return (int)cudaErrorInvalidValue;
  }
  const GridDualSplit split = grid_dual_split(w);
  const int grid = grid_dual_ctas(rows, w);
  if (png && (scratch == nullptr || (uintptr_t)scratch % 8 || cap < grid)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.tiles = tiles;
  a.prev = prev;
  a.lq = lq;
  a.cq = cq;
  a.types = types;
  a.filtered = filtered;
  a.last = last;
  a.y = y;
  a.cb = cb;
  a.cr = cr;
  a.scratch = scratch;
  a.base = base;
  a.tag = tag;
  a.cap = cap;
  a.gx = gx;
  a.th = th;
  a.tw = tw;
  a.w = w;
  a.r0 = r0;
  a.rows = rows;
  a.ctas = split.ctas;
  a.chunk_px = split.chunk_px;
  a.win_px = split.win_px;
  a.windows = split.windows;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == kVec16) return launch_halves<kVec16>(a, png, jpeg, grid, s);
  return launch_halves<kWords>(a, png, jpeg, grid, s);
}
