// Windowed bilinear lookup from a correlation pyramid (Hopper).
//
// Every kernel here computes DROID's corr_index_forward for radius 3: a
// 7x7 window per pixel and level, sampled bilinearly from an 8x8 tap
// support, level coordinates x0 / 2^l, window start floor(x_l) - 3,
// out-of-bounds taps exactly 0, output channel lvl*49 + a*7 + b (a = x
// offset, b = y offset).  Three device kernels:
//
// corr_lookup_grouped4_kernel replaces the TPU kernel
//   nerf_slam_tpu/ops/corr_pallas.py  lookup_pyramid_grouped4_nhwc
//   (_make_grouped4_kernel), gated and ungated.
// Its rounding is reproduced exactly: the x and y bilinear "hat" weights
// are rounded to bf16, each row's y-interpolation is rounded to bf16, the
// x pass sums in fp32, and the result is cast to the output type.
// Non-finite coords select nothing (the output is 0).  Slabs may carry
// padded rows; taps at or beyond the real level dims are masked.  With an
// active-edge count (n_act, read from device memory, so the host never
// syncs), slots >= n_act skip the gather and WRITE ZEROS: the caller
// allocates the output with torch.empty, and garbage left there would
// reach the GRU's per-keyframe segment sums, where NaN * 0 spreads.
//
// The same device kernel, in its exact mode (kExact), replaces the TPU
// kernel
//   nerf_slam_tpu/ops/corr_pallas.py  lookup_pyramid_pallas_nhwc
//   (_lookup_pyramid_kernel / _level_lookup_body): exact bf16 taps with
//   fp32 bilinear weights, summed as w00*S00 + w10*S10 + w01*S01 +
//   w11*S11 in that order, fp32 output, no gate.
// corr_level_kernel computes the same function for one level (coords
// already in level units, 49 channels) and replaces the two single-level
// TPU kernels
//   nerf_slam_tpu/ops/corr_pallas.py  lookup_level_pallas_nhwc
//   (_lookup_kernel) and lookup_level_pallas_grouped_nhwc
//   (_lookup_kernel_grouped).
// Both compute this same function with the same term order; the second
// groups 16 pixels into one block-diagonal one-hot matmul to fill the
// MXU and stores y-major for its wrapper to swap back, which has no
// counterpart in a gather.  Taps are bounds-checked against the slab as
// it is given (row padding included: padded rows hold zeros).
//
// corr_lookup_l0_kernel (further down) derives all four levels from the
// level-0 slab.
//
// The Pallas kernels build one-hot and hat matrices and contract them on
// the MXU because a TPU has no fast gather.  Here the lookup is a direct
// gather.  All arithmetic uses the _rn intrinsics so that no multiply-add
// is contracted: the plain PyTorch versions in corr_lookup.py then match
// bit for bit.
//
// Bound on the card: bytes.  Per active pixel and edge the lookup must
// read the in-bounds part of 4 levels x 8 x 8 bf16 taps (at most 512 B;
// DRAM moves them as 32 B sectors, up to 2 per support row, so up to
// 2 KB) plus 8 B of coords; every slot writes 196 outputs (392 B bf16 /
// 784 B fp32).  About 1,300 flops go with that, ~2 flops per byte, far
// below where an H100 turns compute-bound, so the tensor cores have
// nothing to do here and the design is about how the bytes move.
// chip_smoke.py computes both figures (elements and sectors) from each
// call's coords and reports the kernels' times beside them.
//
// What corr_lookup_grouped4_kernel does about it: one WARP per (pixel,
// edge).  The 4 levels x 8 support rows are 32 rows, one a lane; a lane
// computes its level's window, hat weights and bounds once and loads its
// row's 8 taps once, as aligned 4-byte words (5 when the row starts on an
// odd element, realigned with a funnel shift) or, for a level whose base
// is not 4-byte aligned or whose element count is odd, as 2-byte loads.
// The y pass takes the row below from the neighbouring lane with
// __shfl_down_sync, so no support row is loaded twice.  The 196 outputs
// are transposed to channel order through shared memory and leave as one
// contiguous run of 16-byte stores (an 8-byte head or tail where a bf16
// pixel starts on an odd 8 bytes); gated-off slots write their zeros the
// same way.  corr_level_kernel does the same with eight lanes a pixel,
// four pixels a warp, and 16-byte loads.
//
// The motion filter's lookup (#2) runs at one edge slot, 42 x 80 pixels.
// Its first design (one block per source row and edge, one thread per
// pixel, level and window row, scalar 2-byte loads, 7 strided stores a
// thread) put 42 blocks on 132 SMs.  It now takes the grouped4 kernel's
// exact mode: 3,360 warps (420 blocks), a lane per (level, support row)
// with word loads, and each pixel's 196 fp32 outputs leave as one aligned
// 784-byte run (49 16-byte stores, no head or tail).  corr_level_kernel
// was the other candidate; it would need one launch per level, or a
// four-level variant whose 49-channel runs start 196*l bytes into a
// pixel's record, off the 16-byte grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kRd = 7;       // window taps per axis (2r + 1), r = 3
constexpr int kSup = 8;      // support taps per axis
constexpr int kLevels = 4;

struct Levels {
  const __nv_bfloat16* ptr[kLevels];
  int slab_h[kLevels];       // rows of each level's slab (may be padded)
  int slab_w[kLevels];
  int real_h[kLevels];       // taps at or beyond the real dims are masked
  int real_w[kLevels];
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float hat(float base, float star) {
  // max(1 - |base - star|, 0), rounded to bf16 (the TPU kernel's select)
  return round_bf16(fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(base, star))),
                          0.0f));
}

// ---------------------------------------------------------------------------
// The four-level lookups: the update loop's from four pooled slabs (hat
// rounding) and the motion filter's from four unpadded levels (exact).
// ---------------------------------------------------------------------------

__device__ __forceinline__ float bf_lo(uint32_t p) {      // lower address
  return __uint_as_float(p << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t p) {
  return __uint_as_float(p & 0xffff0000u);
}

// The support row at element offset off of the tensor at base (the
// offset of tap x0; it may be < 0): taps x0 .. x0 + 7, two to a word, the
// lower address in the low half; taps with x0 + k outside [0, wr) are 0.
// p must hold zeros.  kBytes, the width of each load: 2 (any tensor); 4
// (aligned words, 5 where off is odd, realigned with a funnel shift) or 16
// (the two aligned 16-byte chunks that the row spans, realigned by
// selects and a funnel shift).  The caller allows a width of w bytes only
// where the base is w-byte aligned and the element count a multiple of
// w / 2, so that the chunk around any in-bounds tap lies inside the
// tensor; only chunks that hold an in-bounds tap are loaded.
template <int kBytes>
__device__ __forceinline__ void load_support_row(const __nv_bfloat16* base,
                                                 int64_t off, int x0, int wr,
                                                 uint32_t (&p)[kSup / 2]) {
  auto okc = [&](int k) {
    return k >= 0 && k < kSup && x0 + k >= 0 && x0 + k < wr;
  };
  if (kBytes == 16) {
    const int s = static_cast<int>(off & 7);   // tap 0 within chunk 0
    const uint4* cp = reinterpret_cast<const uint4*>(base) + ((off - s) >> 3);
    bool any0 = false, any1 = false;
#pragma unroll
    for (int k = 0; k < kSup; ++k) {
      any0 |= okc(k) && k < 8 - s;
      any1 |= okc(k) && k >= 8 - s;
    }
    const uint4 c0 = any0 ? __ldg(cp) : make_uint4(0u, 0u, 0u, 0u);
    const uint4 c1 = any1 ? __ldg(cp + 1) : make_uint4(0u, 0u, 0u, 0u);
    const uint32_t w[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    const int j = s >> 1;                      // word of tap 0
    uint32_t a[6], b[5];
#pragma unroll
    for (int i = 0; i < 6; ++i) a[i] = (j & 2) ? w[i + 2] : w[i];
#pragma unroll
    for (int i = 0; i < 5; ++i) b[i] = (j & 1) ? a[i + 1] : a[i];
#pragma unroll
    for (int i = 0; i < kSup / 2; ++i)
      p[i] = (s & 1) ? __funnelshift_r(b[i], b[i + 1], 16) : b[i];
  } else if (kBytes == 4) {
    const int odd = static_cast<int>(off & 1);
    const uint32_t* wp =
        reinterpret_cast<const uint32_t*>(base) + ((off - odd) >> 1);
    uint32_t w[kSup / 2 + 1];
#pragma unroll
    for (int i = 0; i <= kSup / 2; ++i)        // word i: taps 2i-odd, 2i-odd+1
      w[i] = (okc(2 * i - odd) || okc(2 * i - odd + 1)) ? __ldg(wp + i) : 0u;
#pragma unroll
    for (int i = 0; i < kSup / 2; ++i)
      p[i] = odd ? __funnelshift_r(w[i], w[i + 1], 16) : w[i];
  } else {
    const unsigned short* hp =
        reinterpret_cast<const unsigned short*>(base) + off;
#pragma unroll
    for (int k = 0; k < kSup; ++k)
      if (okc(k))
        p[k / 2] |= static_cast<uint32_t>(__ldg(hp + k)) << (16 * (k & 1));
  }
#pragma unroll
  for (int i = 0; i < kSup / 2; ++i)
    p[i] &= (okc(2 * i) ? 0x0000ffffu : 0u)
            | (okc(2 * i + 1) ? 0xffff0000u : 0u);
}

constexpr int kG4Warps = 8;                    // pixels per block, one a warp
constexpr int kCh4 = kLevels * kRd * kRd;      // 196

// One pixel's kCh4 outputs as one contiguous run: 16-byte stores from the
// first 16-byte boundary, with an 8-byte head or tail where the run starts
// or ends on an odd 8 bytes (g is 8-byte aligned, the run a multiple of
// 8).  stage holds the run at stage + (g & 15), so that it shares the
// alignment of g; stage == nullptr writes zeros.
template <typename OutT>
__device__ __forceinline__ void store_run(OutT* gout,
                                          const unsigned char* stage,
                                          int lane) {
  constexpr int kBytes = kCh4 * static_cast<int>(sizeof(OutT));
  unsigned char* g = reinterpret_cast<unsigned char*>(gout);
  const int d = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
  const int t0 = (16 - d) & 15;                // first aligned byte: 0 or 8
  const int n16 = (kBytes - t0) / 16;
  const int tail = t0 + n16 * 16;
  const unsigned char* s = stage ? stage + d : nullptr;   // byte t at s + t
  if (t0 != 0 && lane == 0)
    *reinterpret_cast<uint2*>(g) =
        stage ? *reinterpret_cast<const uint2*>(s) : make_uint2(0u, 0u);
  for (int i = lane; i < n16; i += 32)
    *reinterpret_cast<uint4*>(g + t0 + 16 * i) =
        stage ? *reinterpret_cast<const uint4*>(s + t0 + 16 * i)
              : make_uint4(0u, 0u, 0u, 0u);
  if (tail < kBytes && lane == 31)
    *reinterpret_cast<uint2*>(g + tail) =
        stage ? *reinterpret_cast<const uint2*>(s + tail)
              : make_uint2(0u, 0u);
}

// vec_mask bit l: level l may be read as aligned 4-byte words (its base is
// 4-byte aligned and its element count even, so that the word around any
// in-bounds element lies inside the tensor); else 2-byte loads.
// kExact (kernel #2, OutT float, no n_act): exact taps and the fp32
// weights (1-dx)(1-dy), dx(1-dy), (1-dx)dy, dx dy in the four-term order
// above; a non-finite coord gives NaN, as in the plain version.
template <typename OutT, bool kExact>
__global__ void __launch_bounds__(kG4Warps * 32)
corr_lookup_grouped4_kernel(const __grid_constant__ Levels lv, int vec_mask,
                            const float2* __restrict__ coords,
                            const int* __restrict__ n_act,
                            OutT* __restrict__ out, int64_t n_pix,
                            int64_t pix_per_slot) {
  constexpr int kStage = (kCh4 * static_cast<int>(sizeof(OutT)) + 31) / 16 * 16;
  __shared__ __align__(16) unsigned char stage_all[kG4Warps][kStage];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t pix = static_cast<int64_t>(blockIdx.x) * kG4Warps + warp;
  if (pix >= n_pix) return;                    // warps never sync as a block
  OutT* opix = out + pix * kCh4;
  if (!kExact && n_act != nullptr && pix / pix_per_slot >= __ldg(n_act)) {
    store_run<OutT>(opix, nullptr, lane);
    return;
  }

  const int lvl = lane >> 3;                   // this lane's level
  const int r = lane & 7;                      // and support row
  const float2 c = coords[pix];
  const float inv = 1.0f / static_cast<float>(1 << lvl);   // exact
  const float xl = __fmul_rn(c.x, inv);
  const float yl = __fmul_rn(c.y, inv);
  const float fx = floorf(xl);
  const float fy = floorf(yl);
  const float dx = __fsub_rn(xl, fx);
  const float dy = __fsub_rn(yl, fy);
  const int hs = lv.slab_h[lvl];
  const int ws = lv.slab_w[lvl];
  const int hr = min(lv.real_h[lvl], hs);
  const int wr = min(lv.real_w[lvl], ws);

  // window start as a float, clipped as the TPU kernel clips it
  const float xi = fminf(fmaxf(__fsub_rn(fx, 3.0f), -8.0f),
                         static_cast<float>(lv.real_w[lvl] + 8));
  const float yi = fminf(fmaxf(__fsub_rn(fy, 3.0f), -8.0f),
                         static_cast<float>(lv.real_h[lvl] + 8));
  // kExact: (w00, w10, w01, w11); else the hat weights (wy0, wy1, wx0, wx1)
  float wa, wb, wc, wd;
  if (kExact) {
    const float ox = __fsub_rn(1.0f, dx);
    const float oy = __fsub_rn(1.0f, dy);
    wa = __fmul_rn(ox, oy);
    wb = __fmul_rn(dx, oy);
    wc = __fmul_rn(ox, dy);
    wd = __fmul_rn(dx, dy);
  } else {
    float xs = __fadd_rn(xi, dx);
    float ys = __fadd_rn(yi, dy);
    if (!isfinite(xs)) xs = -1e4f;             // selects nothing
    if (!isfinite(ys)) ys = -1e4f;
    wa = hat(yi, ys);
    wb = hat(__fadd_rn(yi, 1.0f), ys);
    wc = hat(xi, xs);
    wd = hat(__fadd_rn(xi, 1.0f), xs);
  }

  // this lane's support row: taps x0 .. x0 + 7 of row y0, two to a word
  const int y0 = static_cast<int>(yi) + r;
  const int x0 = static_cast<int>(xi);
  uint32_t p[kSup / 2] = {0u, 0u, 0u, 0u};
  if (y0 >= 0 && y0 < hr && x0 + kSup > 0 && x0 < wr) {
    const int64_t off = (pix * hs + y0) * ws + x0;
    if ((vec_mask >> lvl) & 1)
      load_support_row<4>(lv.ptr[lvl], off, x0, wr, p);
    else
      load_support_row<2>(lv.ptr[lvl], off, x0, wr, p);
  }

  // the row below comes from the next lane (row 7 has none and writes
  // nothing)
  float t0[kSup], t1[kSup];
#pragma unroll
  for (int i = 0; i < kSup / 2; ++i) {
    const uint32_t q = __shfl_down_sync(0xffffffffu, p[i], 1);
    t0[2 * i] = bf_lo(p[i]);
    t0[2 * i + 1] = bf_hi(p[i]);
    t1[2 * i] = bf_lo(q);
    t1[2 * i + 1] = bf_hi(q);
  }
  unsigned char* stage = stage_all[warp];
  if (r < kRd) {
    OutT* sp = reinterpret_cast<OutT*>(
        stage + (reinterpret_cast<uintptr_t>(opix) & 15)) + lvl * kRd * kRd + r;
    if (kExact) {
#pragma unroll
      for (int a = 0; a < kRd; ++a) {
        float v = __fadd_rn(__fmul_rn(wa, t0[a]), __fmul_rn(wb, t0[a + 1]));
        v = __fadd_rn(v, __fmul_rn(wc, t1[a]));
        store(sp + a * kRd, __fadd_rn(v, __fmul_rn(wd, t1[a + 1])));
      }
    } else {
      // y pass rounded to bf16, then the x pass in fp32
      float row[kSup];
#pragma unroll
      for (int k = 0; k < kSup; ++k)
        row[k] = round_bf16(__fadd_rn(__fmul_rn(wa, t0[k]),
                                      __fmul_rn(wb, t1[k])));
#pragma unroll
      for (int a = 0; a < kRd; ++a)
        store(sp + a * kRd,
              __fadd_rn(__fmul_rn(wc, row[a]), __fmul_rn(wd, row[a + 1])));
    }
  }
  __syncwarp();
  store_run<OutT>(opix, stage, lane);
}

// ---------------------------------------------------------------------------
// One stored level, exact taps (kernels #3 and #5).
// ---------------------------------------------------------------------------
// Eight lanes a pixel, lane r owning support row r, so a warp serves
// four neighbouring pixels.  A lane loads its row's 8 taps once, as the
// one or two aligned 16-byte chunks that the row spans (2-byte loads on a
// slab that does not allow them), takes the row below from the next lane
// with __shfl_down_sync (row 7 has none and writes nothing), and computes
// the 7 outputs of window row b = r.  The warp's 4 x 49 fp32 outputs are
// one contiguous run of 784 bytes, transposed to channel order through
// shared memory and stored as 49 16-byte words.  What remains of its time
// is the tap reads, one or two 32-byte sectors a row with a plane (7-8 KB
// at level 0) between neighbouring pixels, which an H100's HBM serves at
// about half its streaming rate, and the fp32 output.
constexpr int kLvWarps = 8;                   // warps per block
constexpr int kLvPix = 4;                     // pixels per warp, 8 lanes each
constexpr int kCh1 = kRd * kRd;               // 49

__global__ void __launch_bounds__(kLvWarps * 32)
corr_level_kernel(const __nv_bfloat16* __restrict__ vol, int wide,
                  const float2* __restrict__ coords, float* __restrict__ out,
                  int64_t n_pix, int hs, int ws) {
  __shared__ __align__(16) float stage_all[kLvWarps][kLvPix * kCh1];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t pix0 =
      (static_cast<int64_t>(blockIdx.x) * kLvWarps + warp) * kLvPix;
  if (pix0 >= n_pix) return;                   // warps never sync as a block
  const int q = lane >> 3;                     // this lane's pixel
  const int r = lane & 7;                      // and support row
  const int64_t pix = pix0 + q;

  // a pixel past the end keeps zeros: its lanes still take part in the
  // shuffle, and its outputs are never stored
  uint32_t p[kSup / 2] = {0u, 0u, 0u, 0u};
  float w00 = 0.0f, w10 = 0.0f, w01 = 0.0f, w11 = 0.0f;
  if (pix < n_pix) {
    const float2 c = coords[pix];
    const float fx = floorf(c.x);
    const float fy = floorf(c.y);
    const float dx = __fsub_rn(c.x, fx);
    const float dy = __fsub_rn(c.y, fy);
    const int xi = static_cast<int>(fminf(fmaxf(__fsub_rn(fx, 3.0f), -8.0f),
                                          static_cast<float>(ws + 8)));
    const int yi = static_cast<int>(fminf(fmaxf(__fsub_rn(fy, 3.0f), -8.0f),
                                          static_cast<float>(hs + 8)));
    const float ox = __fsub_rn(1.0f, dx);
    const float oy = __fsub_rn(1.0f, dy);
    w00 = __fmul_rn(ox, oy);
    w10 = __fmul_rn(dx, oy);
    w01 = __fmul_rn(ox, dy);
    w11 = __fmul_rn(dx, dy);
    const int y0 = yi + r;
    if (y0 >= 0 && y0 < hs && xi + kSup > 0 && xi < ws) {
      const int64_t off = (pix * hs + y0) * ws + xi;
      if (wide)
        load_support_row<16>(vol, off, xi, ws, p);
      else
        load_support_row<2>(vol, off, xi, ws, p);
    }
  }

  float t0[kSup], t1[kSup];
#pragma unroll
  for (int i = 0; i < kSup / 2; ++i) {
    const uint32_t below = __shfl_down_sync(0xffffffffu, p[i], 1);
    t0[2 * i] = bf_lo(p[i]);
    t0[2 * i + 1] = bf_hi(p[i]);
    t1[2 * i] = bf_lo(below);
    t1[2 * i + 1] = bf_hi(below);
  }
  float* stage = stage_all[warp];
  if (r < kRd) {
    float* sp = stage + q * kCh1 + r;
#pragma unroll
    for (int a = 0; a < kRd; ++a) {
      float v = __fadd_rn(__fmul_rn(w00, t0[a]), __fmul_rn(w10, t0[a + 1]));
      v = __fadd_rn(v, __fmul_rn(w01, t1[a]));
      sp[a * kRd] = __fadd_rn(v, __fmul_rn(w11, t1[a + 1]));
    }
  }
  __syncwarp();
  float* o = out + pix0 * kCh1;                // 16-byte aligned
  const int n_live = static_cast<int>(
      n_pix - pix0 < kLvPix ? n_pix - pix0 : kLvPix);
  if (n_live == kLvPix) {
    for (int i = lane; i < kLvPix * kCh1 / 4; i += 32)
      reinterpret_cast<float4*>(o)[i] =
          reinterpret_cast<const float4*>(stage)[i];
  } else {
    for (int i = lane; i < n_live * kCh1; i += 32) o[i] = stage[i];
  }
}

// ---------------------------------------------------------------------------
// The 4-level lookup from the LEVEL-0 slab alone.  Replaces the TPU kernel
//   nerf_slam_tpu/ops/corr_pallas.py  lookup_pyramid_l0_nhwc
//   (_make_l0_kernel).
// ---------------------------------------------------------------------------
// Average pooling commutes with the windowed sampling, so a level-l tap is
// the sum of its 2^l x 2^l level-0 block, with 4^-l folded into the
// bilinear weights; the edge state then stores one slab, not four.  The
// TPU kernel's rounding is kept: for each support tap the level-0 rows of
// the block are summed in fp32 per column, row after row, and ROUNDED TO
// bf16, the block's columns are then summed in fp32, column after column,
// and the fp32 weights scale*(1-dx)*(1-dy) ... combine the four
// neighbours in the order w00*S00 + w10*S10 + w01*S01 + w11*S11.  The
// order inside each sum is the plain version's (a sum of rounded sums is
// exact only while the exponents stay close, so no partial sum is shared
// between levels).  Support taps at or beyond the real (floor-cropped)
// level dims are masked, which also keeps cropped and padded level-0 rows
// out of the block sums.
//
// Bound on the card: bytes.  Level 3's support spans 64 x 64 level-0
// elements, most of the plane at the tracking shapes, so the least traffic
// is the part of every plane that window covers plus the fp32 output: up
// to 1.24 GB + 126 MB at 48 slots of 42 x 80 pixels with 48 x 80 planes
// (chip_smoke.py counts the covered part on its coords), several times
// the four-slab lookup's.  The single slab saves memory and costs reads.
//
// What the design does about it: each pixel's plane crosses the memory
// bus once.  One warp serves one pixel at a time and walks over many
// pixels.  Lane 0 asks the copy engine for the rows that the pixel's
// windows cover (one cp.async.bulk of one contiguous, 16-byte aligned run,
// completion counted on an mbarrier) into the warp's own ring of shared
// memory stages, one pixel ahead of the one being summed, so the copies of
// one pixel run under the sums of another and no thread spends
// cycles on addresses.  All four levels are then summed from that
// staged copy with every lane doing the same work: at level l a lane owns
// two neighbouring level-0 columns (one 4-byte shared-memory load where
// the width is even) of 2^l support rows, sums them down its blocks' rows,
// rounds, and the 2^(l-1) lanes of a tap chain their columns left to right
// with __shfl_up_sync.  The 256 block sums and 16 weights go through
// shared memory, and the 196 outputs leave as 16-byte stores of one
// contiguous run.  A slab whose planes are not 16-byte aligned is staged by
// the warp with 2-byte loads (kL0Coop); one whose plane does not fit the
// shared memory is summed straight from device memory (kL0Direct).
constexpr int kL0Warps = 4;        // warps per block; corr_lookup.py L0_WARPS
constexpr int kL0Stages = 2;       // ring depth;      corr_lookup.py L0_STAGES
constexpr int kL0Scratch = kLevels * kSup * kSup + 4 * kLevels;   // floats
constexpr int kL0SmemMax = 232448 - 1024;    // a block's most; L0_SMEM_MAX
enum { kL0Bulk = 0, kL0Coop = 1, kL0Direct = 2 };
constexpr int kL0Fixed =           // a block's bytes beside its stages
    kL0Warps * (kL0Scratch * sizeof(float)
                + kL0Stages * (sizeof(uint64_t) + sizeof(float2)));

__host__ __device__ constexpr int l0_stages(int mode) {
  return mode == kL0Bulk ? kL0Stages : mode == kL0Coop ? 1 : 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// window start of level l along an axis of real size nl
__device__ __forceinline__ int l0_start(float c, int l, int nl) {
  const float f = floorf(__fmul_rn(c, 1.0f / static_cast<float>(1 << l)));
  return static_cast<int>(
      fminf(fmaxf(__fsub_rn(f, 3.0f), -8.0f), static_cast<float>(nl + 8)));
}

// level-0 rows [r0, r1) that the four windows of a pixel at height cy
// cover, widened to multiples of gran rows (r1 at most the slab's rows)
__device__ __forceinline__ void l0_rows(const Levels& lv, float cy, int gran,
                                        int& r0, int& r1) {
  r0 = lv.slab_h[0];
  r1 = 0;
#pragma unroll
  for (int l = 0; l < kLevels; ++l) {
    const int yi = l0_start(cy, l, lv.real_h[l]);
    const int lo = max(yi, 0), hi = min(yi + kSup, lv.real_h[l]);
    if (hi > lo) {
      r0 = min(r0, lo << l);
      r1 = max(r1, hi << l);
    }
  }
  if (r1 <= r0) {
    r0 = r1 = 0;
    return;
  }
  r0 -= r0 % gran;
  r1 = min(lv.slab_h[0], (r1 + gran - 1) / gran * gran);
}

template <bool kPair>
__device__ __forceinline__ void l0_load2(const __nv_bfloat16* q, float& a,
                                         float& b) {
  if (kPair) {
    const uint32_t p = *reinterpret_cast<const uint32_t*>(q);
    a = bf_lo(p);
    b = bf_hi(p);
  } else {
    a = __bfloat162float(q[0]);
    b = __bfloat162float(q[1]);
  }
}

// The 64 block sums of level L into S[L][a][b] (a = support column, b =
// support row) and its four weights into Wt[L], from the staged rows t
// (t[0] is element (r0, 0) of the plane).
template <int L, bool kPair>
__device__ __forceinline__ void l0_level(const __nv_bfloat16* t, int r0,
                                         int W2, int hl, int wl, float2 c,
                                         int lane, float* S, float* Wt) {
  constexpr int n = 1 << L;                    // block edge, level-0 units
  const float inv = 1.0f / static_cast<float>(n);          // exact
  const float xl = __fmul_rn(c.x, inv);
  const float yl = __fmul_rn(c.y, inv);
  const int xi = l0_start(c.x, L, wl);
  const int yi = l0_start(c.y, L, hl);
  if (lane == 0) {
    const float dx = __fsub_rn(xl, floorf(xl));
    const float dy = __fsub_rn(yl, floorf(yl));
    const float scale = inv * inv;                          // 4^-l, exact
    const float ox = __fsub_rn(1.0f, dx);
    const float oy = __fsub_rn(1.0f, dy);
    Wt[4 * L + 0] = __fmul_rn(__fmul_rn(scale, ox), oy);
    Wt[4 * L + 1] = __fmul_rn(__fmul_rn(scale, dx), oy);
    Wt[4 * L + 2] = __fmul_rn(__fmul_rn(scale, ox), dy);
    Wt[4 * L + 3] = __fmul_rn(__fmul_rn(scale, dx), dy);
  }
  S += L * kSup * kSup;
  if (L == 0) {                                // a tap is one element
    const int a = lane & 7;
    const int tx = xi + a;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (lane >> 3) + 4 * h;
      const int ty = yi + r;
      const bool ok = tx >= 0 && tx < wl && ty >= 0 && ty < hl;
      S[a * kSup + r] = ok ? __bfloat162float(t[(ty - r0) * W2 + tx]) : 0.0f;
    }
    return;
  }
  constexpr int P = n > 1 ? n / 2 : 1;         // lanes per tap (column pairs)
  constexpr int GL = kSup * P;                 // lanes per support row
  const int g = lane / GL;                     // 32 / GL groups, n rows each
  const int j = lane % GL;
  const int a = j / P;
  const int jp = j % P;
  const int tx = xi + a;
  const bool okx = tx >= 0 && tx < wl;
  const int col = tx * n + 2 * jp;
#pragma unroll
  for (int rr = 0; rr < n; ++rr) {
    const int r = g * n + rr;
    const int ty = yi + r;
    float c0 = 0.0f, c1 = 0.0f;
    if (okx && ty >= 0 && ty < hl) {
      const __nv_bfloat16* q = t + (ty * n - r0) * W2 + col;
      l0_load2<kPair>(q, c0, c1);
#pragma unroll
      for (int yy = 1; yy < n; ++yy) {
        float u0, u1;
        l0_load2<kPair>(q + yy * W2, u0, u1);
        c0 = __fadd_rn(c0, u0);
        c1 = __fadd_rn(c1, u1);
      }
      c0 = round_bf16(c0);
      c1 = round_bf16(c1);
    }
    float s = __fadd_rn(c0, c1);
#pragma unroll
    for (int k = 1; k < P; ++k) {              // left to right along the tap
      const float up = __shfl_up_sync(0xffffffffu, s, 1);
      if (jp == k) s = __fadd_rn(__fadd_rn(up, c0), c1);
    }
    if (jp == P - 1) S[a * kSup + r] = s;
  }
}

template <int kMode, bool kPair>
__global__ void __launch_bounds__(kL0Warps * 32)
corr_lookup_l0_kernel(const __nv_bfloat16* __restrict__ vol,
                      const float2* __restrict__ coords,
                      float* __restrict__ out, Levels lv, int64_t n_pix,
                      int gran, int stage_bytes) {
  // [warp][stage] rows | [warp] block sums and weights | [warp][stage]
  // barriers | [warp][stage] coords
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kNStage = l0_stages(kMode);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned char* stages =
      smem + static_cast<size_t>(warp) * kNStage * stage_bytes;
  unsigned char* rest =
      smem + static_cast<size_t>(kL0Warps) * kNStage * stage_bytes;
  float* S = reinterpret_cast<float*>(rest) + warp * kL0Scratch;
  float* Wt = S + kLevels * kSup * kSup;
  rest += kL0Warps * kL0Scratch * sizeof(float);
  uint64_t* bars = reinterpret_cast<uint64_t*>(rest) + warp * kL0Stages;
  float2* cst = reinterpret_cast<float2*>(
      rest + kL0Warps * kL0Stages * sizeof(uint64_t)) + warp * kL0Stages;

  const int H2p = lv.slab_h[0];
  const int W2 = lv.slab_w[0];
  const int64_t plane = static_cast<int64_t>(H2p) * W2;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kL0Warps;
  int64_t p = static_cast<int64_t>(blockIdx.x) * kL0Warps + warp;

  // lane 0: ask for pixel q's rows into stage s and leave its coords there
  auto request = [&](int64_t q, float2 c, int s) {
    int r0, r1;
    l0_rows(lv, c.y, gran, r0, r1);
    if (lane != 0) return;
    cst[s] = c;
    const uint32_t bar = smem_u32(bars + s);
    const uint32_t bytes = static_cast<uint32_t>(r1 - r0) * W2 * 2;
    if (bytes == 0) {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                   :: "r"(bar) : "memory");
      return;
    }
    // the stage's earlier readers are done (__syncwarp); order them
    // before the copy engine's writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32(stages + static_cast<size_t>(s) * stage_bytes)),
           "l"(vol + q * plane + static_cast<int64_t>(r0) * W2), "r"(bytes),
           "r"(bar)
        : "memory");
  };

  float2 c_pref = make_float2(0.0f, 0.0f);     // coords of the next request
  if (kMode == kL0Bulk) {
    if (lane == 0) {
      for (int s = 0; s < kL0Stages; ++s)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                     :: "r"(smem_u32(bars + s)), "r"(1) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    for (int s = 0; s < kL0Stages - 1; ++s) {
      const int64_t q = p + s * stride;
      if (q < n_pix) request(q, coords[q], s);
    }
    const int64_t q = p + (kL0Stages - 1) * stride;
    if (q < n_pix) c_pref = coords[q];
  }

  for (int k = 0; p < n_pix; ++k, p += stride) {
    const int s = k % kL0Stages;
    float2 c;
    const __nv_bfloat16* t;
    int r0, r1;
    if (kMode == kL0Bulk) {
      const int64_t q = p + (kL0Stages - 1) * stride;
      if (q < n_pix) request(q, c_pref, (k + kL0Stages - 1) % kL0Stages);
      if (q + stride < n_pix) c_pref = coords[q + stride];
      const uint32_t bar = smem_u32(bars + s);
      const uint32_t parity = (k / kL0Stages) & 1;
      uint32_t done;
      do {
        asm volatile(
            "{\n .reg .pred ok;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 ok, [%1], %2;\n"
            " selp.u32 %0, 1, 0, ok;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
      } while (!done);
      c = cst[s];
      l0_rows(lv, c.y, gran, r0, r1);
      t = reinterpret_cast<const __nv_bfloat16*>(
          stages + static_cast<size_t>(s) * stage_bytes);
    } else if (kMode == kL0Coop) {
      c = coords[p];
      l0_rows(lv, c.y, 1, r0, r1);
      const unsigned short* src = reinterpret_cast<const unsigned short*>(
          vol + p * plane + static_cast<int64_t>(r0) * W2);
      unsigned short* dst = reinterpret_cast<unsigned short*>(stages);
      for (int i = lane; i < (r1 - r0) * W2; i += 32) dst[i] = __ldg(src + i);
      __syncwarp();
      t = reinterpret_cast<const __nv_bfloat16*>(stages);
    } else {
      c = coords[p];
      r0 = 0;
      t = vol + p * plane;
    }

    l0_level<0, kPair>(t, r0, W2, lv.real_h[0], lv.real_w[0], c, lane, S, Wt);
    l0_level<1, kPair>(t, r0, W2, lv.real_h[1], lv.real_w[1], c, lane, S, Wt);
    l0_level<2, kPair>(t, r0, W2, lv.real_h[2], lv.real_w[2], c, lane, S, Wt);
    l0_level<3, kPair>(t, r0, W2, lv.real_h[3], lv.real_w[3], c, lane, S, Wt);
    __syncwarp();

    // 196 outputs, four neighbouring channels a lane, one 16-byte store
    float* op = out + p * kCh4;
    for (int q4 = lane; q4 < kCh4 / 4; q4 += 32) {
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ch = 4 * q4 + i;
        const int l = ch / (kRd * kRd);
        const int rem = ch - l * kRd * kRd;
        const int a = rem / kRd;
        const int b = rem - a * kRd;
        const float* sp = S + l * kSup * kSup + a * kSup + b;
        const float* w = Wt + 4 * l;
        float acc = __fadd_rn(__fmul_rn(w[0], sp[0]),
                              __fmul_rn(w[1], sp[kSup]));
        acc = __fadd_rn(acc, __fmul_rn(w[2], sp[1]));
        v[i] = __fadd_rn(acc, __fmul_rn(w[3], sp[kSup + 1]));
      }
      *reinterpret_cast<float4*>(op + 4 * q4) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncwarp();      // S, Wt and this stage are free for the next pixel
  }
}

template <int kMode, bool kPair>
int l0_launch(const __nv_bfloat16* vol, const float2* coords, float* out,
              const Levels& lv, int64_t n_pix, int gran, int stage_bytes,
              cudaStream_t stream) {
  auto kernel = corr_lookup_l0_kernel<kMode, kPair>;
  const size_t smem =
      static_cast<size_t>(kL0Warps) * l0_stages(kMode) * stage_bytes
      + kL0Fixed;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kL0Warps * 32, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1 || sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t want = (n_pix + kL0Warps - 1) / kL0Warps;
  const int64_t resident = static_cast<int64_t>(sms) * per_sm;
  const unsigned blocks = static_cast<unsigned>(std::min(want, resident));
  kernel<<<blocks, kL0Warps * 32, smem, stream>>>(vol, coords, out, lv, n_pix,
                                                  gran, stage_bytes);
  return static_cast<int>(cudaGetLastError());
}

int gcd_int(int a, int b) { return b == 0 ? a : gcd_int(b, a % b); }

void fill_levels(Levels& lv, const int* dims) {
  for (int l = 0; l < kLevels; ++l) {
    lv.slab_h[l] = dims[l];
    lv.slab_w[l] = dims[kLevels + l];
    lv.real_h[l] = dims[2 * kLevels + l];
    lv.real_w[l] = dims[3 * kLevels + l];
  }
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each returns the launch's
// cudaError_t.
namespace {

// The grouped4 kernel over four levels; dims holds slab_h[4], slab_w[4],
// real_h[4], real_w[4].  vec_mask bit l allows 4-byte loads from level l
// and is refused where that level's base or element count does not.
int grouped4_launch(const void* const* ptrs, const int* dims, int vec_mask,
                    const void* coords, const void* n_act, void* out, int E,
                    int H1, int W1, int out_f32, bool exact, void* stream) {
  if (E == 0 || H1 == 0 || W1 == 0) return 0;
  Levels lv;
  for (int l = 0; l < kLevels; ++l)
    lv.ptr[l] = static_cast<const __nv_bfloat16*>(ptrs[l]);
  fill_levels(lv, dims);
  const int64_t pps = static_cast<int64_t>(H1) * W1;
  const int64_t n_pix = pps * E;
  for (int l = 0; l < kLevels; ++l) {
    const int64_t numel = n_pix * lv.slab_h[l] * lv.slab_w[l];
    if (((vec_mask >> l) & 1)
        && (reinterpret_cast<uintptr_t>(ptrs[l]) % 4 != 0 || numel % 2 != 0))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (n_pix + kG4Warps - 1) / kG4Warps;
  if (blocks > 2147483647LL || reinterpret_cast<uintptr_t>(out) % 16 != 0
      || (exact && (!out_f32 || n_act != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  const float2* c = static_cast<const float2*>(coords);
  const int* n = static_cast<const int*>(n_act);
  if (exact)
    corr_lookup_grouped4_kernel<float, true><<<grid, kG4Warps * 32, 0, s>>>(
        lv, vec_mask, c, nullptr, static_cast<float*>(out), n_pix, pps);
  else if (out_f32)
    corr_lookup_grouped4_kernel<float, false><<<grid, kG4Warps * 32, 0, s>>>(
        lv, vec_mask, c, n, static_cast<float*>(out), n_pix, pps);
  else
    corr_lookup_grouped4_kernel<__nv_bfloat16, false>
        <<<grid, kG4Warps * 32, 0, s>>>(lv, vec_mask, c, n,
                                        static_cast<__nv_bfloat16*>(out),
                                        n_pix, pps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Four unpadded levels, exact bf16 taps, fp32 out (lookup_pyramid of
// corr_lookup.py), on the grouped4 kernel's exact mode.
extern "C" int corr_lookup_launch(const void* l0, const void* l1,
                                  const void* l2, const void* l3,
                                  const int* dims, int vec_mask,
                                  const void* coords, void* out, int E,
                                  int H1, int W1, void* stream) {
  const void* ptrs[kLevels] = {l0, l1, l2, l3};
  return grouped4_launch(ptrs, dims, vec_mask, coords, nullptr, out, E, H1,
                         W1, 1, true, stream);
}

// Four pooled, row-padded slabs with hat rounding (lookup_pyramid_grouped4).
// n_act may be null (ungated); out is bf16, or fp32 with out_f32.
extern "C" int corr_lookup_grouped4_launch(const void* l0, const void* l1,
                                           const void* l2, const void* l3,
                                           const int* dims, int vec_mask,
                                           const void* coords,
                                           const void* n_act, void* out,
                                           int E, int H1, int W1,
                                           int out_f32, void* stream) {
  const void* ptrs[kLevels] = {l0, l1, l2, l3};
  return grouped4_launch(ptrs, dims, vec_mask, coords, n_act, out, E, H1, W1,
                         out_f32, false, stream);
}

// One stored level (kernels lookup_level and lookup_level_grouped of
// corr_lookup.py): vol (E, H1, W1, H2, W2) bf16, coords in LEVEL units,
// out (E, H1, W1, 49) fp32, 16-byte aligned.  16-byte loads where the base
// is 16-byte aligned and the element count a multiple of 8 (every slab the
// tracker builds: rows padded to 8), else 2-byte loads.
extern "C" int corr_lookup_level_launch(const void* vol, const void* coords,
                                        void* out, int E, int H1, int W1,
                                        int H2, int W2, void* stream) {
  if (E == 0 || H1 == 0 || W1 == 0) return 0;
  const int64_t n_pix = static_cast<int64_t>(E) * H1 * W1;
  const int64_t per_block = kLvWarps * kLvPix;
  const int64_t blocks = (n_pix + per_block - 1) / per_block;
  if (blocks > 2147483647LL || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int wide = reinterpret_cast<uintptr_t>(vol) % 16 == 0
                   && (n_pix * H2 * W2) % 8 == 0;
  corr_level_kernel<<<static_cast<unsigned>(blocks), kLvWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(vol), wide,
      static_cast<const float2*>(coords), static_cast<float*>(out), n_pix,
      H2, W2);
  return static_cast<int>(cudaGetLastError());
}

// Four levels from the level-0 slab: vol0 (E, H1, W1, H2p, W2) bf16,
// coords in level-0 units, dims = real_h[4], real_w[4] (floor-halved level
// dims), out (E, H1, W1, 196) fp32.  mode (kL0Bulk / kL0Coop / kL0Direct)
// and pair (4-byte loads of column pairs) are the caller's choice from
// the slab's address and shape (corr_lookup.py l0_plan); a choice that the
// slab does not allow is refused.
extern "C" int corr_lookup_l0_launch(const void* vol0, const int* dims,
                                     const void* coords, void* out, int E,
                                     int H1, int W1, int H2p, int W2,
                                     int mode, int pair, void* stream) {
  if (E == 0 || H1 == 0 || W1 == 0) return 0;
  Levels lv = {};
  lv.slab_h[0] = H2p;
  lv.slab_w[0] = W2;
  for (int l = 0; l < kLevels; ++l) {
    lv.real_h[l] = dims[l];
    lv.real_w[l] = dims[kLevels + l];
  }
  const uintptr_t addr = reinterpret_cast<uintptr_t>(vol0);
  const int64_t plane_bytes = static_cast<int64_t>(H2p) * W2 * 2;
  const int64_t stage = (plane_bytes + 15) / 16 * 16;
  const bool bad =
      mode < kL0Bulk || mode > kL0Direct
      || (pair && (W2 % 2 != 0 || (mode == kL0Direct && addr % 4 != 0)))
      || (mode == kL0Bulk && (addr % 16 != 0 || plane_bytes % 16 != 0))
      || kL0Warps * l0_stages(mode) * stage + kL0Fixed > kL0SmemMax
      || reinterpret_cast<uintptr_t>(out) % 16 != 0;
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  // rows per 16 bytes of a plane: a bulk copy starts and ends on them
  const int gran = W2 > 0 ? 8 / gcd_int(W2, 8) : 1;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(vol0);
  const float2* c = static_cast<const float2*>(coords);
  float* o = static_cast<float*>(out);
  const int64_t n_pix = static_cast<int64_t>(E) * H1 * W1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int sb = static_cast<int>(stage);
  switch (mode * 2 + (pair ? 1 : 0)) {
    case 0: return l0_launch<kL0Bulk, false>(v, c, o, lv, n_pix, gran, sb, s);
    case 1: return l0_launch<kL0Bulk, true>(v, c, o, lv, n_pix, gran, sb, s);
    case 2: return l0_launch<kL0Coop, false>(v, c, o, lv, n_pix, 1, sb, s);
    case 3: return l0_launch<kL0Coop, true>(v, c, o, lv, n_pix, 1, sb, s);
    case 4: return l0_launch<kL0Direct, false>(v, c, o, lv, n_pix, 1, 0, s);
    default: return l0_launch<kL0Direct, true>(v, c, o, lv, n_pix, 1, 0, s);
  }
}
