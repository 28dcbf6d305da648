// Windowed bilinear lookup from a 4-level correlation pyramid (Hopper).
//
// Two kernels of one template, both computing DROID's corr_index_forward
// for radius 3: a 7x7 window per pixel and level, sampled bilinearly from
// an 8x8 tap support, level coordinates x0 / 2^l, window start
// floor(x_l) - 3, out-of-bounds taps exactly 0, output channel
// lvl*49 + a*7 + b (a = x offset, b = y offset).
//
// kHat = true replaces the TPU kernel
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
// kHat = false replaces the TPU kernel
//   nerf_slam_tpu/ops/corr_pallas.py  lookup_pyramid_pallas_nhwc
//   (_lookup_pyramid_kernel / _level_lookup_body): exact bf16 taps with
//   fp32 bilinear weights, summed as w00*S00 + w10*S10 + w01*S01 +
//   w11*S11 in that order, fp32 output.
//
// The Pallas kernels build one-hot and hat matrices and contract them on
// the MXU because a TPU has no fast gather.  Here the lookup is a direct
// gather: one block per (source row, edge), one thread per (pixel, level,
// y offset b), each loading the two support rows it interpolates (8 bf16
// values each, bounds-checked) and writing 7 outputs.  All arithmetic uses
// the _rn intrinsics so that no multiply-add is contracted: the plain
// PyTorch versions in corr_lookup.py then match bit for bit.
//
// Bound on the card: bytes.  Per active pixel and edge the lookup must
// read the in-bounds part of 4 levels x 8 x 8 bf16 taps (at most 512 B;
// DRAM moves them as 32 B sectors, up to 2 per support row, so up to
// 2 KB) plus 8 B of coords; every slot writes 196 outputs (392 B bf16 /
// 784 B fp32).  About 1,300 flops go with that, ~2 flops per byte, far
// below where an H100 turns compute-bound.  At the tracking shapes (48
// slots, 36 active, 42 x 80 pixels, gated) the taps, coords and output
// come to ~109 MB, 0.033 ms at 3.35 TB/s; counted in sectors, ~0.09 ms
// (chip_smoke.py computes the element figure from each call's coords).
// This first version issues scalar 2-byte loads, each support row is read
// by the two threads that share it, and one block per source row leaves
// the E = 1 motion-filter call with only H1 blocks; wide, shared loads and
// a finer grid are later work.  chip_smoke.py reports the time beside the
// bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRd = 7;       // window taps per axis (2r + 1), r = 3
constexpr int kSup = 8;      // support taps per axis
constexpr int kLevels = 4;
constexpr int kCh = kLevels * kRd * kRd;   // 196 output channels

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

template <bool kHat, typename OutT>
__global__ void __launch_bounds__(256)
corr_lookup_kernel(Levels lv, const float2* __restrict__ coords,
                   const int* __restrict__ n_act, OutT* __restrict__ out,
                   int H1, int W1) {
  const int y = blockIdx.x;
  const int e = blockIdx.y;
  const int64_t pix0 = (static_cast<int64_t>(e) * H1 + y) * W1;
  OutT* orow = out + pix0 * kCh;

  if (n_act != nullptr && e >= __ldg(n_act)) {
    for (int i = threadIdx.x; i < W1 * kCh; i += blockDim.x)
      store(orow + i, 0.0f);
    return;
  }

  const int items = W1 * kLevels * kRd;          // (pixel, level, b)
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int b = it % kRd;
    const int lvl = (it / kRd) % kLevels;
    const int x = it / (kRd * kLevels);
    const float2 c = coords[pix0 + x];

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
    const __nv_bfloat16* plane =
        lv.ptr[lvl] + (pix0 + x) * static_cast<int64_t>(hs) * ws;

    float o[kRd];
    if (kHat) {
      // window start as a float, clipped as the TPU kernel clips it
      const float xi = fminf(fmaxf(__fsub_rn(fx, 3.0f), -8.0f),
                             static_cast<float>(lv.real_w[lvl] + 8));
      const float yi = fminf(fmaxf(__fsub_rn(fy, 3.0f), -8.0f),
                             static_cast<float>(lv.real_h[lvl] + 8));
      float xs = __fadd_rn(xi, dx);
      float ys = __fadd_rn(yi, dy);
      if (!isfinite(xs)) xs = -1e4f;             // selects nothing
      if (!isfinite(ys)) ys = -1e4f;
      const float wy0 = hat(yi, ys);
      const float wy1 = hat(__fadd_rn(yi, 1.0f), ys);
      const float wx0 = hat(xi, xs);
      const float wx1 = hat(__fadd_rn(xi, 1.0f), xs);

      const int y0 = static_cast<int>(yi) + b;
      const int x0 = static_cast<int>(xi);
      const bool ok0 = y0 >= 0 && y0 < hr;
      const bool ok1 = y0 + 1 >= 0 && y0 + 1 < hr;
      float r[kSup];
#pragma unroll
      for (int s = 0; s < kSup; ++s) {
        const int xx = x0 + s;
        const bool okx = xx >= 0 && xx < wr;
        const float v0 = (ok0 && okx)
            ? __bfloat162float(plane[y0 * ws + xx]) : 0.0f;
        const float v1 = (ok1 && okx)
            ? __bfloat162float(plane[(y0 + 1) * ws + xx]) : 0.0f;
        r[s] = round_bf16(__fadd_rn(__fmul_rn(wy0, v0), __fmul_rn(wy1, v1)));
      }
#pragma unroll
      for (int a = 0; a < kRd; ++a)
        o[a] = __fadd_rn(__fmul_rn(wx0, r[a]), __fmul_rn(wx1, r[a + 1]));
    } else {
      const int xi = static_cast<int>(
          fminf(fmaxf(__fsub_rn(fx, 3.0f), -8.0f), static_cast<float>(ws + 8)));
      const int yi = static_cast<int>(
          fminf(fmaxf(__fsub_rn(fy, 3.0f), -8.0f), static_cast<float>(hs + 8)));
      const float ox = __fsub_rn(1.0f, dx);
      const float oy = __fsub_rn(1.0f, dy);
      const float w00 = __fmul_rn(ox, oy);
      const float w10 = __fmul_rn(dx, oy);
      const float w01 = __fmul_rn(ox, dy);
      const float w11 = __fmul_rn(dx, dy);
      const int y0 = yi + b;
      const bool ok0 = y0 >= 0 && y0 < hr;
      const bool ok1 = y0 + 1 >= 0 && y0 + 1 < hr;
      float t0[kSup], t1[kSup];
#pragma unroll
      for (int s = 0; s < kSup; ++s) {
        const int xx = xi + s;
        const bool okx = xx >= 0 && xx < wr;
        t0[s] = (ok0 && okx) ? __bfloat162float(plane[y0 * ws + xx]) : 0.0f;
        t1[s] = (ok1 && okx) ? __bfloat162float(plane[(y0 + 1) * ws + xx])
                             : 0.0f;
      }
#pragma unroll
      for (int a = 0; a < kRd; ++a) {
        float v = __fadd_rn(__fmul_rn(w00, t0[a]), __fmul_rn(w10, t0[a + 1]));
        v = __fadd_rn(v, __fmul_rn(w01, t1[a]));
        o[a] = __fadd_rn(v, __fmul_rn(w11, t1[a + 1]));
      }
    }

    OutT* op = orow + static_cast<int64_t>(x) * kCh + lvl * kRd * kRd + b;
#pragma unroll
    for (int a = 0; a < kRd; ++a) store(op + a * kRd, o[a]);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  dims holds slab_h[4],
// slab_w[4], real_h[4], real_w[4]; n_act may be null (ungated).  mode 0:
// hat rounding, bf16 out; mode 1: hat rounding, fp32 out; mode 2: exact
// bf16 taps, fp32 out.  Returns the launch's cudaError_t.
extern "C" int corr_lookup_launch(const void* l0, const void* l1,
                                  const void* l2, const void* l3,
                                  const int* dims, const void* coords,
                                  const void* n_act, void* out, int E,
                                  int H1, int W1, int mode, void* stream) {
  if (E == 0 || H1 == 0 || W1 == 0) return 0;
  Levels lv;
  const void* ptrs[kLevels] = {l0, l1, l2, l3};
  for (int l = 0; l < kLevels; ++l) {
    lv.ptr[l] = static_cast<const __nv_bfloat16*>(ptrs[l]);
    lv.slab_h[l] = dims[l];
    lv.slab_w[l] = dims[kLevels + l];
    lv.real_h[l] = dims[2 * kLevels + l];
    lv.real_w[l] = dims[3 * kLevels + l];
  }
  const dim3 grid(H1, E);
  const dim3 block(256);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* c = static_cast<const float2*>(coords);
  const int* n = static_cast<const int*>(n_act);
  switch (mode) {
    case 0:
      corr_lookup_kernel<true, __nv_bfloat16><<<grid, block, 0, s>>>(
          lv, c, n, static_cast<__nv_bfloat16*>(out), H1, W1);
      break;
    case 1:
      corr_lookup_kernel<true, float><<<grid, block, 0, s>>>(
          lv, c, n, static_cast<float*>(out), H1, W1);
      break;
    case 2:
      corr_lookup_kernel<false, float><<<grid, block, 0, s>>>(
          lv, c, n, static_cast<float*>(out), H1, W1);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
