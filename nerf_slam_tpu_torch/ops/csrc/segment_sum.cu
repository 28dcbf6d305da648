// Segment sums in a fixed order (Hopper): out[s] = sum of the rows x[r]
// with ids[r] == s, r ascending.
//
// Replaces no TPU kernel.  The JAX package pools per-edge blocks with
// jax.ops.segment_sum, which XLA lowers itself; the port took the same
// sums as an f32 product of the ids' one-hot (n_seg, E) with the blocks
// (E, F), plus a second product of the same one-hot with NaN/+inf/-inf
// indicators to place the non-finite entries (ops/segment.py keeps that
// as the plain version).  That is n_seg x E x F multiply-adds for sums in
// which each row meets one segment: at the dense BA's coupling sum (192
// rows of 18,432 f32 into 1,280 segments) some 36 GFLOP and 1.2 GB of
// elementwise traffic a call, for 14 MB read and 94 MB written.
//
// Bound on the card: bytes.  A call must read the kept rows once (and E
// ids) and write n_seg x F outputs once; there is one addition per kept
// element, far below what an H100 can do per byte.  So the design is about
// how the bytes move:
//
// - Grid: one block per (segment, column tile).  The block walks the ids
//   in chunks of its thread count; a warp ballot marks the rows of its
//   segment and a prefix over the warps' counts compacts them, in
//   ascending row order, into shared memory.  No atomics: every output is
//   one thread's own chain of additions.
// - Each thread holds up to kItems vectors of its tile's columns and adds
//   the compacted rows into them in f32, starting from +0.0, with plain
//   IEEE additions (__fadd_rn), in ascending row order; it rounds once to
//   the output type (and, for a mean, divides once by the count first,
//   __fdiv_rn).  A dropped row (id outside [0, n_seg)) is never read, so
//   its NaN or inf reaches nothing; a non-finite value in a kept row stays
//   in its own segment and column with IEEE addition's result (NaN stays
//   NaN, +inf plus -inf is NaN), as jax.ops.segment_sum gives it.
// - Loads and stores are 16 bytes a thread where the row pitch and the
//   base allow (F % 4 in f32, F % 8 in bf16; the wrapper checks the base),
//   else one element a thread.  Tiles are balanced over the columns, and
//   the block shrinks (to a warp) for the narrow sums.
//
// The one-hot product accumulates each output as the FMA chain c += 1 * x
// or c += 0 * x from +0 in ascending k, which on finite inputs is this
// kernel's chain with the zero terms (which change no bits) left out.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kItems = 4;     // vectors of a tile per thread
constexpr int kF32 = 0, kBF16 = 1;

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x (E, F) rows of Tin, ids (E,) int64, out (n_seg, F) of Tout, count
// (n_seg,) int64 or null.  blockIdx.x: the segment; blockIdx.y: the tile
// of ``tile`` vectors of VEC elements.
template <typename Tin, typename Tout, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
segment_sum_kernel(const Tin* __restrict__ x,
                   const int64_t* __restrict__ ids, Tout* __restrict__ out,
                   int64_t* __restrict__ count, int E, int64_t F,
                   int64_t tile, int mean) {
  __shared__ int s_rows[kMaxThreads];
  __shared__ int s_warp[kMaxThreads / 32];
  const int seg = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int64_t nvec = F / VEC;
  const int64_t v0 = static_cast<int64_t>(blockIdx.y) * tile;
  const int64_t v1 = v0 + tile < nvec ? v0 + tile : nvec;

  float acc[kItems][VEC];
#pragma unroll
  for (int k = 0; k < kItems; ++k)
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[k][q] = 0.0f;

  int n = 0;
  for (int base = 0; base < E; base += nthreads) {
    const int r = base + tid;
    const bool hit = r < E && ids[r] == seg;
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_warp[warp] = __popc(mask);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < nwarps; ++w) {
      const int c = s_warp[w];
      before += w < warp ? c : 0;
      total += c;
    }
    if (hit) s_rows[before + __popc(mask & ((1u << lane) - 1u))] = r;
    __syncthreads();
    for (int i = 0; i < total; ++i) {
      const Vec<Tin, VEC>* row = reinterpret_cast<const Vec<Tin, VEC>*>(
          x + static_cast<int64_t>(s_rows[i]) * F);
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int64_t j = v0 + tid + static_cast<int64_t>(k) * nthreads;
        if (j < v1) {
          const Vec<Tin, VEC> a = row[j];
#pragma unroll
          for (int q = 0; q < VEC; ++q)
            acc[k][q] = __fadd_rn(acc[k][q], to_f32(a.v[q]));
        }
      }
    }
    n += total;
    __syncthreads();   // s_rows and s_warp are rewritten by the next chunk
  }

  const float div = static_cast<float>(n > 1 ? n : 1);
  Vec<Tout, VEC>* dst = reinterpret_cast<Vec<Tout, VEC>*>(
      out + static_cast<int64_t>(seg) * F);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t j = v0 + tid + static_cast<int64_t>(k) * nthreads;
    if (j < v1) {
      Vec<Tout, VEC> o;
#pragma unroll
      for (int q = 0; q < VEC; ++q)
        o.v[q] = from_f32<Tout>(mean ? __fdiv_rn(acc[k][q], div)
                                     : acc[k][q]);
      dst[j] = o;
    }
  }
  if (count != nullptr && blockIdx.y == 0 && tid == 0) count[seg] = n;
}

template <typename Tin, typename Tout, int VEC>
int launch(const void* x, const void* ids, void* out, void* count, int E,
           int64_t F, int n_seg, int mean, cudaStream_t stream) {
  const int64_t nvec = F / VEC;
  const int64_t per_block = static_cast<int64_t>(kMaxThreads) * kItems;
  int64_t tiles = (nvec + per_block - 1) / per_block;
  if (tiles < 1) tiles = 1;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t tile = (nvec + tiles - 1) / tiles;      // balanced tiles
  int64_t threads = ((tile + kItems - 1) / kItems + 31) / 32 * 32;
  if (threads < 32) threads = 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const dim3 grid(static_cast<unsigned>(n_seg),
                  static_cast<unsigned>(tiles));
  segment_sum_kernel<Tin, Tout, VEC>
      <<<grid, static_cast<unsigned>(threads), 0, stream>>>(
          static_cast<const Tin*>(x), static_cast<const int64_t*>(ids),
          static_cast<Tout*>(out), static_cast<int64_t*>(count), E, F,
          tile < 1 ? 1 : tile, mean);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (E, F) contiguous, ids (E,) int64, out (n_seg, F) contiguous, count
// (n_seg,) int64 or null, all on the current device.  in_type / out_type:
// 0 f32, 1 bf16 (f32 -> f32, bf16 -> bf16, bf16 -> f32).  vec: elements a
// load, 1 or 16 bytes' worth (then x 16-byte aligned and F a multiple).
// mean: divide each sum by max(count, 1) before the rounding.  Launches
// on ``stream`` and does not synchronise.
extern "C" int segment_sum_launch(const void* x, const void* ids, void* out,
                                  void* count, int E, long long F, int n_seg,
                                  int in_type, int out_type, int vec,
                                  int mean, void* stream) {
  if (n_seg == 0) return 0;
  if (E < 0 || F < 0 || n_seg < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_type == kF32 && out_type == kF32) {
    if (vec == 4) return launch<float, float, 4>(x, ids, out, count, E, F,
                                                 n_seg, mean, s);
    if (vec == 1) return launch<float, float, 1>(x, ids, out, count, E, F,
                                                 n_seg, mean, s);
  } else if (in_type == kBF16 && out_type == kBF16) {
    if (vec == 8)
      return launch<__nv_bfloat16, __nv_bfloat16, 8>(x, ids, out, count, E,
                                                     F, n_seg, mean, s);
    if (vec == 1)
      return launch<__nv_bfloat16, __nv_bfloat16, 1>(x, ids, out, count, E,
                                                     F, n_seg, mean, s);
  } else if (in_type == kBF16 && out_type == kF32) {
    if (vec == 8)
      return launch<__nv_bfloat16, float, 8>(x, ids, out, count, E, F,
                                             n_seg, mean, s);
    if (vec == 1)
      return launch<__nv_bfloat16, float, 1>(x, ids, out, count, E, F,
                                             n_seg, mean, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
