// Per-channel BatchNorm training statistics: fp32 sum(x) and sum(x*x) over
// the channel-minor [M, C] view of an activation (bf16 or f32).
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_kernels.py:_stats_fwd_impl
// (body _stats_kernel).  That kernel walked the M axis as the innermost,
// sequential grid dimension and kept the output block resident as the
// accumulator.  Blocks on a GPU run in parallel and in no order, so nothing
// can be carried from one block to the next; the sum is split in two stages:
//
//   stage 1 (stats_partial): a 2-D grid over (channel tiles, M splits).
//     Each block owns a tile of `bc` channels and a contiguous range of
//     rows.  Thread t reads channel t % bc of rows t / bc, t / bc + g, ...
//     (g = kThreads / bc rows per sweep), so the threads of a warp read
//     neighbouring addresses of one row — or, when C < kThreads, of a few
//     consecutive rows, since rows of a narrow activation are adjacent.
//     Sums live in fp32 registers; the block reduces its g row groups in
//     shared memory in a fixed order and writes partial[split][c].
//   stage 2 (stats_finish): one thread per channel sums the splits in
//     order.  No atomics, so results are deterministic run to run.
//
// Any C works (ResNet's bn_data has C = 3): there is no lane fold, which
// was a TPU layout artifact.  Row offsets are 64-bit: B*224*224*3 at
// batch 512 is 77 M elements.
//
// Bound: memory.  The kernel must read M*C*itemsize bytes once and does two
// fp32 FMAs per element, far below the card's compute rate, so its floor is
// one read of the activation at 3.35 TB/s (H100 SXM).  The split count is
// chosen (ops/kernels.py:_launch_plan) to put several blocks on every SM so
// that enough loads are in flight to approach that rate; the partial sums it
// writes are 2*splits*C floats, small beside the input.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
stats_partial(const T* __restrict__ x, int64_t m, int c, int bc,
              int64_t rows_per_split, int splits, float* __restrict__ partial) {
  __shared__ float sh1[kThreads];
  __shared__ float sh2[kThreads];
  const int t = threadIdx.x;
  const int g = kThreads / bc;
  const int lane_c = t % bc;
  const int lane_r = t / bc;
  const int ch = blockIdx.x * bc + lane_c;
  const int split = blockIdx.y;
  const int64_t r0 = static_cast<int64_t>(split) * rows_per_split;
  const int64_t end = r0 + rows_per_split;
  const int64_t r1 = end < m ? end : m;
  float s1 = 0.f, s2 = 0.f;
  if (lane_r < g && ch < c) {
    const T* p = x + ch;
#pragma unroll 4
    for (int64_t r = r0 + lane_r; r < r1; r += g) {
      const float v = to_f32(p[r * c]);
      s1 += v;
      s2 = fmaf(v, v, s2);
    }
  }
  sh1[t] = s1;
  sh2[t] = s2;
  __syncthreads();
  if (t < bc && ch < c) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < g; ++k) {
      a += sh1[k * bc + t];
      b += sh2[k * bc + t];
    }
    partial[static_cast<int64_t>(split) * c + ch] = a;
    partial[static_cast<int64_t>(splits + split) * c + ch] = b;
  }
}

__global__ void __launch_bounds__(kThreads)
stats_finish(const float* __restrict__ partial, int c, int splits,
             float* __restrict__ out) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= c) return;
  float a = 0.f, b = 0.f;
  for (int s = 0; s < splits; ++s) {
    a += partial[static_cast<int64_t>(s) * c + ch];
    b += partial[static_cast<int64_t>(splits + s) * c + ch];
  }
  out[ch] = a;
  out[c + ch] = b;
}

}  // namespace

// x: [m, c] row-major, dtype 0 = float32, 1 = bfloat16.
// partial: float32 scratch of 2 * splits * c.  out: float32 [2, c] receiving
// (sum x, sum x*x).  Launches on `stream`, does not synchronise, returns
// cudaGetLastError() (0 on success).
extern "C" int bn_stats_launch(const void* x, void* partial, void* out,
                               long long m, int c, int bc, int splits,
                               long long rows_per_split, int dtype,
                               void* stream) {
  if (m <= 0 || c <= 0 || bc <= 0 || bc > kThreads || splits <= 0 ||
      rows_per_split <= 0 ||
      static_cast<long long>(splits) * rows_per_split < m ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid1((c + bc - 1) / bc, splits);
  float* part = static_cast<float*>(partial);
  if (dtype == 0) {
    stats_partial<float><<<grid1, kThreads, 0, s>>>(
        static_cast<const float*>(x), m, c, bc, rows_per_split, splits, part);
  } else {
    stats_partial<__nv_bfloat16><<<grid1, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), m, c, bc, rows_per_split, splits,
        part);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_finish<<<(c + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      part, c, splits, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
