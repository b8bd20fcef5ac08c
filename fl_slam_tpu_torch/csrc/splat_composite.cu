// K8: front-to-back splat compositing of 8x128-pixel image tiles.
//
// Replaces the TPU kernel fl_slam_tpu/render/splat_pallas.py:182
// render_pallas (body _make_kernel / _composite_kernel, :40). Block t
// composites tile t (row-major over n_ty x n_tx tiles) over its K
// depth-sorted splat rows params[t] (K, 16): u, v, the 2x2 inverse
// covariance (Sinv00, Sinv01, Sinv11), alpha, r, g, b, z. Each pixel runs
//   logw = -0.5 (ia du du + 2 ib du dv + ic dv dv)
//   w = logw > -12 ? exp(logw) : 0;  a = clip(alpha w, 0, 0.995)
//   contrib = a T;  rgb += contrib c;  zacc += contrib z;  zw += contrib
//   T *= 1 - a
// and writes r, g, b over a white background (+ T) and depth
// zacc / max(zw, 1e-9). Outputs are (4, T * 8, 128), tile-major, like the
// reference's four (T * 8, 128) blocks.
//
// What bounds it on an H100: operations. At 960x720 with K = 64 (720
// tiles) it does ~26 f32 operations per pixel and splat, 1.2 GFLOP (~18 us
// at 67 TFLOP/s), and moves 15 MB (4.4 us). The design: one block of 1,024
// threads per tile, one thread per pixel, the tile's K x 16 rows (4 KB at
// K = 64) staged once in shared memory and read as broadcasts; the blend
// state lives in registers; each thread writes its four outputs once,
// coalesced along the 128-pixel rows. The expressions keep the plain
// version's order and the file builds with -fmad=false, so the kernel
// rounds as the plain version's elementwise ops do (exp aside).

#include "common.cuh"

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kThreads = kTileH * kTileW;
constexpr int kParam = 16;

__global__ void __launch_bounds__(kThreads)
composite_kernel(const float* __restrict__ params, float* __restrict__ out,
                 int T, int K, int n_tx) {
  extern __shared__ float sp[];
  const int t = blockIdx.x;
  const float* p = params + static_cast<size_t>(t) * K * kParam;
  for (int i = threadIdx.x; i < K * kParam; i += kThreads) sp[i] = p[i];
  __syncthreads();

  const int row = threadIdx.x / kTileW, col = threadIdx.x % kTileW;
  const int ty = t / n_tx, tx = t - ty * n_tx;
  const float py = static_cast<float>(row) + static_cast<float>(ty) * 8.0f;
  const float px = static_cast<float>(col) + static_cast<float>(tx) * 128.0f;
  float r = 0.0f, g = 0.0f, b = 0.0f, zacc = 0.0f, zw = 0.0f, trans = 1.0f;
  for (int k = 0; k < K; ++k) {
    const float* q = sp + k * kParam;
    const float du = px - q[0];
    const float dv = py - q[1];
    const float logw =
        -0.5f * (q[2] * du * du + 2.0f * q[3] * du * dv + q[4] * dv * dv);
    const float w = logw > -12.0f ? expf(logw) : 0.0f;
    float a = q[5] * w;
    a = a < 0.0f ? 0.0f : (a > 0.995f ? 0.995f : a);
    const float contrib = a * trans;
    r = r + contrib * q[6];
    g = g + contrib * q[7];
    b = b + contrib * q[8];
    zacc = zacc + contrib * q[9];
    zw = zw + contrib;
    trans = trans * (1.0f - a);
  }
  const size_t plane = static_cast<size_t>(T) * kThreads;
  const size_t o = static_cast<size_t>(t) * kThreads + threadIdx.x;
  out[o] = r + trans;
  out[plane + o] = g + trans;
  out[2 * plane + o] = b + trans;
  out[3 * plane + o] = zacc / (zw > 1e-9f ? zw : 1e-9f);
}

}  // namespace

FL_DEFINE_ERROR_STRING

extern "C" int splat_composite_f32(const float* params, float* out, int T,
                                   int K, int n_tx, void* stream) {
  if (T <= 0 || K <= 0 || n_tx <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(K) * kParam * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      composite_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  composite_kernel<<<T, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      params, out, T, K, n_tx);
  return static_cast<int>(cudaGetLastError());
}
