// Hand-written Hopper (sm_90a) kernel of the port's HBM stream probe.
//
// It replaces the Pallas kernel of the JAX repo's bandwidth probe:
//   K6  benchmarks/hbm_probe.py:65  _pallas_scale  -> stream_scale_kernel
// o = x * v over a float32 [R, 128] plane (24 qubits: R = 2^17, 64 MB), in
// tiles of `rows_per_tile` rows, one block per tile, with the scalar v in
// device memory so that chained calls need no host round trip.
//
// Bound: bytes.  Each element is read once and written once (8 bytes for
// one multiply), so the kernel can at best move the plane at the card's
// memory rate.  Design: 16-byte (float4) loads and stores, neighbouring
// threads on neighbouring addresses, v read once per block into shared
// memory, four float4s in flight per thread.  The tile size is the probe's
// parameter: a tile of 8192 rows gives 16 blocks at 24 qubits, too few to
// fill 132 SMs, and the probe reports that as it is.
//
// The extern "C" entry point launches on the caller's stream and returns
// cudaGetLastError(); nothing here allocates or synchronises.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 128;            // floats per row
constexpr int kRow4 = kCols / 4;      // float4s per row
constexpr int kThreads = 512;
constexpr int kUnroll = 4;

__global__ void stream_scale_kernel(const float4* __restrict__ x,
                                    const float* __restrict__ v,
                                    float4* __restrict__ o, long long rows,
                                    int rows_per_tile) {
  __shared__ float s_v;
  if (threadIdx.x == 0) s_v = *v;
  __syncthreads();
  const float scale = s_v;
  const long long row0 = (long long)blockIdx.x * rows_per_tile;
  const long long row1 = min(rows, row0 + rows_per_tile);
  const long long end = row1 * kRow4;
  long long i = row0 * kRow4 + threadIdx.x;
  // Full rounds of kUnroll float4s per thread, loads issued before stores.
  for (; i + (kUnroll - 1) * kThreads < end; i += kUnroll * kThreads) {
    float4 a[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) a[u] = x[i + u * kThreads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      a[u].x *= scale;
      a[u].y *= scale;
      a[u].z *= scale;
      a[u].w *= scale;
      o[i + u * kThreads] = a[u];
    }
  }
  for (; i < end; i += kThreads) {
    float4 a = x[i];
    a.x *= scale;
    a.y *= scale;
    a.z *= scale;
    a.w *= scale;
    o[i] = a;
  }
}

}  // namespace

extern "C" {

// o = x * v[0] over x float32 [rows, 128] (16-byte aligned), one block per
// tile of rows_per_tile rows; the last tile may be short.
int qhbm_stream_scale(const float* x, const float* v, float* o, int rows,
                      int rows_per_tile, void* stream) {
  if (rows <= 0 || rows_per_tile <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (rows + rows_per_tile - 1) / rows_per_tile;
  stream_scale_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), v, reinterpret_cast<float4*>(o),
      rows, rows_per_tile);
  return (int)cudaGetLastError();
}

}  // extern "C"
