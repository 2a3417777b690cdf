// Hand-written Hopper (sm_90a) kernels for the batched statevector forward
// and adjoint reverse sweep of qhbmlib_tpu_torch.
//
// They replace the grid-over-batch Pallas kernels of the JAX package:
//   K4  qhbmlib_tpu/ops/pallas_sv.py:459      apply_circuit_pallas_batched
//   K5  qhbmlib_tpu/ops/pallas_adjoint.py:540 adjoint_sweep_batched
// A 20-qubit state (16 MB as float32 re/im planes) held a whole state in the
// TPU's VMEM; on the H100 it cannot sit in one SM's 227 KB of shared memory,
// so each circuit segment becomes one or two launches over the whole
// [B, R, C] batch, and the state streams through device memory (or the
// 50 MB L2) between segments.
//
// States are split-complex: separate float32 re and im planes, row-major.
// A "[P, N, Q] view" of a plane names element (p, n, q) at p*N*Q + n*Q + q;
// a "column" is one (p, q) pair and holds N elements.
//
// Every extern "C" entry point launches on the caller's stream and returns
// cudaGetLastError(); nothing here allocates or synchronises.

#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// Tiles of W columns of a [P, N, Q] view.
// ---------------------------------------------------------------------------
//
// With Q >= W (and both powers of two) a tile is W consecutive q of one p:
// each of its N rows is W contiguous floats.  With Q < W a tile covers W/Q
// whole p's and is one contiguous run of N*W floats.  Either way a warp
// loads consecutive addresses.  Linear index i in [0, N*W) maps to the
// element (n, w) of the tile and to its offset from the tile's base.
struct TileIndex {
  int n;
  int w;
  long long off;
};

__device__ __forceinline__ long long tile_base(long long c0, int N, int Q,
                                               int W) {
  const long long p = c0 / Q;
  return p * N * (long long)Q + (Q >= W ? c0 - p * Q : 0);
}

__device__ __forceinline__ TileIndex tile_index(int i, int N, int Q, int W,
                                                long long base) {
  TileIndex t;
  if (Q >= W) {
    t.n = i / W;
    t.w = i - t.n * W;
    t.off = base + (long long)t.n * Q + t.w;
  } else {
    const int nq = N * Q;
    const int pl = i / nq;
    const int rem = i - pl * nq;
    t.n = rem / Q;
    t.w = pl * Q + (rem - t.n * Q);
    t.off = base + i;
  }
  return t;
}

// ---------------------------------------------------------------------------
// axis_apply: y[p, M, q] = sum_N Op[M, N] x[p, N, q], split complex.
// ---------------------------------------------------------------------------
//
// Replaces the row-block and minor split-complex dots of K4
// (pallas_sv.py `_apply_rowblock`, the "minor_mm" stage of
// `_make_batched_kernel`) and the un-applies of K5 (pallas_adjoint.py
// `_make_bwd_kernel`, stage (2) of "bwd1q").
//
// Bound: at N = 128 each amplitude costs 8*N = 1024 flop against 16 bytes
// read and written, about 64 flop/B -- above the H100's fp32 CUDA-core ridge
// (~67 TFLOP/s over 3.35 TB/s, ~20 flop/B).  So the kernel is bound by fp32
// FMA issue and shared-memory operand traffic, not by device memory; a
// TF32/wgmma version is the later fast path.  This one is a plain fp32 FMA
// kernel: the operator (<= 128 KB as two planes) is staged once per
// persistent block in shared memory, a tile of W columns is staged beside
// it, each of 512 threads keeps an (N/16)x2 register tile of outputs,
// operator reads are 16-byte warp broadcasts, and outputs go back through
// shared memory so the stores are as coalesced as the loads.  At N = 128 the
// shared memory (193 KB) admits one block per SM; 512 threads rather than
// 256 give each scheduler four warps to hide shared-memory latency.
constexpr int kApplyThreads = 512;
constexpr int kApplyW = 64;             // columns per tile (2 per lane)
constexpr int kApplyLd = kApplyW + 1;   // padded row stride of the tile

template <int N>
__global__ void __launch_bounds__(kApplyThreads)
    axis_apply_kernel(const float* __restrict__ x_re,
                      const float* __restrict__ x_im,
                      const float* __restrict__ op_re,
                      const float* __restrict__ op_im,
                      float* __restrict__ y_re, float* __restrict__ y_im,
                      long long cols, int Q) {
  extern __shared__ float smem[];
  float* o_re = smem;              // [N][N]
  float* o_im = o_re + N * N;
  float* t_re = o_im + N * N;      // [N][kApplyLd]
  float* t_im = t_re + N * kApplyLd;
  for (int i = threadIdx.x; i < N * N; i += kApplyThreads) {
    o_re[i] = op_re[i];
    o_im[i] = op_im[i];
  }
  constexpr int kGroups = kApplyThreads / 32;
  constexpr int kRows = (N + kGroups - 1) / kGroups;  // output rows / thread
  const int lane = threadIdx.x & 31;
  const int group = threadIdx.x >> 5;
  const long long tiles = (cols + kApplyW - 1) / kApplyW;

  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long c0 = tile * kApplyW;
    const long long base = tile_base(c0, N, Q, kApplyW);
    __syncthreads();  // operator staged; previous tile fully stored
    for (int i = threadIdx.x; i < N * kApplyW; i += kApplyThreads) {
      const TileIndex t = tile_index(i, N, Q, kApplyW, base);
      const bool ok = c0 + t.w < cols;
      t_re[t.n * kApplyLd + t.w] = ok ? x_re[t.off] : 0.f;
      t_im[t.n * kApplyLd + t.w] = ok ? x_im[t.off] : 0.f;
    }
    __syncthreads();

    float ar[kRows][2], ai[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      ar[r][0] = ar[r][1] = ai[r][0] = ai[r][1] = 0.f;
    }
    // Operator entries are read four n at a time (one 16-byte broadcast
    // per row and plane): with one 4-byte read per n the loop issued one
    // shared-memory read per 3.6 FMAs and was bound by shared-memory
    // issue, not by the FMA pipes.
    constexpr int kStep = (N % 4 == 0) ? 4 : 1;
#pragma unroll 1
    for (int n0 = 0; n0 < N; n0 += kStep) {
      float xr0[kStep], xi0[kStep], xr1[kStep], xi1[kStep];
#pragma unroll
      for (int j = 0; j < kStep; ++j) {
        xr0[j] = t_re[(n0 + j) * kApplyLd + lane];
        xi0[j] = t_im[(n0 + j) * kApplyLd + lane];
        xr1[j] = t_re[(n0 + j) * kApplyLd + lane + 32];
        xi1[j] = t_im[(n0 + j) * kApplyLd + lane + 32];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int m = group + r * kGroups;
        if (m < N) {
          float wr[kStep], wi[kStep];
          if constexpr (kStep == 4) {
            const float4 vr =
                *reinterpret_cast<const float4*>(&o_re[m * N + n0]);
            const float4 vi =
                *reinterpret_cast<const float4*>(&o_im[m * N + n0]);
            wr[0] = vr.x; wr[1] = vr.y; wr[2] = vr.z; wr[3] = vr.w;
            wi[0] = vi.x; wi[1] = vi.y; wi[2] = vi.z; wi[3] = vi.w;
          } else {
            wr[0] = o_re[m * N + n0];
            wi[0] = o_im[m * N + n0];
          }
#pragma unroll
          for (int j = 0; j < kStep; ++j) {
            ar[r][0] = fmaf(wr[j], xr0[j], fmaf(-wi[j], xi0[j], ar[r][0]));
            ai[r][0] = fmaf(wr[j], xi0[j], fmaf(wi[j], xr0[j], ai[r][0]));
            ar[r][1] = fmaf(wr[j], xr1[j], fmaf(-wi[j], xi1[j], ar[r][1]));
            ai[r][1] = fmaf(wr[j], xi1[j], fmaf(wi[j], xr1[j], ai[r][1]));
          }
        }
      }
    }
    __syncthreads();  // every thread has read the input tile
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int m = group + r * kGroups;
      if (m < N) {
        t_re[m * kApplyLd + lane] = ar[r][0];
        t_re[m * kApplyLd + lane + 32] = ar[r][1];
        t_im[m * kApplyLd + lane] = ai[r][0];
        t_im[m * kApplyLd + lane + 32] = ai[r][1];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < N * kApplyW; i += kApplyThreads) {
      const TileIndex t = tile_index(i, N, Q, kApplyW, base);
      if (c0 + t.w < cols) {
        y_re[t.off] = t_re[t.n * kApplyLd + t.w];
        y_im[t.off] = t_im[t.n * kApplyLd + t.w];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// axis_gram: G[I, J] = sum_{p, q} conj(l[p, I, q]) a[p, J, q], split complex.
// ---------------------------------------------------------------------------
//
// Replaces the gradient reductions of K5's 1q segments
// (pallas_adjoint.py `_block_transition_parts` for row blocks and the
// `_dot_t` minor cross matrix kmat), summed over the batch.
//
// Bound: the same 8*N flop per amplitude pair as axis_apply, so fp32 FMA
// issue.  Pass 1: each persistent block accumulates its share of the
// columns into a per-thread 4x8 register tile of G and writes its partial
// [2, N, N] to scratch.  Pass 2 sums the partials in block order.  No float
// atomics, so gradients are bitwise reproducible run to run.
constexpr int kGramThreads = 512;
constexpr int kGramW = 32;  // columns per tile

template <int N, int TI, int TJ>
__global__ void __launch_bounds__(kGramThreads)
    axis_gram_partial_kernel(const float* __restrict__ l_re,
                             const float* __restrict__ l_im,
                             const float* __restrict__ a_re,
                             const float* __restrict__ a_im,
                             float* __restrict__ partial, long long cols,
                             int Q) {
  extern __shared__ float smem[];
  constexpr int kLd = N + 1;  // tile stored [w][n], padded
  float* sl_re = smem;
  float* sl_im = sl_re + kGramW * kLd;
  float* sa_re = sl_im + kGramW * kLd;
  float* sa_im = sa_re + kGramW * kLd;
  constexpr int NI = N / TI;
  constexpr int NJ = N / TJ;
  const bool active = threadIdx.x < NI * NJ;
  const int ti = threadIdx.x / NJ;
  const int tj = threadIdx.x - ti * NJ;

  float gr[TI][TJ], gi[TI][TJ];
#pragma unroll
  for (int i = 0; i < TI; ++i) {
#pragma unroll
    for (int j = 0; j < TJ; ++j) gr[i][j] = gi[i][j] = 0.f;
  }
  const long long tiles = (cols + kGramW - 1) / kGramW;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long c0 = tile * kGramW;
    const long long base = tile_base(c0, N, Q, kGramW);
    __syncthreads();
    for (int i = threadIdx.x; i < N * kGramW; i += kGramThreads) {
      const TileIndex t = tile_index(i, N, Q, kGramW, base);
      const bool ok = c0 + t.w < cols;
      const int s = t.w * kLd + t.n;
      sl_re[s] = ok ? l_re[t.off] : 0.f;
      sl_im[s] = ok ? l_im[t.off] : 0.f;
      sa_re[s] = ok ? a_re[t.off] : 0.f;
      sa_im[s] = ok ? a_im[t.off] : 0.f;
    }
    __syncthreads();
    if (active) {
      for (int w = 0; w < kGramW; ++w) {
        float lr[TI], li[TI], xr[TJ], xi[TJ];
#pragma unroll
        for (int i = 0; i < TI; ++i) {
          lr[i] = sl_re[w * kLd + ti + i * NI];
          li[i] = sl_im[w * kLd + ti + i * NI];
        }
#pragma unroll
        for (int j = 0; j < TJ; ++j) {
          xr[j] = sa_re[w * kLd + tj + j * NJ];
          xi[j] = sa_im[w * kLd + tj + j * NJ];
        }
#pragma unroll
        for (int i = 0; i < TI; ++i) {
#pragma unroll
          for (int j = 0; j < TJ; ++j) {
            gr[i][j] = fmaf(lr[i], xr[j], fmaf(li[i], xi[j], gr[i][j]));
            gi[i][j] = fmaf(lr[i], xi[j], fmaf(-li[i], xr[j], gi[i][j]));
          }
        }
      }
    }
  }
  if (active) {
    float* out = partial + (long long)blockIdx.x * 2 * N * N;
#pragma unroll
    for (int i = 0; i < TI; ++i) {
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        const int idx = (ti + i * NI) * N + tj + j * NJ;
        out[idx] = gr[i][j];
        out[N * N + idx] = gi[i][j];
      }
    }
  }
}

// Fixed-order sum of per-block partials: out[i] = sum_b partial[b, i] for i
// in [0, width); the first half of `width` goes to out0, the rest to out1.
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    int blocks, int width,
                                    float* __restrict__ out0,
                                    float* __restrict__ out1) {
  const int half = width / 2;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < width;
       i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < blocks; ++b) s += partial[(long long)b * width + i];
    if (out1 == nullptr || i < half) {
      out0[i] = s;
    } else {
      out1[i - half] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// parity_bilinear: bilin[k] = sum_{b,r,c} s(r & rm_k) s(c & cm_k)
//                             (l_re*a_im - l_im*a_re)[b, r, c]
// ---------------------------------------------------------------------------
//
// Replaces the diagonal-segment gradient reductions of K5
// (pallas_adjoint.py `_make_bwd_kernel`, "bwddiagrot": the [R, K] sign
// matmul plus the column-sum dot), summed over the batch.
//
// Bound: reading the two state batches (16 bytes per amplitude pair) -- the
// K * C sign work per row is small next to it.  Each block stages the
// batch-summed P for a few rows in shared memory (coalesced along columns),
// then thread k folds those rows into its factor's sum with signs from
// __popc, so no [R, K] or [K, C] sign matrix is ever materialised.  Per-block
// partials are summed in a fixed order by sum_partials_kernel.
constexpr int kBilinThreads = 256;
constexpr int kBilinMaxK = 1024;
constexpr int kBilinKPerThread = kBilinMaxK / kBilinThreads;

__global__ void __launch_bounds__(kBilinThreads)
    parity_bilinear_partial_kernel(const float* __restrict__ l_re,
                                   const float* __restrict__ l_im,
                                   const float* __restrict__ a_re,
                                   const float* __restrict__ a_im,
                                   const int* __restrict__ row_masks,
                                   const int* __restrict__ col_masks, int K,
                                   int B, int R, int C,
                                   float* __restrict__ partial) {
  __shared__ float w[kBilinThreads];
  __shared__ int s_rm[kBilinMaxK];
  __shared__ int s_cm[kBilinMaxK];
  for (int k = threadIdx.x; k < K; k += kBilinThreads) {
    s_rm[k] = row_masks[k];
    s_cm[k] = col_masks[k];
  }
  const int rows_per = kBilinThreads / C;
  const long long plane = (long long)R * C;
  float acc[kBilinKPerThread];
#pragma unroll
  for (int j = 0; j < kBilinKPerThread; ++j) acc[j] = 0.f;

  for (long long r0 = (long long)blockIdx.x * rows_per; r0 < R;
       r0 += (long long)gridDim.x * rows_per) {
    const int rl = threadIdx.x / C;
    const long long r = r0 + rl;
    float v = 0.f;
    if (rl < rows_per && r < R) {
      const long long off = r * C + (threadIdx.x - rl * C);
      for (int b = 0; b < B; ++b) {
        const long long o = b * plane + off;
        v = fmaf(l_re[o], a_im[o], fmaf(-l_im[o], a_re[o], v));
      }
    }
    __syncthreads();  // previous rows fully consumed
    w[threadIdx.x] = v;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kBilinKPerThread; ++j) {
      const int k = threadIdx.x + j * kBilinThreads;
      if (k < K) {
        const int rm = s_rm[k];
        const int cm = s_cm[k];
        for (int q = 0; q < rows_per && r0 + q < R; ++q) {
          float s = 0.f;
          for (int c = 0; c < C; ++c) {
            const float x = w[q * C + c];
            s += (__popc(c & cm) & 1) ? -x : x;
          }
          acc[j] += (__popc((int)(r0 + q) & rm) & 1) ? -s : s;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kBilinKPerThread; ++j) {
    const int k = threadIdx.x + j * kBilinThreads;
    if (k < K) partial[(long long)blockIdx.x * K + k] = acc[j];
  }
}

// ---------------------------------------------------------------------------
// diag_rotate: x <- (cos t + i*sign*sin t) * x, in place, for one or two
// state batches sharing the [R, C] cos/sin planes.
// ---------------------------------------------------------------------------
//
// Replaces the "diag_rot" stage of K4 (pallas_sv.py `_make_batched_kernel`,
// sign +) and the "bwddiagrot" un-apply of K5 (pallas_adjoint.py
// `_make_bwd_kernel`, sign -, a and lambda together).
//
// Bound: device memory -- 16 bytes read and written per amplitude for 6
// flop.  The kernel reads each float4 of the planes once and applies it to
// every state of the batch, so the planes cost 8 bytes per element instead
// of 8 per element per state; accesses are 16-byte vectors.
__device__ __forceinline__ void rotate4(float4* re, float4* im, long long i,
                                        float4 c, float4 s) {
  const float4 xr = re[i];
  const float4 xi = im[i];
  re[i] = make_float4(c.x * xr.x - s.x * xi.x, c.y * xr.y - s.y * xi.y,
                      c.z * xr.z - s.z * xi.z, c.w * xr.w - s.w * xi.w);
  im[i] = make_float4(c.x * xi.x + s.x * xr.x, c.y * xi.y + s.y * xr.y,
                      c.z * xi.z + s.z * xr.z, c.w * xi.w + s.w * xr.w);
}

__global__ void diag_rotate_kernel(float4* re0, float4* im0, float4* re1,
                                   float4* im1, int B, long long size4,
                                   const float4* __restrict__ cos_p,
                                   const float4* __restrict__ sin_p,
                                   float sign) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < size4; i += (long long)gridDim.x * blockDim.x) {
    const float4 c = cos_p[i];
    float4 s = sin_p[i];
    s.x *= sign;
    s.y *= sign;
    s.z *= sign;
    s.w *= sign;
    for (int b = 0; b < B; ++b) {
      rotate4(re0, im0, b * size4 + i, c, s);
      if (re1 != nullptr) rotate4(re1, im1, b * size4 + i, c, s);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch helpers
// ---------------------------------------------------------------------------

int sm_count() {
  int dev = 0;
  int sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

template <typename Kernel>
int persistent_grid(Kernel kernel, int threads, size_t smem, long long work) {
  int per_sm = 0;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  long long grid = (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
  if (work < grid) grid = work;
  return grid > 0 ? (int)grid : 1;
}

template <int N>
int launch_axis_apply(const float* x_re, const float* x_im,
                      const float* op_re, const float* op_im, float* y_re,
                      float* y_im, long long cols, int Q,
                      cudaStream_t stream) {
  const size_t smem = (2 * N * N + 2 * N * kApplyLd) * sizeof(float);
  auto kernel = axis_apply_kernel<N>;
  const int grid = persistent_grid(kernel, kApplyThreads, smem,
                                   (cols + kApplyW - 1) / kApplyW);
  kernel<<<grid, kApplyThreads, smem, stream>>>(x_re, x_im, op_re, op_im,
                                                y_re, y_im, cols, Q);
  return (int)cudaGetLastError();
}

template <int N, int TI, int TJ>
struct GramConfig {
  static constexpr size_t smem() {
    return 4 * kGramW * (N + 1) * sizeof(float);
  }
  static int grid(long long cols) {
    return persistent_grid(axis_gram_partial_kernel<N, TI, TJ>, kGramThreads,
                           smem(), (cols + kGramW - 1) / kGramW);
  }
  static void launch(const float* l_re, const float* l_im, const float* a_re,
                     const float* a_im, float* partial, int blocks,
                     long long cols, int Q, cudaStream_t stream) {
    axis_gram_partial_kernel<N, TI, TJ>
        <<<blocks, kGramThreads, smem(), stream>>>(l_re, l_im, a_re, a_im,
                                                   partial, cols, Q);
  }
};

// Thread tiles: (N/TI) x (N/TJ) <= 512 threads, each TI x TJ entries of G.
#define QHBM_GRAM_SWITCH(N, CALL)                 \
  switch (N) {                                    \
    case 2: { using G = GramConfig<2, 1, 1>; CALL; } \
    case 4: { using G = GramConfig<4, 1, 1>; CALL; } \
    case 8: { using G = GramConfig<8, 1, 1>; CALL; } \
    case 16: { using G = GramConfig<16, 1, 1>; CALL; } \
    case 32: { using G = GramConfig<32, 1, 2>; CALL; } \
    case 64: { using G = GramConfig<64, 2, 4>; CALL; } \
    case 128: { using G = GramConfig<128, 4, 8>; CALL; } \
    default: break;                               \
  }

}  // namespace

extern "C" {

// y = Op x on the N axis of the [P, N, Q] view (N a power of two, <= 128).
int qhbm_axis_apply(const float* x_re, const float* x_im, const float* op_re,
                    const float* op_im, float* y_re, float* y_im, int P,
                    int N, int Q, void* stream) {
  int (*launch)(const float*, const float*, const float*, const float*,
                float*, float*, long long, int, cudaStream_t) = nullptr;
  switch (N) {
    case 2: launch = launch_axis_apply<2>; break;
    case 4: launch = launch_axis_apply<4>; break;
    case 8: launch = launch_axis_apply<8>; break;
    case 16: launch = launch_axis_apply<16>; break;
    case 32: launch = launch_axis_apply<32>; break;
    case 64: launch = launch_axis_apply<64>; break;
    case 128: launch = launch_axis_apply<128>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  return launch(x_re, x_im, op_re, op_im, y_re, y_im, (long long)P * Q, Q,
                static_cast<cudaStream_t>(stream));
}

// G = sum conj(l)^T a over the N axis of the [P, N, Q] view.  `partial` is
// scratch of max_blocks * 2 * N * N floats; pass 1 runs on at most
// max_blocks persistent blocks (4 per SM always suffices: 512 threads each).
int qhbm_axis_gram(const float* l_re, const float* l_im, const float* a_re,
                   const float* a_im, float* partial, int max_blocks,
                   float* g_re, float* g_im, int P, int N, int Q,
                   void* stream) {
  const long long cols = (long long)P * Q;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int blocks = 0;
  QHBM_GRAM_SWITCH(N, blocks = G::grid(cols);
                   if (blocks > max_blocks) blocks = max_blocks;
                   G::launch(l_re, l_im, a_re, a_im, partial, blocks, cols, Q,
                             s);
                   break)
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  const int width = 2 * N * N;
  sum_partials_kernel<<<(width + 255) / 256, 256, 0, s>>>(
      partial, blocks, width, g_re, g_im);
  return (int)cudaGetLastError();
}

// bilin[k] over B states [B, R, C]; masks are int32 [K] device arrays;
// `partial` is scratch of blocks * K floats.  Needs C <= 256, K <= 1024.
int qhbm_parity_bilinear(const float* l_re, const float* l_im,
                         const float* a_re, const float* a_im,
                         const int* row_masks, const int* col_masks, int K,
                         int B, int R, int C, float* partial, float* out,
                         int blocks, void* stream) {
  if (C > kBilinThreads || K > kBilinMaxK) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  parity_bilinear_partial_kernel<<<blocks, kBilinThreads, 0, s>>>(
      l_re, l_im, a_re, a_im, row_masks, col_masks, K, B, R, C, partial);
  sum_partials_kernel<<<(K + 255) / 256, 256, 0, s>>>(partial, blocks, K,
                                                      out, nullptr);
  return (int)cudaGetLastError();
}

// In-place rotation of one (re1 == im1 == NULL) or two [B, size] state
// batches by cos + i*sign*sin of the shared [size] planes; size % 4 == 0 and
// every pointer 16-byte aligned.
int qhbm_diag_rotate(float* re0, float* im0, float* re1, float* im1, int B,
                     int size, const float* cos_p, const float* sin_p,
                     int sign, void* stream) {
  const long long size4 = size / 4;
  long long grid = (size4 + 255) / 256;
  const long long cap = (long long)sm_count() * 8;
  if (grid > cap) grid = cap;
  diag_rotate_kernel<<<(int)grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<float4*>(re0), reinterpret_cast<float4*>(im0),
      reinterpret_cast<float4*>(re1), reinterpret_cast<float4*>(im1), B,
      size4, reinterpret_cast<const float4*>(cos_p),
      reinterpret_cast<const float4*>(sin_p), (float)sign);
  return (int)cudaGetLastError();
}

}  // extern "C"
