// Hand-written Hopper (sm_90a) kernels for the statevector forward and
// adjoint reverse sweep of qhbmlib_tpu_torch.
//
// They replace the Pallas kernels of the JAX package:
//   K1  qhbmlib_tpu/ops/pallas_sv.py:615      fused_blocks_minor_apply
//       -> axis2_apply
//   K2  qhbmlib_tpu/ops/pallas_adjoint.py:480 adjoint_sweep
//       -> sweep_kernel<2> (qhbm_adjoint_sweep)
//   K3  qhbmlib_tpu/ops/pallas_sv.py:667      apply_circuit_pallas
//       -> sweep_kernel<1> (qhbm_circuit_forward)
//   K4  qhbmlib_tpu/ops/pallas_sv.py:459      apply_circuit_pallas_batched
//       -> axis_apply, diag_rotate
//   K5  qhbmlib_tpu/ops/pallas_adjoint.py:540 adjoint_sweep_batched
//       -> axis_gram, parity_bilinear (and K4's two)
// A 20-qubit state (8 MB as float32 re/im planes) sat whole in the TPU's
// VMEM; on the H100 it cannot sit in one SM's 227 KB of shared memory, so
// the batched engine makes each circuit segment one or two launches over the
// whole [B, R, C] batch, and the single-state kernels keep the state in the
// 50 MB L2 across one cooperative launch.
//
// States are split-complex: separate float32 re and im planes, row-major.
// A "[P, N, Q] view" of a plane names element (p, n, q) at p*N*Q + n*Q + q;
// a "column" is one (p, q) pair and holds N elements.
//
// Every extern "C" entry point launches on the caller's stream and returns
// cudaGetLastError(); nothing here allocates or synchronises.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

int sm_count();

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
constexpr size_t axis_apply_smem() {
  return (2 * N * N + 2 * N * kApplyLd) * sizeof(float);
}

// The body of axis_apply, shared with the cooperative whole-circuit kernels:
// this block takes tiles first_tile, first_tile + tile_stride, ...  It
// starts and ends with a block barrier, so `smem` may be reused around it.
template <int N>
__device__ void axis_apply_tiles(const float* __restrict__ x_re,
                                 const float* __restrict__ x_im,
                                 const float* __restrict__ op_re,
                                 const float* __restrict__ op_im,
                                 float* __restrict__ y_re,
                                 float* __restrict__ y_im, long long cols,
                                 int Q, long long first_tile,
                                 long long tile_stride, float* smem) {
  float* o_re = smem;              // [N][N]
  float* o_im = o_re + N * N;
  float* t_re = o_im + N * N;      // [N][kApplyLd]
  float* t_im = t_re + N * kApplyLd;
  __syncthreads();
  for (int i = threadIdx.x; i < N * N; i += kApplyThreads) {
    o_re[i] = op_re[i];
    o_im[i] = op_im[i];
  }
  constexpr int kGroups = kApplyThreads / 32;
  constexpr int kRows = (N + kGroups - 1) / kGroups;  // output rows / thread
  const int lane = threadIdx.x & 31;
  const int group = threadIdx.x >> 5;
  const long long tiles = (cols + kApplyW - 1) / kApplyW;

  for (long long tile = first_tile; tile < tiles; tile += tile_stride) {
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
  __syncthreads();
}

template <int N>
__global__ void __launch_bounds__(kApplyThreads)
    axis_apply_kernel(const float* __restrict__ x_re,
                      const float* __restrict__ x_im,
                      const float* __restrict__ op_re,
                      const float* __restrict__ op_im,
                      float* __restrict__ y_re, float* __restrict__ y_im,
                      long long cols, int Q) {
  extern __shared__ float smem[];
  axis_apply_tiles<N>(x_re, x_im, op_re, op_im, y_re, y_im, cols, Q,
                      blockIdx.x, gridDim.x, smem);
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

template <int N>
constexpr size_t axis_gram_smem() {
  return 4 * kGramW * (N + 1) * sizeof(float);
}

// This block's partial G over tiles first_tile, first_tile + tile_stride,
// ... written to out[2 * N * N] (re then im).  Starts and ends with a block
// barrier, so `smem` may be reused around it.
template <int N, int TI, int TJ>
__device__ void axis_gram_tiles(const float* __restrict__ l_re,
                                const float* __restrict__ l_im,
                                const float* __restrict__ a_re,
                                const float* __restrict__ a_im,
                                float* __restrict__ out, long long cols, int Q,
                                long long first_tile, long long tile_stride,
                                float* smem) {
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
  for (long long tile = first_tile; tile < tiles; tile += tile_stride) {
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
  __syncthreads();
}

template <int N, int TI, int TJ>
__global__ void __launch_bounds__(kGramThreads)
    axis_gram_partial_kernel(const float* __restrict__ l_re,
                             const float* __restrict__ l_im,
                             const float* __restrict__ a_re,
                             const float* __restrict__ a_im,
                             float* __restrict__ partial, long long cols,
                             int Q) {
  extern __shared__ float smem[];
  axis_gram_tiles<N, TI, TJ>(l_re, l_im, a_re, a_im,
                             partial + (long long)blockIdx.x * 2 * N * N,
                             cols, Q, blockIdx.x, gridDim.x, smem);
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

// This block's partial bilinears over rows first_block * rows_per, ... with
// THREADS threads; out[K].  `w` holds THREADS floats, s_rm / s_cm kBilinMaxK
// ints each.  Starts and ends with a block barrier.
template <int THREADS>
__device__ void parity_bilinear_rows(const float* __restrict__ l_re,
                                     const float* __restrict__ l_im,
                                     const float* __restrict__ a_re,
                                     const float* __restrict__ a_im,
                                     const int* __restrict__ row_masks,
                                     const int* __restrict__ col_masks, int K,
                                     int B, int R, int C,
                                     float* __restrict__ out, int first_block,
                                     int block_stride, float* w, int* s_rm,
                                     int* s_cm) {
  constexpr int kKPerThread = kBilinMaxK / THREADS;
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += THREADS) {
    s_rm[k] = row_masks[k];
    s_cm[k] = col_masks[k];
  }
  const int rows_per = THREADS / C;
  const long long plane = (long long)R * C;
  float acc[kKPerThread];
#pragma unroll
  for (int j = 0; j < kKPerThread; ++j) acc[j] = 0.f;

  for (long long r0 = (long long)first_block * rows_per; r0 < R;
       r0 += (long long)block_stride * rows_per) {
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
    for (int j = 0; j < kKPerThread; ++j) {
      const int k = threadIdx.x + j * THREADS;
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
  for (int j = 0; j < kKPerThread; ++j) {
    const int k = threadIdx.x + j * THREADS;
    if (k < K) out[k] = acc[j];
  }
  __syncthreads();
}

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
  parity_bilinear_rows<kBilinThreads>(
      l_re, l_im, a_re, a_im, row_masks, col_masks, K, B, R, C,
      partial + (long long)blockIdx.x * K, blockIdx.x, gridDim.x, w, s_rm,
      s_cm);
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
// axis2_apply: y[p, I, m, J, q] = sum_{i, j} A[I, i] B[J, j] x[p, i, m, j, q]
// ---------------------------------------------------------------------------
//
// Replaces K1, the streamed fused 1q-segment kernel
// (qhbmlib_tpu/ops/pallas_sv.py:615 `fused_blocks_minor_apply`, body
// `_fused_1q_kernel`), which applies two row blocks and the minor operator
// of a segment in one pass over [2^k1, 2^k2, C] tiles.  That tile is 16 MB
// at 7 + 7 row bits; an SM holds 227 KB, so here one pass fuses TWO of a
// segment's operators, on two axes of a [P, N1, M, N2, Q] view, and a
// segment takes two passes where axis_apply took one per operator.  The
// Python side pairs them (hopper_sv.plan_passes): the first row block with
// the minor operator (rows of the slab are 128 contiguous floats), then the
// remaining row blocks two by two (at 24 qubits: block 7:7 with block 14:3,
// a [128, 8, W] slab read in runs of W = 16 floats).  Pairing the first two
// row blocks instead would read one float per 32-byte sector.
//
// Bound: a slab of N1 * N2 * W <= 2^14 amplitudes (132 KB as two padded
// planes) is read once, both contractions run on it in shared memory, and
// it is written once -- one state pass for two operators.  The work is
// 8 * (N1 + N2) flop per amplitude, so at N1 = N2 = 128 the kernel is fp32
// FMA-bound as axis_apply is.  The slab leaves no room for whole
// operators, so they stream through shared memory in [N, 32] panels; the
// inner loop then reads them as 16-byte broadcasts, as axis_apply does.
// (Read straight from global memory as warp-uniform float4 loads, the first
// version ran 0.885 ms where two axis_apply passes take ~0.6 ms at 20q.)
constexpr int kSlab = 1 << 14;  // amplitudes per slab

constexpr int kPanel = 32;  // operator columns staged per panel
constexpr size_t kPanelSmem = 2 * 128 * kPanel * sizeof(float);

// In place on a shared-memory slab: every column v of `cols` is replaced by
// Op v.  Column c = o * W + w holds element n at o * ld + n * stride + w.
// Threads: lane -> two columns of a 64-column chunk, warp -> output rows.
// The operator streams through shared memory in [N, kPanel] panels
// (p_re / p_im), so its reads are 16-byte broadcasts as in axis_apply.
template <int N>
__device__ void slab_axis_apply(float* s_re, float* s_im,
                                const float* __restrict__ op_re,
                                const float* __restrict__ op_im, int cols,
                                int W, int ld, int stride, float* p_re,
                                float* p_im) {
  constexpr int kGroups = kApplyThreads / 32;
  constexpr int kRows = (N + kGroups - 1) / kGroups;
  constexpr int kStep = (N % 4 == 0) ? 4 : 1;
  constexpr int kWidth = N < kPanel ? N : kPanel;
  const int lane = threadIdx.x & 31;
  const int group = threadIdx.x >> 5;
  for (int c0 = 0; c0 < cols; c0 += 64) {
    int base[2];
    bool ok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + lane + 32 * h;
      ok[h] = c < cols;
      const int o = c / W;
      base[h] = ok[h] ? o * ld + (c - o * W) : 0;
    }
    float ar[kRows][2], ai[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      ar[r][0] = ar[r][1] = ai[r][0] = ai[r][1] = 0.f;
    }
#pragma unroll 1
    for (int p0 = 0; p0 < N; p0 += kWidth) {
      __syncthreads();  // the previous panel is fully read
      for (int i = threadIdx.x; i < N * kWidth; i += kApplyThreads) {
        const int m = i / kWidth;
        const int j = i - m * kWidth;
        p_re[i] = op_re[m * N + p0 + j];
        p_im[i] = op_im[m * N + p0 + j];
      }
      __syncthreads();
#pragma unroll 1
      for (int n0 = 0; n0 < kWidth; n0 += kStep) {
        float xr[2][kStep], xi[2][kStep];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int j = 0; j < kStep; ++j) {
            xr[h][j] = s_re[base[h] + (p0 + n0 + j) * stride];
            xi[h][j] = s_im[base[h] + (p0 + n0 + j) * stride];
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int m = group + r * kGroups;
          if (m < N) {
            float wr[kStep], wi[kStep];
            if constexpr (kStep == 4) {
              const float4 vr =
                  *reinterpret_cast<const float4*>(&p_re[m * kWidth + n0]);
              const float4 vi =
                  *reinterpret_cast<const float4*>(&p_im[m * kWidth + n0]);
              wr[0] = vr.x; wr[1] = vr.y; wr[2] = vr.z; wr[3] = vr.w;
              wi[0] = vi.x; wi[1] = vi.y; wi[2] = vi.z; wi[3] = vi.w;
            } else {
              wr[0] = p_re[m * kWidth + n0];
              wi[0] = p_im[m * kWidth + n0];
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
#pragma unroll
              for (int j = 0; j < kStep; ++j) {
                ar[r][h] =
                    fmaf(wr[j], xr[h][j], fmaf(-wi[j], xi[h][j], ar[r][h]));
                ai[r][h] =
                    fmaf(wr[j], xi[h][j], fmaf(wi[j], xr[h][j], ai[r][h]));
              }
            }
          }
        }
      }
    }
    __syncthreads();  // every thread has read this chunk's inputs
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int m = group + r * kGroups;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (m < N && ok[h]) {
          s_re[base[h] + m * stride] = ar[r][h];
          s_im[base[h] + m * stride] = ai[r][h];
        }
      }
    }
    __syncthreads();
  }
}

#define QHBM_LOG2_SWITCH(K, FN, ...)       \
  switch (K) {                             \
    case 1: FN<2>(__VA_ARGS__); break;     \
    case 2: FN<4>(__VA_ARGS__); break;     \
    case 3: FN<8>(__VA_ARGS__); break;     \
    case 4: FN<16>(__VA_ARGS__); break;    \
    case 5: FN<32>(__VA_ARGS__); break;    \
    case 6: FN<64>(__VA_ARGS__); break;    \
    case 7: FN<128>(__VA_ARGS__); break;   \
    default: break;                        \
  }

__global__ void __launch_bounds__(kApplyThreads)
    axis2_apply_kernel(const float* __restrict__ x_re,
                       const float* __restrict__ x_im,
                       const float* __restrict__ a_re,
                       const float* __restrict__ a_im,
                       const float* __restrict__ b_re,
                       const float* __restrict__ b_im,
                       float* __restrict__ y_re, float* __restrict__ y_im,
                       long long P, int k1, int M, int k2, int Q, int W) {
  extern __shared__ float smem[];
  const int n1 = 1 << k1;
  const int n2 = 1 << k2;
  const int L = n2 * W;    // slab row: (j, w) pairs
  const int ld = L + 1;    // padded row stride
  float* s_re = smem;
  float* s_im = smem + n1 * ld;
  float* p_re = s_im + n1 * ld;  // 16-byte aligned: 2 * n1 * ld % 4 == 0
  float* p_im = p_re + 128 * kPanel;
  const long long q_tiles = Q / W;
  const long long slabs = P * M * q_tiles;
  const long long i_stride = (long long)M * n2 * Q;
  for (long long slab = blockIdx.x; slab < slabs; slab += gridDim.x) {
    const long long pm = slab / q_tiles;
    const long long q0 = (slab - pm * q_tiles) * W;
    const long long p = pm / M;
    const long long m = pm - p * M;
    const long long base = p * n1 * i_stride + m * n2 * (long long)Q + q0;
    __syncthreads();  // the previous slab is fully stored
    for (int e = threadIdx.x; e < n1 * L; e += kApplyThreads) {
      const int i = e / L;
      const int rem = e - i * L;
      const int j = rem / W;
      const long long off = base + i * i_stride + (long long)j * Q + (rem - j * W);
      s_re[i * ld + rem] = x_re[off];
      s_im[i * ld + rem] = x_im[off];
    }
    __syncthreads();
    // A on the N1 axis: columns are the L (j, w) pairs, element i at i * ld.
    QHBM_LOG2_SWITCH(k1, slab_axis_apply, s_re, s_im, a_re, a_im, L, L, 0, ld,
                     p_re, p_im)
    // B on the N2 axis: columns are the (i, w) pairs, element j at j * W.
    QHBM_LOG2_SWITCH(k2, slab_axis_apply, s_re, s_im, b_re, b_im, n1 * W, W,
                     ld, W, p_re, p_im)
    for (int e = threadIdx.x; e < n1 * L; e += kApplyThreads) {
      const int i = e / L;
      const int rem = e - i * L;
      const int j = rem / W;
      const long long off = base + i * i_stride + (long long)j * Q + (rem - j * W);
      y_re[off] = s_re[i * ld + rem];
      y_im[off] = s_im[i * ld + rem];
    }
  }
}

// ---------------------------------------------------------------------------
// circuit_forward / adjoint_sweep: every segment of one state's circuit in
// ONE cooperative launch, stages separated by grid-wide barriers.
// ---------------------------------------------------------------------------
//
// Replace K3 (qhbmlib_tpu/ops/pallas_sv.py:667 `apply_circuit_pallas`, the
// whole circuit forward with the state in VMEM) and K2
// (qhbmlib_tpu/ops/pallas_adjoint.py:480 `adjoint_sweep`, the whole
// reverse sweep with psi and lambda in VMEM), for 8 <= n <= 20 as there.
//
// Bound: at 20 qubits a state is two 4 MB planes; with its ping-pong copy
// (and lambda's, for the sweep) it fits the 50 MB L2, which takes the place
// of VMEM residency.  Every stage then streams the state from L2, and a
// stage costs at least one grid barrier, so the design keeps one launch per
// circuit: one persistent 512-thread block per SM (the N = 128 operator and
// tile take 193 KB of shared memory), walking a stage table in device memory,
// one record per stage in order, each with its own data offsets (so the
// Pallas kernel's loop over repeated layers has no counterpart).  A stage is
//   kAxis  -- an [N, N] operator on bits [start, start + k) of every state,
//             axis_apply's tile code, out of place into the other buffer;
//   kDiag  -- theta = sum_k w_k s(x & mask_k), summed per amplitude in fp64
//             from the parity masks with __popc (the Pallas kernel builds
//             its sign matrices in-kernel too), then one sincosf rotation
//             of every state in place; no cos/sin planes are read;
//   kGram  -- (sweep) G over bits [start, start + k) from (lambda, a):
//             per-block partials, a barrier, then a sum in block order;
//   kBilin -- (sweep) the parity bilinears of Im(conj(lambda) a), likewise.
// A kDiag or kBilin record holds at most kBilinMaxK factors (the shared
// memory its masks and weights are staged in); the host splits a longer
// diagonal segment into several records.
// Reductions are summed without float atomics, so gradients are bitwise
// reproducible.  The inverse operators and negated weights of the sweep are
// folded on the host.  A launch that cannot be co-resident is refused.
constexpr int kAxis = 0;
constexpr int kDiag = 1;
constexpr int kGram = 2;
constexpr int kBilin = 3;
constexpr int kStageInts = 8;  // kind, start, k, K, data, masks, out, unused
constexpr size_t kSweepSmem = axis_apply_smem<128>();
static_assert(kSweepSmem >= axis_gram_smem<128>() &&
                  kSweepSmem >= (kApplyThreads + 2 * kBilinMaxK) * 4,
              "the sweep's shared memory must hold every stage's");

__device__ void sweep_diag(float* re0, float* im0, float* re1, float* im1,
                           long long size, const float* __restrict__ w,
                           const int* __restrict__ masks, int K, float* s_w,
                           int* s_mask) {
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    s_w[k] = w[k];
    s_mask[k] = masks[k];
  }
  __syncthreads();
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < size; idx += (long long)gridDim.x * blockDim.x) {
    const int x = (int)idx;  // (row << m) | col
    double theta = 0.0;
    for (int k = 0; k < K; ++k) {
      const double v = s_w[k];
      theta += (__popc(x & s_mask[k]) & 1) ? -v : v;
    }
    float s, c;
    sincosf((float)theta, &s, &c);
    float xr = re0[idx], xi = im0[idx];
    re0[idx] = c * xr - s * xi;
    im0[idx] = c * xi + s * xr;
    if (re1 != nullptr) {
      xr = re1[idx];
      xi = im1[idx];
      re1[idx] = c * xr - s * xi;
      im1[idx] = c * xi + s * xr;
    }
  }
}

__device__ void sweep_sum_partials(const float* __restrict__ partial,
                                   int blocks, int width,
                                   float* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < width;
       i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < blocks; ++b) s += partial[(long long)b * width + i];
    out[i] = s;
  }
}

__device__ void sweep_gram(int k, const float* l_re, const float* l_im,
                           const float* a_re, const float* a_im, float* out,
                           long long cols, int Q, float* smem) {
  const long long b = blockIdx.x;
  const long long g = gridDim.x;
  switch (k) {
    case 1: axis_gram_tiles<2, 1, 1>(l_re, l_im, a_re, a_im, out, cols, Q, b, g, smem); break;
    case 2: axis_gram_tiles<4, 1, 1>(l_re, l_im, a_re, a_im, out, cols, Q, b, g, smem); break;
    case 3: axis_gram_tiles<8, 1, 1>(l_re, l_im, a_re, a_im, out, cols, Q, b, g, smem); break;
    case 4: axis_gram_tiles<16, 1, 1>(l_re, l_im, a_re, a_im, out, cols, Q, b, g, smem); break;
    case 5: axis_gram_tiles<32, 1, 2>(l_re, l_im, a_re, a_im, out, cols, Q, b, g, smem); break;
    case 6: axis_gram_tiles<64, 2, 4>(l_re, l_im, a_re, a_im, out, cols, Q, b, g, smem); break;
    case 7: axis_gram_tiles<128, 4, 8>(l_re, l_im, a_re, a_im, out, cols, Q, b, g, smem); break;
    default: break;
  }
}

// S = 1: circuit_forward of `a`.  S = 2: adjoint_sweep of (a, lambda).
// Each state buffer holds two (re, im) plane pairs of 2^n floats; the
// state starts in pair 0 and every kAxis stage flips the current pair.
template <int S>
__global__ void __launch_bounds__(kApplyThreads)
    sweep_kernel(float* a, float* lam, int n, int m,
                 const int* __restrict__ stages, int num_stages,
                 const float* __restrict__ data,
                 const int* __restrict__ masks, float* __restrict__ partial,
                 float* __restrict__ out) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const long long size = 1LL << n;
  float* states[2] = {a, lam};
  int cur = 0;
  for (int t = 0; t < num_stages; ++t) {
    const int* sd = stages + kStageInts * t;
    const int kind = sd[0];
    const int start = sd[1];
    const int k = sd[2];
    const int K = sd[3];
    const float* d = data + sd[4];
    const int* mk = masks + sd[5];
    const long long P = 1LL << start;
    const int Q = 1 << (n - start - k);
    float* a0 = states[0] + cur * 2 * size;
    float* l0 = S == 2 ? states[1] + cur * 2 * size : nullptr;
    if (kind == kAxis) {
      const int nn = 1 << (2 * k);
      for (int s = 0; s < S; ++s) {
        float* src = states[s] + cur * 2 * size;
        float* dst = states[s] + (cur ^ 1) * 2 * size;
        QHBM_LOG2_SWITCH(k, axis_apply_tiles, src, src + size, d, d + nn,
                         dst, dst + size, P * Q, Q, blockIdx.x, gridDim.x,
                         smem)
      }
      cur ^= 1;
      grid.sync();
    } else if (kind == kDiag) {
      sweep_diag(a0, a0 + size, l0, S == 2 ? l0 + size : nullptr, size, d,
                 mk, K, smem, reinterpret_cast<int*>(smem + kBilinMaxK));
      grid.sync();
    } else if constexpr (S == 2) {
      float* o = out + sd[6];
      int width;
      if (kind == kGram) {
        width = 2 << (2 * k);
        sweep_gram(k, l0, l0 + size, a0, a0 + size,
                   partial + (long long)blockIdx.x * width, P * Q, Q, smem);
      } else {  // kBilin
        width = K;
        int* s_masks = reinterpret_cast<int*>(smem + kApplyThreads);
        parity_bilinear_rows<kApplyThreads>(
            l0, l0 + size, a0, a0 + size, mk, mk + K, K, 1, 1 << (n - m),
            1 << m, partial + (long long)blockIdx.x * K, blockIdx.x,
            gridDim.x, smem, s_masks, s_masks + kBilinMaxK);
      }
      grid.sync();
      sweep_sum_partials(partial, gridDim.x, width, o);
      grid.sync();  // the partials are free for the next reduction
    }
  }
}

// Co-resident blocks of sweep_kernel<S> (one per SM at the 193 KB of shared
// memory); 0 if the device cannot launch it cooperatively.
template <int S>
int sweep_blocks() {
  int dev = 0;
  int coop = 0;
  int per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return 0;
  auto kernel = sweep_kernel<S>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kSweepSmem) != cudaSuccess) {
    return 0;
  }
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessorWithFlags(
          &per_sm, kernel, kApplyThreads, kSweepSmem, cudaOccupancyDefault) !=
      cudaSuccess) {
    return 0;
  }
  return per_sm * sm_count();
}

template <int S>
int launch_sweep(float* a, float* lam, int n, int m, const int* stages,
                 int num_stages, const float* data, const int* masks,
                 float* partial, int blocks, float* out, cudaStream_t stream) {
  if (blocks <= 0 || blocks > sweep_blocks<S>()) {
    return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  void* args[] = {&a, &lam, &n, &m, &stages, &num_stages, &data,
                  &masks, &partial, &out};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)sweep_kernel<S>, dim3(blocks), dim3(kApplyThreads), args,
      kSweepSmem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
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
  const size_t smem = axis_apply_smem<N>();
  auto kernel = axis_apply_kernel<N>;
  const int grid = persistent_grid(kernel, kApplyThreads, smem,
                                   (cols + kApplyW - 1) / kApplyW);
  kernel<<<grid, kApplyThreads, smem, stream>>>(x_re, x_im, op_re, op_im,
                                                y_re, y_im, cols, Q);
  return (int)cudaGetLastError();
}

template <int N, int TI, int TJ>
struct GramConfig {
  static constexpr size_t smem() { return axis_gram_smem<N>(); }
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

// y = (A on the N1 axis) (B on the N2 axis) x of the [P, N1, M, N2, Q]
// view, N1 = 2^k1 and N2 = 2^k2 in [2, 128], Q a power of two.
int qhbm_axis2_apply(const float* x_re, const float* x_im, const float* a_re,
                     const float* a_im, const float* b_re, const float* b_im,
                     float* y_re, float* y_im, int P, int k1, int M, int k2,
                     int Q, void* stream) {
  if (k1 < 1 || k1 > 7 || k2 < 1 || k2 > 7 || Q < 1 || (Q & (Q - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  int W = kSlab >> (k1 + k2);
  if (W < 1) W = 1;
  if (W > Q) W = Q;
  const size_t smem =
      2 * (size_t)(1 << k1) * ((1 << k2) * W + 1) * sizeof(float) +
      kPanelSmem;
  const int grid = persistent_grid(axis2_apply_kernel, kApplyThreads, smem,
                                   (long long)P * M * (Q / W));
  axis2_apply_kernel<<<grid, kApplyThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x_re, x_im, a_re, a_im, b_re, b_im, y_re, y_im, P, k1, M, k2, Q, W);
  return (int)cudaGetLastError();
}

// Blocks of one cooperative circuit_forward (states = 1) or adjoint_sweep
// (states = 2) launch; 0 when it cannot be launched cooperatively.
int qhbm_sweep_blocks(int states) {
  return states == 2 ? sweep_blocks<2>() : sweep_blocks<1>();
}

// The whole circuit on one state: `a` holds 4 planes of 2^n floats, the
// state in planes 0-1 on entry; the result is in planes 0-1 when the table
// of `num_stages` records has an even number of kAxis stages, else in
// planes 2-3.  No kDiag record may hold more than kBilinMaxK factors.
int qhbm_circuit_forward(float* a, int n, int m, const int* stages,
                         int num_stages, const float* data, const int* masks,
                         int blocks, void* stream) {
  return launch_sweep<1>(a, nullptr, n, m, stages, num_stages, data,
                         masks, nullptr, blocks, nullptr,
                         static_cast<cudaStream_t>(stream));
}

// The reverse sweep of (a, lam), each 4 planes as in circuit_forward; the
// reductions land in `out` at the stages' offsets.  `partial` is scratch of
// blocks * (the widest reduction) floats.
int qhbm_adjoint_sweep(float* a, float* lam, int n, int m, const int* stages,
                       int num_stages, const float* data, const int* masks,
                       float* partial, int blocks, float* out, void* stream) {
  return launch_sweep<2>(a, lam, n, m, stages, num_stages, data, masks,
                         partial, blocks, out,
                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
