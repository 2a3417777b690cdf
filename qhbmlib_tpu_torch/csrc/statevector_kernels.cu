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
//       -> qubit_transitions, diag_bilinear (qhbm_parity_bilinear: the
//          diagonal stage's bilinears and its un-apply in one pass; K1 /
//          K4's applies un-apply the 1q segments)
// and, for the gates no Pallas kernel takes (CXP, XXP, YYP, PROTs with X
// or Y factors on two or more qubits), which the reference applies one at
// a time through XLA (qhbmlib_tpu/ops/statevector.py:604 apply_gate):
//       -> flip_apply (the batched forward, an un-apply alone) and
//          flip_bilinear (the batched sweep's stage: un-apply and gradient)
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

#include <mutex>
#include <vector>

namespace cg = cooperative_groups;

namespace {

int sm_count();
int blocks_per_sm(const void* kernel, int threads, size_t smem,
                  bool max_carveout);
template <auto kAttr>
int device_attribute();

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
// (~67 TFLOP/s over 3.35 TB/s, ~20 flop/B).  So for N >= 16 axis_apply runs
// on the tensor cores (axis_apply_mma_kernel, below K1).  Below N = 16 an
// amplitude costs 8N flop against 16 bytes, at most 4 flop/B: a stream that
// HBM bounds, which axis_stream_kernel (below) serves -- the lone row blocks
// of 15-17 and 29-31 qubits and the minor operator of 2-3 qubits.
//
// axis_apply_tiles is the fp32 FMA body of the cooperative whole-circuit
// kernels' axis stages of N < 16.  The operator is staged once per
// persistent block in shared memory, a tile of W columns is staged beside
// it, each of 512 threads keeps an (N/16)x2 register tile of outputs,
// operator reads are 16-byte warp broadcasts, and outputs go back through
// shared memory so the stores are as coalesced as the loads; 512 threads
// give each scheduler four warps to hide shared-memory latency.
constexpr int kApplyThreads = 512;
constexpr int kApplyW = 64;             // columns per tile (2 per lane)
constexpr int kApplyLd = kApplyW + 1;   // padded row stride of the tile

template <int N>
constexpr size_t axis_apply_smem() {
  return (2 * N * N + 2 * N * kApplyLd) * sizeof(float);
}

// The cooperative kernels' axis stage of N < 16 on one block: this block
// takes tiles first_tile, first_tile + tile_stride, ...  It
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

// axis_stream_kernel<N, W, kVec>: axis_apply for N < 16, streamed through
// registers.  A thread owns a group of W = min(Q, 4) consecutive q of one p
// (for Q < 4, whole p's: N * Q contiguous floats a plane): it loads the
// group's N rows of each plane straight into registers (with kVec, one
// 16-byte load a row and plane, so a warp reads 512 contiguous bytes a row
// at Q >= 128), forms the N output rows one at a time and stores each at
// once.  No shared-memory tile and no barrier in the loop: the operator
// (2 N^2 <= 128 floats) is staged once a block behind one barrier and read
// as warp-uniform broadcasts.  Every load of a group is issued before its
// first FMA, so a thread keeps 2 N W floats in flight.  Groups are taken
// in a grid-stride loop; the launcher gives one group a thread up to
// kStreamBlocksPerSm blocks an SM.  Without kVec (W < 4, or a plane not
// 16-byte aligned) the same loop runs on 4-byte loads and stores.
constexpr int kStreamThreads = 256;
constexpr int kStreamBlocksPerSm = 16;

template <int N, int W, bool kVec>
__global__ void __launch_bounds__(kStreamThreads)
    axis_stream_kernel(const float* __restrict__ x_re,
                       const float* __restrict__ x_im,
                       const float* __restrict__ op_re,
                       const float* __restrict__ op_im,
                       float* __restrict__ y_re, float* __restrict__ y_im,
                       long long groups, int log_q) {
  static_assert(N >= 2 && N < 16 && (W == 1 || W == 2 || W == 4) &&
                    (!kVec || W == 4),
                "axis_stream_kernel: N < 16; W of 1, 2 or 4; kVec at W = 4");
  extern __shared__ float smem[];  // [N][N] re, then [N][N] im
  for (int i = threadIdx.x; i < N * N; i += kStreamThreads) {
    smem[i] = op_re[i];
    smem[N * N + i] = op_im[i];
  }
  __syncthreads();
  constexpr int kLogW = W == 4 ? 2 : W - 1;
  const int log_g = log_q - kLogW;  // groups a p
  const long long q_mask = (1LL << log_g) - 1;
  const long long stride = (long long)gridDim.x * kStreamThreads;
  for (long long g = (long long)blockIdx.x * kStreamThreads + threadIdx.x;
       g < groups; g += stride) {
    const long long base =
        (((g >> log_g) * N) << log_q) + ((g & q_mask) << kLogW);
    float xr[N][W], xi[N][W];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const long long off = base + ((long long)n << log_q);
      if constexpr (kVec) {
        const float4 vr = *reinterpret_cast<const float4*>(x_re + off);
        const float4 vi = *reinterpret_cast<const float4*>(x_im + off);
        xr[n][0] = vr.x; xr[n][1] = vr.y; xr[n][2] = vr.z; xr[n][3] = vr.w;
        xi[n][0] = vi.x; xi[n][1] = vi.y; xi[n][2] = vi.z; xi[n][3] = vi.w;
      } else {
#pragma unroll
        for (int w = 0; w < W; ++w) {
          xr[n][w] = x_re[off + w];
          xi[n][w] = x_im[off + w];
        }
      }
    }
    // From N = 4 the output rows go one at a time, so one row's operator
    // is live, not all 2 N^2 floats: unrolled, N = 8 took 255 registers (one
    // block an SM) and ran 5% slower at 17q; at N = 2 the loop not unrolled
    // ran 34% slower (PERF.md, section 6).
#pragma unroll(N >= 4 ? 1 : N)
    for (int m = 0; m < N; ++m) {
      float ar[W], ai[W];
#pragma unroll
      for (int w = 0; w < W; ++w) ar[w] = ai[w] = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float wr = smem[m * N + n];
        const float wi = smem[N * N + m * N + n];
#pragma unroll
        for (int w = 0; w < W; ++w) {
          ar[w] = fmaf(wr, xr[n][w], fmaf(-wi, xi[n][w], ar[w]));
          ai[w] = fmaf(wr, xi[n][w], fmaf(wi, xr[n][w], ai[w]));
        }
      }
      const long long off = base + ((long long)m << log_q);
      if constexpr (kVec) {
        *reinterpret_cast<float4*>(y_re + off) =
            make_float4(ar[0], ar[1], ar[2], ar[3]);
        *reinterpret_cast<float4*>(y_im + off) =
            make_float4(ai[0], ai[1], ai[2], ai[3]);
      } else {
#pragma unroll
        for (int w = 0; w < W; ++w) {
          y_re[off + w] = ar[w];
          y_im[off + w] = ai[w];
        }
      }
    }
  }
}

using AxisStreamKernel = void (*)(const float*, const float*, const float*,
                                  const float*, float*, float*, long long,
                                  int);

// The axis_stream_kernel instance for Q = 2^log_q on these planes: 16-byte
// accesses where Q >= 4 and every plane is 16-byte aligned.
template <int N>
AxisStreamKernel axis_stream_pick(int log_q, const float* x_re,
                                  const float* x_im, const float* y_re,
                                  const float* y_im) {
  const unsigned long long any =
      (unsigned long long)x_re | (unsigned long long)x_im |
      (unsigned long long)y_re | (unsigned long long)y_im;
  if (log_q >= 2) {
    return any % 16 ? axis_stream_kernel<N, 4, false>
                    : axis_stream_kernel<N, 4, true>;
  }
  return log_q == 1 ? axis_stream_kernel<N, 2, false>
                    : axis_stream_kernel<N, 1, false>;
}

// ---------------------------------------------------------------------------
// The batched engine's diagonal stages: a (batch, amplitude) grid.
// ---------------------------------------------------------------------------
//
// diag_rotate (the forward's diagonal segments) and diag_bilinear (the
// sweep's: parity bilinears, then the un-apply) stream [B, R, C] state
// batches that share one [R, C] cos/sin plane pair.  Their shapes run from
// B = 2^n states of 2^n amplitudes (rho's eigenvectors: 8q B = 256, 11q B =
// 2048) to a state that alone fills the card (20q B = 64, 24q B = 8).  A
// grid over one state's amplitudes that loops over the batch in a thread
// has one or two blocks at 8-11 qubits, so the grid here spans amplitude
// tiles x batch chunks: a block owns the states [chunk * S, chunk * S + S)
// of one tile of up to kDiagThreads float4s at a time, its threads split
// into `lanes` lanes over the chunk's states where a state has fewer
// float4s than the block has threads.  Each thread loads a tile position's
// cos/sin once and applies it to its lane's states, kDiagUnroll states'
// 16-byte loads in flight before the first store.  Where one state has at
// least half a wave of tiles (20q, 24q), the chunk is the whole batch and
// the blocks walk the tiles: a second chunk would read the planes again
// for no more parallelism.  Otherwise the
// batch is cut into as many chunks as a wave holds beside the tiles, down
// to one state a lane.  Each (state, amplitude) has exactly one owning
// thread, so the in-place writes never race a read.
constexpr int kDiagThreads = 256;
constexpr int kDiagBlocksPerSm = 8;  // a wave: 2048 threads an SM
constexpr int kDiagUnroll = 4;       // states a lane loads before it stores

// Launch geometry: blockIdx.x = chunk * tiles_grid + t; block t walks tiles
// t, t + tiles_grid, ... of its chunk.
struct DiagGrid {
  int tile4;       // float4s of a tile: min(state, kDiagThreads)
  int lanes;       // kDiagThreads / tile4 lanes over a chunk's states
  long long tiles;  // tiles of one state
  int tiles_grid;  // blocks over the tiles (<= tiles)
  int chunk;       // states of a chunk (a multiple of lanes, or the batch)
  int chunks;
  int blocks() const { return tiles_grid * chunks; }
};

// The grid of B states of size4 float4s for a wave of `wave` blocks: at
// most `wave` blocks.
DiagGrid diag_grid(long long B, long long size4, long long wave) {
  DiagGrid g;
  g.tile4 = (int)(size4 < kDiagThreads ? size4 : kDiagThreads);
  g.lanes = kDiagThreads / g.tile4;
  g.tiles = (size4 + g.tile4 - 1) / g.tile4;
  const long long want = wave / g.tiles;  // chunks a wave holds
  if (want <= 1) {
    g.tiles_grid = (int)(g.tiles < wave ? g.tiles : wave);
    g.chunk = (int)B;
    g.chunks = 1;
    return g;
  }
  g.tiles_grid = (int)g.tiles;
  const long long per = (B + want * g.lanes - 1) / (want * g.lanes);
  g.chunk = (int)(per * g.lanes);
  g.chunks = (int)((B + g.chunk - 1) / g.chunk);
  return g;
}

// This thread's place in the grid: float4 tx of a tile in lane ty, states
// [b_begin + ty, b_end) of its chunk in steps of `lanes`.
struct DiagPlace {
  int tx;
  int ty;
  long long tile0;
  int b_begin;
  int b_end;
};

__device__ __forceinline__ DiagPlace diag_place(const DiagGrid& g, int B) {
  DiagPlace p;
  p.tx = (int)threadIdx.x % g.tile4;
  p.ty = (int)threadIdx.x / g.tile4;
  p.tile0 = (long long)(blockIdx.x % g.tiles_grid);
  const long long chunk = blockIdx.x / g.tiles_grid;
  p.b_begin = (int)(chunk * g.chunk);
  const long long end = (chunk + 1) * g.chunk;
  p.b_end = end < B ? (int)end : B;
  return p;
}

// (re, im) <- (c + i*s) * (re, im), four amplitudes.
__device__ __forceinline__ void rotate4(float4& re, float4& im, float4 c,
                                        float4 s) {
  const float4 xr = re;
  const float4 xi = im;
  re = make_float4(c.x * xr.x - s.x * xi.x, c.y * xr.y - s.y * xi.y,
                   c.z * xr.z - s.z * xi.z, c.w * xr.w - s.w * xi.w);
  im = make_float4(c.x * xi.x + s.x * xr.x, c.y * xi.y + s.y * xr.y,
                   c.z * xi.z + s.z * xr.z, c.w * xi.w + s.w * xr.w);
}

// ---------------------------------------------------------------------------
// diag_rotate: x <- (cos t + i*sign*sin t) * x, in place, for one or two
// state batches sharing the [R, C] cos/sin planes.
// ---------------------------------------------------------------------------
//
// Replaces the "diag_rot" stage of K4 (pallas_sv.py `_make_batched_kernel`,
// sign +).  Bound: device memory -- 16 bytes read and written per
// amplitude for 6 flop; the planes, read once a tile position and block,
// add 8 bytes per amplitude of ONE state.  kTwo rotates two batches (a and
// lambda) with the same planes.
template <bool kTwo>
__global__ void __launch_bounds__(kDiagThreads)
    diag_rotate_kernel(float4* __restrict__ re0, float4* __restrict__ im0,
                       float4* __restrict__ re1, float4* __restrict__ im1,
                       int B, long long size4, DiagGrid g,
                       const float4* __restrict__ cos_p,
                       const float4* __restrict__ sin_p, float sign) {
  const DiagPlace p = diag_place(g, B);
  if (p.ty >= g.lanes) return;
  const int step = g.lanes;
  for (long long i = p.tile0 * g.tile4 + p.tx; i < size4;
       i += (long long)g.tiles_grid * g.tile4) {
    const float4 c = cos_p[i];
    float4 s = sin_p[i];
    s.x *= sign;
    s.y *= sign;
    s.z *= sign;
    s.w *= sign;
    for (int b = p.b_begin + p.ty; b < p.b_end; b += kDiagUnroll * step) {
      float4 xr[kDiagUnroll], xi[kDiagUnroll], yr[kDiagUnroll],
          yi[kDiagUnroll];
#pragma unroll
      for (int j = 0; j < kDiagUnroll; ++j) {
        const long long o = (long long)(b + j * step) * size4 + i;
        if (b + j * step < p.b_end) {
          xr[j] = re0[o];
          xi[j] = im0[o];
          if (kTwo) {
            yr[j] = re1[o];
            yi[j] = im1[o];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kDiagUnroll; ++j) {
        const long long o = (long long)(b + j * step) * size4 + i;
        if (b + j * step < p.b_end) {
          rotate4(xr[j], xi[j], c, s);
          re0[o] = xr[j];
          im0[o] = xi[j];
          if (kTwo) {
            rotate4(yr[j], yi[j], c, s);
            re1[o] = yr[j];
            im1[o] = yi[j];
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// diag_bilinear: bilin[k] = sum_{b,r,c} s(r & rm_k) s(c & cm_k)
//                           (l_re*a_im - l_im*a_re)[b, r, c],
// and, with kRotate, a and lambda <- exp(-i theta) * (a, lambda) in place.
// ---------------------------------------------------------------------------
//
// Replaces the "bwddiagrot" stage of K5 (pallas_adjoint.py
// `_make_bwd_kernel`: the [R, K] sign matmul and column-sum dot, then the
// un-apply of a and lambda), summed over the batch.  Since
// Im(conj(lam e^{-it}) a e^{-it}) = Im(conj(lam) a), the bilinears are the
// same before and after the rotation, so one pass reads a and lambda once,
// writes them un-applied and emits the K bilinears.
//
// Bound: device memory -- 32 bytes read and 32 written per amplitude-state
// with the un-apply (16 read without it).  Each thread sums its lane's
// Im(conj(lam) a) over its states in registers; the block sums its lanes
// in a fixed order into w[r, c] for the tile's rows in shared memory, then
// a log2(C)-level Walsh-Hadamard butterfly over each row gives every column
// parity u[r, m] = sum_c s(c & m) w[r, c] at once (C log2 C adds a row, not
// K * C sign-and-adds), and factor k adds s(r & rm_k) u[r, cm_k] over the
// tile's rows: one sign a row and factor.  Per-block partials are summed in
// a fixed order by sum_partials_kernel: no float atomics, so the gradient
// is the same run to run.  C is a power of two in [4, 256], K <= kBilinMaxK.
constexpr int kBilinMaxK = 1024;
constexpr size_t kDiagBilinearSmem =
    (8 * kDiagThreads + 2 * kBilinMaxK) * sizeof(float);

template <bool kRotate>
__global__ void __launch_bounds__(kDiagThreads)
    diag_bilinear_kernel(float4* __restrict__ l_re, float4* __restrict__ l_im,
                         float4* __restrict__ a_re, float4* __restrict__ a_im,
                         const float4* __restrict__ cos_p,
                         const float4* __restrict__ sin_p,
                         const int* __restrict__ row_masks,
                         const int* __restrict__ col_masks, int K, int B,
                         int R, int C, DiagGrid g,
                         float* __restrict__ partial) {
  constexpr int kKPerThread = kBilinMaxK / kDiagThreads;
  extern __shared__ float smem[];  // kDiagBilinearSmem bytes
  float4* s_w = reinterpret_cast<float4*>(smem);  // each lane's sums
  float* s_u = smem + 4 * kDiagThreads;  // a tile's rows, then parities
  int* s_rm = reinterpret_cast<int*>(s_u + 4 * kDiagThreads);
  int* s_cm = s_rm + kBilinMaxK;
  for (int k = threadIdx.x; k < K; k += kDiagThreads) {
    s_rm[k] = row_masks[k];
    s_cm[k] = col_masks[k];
  }
  const DiagPlace p = diag_place(g, B);
  const bool lane_on = p.ty < g.lanes;
  const int step = g.lanes;
  const long long size4 = (long long)R * C / 4;
  const int rows = 4 * g.tile4 / C;  // rows of a tile
  float acc[kKPerThread];
#pragma unroll
  for (int j = 0; j < kKPerThread; ++j) acc[j] = 0.f;

  for (long long tile = p.tile0; tile < g.tiles; tile += g.tiles_grid) {
    const long long i = tile * g.tile4 + p.tx;
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    if (lane_on && i < size4) {
      float4 c = make_float4(1.f, 1.f, 1.f, 1.f);
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kRotate) {  // the un-apply: exp(-i theta)
        c = cos_p[i];
        s = sin_p[i];
        s.x = -s.x;
        s.y = -s.y;
        s.z = -s.z;
        s.w = -s.w;
      }
      for (int b = p.b_begin + p.ty; b < p.b_end; b += kDiagUnroll * step) {
        float4 lr[kDiagUnroll], li[kDiagUnroll], ar[kDiagUnroll],
            ai[kDiagUnroll];
#pragma unroll
        for (int j = 0; j < kDiagUnroll; ++j) {
          const long long o = (long long)(b + j * step) * size4 + i;
          if (b + j * step < p.b_end) {
            lr[j] = l_re[o];
            li[j] = l_im[o];
            ar[j] = a_re[o];
            ai[j] = a_im[o];
          }
        }
#pragma unroll
        for (int j = 0; j < kDiagUnroll; ++j) {
          const long long o = (long long)(b + j * step) * size4 + i;
          if (b + j * step < p.b_end) {
            w.x = fmaf(lr[j].x, ai[j].x, fmaf(-li[j].x, ar[j].x, w.x));
            w.y = fmaf(lr[j].y, ai[j].y, fmaf(-li[j].y, ar[j].y, w.y));
            w.z = fmaf(lr[j].z, ai[j].z, fmaf(-li[j].z, ar[j].z, w.z));
            w.w = fmaf(lr[j].w, ai[j].w, fmaf(-li[j].w, ar[j].w, w.w));
            if (kRotate) {
              rotate4(ar[j], ai[j], c, s);
              rotate4(lr[j], li[j], c, s);
              a_re[o] = ar[j];
              a_im[o] = ai[j];
              l_re[o] = lr[j];
              l_im[o] = li[j];
            }
          }
        }
      }
    }
    s_w[threadIdx.x] = w;
    __syncthreads();
    // The lanes' sums, lane by lane: w[r, c] of the tile, row-major.
    for (int t = threadIdx.x; t < g.tile4; t += kDiagThreads) {
      float4 v = s_w[t];
      for (int y = 1; y < g.lanes; ++y) {
        const float4 e = s_w[y * g.tile4 + t];
        v.x += e.x;
        v.y += e.y;
        v.z += e.z;
        v.w += e.w;
      }
      s_u[4 * t] = v.x;
      s_u[4 * t + 1] = v.y;
      s_u[4 * t + 2] = v.z;
      s_u[4 * t + 3] = v.w;
    }
    __syncthreads();
    // Butterflies on bit h of the column, h < C: rows never mix.
    for (int h = 1; h < C; h <<= 1) {
      for (int q = threadIdx.x; q < rows * C / 2; q += kDiagThreads) {
        const int lo = (q / h) * 2 * h + q % h;
        const float x = s_u[lo];
        const float y = s_u[lo + h];
        s_u[lo] = x + y;
        s_u[lo + h] = x - y;
      }
      __syncthreads();
    }
    const long long r0 = tile * rows;
#pragma unroll
    for (int j = 0; j < kKPerThread; ++j) {
      const int k = threadIdx.x + j * kDiagThreads;
      if (k < K) {
        const int rm = s_rm[k];
        const int cm = s_cm[k];
        float sum = 0.f;
        for (int q = 0; q < rows && r0 + q < R; ++q) {
          const float u = s_u[q * C + cm];
          sum += (__popc((int)(r0 + q) & rm) & 1) ? -u : u;
        }
        acc[j] += sum;
      }
    }
    __syncthreads();  // s_w and s_u are the next tile's
  }
#pragma unroll
  for (int j = 0; j < kKPerThread; ++j) {
    const int k = threadIdx.x + j * kDiagThreads;
    if (k < K) partial[(long long)blockIdx.x * K + k] = acc[j];
  }
}

// out[i] = sum_b partial[b, i] for i in [0, width): one warp an output, its
// lanes over the blocks, then a butterfly of shuffles -- a fixed order for
// a fixed number of blocks.
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    int blocks, int width,
                                    float* __restrict__ out) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = (int)threadIdx.x % 32;
  if (i >= width) return;  // whole warps: blockDim.x is a multiple of 32
  float s = 0.f;
  for (int b = lane; b < blocks; b += 32) {
    s += partial[(long long)b * width + i];
  }
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) out[i] = s;
}

// ---------------------------------------------------------------------------
// The flip class: out[x] = alpha[c(x)] s[x] + beta[c(x)] sigma(x) s[x ^ f]
// ---------------------------------------------------------------------------
//
// On the flat amplitude index x of an n-qubit state (qubit q is bit
// n-1-q), f the flip mask, c(x) = (x & ctrl) != 0 and sigma(x) =
// (-1)^popcount(x & z).  One gate (or its inverse, or its derivative) is
// one record: the masks and alpha[2], beta[2] (hopper_sv.flip_record).
// Each thread owns amplitude pairs {x, x ^ f}, enumerated as pair index p
// with a 0 inserted at f's top bit, in a grid-stride loop over the batch's
// B * 2^(n-1) pairs: it reads both amplitudes and writes both, so the
// update is in place.  Neighbouring threads own neighbouring x, and x ^ f
// moves a warp's addresses by the same mask, so both loads coalesce.
//
// Bound: device memory -- 16 bytes read and written per amplitude of each
// state for ~10 flop (flip_apply); flip_bilinear reads and writes a and
// lambda, twice the bytes, and sums 2 Re conj(lam) dU a_before per block
// in a fixed order (per-block partials, then sum_partials_kernel).
// States of 1 to 30 qubits: an in-state index fits an int.
constexpr int kFlipThreads = 256;
constexpr size_t kFlipSmem = kFlipThreads / 32 * sizeof(float);

struct FlipMasks {
  int f;     // flip mask
  int ctrl;  // control mask; 0 for none
  int z;     // sign mask
  int top;   // the position of f's highest bit
};

// alpha[c] = (ar[c], ai[c]), beta[c] = (br[c], bi[c]).
struct FlipCoeffs {
  float ar[2], ai[2], br[2], bi[2];
};

// x of pair index p: p with a 0 inserted at bit `top`; its partner is
// x ^ f.
__device__ __forceinline__ int flip_pair(int p, int top) {
  return ((p >> top) << (top + 1)) | (p & ((1 << top) - 1));
}

__device__ __forceinline__ float flip_sign(int x, int z) {
  return (__popc((unsigned)(x & z)) & 1) ? -1.f : 1.f;
}

// (x, y) <- (alpha s_x + beta sx s_y, alpha s_y + beta sy s_x) for the
// pair's record entry c.
__device__ __forceinline__ void flip_update(float& xr, float& xi, float& yr,
                                            float& yi, const FlipCoeffs& k,
                                            int c, float sx, float sy) {
  const float ar = k.ar[c], ai = k.ai[c];
  const float bxr = k.br[c] * sx, bxi = k.bi[c] * sx;
  const float byr = k.br[c] * sy, byi = k.bi[c] * sy;
  const float oxr = ar * xr - ai * xi + bxr * yr - bxi * yi;
  const float oxi = ar * xi + ai * xr + bxr * yi + bxi * yr;
  const float oyr = ar * yr - ai * yi + byr * xr - byi * xi;
  const float oyi = ar * yi + ai * yr + byr * xi + byi * xr;
  xr = oxr;
  xi = oxi;
  yr = oyr;
  yi = oyi;
}

// flip_apply: one record on one (kTwo false) or two [B, 2^n] state batches,
// in place.
template <bool kTwo>
__global__ void __launch_bounds__(kFlipThreads)
    flip_apply_kernel(float* __restrict__ re0, float* __restrict__ im0,
                      float* __restrict__ re1, float* __restrict__ im1,
                      int B, int n, FlipMasks m, FlipCoeffs k) {
  const int half = 1 << (n - 1);
  const long long total = (long long)B * half;
  for (long long j = (long long)blockIdx.x * kFlipThreads + threadIdx.x;
       j < total; j += (long long)gridDim.x * kFlipThreads) {
    const long long base = (j >> (n - 1)) << n;
    const int x = flip_pair((int)(j & (half - 1)), m.top);
    const int y = x ^ m.f;
    const int c = (x & m.ctrl) != 0;
    const float sx = flip_sign(x, m.z);
    const float sy = flip_sign(y, m.z);
    float xr = re0[base + x], xi = im0[base + x];
    float yr = re0[base + y], yi = im0[base + y];
    flip_update(xr, xi, yr, yi, k, c, sx, sy);
    re0[base + x] = xr;
    im0[base + x] = xi;
    re0[base + y] = yr;
    im0[base + y] = yi;
    if (kTwo) {
      xr = re1[base + x];
      xi = im1[base + x];
      yr = re1[base + y];
      yi = im1[base + y];
      flip_update(xr, xi, yr, yi, k, c, sx, sy);
      re1[base + x] = xr;
      im1[base + x] = xi;
      re1[base + y] = yr;
      im1[base + y] = yi;
    }
  }
}

// flip_bilinear: a <- U^-1 a and lambda <- U^-1 lambda in place (`inv`),
// and this block's partial of 2 Re sum_b sum_x conj(lam[b, x]) (dU
// a_before)[b, x] (`d` the record of dU) in partial[blockIdx.x]: each
// thread sums its pairs in registers, the block its warps' sums in a fixed
// order.
__global__ void __launch_bounds__(kFlipThreads)
    flip_bilinear_kernel(float* __restrict__ l_re, float* __restrict__ l_im,
                         float* __restrict__ a_re, float* __restrict__ a_im,
                         int B, int n, FlipMasks m, FlipCoeffs inv,
                         FlipCoeffs d, float* __restrict__ partial) {
  extern __shared__ float smem[];  // kFlipSmem bytes: the warps' sums
  const int half = 1 << (n - 1);
  const long long total = (long long)B * half;
  float acc = 0.f;
  for (long long j = (long long)blockIdx.x * kFlipThreads + threadIdx.x;
       j < total; j += (long long)gridDim.x * kFlipThreads) {
    const long long base = (j >> (n - 1)) << n;
    const int x = flip_pair((int)(j & (half - 1)), m.top);
    const int y = x ^ m.f;
    const int c = (x & m.ctrl) != 0;
    const float sx = flip_sign(x, m.z);
    const float sy = flip_sign(y, m.z);
    float axr = a_re[base + x], axi = a_im[base + x];
    float ayr = a_re[base + y], ayi = a_im[base + y];
    float lxr = l_re[base + x], lxi = l_im[base + x];
    float lyr = l_re[base + y], lyi = l_im[base + y];
    flip_update(axr, axi, ayr, ayi, inv, c, sx, sy);  // a_before
    float dxr = axr, dxi = axi, dyr = ayr, dyi = ayi;
    flip_update(dxr, dxi, dyr, dyi, d, c, sx, sy);  // dU a_before
    acc += lxr * dxr + lxi * dxi + lyr * dyr + lyi * dyi;
    flip_update(lxr, lxi, lyr, lyi, inv, c, sx, sy);
    a_re[base + x] = axr;
    a_im[base + x] = axi;
    a_re[base + y] = ayr;
    a_im[base + y] = ayi;
    l_re[base + x] = lxr;
    l_im[base + x] = lxi;
    l_re[base + y] = lyr;
    l_im[base + y] = lyi;
  }
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (threadIdx.x % 32 == 0) smem[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.f;
    for (int w = 0; w < kFlipThreads / 32; ++w) sum += smem[w];
    partial[blockIdx.x] = 2.f * sum;
  }
}

// parity_bilinear_rows: the bilinears of K2's kBilin stage (the
// cooperative sweep of one state), bilin[k] = sum_{b,r,c} s(r & rm_k)
// s(c & cm_k) (l_re*a_im - l_im*a_re)[b, r, c].  This block's partial
// bilinears over rows first_block * rows_per, ... with THREADS threads;
// out[K].  The block stages the batch-summed P of a few rows in shared
// memory (coalesced along columns), then thread k folds those rows into
// its factor's sum with signs from __popc.  `w` holds THREADS floats,
// s_rm / s_cm kBilinMaxK ints each.  Starts and ends with a block
// barrier.
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
// Bound: a slab of N1 * N2 * W <= 2^14 amplitudes (128 KB as two planes) is
// read once, both contractions run on it in shared memory, and it is
// written once -- one state pass for two operators.  The work is
// 8 * (N1 + N2) flop per amplitude, 2048 at N1 = N2 = 128 against 16 bytes:
// far past the ridge of fp32 on the CUDA cores, where the FMA version of
// this kernel sat at 37% of 67 TFLOP/s.  So the contractions run on the
// tensor cores in 3xTF32.  Split rule: each fp32 operand x becomes, in
// registers, big = tf32(x) and small = tf32(x - big), both rounded as
// cvt.rna.tf32.f32 rounds (to nearest, ties away from zero; `tf32_rna`), and
// a real product is small*big + big*small + big*big in fp32.  The dropped
// small*small term and the rounding of small cost ~2^-22 relative, fp32's
// level, where one TF32 product (2^-11) would break the 1e-5 gate.  A
// complex product is four real ones on the re/im planes (with -Im(S) for the
// real part), not the 3-multiply form, whose cancellation the gate does not
// allow: 12 mma.sync.m16n8k8 a k-step of 8.  Three TF32 products per fp32
// product at the H100's 495 TFLOP/s dense make fp32-accurate 165 TFLOP/s, so
// the bound is max(bytes / 3.35 TB/s, 3 * flops / 495 TFLOP/s): the
// operations at every main-path shape.
//
// Work split: for an operator with N >= 16 a contraction is the GEMM
// Y[N, cols] = Op[N, N] S[N, cols] over the slab, in chunks of kChunk
// columns.  The 8 warps of the 256-thread block tile the [N, kChunk]
// output in warp tiles of kAxis2WarpRows x kAxis2WarpCols: at N = 128, 4 x 2
// warps of 32 x 32 (2 x 4 m16n8 tiles, 64 fp32 accumulators a thread, up to
// 255 registers), chunks of 64 columns.  (16 warps of 32 x 16, or 8 of
// 32 x 64 or 64 x 32, ran slower on the H100: PERF.md.)  The operator is the
// MMA's A: it streams through shared memory in [N, 32] panels that cp.async
// copies into a double buffer, so one panel's copy overlaps the previous
// panel's MMAs, and the next contraction's first panel is copied during
// this one's last (each contraction copying its own first panel as it
// starts ran 3% slower at 24q on the H100: PERF.md).  The operator is split per fragment as it is loaded, not
// once per panel: pre-split panels would take twice the shared memory, which
// the slab does not leave.  The results go back into the slab in place once
// a block barrier shows that every warp has read its inputs.  N < 16 (the
// 24q pass 2's N2 = 8, 8/128 of that pass's flops) keeps fp32 FMAs: one
// thread a column, the operator read from its staged panel as broadcasts.
//
// Shared memory: the slab, 2 x 2^14 floats = 128 KB, and two panel buffers
// of 2 planes x [128, 36] floats = 72 KB: 200 KB of 227 KB, one block per
// SM.  The slab is the MMA's B along two axes: element k of a column at
// stride L (the N1 contraction) or at stride 1 (the N2 one at W = 1).  Row i
// stores r at i * L + (r ^ swizzle(i)), an XOR of bits 2-4 under which both
// fragment loads are free of bank conflicts (`slab_at`); panel rows are
// padded to 36 floats for the same reason.  The slab comes in by cp.async
// (16-byte runs) where the view allows.
constexpr int kLogSlab = 14;  // log2 of the amplitudes per slab
constexpr int kAxis2Threads = 256;
constexpr int kAxis2WarpRows = 32;  // a warp's output tile (N >= 32)
constexpr int kAxis2WarpCols = 32;
constexpr int kPanel = 32;      // operator columns (k) staged per panel
constexpr int kPanelLd = kPanel + 4;          // padded panel row

// A block that runs slab contractions (slab_mma_apply): its threads, its
// warp tiles' width, and where the operator comes from.  Streamed
// (RESIDENT false): [ROWS, kPanel] panels of the operator copied by
// cp.async into two buffers of a re and an im plane, rows kPanelLd floats
// apart: four planes of kPlane floats.  Resident: the whole [ROWS, ROWS]
// operator, rows ROWS + 4 apart, split once into four TF32 planes (big re,
// small re, big im, small im; PRESPLIT), or as its re and im fp32 planes,
// split as each fragment is loaded.
template <int THREADS, int ROWS, int WARP_COLS, bool RESIDENT,
          bool PRESPLIT = RESIDENT>
struct SlabBlock {
  static constexpr int kThreads = THREADS;
  static constexpr int kWarpCols = WARP_COLS;
  static constexpr bool kResident = RESIDENT;
  static constexpr bool kPresplit = PRESPLIT;
  static constexpr int kLd = RESIDENT ? ROWS + 4 : kPanelLd;
  static constexpr int kPlane = ROWS * kLd;
  static constexpr size_t kPanelSmem =
      (RESIDENT && !PRESPLIT ? 2 : 4) * kPlane * sizeof(float);
};
using Axis2Block = SlabBlock<kAxis2Threads, 128, kAxis2WarpCols, false>;

// Bits 2-4 of slab row i's XOR: i's bits 0 and 1 to bits 3 and 4, bit 2
// kept.  The N1 contraction's fragment (thread g, t: column g, element t)
// then spans 32 banks as g + 8t, the N2 one's (column g, element t) as
// 4 * perm(g) + t.
__device__ __forceinline__ int slab_swizzle(int i) {
  return ((i << 3) & 24) | (i & 4);
}

// Offset of element k of column c in the slab [N1, L = N2 * W]: row i,
// r = j * W + w at i * L + (r ^ slab_swizzle(i)).  AXIS 1 (A on N1): column
// c = r, element k = i.  AXIS 2 (B on N2): column c = i * W + w, element
// k = j.  L is a power of two; the XOR stays inside the row.
template <int AXIS>
__device__ __forceinline__ int slab_at(int k, int c, int L, int log_w) {
  if constexpr (AXIS == 1) {
    return k * L + (c ^ (slab_swizzle(k) & (L - 1)));
  } else {
    const int i = c >> log_w;
    const int r = (k << log_w) | (c & ((1 << log_w) - 1));
    return i * L + (r ^ (slab_swizzle(i) & (L - 1)));
  }
}

// slab_at<AXIS>(kb + e, c) for k-step bases kb (multiples of 8) and one
// element e < 8 of a fragment, split into a part fixed per (c, e) and a part
// that follows kb: AXIS 1, kb * L + off; AXIS 2, off + ((kb << log_w) ^ hi).
// Exact: kb's bits and e's sit in disjoint bit ranges, and the XOR acts on
// each range apart.
template <int AXIS>
struct SlabColumn {
  int off[2];  // e = t, t + 4
  int hi;

  static __device__ __forceinline__ SlabColumn make(int t, int c, int L,
                                                    int log_w) {
    SlabColumn col;
    if constexpr (AXIS == 1) {
      col.off[0] = slab_at<1>(t, c, L, log_w);
      col.off[1] = slab_at<1>(t + 4, c, L, log_w);
      col.hi = 0;
    } else {
      const int i = c >> log_w;
      const int x = slab_swizzle(i) & (L - 1);
      const int lo_mask = (8 << log_w) - 1;  // bits of e * W + w
      const int w = c & ((1 << log_w) - 1);
      col.off[0] = i * L + (((t << log_w) | w) ^ (x & lo_mask));
      col.off[1] = i * L + ((((t + 4) << log_w) | w) ^ (x & lo_mask));
      col.hi = x & ~lo_mask;
    }
    return col;
  }

  __device__ __forceinline__ int at(int kb, int h, int L, int log_w) const {
    if constexpr (AXIS == 1) {
      return kb * L + off[h];
    } else {
      return off[h] + ((kb << log_w) ^ hi);
    }
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for every committed copy group but the newest.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Waits for every committed copy group.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Starts copying columns [p0, p0 + width) of the split-complex [N, N]
// operator (N = 2^log_n; width = min(N, kPanel)) into a panel buffer of
// Block: the re plane, then the im plane Block::kPlane floats on, rows
// kPanelLd floats apart.  16-byte copies where both planes are 16-byte
// aligned, else 4-byte ones.  One body for every N (shifts, no N
// template): a call per panel inside the MMA loop stays inline.
template <class Block = Axis2Block>
__device__ __forceinline__ void issue_panel(const float* op_re,
                                            const float* op_im, int log_n,
                                            int p0, float* dst) {
  const int log_width = log_n < 5 ? log_n : 5;  // kPanel = 2^5
  const bool vec = log_width >= 2 &&
                   ((reinterpret_cast<unsigned long long>(op_re) |
                     reinterpret_cast<unsigned long long>(op_im)) &
                    15) == 0;
  const int log_run = vec ? 2 : 0;         // floats a copy
  const int log_row = log_width - log_run;  // copies a row
  const int copies = 2 << (log_n + log_row);
  for (int e = threadIdx.x; e < copies; e += Block::kThreads) {
    const int plane = e >> (log_n + log_row);
    const int rem = e & ((1 << (log_n + log_row)) - 1);
    const int m = rem >> log_row;
    const int j = (rem & ((1 << log_row) - 1)) << log_run;
    float* d = dst + plane * Block::kPlane + m * Block::kLd + j;
    const float* src = (plane ? op_im : op_re) + (m << log_n) + p0 + j;
    if (vec) {
      cp_async_16(d, src);
    } else {
      cp_async_4(d, src);
    }
  }
}

// What slab_mma_apply calls before each step's cp.async commit (step, of
// steps): nothing, for K1.
struct NoHook {
  __device__ __forceinline__ void operator()(int, int) const {}
};

// The operator whose first panel a contraction copies during its last one
// (k = log2 N; 0: none).
struct NextOp {
  int k;
  const float* re;
  const float* im;
};

template <class Block = Axis2Block>
__device__ __forceinline__ void issue_next(NextOp next, float* dst) {
  if (next.k > 0) issue_panel<Block>(next.re, next.im, next.k, 0, dst);
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

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero), low 13 bits cleared: half a TF32 ulp added to the magnitude
// bits, then truncated.  Equal to cvt.rna for every finite x; with cvt the
// kernel ran 13% slower on the H100 (32 x 16 warp tiles, PERF.md).
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x -> (big, small) TF32 parts: big = tf32(x), small = tf32(x - big).
__device__ __forceinline__ void split_tf32(float x, unsigned& big,
                                           unsigned& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// d += a b on one m16n8k8 tile: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); b0 (k = t, n = g), b1 (t + 4, g); d0 (g, 2t),
// d1 (g, 2t + 1), d2 (g + 8, 2t), d3 (g + 8, 2t + 1), for lane 4g + t.
__device__ __forceinline__ void mma_tf32(float* d, const unsigned* a,
                                         const unsigned* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b (a zero accumulator).
__device__ __forceinline__ void mma_tf32_first(float* d, const unsigned* a,
                                               const unsigned* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// In place on the slab, N >= 16: every column v of `cols` is replaced by
// Op v on the tensor cores (3xTF32).  Streamed (K1): on entry the
// operator's first panel is in flight in panel buffer `buf`; on exit
// `next`'s first panel is, in the buffer returned.  Resident (K4's
// axis_apply at N <= 64, the sweep's axis stages): the operator is in
// `panels`, nothing is copied or waited for, `buf` is returned as it
// came.  `hook(step, steps)` runs before each panel step's commit
// (streamed) or each chunk's (resident), to put more copies in that group.
// Each k-step of 8 is summed in fresh registers, the small cross terms
// first, and added to the fp32 totals with round-to-nearest adds: the
// tensor cores truncate as they accumulate, and one accumulator over all
// 16 k-steps (96 MMAs) was 3.4e-6 off the plain version a pass on the
// H100, a shrink of the norm that adds up over a circuit's passes (fresh
// sums: 3.5e-7, below the FMA version's 4.6e-7).
template <int N, int AXIS, class Block = Axis2Block, class Hook = NoHook>
__device__ __forceinline__ int slab_mma_apply(float* s_re, float* s_im,
                                              const float* __restrict__ op_re,
                                              const float* __restrict__ op_im,
                                              int cols, int L, int log_w,
                                              float* panels, int buf,
                                              NextOp next, Hook hook = {}) {
  constexpr int kLogN = N == 16 ? 4 : N == 32 ? 5 : N == 64 ? 6 : 7;
  constexpr int kMT = (N < kAxis2WarpRows ? N : kAxis2WarpRows) / 16;
  constexpr int kNT = Block::kWarpCols / 8;
  constexpr int kWarpsM = N / (16 * kMT);
  constexpr int kWarpsN = Block::kThreads / 32 / kWarpsM;
  constexpr int kChunk = kWarpsN * kNT * 8;  // columns a block tile
  constexpr bool kResident = Block::kResident;
  constexpr int kWidth = kResident ? N : N < kPanel ? N : kPanel;
  constexpr int kPanels = N / kWidth;
  constexpr int kUnroll = kResident ? 1 : kWidth / 8;  // k-steps unrolled
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int warp = threadIdx.x >> 5;
  const int row0 = (warp % kWarpsM) * kMT * 16;
  const int chunks = (cols + kChunk - 1) / kChunk;
  for (int ch = 0; ch < chunks; ++ch) {
    const int col0 = ch * kChunk + (warp / kWarpsM) * kNT * 8;
    float acc[kMT][kNT][8];  // per tile: re d0..d3, then im d0..d3
    SlabColumn<AXIS> bcol[kNT];  // this lane's column c of each n-tile
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      bcol[nt] = SlabColumn<AXIS>::make(t, col0 + nt * 8 + g, L, log_w);
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[mt][nt][e] = 0.f;
      }
    }
#pragma unroll 1
    for (int p = 0; p < kPanels; ++p) {
      if constexpr (!kResident) {
        float* nxt = panels + (buf ^ 1) * 2 * Block::kPlane;
        if (p + 1 < kPanels) {
          issue_panel<Block>(op_re, op_im, kLogN, (p + 1) * kWidth, nxt);
        } else if (ch + 1 < chunks) {
          issue_panel<Block>(op_re, op_im, kLogN, 0, nxt);
        } else {
          issue_next<Block>(next, nxt);
        }
      }
      hook(ch * kPanels + p, chunks * kPanels);
      cp_async_commit();
      if constexpr (!kResident) {
        cp_async_wait_prior();
        __syncthreads();  // panel p has landed; earlier slab writes are seen
      }
      const float* pr = panels + buf * 2 * Block::kPlane;
      const float* pi = pr + Block::kPlane;
#pragma unroll (kUnroll)
      for (int ks = 0; ks < kWidth; ks += 8) {
        const int kb = p * kWidth + ks;  // the k-step's first element
        unsigned arb[kMT][4], ars[kMT][4], aib[kMT][4], ais[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const int a = (row0 + mt * 16 + g) * Block::kLd + ks + t;
          const int a_off[4] = {a, a + 8 * Block::kLd, a + 4,
                                a + 8 * Block::kLd + 4};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if constexpr (kResident && Block::kPresplit) {
              const unsigned* split = reinterpret_cast<const unsigned*>(panels);
              arb[mt][r] = split[a_off[r]];
              ars[mt][r] = split[Block::kPlane + a_off[r]];
              aib[mt][r] = split[2 * Block::kPlane + a_off[r]];
              ais[mt][r] = split[3 * Block::kPlane + a_off[r]];
            } else {
              split_tf32(pr[a_off[r]], arb[mt][r], ars[mt][r]);
              split_tf32(pi[a_off[r]], aib[mt][r], ais[mt][r]);
            }
          }
        }
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const int c = col0 + nt * 8 + g;
          unsigned brb[2], brs[2], bib[2], bis[2], nbb[2], nbs[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float xr = 0.f;
            float xi = 0.f;
            if (c < cols) {
              const int o = bcol[nt].at(kb, h, L, log_w);
              xr = s_re[o];
              xi = s_im[o];
            }
            split_tf32(xr, brb[h], brs[h]);
            split_tf32(xi, bib[h], bis[h]);
            nbb[h] = bib[h] ^ 0x80000000u;  // -Im(S), exactly
            nbs[h] = bis[h] ^ 0x80000000u;
          }
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            float d[8];
            // Re += A_re S_re - A_im S_im, Im += A_re S_im + A_im S_re:
            // the cross terms (small x big, big x small), then big x big.
            mma_tf32_first(d, ars[mt], brb);
            mma_tf32_first(d + 4, ars[mt], bib);
            mma_tf32(d, arb[mt], brs);
            mma_tf32(d + 4, arb[mt], bis);
            mma_tf32(d, ais[mt], nbb);
            mma_tf32(d + 4, ais[mt], brb);
            mma_tf32(d, aib[mt], nbs);
            mma_tf32(d + 4, aib[mt], brs);
            mma_tf32(d, arb[mt], brb);
            mma_tf32(d + 4, arb[mt], bib);
            mma_tf32(d, aib[mt], nbb);
            mma_tf32(d + 4, aib[mt], brb);
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[mt][nt][e] += d[e];
          }
        }
      }
      __syncthreads();  // panel p is read (the last: so are the columns)
      if constexpr (!kResident) buf ^= 1;
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = row0 + mt * 16 + g + 8 * (e >> 1);
          const int c = col0 + nt * 8 + 2 * t + (e & 1);
          if (c < cols) {
            const int o = slab_at<AXIS>(m, c, L, log_w);
            s_re[o] = acc[mt][nt][e];
            s_im[o] = acc[mt][nt][4 + e];
          }
        }
      }
    }
  }
  return buf;
}

// In place on the slab, N < 16, in fp32 FMAs: a thread replaces whole
// columns v by Op v, the operator (one panel) read as broadcasts.  Panel
// buffers as in slab_mma_apply.
template <int N, int AXIS>
__device__ __forceinline__ int slab_fma_apply(float* s_re, float* s_im,
                                              int cols, int L, int log_w,
                                              float* panels, int buf,
                                              NextOp next) {
  issue_next(next, panels + (buf ^ 1) * 2 * Axis2Block::kPlane);
  cp_async_commit();
  cp_async_wait_prior();
  __syncthreads();  // the operator has landed; earlier slab writes are seen
  const float* pr = panels + buf * 2 * Axis2Block::kPlane;
  const float* pi = pr + Axis2Block::kPlane;
  for (int c = threadIdx.x; c < cols; c += kAxis2Threads) {
    float xr[N], xi[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int o = slab_at<AXIS>(k, c, L, log_w);
      xr[k] = s_re[o];
      xi[k] = s_im[o];
    }
#pragma unroll
    for (int m = 0; m < N; ++m) {
      float yr = 0.f;
      float yi = 0.f;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float wr = pr[m * kPanelLd + k];
        const float wi = pi[m * kPanelLd + k];
        yr = fmaf(wr, xr[k], fmaf(-wi, xi[k], yr));
        yi = fmaf(wr, xi[k], fmaf(wi, xr[k], yi));
      }
      const int o = slab_at<AXIS>(m, c, L, log_w);
      s_re[o] = yr;
      s_im[o] = yi;
    }
  }
  __syncthreads();  // the panel is read
  return buf ^ 1;
}

// The contraction of an [N, N] operator on axis AXIS of the slab.
// Returns the panel buffer that holds `next`'s first panel.
template <int AXIS>
struct SlabApply {
  template <int N>
  static __device__ __forceinline__ int run(float* s_re, float* s_im,
                                            const float* op_re,
                                            const float* op_im, int cols,
                                            int L, int log_w, float* panels,
                                            int buf, NextOp next) {
    if constexpr (N >= 16) {
      return slab_mma_apply<N, AXIS>(s_re, s_im, op_re, op_im, cols, L,
                                     log_w, panels, buf, next);
    } else {
      return slab_fma_apply<N, AXIS>(s_re, s_im, cols, L, log_w, panels, buf,
                                     next);
    }
  }
};

// One persistent block walks slabs blockIdx.x, + gridDim.x, ...: each is
// [N1, L = N2 * W] amplitudes at one (p, m, q-tile), read, A applied on N1,
// B on N2, written.  Operator panels stream across slabs: A's first panel is
// copied before the first slab, B's during A's last panel, the next slab's
// A's during B's last.
__global__ void __launch_bounds__(kAxis2Threads)
    axis2_apply_kernel(const float* __restrict__ x_re,
                       const float* __restrict__ x_im,
                       const float* __restrict__ a_re,
                       const float* __restrict__ a_im,
                       const float* __restrict__ b_re,
                       const float* __restrict__ b_im,
                       float* __restrict__ y_re, float* __restrict__ y_im,
                       long long P, int k1, int M, int k2, int Q, int log_w) {
  extern __shared__ float smem[];
  const int n1 = 1 << k1;
  const int log_l = k2 + log_w;
  const int L = 1 << log_l;  // slab row: (j, w) pairs
  float* s_re = smem;
  float* s_im = smem + n1 * L;
  float* panels = s_im + n1 * L;  // 16-byte aligned: n1 * L >= 4
  const long long q_tiles = Q >> log_w;
  const long long slabs = P * M * q_tiles;
  const long long i_stride = (long long)M * (1 << k2) * Q;
  // Runs of 4 floats of a slab row are 16 contiguous, aligned bytes of the
  // state (the XOR keeps bits 0-1): cp.async them in and store float4s.
  const bool vec = L % 4 == 0 && ((1 << log_w) >= 4 || (1 << log_w) == Q) &&
                   ((reinterpret_cast<unsigned long long>(x_re) |
                     reinterpret_cast<unsigned long long>(x_im) |
                     reinterpret_cast<unsigned long long>(y_re) |
                     reinterpret_cast<unsigned long long>(y_im)) &
                    15) == 0;
  const int step = vec ? 4 : 1;
  int buf = 0;
  if (blockIdx.x < slabs) {
    issue_panel(a_re, a_im, k1, 0, panels);
    cp_async_commit();
  }
  for (long long slab = blockIdx.x; slab < slabs; slab += gridDim.x) {
    const long long pm = slab / q_tiles;
    const long long q0 = (slab - pm * q_tiles) << log_w;
    const long long p = pm / M;
    const long long m = pm - p * M;
    const long long base = p * n1 * i_stride + m * ((long long)Q << k2) + q0;
    // Element e = i * L + (j * W + w) of the slab: its offset in the
    // state and in the slab.
    auto state_at = [&](int e) {
      return base + (e >> log_l) * i_stride +
             (long long)((e & (L - 1)) >> log_w) * Q + (e & ((1 << log_w) - 1));
    };
    auto slab_of = [&](int e) {
      return slab_at<1>(e >> log_l, e & (L - 1), L, log_w);
    };
    __syncthreads();  // the previous slab is fully stored
    for (int e = threadIdx.x * step; e < n1 << log_l;
         e += kAxis2Threads * step) {
      const long long off = state_at(e);
      const int s = slab_of(e);
      if (vec) {
        cp_async_16(s_re + s, x_re + off);
        cp_async_16(s_im + s, x_im + off);
      } else {
        s_re[s] = x_re[off];
        s_im[s] = x_im[off];
      }
    }
    cp_async_commit();  // the first contraction waits for it
    const NextOp op_b = {k2, b_re, b_im};
    const NextOp op_a = {slab + gridDim.x < slabs ? k1 : 0, a_re, a_im};
    // A on the N1 axis: columns are the L (j, w) pairs.
    QHBM_LOG2_SWITCH(k1, buf = SlabApply<1>::run, s_re, s_im, a_re, a_im, L,
                     L, log_w, panels, buf, op_b)
    // B on the N2 axis: columns are the N1 * W (i, w) pairs.
    QHBM_LOG2_SWITCH(k2, buf = SlabApply<2>::run, s_re, s_im, b_re, b_im,
                     n1 << log_w, L, log_w, panels, buf, op_a)
    __syncthreads();  // every column is written back
    for (int e = threadIdx.x * step; e < n1 << log_l;
         e += kAxis2Threads * step) {
      const long long off = state_at(e);
      const int s = slab_of(e);
      if (vec) {
        *reinterpret_cast<float4*>(y_re + off) =
            *reinterpret_cast<const float4*>(s_re + s);
        *reinterpret_cast<float4*>(y_im + off) =
            *reinterpret_cast<const float4*>(s_im + s);
      } else {
        y_re[off] = s_re[s];
        y_im[off] = s_im[s];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// axis2_wgmma: axis2_apply on warpgroup MMA, for the main paths' views
// ---------------------------------------------------------------------------
//
// Replaces, as axis2_apply_kernel does, K1 (qhbmlib_tpu/ops/pallas_sv.py:615
// `fused_blocks_minor_apply`), on the views that every K1 pass of the 24q,
// 20q and 28q main paths has: N1 = 128 and a slab row of L = N2 * W = 128,
// with N2 = 128 (both contractions here) or N2 <= 8 (the second one in fp32
// FMAs, as slab_fma_apply does).  hopper_sv.axis2_route picks the view by
// its shape; every other view keeps axis2_apply_kernel.
//
// Bound: as axis2_apply_kernel's, max(bytes / 3.35 TB/s,
// 3 * flops / 495 TFLOP/s): at these shapes the operations, 2048 flop an
// amplitude against 16 bytes at N1 = N2 = 128.  axis2_apply_kernel's legacy
// mma.sync.m16n8k8 reached 29% of it (PERF.md); `wgmma` is the only way to
// the tensor cores' full rate on Hopper.
//
// Why the operator is wgmma's B: a contraction Y = Op S over slab columns is
// written Y^T = S^T Op^T, M = 64 slab columns a warpgroup, N = the operator's
// rows, K the contracted axis.  wgmma reads B only from shared memory and,
// for .tf32, only K-major, which Op^T K-major is: the operator row-major.
// One of a slab's two contractions is always strided along K, so the slab
// cannot be B; it is A, in registers, each fragment loaded from the swizzled
// slab (slab_at, conflict-free as for axis2_apply_kernel's B) and split into
// TF32 big / small there.  -Im(S) is A with wgmma's scale-a of -1.
//
// The operator is split once a call (wgmma_presplit_kernel, one launch
// before the main one) into four TF32 planes (big re, small re, big im,
// small im; the tf32_rna rule) laid out as the shared-memory image of each
// K-panel of 16: core matrices of 8 rows x 16 bytes, 128 bytes apart along N
// (SBO), 2048 along K (LBO), no swizzle (a core matrix is one contiguous
// 128-byte line, so B reads are free of bank conflicts).  A panel, 32 KB,
// is one cp.async.bulk copy completing on an mbarrier; a ring of kWgStages
// panels runs across both contractions and across slabs.  The warp whose
// release of a panel is the last (a shared counter) refills its stage, so no
// thread waits for a free stage.
//
// Work split: 256 threads, two warpgroups of 64 slab columns each; warp w
// of a warpgroup holds columns 16w..16w+15 as A's rows and D's, so it reads
// and writes only its own columns and the in-place write back needs no
// barrier.  Block barriers stand only between the two contractions and
// after the second.  A slab's store and the next slab's read go together,
// 16 slab rows (a row panel) at a time: each thread refills (cp.async) the
// words it has just stored and arrives on the panel's mbarrier when its
// copies land.  The first contraction, whose k is the slab row, issues the
// panel kWgLead ahead of the one it is about to read and waits for that
// one's mbarrier, so the state's traffic runs under the tensor work.
// (With the whole slab read before the first contraction, 24q B=8 pass 2
// took 2.04 ms against 1.84 now, pass 1 2.79 against 2.76: PERF.md.)
//
// Shared memory: the slab, 2 x 2^14 floats = 128 KB; the ring, 3 x 32 KB;
// the small N2 <= 8 operator 512 B, eleven mbarriers and three counters:
// 229,988 of 232,448 bytes, one block per SM.
//
// Accumulation (as slab_mma_apply's): each k-step of 8 and each half of the
// operator's rows (N = 64 a wgmma) is summed in fresh registers, 12 wgmma
// m64n64k8 (the small cross terms first, then big x big: three TF32
// products a real product, four real products a complex one), and added to
// the fp32 totals (2 x 64 a thread) with round-to-nearest adds.  Measured
// on the H100 against the plain version: 3.537e-7 relative at 24q B=8 pass
// 1, 2.624e-7 pass 2, as axis2_apply_kernel to four digits.  Time there:
// 2.76 + 1.84 ms against the bound's 1.67 + 0.89 (55%; axis2_apply_kernel
// 5.40 + 3.15).  Groups of two k-steps ran the inner loop 18% faster but
// doubled the error (the emulated truncation model: 4.5e-7 against
// 2.0e-7), so a group stays one k-step.
constexpr int kWgThreads = 256;   // two warpgroups
constexpr int kWgN = 128;         // N1, and N2 on the wgmma route
constexpr int kWgStageK = 16;     // operator columns (K) a ring stage holds
constexpr int kWgStages = 3;
constexpr int kWgLead = 2;        // row panels the slab's read runs ahead
constexpr int kWgPanels = kWgN / kWgStageK;           // stages a contraction
constexpr int kWgPlane = kWgN * kWgStageK;            // floats a TF32 plane
constexpr int kWgStageFloats = 4 * kWgPlane;          // 32 KB
constexpr int kWgImageFloats = kWgPanels * kWgStageFloats;  // one operator
constexpr size_t kWgSmem =
    (2 * (1 << kLogSlab) + kWgStages * kWgStageFloats + 2 * 8 * 8) *
        sizeof(float) +
    (kWgStages + kWgPanels) * sizeof(unsigned long long) +
    kWgStages * sizeof(int);

// Float offset of operator element (n, k) in its image: panel k / 16, then
// plane (+ 0, 1, 2, 3 x kWgPlane), k-step (k / 8) % 2, K-chunk (k / 4) % 2,
// row group n / 8, row n % 8, k % 4.
__device__ __forceinline__ int wgmma_image_at(int n, int k) {
  return (k >> 4) * kWgStageFloats + ((k >> 3) & 1) * 1024 +
         ((k >> 2) & 1) * 512 + (n >> 3) * 32 + (n & 7) * 4 + (k & 3);
}

// The images of A (and of B after it, with two operators) from their fp32
// re / im planes, [128, 128] row-major: one thread an element.
__global__ void wgmma_presplit_kernel(const float* __restrict__ a_re,
                                      const float* __restrict__ a_im,
                                      const float* __restrict__ b_re,
                                      const float* __restrict__ b_im,
                                      float* __restrict__ image) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int op = idx / (kWgN * kWgN);
  const int e = idx - op * kWgN * kWgN;
  unsigned rb, rs, ib, is;
  split_tf32((op ? b_re : a_re)[e], rb, rs);
  split_tf32((op ? b_im : a_im)[e], ib, is);
  float* dst = image + op * kWgImageFloats + wgmma_image_at(e / kWgN, e % kWgN);
  dst[0] = __uint_as_float(rb);
  dst[kWgPlane] = __uint_as_float(rs);
  dst[2 * kWgPlane] = __uint_as_float(ib);
  dst[3 * kWgPlane] = __uint_as_float(is);
}

// A wgmma descriptor of the B operand at `p` in shared memory: no swizzle,
// K-major, core matrices 2048 bytes apart along K (LBO) and 128 along N
// (SBO).
__device__ __forceinline__ unsigned long long wgmma_desc(const void* p) {
  return (unsigned long long)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((unsigned long long)(2048 >> 4) << 16) |
         ((unsigned long long)(128 >> 4) << 32);
}

#define QHBM_D32(x)                                                          \
  "+f"(x[0]), "+f"(x[1]), "+f"(x[2]), "+f"(x[3]), "+f"(x[4]), "+f"(x[5]),   \
      "+f"(x[6]), "+f"(x[7]), "+f"(x[8]), "+f"(x[9]), "+f"(x[10]),          \
      "+f"(x[11]), "+f"(x[12]), "+f"(x[13]), "+f"(x[14]), "+f"(x[15]),      \
      "+f"(x[16]), "+f"(x[17]), "+f"(x[18]), "+f"(x[19]), "+f"(x[20]),      \
      "+f"(x[21]), "+f"(x[22]), "+f"(x[23]), "+f"(x[24]), "+f"(x[25]),      \
      "+f"(x[26]), "+f"(x[27]), "+f"(x[28]), "+f"(x[29]), "+f"(x[30]),      \
      "+f"(x[31])

// d (+)= (SA a) b on one warpgroup: wgmma.mma_async m64n64k8, f32 += tf32 x
// tf32.  a holds this warp's 16 of A's 64 rows: a0 (row g, k t), a1
// (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4), lane 4g + t; b is [K 8,
// N 64] behind `desc`; d[4j + e] is (row g + 8 (e >> 1), column 8j + 2t +
// (e & 1)).  scale_d 0 ignores d's old values.
template <int SA>
__device__ __forceinline__ void wgmma_tf32(float* d, const unsigned* a,
                                           unsigned long long desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, %38, 1;\n}\n"
      : QHBM_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d),
        "n"(SA));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving d's reads or writes across a wgmma.
__device__ __forceinline__ void wgmma_hold(float* d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// An mbarrier whose phases complete on `count` arrivals.
__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          int count) {
  asm volatile(
      "mbarrier.init.shared::cta.b64 [%0], %1;\n"
      "fence.mbarrier_init.release.cluster;\n" ::"r"(smem_addr(bar)),
      "r"(count)
      : "memory");
}

// One arrival on `bar` once this thread's cp.async copies so far have
// landed.
__device__ __forceinline__ void cp_async_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_addr(bar))
               : "memory");
}

// Copies `bytes` from global `src` to shared `dst` in one bulk copy that
// completes on `bar` (armed here for the bytes).
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%2], [%3], %1, [%0];\n" ::"r"(smem_addr(bar)),
      "r"(bytes), "r"(smem_addr(dst)), "l"(src)
      : "memory");
}

// Waits until the phase of `bar` of parity `parity` has completed; traps
// (a launch error, not a hung card) if it has not after ~2^26 polls.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          int parity) {
  for (int polls = 0;; ++polls) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == 1 << 26) __trap();
  }
}

// The ring of operator panels: panel q of this block's sequence (per slab,
// A's kWgPanels, then B's where N2 = 128) goes to stage q % kWgStages.
struct WgRing {
  float* stages;
  unsigned long long* full;
  int* released;  // warps done with each stage's panel
  const float* image;
  int per_slab;   // panels a slab
  long long total;  // panels this block consumes

  __device__ __forceinline__ void issue(long long q) const {
    const int s = (int)(q % kWgStages);
    const int in_slab = (int)(q % per_slab);
    bulk_copy(stages + s * kWgStageFloats,
              image + (in_slab / kWgPanels) * kWgImageFloats +
                  (in_slab % kWgPanels) * kWgStageFloats,
              kWgStageFloats * (int)sizeof(float), &full[s]);
  }

  // This warp is done with panel q; the last of the block's warps to be
  // refills its stage with panel q + kWgStages.
  __device__ __forceinline__ void release(long long q) const {
    const int s = (int)(q % kWgStages);
    if ((threadIdx.x & 31) == 0 &&
        atomicAdd(&released[s], 1) == kWgThreads / 32 - 1) {
      atomicExch(&released[s], 0);
      if (q + kWgStages < total) issue(q + kWgStages);
    }
    __syncwarp();
  }
};

// In place on the slab, N = 128 on axis AXIS, 128 columns: column v <- Op v
// on warpgroup MMA in 3xTF32, the operator's panels q, q + 1, ... from the
// ring (q advances past them).  With `rows` (AXIS 1, whose k is the slab
// row), slab rows 16p..16p+15 are waited for (the phase of parity
// `parity` of rows[p]) before panel p reads them, and hook(p) runs first.
template <int AXIS, class Hook = NoHook>
__device__ __forceinline__ void wgmma_contract(float* s_re, float* s_im,
                                               const WgRing& ring,
                                               long long& q, int L,
                                               int log_w,
                                               unsigned long long* rows,
                                               int parity, Hook hook = {}) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int c0 = (threadIdx.x >> 5) * 16 + g;  // A's rows g, g + 8
  const SlabColumn<AXIS> col0 = SlabColumn<AXIS>::make(t, c0, L, log_w);
  const SlabColumn<AXIS> col1 = SlabColumn<AXIS>::make(t, c0 + 8, L, log_w);
  float tot[2][2][32];  // [rows 0-63, 64-127][re, im][fragment]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int i = 0; i < 32; ++i) tot[h][0][i] = tot[h][1][i] = 0.f;
  }
#pragma unroll 1
  for (int p = 0; p < kWgPanels; ++p, ++q) {
    const int s = (int)(q % kWgStages);
    hook(p, kWgPanels);
    if (rows != nullptr) mbar_wait(&rows[p], parity);
    mbar_wait(&ring.full[s], (int)((q / kWgStages) & 1));
    __syncwarp();
    const float* stage = ring.stages + s * kWgStageFloats;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int kb = p * kWgStageK + ks * 8;
      const int o[4] = {col0.at(kb, 0, L, log_w), col1.at(kb, 0, L, log_w),
                        col0.at(kb, 1, L, log_w), col1.at(kb, 1, L, log_w)};
      unsigned rb[4], rs[4], ib[4], is[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        split_tf32(s_re[o[r]], rb[r], rs[r]);
        split_tf32(s_im[o[r]], ib[r], is[r]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* b = stage + ks * 1024 + h * 256;  // rows 64h..64h+63
        const unsigned long long d_rb = wgmma_desc(b);
        const unsigned long long d_rs = wgmma_desc(b + kWgPlane);
        const unsigned long long d_ib = wgmma_desc(b + 2 * kWgPlane);
        const unsigned long long d_is = wgmma_desc(b + 3 * kWgPlane);
        float fr[32], fi[32];
        wgmma_fence();
        // Re += S_re A_re - S_im A_im, Im += S_im A_re + S_re A_im: the
        // cross terms (small x big, big x small), then big x big.
        wgmma_tf32<1>(fr, rs, d_rb, 0);
        wgmma_tf32<1>(fi, is, d_rb, 0);
        wgmma_tf32<1>(fr, rb, d_rs, 1);
        wgmma_tf32<1>(fi, ib, d_rs, 1);
        wgmma_tf32<-1>(fr, is, d_ib, 1);
        wgmma_tf32<1>(fi, rs, d_ib, 1);
        wgmma_tf32<-1>(fr, ib, d_is, 1);
        wgmma_tf32<1>(fi, rb, d_is, 1);
        wgmma_tf32<1>(fr, rb, d_rb, 1);
        wgmma_tf32<1>(fi, ib, d_rb, 1);
        wgmma_tf32<-1>(fr, ib, d_ib, 1);
        wgmma_tf32<1>(fi, rb, d_ib, 1);
        wgmma_commit();
        wgmma_wait_all();
        wgmma_hold(fr);
        wgmma_hold(fi);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          tot[h][0][i] += fr[i];
          tot[h][1][i] += fi[i];
        }
      }
    }
    ring.release(q);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = c0 + 8 * ((i >> 1) & 1);
      const int m = 64 * h + 8 * (i >> 2) + 2 * t + (i & 1);
      const int o = slab_at<AXIS>(m, c, L, log_w);
      s_re[o] = tot[h][0][i];
      s_im[o] = tot[h][1][i];
    }
  }
}

// In place on the slab, N < 16 on axis 2, in fp32 FMAs as slab_fma_apply:
// a thread replaces whole columns v by Op v; `op` holds the re then the im
// plane in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_fma_contract(float* s_re, float* s_im,
                                                   const float* op, int cols,
                                                   int L, int log_w) {
  float wr[N * N], wi[N * N];  // the operator, in registers
#pragma unroll
  for (int e = 0; e < N * N; ++e) {
    wr[e] = op[e];
    wi[e] = op[N * N + e];
  }
  for (int c = threadIdx.x; c < cols; c += kWgThreads) {
    float xr[N], xi[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int o = slab_at<2>(k, c, L, log_w);
      xr[k] = s_re[o];
      xi[k] = s_im[o];
    }
#pragma unroll
    for (int m = 0; m < N; ++m) {
      float yr = 0.f;
      float yi = 0.f;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        yr = fmaf(wr[m * N + k], xr[k], fmaf(-wi[m * N + k], xi[k], yr));
        yi = fmaf(wr[m * N + k], xi[k], fmaf(wi[m * N + k], xr[k], yi));
      }
      const int o = slab_at<2>(m, c, L, log_w);
      s_re[o] = yr;
      s_im[o] = yi;
    }
  }
}

// One persistent block walks slabs blockIdx.x, + gridDim.x, ... of the
// [P, 128, M, N2, Q] view: each [128, L = N2 * W = 128] slab is read, A
// applied on N1 (wgmma), B on N2 (wgmma at N2 = 128, FMAs below 16), and
// written while the next slab is read into the words already stored.  That
// read goes in slab row order, 16 rows an mbarrier (rows[p]), and A's
// contraction of the next slab starts on rows 0-15 while the rest land.
template <int N2>
__global__ void __launch_bounds__(kWgThreads, 1)
    axis2_wgmma_kernel(const float* __restrict__ x_re,
                       const float* __restrict__ x_im,
                       const float* __restrict__ image,
                       const float* __restrict__ b_re,
                       const float* __restrict__ b_im,
                       float* __restrict__ y_re, float* __restrict__ y_im,
                       long long P, int M, int Q, int log_w) {
  extern __shared__ float smem[];
  constexpr int kLogL = 7;  // log2 L: N2 * W = 128
  constexpr int L = 1 << kLogL;
  float* s_re = smem;
  float* s_im = smem + (1 << kLogSlab);
  float* stages = s_im + (1 << kLogSlab);
  float* small_op = stages + kWgStages * kWgStageFloats;
  auto* full = reinterpret_cast<unsigned long long*>(small_op + 2 * 8 * 8);
  unsigned long long* rows = full + kWgStages;
  int* released = reinterpret_cast<int*>(rows + kWgPanels);
  const long long q_tiles = Q >> log_w;
  const long long slabs = P * M * q_tiles;
  const long long i_stride = (long long)M * N2 * Q;
  const bool vec = ((1 << log_w) >= 4 || (1 << log_w) == Q) &&
                   ((reinterpret_cast<unsigned long long>(x_re) |
                     reinterpret_cast<unsigned long long>(x_im) |
                     reinterpret_cast<unsigned long long>(y_re) |
                     reinterpret_cast<unsigned long long>(y_im)) &
                    15) == 0;
  const int step = vec ? 4 : 1;
  // Iterations of the store / load loop a 16-row panel of the slab.
  const int per_panel = (kWgStageK << kLogL) / (kWgThreads * step);
  const int per_slab = (N2 == kWgN ? 2 : 1) * kWgPanels;
  const WgRing ring = {
      stages, full, released, image, per_slab,
      (slabs - blockIdx.x + gridDim.x - 1) / gridDim.x * per_slab};
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      released[s] = 0;
    }
    for (int p = 0; p < kWgPanels; ++p) mbar_init(&rows[p], kWgThreads);
  }
  if constexpr (N2 < 16) {
    for (int e = threadIdx.x; e < 2 * N2 * N2; e += kWgThreads) {
      small_op[e] = e < N2 * N2 ? b_re[e] : b_im[e - N2 * N2];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages && s < ring.total; ++s) ring.issue(s);
  }
  // Element e = i * L + (j * W + w) of slab `slab`: its offset in the
  // state, and in the slab.
  auto state_at = [&](long long slab, int e) {
    const long long pm = slab / q_tiles;
    const long long q0 = (slab - pm * q_tiles) << log_w;
    const long long p = pm / M;
    const long long m = pm - p * M;
    return p * kWgN * i_stride + m * ((long long)Q * N2) + q0 +
           (e >> kLogL) * i_stride +
           (long long)((e & (L - 1)) >> log_w) * Q + (e & ((1 << log_w) - 1));
  };
  auto slab_of = [&](int e) {
    return slab_at<1>(e >> kLogL, e & (L - 1), L, log_w);
  };
  // Row panel p (rows 16p..16p+15) of this thread's slab words: slab `cur`
  // stored from them where cur >= 0, then slab `next` read into them where
  // it exists, arriving on rows[p] once the copies land.
  auto store_load = [&](long long cur, long long next, int p) {
    for (int it = 0; it < per_panel; ++it) {
      const int e = ((p * per_panel + it) * kWgThreads + threadIdx.x) * step;
      const int s = slab_of(e);
      if (cur >= 0) {
        const long long off = state_at(cur, e);
        if (vec) {
          *reinterpret_cast<float4*>(y_re + off) =
              *reinterpret_cast<const float4*>(s_re + s);
          *reinterpret_cast<float4*>(y_im + off) =
              *reinterpret_cast<const float4*>(s_im + s);
        } else {
          y_re[off] = s_re[s];
          y_im[off] = s_im[s];
        }
      }
      if (next < slabs) {
        const long long off = state_at(next, e);
        if (vec) {
          cp_async_16(s_re + s, x_re + off);
          cp_async_16(s_im + s, x_im + off);
        } else {
          cp_async_4(s_re + s, x_re + off);
          cp_async_4(s_im + s, x_im + off);
        }
      }
    }
    if (next < slabs) cp_async_arrive(&rows[p]);
  };
  long long q = 0;
  int parity = 0;  // of this slab's phase of rows[]
  long long prev = -1;
  for (long long slab = blockIdx.x; slab < slabs;
       prev = slab, slab += gridDim.x, parity ^= 1) {
    // The previous slab's store and this one's read run kWgLead row panels
    // ahead of A's contraction, which waits for each panel's rows.  Once a
    // warp has waited for rows[7], every thread has stored the previous
    // slab, so the contraction's write back may follow.
    for (int p = 0; p < kWgLead; ++p) store_load(prev, slab, p);
    // A on the N1 axis: columns are the L (j, w) pairs.
    wgmma_contract<1>(s_re, s_im, ring, q, L, log_w, rows, parity,
                      [&](int p, int panels) {
                        if (p + kWgLead < panels) {
                          store_load(prev, slab, p + kWgLead);
                        }
                      });
    __syncthreads();  // every column of A's contraction is written back
    // B on the N2 axis: columns are the N1 * W (i, w) pairs.
    if constexpr (N2 == kWgN) {
      wgmma_contract<2>(s_re, s_im, ring, q, L, log_w, nullptr, 0);
    } else {
      wgmma_fma_contract<N2>(s_re, s_im, small_op, kWgN << log_w, L, log_w);
    }
    __syncthreads();  // every column is written back
  }
  for (int p = 0; p < kWgPanels; ++p) store_load(prev, slabs, p);
}

// ---------------------------------------------------------------------------
// axis_apply_mma: axis_apply for N >= 16, on the tensor cores
// ---------------------------------------------------------------------------
//
// Replaces, as axis_apply does for N < 16, the row-block and minor
// split-complex dots of K4 (qhbmlib_tpu/ops/pallas_sv.py:459
// `apply_circuit_pallas_batched`: `_apply_rowblock`, called from
// `_make_batched_kernel`) and K5's un-applies, for operators of N >= 16:
// at 20 qubits the row block (7,6) that hopper_sv.plan_passes leaves
// unpaired, in the forward and on both states of every un-apply.
//
// Bound: 8 * N flop per amplitude against 16 bytes, 512 at N = 64: past the
// fp32 ridge (~20 flop/B), where the FMA kernel was bound by operations.  In
// 3xTF32 on the tensor cores (K1's slab_mma_apply: the same split rule,
// fresh sums a k-step and swizzle) they take 3 * flops / 495 TFLOP/s, 0.21
// ms at the 20q step's shape against 0.32 ms of bytes: the bytes bound it,
// if the state stream does not stop while the tensor cores work, and if
// the contraction's own overheads shrink.  Hence (the design runs in
// PERF.md, section 6):
//   - two slab buffers: slab s + 1 is copied while slab s is contracted;
//   - for N <= 64 the operator is resident: split once a block into four
//     TF32 planes (68 KB at N = 64), no panel stream, no barrier inside a
//     chunk's k-loop and no split of A in the loop.  At N = 128 the split
//     operator would take 264 KB: it streams in panels as in K1, and the
//     next slab's copy goes out in parts, one a panel step (a copy issued
//     ahead of the panel groups would hold up their waits);
//   - 16 warps in 32 x 16 warp tiles, <= 128 registers a thread.
// A slab is 2^13 amplitudes, L = 2^13 / N consecutive columns c = p * Q + q
// of the [P, N, Q] view: a run of one p's q when Q >= L, whole p's when
// Q < L.  It comes in by cp.async in 16-byte runs and goes back as float4s,
// in one of K1's two layouts:
//   AXIS 1 (Q >= 4): row n holds the slab's L columns (the state's q-runs),
//     contracted at stride L;
//   AXIS 2 (Q = 1, 2; the minor operator at Q = 1): row i holds p0 + i's
//     N * Q floats as they lie in the state, contracted at stride Q.
// Shared memory: two slabs (128 KB) and the operator (68 KB resident at
// N = 64, 72 KB of panel buffers at N = 128): one block an SM.
//
// BUFS = 1 is the cooperative whole-circuit kernels' variant: one slab
// buffer and the operator resident at every N (at N = 128 as its two fp32
// planes, 132 KB, split per fragment), 196 KB at N = 128.  There a state
// of up to 20 qubits is at most 128 slabs, one a block on the H100's 132
// SMs, so a second buffer has no next slab to take, and the panel stream's
// waits and barriers went: 13-22% off an N = 128 stage (PERF.md, section 6).
constexpr int kAxisMmaThreads = 512;
constexpr int kAxisMmaWarpCols = 16;
constexpr int kLogAxisSlab = 13;  // amplitudes a slab

template <int N, int BUFS = 2>
struct AxisMma {
  static constexpr int kLogN = N == 16 ? 4 : N == 32 ? 5 : N == 64 ? 6 : 7;
  static constexpr int kLogL = kLogAxisSlab - kLogN;  // columns a slab
  using Block = SlabBlock<kAxisMmaThreads, N, kAxisMmaWarpCols,
                          BUFS == 1 || N <= 64, N <= 64>;
  static constexpr size_t kSmem =
      (2 * BUFS << kLogAxisSlab) * sizeof(float) + Block::kPanelSmem;
};

// The body of axis_apply_mma_kernel (BUFS = 2), shared with the cooperative
// whole-circuit kernels (BUFS = 1): this block takes slabs first,
// first + stride, ... of the view; `smem` holds AxisMma<N, BUFS>::kSmem
// bytes.  Ends with a block barrier, so `smem` may be reused after it.
template <int N, int AXIS, int BUFS = 2>
__device__ __forceinline__ void axis_mma_slabs(
    const float* __restrict__ x_re, const float* __restrict__ x_im,
    const float* __restrict__ op_re, const float* __restrict__ op_im,
    float* __restrict__ y_re, float* __restrict__ y_im, long long cols,
    int log_q, long long first, long long stride, float* smem) {
  using A = AxisMma<N, BUFS>;
  using Block = typename A::Block;
  constexpr int L = 1 << A::kLogL;
  constexpr int S = 1 << kLogAxisSlab;
  float* panels = smem + 2 * BUFS * S;  // after [BUFS][re, im][S] slabs
  // Floats a slab row: AXIS 1, the L columns of one n; AXIS 2, one p.
  const int log_row = AXIS == 1 ? A::kLogL : A::kLogN + log_q;
  const long long slabs = (cols + L - 1) >> A::kLogL;
  const bool vec = ((reinterpret_cast<unsigned long long>(x_re) |
                     reinterpret_cast<unsigned long long>(x_im) |
                     reinterpret_cast<unsigned long long>(y_re) |
                     reinterpret_cast<unsigned long long>(y_im)) &
                    15) == 0;
  const int step = vec ? 4 : 1;
  // Element e of slab `slab` (row e >> log_row): its valid columns, whether
  // e lies in one, its offset in the state (AXIS 1: e = n * L + c, column
  // col0 + c = p * Q + q at (p * N + n) * Q + q; AXIS 2: the slab is the
  // state's run from p0 * N * Q on) and in a slab buffer.
  auto valid_of = [&](long long slab) {
    const long long rest = cols - (slab << A::kLogL);
    return rest < L ? (int)rest : L;
  };
  auto in_view = [&](int e, int valid) {
    return AXIS == 1 ? (e & (L - 1)) < valid : e < valid << A::kLogN;
  };
  auto state_at = [&](long long slab, int e) -> long long {
    const long long col0 = slab << A::kLogL;
    if constexpr (AXIS == 1) {
      const long long col = col0 + (e & (L - 1));
      return ((((col >> log_q) << A::kLogN) + (e >> A::kLogL)) << log_q) |
             (col & ((1 << log_q) - 1));
    } else {
      return (col0 << A::kLogN) + e;
    }
  };
  auto slab_of = [&](int e) {
    return slab_at<1>(e >> log_row, e & ((1 << log_row) - 1), 1 << log_row,
                      0);
  };
  // Starts copying elements [e0, e1) of slab `slab` into slab buffer b.
  auto issue_slab = [&](long long slab, int b, int e0, int e1) {
    const int valid = valid_of(slab);
    float* d_re = smem + b * 2 * S;
    float* d_im = d_re + S;
    for (int e = e0 + threadIdx.x * step; e < e1;
         e += kAxisMmaThreads * step) {
      if (!in_view(e, valid)) continue;
      const long long off = state_at(slab, e);
      const int s = slab_of(e);
      if (vec) {
        cp_async_16(d_re + s, x_re + off);
        cp_async_16(d_im + s, x_im + off);
      } else {
        d_re[s] = x_re[off];
        d_im[s] = x_im[off];
      }
    }
  };
  if constexpr (Block::kResident) {
    unsigned* split = reinterpret_cast<unsigned*>(panels);
    for (int i = threadIdx.x; i < N * N; i += kAxisMmaThreads) {
      const int o = (i >> A::kLogN) * Block::kLd + (i & (N - 1));
      if constexpr (Block::kPresplit) {
        split_tf32(op_re[i], split[o], split[Block::kPlane + o]);
        split_tf32(op_im[i], split[2 * Block::kPlane + o],
                   split[3 * Block::kPlane + o]);
      } else {
        panels[o] = op_re[i];
        panels[Block::kPlane + o] = op_im[i];
      }
    }
  } else if (first < slabs) {
    issue_panel<Block>(op_re, op_im, A::kLogN, 0, panels);
  }
  if (first < slabs) {
    issue_slab(first, 0, 0, S);
    cp_async_commit();
  }
  int buf = 0;
  int cur = 0;  // the slab buffer of `slab`
  for (long long slab = first; slab < slabs;
       slab += stride, cur ^= BUFS - 1) {
    const long long nxt = slab + stride;
    cp_async_wait_all();
    __syncthreads();  // this slab has landed; the slab before is stored
    // With two buffers, the next slab's copy, in parts, one a step of the
    // contraction.
    auto hook = [&](int k, int steps) {
      if (BUFS == 2 && nxt < slabs) {
        issue_slab(nxt, cur ^ 1, S / 4 * k / steps * 4,
                   S / 4 * (k + 1) / steps * 4);
      }
    };
    const NextOp next = {nxt < slabs ? A::kLogN : 0, op_re, op_im};
    const int valid = valid_of(slab);
    float* s_re = smem + cur * 2 * S;
    float* s_im = s_re + S;
    buf = slab_mma_apply<N, AXIS, Block>(s_re, s_im, op_re, op_im, valid,
                                         1 << log_row, log_q, panels, buf,
                                         next, hook);
    __syncthreads();  // every column is written back
    for (int e = threadIdx.x * step; e < S; e += kAxisMmaThreads * step) {
      if (!in_view(e, valid)) continue;
      const long long off = state_at(slab, e);
      const int s = slab_of(e);
      if (vec) {
        *reinterpret_cast<float4*>(y_re + off) =
            *reinterpret_cast<const float4*>(s_re + s);
        *reinterpret_cast<float4*>(y_im + off) =
            *reinterpret_cast<const float4*>(s_im + s);
      } else {
        y_re[off] = s_re[s];
        y_im[off] = s_im[s];
      }
    }
    if (BUFS == 1 && nxt < slabs) {
      __syncthreads();  // the slab is stored; its buffer takes the next
      issue_slab(nxt, 0, 0, S);
      cp_async_commit();
    }
  }
  __syncthreads();  // every slab is stored; `smem` is free
}

template <int N, int AXIS>
__global__ void __launch_bounds__(kAxisMmaThreads)
    axis_apply_mma_kernel(const float* __restrict__ x_re,
                          const float* __restrict__ x_im,
                          const float* __restrict__ op_re,
                          const float* __restrict__ op_im,
                          float* __restrict__ y_re, float* __restrict__ y_im,
                          long long cols, int log_q) {
  extern __shared__ float smem[];
  axis_mma_slabs<N, AXIS>(x_re, x_im, op_re, op_im, y_re, y_im, cols, log_q,
                          blockIdx.x, gridDim.x, smem);
}

// ---------------------------------------------------------------------------
// qubit_transitions: T_q[i, j] = sum_{x: x_q = 0} conj(l[x ^ i e_q])
//                                 a[x ^ j e_q], summed over the batch
// ---------------------------------------------------------------------------
//
// Replaces the 1q-segment gradient reductions of K5
// (qhbmlib_tpu/ops/pallas_adjoint.py:540 `adjoint_sweep_batched`: the row
// block transitions and the minor kmat of `_make_bwd_kernel`'s "bwd1q"
// stage, which `_assemble_grads` reads only through the 2x2 partial trace of
// each gradient qubit).  Here the traces are the output, [Q, 2, 2] complex,
// not an [N, N] gram per row block.
//
// Bound: about 10 flop per amplitude and qubit (one conj(l) a product per
// amplitude for the diagonal; two complex multiply-adds per pair along the
// qubit's bit for the off-diagonals) against 16 bytes read per amplitude:
// at 24 qubits 240 flop against 16 B, below the fp32 ridge (~20 flop/B), so
// HBM reads bound it, and each pass reads every amplitude once.  A pair along
// bit b needs both amplitudes in one thread, and a tile of the state that
// holds every pair of its bits must span them: a tile is 2^T amplitudes
// (T <= kTransMaxBits = 13: 128 KB of the four planes) whose index bits
// are T bits of the state's index, the low `run` of them contiguous for
// coalesced copies.  Pass 1 tiles the lowest 13 bits (a contiguous 32 KB a
// plane); each later pass keeps `run` low bits (at least kTransMinRun) and
// takes up to 13 - run new ones (`plan_transitions`).  At 24 qubits two
// passes with run 2 (16-byte runs, half a 32-byte sector; the other half
// is the neighbouring tile, which the next block reads at the same time),
// at 20 qubits two passes with run 6.  Each qubit is computed in the pass
// where its bit is new.
//
// A tile streams through shared memory as two half-tiles, split at its top
// bit, in a ring of three half slots (192 KB, one block per SM): while half
// h is reduced, half h + 1 is in flight by cp.async, so the copy overlaps
// the arithmetic (a whole-tile buffer left no room for a second, and the
// two phases took turns).  Inside a half: each thread takes groups of 16
// amplitudes, four float4s (tile bits 0-1) at positions f, f ^ b1, f ^ b2,
// f ^ b1 ^ b2 of the tile's float4 index, and so holds every pair along
// tile bits 0, 1, j1 and j2 in registers.  A "layout" is one (j1, j2)
// choice; layouts cover a half's bits two at a time, each reading the half
// from shared memory once, and the last layout pairs the top bit across
// the tile's two halves, run when the second has landed (6 layouts at
// T = 13).  No layout holds two float4-index bits below 4, so the XOR
// swizzle of bits 0-2 by bit 3 (`trans_swizzle`) keeps every float4 load
// conflict-free.  Diagonals come from w = conj(l) a, formed
// once per amplitude in layout 0: T_q[1, 1] is the sum of w over x_q = 1
// (the "margin" of q's tile bit, `trans_margins`), T_q[0, 0] the total
// minus that; the other layouts do only the pair products.  The
// accumulators (T01 and T10 of 14 slots, 13 margins and the total: 84
// floats) stay in registers across tiles; at the end of a pass the
// block sums them through shared memory in thread order and writes one
// partial; transitions_finish_kernel sums the partials in block order.  No
// float atomics, so gradients are bitwise reproducible run to run.
constexpr int kTransThreads = 256;
constexpr int kTransMaxBits = 13;
constexpr int kTransMinRun = 2;  // low bits each pass after the first keeps
constexpr int kTransMaxPasses = 3;  // 13 + 11 + 11 bits cover 30
constexpr int kTransLayouts = (kTransMaxBits - 1) / 2;  // tile bits 2.. in 2s
constexpr int kTransSlots = 2 + 2 * kTransLayouts;
// A thread's accumulators, and a block's partial, in this order: T01 and
// T10 (re, im) of each slot; T11 (re, im) of each tile bit, the top bit's
// last (its "margin"); the total of w (re, im).
constexpr int kTransSlotFloats = 4;
constexpr int kTransMargins = kTransMaxBits;
constexpr int kTransTop = kTransMargins - 1;  // the top tile bit's margin
constexpr int kTransMarginAt = kTransSlots * kTransSlotFloats;
constexpr int kTransTotalAt = kTransMarginAt + 2 * kTransMargins;
constexpr int kTransPartial = kTransTotalAt + 2;
constexpr int kTransRedLd = kTransPartial + 1;  // odd: conflict-free rows
constexpr int kTransHeader = 128;  // ints of the offset tables (64 + 32)
constexpr int kTransMaxQubits = 32;
constexpr int kTransMaxStateBits = 30;

// One pass: its tile's bits and the layouts that cover them.
struct TransPass {
  int bits;                       // T: the tile holds 2^T amplitudes
  int tile_bit[kTransMaxBits];    // the state-index bit of each tile bit
  int rest;                       // the state's other n - T bits ...
  int rest_bit[kTransMaxStateBits];  // ... ascending: tile u's origin
  int layouts;
  int j1[kTransLayouts];          // float4-index bits (tile bit - 2) held
  int j2[kTransLayouts];          // in registers by each layout
  long long tiles;                // B * 2^rest
};

struct TransPlan {
  int n;
  int passes;
  TransPass pass[kTransMaxPasses];
};

// The qubits to write: each one's pass, slot and margin.
struct TransPick {
  int count;
  int pass[kTransMaxQubits];
  int slot[kTransMaxQubits];
  int margin[kTransMaxQubits];
};

// Shared-memory float4 index of tile float4 f: bits 0-2 XORed with bit 3.
__device__ __forceinline__ int trans_swizzle(int f) {
  return f ^ (((f >> 3) & 1) * 7);
}

// g with a zero bit inserted at bit p.
__device__ __forceinline__ int insert_zero(int g, int p) {
  return ((g >> p) << (p + 1)) | (g & ((1 << p) - 1));
}

// Adds the pair (x, y = x with the qubit's bit set) to a slot:
// T01 += conj(l_x) a_y, T10 += conj(l_y) a_x.
__device__ __forceinline__ void trans_pair(float* acc, const float* v, int x,
                                           int y) {
  const float lxr = v[x], lxi = v[16 + x], axr = v[32 + x], axi = v[48 + x];
  const float lyr = v[y], lyi = v[16 + y], ayr = v[32 + y], ayi = v[48 + y];
  acc[0] = fmaf(lxr, ayr, fmaf(lxi, ayi, acc[0]));
  acc[1] = fmaf(lxr, ayi, fmaf(-lxi, ayr, acc[1]));
  acc[2] = fmaf(lyr, axr, fmaf(lyi, axi, acc[2]));
  acc[3] = fmaf(lyr, axi, fmaf(-lyi, axr, acc[3]));
}

// Every pair of a 16-amplitude group along its bit k (amplitude index
// pos * 4 + component: bits 0-1 the float4 component, bit 2 j1, bit 3 j2).
template <int K>
__device__ __forceinline__ void trans_bit(float* acc, const float* v) {
#pragma unroll
  for (int x = 0; x < 16; ++x) {
    if (!((x >> K) & 1)) trans_pair(acc, v, x, x | (1 << K));
  }
}

// Layout 0's diagonal sums over a group at float4 positions f, f ^ 2^j1,
// f ^ 2^j2, f ^ 2^j1 ^ 2^j2 of a half-tile: w = conj(l) a per amplitude,
// added to the total and to the margin (T11) of each tile bit set in the
// amplitude's index: bits 0-1 by component, the float4-index bits by
// position, and the top bit when the half is the tile's second.
__device__ __forceinline__ void trans_margins(float* acc, const float* v,
                                              int f, int j1, int j2,
                                              bool second) {
  float sr[4], si[4];  // w summed over each position's four components
  float* m = acc + kTransMarginAt;
#pragma unroll
  for (int pos = 0; pos < 4; ++pos) {
    sr[pos] = si[pos] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int x = pos * 4 + c;
      const float wr = fmaf(v[x], v[32 + x], v[16 + x] * v[48 + x]);
      const float wi = fmaf(v[x], v[48 + x], -v[16 + x] * v[32 + x]);
      sr[pos] += wr;
      si[pos] += wi;
      if (c & 1) {
        m[0] += wr;
        m[1] += wi;
      }
      if (c & 2) {
        m[2] += wr;
        m[3] += wi;
      }
    }
  }
  const float tr = (sr[0] + sr[1]) + (sr[2] + sr[3]);
  const float ti = (si[0] + si[1]) + (si[2] + si[3]);
#pragma unroll
  for (int p = 0; p < kTransMaxBits - 3; ++p) {  // tile bit p + 2
    float ar = (f >> p) & 1 ? tr : 0.f;
    float ai = (f >> p) & 1 ? ti : 0.f;
    if (p == j1) {
      ar = sr[1] + sr[3];
      ai = si[1] + si[3];
    } else if (p == j2) {
      ar = sr[2] + sr[3];
      ai = si[2] + si[3];
    }
    m[2 * p + 4] += ar;
    m[2 * p + 5] += ai;
  }
  if (second) {
    m[2 * kTransTop] += tr;
    m[2 * kTransTop + 1] += ti;
  }
  acc[kTransTotalAt] += tr;
  acc[kTransTotalAt + 1] += ti;
}

// Layout L over half-tiles in shared memory (`lo`, `hi`: 4 planes of 2^log_hv
// float4s each, l_re, l_im, a_re, a_im): this thread's groups among
// `groups`, accumulated into slots 2L + 2 (bit j1) and 2L + 3 (bit j2); a
// float4 index at or above 2^log_hv lies in `hi` (the cross layout's j2).
// Layout 0 also takes tile bits 0-1 (slots 0, 1) and every margin
// (`second`: the half is its tile's second).
template <int L>
__device__ __forceinline__ void trans_layout(const float* lo, const float* hi,
                                             int log_hv, int groups, int j1,
                                             int j2, bool second,
                                             float* acc) {
  const int p_lo = j1 < j2 ? j1 : j2;
  const int p_hi = j1 < j2 ? j2 : j1;
  const int hv = 1 << log_hv;
  for (int g = threadIdx.x; g < groups; g += kTransThreads) {
    const int f = insert_zero(insert_zero(g, p_lo), p_hi);
    const int at[4] = {f, f | (1 << j1), f | (1 << j2),
                       f | (1 << j1) | (1 << j2)};
    float v[64];  // [plane][amplitude]
#pragma unroll
    for (int pos = 0; pos < 4; ++pos) {
      const float4* half =
          reinterpret_cast<const float4*>(at[pos] >> log_hv ? hi : lo);
      const int e = trans_swizzle(at[pos] & (hv - 1));
#pragma unroll
      for (int pl = 0; pl < 4; ++pl) {
        const float4 x = half[pl * hv + e];
        v[pl * 16 + pos * 4 + 0] = x.x;
        v[pl * 16 + pos * 4 + 1] = x.y;
        v[pl * 16 + pos * 4 + 2] = x.z;
        v[pl * 16 + pos * 4 + 3] = x.w;
      }
    }
    if constexpr (L == 0) {
      trans_margins(acc, v, f, j1, j2, second);
      trans_bit<0>(acc, v);
      trans_bit<1>(acc + kTransSlotFloats, v);
    }
    trans_bit<2>(acc + (2 * L + 2) * kTransSlotFloats, v);
    trans_bit<3>(acc + (2 * L + 3) * kTransSlotFloats, v);
  }
}

// Starts copying half `h` of this block's stream of half-tiles (tile
// blockIdx.x + (h / 2) * gridDim.x, its float4s from (h % 2) * 2^log_hv)
// into `dst`: cp.async from the state, zeros past the state's `loaded`
// float4s (a tile padded out to 16 amplitudes a half).
__device__ __forceinline__ void trans_issue(const float* const* src,
                                            const TransPass& ps, int n,
                                            long long h, int log_hv,
                                            int loaded, const int* s_lo,
                                            const int* s_hi, float* dst) {
  const long long t = blockIdx.x + (h >> 1) * gridDim.x;
  const long long u = t & ((1LL << ps.rest) - 1);
  long long origin = (t >> ps.rest) << n;
  for (int k = 0; k < ps.rest; ++k) {
    if ((u >> k) & 1) origin += 1LL << ps.rest_bit[k];
  }
  const int hv = 1 << log_hv;
  for (int e = threadIdx.x; e < hv; e += kTransThreads) {
    const int f = (int)(h & 1) * hv + e;  // float4 index in the tile
    float* d = dst + 4 * trans_swizzle(e);
    if (f < loaded) {
      const long long off = origin + s_lo[f & 63] + s_hi[f >> 6];
#pragma unroll
      for (int pl = 0; pl < 4; ++pl) cp_async_16(d + pl * 4 * hv, src[pl] + off);
    } else {
#pragma unroll
      for (int pl = 0; pl < 4; ++pl) {
        *reinterpret_cast<float4*>(d + pl * 4 * hv) =
            make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
}

// Blocks take tiles blockIdx.x, + gridDim.x, ... of each pass in turn and
// write one partial per pass: partial[(block * kTransMaxPasses + pass) *
// kTransPartial + e], e in the accumulators' order (kTransMarginAt).  Planes are [B, 2^n] floats, 16-byte aligned.
//
// A tile streams through shared memory as two halves split at its top bit,
// in a ring of three half-tile slots: while half h is reduced, half h + 1
// is in flight (cp.async), and the tile's first half stays for the layout
// across the halves (the last one), run with its second.
__global__ void __launch_bounds__(kTransThreads)
    qubit_transitions_kernel(const float* __restrict__ l_re,
                             const float* __restrict__ l_im,
                             const float* __restrict__ a_re,
                             const float* __restrict__ a_im,
                             const __grid_constant__ TransPlan plan,
                             float* __restrict__ partial) {
  extern __shared__ float smem[];
  int* s_lo = reinterpret_cast<int*>(smem);  // offsets of float4 bits 0-5
  int* s_hi = s_lo + 64;                     // and of float4 bits 6-10
  float* ring = smem + kTransHeader;
  const float* src[4] = {l_re, l_im, a_re, a_im};
  for (int p = 0; p < plan.passes; ++p) {
    const TransPass& ps = plan.pass[p];
    const int bits = ps.bits;
    const int log_hv = (bits < 5 ? 5 : bits) - 3;  // float4s of a half plane
    const int slot_floats = 16 << log_hv;           // 4 planes of a half
    const int loaded = 1 << (bits - 2);
    const long long halves =
        ps.tiles > blockIdx.x ? 2 * ((ps.tiles - 1 - blockIdx.x) / gridDim.x + 1)
                              : 0;
    __syncthreads();  // the previous pass's reduction has been read
    if (threadIdx.x < 96) {
      const bool low = threadIdx.x < 64;
      const int i = low ? threadIdx.x : threadIdx.x - 64;
      const int first = low ? 2 : 8;
      int off = 0;
      for (int k = 0; k < (low ? 6 : 5); ++k) {
        if (((i >> k) & 1) && first + k < bits) off += 1 << ps.tile_bit[first + k];
      }
      (low ? s_lo : s_hi)[i] = off;
    }
    float acc[kTransPartial];
#pragma unroll
    for (int e = 0; e < kTransPartial; ++e) acc[e] = 0.f;
    __syncthreads();  // offsets written
    if (halves > 0) {
      trans_issue(src, ps, plan.n, 0, log_hv, loaded, s_lo, s_hi, ring);
      cp_async_commit();
    }
    const int inner = ps.layouts - 1;  // the last layout crosses the halves
    const int groups = 1 << (log_hv - 2);
    for (long long h = 0; h < halves; ++h) {
      if (h + 1 < halves) {
        trans_issue(src, ps, plan.n, h + 1, log_hv, loaded, s_lo, s_hi,
                    ring + ((h + 1) % 3) * slot_floats);
        cp_async_commit();
        cp_async_wait_prior();
      } else {
        cp_async_wait_all();
      }
      __syncthreads();  // half h has landed
      const float* cur = ring + (h % 3) * slot_floats;
      const bool second = h & 1;
      if (inner > 0) trans_layout<0>(cur, cur, log_hv, groups, ps.j1[0], ps.j2[0], second, acc);
      if (inner > 1) trans_layout<1>(cur, cur, log_hv, groups, ps.j1[1], ps.j2[1], second, acc);
      if (inner > 2) trans_layout<2>(cur, cur, log_hv, groups, ps.j1[2], ps.j2[2], second, acc);
      if (inner > 3) trans_layout<3>(cur, cur, log_hv, groups, ps.j1[3], ps.j2[3], second, acc);
      if (inner > 4) trans_layout<4>(cur, cur, log_hv, groups, ps.j1[4], ps.j2[4], second, acc);
      if (second) {
        const float* first = ring + ((h - 1) % 3) * slot_floats;
        const int g2 = 2 * groups;
        switch (inner) {  // static slots: one call each
          case 1: trans_layout<1>(first, cur, log_hv, g2, ps.j1[1], ps.j2[1], true, acc); break;
          case 2: trans_layout<2>(first, cur, log_hv, g2, ps.j1[2], ps.j2[2], true, acc); break;
          case 3: trans_layout<3>(first, cur, log_hv, g2, ps.j1[3], ps.j2[3], true, acc); break;
          case 4: trans_layout<4>(first, cur, log_hv, g2, ps.j1[4], ps.j2[4], true, acc); break;
          default: trans_layout<5>(first, cur, log_hv, g2, ps.j1[5], ps.j2[5], true, acc); break;
        }
      }
      __syncthreads();  // the slot half h + 2 will take is free
    }
    // The block's sum, in thread order, through the ring's shared memory.
    float* row = ring + threadIdx.x * kTransRedLd;
#pragma unroll
    for (int e = 0; e < kTransPartial; ++e) row[e] = acc[e];
    __syncthreads();
    if (threadIdx.x < kTransPartial) {
      float sum = 0.f;
      for (int r = 0; r < kTransThreads; ++r) {
        sum += ring[r * kTransRedLd + threadIdx.x];
      }
      partial[((long long)blockIdx.x * kTransMaxPasses + p) * kTransPartial +
              threadIdx.x] = sum;
    }
  }
}

// out[i, re/im, r, c] = T[r, c] of picked qubit i: the partials of its
// pass summed in block order; T00 is the total of w less T11.
__global__ void transitions_finish_kernel(const float* __restrict__ partial,
                                          int blocks, TransPick pick,
                                          float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pick.count * 8) return;
  const int q = i >> 3;
  const int part = (i >> 2) & 1;  // 0: re, 1: im
  const int r = (i >> 1) & 1;
  const int c = i & 1;
  const int t11 = kTransMarginAt + 2 * pick.margin[q] + part;
  const int at = r == c ? t11
                        : pick.slot[q] * kTransSlotFloats + 2 * r + part;
  float sum = 0.f;
  float total = 0.f;
  for (int b = 0; b < blocks; ++b) {
    const float* pb = partial +
        ((long long)b * kTransMaxPasses + pick.pass[q]) * kTransPartial;
    sum += pb[at];
    total += pb[kTransTotalAt + part];
  }
  out[i] = (r == 0 && c == 0) ? total - sum : sum;
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
// of VMEM residency, so every stage streams the state from L2 and the axis
// stages' operations bound the launch: at N = 128 an amplitude costs 1024
// flop against 16 bytes.  So an axis stage of N >= 16 contracts on the
// tensor cores in 3xTF32 through K4's body (axis_mma_slabs) in its
// one-buffer variant: slabs of 2^13 amplitudes, the operator resident in
// shared memory at every N (split once into TF32 planes for N <= 64, fp32
// planes split per fragment at N = 128); N < 16 keeps the fp32 FMA body
// (axis_apply_tiles).  At 20 qubits a state is 128 slabs, one a block, so
// a stage takes one slab's latency, mostly its contraction: the copies in
// and out alone took about a quarter of an N = 128 stage on the H100
// (PERF.md, section 6).  The second state of a sweep's axis stage starts
// on the blocks the first leaves idle (`sweep_axis`'s rotation), so small
// states keep twice the blocks busy.  A stage ends in a grid barrier (a
// near-empty stage took ~2 us), so the design keeps one launch per
// circuit: one persistent 512-thread block per SM (196 KB of shared
// memory, the N = 128 axis stage's), walking a stage table in device
// memory, one record per stage in order, each with its own data offsets
// (so the Pallas kernel's loop over repeated layers has no counterpart).
// A stage is
//   kAxis  -- an [N, N] operator on bits [start, start + k) of every state,
//             out of place into the other plane pair;
//   kDiag  -- theta = sum_k w_k s(x & mask_k), summed per amplitude in fp64
//             from the parity masks with __popc (the Pallas kernel builds
//             its sign matrices in-kernel too), then one sincosf rotation
//             of every state in place; no cos/sin planes are read;
//   kTrans -- (sweep) the 2x2 transition T_q[i, j] = sum_{x: x_q = 0}
//             conj(lambda[x ^ i e_q]) a[x ^ j e_q] of each of K qubits
//             (their state-index bits at the record's mask offset), 8
//             floats a qubit (re, then im, of T00 T01 T10 T11): all the
//             gradient reads of the reference's row-block transitions and
//             minor kmat, without the [N, N] grams (`sweep_transitions`);
//   kBilin -- (sweep) the parity bilinears of Im(conj(lambda) a).
// A reduction writes per-block partials, then a barrier, then a sum in
// block order (sweep_sum_partials): no float atomics, so gradients are
// bitwise reproducible run to run.  A kDiag or kBilin record holds at most
// kBilinMaxK factors (the shared memory its masks and weights are staged
// in); the host splits a longer diagonal segment into several records.  The
// inverse operators and negated weights of the sweep are folded on the
// host.  A launch that cannot be co-resident is refused.
constexpr int kAxis = 0;
constexpr int kDiag = 1;
constexpr int kTrans = 2;
constexpr int kBilin = 3;
constexpr int kStageInts = 8;  // kind, start, k, K, data, masks, out, unused
constexpr int kSweepTileBits = 13;  // a kTrans tile: 2^13 amplitudes
constexpr int kSweepWarps = kApplyThreads / 32;
constexpr int kSweepMaxTrans = 32;  // qubits a kTrans record
constexpr size_t kSweepTransSmem =
    ((4 << kSweepTileBits) + 8 * kSweepWarps) * sizeof(float) +
    kSweepMaxTrans * sizeof(int);
constexpr size_t kSweepSmem = AxisMma<128, 1>::kSmem;
static_assert(kSweepSmem >= AxisMma<64, 1>::kSmem &&
                  kSweepSmem >= AxisMma<32, 1>::kSmem &&
                  kSweepSmem >= AxisMma<16, 1>::kSmem &&
                  kSweepSmem >= axis_apply_smem<8>() &&
                  kSweepSmem >= kSweepTransSmem &&
                  kSweepSmem >= (kApplyThreads + 2 * kBilinMaxK) * 4,
              "the sweep's shared memory must hold every stage's");
static_assert(kAxisMmaThreads == kApplyThreads,
              "the sweep's blocks run both axis bodies");

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

// One kAxis stage on one state of n qubits: the [N, N] operator on the
// [P, N, Q = 2^log_q] view, out of place.  Block b takes the work items
// (slabs, or FMA tiles) b - rot, b - rot + gridDim.x, ... with rot the
// items of `state` earlier states (mod gridDim.x): a sweep's lambda starts
// on the blocks that a left idle.
template <int N>
__device__ __forceinline__ void sweep_axis(const float* x_re,
                                           const float* x_im,
                                           const float* op_re,
                                           const float* op_im, float* y_re,
                                           float* y_im, int n, int log_q,
                                           int state, float* smem) {
  constexpr int kLogN = N == 2 ? 1 : N == 4 ? 2 : N == 8 ? 3 : N == 16 ? 4
                        : N == 32 ? 5 : N == 64 ? 6 : 7;
  const long long cols = 1LL << (n - kLogN);  // P * Q
  const long long g = gridDim.x;
  auto first = [&](long long items) {
    return (blockIdx.x + g - (state * items) % g) % g;
  };
  if constexpr (N >= 16) {
    constexpr long long L = 1LL << AxisMma<N, 1>::kLogL;
    const long long start = first((cols + L - 1) / L);
    if (log_q >= 2) {
      axis_mma_slabs<N, 1, 1>(x_re, x_im, op_re, op_im, y_re, y_im, cols,
                              log_q, start, g, smem);
    } else {
      axis_mma_slabs<N, 2, 1>(x_re, x_im, op_re, op_im, y_re, y_im, cols,
                              log_q, start, g, smem);
    }
  } else {
    axis_apply_tiles<N>(x_re, x_im, op_re, op_im, y_re, y_im, cols,
                        1 << log_q, first((cols + kApplyW - 1) / kApplyW), g,
                        smem);
  }
}

// Adds the amplitude pair (x, y = x with the qubit's bit set) to
// acc = (re, then im, of T00 T01 T10 T11): T_ij += conj(l_i) a_j.
__device__ __forceinline__ void sweep_pair(float* acc, const float* x,
                                           const float* y, int c, int d) {
  // x[pl * 4 + c]: planes l_re, l_im, a_re, a_im; component c of x, d of y.
  const float lxr = x[c], lxi = x[4 + c], axr = x[8 + c], axi = x[12 + c];
  const float lyr = y[d], lyi = y[4 + d], ayr = y[8 + d], ayi = y[12 + d];
  acc[0] = fmaf(lxr, axr, fmaf(lxi, axi, acc[0]));
  acc[4] = fmaf(lxr, axi, fmaf(-lxi, axr, acc[4]));
  acc[1] = fmaf(lxr, ayr, fmaf(lxi, ayi, acc[1]));
  acc[5] = fmaf(lxr, ayi, fmaf(-lxi, ayr, acc[5]));
  acc[2] = fmaf(lyr, axr, fmaf(lyi, axi, acc[2]));
  acc[6] = fmaf(lyr, axi, fmaf(-lyi, axr, acc[6]));
  acc[3] = fmaf(lyr, ayr, fmaf(lyi, ayi, acc[3]));
  acc[7] = fmaf(lyr, ayi, fmaf(-lyi, ayr, acc[7]));
}

// The four planes' float4 f of a tile in shared memory, into v[pl * 4 + c].
__device__ __forceinline__ void sweep_load4(const float4* tile, int f,
                                            float* v) {
#pragma unroll
  for (int pl = 0; pl < 4; ++pl) {
    const float4 q = tile[(pl << (kSweepTileBits - 2)) + f];
    v[pl * 4 + 0] = q.x;
    v[pl * 4 + 1] = q.y;
    v[pl * 4 + 2] = q.z;
    v[pl * 4 + 3] = q.w;
  }
}

// kTrans: this block's partial [K, 8] of the transitions of the state-index
// bits `bits` of (lambda, a), 2^n amplitudes each.
//
// Bound: 16 flop an amplitude pair and qubit against 16 bytes an amplitude
// read once from L2, so reads bound it, as K5's kernel.  A pair along bit b
// needs both amplitudes in one block, so the state goes through shared
// memory in tiles of 2^13 amplitudes of the four planes (128 KB) whose
// index bits cover b, in two passes as K5's planner makes them at B = 1:
// pass 1 the low 13 bits (tiles are contiguous runs), pass 2 the state's
// bits 13 .. n - 1 with its 26 - n lowest (runs of >= 64 floats).  A qubit
// is computed in the pass where its bit is new.  There each of its warps
// (16 / the pass's qubits, so most warps work) walks its share of the
// tile's pairs, four a float4 pair (tile bits >= 2) or two a float4 (bits
// 0 and 1), into 8 fp32 accumulators a lane held across the block's tiles:
// 8 registers a qubit where K5's 256-thread kernel holds 84 floats, which a
// 512-thread block's 128 registers do not leave.  At the pass's end each
// warp sums its lanes by a fixed shuffle tree and the qubit's warps are
// added in warp order, so the partials, like their sum in block order, are
// bitwise reproducible.  The tile has to land before the pairs are read (no
// second buffer); at 20 qubits a block has one tile a pass.
__device__ void sweep_transitions(const float* l_re, const float* l_im,
                                  const float* a_re, const float* a_im,
                                  int n, const int* __restrict__ bits, int K,
                                  float* __restrict__ partial, float* smem) {
  constexpr int T = kSweepTileBits;
  float* tile = smem;  // [l_re, l_im, a_re, a_im][2^T]
  float* red = tile + (4 << T);  // [kSweepWarps][8] warp sums
  int* s_bits = reinterpret_cast<int*>(red + 8 * kSweepWarps);
  const float* src[4] = {l_re, l_im, a_re, a_im};
  const float4* t4 = reinterpret_cast<const float4*>(tile);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tb = n < T ? n : T;  // tile bits
  for (int i = threadIdx.x; i < K; i += kApplyThreads) s_bits[i] = bits[i];
  for (int pass = 0; pass < (n > T ? 2 : 1); ++pass) {
    // Tile bits [0, run) are the state's; in pass 2, tile bits [run, T)
    // are the state's bits [T, n) and tile u sits at state bits [run, T).
    const int run = pass == 0 ? tb : 2 * T - n;
    auto tile_bit = [&](int b) {
      return pass == 0 ? (b < tb ? b : -1) : (b >= T ? run + b - T : -1);
    };
    // The j-th qubit new in this pass: its tile bit and its row of the
    // partial (-1, -1 past the last).
    auto pick = [&](int j, int* row) {
      for (int i = 0; i < K; ++i) {
        const int t = tile_bit(s_bits[i]);
        if (t >= 0 && j-- == 0) {
          *row = i;
          return t;
        }
      }
      *row = -1;
      return -1;
    };
    __syncthreads();  // s_bits written; the previous pass's sums are read
    int nb = 0;
    for (int i = 0; i < K; ++i) nb += tile_bit(s_bits[i]) >= 0;
    if (nb == 0) continue;
    const int wpb = kSweepWarps / nb;  // warps a qubit (nb <= T < 16)
    const int slot = warp / wpb;
    const int part = warp - slot * wpb;
    int row;
    const int t = pick(slot, &row);
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    const long long tiles = 1LL << (n - tb);
    for (long long u = blockIdx.x; u < tiles; u += gridDim.x) {
      __syncthreads();  // the previous tile is read
      for (int f = threadIdx.x; f < 1 << (tb - 2); f += kApplyThreads) {
        const int e = 4 * f;
        const long long at = (e & ((1 << run) - 1)) |
                             ((long long)(e >> run) << T) | (u << run);
#pragma unroll
        for (int pl = 0; pl < 4; ++pl) {
          cp_async_16(tile + (pl << T) + e, src[pl] + at);
        }
      }
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();  // the tile has landed
      if (t >= 2) {  // float4 f and f with float4 bit t - 2 set
        const int j = t - 2;
        const int groups = 1 << (tb - 3);
        for (int g = part * groups / wpb + lane;
             g < (part + 1) * groups / wpb; g += 32) {
          const int f = insert_zero(g, j);
          float x[16], y[16];
          sweep_load4(t4, f, x);
          sweep_load4(t4, f | (1 << j), y);
#pragma unroll
          for (int c = 0; c < 4; ++c) sweep_pair(acc, x, y, c, c);
        }
      } else if (t >= 0) {  // both members in one float4
        const int groups = 1 << (tb - 2);
        for (int g = part * groups / wpb + lane;
             g < (part + 1) * groups / wpb; g += 32) {
          float x[16];
          sweep_load4(t4, g, x);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (!((c >> t) & 1)) sweep_pair(acc, x, x, c, c | (1 << t));
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) {
        acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], m);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int e = 0; e < 8; ++e) red[warp * 8 + e] = acc[e];
    }
    __syncthreads();
    if (threadIdx.x < 8 * nb) {
      const int s = threadIdx.x >> 3;
      const int e = threadIdx.x & 7;
      float sum = 0.f;
      for (int p = 0; p < wpb; ++p) sum += red[(s * wpb + p) * 8 + e];
      int out_row;
      pick(s, &out_row);
      partial[out_row * 8 + e] = sum;
    }
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
    float* a0 = states[0] + cur * 2 * size;
    float* l0 = S == 2 ? states[1] + cur * 2 * size : nullptr;
    if (kind == kAxis) {
      const int nn = 1 << (2 * k);
      for (int s = 0; s < S; ++s) {
        float* src = states[s] + cur * 2 * size;
        float* dst = states[s] + (cur ^ 1) * 2 * size;
        QHBM_LOG2_SWITCH(k, sweep_axis, src, src + size, d, d + nn, dst,
                         dst + size, n, n - start - k, s, smem)
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
      if (kind == kTrans) {
        width = 8 * K;
        sweep_transitions(l0, l0 + size, a0, a0 + size, n, mk, K,
                          partial + (long long)blockIdx.x * width, smem);
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

// Co-resident blocks of sweep_kernel<S> (one per SM at its 196 KB of shared
// memory); 0 if the device cannot launch it cooperatively.
template <int S>
int sweep_blocks() {
  if (!device_attribute<cudaDevAttrCooperativeLaunch>()) return 0;
  return blocks_per_sm((const void*)sweep_kernel<S>, kApplyThreads,
                       kSweepSmem, true) *
         sm_count();
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

// The launch geometry is asked of the runtime once and then cached, so a
// launch makes no attribute or occupancy query after its kernel's first
// launch on a device: asked at every launch, they cost host time that a
// small launch (a few us on the card) cannot hide.

int current_device() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev;
}

// The current device's attribute kAttr, asked once a device.
template <auto kAttr>
int device_attribute() {
  static std::mutex mu;
  static std::vector<int> value;  // by device; -1: not asked yet
  const int dev = current_device();
  std::lock_guard<std::mutex> lock(mu);
  if ((int)value.size() <= dev) value.resize(dev + 1, -1);
  if (value[dev] < 0) {
    int v = 0;
    cudaDeviceGetAttribute(&v, kAttr, dev);
    value[dev] = v;
  }
  return value[dev];
}

int sm_count() {
  const int sms = device_attribute<cudaDevAttrMultiProcessorCount>();
  return sms > 0 ? sms : 1;
}

// A wave of the diagonal kernels' 256-thread blocks on this device.
long long diag_wave() { return (long long)sm_count() * kDiagBlocksPerSm; }

// Blocks of `kernel` resident on one SM at `threads` threads and `smem`
// bytes of dynamic shared memory.  The kernel's dynamic shared-memory
// limit is raised to `smem` where it is lower (never lowered: a launch of
// less than the limit is valid, so one kernel may launch at several sizes
// in any order) and, with `max_carveout`, its whole carveout is asked for
// at its first launch; the occupancy is asked once for each (kernel,
// threads, smem) on a device, then cached.  0 if the kernel cannot run so.
int blocks_per_sm(const void* kernel, int threads, size_t smem,
                  bool max_carveout) {
  struct Limit {
    const void* kernel;
    int dev;
    size_t smem;  // the dynamic shared-memory limit set so far
  };
  struct Fit {
    const void* kernel;
    int dev;
    int threads;
    size_t smem;
    int per_sm;
  };
  static std::mutex mu;
  static std::vector<Limit> limits;
  static std::vector<Fit> fits;
  const int dev = current_device();
  std::lock_guard<std::mutex> lock(mu);
  Limit* limit = nullptr;
  for (Limit& l : limits) {
    if (l.kernel == kernel && l.dev == dev) limit = &l;
  }
  if (limit == nullptr) {
    if (max_carveout) {
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
    }
    limits.push_back({kernel, dev, 0});
    limit = &limits.back();
  }
  if (smem > limit->smem) {
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) != cudaSuccess) {
      return 0;
    }
    limit->smem = smem;
  }
  for (const Fit& f : fits) {
    if (f.kernel == kernel && f.dev == dev && f.threads == threads &&
        f.smem == smem) {
      return f.per_sm;
    }
  }
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess) {
    per_sm = 0;
  }
  fits.push_back({kernel, dev, threads, smem, per_sm});
  return per_sm;
}

// One persistent block per resident slot, at most `work` blocks.
template <typename Kernel>
int persistent_grid(Kernel kernel, int threads, size_t smem, long long work,
                    bool max_carveout = false) {
  const int per_sm =
      blocks_per_sm((const void*)kernel, threads, smem, max_carveout);
  long long grid = (long long)sm_count() * (per_sm > 0 ? per_sm : 1);
  if (work < grid) grid = work;
  return grid > 0 ? (int)grid : 1;
}

// axis_apply for N < 16: one group of columns a thread, up to
// kStreamBlocksPerSm blocks an SM (then a grid-stride loop).
template <int N>
int launch_axis_stream(const float* x_re, const float* x_im,
                       const float* op_re, const float* op_im, float* y_re,
                       float* y_im, long long cols, int log_q,
                       cudaStream_t stream) {
  const int log_w = log_q < 2 ? log_q : 2;
  const long long groups = cols >> log_w;
  long long grid = (groups + kStreamThreads - 1) / kStreamThreads;
  const long long cap = (long long)sm_count() * kStreamBlocksPerSm;
  if (grid > cap) grid = cap;
  const AxisStreamKernel kernel =
      axis_stream_pick<N>(log_q, x_re, x_im, y_re, y_im);
  kernel<<<(int)grid, kStreamThreads, 2 * N * N * sizeof(float), stream>>>(
      x_re, x_im, op_re, op_im, y_re, y_im, groups, log_q);
  return (int)cudaGetLastError();
}

// One block of up to 200 KB an SM: the shared-memory carveout is asked
// for in full.
template <int N>
int launch_axis_apply_mma(const float* x_re, const float* x_im,
                          const float* op_re, const float* op_im,
                          float* y_re, float* y_im, long long cols,
                          int log_q, cudaStream_t stream) {
  auto kernel = log_q >= 2 ? axis_apply_mma_kernel<N, 1>
                           : axis_apply_mma_kernel<N, 2>;
  const int grid =
      persistent_grid(kernel, kAxisMmaThreads, AxisMma<N>::kSmem,
                      (cols + (1 << AxisMma<N>::kLogL) - 1) >>
                          AxisMma<N>::kLogL,
                      true);
  kernel<<<grid, kAxisMmaThreads, AxisMma<N>::kSmem, stream>>>(
      x_re, x_im, op_re, op_im, y_re, y_im, cols, log_q);
  return (int)cudaGetLastError();
}


// Fills `plan` for B states of n qubits: tiles of at most kTransMaxBits
// bits, the first the lowest bits, each later one its `run` lowest bits (at
// least kTransMinRun) and up to kTransMaxBits - run bits not yet taken: one
// pass to 13 qubits, two to 24, three to 30.  For each state-index bit, the
// pass, the slot and the margin that compute its qubit.  False for
// arguments out of range.
bool plan_transitions(int n, long long B, TransPlan* plan, int* pass_of_bit,
                      int* slot_of_bit, int* margin_of_bit) {
  if (n < 2 || n > kTransMaxStateBits || B < 1) return false;
  plan->n = n;
  plan->passes = 0;
  for (int covered = 0; covered < n;) {  // bits below `covered` are taken
    if (plan->passes == kTransMaxPasses) return false;
    TransPass& ps = plan->pass[plan->passes];
    const int room = covered == 0 ? kTransMaxBits
                                  : kTransMaxBits - kTransMinRun;
    const int fresh = n - covered < room ? n - covered : room;
    const int run = covered == 0 ? 0 : kTransMaxBits - fresh;
    ps.bits = run + fresh;
    for (int t = 0; t < ps.bits; ++t) {
      ps.tile_bit[t] = t < run ? t : covered + t - run;
    }
    ps.rest = 0;
    for (int b = run; b < n; ++b) {
      if (b < covered || b >= covered + fresh) ps.rest_bit[ps.rest++] = b;
    }
    ps.tiles = B << ps.rest;
    // Layouts over the float4-index bits of a half-tile, 0 .. eff - 4: each
    // bit below 4 with one above (conflict-free under trans_swizzle), the
    // rest in pairs, an odd one out with a bit already covered (its second
    // slot unread).  Then the top bit, eff - 3, across the halves.
    const int eff = ps.bits < 5 ? 5 : ps.bits;
    int low[4], high[kTransMaxBits], left[kTransMaxBits];
    int nl = 0, nh = 0, nleft = 0;
    for (int p = 0; p < eff - 3; ++p) {
      if (p < 4) {
        low[nl++] = p;
      } else {
        high[nh++] = p;
      }
    }
    ps.layouts = 0;
    auto add = [&ps](int j1, int j2) {
      ps.j1[ps.layouts] = j1;
      ps.j2[ps.layouts] = j2;
      ++ps.layouts;
    };
    const int pairs = nl < nh ? nl : nh;
    for (int i = 0; i < pairs; ++i) add(low[i], high[i]);
    for (int i = pairs; i < nl; ++i) left[nleft++] = low[i];
    for (int i = pairs; i < nh; ++i) left[nleft++] = high[i];
    for (int i = 0; i + 1 < nleft; i += 2) add(left[i], left[i + 1]);
    if (nleft % 2) {
      const int p = left[nleft - 1];
      add(p, nh > 0 && high[0] != p ? high[0] : (p == 0 ? 1 : 0));
    }
    add(nh > 0 ? high[0] : 0, eff - 3);
    for (int t = run; t < ps.bits; ++t) {
      int slot = t < 2 ? t : -1;  // tile bits 0 and 1: slots 0 and 1
      for (int l = 0; slot < 0; ++l) {  // the first layout holding the bit
        if (ps.j1[l] == t - 2) slot = 2 * l + 2;
        if (ps.j2[l] == t - 2) slot = 2 * l + 3;
      }
      pass_of_bit[ps.tile_bit[t]] = plan->passes;
      slot_of_bit[ps.tile_bit[t]] = slot;
      margin_of_bit[ps.tile_bit[t]] = t == eff - 1 ? kTransTop : t;
    }
    covered += fresh;
    ++plan->passes;
  }
  return true;
}

}  // namespace

extern "C" {

// y = Op x on the N axis of the [P, N, Q] view (N and Q powers of two,
// N <= 128): a register stream of fp32 FMAs below N = 16, the tensor cores
// from N = 16 on.
int qhbm_axis_apply(const float* x_re, const float* x_im, const float* op_re,
                    const float* op_im, float* y_re, float* y_im, int P,
                    int N, int Q, void* stream) {
  if (P < 1 || Q < 1 || (Q & (Q - 1))) return (int)cudaErrorInvalidValue;
  int log_q = 0;
  while ((1 << log_q) < Q) ++log_q;
  int (*launch)(const float*, const float*, const float*, const float*,
                float*, float*, long long, int, cudaStream_t) = nullptr;
  switch (N) {
    case 2: launch = launch_axis_stream<2>; break;
    case 4: launch = launch_axis_stream<4>; break;
    case 8: launch = launch_axis_stream<8>; break;
    case 16: launch = launch_axis_apply_mma<16>; break;
    case 32: launch = launch_axis_apply_mma<32>; break;
    case 64: launch = launch_axis_apply_mma<64>; break;
    case 128: launch = launch_axis_apply_mma<128>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  return launch(x_re, x_im, op_re, op_im, y_re, y_im, (long long)P * Q,
                log_q, static_cast<cudaStream_t>(stream));
}

// Floats of qhbm_qubit_transitions' scratch per block.
int qhbm_transitions_scratch() { return kTransMaxPasses * kTransPartial; }

// T_q of `count` qubits (`qubits`, in host memory) of B states of n qubits,
// [B, 2^n] float planes 16-byte aligned: out [count, 2, 2, 2] (qubit,
// re/im, i, j).  `partial` is scratch of max_blocks *
// qhbm_transitions_scratch() floats.
int qhbm_qubit_transitions(const float* l_re, const float* l_im,
                           const float* a_re, const float* a_im, int B,
                           int n, const int* qubits, int count,
                           float* partial, int max_blocks, float* out,
                           void* stream) {
  TransPlan plan;
  int pass_of_bit[kTransMaxStateBits];
  int slot_of_bit[kTransMaxStateBits];
  int margin_of_bit[kTransMaxStateBits];
  if (count < 1 || count > kTransMaxQubits || max_blocks < 1 ||
      !plan_transitions(n, B, &plan, pass_of_bit, slot_of_bit,
                        margin_of_bit)) {
    return (int)cudaErrorInvalidValue;
  }
  TransPick pick;
  pick.count = count;
  for (int i = 0; i < count; ++i) {
    if (qubits[i] < 0 || qubits[i] >= n) return (int)cudaErrorInvalidValue;
    pick.pass[i] = pass_of_bit[n - 1 - qubits[i]];  // qubit 0: the top bit
    pick.slot[i] = slot_of_bit[n - 1 - qubits[i]];
    pick.margin[i] = margin_of_bit[n - 1 - qubits[i]];
  }
  size_t ring_floats = kTransThreads * kTransRedLd;  // the block's sum
  long long most = 0;
  for (int p = 0; p < plan.passes; ++p) {
    const int eff = plan.pass[p].bits < 5 ? 5 : plan.pass[p].bits;
    // Three half-tile slots of 4 planes of 2^(eff - 1) floats.
    if ((size_t)6 << eff > ring_floats) ring_floats = (size_t)6 << eff;
    if (plan.pass[p].tiles > most) most = plan.pass[p].tiles;
  }
  const size_t smem = (kTransHeader + ring_floats) * sizeof(float);
  int grid = persistent_grid(qubit_transitions_kernel, kTransThreads, smem,
                             most);
  if (grid > max_blocks) grid = max_blocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  qubit_transitions_kernel<<<grid, kTransThreads, smem, s>>>(
      l_re, l_im, a_re, a_im, plan, partial);
  transitions_finish_kernel<<<1, kTransMaxQubits * 8, 0, s>>>(partial, grid,
                                                              pick, out);
  return (int)cudaGetLastError();
}

// Blocks of the diagonal kernels' grid over B states of `size` amplitudes
// on this device: the rows of qhbm_parity_bilinear's `partial`.
int qhbm_diag_blocks(int B, int size) {
  if (B < 1 || size < 4) return 0;
  return diag_grid(B, size / 4, diag_wave()).blocks();
}

// bilin[k] over B states [B, R, C] (R*C floats a plane, every plane 16-byte
// aligned); masks are int32 [K] device arrays; `partial` is scratch of
// `blocks` (>= qhbm_diag_blocks(B, R*C)) * K floats.  With cos_p and sin_p
// ([R, C] planes, else NULL) it also un-applies the segment in place: a
// and lambda <- exp(-i theta) * (a, lambda).  Needs C a power of two in
// [4, 256] and K <= 1024.
int qhbm_parity_bilinear(float* l_re, float* l_im, float* a_re, float* a_im,
                         const int* row_masks, const int* col_masks, int K,
                         int B, int R, int C, const float* cos_p,
                         const float* sin_p, float* partial, int blocks,
                         float* out, void* stream) {
  if (C < 4 || C > kDiagThreads || (C & (C - 1)) || K < 0 ||
      K > kBilinMaxK || B < 1 || R < 1 ||
      (cos_p == nullptr) != (sin_p == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const DiagGrid g = diag_grid(B, (long long)R * C / 4, diag_wave());
  if (g.blocks() > blocks) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = cos_p != nullptr ? diag_bilinear_kernel<true>
                                 : diag_bilinear_kernel<false>;
  kernel<<<g.blocks(), kDiagThreads, kDiagBilinearSmem, s>>>(
      reinterpret_cast<float4*>(l_re), reinterpret_cast<float4*>(l_im),
      reinterpret_cast<float4*>(a_re), reinterpret_cast<float4*>(a_im),
      reinterpret_cast<const float4*>(cos_p),
      reinterpret_cast<const float4*>(sin_p), row_masks, col_masks, K, B, R,
      C, g, partial);
  if (K > 0) {
    sum_partials_kernel<<<(K + 7) / 8, 256, 0, s>>>(partial, g.blocks(), K,
                                                    out);
  }
  return (int)cudaGetLastError();
}

// In-place rotation of one (re1 == im1 == NULL) or two [B, size] state
// batches by cos + i*sign*sin of the shared [size] planes; size % 4 == 0 and
// every pointer 16-byte aligned.
int qhbm_diag_rotate(float* re0, float* im0, float* re1, float* im1, int B,
                     int size, const float* cos_p, const float* sin_p,
                     int sign, void* stream) {
  if (B < 1 || size < 4 || size % 4) return (int)cudaErrorInvalidValue;
  const long long size4 = size / 4;
  const DiagGrid g = diag_grid(B, size4, diag_wave());
  auto kernel = re1 != nullptr ? diag_rotate_kernel<true>
                               : diag_rotate_kernel<false>;
  kernel<<<g.blocks(), kDiagThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<float4*>(re0), reinterpret_cast<float4*>(im0),
      reinterpret_cast<float4*>(re1), reinterpret_cast<float4*>(im1), B,
      size4, g, reinterpret_cast<const float4*>(cos_p),
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
  int log_q = 0;
  while ((1 << log_q) < Q) ++log_q;
  // W = 2^log_w columns of Q a slab: the slab's 2^kLogSlab amplitudes, or
  // all of Q.  k1 + k2 <= 14, so W >= 1.
  const int log_w = kLogSlab - k1 - k2 < log_q ? kLogSlab - k1 - k2 : log_q;
  const size_t smem =
      2 * ((size_t)1 << (k1 + k2 + log_w)) * sizeof(float) +
      Axis2Block::kPanelSmem;
  const int grid = persistent_grid(axis2_apply_kernel, kAxis2Threads, smem,
                                   (long long)P * M * (Q >> log_w));
  axis2_apply_kernel<<<grid, kAxis2Threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x_re, x_im, a_re, a_im, b_re, b_im, y_re, y_im, P, k1, M, k2, Q,
      log_w);
  return (int)cudaGetLastError();
}

// 1 where axis2_wgmma_kernel takes the [P, 2^k1, M, 2^k2, Q] view: N1 =
// 128 and a slab row of N2 * W = 128, with N2 = 128 or N2 <= 8
// (hopper_sv.axis2_route, the same rule).
int qhbm_axis2_wgmma_view(int k1, int k2, int Q) {
  if (Q < 1 || (Q & (Q - 1))) return 0;
  int log_q = 0;
  while ((1 << log_q) < Q) ++log_q;
  return k1 == 7 && (k2 == 7 || (k2 >= 1 && k2 <= 3)) && k2 + log_q >= 7;
}

// axis2_apply on the views qhbm_axis2_wgmma_view takes: the operators'
// TF32 images go to `image` (kWgImageFloats floats an operator of 128 rows:
// A's, then B's where N2 = 128), then the slab kernel runs.  Two launches.
int qhbm_axis2_wgmma(const float* x_re, const float* x_im, const float* a_re,
                     const float* a_im, const float* b_re, const float* b_im,
                     float* image, float* y_re, float* y_im, int P, int k1,
                     int M, int k2, int Q, void* stream) {
  if (!qhbm_axis2_wgmma_view(k1, k2, Q) || P < 1 || M < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int log_w = 7 - k2;  // W = 128 / N2 <= Q
  const long long slabs = (long long)P * M * (Q >> log_w);
  const int ops = k2 == 7 ? 2 : 1;
  wgmma_presplit_kernel<<<ops * kWgN * kWgN / 256, 256, 0, s>>>(
      a_re, a_im, b_re, b_im, image);
  auto launch = [&](auto kernel) {
    const int grid = persistent_grid(kernel, kWgThreads, kWgSmem, slabs);
    kernel<<<grid, kWgThreads, kWgSmem, s>>>(x_re, x_im, image, b_re, b_im,
                                             y_re, y_im, P, M, Q, log_w);
  };
  switch (k2) {
    case 1: launch(axis2_wgmma_kernel<2>); break;
    case 2: launch(axis2_wgmma_kernel<4>); break;
    case 3: launch(axis2_wgmma_kernel<8>); break;
    default: launch(axis2_wgmma_kernel<kWgN>); break;
  }
  return (int)cudaGetLastError();
}

// Blocks of the flip kernels' grid over B states of n qubits: one pair a
// thread up to a wave of the diagonal kernels' blocks, then a grid-stride
// loop; the rows of qhbm_flip_bilinear's `partial`.
int qhbm_flip_blocks(int B, int n) {
  if (B < 1 || n < 1 || n > 30) return 0;
  const long long pairs = (long long)B << (n - 1);
  const long long need = (pairs + kFlipThreads - 1) / kFlipThreads;
  const long long wave = diag_wave();
  return (int)(need < wave ? need : wave);
}

}  // extern "C"

namespace {

// The kernels' masks and coefficients of a record: f, ctrl, z and
// coeffs[8] in host memory (re alpha[0..1], im alpha[0..1], re beta[0..1],
// im beta[0..1]); false if f is empty or out of range.
bool flip_args(int n, int f, int ctrl, int z, const float* coeffs,
               FlipMasks* m, FlipCoeffs* k) {
  if (n < 1 || n > 30 || f <= 0 || f >= (1 << n) || (ctrl & f) ||
      ctrl < 0 || z < 0 || coeffs == nullptr) {
    return false;
  }
  m->f = f;
  m->ctrl = ctrl;
  m->z = z;
  m->top = 31 - __builtin_clz((unsigned)f);
  for (int c = 0; c < 2; ++c) {
    k->ar[c] = coeffs[c];
    k->ai[c] = coeffs[2 + c];
    k->br[c] = coeffs[4 + c];
    k->bi[c] = coeffs[6 + c];
  }
  return true;
}

}  // namespace

extern "C" {

// One flip record (masks f, ctrl, z; coeffs[8] in host memory) applied in
// place to one (re1 == im1 == NULL) or two [B, 2^n] state batches.
int qhbm_flip_apply(float* re0, float* im0, float* re1, float* im1, int B,
                    int n, int f, int ctrl, int z, const float* coeffs,
                    void* stream) {
  FlipMasks m;
  FlipCoeffs k;
  if (B < 1 || !flip_args(n, f, ctrl, z, coeffs, &m, &k)) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = re1 != nullptr ? flip_apply_kernel<true>
                               : flip_apply_kernel<false>;
  kernel<<<qhbm_flip_blocks(B, n), kFlipThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(re0, im0, re1, im1, B, n, m,
                                                k);
  return (int)cudaGetLastError();
}

// The batched sweep's flip stage on [B, 2^n] planes a and lambda: both
// un-applied in place by the inverse record (coeffs[0..7]) and out[0] =
// 2 Re sum conj(lam) dU a_before with the derivative record
// (coeffs[8..15]), both in host memory.  `partial` is scratch of `blocks`
// (>= qhbm_flip_blocks(B, n)) floats.
int qhbm_flip_bilinear(float* l_re, float* l_im, float* a_re, float* a_im,
                       int B, int n, int f, int ctrl, int z,
                       const float* coeffs, float* partial, int blocks,
                       float* out, void* stream) {
  FlipMasks m;
  FlipCoeffs inv, d;
  if (B < 1 || !flip_args(n, f, ctrl, z, coeffs, &m, &inv) ||
      !flip_args(n, f, ctrl, z, coeffs + 8, &m, &d)) {
    return (int)cudaErrorInvalidValue;
  }
  const int grid = qhbm_flip_blocks(B, n);
  if (grid > blocks) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  flip_bilinear_kernel<<<grid, kFlipThreads, kFlipSmem, s>>>(
      l_re, l_im, a_re, a_im, B, n, m, inv, d, partial);
  sum_partials_kernel<<<1, 32, 0, s>>>(partial, grid, 1, out);
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
