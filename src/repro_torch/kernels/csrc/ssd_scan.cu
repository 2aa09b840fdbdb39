// Mamba-2 chunked SSD scan for Hopper (sm_90a): kernel K4 of the port.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py (ssd_scan /
// _kernel).  Same function, all in float32: per chunk of Q steps, with
// cum = cumsum(A * dt) over the chunk,
//   y     = w x + exp(cum) (C state^T) + D x,
//           w[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j  for j <= i, else 0
//   state = exp(cum_Q) state + sum_j exp(cum_Q - cum_j) dt_j x_j B_j^T.
// cum falls along the chunk (A < 0, dt > 0), so exp(cum_i - cum_j) can
// overflow for j > i: it is never evaluated there.
//
// Design.  The TPU kernel carries the [hd, ds] state in VMEM scratch across
// its innermost (sequential) chunk grid axis.  Here one block of 256 threads
// owns a (batch row, head, slice of P head-dim columns) and loops over the
// chunks in order itself, holding its [P, ds] float32 state in shared
// memory.  Row p of the state depends only on column p of x, and column p
// of y only on x[:, p] and state[p, :], so slices of hd need no reduction
// across blocks (deterministic, no atomics); each block recomputes the
// [Q, Q] matrix C B^T for its slice, as the Pallas kernel recomputes it per
// head.  Per chunk: stage x, B, C and dt in shared memory as float32; warp 0
// takes the prefix sum; then the masked w tile, y, and the state update.
// Each of the three is a product of shared-memory operands that every
// thread computes as a small register tile (4 x 4, 4 x 2 and 2 x 4 outputs)
// of scalar float32 FMAs, so a loaded value feeds 2-4 FMAs; pitches of
// width + 1 words keep a warp's strided loads on distinct banks.
//
// Bound on this card.  At the zamba2 shape ([1, 2048, 64, 64], ds 64,
// chunk 64) the kernel reads x and writes y once (2 x 16.8 MB in bf16) for
// about 4.3 GFLOP: bytes bound it (0.0103 ms at 3.35 TB/s).  Everything in
// between stays on chip; the scalar products (the block's shared-memory
// loads and FMAs, 128 blocks of 8 warps on 132 SMs) put the kernel well
// above that floor, and mma/wgmma tiles are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_SMEM = 232448;  // 227 KB: a block's dynamic opt-in limit

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Strides {
  long long x_b, x_s, x_h;
  long long dt_b, dt_s, dt_h;
  long long b_b, b_s;
  long long c_b, c_s;
};

// Floats of shared memory per block (kernels/ssd_scan.py smem_bytes / 4).
inline size_t smem_floats(int q, int p, int ds) {
  return (size_t)q * (p + 1) + 2 * (size_t)q * (ds + 1) +
         (size_t)q * (q + 1) + (size_t)p * (ds + 1) + 3 * (size_t)q;
}

// acc[r][c] += sum_{k0 <= k < k1} a[ao[r] + k * ak] * b[bo[c] + k * bk]: one
// thread's TM x TN tile of a product of two shared-memory operands, each
// loaded value reused TN (or TM) times from registers.
template <int TM, int TN>
__device__ __forceinline__ void mm_tile(float (&acc)[TM][TN],
                                        const float* a, const int (&ao)[TM],
                                        int ak, const float* b,
                                        const int (&bo)[TN], int bk, int k0,
                                        int k1) {
  for (int k = k0; k < k1; ++k) {
    float av[TM], bv[TN];
#pragma unroll
    for (int r = 0; r < TM; ++r) av[r] = a[ao[r] + k * ak];
#pragma unroll
    for (int c = 0; c < TN; ++c) bv[c] = b[bo[c] + k * bk];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;
}

template <typename TX, typename TB>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const TB* __restrict__ Bm,
                const TB* __restrict__ Cm, const float* __restrict__ D,
                TX* __restrict__ y, int s, int nh, int hd, int ds, int q,
                int p, Strides st) {
  const int LX = p + 1;   // pitch of the x tile
  const int LB = ds + 1;  // pitch of the B, C and state tiles
  const int LW = q + 1;   // pitch of the w tile
  extern __shared__ float smem[];
  float* sX = smem;             // [q][LX]
  float* sB = sX + q * LX;      // [q][LB]
  float* sC = sB + q * LB;      // [q][LB]
  float* sW = sC + q * LB;      // [q][LW]
  float* sS = sW + q * LW;      // [p][LB]  the state rows of this slice
  float* sDt = sS + p * LB;     // [q]
  float* sCum = sDt + q;        // [q]
  float* sWj = sCum + q;        // [q]  dt_j exp(cum_Q - cum_j)

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * p;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const float a = A[h];
  const float d_skip = D[h];
  const TX* xb = x + bi * st.x_b + h * st.x_h + p0;
  const float* dtb = dt + bi * st.dt_b + h * st.dt_h;
  const TB* bb = Bm + bi * st.b_b;
  const TB* cb = Cm + bi * st.c_b;
  const long long y_s = (long long)nh * hd;  // y is contiguous [b, s, nh, hd]
  TX* yb = y + (long long)bi * s * y_s + (long long)h * hd + p0;

  for (int k = tid; k < p * ds; k += THREADS)
    sS[(k / ds) * LB + k % ds] = 0.f;

  for (int t0 = 0; t0 < s; t0 += q) {
    __syncthreads();  // the previous chunk's readers are done
    for (int k = tid; k < q * p; k += THREADS) {
      const int j = k / p, c = k - j * p;
      sX[j * LX + c] = to_float(xb[(long long)(t0 + j) * st.x_s + c]);
    }
    for (int k = tid; k < q * ds; k += THREADS) {
      const int j = k / ds, c = k - j * ds;
      const long long t = t0 + j;
      sB[j * LB + c] = to_float(bb[t * st.b_s + c]);
      sC[j * LB + c] = to_float(cb[t * st.c_s + c]);
    }
    for (int j = tid; j < q; j += THREADS)
      sDt[j] = dtb[(long long)(t0 + j) * st.dt_s];
    __syncthreads();

    // inclusive prefix sum of a * dt: each lane of warp 0 sums a run of
    // consecutive steps, then the lanes' totals are scanned by shuffles
    if (tid < 32) {
      const int per = (q + 31) / 32;
      const int lo = min(q, tid * per), hi = min(q, lo + per);
      float run = 0.f;
      for (int j = lo; j < hi; ++j) {
        run += a * sDt[j];
        sCum[j] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      const float before = incl - run;
      for (int j = lo; j < hi; ++j) sCum[j] += before;
    }
    __syncthreads();

    const float cum_last = sCum[q - 1];
    for (int j = tid; j < q; j += THREADS)
      sWj[j] = sDt[j] * expf(cum_last - sCum[j]);
    // w = (C B^T) * exp(cum_i - cum_j) * dt_j below the diagonal: 4 x 4
    // tiles, rows i = 4 tm + r, columns j = tn + (q / 4) c
    {
      const int nt = q / 4;
      for (int t = tid; t < nt * nt; t += THREADS) {
        const int tm = t / nt, tn = t - tm * nt;
        int ao[4], bo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) ao[r] = (4 * tm + r) * LB;
#pragma unroll
        for (int c = 0; c < 4; ++c) bo[c] = (tn + nt * c) * LB;
        float g[4][4];
        zero(g);
        mm_tile(g, sC, ao, 1, sB, bo, 1, 0, ds);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 4 * tm + r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = tn + nt * c;
            sW[i * LW + j] =
                j <= i ? g[r][c] * expf(sCum[i] - sCum[j]) * sDt[j] : 0.f;
          }
        }
      }
    }
    __syncthreads();

    // y = w x + exp(cum) (C state^T) + D x: 4 x 2 tiles, rows i = 4 tm + r
    // (w is zero right of row 4 tm + 3), columns tn + (p / 2) c
    {
      const int nn = p / 2;
      for (int t = tid; t < (q / 4) * nn; t += THREADS) {
        const int tm = t / nn, tn = t - tm * nn;
        int wo[4], co[4], xo[2], so[2];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          wo[r] = (4 * tm + r) * LW;
          co[r] = (4 * tm + r) * LB;
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          xo[c] = tn + nn * c;
          so[c] = (tn + nn * c) * LB;
        }
        float intra[4][2], inter[4][2];
        zero(intra);
        zero(inter);
        mm_tile(intra, sW, wo, 1, sX, xo, LX, 0, 4 * tm + 4);
        mm_tile(inter, sC, co, 1, sS, so, 1, 0, ds);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 4 * tm + r;
          const float e = expf(sCum[i]);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = tn + nn * c;
            const float out =
                intra[r][c] + e * inter[r][c] + d_skip * sX[i * LX + col];
            yb[(long long)(t0 + i) * y_s + col] = from_float<TX>(out);
          }
        }
      }
    }
    __syncthreads();  // every reader of x and of the entering state is done

    for (int k = tid; k < q * p; k += THREADS) {
      const int j = k / p, c = k - j * p;
      sX[j * LX + c] *= sWj[j];
    }
    __syncthreads();

    // state = exp(cum_Q) state + (x wj)^T B: 2 x 4 tiles, rows 2 tm + r,
    // columns tn + (ds / 4) c
    {
      const float total = expf(cum_last);
      const int nn = ds / 4;
      for (int t = tid; t < (p / 2) * nn; t += THREADS) {
        const int tm = t / nn, tn = t - tm * nn;
        int ao[2], bo[4];
#pragma unroll
        for (int r = 0; r < 2; ++r) ao[r] = 2 * tm + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) bo[c] = tn + nn * c;
        float acc[2][4];
        zero(acc);
        mm_tile(acc, sX, ao, LX, sB, bo, LB, 0, q);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float* st_rc = sS + (2 * tm + r) * LB + tn + nn * c;
            *st_rc = total * *st_rc + acc[r][c];
          }
      }
    }
  }
}

template <typename TX, typename TB>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, const float* D, void* y,
                   int b, int s, int nh, int hd, int ds, int q, int p,
                   const Strides& st, cudaStream_t stream) {
  const size_t smem = smem_floats(q, p, ds) * sizeof(float);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  static int attr_bytes = 0;  // the dynamic limit set so far
  if ((int)smem > attr_bytes) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<TX, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    attr_bytes = (int)smem;
  }
  dim3 grid(hd / p, nh, b);
  ssd_scan_kernel<TX, TB><<<grid, THREADS, smem, stream>>>(
      static_cast<const TX*>(x), dt, A, static_cast<const TB*>(Bm),
      static_cast<const TB*>(Cm), D, static_cast<TX*>(y), s, nh, hd, ds, q,
      p, st);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t dispatch_bc(int bc_dtype, const void* x, const float* dt,
                        const float* A, const void* Bm, const void* Cm,
                        const float* D, void* y, int b, int s, int nh, int hd,
                        int ds, int q, int p, const Strides& st,
                        cudaStream_t stream) {
  if (bc_dtype == 0)
    return launch<TX, float>(x, dt, A, Bm, Cm, D, y, b, s, nh, hd, ds, q, p,
                             st, stream);
  if (bc_dtype == 1)
    return launch<TX, __nv_bfloat16>(x, dt, A, Bm, Cm, D, y, b, s, nh, hd,
                                     ds, q, p, st, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x_dtype, bc_dtype: 0 = float32, 1 = bfloat16 (x and y; B and C).  dt, A
// and D are float32.  strides: 10 element strides, (batch, seq, head) of x
// and dt, (batch, seq) of B and C; the last axis of each is contiguous.
// hd_slice divides hd; s is a multiple of chunk; chunk, hd_slice and ds
// are multiples of 4 (the register tiles).  Returns the cudaError_t
// of the launch.
int repro_ssd_scan(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, const float* D, void* y,
                   int x_dtype, int bc_dtype, int b, int s, int nh, int hd,
                   int ds, int chunk, int hd_slice, const long long* strides,
                   int device, void* stream) {
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return e;
  if (cur != device) {
    e = cudaSetDevice(device);
    if (e != cudaSuccess) return e;
  }
  if (b <= 0 || nh <= 0 || chunk <= 0 || ds <= 0 || hd_slice <= 0 ||
      hd % hd_slice != 0 || s % chunk != 0 || chunk % 4 != 0 ||
      hd_slice % 4 != 0 || ds % 4 != 0)
    return cudaErrorInvalidValue;
  if (s == 0) return cudaSuccess;
  Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],
             strides[5], strides[6], strides[7], strides[8], strides[9]};
  cudaStream_t sm = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return dispatch_bc<float>(bc_dtype, x, dt, A, Bm, Cm, D, y, b, s, nh, hd,
                              ds, chunk, hd_slice, st, sm);
  if (x_dtype == 1)
    return dispatch_bc<__nv_bfloat16>(bc_dtype, x, dt, A, Bm, Cm, D, y, b, s,
                                      nh, hd, ds, chunk, hd_slice, st, sm);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
