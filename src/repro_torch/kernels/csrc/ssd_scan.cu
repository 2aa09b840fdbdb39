// Mamba-2 chunked SSD scan for Hopper (sm_90a): kernel K4 of the port.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py (ssd_scan /
// _kernel).  Same function: per chunk of Q steps, with cum = cumsum(A * dt)
// over the chunk,
//   y     = w x + exp(cum) (C state^T) + D x,
//           w[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j  for j <= i, else 0
//   state = exp(cum_Q) state + sum_j exp(cum_Q - cum_j) dt_j x_j B_j^T.
// cum falls along the chunk (A < 0, dt > 0), so exp(cum_i - cum_j) can
// overflow for j > i: it is never evaluated there.
//
// Both kernels keep the TPU kernel's sequential chunk grid axis as a loop
// inside one block, which owns a (batch row, head, slice of P head-dim
// columns) and carries its [P, ds] state in float32 from chunk to chunk.
// Row p of the state depends only on column p of x, and column p of y only
// on x[:, p] and state[p, :], so slices of hd need no reduction across
// blocks: no atomics, and two calls on the same inputs give the same bits.
//
// Bound on this card: bytes.  At the zamba2 shape ([1, 2048, 64, 64], ds
// 64, chunk 64) the kernel reads x and writes y once (2 x 16.8 MB in bf16)
// plus B, C and dt, 3.46e7 B in all, for about 4.3 GFLOP: 0.0103 ms at
// 3.35 TB/s against 0.0043 ms of bf16 tensor-core work.
//
// bfloat16 (the main path): a tensor-core kernel, namespace tc.  The
// scalar kernel it replaced spent ~15 us per chunk at the zamba2 shape
// (0.4981 ms, PERF.md), held back by three things; what this design does
// about each:
//  1. Its four products were scalar float32 FMAs on operands widened to
//     float32 in shared memory.  Here all four are mma.sync m16n8k16 (bf16
//     operands, float32 accumulators) on ldmatrix fragments of bf16 tiles:
//     - C B^T takes the bf16 B and C, the rounding of the reference's
//       _ssd_xla_chunked (the wrapper casts float32 B and C when x is bf16);
//     - w = (C B^T) exp(cum_i - cum_j) dt_j is built from the C B^T
//       accumulators and rounded to bf16 as that reference rounds it, into
//       a [Q, Q] tile whose ldmatrix fragments feed w x; exp is taken of
//       -inf above the diagonal (0, never an overflow);
//     - the two state products, float32 in the reference: the float32
//       operand (the state, and x_j dt_j exp(cum_Q - cum_j)) is split
//       into bf16 hi + lo halves against the exact bf16 other operand (C,
//       B), two mma each.  hi + lo carries 16 of float32's 24 mantissa
//       bits, so these products are within ~2^-16 of the float32 ones
//       (relative to the largest term of each sum); the state itself stays
//       in float32 accumulator registers across all chunks and is never
//       rounded, so no error compounds from chunk to chunk.
//  2. It had no overlap between chunks.  Here 4 producer warps bring chunk
//     c + 1's x, B and C in their own dtype by 16-byte cp.async copies into
//     a 2-stage ring while 8 compute warps work on chunk c; the first
//     producer warp also loads chunk c + 1's dt (a strided column) and takes
//     its prefix sum of A dt (a warp-shuffle scan) into double-buffered
//     arrays.  The entering state is double-buffered too, so a chunk costs
//     two __syncthreads (data landed; w complete).
//  3. Its warps waited at 5 barriers per chunk, with the causal [Q, Q] work
//     on whichever thread's rows held it.  Here each phase is spread evenly
//     over the compute warps (w's 16 x 16 blocks round robin; y's 16 x 16
//     tiles with heavy and light causal rows paired; the state's 16 x 16
//     tiles round robin); each phase issues its shared-memory loads first,
//     then its mma and exp, then its stores, and keeps independent sums in
//     separate accumulators: with one block per SM, no other warp hides a
//     load's or an mma's latency.
// The hd slice is HD_SLICE columns (32: 128 blocks on 132 SMs at the zamba2
// shape, C B^T done twice per head).  Measured against 16 and 64 columns,
// 4 and 16 compute warps, 1, 2 and 8 producer warps and a 3-stage ring
// (tools/k4_variants.py, PERF.md section 6): all slower or no faster.  What
// bounds it now is the copies: each block reads 16 KB of B and C per chunk,
// the same 16 KB as every other block, for 4 KB of x, and the compute warps
// wait for them at every chunk.
// Ragged widths (hd slice not 16/32/64, ds not 16/32/64/128) are zero-padded
// in shared memory to the kernel's width, which is exact.  Rows are 16-byte
// copies: every pointer 16-byte aligned, hd and ds multiples of 8, and the
// batch/seq/head strides of x, B and C multiples of 8 elements.
//
// float32: the scalar kernel of the first port (namespace f32), kept for
// the float32 checks: one block of 256 threads per (batch row, head, 32
// columns); per chunk, x, B, C and dt staged as float32 in shared memory,
// then register tiles (4 x 4, 4 x 2, 2 x 4) of scalar float32 FMAs.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_SMEM = 232448;  // 227 KB: a block's dynamic opt-in limit

struct Strides {
  long long x_b, x_s, x_h;
  long long dt_b, dt_s, dt_h;
  long long b_b, b_s;
  long long c_b, c_s;
};

// ---------------------------------------------------------------------------
// float32: scalar kernel
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

template <typename TB>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const TB* __restrict__ Bm,
                const TB* __restrict__ Cm, const float* __restrict__ D,
                float* __restrict__ y, int s, int nh, int hd, int ds, int q,
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
  const float* xb = x + bi * st.x_b + h * st.x_h + p0;
  const float* dtb = dt + bi * st.dt_b + h * st.dt_h;
  const TB* bb = Bm + bi * st.b_b;
  const TB* cb = Cm + bi * st.c_b;
  const long long y_s = (long long)nh * hd;  // y is contiguous [b, s, nh, hd]
  float* yb = y + (long long)bi * s * y_s + (long long)h * hd + p0;

  for (int k = tid; k < p * ds; k += THREADS)
    sS[(k / ds) * LB + k % ds] = 0.f;

  for (int t0 = 0; t0 < s; t0 += q) {
    __syncthreads();  // the previous chunk's readers are done
    for (int k = tid; k < q * p; k += THREADS) {
      const int j = k / p, c = k - j * p;
      sX[j * LX + c] = xb[(long long)(t0 + j) * st.x_s + c];
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
            yb[(long long)(t0 + i) * y_s + col] =
                intra[r][c] + e * inter[r][c] + d_skip * sX[i * LX + col];
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

template <typename TB>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, const float* D, void* y,
                   int b, int s, int nh, int hd, int ds, int q, int p,
                   const Strides& st, cudaStream_t stream) {
  if (q % 4 || p % 4 || ds % 4 || hd % p) return cudaErrorInvalidValue;
  const size_t smem = smem_floats(q, p, ds) * sizeof(float);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  static bool attr_set = false;  // the opt-in limit, the same for every call
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid(hd / p, nh, b);
  ssd_scan_kernel<TB><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(x), dt, A, static_cast<const TB*>(Bm),
      static_cast<const TB*>(Cm), D, static_cast<float*>(y), s, nh, hd, ds,
      q, p, st);
  return cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16: tensor-core kernel
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;      // compute warps
constexpr int PRODUCERS = 4;  // warps that issue the copies
constexpr int THREADS = 32 * (WARPS + PRODUCERS);
constexpr int HD_SLICE = 32;   // head-dim columns per block where hd allows
constexpr int STAGES = 2;      // cp.async ring of chunk tiles
constexpr int PAD = 8;         // bf16 per shared-memory row beyond its width
constexpr int MAX_CHUNK = 128;
// Padded widths the kernel is built for: hd slice 16, 32, 64; ds 16, 32,
// 64, 128 (padded_p, padded_n).

// Head-dim columns per block: HD_SLICE where it divides hd, else 16 where
// that does, else all of hd.
inline int slice_of(int hd) {
  return hd % HD_SLICE == 0 ? HD_SLICE : hd % 16 == 0 ? 16 : hd;
}
inline int padded_p(int p) { return p <= 16 ? 16 : p <= 32 ? 32 : 64; }
inline int padded_n(int ds) {
  return ds <= 16 ? 16 : ds <= 32 ? 32 : ds <= 64 ? 64 : 128;
}

// Shared memory of one block (kernels/ssd_scan.py tc_smem_bytes): STAGES x
// (x [q][pp + PAD], B and C [q][np + PAD] bf16),
// the state entering a chunk twice (hi and lo halves [pp][np + PAD] bf16,
// double buffered), the w tile [q][q + PAD] bf16, and dt, cum and wj [q]
// float, double-buffered.
inline size_t smem_bytes(int q, int pp, int np) {
  return (size_t)STAGES *
             (2 * (size_t)q * (pp + PAD) + 4 * (size_t)q * (np + PAD)) +
         8 * (size_t)pp * (np + PAD) + 2 * (size_t)q * (q + PAD) +
         24 * (size_t)q;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's commit groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a * b for one m16n8k16 tile: bf16 operands, float32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two floats as bf16 hi + lo halves: hi = bf16(v), lo = bf16(v - hi).
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(v0 - hf.x, v1 - hf.y);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Chunk t0's x [q][p], B and C [q][ds] rows into one stage of the ring
// as 16-byte copies, issued by the producer warps (pt: the thread's index
// among them).  Rows are walked in the padded widths' pieces (powers of
// two: no division).
template <int PP, int NP>
__device__ __forceinline__ void load_chunk(bf16* sX, bf16* sB, bf16* sC,
                                           const bf16* xb, const bf16* bb,
                                           const bf16* cb, const Strides& st,
                                           int t0, int q, int p, int ds,
                                           int pt) {
  constexpr int LX = PP + PAD, LN = NP + PAD;
  constexpr int CX = PP / 8, CN = NP / 8;  // 16-byte pieces per padded row
  constexpr int N = 32 * PRODUCERS;
  for (int i = pt; i < q * CX; i += N) {
    const int r = i / CX, c = i % CX;
    if (c * 8 < p)
      cp_async16(smem_addr(sX + r * LX + c * 8),
                 xb + (long long)(t0 + r) * st.x_s + c * 8);
  }
  for (int i = pt; i < q * CN; i += N) {
    const int r = i / CN, c = i % CN;
    if (c * 8 < ds) {
      const long long t = t0 + r;
      cp_async16(smem_addr(sB + r * LN + c * 8), bb + t * st.b_s + c * 8);
      cp_async16(smem_addr(sC + r * LN + c * 8), cb + t * st.c_s + c * 8);
    }
  }
}

// Chunk t0's dt (a strided column) into sdt, cum = its inclusive prefix
// sum of a * dt and wj = dt exp(cum_Q - cum), by one warp: each lane sums a
// run of consecutive steps (at most MAX_CHUNK / 32), the runs' totals are
// scanned by shuffles.
__device__ __forceinline__ void chunk_cum(const float* dtb, long long dt_s,
                                          int t0, int q, float a, int lane,
                                          float* sdt, float* cum, float* wj) {
  constexpr int PER = MAX_CHUNK / 32;
  const int per = (q + 31) / 32;
  const int lo = min(q, lane * per), hi = min(q, lo + per);
  float dv[PER], cv[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u)
    dv[u] = lo + u < hi ? __ldg(dtb + (long long)(t0 + lo + u) * dt_s) : 0.f;
  float run = 0.f;
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    run += a * dv[u];
    cv[u] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  const float before = incl - run;
  float mine = 0.f;  // cum[q - 1], from the lane that holds it
#pragma unroll
  for (int u = 0; u < PER; ++u)
    if (lo + u == q - 1) mine = cv[u] + before;
  const float last = __shfl_sync(0xffffffffu, mine, (q - 1) / per);
#pragma unroll
  for (int u = 0; u < PER; ++u)
    if (lo + u < hi) {
      cum[lo + u] = cv[u] + before;
      wj[lo + u] = dv[u] * expf(last - (cv[u] + before));
      sdt[lo + u] = dv[u];
    }
}

// PP, NP: the padded hd slice and ds.  One block of WARPS compute warps
// and PRODUCERS producer warps per (hd slice, head, batch row), walking the
// chunks in order.  Per chunk, three phases, each spread evenly over the
// compute warps:
//  w:     the 16 x 16 blocks (mt, jb <= mt) of w, round robin, into a bf16
//         [q][q] tile;
//  y:     the (m16 row tile, 16 columns) tiles of y, heavy and light causal
//         tiles paired (flattened order reversed every other round);
//  state: the 16 x 16 tiles of the state, round robin, held in registers.
template <int PP, int NP>
__global__ void __launch_bounds__(THREADS)
ssd_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const bf16* __restrict__ Bm,
              const bf16* __restrict__ Cm, const float* __restrict__ D,
              bf16* __restrict__ y, int s, int nh, int hd, int ds, int q,
              int p, Strides st) {
  constexpr int LX = PP + PAD;  // pitch of the x tile
  constexpr int LN = NP + PAD;  // pitch of the B, C and state tiles
  constexpr int KN = NP / 16;   // k16 steps over ds
  constexpr int DP = PP / 16;   // 16-column tiles of y
  constexpr int NPAIR = DP * KN;                    // 16 x 16 state tiles
  constexpr int SPW = (NPAIR + WARPS - 1) / WARPS;  // ... per warp
  const int LW = q + PAD;                           // pitch of the w tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sX = reinterpret_cast<bf16*>(smem_raw);  // [STAGES][q][LX]
  bf16* sB = sX + STAGES * q * LX;               // [STAGES][q][LN]
  bf16* sC = sB + STAGES * q * LN;               // [STAGES][q][LN]
  bf16* sSh = sC + STAGES * q * LN;              // [2][PP][LN] state, hi
  bf16* sSl = sSh + 2 * PP * LN;                 // [2][PP][LN] state, lo
  bf16* sW = sSl + 2 * PP * LN;                  // [q][LW]
  float* sDt = reinterpret_cast<float*>(sW + q * LW);  // [2][q]
  float* sCum = sDt + 2 * q;                     // [2][q]
  float* sWj = sCum + 2 * q;                     // [2][q]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // accumulator rows g, g + 8
  const int tig = lane & 3;  // accumulator columns 2 tig, 2 tig + 1
  // ldmatrix row/column of this lane (K1's): A and the .trans B use the
  // matrices (rows 0-7, 8-15) x (cols 0-7, 8-15) column-major; the
  // non-trans B and the .trans A (x^T) use (cols ...) x (rows ...).
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 8;

  const int p0 = blockIdx.x * p;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const float a = A[h];
  const float d_skip = D[h];
  const bf16* xb = x + bi * st.x_b + h * st.x_h + p0;
  const float* dtb = dt + bi * st.dt_b + h * st.dt_h;
  const bf16* bb = Bm + bi * st.b_b;
  const bf16* cb = Cm + bi * st.c_b;
  const long long y_s = (long long)nh * hd;  // y is contiguous [b, s, nh, hd]
  bf16* yb = y + (long long)bi * s * y_s + (long long)h * hd + p0;

  // Columns past p and ds stay zero in every stage (copies never reach
  // them): exact padding to the fragments' width.
  const bf16 zero = __float2bfloat16_rn(0.f);
  if (p < PP)
    for (int i = tid; i < STAGES * q * (PP - p); i += THREADS) {
      const int r = i / (PP - p);
      sX[r * LX + p + i - r * (PP - p)] = zero;
    }
  if (ds < NP)
    for (int i = tid; i < STAGES * q * (NP - ds); i += THREADS) {
      const int r = i / (NP - ds), c = ds + i - r * (NP - ds);
      sB[r * LN + c] = zero;
      sC[r * LN + c] = zero;
    }

  const int nc = s / q;
  const int mtq = q / 16;  // m16 row tiles of a chunk
  float sacc[SPW][2][4];   // this warp's 16 x 16 tiles of the state
#pragma unroll
  for (int r = 0; r < SPW; ++r)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[r][nt][e] = 0.f;

  const bool producer = warp >= WARPS;
  const int pt = tid - 32 * WARPS;  // a producer thread's index
  if (producer)  // chunks 0 .. STAGES - 2; one commit group per chunk
    for (int k = 0; k < STAGES - 1; ++k) {
      if (k < nc)
        load_chunk<PP, NP>(sX + k * q * LX, sB + k * q * LN, sC + k * q * LN,
                           xb, bb, cb, st, k * q, q, p, ds, pt);
      cp_async_commit();
    }

  // dt, cum and wj of chunk c are in buffer c & 1, written a chunk ahead
  // by the first producer warp
  if (warp == WARPS) chunk_cum(dtb, st.dt_s, 0, q, a, lane, sDt, sCum, sWj);

  for (int c = 0; c < nc; ++c) {
    const int stg = c % STAGES;  // the ring's stage of chunk c
    const int sb = c & 1;        // the state buffer read by chunk c
    const int t0 = c * q;
    // chunk c has landed; chunks up to c + STAGES - 2 may be in flight
    if (producer) cp_async_wait<STAGES - 2>();
    // Every warp is done with chunk c - 1: its stage may be refilled, the
    // w tile rewritten, and the state written for chunk c is complete.
    __syncthreads();
    if (producer) {
      const int k = c + STAGES - 1, ks = k % STAGES;  // ks: chunk c - 1's
      if (k < nc)
        load_chunk<PP, NP>(sX + ks * q * LX, sB + ks * q * LN,
                           sC + ks * q * LN, xb, bb, cb, st, k * q, q, p, ds,
                           pt);
      cp_async_commit();
      if (warp == WARPS && c + 1 < nc)
        chunk_cum(dtb, st.dt_s, t0 + q, q, a, lane, sDt + (sb ^ 1) * q,
                  sCum + (sb ^ 1) * q, sWj + (sb ^ 1) * q);
    }
    const bf16* tX = sX + stg * q * LX;
    const bf16* tB = sB + stg * q * LN;
    const bf16* tC = sC + stg * q * LN;
    const float* tDt = sDt + sb * q;
    const float* cum = sCum + sb * q;
    const float* wj = sWj + sb * q;
    const float cum_last = cum[q - 1];
    if (!producer) {
      // w = (C B^T) exp(cum_i - cum_j) dt_j, as bf16, block (mt, jb) of 16 x
      // 16.  Above the diagonal the exponent is -inf before exp (w = 0, no
      // overflow, no branch); exp is the fast one, its error (~2^-22 relative
      // and |cum_i - cum_j| 2^-24) far below w's rounding to bf16 (2^-9).
      {
        int k = 0;
        for (int mt = 0; mt < mtq; ++mt)
          for (int jb = 0; jb <= mt; ++jb, ++k) {
            if (k % WARPS != warp) continue;
            uint32_t af[KN][4], bf[KN][4];
#pragma unroll
            for (int ks = 0; ks < KN; ++ks) {
              ldmatrix_x4(af[ks], smem_addr(tC + (mt * 16 + a_row) * LN +
                                            ks * 16 + a_col));
              ldmatrix_x4(bf[ks], smem_addr(tB + (jb * 16 + b_row) * LN +
                                            ks * 16 + b_col));
            }
            const int i0 = mt * 16 + g, j0 = jb * 16 + 2 * tig;
            const float ci[2] = {cum[i0], cum[i0 + 8]};
            float cj[4], dj[4];  // steps j0, j0 + 1, j0 + 8, j0 + 9
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              cj[u] = cum[j0 + (u >> 1) * 8 + (u & 1)];
              dj[u] = tDt[j0 + (u >> 1) * 8 + (u & 1)];
            }
            // C B^T over even and odd k16 steps apart (two short chains)
            float gg[2][4], go[2][4];
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) gg[nt][e] = go[nt][e] = 0.f;
#pragma unroll
            for (int ks = 0; ks < KN; ++ks) {
              float(&acc)[2][4] = ks & 1 ? go : gg;
              mma_bf16(acc[0], af[ks], bf[ks][0], bf[ks][1]);
              mma_bf16(acc[1], af[ks], bf[ks][2], bf[ks][3]);
            }
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) gg[nt][e] += go[nt][e];
            uint32_t wv[2][2];
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int rr = 0; rr < 2; ++rr) {
                float w[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int u = nt * 2 + e;
                  const float arg = j0 + nt * 8 + e <= i0 + rr * 8
                                        ? ci[rr] - cj[u]
                                        : -INFINITY;
                  w[e] = gg[nt][2 * rr + e] * __expf(arg) * dj[u];
                }
                wv[nt][rr] = pack_bf16(w[0], w[1]);
              }
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int rr = 0; rr < 2; ++rr)
                *reinterpret_cast<uint32_t*>(sW + (i0 + rr * 8) * LW + j0 +
                                             nt * 8) = wv[nt][rr];
          }
      }
    }
    __syncthreads();  // the w tile is complete
    if (!producer) {

      // y = w x + exp(cum) (C state^T) + D x, tile (mt, dp): rows mt * 16 ..,
      // columns dp * 16 ..; the state as hi + lo bf16 halves
      const bf16* rSh = sSh + sb * PP * LN;  // the state entering chunk c
      const bf16* rSl = sSl + sb * PP * LN;
      const int ny = mtq * DP;
      for (int rnd = 0; rnd * WARPS < ny; ++rnd) {
        const int k = rnd * WARPS + ((rnd & 1) ? WARPS - 1 - warp : warp);
        if (k >= ny) continue;
        const int mt = k / DP, dp = k - mt * DP;
        const int i0 = mt * 16;
        // three accumulators, three short mma chains: the inter-chunk term
        // against the state's hi and lo halves, and w x
        float acc[2][4], accl[2][4], accw[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[nt][e] = accl[nt][e] = accw[nt][e] = 0.f;
        if (c > 0) {
          uint32_t af[KN][4], bh[KN][4], bl[KN][4];
#pragma unroll
          for (int ks = 0; ks < KN; ++ks) {
            const int off = (dp * 16 + b_row) * LN + ks * 16 + b_col;
            ldmatrix_x4(af[ks], smem_addr(tC + (i0 + a_row) * LN + ks * 16 +
                                          a_col));
            ldmatrix_x4(bh[ks], smem_addr(rSh + off));
            ldmatrix_x4(bl[ks], smem_addr(rSl + off));
          }
          const float e0 = expf(cum[i0 + g]), e1 = expf(cum[i0 + g + 8]);
#pragma unroll
          for (int ks = 0; ks < KN; ++ks) {
            mma_bf16(acc[0], af[ks], bh[ks][0], bh[ks][1]);
            mma_bf16(acc[1], af[ks], bh[ks][2], bh[ks][3]);
            mma_bf16(accl[0], af[ks], bl[ks][0], bl[ks][1]);
            mma_bf16(accl[1], af[ks], bl[ks][2], bl[ks][3]);
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[nt][e] = (acc[nt][e] + accl[nt][e]) * (e < 2 ? e0 : e1);
        }
        // two column blocks of w x per round: their loads, then their mma
        for (int jb = 0; jb <= mt; jb += 2) {
          const bool two = jb + 1 <= mt;
          uint32_t wa[2][4], b[2][4];
          ldmatrix_x4(wa[0], smem_addr(sW + (i0 + a_row) * LW + jb * 16 +
                                       a_col));
          ldmatrix_x4_trans(b[0], smem_addr(tX + (jb * 16 + a_row) * LX +
                                            dp * 16 + a_col));
          if (two) {
            ldmatrix_x4(wa[1], smem_addr(sW + (i0 + a_row) * LW + jb * 16 +
                                         16 + a_col));
            ldmatrix_x4_trans(b[1], smem_addr(tX + (jb * 16 + 16 + a_row) *
                                                       LX + dp * 16 + a_col));
          }
          mma_bf16(accw[0], wa[0], b[0][0], b[0][1]);
          mma_bf16(accw[1], wa[0], b[0][2], b[0][3]);
          if (two) {
            mma_bf16(accw[0], wa[1], b[1][0], b[1][1]);
            mma_bf16(accw[1], wa[1], b[1][2], b[1][3]);
          }
        }
        // w x + exp(cum) (C state^T) + D x, as bf16 pairs to y
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = dp * 16 + nt * 8 + 2 * tig;
          if (col < p) {
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int i = i0 + g + rr * 8;
              const float2 xv = unpack_bf16(
                  *reinterpret_cast<const uint32_t*>(tX + i * LX + col));
              *reinterpret_cast<uint32_t*>(yb + (long long)(t0 + i) * y_s +
                                           col) =
                  pack_bf16(accw[nt][2 * rr] + acc[nt][2 * rr] +
                                d_skip * xv.x,
                            accw[nt][2 * rr + 1] + acc[nt][2 * rr + 1] +
                                d_skip * xv.y);
            }
          }
        }
      }

      // state = exp(cum_Q) state + (x wj)^T B: this warp's 16 x 16 tiles k =
      // warp + WARPS r, rows ms = k / KN of the slice, columns ns = k % KN of
      // ds, interleaved over the steps jb; x wj as hi + lo bf16 halves.  The
      // result, split likewise, goes to the other state buffer, read by
      // chunk c + 1.
      const float total = expf(cum_last);
#pragma unroll
      for (int r = 0; r < SPW; ++r)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[r][nt][e] *= total;
      float slo[SPW][2][4];  // the lo halves' products, a chain of their own
#pragma unroll
      for (int r = 0; r < SPW; ++r)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) slo[r][nt][e] = 0.f;
      for (int jb = 0; jb < mtq; ++jb) {
        // x fragments: xa[0], xa[1] hold steps j, j + 1; xa[2], xa[3] j + 8,
        // j + 9
        const int j = jb * 16 + 2 * tig;
        uint32_t xa[SPW][4], b[SPW][4];
#pragma unroll
        for (int r = 0; r < SPW; ++r) {
          const int k = warp + WARPS * r;
          if (k < NPAIR) {
            const int ms = k / KN, ns = k - ms * KN;
            ldmatrix_x4_trans(xa[r], smem_addr(tX + (jb * 16 + b_row) * LX +
                                               ms * 16 + b_col));
            ldmatrix_x4_trans(b[r], smem_addr(tB + (jb * 16 + a_row) * LN +
                                              ns * 16 + a_col));
          }
        }
        const float w0 = wj[j], w1 = wj[j + 1];
        const float w8 = wj[j + 8], w9 = wj[j + 9];
#pragma unroll
        for (int r = 0; r < SPW; ++r) {
          if (warp + WARPS * r < NPAIR) {
            uint32_t ahi[4], alo[4];
#pragma unroll
            for (int rg = 0; rg < 4; ++rg) {
              const float2 v = unpack_bf16(xa[r][rg]);
              const bool up = rg >= 2;
              split_bf16(v.x * (up ? w8 : w0), v.y * (up ? w9 : w1), ahi[rg],
                         alo[rg]);
            }
            mma_bf16(sacc[r][0], ahi, b[r][0], b[r][1]);
            mma_bf16(sacc[r][1], ahi, b[r][2], b[r][3]);
            mma_bf16(slo[r][0], alo, b[r][0], b[r][1]);
            mma_bf16(slo[r][1], alo, b[r][2], b[r][3]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < SPW; ++r)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[r][nt][e] += slo[r][nt][e];
      bf16* wSh = sSh + (sb ^ 1) * PP * LN;
      bf16* wSl = sSl + (sb ^ 1) * PP * LN;
#pragma unroll
      for (int r = 0; r < SPW; ++r) {
        const int k = warp + WARPS * r;
        if (k < NPAIR) {
          const int ms = k / KN, ns = k - ms * KN;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int off =
                  (ms * 16 + g + rr * 8) * LN + ns * 16 + nt * 8 + 2 * tig;
              uint32_t hi, lo;
              split_bf16(sacc[r][nt][2 * rr], sacc[r][nt][2 * rr + 1], hi, lo);
              *reinterpret_cast<uint32_t*>(wSh + off) = hi;
              *reinterpret_cast<uint32_t*>(wSl + off) = lo;
            }
        }
      }
    }
  }
}

template <int PP, int NP>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, const float* D, void* y,
                   int b, int s, int nh, int hd, int ds, int q, int p,
                   const Strides& st, cudaStream_t stream) {
  const size_t smem = smem_bytes(q, PP, NP);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  static bool attr_set = false;  // the opt-in limit, the same for every call
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_tc_kernel<PP, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid(hd / p, nh, b);
  ssd_tc_kernel<PP, NP><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), D, static_cast<bf16*>(y), s, nh, hd, ds,
      q, p, st);
  return cudaGetLastError();
}

template <int PP>
cudaError_t launch_n(const void* x, const float* dt, const float* A,
                     const void* Bm, const void* Cm, const float* D, void* y,
                     int b, int s, int nh, int hd, int ds, int q, int p,
                     const Strides& st, cudaStream_t stream) {
  switch (padded_n(ds)) {
    case 16:
      return launch<PP, 16>(x, dt, A, Bm, Cm, D, y, b, s, nh, hd, ds, q, p,
                            st, stream);
    case 32:
      return launch<PP, 32>(x, dt, A, Bm, Cm, D, y, b, s, nh, hd, ds, q, p,
                            st, stream);
    case 64:
      return launch<PP, 64>(x, dt, A, Bm, Cm, D, y, b, s, nh, hd, ds, q, p,
                            st, stream);
    default:
      return launch<PP, 128>(x, dt, A, Bm, Cm, D, y, b, s, nh, hd, ds, q, p,
                             st, stream);
  }
}

// What the kernel takes: chunk a multiple of 16 up to MAX_CHUNK, the hd
// slice slice_of(hd) of at most 64 columns, ds up to 128, 16-byte rows.
cudaError_t dispatch(const void* x, const float* dt, const float* A,
                     const void* Bm, const void* Cm, const float* D, void* y,
                     int b, int s, int nh, int hd, int ds, int q, int p,
                     const Strides& st, cudaStream_t stream) {
  if (q % 16 || q > MAX_CHUNK || p != slice_of(hd) || p > 64 || p % 8 ||
      ds > 128 || ds % 8)
    return cudaErrorInvalidValue;
  const long long strides[8] = {st.x_b, st.x_s, st.x_h, st.b_b,
                                st.b_s, st.c_b, st.c_s, hd};
  for (long long v : strides)
    if (v % 8) return cudaErrorMisalignedAddress;
  if (((uintptr_t)x | (uintptr_t)Bm | (uintptr_t)Cm | (uintptr_t)y) % 16)
    return cudaErrorMisalignedAddress;
  switch (padded_p(p)) {
    case 16:
      return launch_n<16>(x, dt, A, Bm, Cm, D, y, b, s, nh, hd, ds, q, p, st,
                          stream);
    case 32:
      return launch_n<32>(x, dt, A, Bm, Cm, D, y, b, s, nh, hd, ds, q, p, st,
                          stream);
    default:
      return launch_n<64>(x, dt, A, Bm, Cm, D, y, b, s, nh, hd, ds, q, p, st,
                          stream);
  }
}

}  // namespace tc

}  // namespace

extern "C" {

// x_dtype, bc_dtype: 0 = float32, 1 = bfloat16 (x and y; B and C).  dt, A
// and D are float32.  float32 x takes the scalar kernel with float32 or
// bf16 B and C; bf16 x the tensor-core kernel with bf16 B and C.  strides:
// 10 element strides, (batch, seq, head) of x and dt, (batch, seq) of B and
// C; the last axis of each is contiguous.  s is a multiple of chunk;
// hd_slice divides hd (scalar kernel: chunk, hd_slice and ds multiples of
// 4; tensor-core kernel: see tc::dispatch).  Returns the cudaError_t of
// the launch.
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
      hd % hd_slice != 0 || s % chunk != 0)
    return cudaErrorInvalidValue;
  if (s == 0) return cudaSuccess;
  Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],
             strides[5], strides[6], strides[7], strides[8], strides[9]};
  cudaStream_t sm = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && bc_dtype == 0)
    return f32::launch<float>(x, dt, A, Bm, Cm, D, y, b, s, nh, hd, ds,
                              chunk, hd_slice, st, sm);
  if (x_dtype == 0 && bc_dtype == 1)
    return f32::launch<__nv_bfloat16>(x, dt, A, Bm, Cm, D, y, b, s, nh, hd,
                                      ds, chunk, hd_slice, st, sm);
  if (x_dtype == 1 && bc_dtype == 1)
    return tc::dispatch(x, dt, A, Bm, Cm, D, y, b, s, nh, hd, ds, chunk,
                        hd_slice, st, sm);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
