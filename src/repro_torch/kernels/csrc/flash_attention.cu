// Flash-attention forward for Hopper (sm_90a): kernel K1 of the port (its
// bf16 backward, K1b, is namespace bwd below).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_fwd / _kernel).  Same function: causal or sliding-window
// GQA attention, q pre-scaled by hd**-0.5, query and key positions
// arange(sq) / arange(sk), online softmax (m, l, acc) in float32, fully
// masked key tiles skipped (the Pallas `run` predicate).  Unlike the Pallas
// kernel it also writes the row log-sum-exp (lse = m + log l), which the
// plain backward reads.
//
// Bound on this card: operations.  Causal attention at the training shape
// does 2*b*hq*sq^2*hd FLOP (QK^T and PV, half the square each) on
// O(b*h*s*hd) bytes, far above the ridge, so the floor is the bf16
// tensor-core rate, 989 TFLOP/s.
//
// bfloat16 (the main path): a FlashAttention-2-style kernel on the tensor
// cores.  One block of 4 warps per (BLOCK_M query rows, query head, batch
// row); each warp owns BLOCK_M/4 rows and loops over 64-key tiles.
// Head_dim 256 (gemma3) would need 128 registers a thread for the O
// accumulator alone, so there the block has 8 warps in two column groups:
// warps w and w + 4 own the same 16 rows, both compute their S (and the
// same softmax, bit for bit), and each accumulates half of O's columns;
// Q stays in shared memory and its fragments are loaded at every k-step.
//  - Both products are mma.sync m16n8k16 (bf16 in, float32 accumulate).
//    S = Q K^T takes Q fragments loaded once per block by ldmatrix (up to
//    hd 128) and K fragments by ldmatrix; O += P V takes P straight from the S registers
//    (the accumulator layout of two n8 tiles is the A layout of one k16
//    step), rounded to bf16, and V fragments by ldmatrix.trans.
//  - K and V tiles stay bf16 in shared memory, filled by 16-byte cp.async
//    copies in a 2-stage ring: the next tile's loads are in flight while
//    the current one computes.  Rows are padded by 8 bf16 (16 B), which
//    puts the 8 rows of every ldmatrix phase on 8 distinct 16-byte bank
//    groups for every head dim (pitches 80, 144, 208, 272, 528 B).
//  - The online softmax stays in float32 registers: the row max across the
//    quad that shares a row by shuffles, l summed from the unrounded p and
//    reduced once at the end.  Masks are evaluated only on tiles that
//    straddle a causal, window or ragged edge; a warp skips a tile that is
//    masked for all its rows.
//  - Query tiles go out heaviest first (the longest causal rows in the
//    first wave), and the output leaves through shared memory as 16-byte
//    stores.  No atomics and a fixed reduction order: two calls on the
//    same inputs give the same bits.
// float32: a scalar kernel (64x64 tiles of float32 FMAs in shared memory),
// kept for the float32 checks, which TF32 tensor cores could not meet; it
// also takes head_dim 16, the reduced configs' (the bf16 kernel's k16 steps
// and 16-byte rows start at 32).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

struct Strides {
  long long q_b, q_h, q_s;
  long long k_b, k_h, k_s;
  long long v_b, v_h, v_s;
  long long o_b, o_h, o_s;
};

// ---------------------------------------------------------------------------
// float32: scalar kernel
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int BLOCK_M = 64;
constexpr int BLOCK_N = 64;
constexpr int THREADS = 256;
constexpr int LP = BLOCK_N + 1;  // pitch of the probability tile

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(3 * BLOCK_M * (HD + 1) + BLOCK_M * LP);
}

// Thread (ty, tx) owns query rows 4*ty..4*ty+3, score columns tx + 16*j
// and output columns tx + 16*j; tiles are float32 with a pitch of hd + 1
// words so that the column walks hit 16 distinct banks.
template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, int hq, int group,
                 Strides st, int causal, int window) {
  constexpr int LD = HD + 1;
  constexpr int DPT = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                // [BLOCK_M][LD]
  float* sK = sQ + BLOCK_M * LD;   // [BLOCK_N][LD]
  float* sV = sK + BLOCK_N * LD;   // [BLOCK_N][LD]
  float* sP = sV + BLOCK_N * LD;   // [BLOCK_M][LP]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.x * BLOCK_M;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int hk = h / group;

  const float* qb = q + bi * st.q_b + h * st.q_h;
  const float* kb = k + bi * st.k_b + hk * st.k_h;
  const float* vb = v + bi * st.v_b + hk * st.v_h;

  for (int idx = tid; idx < BLOCK_M * HD; idx += THREADS) {
    const int r = idx / HD;
    const int d = idx - r * HD;
    const int qr = m0 + r;
    sQ[r * LD + d] = qr < sq ? qb[qr * st.q_s + d] : 0.f;
  }

  float m_i[4], l_i[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) acc[i][jd] = 0.f;
  }

  // Key tiles that can hold an unmasked entry for some row of this tile.
  int n_end = sk;
  if (causal) n_end = min(sk, m0 + BLOCK_M);
  int n_begin = 0;
  if (window > 0) {
    const int first = m0 - window + 1;
    if (first > 0) n_begin = (first / BLOCK_N) * BLOCK_N;
  }

  for (int n0 = n_begin; n0 < n_end; n0 += BLOCK_N) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BLOCK_N * HD; idx += THREADS) {
      const int r = idx / HD;
      const int d = idx - r * HD;
      const int kr = n0 + r;
      const bool ok = kr < sk;
      sK[r * LD + d] = ok ? kb[kr * st.k_s + d] : 0.f;
      sV[r * LD + d] = ok ? vb[kr * st.v_s + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = m0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = n0 + tx + 16 * j;
        const bool valid = kp < sk && (!causal || qp >= kp) &&
                           (window <= 0 || qp - kp < window);
        s[i][j] = valid ? s[i][j] : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float corr = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == NEG_INF ? 0.f : expf(s[i][j] - m_new);
        rs += p;
        sP[(ty * 4 + i) * LP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = l_i[i] * corr + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < DPT; ++jd) acc[i][jd] *= corr;
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < BLOCK_N; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * LP + c];
#pragma unroll
      for (int jd = 0; jd < DPT; ++jd) {
        const float vv = sV[c * LD + tx + 16 * jd];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jd] = fmaf(pv[i], vv, acc[i][jd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = m0 + ty * 4 + i;
    if (qr < sq) {
      const float l = fmaxf(l_i[i], 1e-30f);
      float* orow = o + bi * st.o_b + h * st.o_h + qr * st.o_s;
#pragma unroll
      for (int jd = 0; jd < DPT; ++jd) orow[tx + 16 * jd] = acc[i][jd] / l;
      if (tx == 0) lse[((long long)bi * hq + h) * sq + qr] = m_i[i] + logf(l);
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int hq, int hkv, int sq, int sk,
                   const Strides& st, int causal, int window,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid((sq + BLOCK_M - 1) / BLOCK_M, hq, b);
  flash_fwd_kernel<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, sq, sk, hq,
      hq / hkv, st, causal, window);
  return cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16: tensor-core kernel
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;   // warps of one column group (rows of a block)
constexpr int BLOCK_N = 64;  // keys per tile
constexpr int PAD = 8;       // bf16 per shared-memory row beyond hd
constexpr float LOG2E = 1.4426950408889634f;

// Query rows per block: 128 (two m16 tiles per warp) while Q fragments,
// S and O fit the registers, 64 beyond.  Measured on an H100 at the
// training shapes (PERF.md, section 6, "BLOCK_M"): 64 rows are the faster
// at hd 96 (gpt3), 128 rows at hd 64 (zamba2).
template <int HD>
__host__ __device__ constexpr int block_m() {
  return HD <= 64 ? 128 : 64;
}

// Q fragments held in registers for the whole block (beside S and the O
// accumulator), or loaded from shared memory at every k-step (hd 256).
template <int HD>
__host__ __device__ constexpr bool q_in_regs() {
  return HD <= 128;
}

// Column groups: warp groups of WARPS that share the block's rows and
// split O's columns (2 at hd 256: 64 accumulator registers a thread).
template <int HD>
__host__ __device__ constexpr int col_groups() {
  return HD <= 128 ? 1 : 2;
}

template <int HD>
__host__ __device__ constexpr int threads() {
  return 32 * WARPS * col_groups<HD>();
}

template <int HD>
constexpr size_t smem_bytes() {
  // Q [BLOCK_M][LD], then a 2-stage ring of K [BLOCK_N][LD], V [BLOCK_N][LD]
  return sizeof(bf16) * (size_t)(block_m<HD>() + 4 * BLOCK_N) * (HD + PAD);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; a row past the edge is filled with zeros
// (src-size 0) from a valid address.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

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

// ROWS rows of hd bf16 from src (row stride `stride`, rows from row0,
// valid below `limit`) into dst [ROWS][HD + PAD], as 16-byte copies.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int row0,
                                          int limit, int tid) {
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  constexpr int THREADS = threads<HD>();
  static_assert((ROWS * CH) % THREADS == 0, "tile copy must divide evenly");
#pragma unroll
  for (int i = 0; i < ROWS * CH / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int r = idx / CH;
    const int c = idx - r * CH;
    const bool ok = row0 + r < limit;
    const bf16* g = ok ? src + (row0 + r) * stride + c * 8 : src;
    cp_async16(smem_addr(dst + r * (HD + PAD) + c * 8), g, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(threads<HD>())
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, int hq, int group,
                 Strides st, int causal, int window) {
  constexpr int BM = block_m<HD>();
  constexpr int THREADS = threads<HD>();
  constexpr int MT = BM / (16 * WARPS);  // m16 tiles per warp
  constexpr int LD = HD + PAD;
  constexpr int KS = HD / 16;       // k16 steps of Q K^T
  constexpr int NT = BLOCK_N / 8;   // n8 tiles of S
  constexpr int DT = HD / 8 / col_groups<HD>();  // n8 tiles of this O part
  constexpr int CH = HD / 8;        // 16-byte chunks per row
  constexpr bool QREG = q_in_regs<HD>();
  static_assert(MT == 1 || MT == 2, "BLOCK_M is 64 or 128");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [BM][LD]; then O
  bf16* sK = sQ + BM * LD;                       // [2][BLOCK_N][LD]
  bf16* sV = sK + 2 * BLOCK_N * LD;              // [2][BLOCK_N][LD]

  const int tid = threadIdx.x;
  const int warp = (tid >> 5) % WARPS;  // this warp's rows in the block
  const int col0 = (tid >> 5) / WARPS * DT * 8;  // its first O column
  const int lane = tid & 31;
  const int h = blockIdx.x;
  const int bi = blockIdx.y;
  const int m0 = (gridDim.z - 1 - blockIdx.z) * BM;  // heaviest tile first
  const int hk = h / group;

  const bf16* qb = q + bi * st.q_b + h * st.q_h;
  const bf16* kb = k + bi * st.k_b + hk * st.k_h;
  const bf16* vb = v + bi * st.v_b + hk * st.v_h;

  // Key tiles that can hold an unmasked entry for some row of this tile.
  const int n_end = causal ? min(sk, m0 + BM) : sk;
  int n_begin = 0;
  if (window > 0) {
    const int first = m0 - window + 1;
    if (first > 0) n_begin = (first / BLOCK_N) * BLOCK_N;
  }
  const int n_tiles =
      n_end > n_begin ? (n_end - n_begin + BLOCK_N - 1) / BLOCK_N : 0;

  load_tile<HD, BM>(sQ, qb, st.q_s, m0, sq, tid);
  cp_async_commit();
  if (n_tiles > 0) {
    load_tile<HD, BLOCK_N>(sK, kb, st.k_s, n_begin, sk, tid);
    load_tile<HD, BLOCK_N>(sV, vb, st.v_s, n_begin, sk, tid);
  }
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed; the first K/V tile may be in flight
  __syncthreads();

  // This warp's rows: wr0 .. wr0 + 16*MT - 1; thread rows g and g + 8 of
  // each m16 tile, g = lane / 4 (the mma accumulator layout).
  const int wr0 = m0 + warp * 16 * MT;
  const int wr1 = wr0 + 16 * MT - 1;
  const int g = lane >> 2;
  const int tig = lane & 3;
  // ldmatrix row/column of this lane: A (Q) and V.trans use matrices
  // (rows 0-7, 8-15) x (cols 0-7, 8-15) column-major; K uses them
  // (cols 0-7, 8-15) x (rows 0-7, 8-15).
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 8;

  // This lane's ldmatrix address of the warp's Q rows at k-step ks.
  const bf16* q_lane = sQ + (warp * 16 * MT + a_row) * LD + a_col;
  uint32_t qf[MT][QREG ? KS : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldmatrix_x4(qf[mt][ks], smem_addr(q_lane + mt * 16 * LD + ks * 16));
  }

  float m_r[MT][2], l_r[MT][2], acc[MT][DT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      m_r[mt][rr] = NEG_INF;
      l_r[mt][rr] = 0.f;
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][dt][e] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int n0 = n_begin + it * BLOCK_N;
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      load_tile<HD, BLOCK_N>(sK + (stage ^ 1) * BLOCK_N * LD, kb, st.k_s,
                             n0 + BLOCK_N, sk, tid);
      load_tile<HD, BLOCK_N>(sV + (stage ^ 1) * BLOCK_N * LD, vb, st.v_s,
                             n0 + BLOCK_N, sk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed; the next is in flight
    __syncthreads();

    const bf16* tK = sK + stage * BLOCK_N * LD;
    const bf16* tV = sV + stage * BLOCK_N * LD;
    // A tile after every row of the warp (causal), or before every row's
    // window, holds nothing for it.
    const bool idle = (causal && n0 > wr1) ||
                      (window > 0 && n0 + BLOCK_N - 1 <= wr0 - window);
    if (!idle) {
      float s[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t qa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (QREG) {
#pragma unroll
            for (int e = 0; e < 4; ++e) qa[mt][e] = qf[mt][ks][e];
          } else {
            ldmatrix_x4(qa[mt], smem_addr(q_lane + mt * 16 * LD + ks * 16));
          }
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          ldmatrix_x4(b, smem_addr(tK + (np * 16 + b_row) * LD + ks * 16 +
                                   b_col));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][2 * np], qa[mt], b[0], b[1]);
            mma_bf16(s[mt][2 * np + 1], qa[mt], b[2], b[3]);
          }
        }
      }

      // Masks only where the tile crosses the ragged end, the diagonal or
      // the window's edge for some row of this warp.
      const bool edge = n0 + BLOCK_N > sk ||
                        (causal && n0 + BLOCK_N - 1 > wr0) ||
                        (window > 0 && wr1 - n0 >= window);
      if (edge) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = wr0 + mt * 16 + g + (e >> 1) * 8;
              const int key = n0 + nt * 8 + tig * 2 + (e & 1);
              const bool ok = key < sk && (!causal || key <= row) &&
                              (window <= 0 || row - key < window);
              if (!ok) s[mt][nt][e] = NEG_INF;
            }
      }

      uint32_t pa[MT][BLOCK_N / 16][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float mx = m_r[mt][rr];
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mx = fmaxf(mx, fmaxf(s[mt][nt][2 * rr], s[mt][nt][2 * rr + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          // A row with no valid key yet keeps m = NEG_INF; its masked
          // scores then take exp2(NEG_INF * LOG2E) = 0, never exp2(0).
          const float ms = mx == NEG_INF ? 0.f : mx * LOG2E;
          const float corr = exp2f(m_r[mt][rr] * LOG2E - ms);
          float rs = 0.f;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 2 * rr; e < 2 * rr + 2; ++e) {
              const float p = exp2f(fmaf(s[mt][nt][e], LOG2E, -ms));
              s[mt][nt][e] = p;
              rs += p;
            }
          l_r[mt][rr] = l_r[mt][rr] * corr + rs;
          m_r[mt][rr] = mx;
#pragma unroll
          for (int dt = 0; dt < DT; ++dt) {
            acc[mt][dt][2 * rr] *= corr;
            acc[mt][dt][2 * rr + 1] *= corr;
          }
        }
#pragma unroll
        for (int t = 0; t < BLOCK_N / 16; ++t) {
          pa[mt][t][0] = pack_bf16(s[mt][2 * t][0], s[mt][2 * t][1]);
          pa[mt][t][1] = pack_bf16(s[mt][2 * t][2], s[mt][2 * t][3]);
          pa[mt][t][2] = pack_bf16(s[mt][2 * t + 1][0], s[mt][2 * t + 1][1]);
          pa[mt][t][3] = pack_bf16(s[mt][2 * t + 1][2], s[mt][2 * t + 1][3]);
        }
      }

#pragma unroll
      for (int t = 0; t < BLOCK_N / 16; ++t) {
#pragma unroll
        for (int dp = 0; dp < DT / 2; ++dp) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, smem_addr(tV + (t * 16 + a_row) * LD +
                                         col0 + dp * 16 + a_col));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][2 * dp], pa[mt][t], b[0], b[1]);
            mma_bf16(acc[mt][2 * dp + 1], pa[mt][t], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with sQ (and the ring): reuse it

  // Epilogue: O / l as bf16 into shared memory, lse per row, then 16-byte
  // stores of whole rows.
  bf16* sO = sQ;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float l = l_r[mt][rr];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      l = fmaxf(l, 1e-30f);
      const float inv = 1.f / l;
      const int r = warp * 16 * MT + mt * 16 + g + rr * 8;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
        *reinterpret_cast<uint32_t*>(sO + r * LD + col0 + dt * 8 +
                                     tig * 2) =
            pack_bf16(acc[mt][dt][2 * rr] * inv,
                      acc[mt][dt][2 * rr + 1] * inv);
      if (tig == 0 && col0 == 0 && m0 + r < sq)
        lse[((long long)bi * hq + h) * sq + m0 + r] = m_r[mt][rr] + logf(l);
    }
  }
  __syncthreads();
  bf16* ob = o + bi * st.o_b + h * st.o_h;
#pragma unroll
  for (int i = 0; i < BM * CH / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int r = idx / CH;
    const int c = idx - r * CH;
    if (m0 + r < sq)
      *reinterpret_cast<uint4*>(ob + (m0 + r) * st.o_s + c * 8) =
          *reinterpret_cast<const uint4*>(sO + r * LD + c * 8);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int hq, int hkv, int sq, int sk,
                   const Strides& st, int causal, int window,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  constexpr int BM = block_m<HD>();
  dim3 grid(hq, b, (sq + BM - 1) / BM);
  flash_fwd_kernel<HD><<<grid, threads<HD>(), smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, sq, sk, hq,
      hq / hkv, st, causal, window);
  return cudaGetLastError();
}

// 16-byte copies need 16-byte aligned rows: every pointer, and every
// batch, head and seq stride a multiple of 8 elements.
bool aligned16(const void* q, const void* k, const void* v, const void* o,
               const Strides& st) {
  const long long s[12] = {st.q_b, st.q_h, st.q_s, st.k_b, st.k_h, st.k_s,
                           st.v_b, st.v_h, st.v_s, st.o_b, st.o_h, st.o_s};
  for (long long x : s)
    if (x % 8) return false;
  return ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 ==
         0;
}

}  // namespace tc

// ---------------------------------------------------------------------------
// bfloat16: the backward (K1b), dq then dk/dv
// ---------------------------------------------------------------------------
// Gradient of the tensor-core forward w.r.t. q, k and v, from its saved out
// and lse (FlashAttention-2's backward, without atomics).  Replaces no TPU
// kernel: the reference backs its Pallas forward with the XLA VJP
// `_blocked_attention_bwd`, which the port's `flash_attention_bwd_plain`
// copies in float32 products.  The products here are the same ones on the
// tensor cores: every operand is bf16 there too (q, k, v, dout, bf16(P),
// bf16(dS)), so bf16 mma.sync with float32 accumulation keeps its rounding
// points; only the order of the float32 sums differs.
//
// Bound on this card: operations (five products of 2*hd FLOP per unmasked
// pair, on O(b*h*s*hd) bytes).  Two launches, three under GQA, each output
// element owned by one thread and summed in a fixed order, so two calls
// give the same bits:
//  - flash_bwd_dq_kernel: one block of 4 warps per (64 query rows, query
//    head, batch row), heaviest causal rows first.  It first writes
//    delta = rowsum(dout * out) in float32 for its rows (the dk/dv pass
//    reads it), then walks the unmasked 64-key tiles through a 2-stage
//    cp.async ring of K and V: S = Q K^T, P = exp(S - lse), dP = dO V^T,
//    dS = P (dP - delta), dQ += bf16(dS) K; dQ * dq_scale is rounded once.
//  - flash_bwd_dkdv_kernel: one block of 4 warps per (64 keys, query head,
//    batch row), the lowest keys (the most causal queries) first; each warp
//    owns 16 keys.  It walks the query tiles that hold an unmasked pair
//    with its keys, Q, dO, lse and delta streaming through a 2-stage ring:
//    S^T = K Q^T, P^T, dV += bf16(P^T) dO, dP^T = V dO^T, dS^T, dK +=
//    bf16(dS^T) Q.  dK and dV stay float32 in registers and are rounded
//    once; under GQA (group > 1) they leave as float32 partials of the one
//    query head, so that the grid has a block per query head and not per
//    kv head (qwen2-vl's 12/2 would fill only 128 of the card's 132 SMs
//    with 4 warps each), and
//  - flash_bwd_group_sum_kernel adds each kv head's partials over its
//    group's query heads in order and rounds once.
// Head dim 256 splits dQ, dK and dV's columns over two groups of 4 warps,
// as the forward splits O: each group computes S and dP whole.  Tiles are
// skipped or masked by the forward's predicates.
namespace bwd {

using tc::bf16;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::ldmatrix_x4;
using tc::ldmatrix_x4_trans;
using tc::load_tile;
using tc::mma_bf16;
using tc::pack_bf16;
using tc::smem_addr;

constexpr int WARPS = 4;
constexpr int PAD = tc::PAD;
constexpr float LOG2E = tc::LOG2E;
// keys per tile of the dq pass and per block of the dk/dv pass
constexpr int BLOCK_N = 64;
// query rows per block of the dq pass (16 a warp)
constexpr int DQ_BLOCK_M = 64;

// Query rows per tile of the dk/dv pass: 64 while dK, dV, S^T and dP^T fit
// the registers beside each other, 32 beyond.
template <int HD>
__host__ __device__ constexpr int kv_block_m() {
  return HD <= 64 ? 64 : 32;
}

template <int HD>
__host__ __device__ constexpr int col_groups() {
  return HD <= 128 ? 1 : 2;
}

template <int HD>
__host__ __device__ constexpr int threads() {
  return 32 * WARPS * col_groups<HD>();
}

// The fixed operand of each pass (Q and dO in the dq pass, K and V in the
// dk/dv pass) held as fragments in registers, or loaded from shared memory
// at every k-step.
template <int HD>
__host__ __device__ constexpr bool frags_in_regs() {
  return HD <= 64;
}

template <int HD>
constexpr size_t dq_smem_bytes() {
  // Q, dO [DQ_BLOCK_M][LD]; a 2-stage ring of K, V [BLOCK_N][LD]; delta
  return sizeof(bf16) * (size_t)(2 * DQ_BLOCK_M + 4 * BLOCK_N) * (HD + PAD) +
         sizeof(float) * DQ_BLOCK_M;
}

template <int HD>
constexpr size_t dkdv_smem_bytes() {
  // K, V [BLOCK_N][LD]; a 2-stage ring of Q, dO [BM][LD], lse and delta [BM]
  constexpr int BM = kv_block_m<HD>();
  return sizeof(bf16) * (size_t)(2 * BLOCK_N + 4 * BM) * (HD + PAD) +
         sizeof(float) * 4 * BM;
}

struct BwdStrides {
  long long q_b, q_h, q_s;
  long long k_b, k_h, k_s;
  long long v_b, v_h, v_s;
  long long o_b, o_h, o_s;
  long long do_b, do_h, do_s;
  long long dq_b, dq_h, dq_s;
  long long dk_b, dk_h, dk_s;
  long long dv_b, dv_h, dv_s;
};

// 4-byte global -> shared copy (zeros past the edge).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ bool valid_pair(int row, int key, int sq, int sk,
                                           int causal, int window) {
  return row < sq && key < sk && (!causal || key <= row) &&
         (window <= 0 || row - key < window);
}

template <int HD>
__global__ void __launch_bounds__(threads<HD>())
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ o,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    bf16* __restrict__ dq, int sq, int sk, int hq, int group,
                    BwdStrides st, int causal, int window, float dq_scale) {
  constexpr int BM = DQ_BLOCK_M;
  constexpr int THREADS = threads<HD>();
  constexpr int LD = HD + PAD;
  constexpr int KS = HD / 16;       // k16 steps of Q K^T and dO V^T
  constexpr int NT = BLOCK_N / 8;   // n8 tiles of S and dP
  constexpr int DT = HD / 8 / col_groups<HD>();  // n8 tiles of this dQ part
  constexpr int CH = HD / 8;        // 16-byte chunks per row
  constexpr bool REG = frags_in_regs<HD>();
  static_assert(THREADS == tc::threads<HD>(), "load_tile's thread count");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [BM][LD]; then dQ
  bf16* sDO = sQ + BM * LD;                      // [BM][LD]
  bf16* sK = sDO + BM * LD;                      // [2][BLOCK_N][LD]
  bf16* sV = sK + 2 * BLOCK_N * LD;              // [2][BLOCK_N][LD]
  float* sDelta = reinterpret_cast<float*>(sV + 2 * BLOCK_N * LD);  // [BM]

  const int tid = threadIdx.x;
  const int warp = (tid >> 5) % WARPS;
  const int col0 = (tid >> 5) / WARPS * DT * 8;
  const int lane = tid & 31;
  const int h = blockIdx.x;
  const int bi = blockIdx.y;
  const int m0 = (gridDim.z - 1 - blockIdx.z) * BM;  // heaviest tile first
  const int hk = h / group;
  const long long row0 = ((long long)bi * hq + h) * sq;  // lse, delta

  const bf16* qb = q + bi * st.q_b + h * st.q_h;
  const bf16* kb = k + bi * st.k_b + hk * st.k_h;
  const bf16* vb = v + bi * st.v_b + hk * st.v_h;
  const bf16* ob = o + bi * st.o_b + h * st.o_h;
  const bf16* dob = dout + bi * st.do_b + h * st.do_h;

  // Key tiles that can hold an unmasked entry for some row of this tile.
  const int n_end = causal ? min(sk, m0 + BM) : sk;
  int n_begin = 0;
  if (window > 0) {
    const int first = m0 - window + 1;
    if (first > 0) n_begin = (first / BLOCK_N) * BLOCK_N;
  }
  const int n_tiles =
      n_end > n_begin ? (n_end - n_begin + BLOCK_N - 1) / BLOCK_N : 0;

  load_tile<HD, BM>(sQ, qb, st.q_s, m0, sq, tid);
  load_tile<HD, BM>(sDO, dob, st.do_s, m0, sq, tid);
  cp_async_commit();
  if (n_tiles > 0) {
    load_tile<HD, BLOCK_N>(sK, kb, st.k_s, n_begin, sk, tid);
    load_tile<HD, BLOCK_N>(sV, vb, st.v_s, n_begin, sk, tid);
  }
  cp_async_commit();

  // delta = rowsum(dout * out) in float32, a row per warp at a time (lane
  // c takes the row's 16-byte chunk c), while the tiles land.
  for (int r = tid >> 5; r < BM; r += THREADS / 32) {
    const int row = m0 + r;
    float acc = 0.f;
    if (row < sq && lane < CH) {
      const uint4 a =
          *reinterpret_cast<const uint4*>(ob + row * st.o_s + lane * 8);
      const uint4 b =
          *reinterpret_cast<const uint4*>(dob + row * st.do_s + lane * 8);
      const bf16* pa = reinterpret_cast<const bf16*>(&a);
      const bf16* pb = reinterpret_cast<const bf16*>(&b);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc = fmaf(__bfloat162float(pa[e]), __bfloat162float(pb[e]), acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      sDelta[r] = acc;
      if (row < sq) delta[row0 + row] = acc;
    }
  }
  cp_async_wait<1>();  // Q and dO have landed
  __syncthreads();

  const int wr0 = m0 + warp * 16;
  const int wr1 = wr0 + 15;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 8;

  // This thread's two rows (g and g + 8): lse in log2 units and delta.
  float lse2[2], dl[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = warp * 16 + g + rr * 8;
    lse2[rr] = m0 + r < sq ? lse[row0 + m0 + r] * LOG2E : 0.f;
    dl[rr] = sDelta[r];
  }

  const bf16* q_lane = sQ + (warp * 16 + a_row) * LD + a_col;
  const bf16* do_lane = sDO + (warp * 16 + a_row) * LD + a_col;
  uint32_t qf[REG ? KS : 1][4], df[REG ? KS : 1][4];
  if constexpr (REG) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      ldmatrix_x4(qf[ks], smem_addr(q_lane + ks * 16));
      ldmatrix_x4(df[ks], smem_addr(do_lane + ks * 16));
    }
  }

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int n0 = n_begin + it * BLOCK_N;
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      load_tile<HD, BLOCK_N>(sK + (stage ^ 1) * BLOCK_N * LD, kb, st.k_s,
                             n0 + BLOCK_N, sk, tid);
      load_tile<HD, BLOCK_N>(sV + (stage ^ 1) * BLOCK_N * LD, vb, st.v_s,
                             n0 + BLOCK_N, sk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const bf16* tK = sK + stage * BLOCK_N * LD;
    const bf16* tV = sV + stage * BLOCK_N * LD;
    const bool idle = (causal && n0 > wr1) ||
                      (window > 0 && n0 + BLOCK_N - 1 <= wr0 - window);
    if (!idle) {
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t qa[4], da[4];
        if constexpr (REG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            qa[e] = qf[ks][e];
            da[e] = df[ks][e];
          }
        } else {
          ldmatrix_x4(qa, smem_addr(q_lane + ks * 16));
          ldmatrix_x4(da, smem_addr(do_lane + ks * 16));
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          ldmatrix_x4(b, smem_addr(tK + (np * 16 + b_row) * LD + ks * 16 +
                                   b_col));
          mma_bf16(s[2 * np], qa, b[0], b[1]);
          mma_bf16(s[2 * np + 1], qa, b[2], b[3]);
          ldmatrix_x4(b, smem_addr(tV + (np * 16 + b_row) * LD + ks * 16 +
                                   b_col));
          mma_bf16(dp[2 * np], da, b[0], b[1]);
          mma_bf16(dp[2 * np + 1], da, b[2], b[3]);
        }
      }

      const bool edge = n0 + BLOCK_N > sk ||
                        (causal && n0 + BLOCK_N - 1 > wr0) ||
                        (window > 0 && wr1 - n0 >= window);
      // dS = P (dP - delta), then rounded to bf16 as the A operand of
      // dQ += dS K (the accumulator layout of two n8 tiles is the A layout
      // of one k16 step).
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(s[nt][e], LOG2E, -lse2[e >> 1]));
          if (edge && !valid_pair(wr0 + g + (e >> 1) * 8,
                                  n0 + nt * 8 + tig * 2 + (e & 1), sq, sk,
                                  causal, window))
            p = 0.f;
          s[nt][e] = p * (dp[nt][e] - dl[e >> 1]);
        }
#pragma unroll
      for (int t = 0; t < BLOCK_N / 16; ++t) {
        uint32_t a[4];
        a[0] = pack_bf16(s[2 * t][0], s[2 * t][1]);
        a[1] = pack_bf16(s[2 * t][2], s[2 * t][3]);
        a[2] = pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]);
        a[3] = pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3]);
#pragma unroll
        for (int dp2 = 0; dp2 < DT / 2; ++dp2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, smem_addr(tK + (t * 16 + a_row) * LD + col0 +
                                         dp2 * 16 + a_col));
          mma_bf16(acc[2 * dp2], a, b[0], b[1]);
          mma_bf16(acc[2 * dp2 + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with sQ (and the ring): reuse it

  bf16* sO = sQ;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = warp * 16 + g + rr * 8;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(sO + r * LD + col0 + dt * 8 + tig * 2) =
          pack_bf16(acc[dt][2 * rr] * dq_scale,
                    acc[dt][2 * rr + 1] * dq_scale);
  }
  __syncthreads();
  bf16* dqb = dq + bi * st.dq_b + h * st.dq_h;
#pragma unroll
  for (int i = 0; i < BM * CH / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int r = idx / CH;
    const int c = idx - r * CH;
    if (m0 + r < sq)
      *reinterpret_cast<uint4*>(dqb + (m0 + r) * st.dq_s + c * 8) =
          *reinterpret_cast<const uint4*>(sO + r * LD + c * 8);
  }
}

template <int HD>
__global__ void __launch_bounds__(threads<HD>())
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, float* __restrict__ dk_part,
                      float* __restrict__ dv_part, int sq, int sk, int hq,
                      int group, BwdStrides st, int causal, int window) {
  constexpr int BM = kv_block_m<HD>();  // query rows per tile
  constexpr int THREADS = threads<HD>();
  constexpr int LD = HD + PAD;
  constexpr int KS = HD / 16;       // k16 steps of K Q^T and V dO^T
  constexpr int MT = BM / 8;        // n8 tiles of S^T and dP^T
  constexpr int DT = HD / 8 / col_groups<HD>();  // n8 tiles of this dK part
  constexpr int CH = HD / 8;
  constexpr bool REG = frags_in_regs<HD>();
  static_assert(THREADS == tc::threads<HD>(), "load_tile's thread count");
  static_assert(2 * BM <= THREADS, "one lse or delta float per thread");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [BLOCK_N][LD]; then dK
  bf16* sV = sK + BLOCK_N * LD;                  // [BLOCK_N][LD]; then dV
  bf16* sQ = sV + BLOCK_N * LD;                  // [2][BM][LD]
  bf16* sDO = sQ + 2 * BM * LD;                  // [2][BM][LD]
  float* sL = reinterpret_cast<float*>(sDO + 2 * BM * LD);  // [2][BM]
  float* sD = sL + 2 * BM;                                  // [2][BM]

  const int tid = threadIdx.x;
  const int warp = (tid >> 5) % WARPS;
  const int col0 = (tid >> 5) / WARPS * DT * 8;
  const int lane = tid & 31;
  const int h = blockIdx.x;
  const int bi = blockIdx.y;
  const int n0 = blockIdx.z * BLOCK_N;  // the lowest keys, most queries, first
  const int hk = h / group;

  const bf16* kb = k + bi * st.k_b + hk * st.k_h;
  const bf16* vb = v + bi * st.v_b + hk * st.v_h;

  // Query tiles that can hold an unmasked pair with this block's keys.
  const int m_begin = causal ? (n0 / BM) * BM : 0;
  const int m_end = window > 0 ? min(sq, n0 + BLOCK_N - 1 + window) : sq;
  const int m_tiles = m_end > m_begin ? (m_end - m_begin + BM - 1) / BM : 0;
  const bf16* qb = q + bi * st.q_b + h * st.q_h;
  const bf16* dob = dout + bi * st.do_b + h * st.do_h;
  const long long row0 = ((long long)bi * hq + h) * sq;  // lse, delta

  // Q, dO, lse and delta of query tile `it` into ring stage `stage`.
  auto load_q = [&](int it, int stage) {
    const int m0 = m_begin + it * BM;
    load_tile<HD, BM>(sQ + stage * BM * LD, qb, st.q_s, m0, sq, tid);
    load_tile<HD, BM>(sDO + stage * BM * LD, dob, st.do_s, m0, sq, tid);
    if (tid < 2 * BM) {
      const int r = tid % BM;
      const bool ok = m0 + r < sq;
      const long long at = row0 + (ok ? m0 + r : 0);
      float* dst = (tid < BM ? sL : sD) + stage * BM + r;
      cp_async4(smem_addr(dst), (tid < BM ? lse : delta) + at, ok);
    }
  };

  load_tile<HD, BLOCK_N>(sK, kb, st.k_s, n0, sk, tid);
  load_tile<HD, BLOCK_N>(sV, vb, st.v_s, n0, sk, tid);
  if (m_tiles > 0) load_q(0, 0);
  cp_async_commit();

  const int kw0 = n0 + warp * 16;  // this warp's keys: kw0 .. kw0 + 15
  const int kw1 = kw0 + 15;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 8;

  const bf16* k_lane = sK + (warp * 16 + a_row) * LD + a_col;
  const bf16* v_lane = sV + (warp * 16 + a_row) * LD + a_col;
  uint32_t kf[REG ? KS : 1][4], vf[REG ? KS : 1][4];

  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;

  for (int it = 0; it < m_tiles; ++it) {
    const int m0 = m_begin + it * BM;
    const int stage = it & 1;
    if (it + 1 < m_tiles) load_q(it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and K, V) has landed
    __syncthreads();
    if constexpr (REG) {
      if (it == 0) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          ldmatrix_x4(kf[ks], smem_addr(k_lane + ks * 16));
          ldmatrix_x4(vf[ks], smem_addr(v_lane + ks * 16));
        }
      }
    }

    const bf16* tQ = sQ + stage * BM * LD;
    const bf16* tDO = sDO + stage * BM * LD;
    const float* tL = sL + stage * BM;
    const float* tD = sD + stage * BM;
    // A tile before every key of the warp (causal), or past every key's
    // window, holds nothing for it.
    const bool idle = (causal && m0 + BM - 1 < kw0) ||
                      (window > 0 && m0 - kw1 >= window);
    if (!idle) {
      float s[MT][4], dp[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][e] = dp[mt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ka[4], va[4];
        if constexpr (REG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ka[e] = kf[ks][e];
            va[e] = vf[ks][e];
          }
        } else {
          ldmatrix_x4(ka, smem_addr(k_lane + ks * 16));
          ldmatrix_x4(va, smem_addr(v_lane + ks * 16));
        }
#pragma unroll
        for (int np = 0; np < MT / 2; ++np) {
          uint32_t b[4];
          ldmatrix_x4(b, smem_addr(tQ + (np * 16 + b_row) * LD + ks * 16 +
                                   b_col));
          mma_bf16(s[2 * np], ka, b[0], b[1]);
          mma_bf16(s[2 * np + 1], ka, b[2], b[3]);
          ldmatrix_x4(b, smem_addr(tDO + (np * 16 + b_row) * LD + ks * 16 +
                                   b_col));
          mma_bf16(dp[2 * np], va, b[0], b[1]);
          mma_bf16(dp[2 * np + 1], va, b[2], b[3]);
        }
      }

      // Masks only where the tile crosses the ragged ends, the diagonal or
      // the window's edge for some key of this warp.
      const bool edge = kw1 >= sk || m0 + BM > sq ||
                        (causal && m0 < kw1) ||
                        (window > 0 && m0 + BM - 1 - kw0 >= window);
      // Rows of S^T are keys, columns queries: P^T and dS^T, each rounded
      // to bf16 as an A operand whose k16 steps run over queries.
      uint32_t pa[BM / 16][4], dsa[BM / 16][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = mt * 8 + tig * 2 + (e & 1);
          float p = exp2f(fmaf(s[mt][e], LOG2E, -tL[c] * LOG2E));
          if (edge && !valid_pair(m0 + c, kw0 + g + (e >> 1) * 8, sq, sk,
                                  causal, window))
            p = 0.f;
          s[mt][e] = p;
          dp[mt][e] = p * (dp[mt][e] - tD[c]);
        }
#pragma unroll
      for (int t = 0; t < BM / 16; ++t) {
        pa[t][0] = pack_bf16(s[2 * t][0], s[2 * t][1]);
        pa[t][1] = pack_bf16(s[2 * t][2], s[2 * t][3]);
        pa[t][2] = pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]);
        pa[t][3] = pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3]);
        dsa[t][0] = pack_bf16(dp[2 * t][0], dp[2 * t][1]);
        dsa[t][1] = pack_bf16(dp[2 * t][2], dp[2 * t][3]);
        dsa[t][2] = pack_bf16(dp[2 * t + 1][0], dp[2 * t + 1][1]);
        dsa[t][3] = pack_bf16(dp[2 * t + 1][2], dp[2 * t + 1][3]);
      }
#pragma unroll
      for (int t = 0; t < BM / 16; ++t) {
#pragma unroll
        for (int d2 = 0; d2 < DT / 2; ++d2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, smem_addr(tDO + (t * 16 + a_row) * LD + col0 +
                                         d2 * 16 + a_col));
          mma_bf16(dv_acc[2 * d2], pa[t], b[0], b[1]);
          mma_bf16(dv_acc[2 * d2 + 1], pa[t], b[2], b[3]);
          ldmatrix_x4_trans(b, smem_addr(tQ + (t * 16 + a_row) * LD + col0 +
                                         d2 * 16 + a_col));
          mma_bf16(dk_acc[2 * d2], dsa[t], b[0], b[1]);
          mma_bf16(dk_acc[2 * d2 + 1], dsa[t], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }
  cp_async_wait<0>();
  if (group > 1) {  // float32 partials [b, hq, sk, HD] of this query head
    const long long part0 = ((long long)bi * hq + h) * sk;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int key = kw0 + g + rr * 8;
      if (key >= sk) continue;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const long long at = (part0 + key) * HD + col0 + dt * 8 + tig * 2;
        *reinterpret_cast<float2*>(dk_part + at) =
            make_float2(dk_acc[dt][2 * rr], dk_acc[dt][2 * rr + 1]);
        *reinterpret_cast<float2*>(dv_part + at) =
            make_float2(dv_acc[dt][2 * rr], dv_acc[dt][2 * rr + 1]);
      }
    }
    return;
  }
  __syncthreads();  // every warp is done with sK and sV: reuse them

  bf16* sdK = sK;
  bf16* sdV = sV;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = warp * 16 + g + rr * 8;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int c = col0 + dt * 8 + tig * 2;
      *reinterpret_cast<uint32_t*>(sdK + r * LD + c) =
          pack_bf16(dk_acc[dt][2 * rr], dk_acc[dt][2 * rr + 1]);
      *reinterpret_cast<uint32_t*>(sdV + r * LD + c) =
          pack_bf16(dv_acc[dt][2 * rr], dv_acc[dt][2 * rr + 1]);
    }
  }
  __syncthreads();
  bf16* dkb = dk + bi * st.dk_b + hk * st.dk_h;
  bf16* dvb = dv + bi * st.dv_b + hk * st.dv_h;
#pragma unroll
  for (int i = 0; i < BLOCK_N * CH / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int r = idx / CH;
    const int c = idx - r * CH;
    if (n0 + r < sk) {
      *reinterpret_cast<uint4*>(dkb + (n0 + r) * st.dk_s + c * 8) =
          *reinterpret_cast<const uint4*>(sdK + r * LD + c * 8);
      *reinterpret_cast<uint4*>(dvb + (n0 + r) * st.dv_s + c * 8) =
          *reinterpret_cast<const uint4*>(sdV + r * LD + c * 8);
    }
  }
}

constexpr int SUM_THREADS = 256;

// dK and dV of each kv head: its group's float32 partials added in head
// order, rounded once.  A thread per 8 columns of one key row.
template <int HD>
__global__ void __launch_bounds__(SUM_THREADS)
flash_bwd_group_sum_kernel(const float* __restrict__ dk_part,
                           const float* __restrict__ dv_part,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int b, int hkv, int sk, int group, BwdStrides st) {
  constexpr int CH = HD / 8;
  const long long i = (long long)blockIdx.x * SUM_THREADS + threadIdx.x;
  if (i >= (long long)b * hkv * sk * CH) return;
  const int c = i % CH;
  const long long row = i / CH;  // (bi, hk, key)
  const int key = row % sk;
  const int hk = (row / sk) % hkv;
  const int bi = row / ((long long)sk * hkv);
  float sum_k[8], sum_v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) sum_k[e] = sum_v[e] = 0.f;
  for (int j = 0; j < group; ++j) {
    const long long at =
        ((((long long)bi * hkv + hk) * group + j) * sk + key) * HD + c * 8;
    const float4* part_k = reinterpret_cast<const float4*>(dk_part + at);
    const float4* part_v = reinterpret_cast<const float4*>(dv_part + at);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float4 a = part_k[half];
      const float4 w = part_v[half];
      const float ka[4] = {a.x, a.y, a.z, a.w};
      const float va[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sum_k[4 * half + e] += ka[e];
        sum_v[4 * half + e] += va[e];
      }
    }
  }
  uint4 out_k, out_v;
  uint32_t* pk = reinterpret_cast<uint32_t*>(&out_k);
  uint32_t* pv = reinterpret_cast<uint32_t*>(&out_v);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    pk[e] = pack_bf16(sum_k[2 * e], sum_k[2 * e + 1]);
    pv[e] = pack_bf16(sum_v[2 * e], sum_v[2 * e + 1]);
  }
  *reinterpret_cast<uint4*>(dk + bi * st.dk_b + hk * st.dk_h +
                            key * st.dk_s + c * 8) = out_k;
  *reinterpret_cast<uint4*>(dv + bi * st.dv_b + hk * st.dv_h +
                            key * st.dv_s + c * 8) = out_v;
}

// dk_part, dv_part: float32 [b, hq, sk, HD] scratch when hq > hkv, else
// unused.
template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv,
                   float* dk_part, float* dv_part, int b, int hq, int hkv,
                   int sq, int sk, const BwdStrides& st, int causal,
                   int window, float dq_scale, cudaStream_t stream) {
  constexpr size_t smem_dq = dq_smem_bytes<HD>();
  constexpr size_t smem_kv = dkdv_smem_bytes<HD>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_dq);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const bf16* q_ = static_cast<const bf16*>(q);
  const bf16* k_ = static_cast<const bf16*>(k);
  const bf16* v_ = static_cast<const bf16*>(v);
  const bf16* do_ = static_cast<const bf16*>(dout);
  dim3 grid_dq(hq, b, (sq + DQ_BLOCK_M - 1) / DQ_BLOCK_M);
  flash_bwd_dq_kernel<HD><<<grid_dq, threads<HD>(), smem_dq, stream>>>(
      q_, k_, v_, static_cast<const bf16*>(o), do_, lse, delta,
      static_cast<bf16*>(dq), sq, sk, hq, hq / hkv, st, causal, window,
      dq_scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int group = hq / hkv;
  bf16* dk_ = static_cast<bf16*>(dk);
  bf16* dv_ = static_cast<bf16*>(dv);
  dim3 grid_kv(hq, b, (sk + BLOCK_N - 1) / BLOCK_N);
  flash_bwd_dkdv_kernel<HD><<<grid_kv, threads<HD>(), smem_kv, stream>>>(
      q_, k_, v_, do_, lse, delta, dk_, dv_, dk_part, dv_part, sq, sk, hq,
      group, st, causal, window);
  e = cudaGetLastError();
  if (e != cudaSuccess || group == 1) return e;
  const long long n = (long long)b * hkv * sk * (HD / 8);
  flash_bwd_group_sum_kernel<HD>
      <<<(unsigned)((n + SUM_THREADS - 1) / SUM_THREADS), SUM_THREADS, 0,
         stream>>>(dk_part, dv_part, dk_, dv_, b, hkv, sk, group, st);
  return cudaGetLastError();
}

// 16-byte copies need 16-byte aligned rows: the eight tensors' pointers,
// and their 24 batch, head and seq strides multiples of 8 elements.
bool aligned16(const void* const* ptrs, const long long* strides) {
  uintptr_t any = 0;
  for (int i = 0; i < 8; ++i) any |= (uintptr_t)ptrs[i];
  for (int i = 0; i < 24; ++i)
    if (strides[i] % 8) return false;
  return any % 16 == 0;
}

}  // namespace bwd

// The float32 scalar kernel or the bf16 tensor-core kernel for one hd.
template <int HD>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* o, float* lse, int b, int hq, int hkv, int sq,
                   int sk, const Strides& st, int causal, int window,
                   cudaStream_t s) {
  if (dtype == 0)
    return f32::launch<HD>(q, k, v, o, lse, b, hq, hkv, sq, sk, st, causal,
                           window, s);
  if (dtype == 1) {
    if (!tc::aligned16(q, k, v, o, st)) return cudaErrorMisalignedAddress;
    return tc::launch<HD>(q, k, v, o, lse, b, hq, hkv, sq, sk, st, causal,
                          window, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (scalar kernel), 1 = bfloat16 (tensor-core kernel).
// strides: 12 element strides, (batch, head, seq) for q, k, v and o in that
// order; the head_dim axis must be contiguous, and for bfloat16 every
// pointer 16-byte aligned and every stride a multiple of 8.  Returns the
// cudaError_t of the launch.
int repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                              void* o, float* lse, int dtype, int b, int hq,
                              int hkv, int sq, int sk, int hd,
                              const long long* strides, int causal,
                              int window, int device, void* stream) {
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return e;
  if (cur != device) {
    e = cudaSetDevice(device);
    if (e != cudaSuccess) return e;
  }
  if (hkv <= 0 || hq % hkv != 0) return cudaErrorInvalidValue;
  Strides st{strides[0], strides[1], strides[2],  strides[3],
             strides[4], strides[5], strides[6],  strides[7],
             strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:  // the reduced configs (float32): the scalar kernel only
      if (dtype != 0) return cudaErrorInvalidValue;
      return f32::launch<16>(q, k, v, o, lse, b, hq, hkv, sq, sk, st, causal,
                             window, s);
    case 32:
      return launch<32>(dtype, q, k, v, o, lse, b, hq, hkv, sq, sk, st,
                        causal, window, s);
    case 64:
      return launch<64>(dtype, q, k, v, o, lse, b, hq, hkv, sq, sk, st,
                        causal, window, s);
    case 96:
      return launch<96>(dtype, q, k, v, o, lse, b, hq, hkv, sq, sk, st,
                        causal, window, s);
    case 128:
      return launch<128>(dtype, q, k, v, o, lse, b, hq, hkv, sq, sk, st,
                         causal, window, s);
    case 256:
      return launch<256>(dtype, q, k, v, o, lse, b, hq, hkv, sq, sk, st,
                         causal, window, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The backward of the bfloat16 kernel (launches: dq and delta; dk and dv;
// under GQA the sum of their partials).  strides: 24 element strides,
// (batch, head, seq) for q, k, v, o, dout, dq, dk and dv in that order; lse
// and delta are contiguous float32 [b, hq, sq]; dk_part and dv_part
// contiguous float32 [b, hq, sk, hd] scratch when hq > hkv (else unused);
// the head_dim axis must be contiguous, every pointer 16-byte aligned and
// every stride a multiple of 8.  Returns the cudaError_t of the launches.
int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const float* lse, float* delta, void* dq,
                              void* dk, void* dv, float* dk_part,
                              float* dv_part, int b, int hq, int hkv,
                              int sq, int sk, int hd,
                              const long long* strides, int causal,
                              int window, float dq_scale, int device,
                              void* stream) {
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return e;
  if (cur != device) {
    e = cudaSetDevice(device);
    if (e != cudaSuccess) return e;
  }
  if (hkv <= 0 || hq % hkv != 0) return cudaErrorInvalidValue;
  if (hq > hkv && (dk_part == nullptr || dv_part == nullptr))
    return cudaErrorInvalidValue;
  const void* ptrs[8] = {q, k, v, o, dout, dq, dk, dv};
  if (!bwd::aligned16(ptrs, strides)) return cudaErrorMisalignedAddress;
  const long long* s = strides;
  bwd::BwdStrides st{s[0],  s[1],  s[2],  s[3],  s[4],  s[5],
                     s[6],  s[7],  s[8],  s[9],  s[10], s[11],
                     s[12], s[13], s[14], s[15], s[16], s[17],
                     s[18], s[19], s[20], s[21], s[22], s[23]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
#define REPRO_BWD(HD)                                                       \
  return bwd::launch<HD>(q, k, v, o, dout, lse, delta, dq, dk, dv,        \
                         dk_part, dv_part, b, hq, hkv, sq, sk, st, causal,  \
                         window, dq_scale, cs)
  switch (hd) {
    case 32:
      REPRO_BWD(32);
    case 64:
      REPRO_BWD(64);
    case 96:
      REPRO_BWD(96);
    case 128:
      REPRO_BWD(128);
    case 256:
      REPRO_BWD(256);
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_BWD
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
