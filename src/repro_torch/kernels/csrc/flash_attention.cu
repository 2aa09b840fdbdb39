// Flash-attention forward for Hopper (sm_90a): kernel K1 of the port.
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

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
