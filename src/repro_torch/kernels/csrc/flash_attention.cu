// Flash-attention forward for Hopper (sm_90a): kernel K1 of the port.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_fwd / _kernel).  Same function: causal or sliding-window
// GQA attention, q pre-scaled by hd**-0.5, query and key positions
// arange(sq) / arange(sk), online softmax (m, l, acc) in float32, fully
// masked key tiles skipped.  Unlike the Pallas kernel it also writes the
// row log-sum-exp (lse = m + log l), which the backward needs.
//
// Design.  One thread block per (64-row query tile, query head, batch row):
// the TPU's sequential kv grid axis becomes a loop inside the block over
// 64-key tiles staged in shared memory, so no state crosses blocks and no
// atomics are needed (results are deterministic).  256 threads: thread
// (ty, tx) owns query rows 4*ty..4*ty+3, score columns tx + 16*j, and output
// columns tx + 16*j of those rows; the 16 threads of a row group reduce the
// row max and row sum with warp shuffles.  Tiles are held in shared memory
// as float32 with a pitch of hd + 1 words so that the column walks of the
// score product hit 16 distinct banks.  The products are scalar FMAs:
// correct and simple first; mma/wgmma tiles are later work.
//
// Bound on this card.  Causal attention at the training shape does
// 2*b*hq*sq^2*hd FLOPs (QK^T and PV, half the square each) on
// O(b*h*s*hd) bytes: far above the ridge, so the bound is the tensor-core
// rate.  Scalar float32 FMAs cannot reach it; this kernel is the correct
// baseline that a tensor-core version is measured against.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int BLOCK_M = 64;
constexpr int BLOCK_N = 64;
constexpr int THREADS = 256;
constexpr int LP = BLOCK_N + 1;  // pitch of the probability tile
constexpr float NEG_INF = -1e30f;

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
  long long q_b, q_h, q_s;
  long long k_b, k_h, k_s;
  long long v_b, v_h, v_s;
  long long o_b, o_h, o_s;
};

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(3 * BLOCK_M * (HD + 1) + BLOCK_M * LP);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, int hq, int group,
                 Strides st, int causal, int window) {
  constexpr int LD = HD + 1;    // padded row pitch of the q/k/v tiles
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

  const T* qb = q + bi * st.q_b + h * st.q_h;
  const T* kb = k + bi * st.k_b + hk * st.k_h;
  const T* vb = v + bi * st.v_b + hk * st.v_h;

  for (int idx = tid; idx < BLOCK_M * HD; idx += THREADS) {
    const int r = idx / HD;
    const int d = idx - r * HD;
    const int qr = m0 + r;
    sQ[r * LD + d] = qr < sq ? to_float(qb[qr * st.q_s + d]) : 0.f;
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
      sK[r * LD + d] = ok ? to_float(kb[kr * st.k_s + d]) : 0.f;
      sV[r * LD + d] = ok ? to_float(vb[kr * st.v_s + d]) : 0.f;
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
      T* orow = o + bi * st.o_b + h * st.o_h + qr * st.o_s;
#pragma unroll
      for (int jd = 0; jd < DPT; ++jd)
        orow[tx + 16 * jd] = from_float<T>(acc[i][jd] / l);
      if (tx == 0) lse[((long long)bi * hq + h) * sq + qr] = m_i[i] + logf(l);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int hq, int hkv, int sq, int sk,
                   const Strides& st, int causal, int window,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid((sq + BLOCK_M - 1) / BLOCK_M, hq, b);
  flash_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, sk, hq,
      hq / hkv, st, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* o, float* lse, int b, int hq, int hkv, int sq,
                        int sk, const Strides& st, int causal, int window,
                        cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, b, hq, hkv, sq, sk, st, causal,
                           window, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, b, hq, hkv, sq, sk, st, causal,
                           window, stream);
    case 96:
      return launch<T, 96>(q, k, v, o, lse, b, hq, hkv, sq, sk, st, causal,
                           window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, b, hq, hkv, sq, sk, st, causal,
                            window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides, (batch,
// head, seq) for q, k, v and o in that order; the head_dim axis must be
// contiguous.  Returns the cudaError_t of the launch.
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
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, lse, b, hq, hkv, sq, sk, st,
                              causal, window, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, lse, b, hq, hkv, sq,
                                      sk, st, causal, window, s);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
