// Split-KV flash decode for Hopper (sm_90a): kernel K3 of the port.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_decode.py
// (flash_decode / _kernel).  Same function: one query position per (batch
// row, query head) against a KV cache, q pre-scaled by hd**-0.5, keys valid
// in [length - window, length) ([0, length) when window is 0), GQA (query
// head h reads kv head h / g), float32 softmax, the output in q's dtype and
// 0 where no key is valid (the Pallas acc / max(l, 1e-30)).  length is read
// from a device int32 scalar, so one launch sequence (or one CUDA graph)
// serves every length: the Hopper form of the Pallas scalar prefetch.  A
// length above the cache capacity S counts as S.
//
// Design (flash-decoding).  The Pallas grid walks the kv blocks in order,
// one query head at a time; at the serve shape b*hq = 16 such walks would
// leave 116 of 132 SMs idle.  Pass 1 has one block per (key split, kv head,
// batch row).  It serves all g = hq/hkv query heads of its kv head, so each
// K/V row is read once per group, not once per query head.  It loops over
// the 64-key tiles of its split in shared memory, skips tiles outside the
// valid range (the Pallas run predicate) and masks inside a tile that
// straddles an edge, and writes a float32 partial (m, l, acc[hd]) per query
// head to a workspace.  Pass 2 has one block per (query head, batch row) and
// merges the splits in index order: deterministic, no atomics.  A split with
// no valid key leaves (m = -1e30, l = 0, acc = 0) and gets weight 0 in the
// merge, so exp(-inf - -inf) is never formed.  The split count comes from S
// and the SM count (the wrapper), never from length: nothing waits on the
// host.  The caches are read through their strides (the model's
// [b, S, hkv, hd] storage), so no transpose or pad copies them.
//
// Bound on this card: bytes.  A call reads the valid keys and values once
// (2 * length * hkv * hd * itemsize per batch row) for 4 FLOPs per element
// read, far below the ridge.  Products are scalar float32 FMAs from shared
// memory; 16-byte loads, wgmma and TMA are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int TILE = 64;      // keys per shared-memory tile
constexpr int THREADS = 128;  // pass 1 block
constexpr int MAX_GROUP = 8;  // query heads per kv head
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
  long long q_b, q_h;
  long long k_b, k_h, k_s;
  long long v_b, v_h, v_s;
  long long o_b, o_h;
};

size_t split_smem_bytes(int hd, int group) {
  return sizeof(float) *
         (size_t)(group * hd + 2 * TILE * (hd + 1) + group * TILE + 3 * group);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const int* __restrict__ length_ptr,
                          float* __restrict__ ws_acc,
                          float* __restrict__ ws_ml, int S, int hq, int group,
                          int tiles_per_split, int num_splits, Strides st,
                          int window) {
  constexpr int LD = HD + 1;  // padded row pitch of the K/V tiles
  constexpr int MAX_OUT = (MAX_GROUP * HD + THREADS - 1) / THREADS;
  extern __shared__ float smem[];
  const int g = group;
  float* sQ = smem;            // [g][HD]
  float* sK = sQ + g * HD;     // [TILE][LD]
  float* sV = sK + TILE * LD;  // [TILE][LD]
  float* sP = sV + TILE * LD;  // [g][TILE] scores, then probabilities
  float* sM = sP + g * TILE;   // [g] running max
  float* sL = sM + g;          // [g] running sum
  float* sC = sL + g;          // [g] this tile's correction factor

  const int tid = threadIdx.x;
  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int bi = blockIdx.z;
  const int h0 = hk * g;  // first query head of this kv head's group

  const int length = min(max(*length_ptr, 0), S);
  const int lo = window > 0 ? max(0, length - window) : 0;
  const int k_begin = split * tiles_per_split * TILE;
  const int k_end = min(S, k_begin + tiles_per_split * TILE);

  for (int idx = tid; idx < g * HD; idx += THREADS) {
    const int h = idx / HD;
    const int d = idx - h * HD;
    sQ[idx] = to_float(q[bi * st.q_b + (h0 + h) * st.q_h + d]);
  }
  for (int h = tid; h < g; h += THREADS) {
    sM[h] = NEG_INF;
    sL[h] = 0.f;
  }
  float acc[MAX_OUT];
#pragma unroll
  for (int r = 0; r < MAX_OUT; ++r) acc[r] = 0.f;

  const T* kb = k + bi * st.k_b + hk * st.k_h;
  const T* vb = v + bi * st.v_b + hk * st.v_h;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  for (int n0 = k_begin; n0 < k_end; n0 += TILE) {
    // The same for every thread of the block: a skipped tile syncs nowhere.
    if (n0 >= length || n0 + TILE <= lo) continue;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < TILE * HD; idx += THREADS) {
      const int r = idx / HD;
      const int d = idx - r * HD;
      const int kr = n0 + r;
      const bool ok = kr < S;
      sK[r * LD + d] = ok ? to_float(kb[kr * st.k_s + d]) : 0.f;
      sV[r * LD + d] = ok ? to_float(vb[kr * st.v_s + d]) : 0.f;
    }
    __syncthreads();

    for (int idx = tid; idx < g * TILE; idx += THREADS) {
      const int h = idx / TILE;
      const int j = idx - h * TILE;
      const int kp = n0 + j;
      float s = NEG_INF;
      if (kp >= lo && kp < length) {
        float a = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d)
          a = fmaf(sQ[h * HD + d], sK[j * LD + d], a);
        s = a;
      }
      sP[idx] = s;
    }
    __syncthreads();

    // One warp per query head: the tile's max and sum, the running (m, l).
    // A processed tile holds at least one valid key, so m_new is finite.
    for (int h = warp; h < g; h += THREADS / 32) {
      const float s0 = sP[h * TILE + lane];
      const float s1 = sP[h * TILE + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[h];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = s0 == NEG_INF ? 0.f : expf(s0 - m_new);
      const float p1 = s1 == NEG_INF ? 0.f : expf(s1 - m_new);
      sP[h * TILE + lane] = p0;
      sP[h * TILE + lane + 32] = p1;
      float rs = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sC[h] = corr;
        sL[h] = sL[h] * corr + rs;
        sM[h] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < MAX_OUT; ++r) {
      const int idx = tid + r * THREADS;
      if (idx < g * HD) {
        const int h = idx / HD;
        const int d = idx - h * HD;
        float a = acc[r] * sC[h];
#pragma unroll 8
        for (int j = 0; j < TILE; ++j)
          a = fmaf(sP[h * TILE + j], sV[j * LD + d], a);
        acc[r] = a;
      }
    }
  }
  __syncthreads();  // sM/sL final (or initial, for an empty split)

  const long long row0 = (long long)bi * hq + h0;
#pragma unroll
  for (int r = 0; r < MAX_OUT; ++r) {
    const int idx = tid + r * THREADS;
    if (idx < g * HD) {
      const int h = idx / HD;
      const int d = idx - h * HD;
      ws_acc[((row0 + h) * num_splits + split) * HD + d] = acc[r];
    }
  }
  for (int h = tid; h < g; h += THREADS) {
    float* ml = ws_ml + ((row0 + h) * num_splits + split) * 2;
    ml[0] = sM[h];
    ml[1] = sL[h];
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
flash_decode_combine_kernel(const float* __restrict__ ws_acc,
                            const float* __restrict__ ws_ml,
                            T* __restrict__ o, int hq, int num_splits,
                            Strides st) {
  const int h = blockIdx.x;
  const int bi = blockIdx.y;
  const int d = threadIdx.x;
  const long long row = (long long)bi * hq + h;
  const float* ml = ws_ml + row * num_splits * 2;
  const float* acc = ws_acc + row * num_splits * HD;
  // Only splits that saw a valid key (l > 0; such a split has l >= 1)
  // take part, so an empty split's m never enters an exponent.
  float m = NEG_INF;
  for (int s = 0; s < num_splits; ++s)
    if (ml[2 * s + 1] > 0.f) m = fmaxf(m, ml[2 * s]);
  float l = 0.f;
  float a = 0.f;
  for (int s = 0; s < num_splits; ++s) {
    const float ls = ml[2 * s + 1];
    if (ls > 0.f) {
      const float w = expf(ml[2 * s] - m);
      l = fmaf(w, ls, l);
      a = fmaf(w, acc[s * HD + d], a);
    }
  }
  o[bi * st.o_b + h * st.o_h + d] = from_float<T>(a / fmaxf(l, 1e-30f));
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* length, void* o, float* ws_acc, float* ws_ml,
                   int b, int hq, int hkv, int S, int num_splits,
                   int tiles_per_split, const Strides& st, int window,
                   cudaStream_t stream) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_decode_split_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)split_smem_bytes(HD, MAX_GROUP));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const int group = hq / hkv;
  flash_decode_split_kernel<T, HD>
      <<<dim3(num_splits, hkv, b), THREADS, split_smem_bytes(HD, group),
         stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                   static_cast<const T*>(v), length, ws_acc, ws_ml, S, hq,
                   group, tiles_per_split, num_splits, st, window);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_decode_combine_kernel<T, HD><<<dim3(hq, b), HD, 0, stream>>>(
      ws_acc, ws_ml, static_cast<T*>(o), hq, num_splits, st);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const int* length, void* o, float* ws_acc,
                        float* ws_ml, int b, int hq, int hkv, int S,
                        int num_splits, int tiles_per_split,
                        const Strides& st, int window, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, length, o, ws_acc, ws_ml, b, hq, hkv, S,
                           num_splits, tiles_per_split, st, window, stream);
    case 64:
      return launch<T, 64>(q, k, v, length, o, ws_acc, ws_ml, b, hq, hkv, S,
                           num_splits, tiles_per_split, st, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, length, o, ws_acc, ws_ml, b, hq, hkv, S,
                            num_splits, tiles_per_split, st, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides: 10 element strides, (batch,
// head) of q, (batch, head, seq) of k and v, (batch, head) of o; the
// head_dim axis must be contiguous.  length: a device int32 scalar.
// ws_acc [b, hq, num_splits, hd] and ws_ml [b, hq, num_splits, 2] are
// float32 scratch the caller allocates.  Returns the cudaError_t of the
// launches.
int repro_flash_decode(const void* q, const void* k, const void* v,
                       const int* length, void* o, float* ws_acc,
                       float* ws_ml, int dtype, int b, int hq, int hkv, int S,
                       int hd, int num_splits, int tiles_per_split,
                       const long long* strides, int window, int device,
                       void* stream) {
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return e;
  if (cur != device) {
    e = cudaSetDevice(device);
    if (e != cudaSuccess) return e;
  }
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > MAX_GROUP || num_splits <= 0 ||
      tiles_per_split <= 0 ||
      (long long)num_splits * tiles_per_split * TILE < S)
    return cudaErrorInvalidValue;
  Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],
             strides[5], strides[6], strides[7], strides[8], strides[9]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, length, o, ws_acc, ws_ml, b, hq,
                              hkv, S, num_splits, tiles_per_split, st, window,
                              s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, length, o, ws_acc, ws_ml,
                                      b, hq, hkv, S, num_splits,
                                      tiles_per_split, st, window, s);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
