// Split-KV flash decode for Hopper (sm_90a): kernel K3 of the port.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_decode.py
// (flash_decode / _kernel).  Same function: one query position per (batch
// row, query head) against a KV cache, q pre-scaled by hd**-0.5, keys valid
// in [length - window, length) ([0, length) when window is 0), GQA (query
// head h reads kv head h / g), float32 softmax, the output in q's dtype and
// 0 where no key is valid (the Pallas acc / max(l, 1e-30)).  length is read
// from a device int32 scalar, so one launch (or one CUDA graph) serves
// every length: the Hopper form of the Pallas scalar prefetch.  A length
// above the cache capacity S counts as S.
//
// Bound on this card: bytes.  A call reads the valid keys and values once
// (2 * length * hkv * hd * itemsize per batch row) for 4 FLOPs per element
// read, far below the ridge, so the floor is those bytes over 3.35 TB/s.
//
// Design (flash-decoding, one launch).  The Pallas grid walks the kv blocks
// in order, one query head at a time; at the serve shape b*hq = 16 such
// walks would leave 116 of 132 SMs idle.  One block per (key split, kv
// head, batch row) serves all g = hq/hkv query heads of its kv head, so
// each K/V row is read once per group.
//  - Its 64-key tiles of K and V are staged in the cache's own dtype by
//    16-byte cp.async copies in a 2-stage ring: the next tile's bytes are in
//    flight while the current one computes (a split of one or two tiles has
//    all of them in flight at once).  Tiles outside the valid range are
//    skipped (the Pallas run predicate); a tile that straddles an edge is
//    masked.  Scores and P.V read the tiles as 16-byte vectors: a lane owns
//    16 bytes of a row, the lanes of one row reduce q.k by shuffles, and
//    for P.V each lane accumulates its columns over its own keys.
//  - Each block writes a float32 partial (m, l, acc[hd]) per query head to
//    a workspace, fences, and takes a ticket from a per-(batch row, kv
//    head) arrival counter.  The block that arrives last merges every split
//    in split index order (so the result does not depend on the arrival
//    order), writes the output and resets the counter to 0 for the next
//    launch or graph replay.  A split with no valid key leaves (m = -1e30,
//    l = 0, acc = 0) and gets weight 0 in the merge, so exp(-inf - -inf) is
//    never formed.
// The split count comes from S and the SM count (the wrapper), never from
// length: nothing waits on the host.  The caches are read through their
// strides (the model's [b, S, hkv, hd] storage), so no transpose or pad
// copies them.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;  // keys per shared-memory tile
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_GROUP = 8;  // query heads per kv head
constexpr float NEG_INF = -1e30f;

using bf16 = __nv_bfloat16;

// 16 bytes of T as floats.
__device__ __forceinline__ void to_floats(const float* p, float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}
__device__ __forceinline__ void to_floats(const bf16* p, float (&f)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Strides {
  long long q_b, q_h;
  long long k_b, k_h, k_s;
  long long v_b, v_h, v_s;
  long long o_b, o_h;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
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

template <typename T, int HD>
constexpr size_t smem_bytes() {
  // K and V ring [2][TILE][HD] each, scores [MAX_GROUP][TILE], the
  // per-warp partial sums [WARPS][MAX_GROUP][HD], (m, l, corr) per head
  return sizeof(T) * 4 * TILE * HD +
         sizeof(float) * (MAX_GROUP * TILE + WARPS * MAX_GROUP * HD +
                          3 * MAX_GROUP);
}

// TILE rows of a cache from row n0 (rows at or past S filled with zeros)
// into dst [TILE][HD], as 16-byte copies.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long stride, int n0, int S,
                                          int tid) {
  constexpr int CH = HD * (int)sizeof(T) / 16;  // 16-byte chunks per row
  constexpr int VEC = 16 / (int)sizeof(T);
  static_assert((TILE * CH) % THREADS == 0, "tile copy must divide evenly");
#pragma unroll
  for (int i = 0; i < TILE * CH / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int r = idx / CH;
    const int c = idx - r * CH;
    const bool ok = n0 + r < S;
    cp_async16(dst + r * HD + c * VEC,
               ok ? src + (n0 + r) * stride + c * VEC : src, ok);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ length_ptr,
                    T* __restrict__ o, float* __restrict__ ws_acc,
                    float* __restrict__ ws_ml, int* __restrict__ counters,
                    int S, int hq, int hkv, int group, int tiles_per_split,
                    int num_splits, Strides st, int window) {
  constexpr int VEC = 16 / (int)sizeof(T);  // elements per 16 bytes
  constexpr int LPK = HD / VEC;             // lanes per key row
  constexpr int KPW = 32 / LPK;             // keys per warp and step
  constexpr int KG = WARPS * KPW;           // keys per block and step
  static_assert(LPK <= 32 && TILE % KG == 0, "unsupported head dim");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);  // [2][TILE][HD]
  T* sV = sK + 2 * TILE * HD;              // [2][TILE][HD]
  float* sS = reinterpret_cast<float*>(sV + 2 * TILE * HD);  // [g][TILE]
  float* sRed = sS + MAX_GROUP * TILE;     // [WARPS][g][HD]
  float* sM = sRed + WARPS * MAX_GROUP * HD;  // [g] running max
  float* sL = sM + MAX_GROUP;                 // [g] running sum
  float* sC = sL + MAX_GROUP;                 // [g] this tile's correction
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int kg = warp * KPW + lane / LPK;  // this lane's key in each step
  const int c = lane % LPK;                // its 16-byte column chunk
  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int bi = blockIdx.z;
  const int g = group;
  const int h0 = hk * g;  // first query head of this kv head's group

  const int length = min(max(*length_ptr, 0), S);
  const int lo = window > 0 ? max(0, length - window) : 0;
  const int k_begin = split * tiles_per_split * TILE;
  const int k_end = min(S, k_begin + tiles_per_split * TILE);
  // The tiles of this split that hold a valid key (the same for every
  // thread of the block: a skipped tile syncs nowhere).
  const int n_lo = max(k_begin, (lo / TILE) * TILE);
  const int n_hi = min(k_end, length);
  const int n_tiles = n_hi > n_lo ? (n_hi - n_lo + TILE - 1) / TILE : 0;

  const T* kb = k + bi * st.k_b + hk * st.k_h;
  const T* vb = v + bi * st.v_b + hk * st.v_h;
  if (n_tiles > 0) {
    load_tile<T, HD>(sK, kb, st.k_s, n_lo, S, tid);
    load_tile<T, HD>(sV, vb, st.v_s, n_lo, S, tid);
  }
  cp_async_commit();

  float qv[MAX_GROUP][VEC], acc[MAX_GROUP][VEC];
#pragma unroll
  for (int h = 0; h < MAX_GROUP; ++h) {
    if (h < g) to_floats(q + bi * st.q_b + (h0 + h) * st.q_h + c * VEC, qv[h]);
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[h][e] = 0.f;
  }
  for (int h = tid; h < g; h += THREADS) {
    sM[h] = NEG_INF;
    sL[h] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int n0 = n_lo + it * TILE;
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      load_tile<T, HD>(sK + (stage ^ 1) * TILE * HD, kb, st.k_s, n0 + TILE,
                       S, tid);
      load_tile<T, HD>(sV + (stage ^ 1) * TILE * HD, vb, st.v_s, n0 + TILE,
                       S, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile has landed; the next is in flight
    __syncthreads();
    const T* tK = sK + stage * TILE * HD;
    const T* tV = sV + stage * TILE * HD;

    // Scores: the LPK lanes of a key each dot 16 bytes, then reduce.
#pragma unroll
    for (int j0 = 0; j0 < TILE; j0 += KG) {
      const int j = j0 + kg;
      float kf[VEC];
      to_floats(tK + j * HD + c * VEC, kf);
      const int kp = n0 + j;
      const bool valid = kp >= lo && kp < length;
#pragma unroll
      for (int h = 0; h < MAX_GROUP; ++h) {
        if (h < g) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) d = fmaf(qv[h][e], kf[e], d);
#pragma unroll
          for (int off = LPK / 2; off > 0; off >>= 1)
            d += __shfl_xor_sync(0xffffffffu, d, off);
          if (c == 0) sS[h * TILE + j] = valid ? d : NEG_INF;
        }
      }
    }
    __syncthreads();

    // One warp per query head: the tile's max and sum, the running (m, l).
    // A processed tile holds at least one valid key, so m_new is finite.
    for (int h = warp; h < g; h += WARPS) {
      const float s0 = sS[h * TILE + lane];
      const float s1 = sS[h * TILE + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[h];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = s0 == NEG_INF ? 0.f : expf(s0 - m_new);
      const float p1 = s1 == NEG_INF ? 0.f : expf(s1 - m_new);
      sS[h * TILE + lane] = p0;
      sS[h * TILE + lane + 32] = p1;
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

    // P.V: each lane accumulates its 16 bytes of columns over its keys.
#pragma unroll
    for (int h = 0; h < MAX_GROUP; ++h) {
      if (h < g) {
        const float corr = sC[h];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[h][e] *= corr;
      }
    }
#pragma unroll
    for (int j0 = 0; j0 < TILE; j0 += KG) {
      const int j = j0 + kg;
      float vf[VEC];
      to_floats(tV + j * HD + c * VEC, vf);
#pragma unroll
      for (int h = 0; h < MAX_GROUP; ++h) {
        if (h < g) {
          const float p = sS[h * TILE + j];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[h][e] = fmaf(p, vf[e], acc[h][e]);
        }
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }
  cp_async_wait<0>();

  // The block's partial: lanes of one column chunk sum over their keys in a
  // fixed order, then the warps' sums are added in warp order.
#pragma unroll
  for (int h = 0; h < MAX_GROUP; ++h) {
    if (h < g) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float a = acc[h][e];
#pragma unroll
        for (int off = LPK; off < 32; off <<= 1)
          a += __shfl_xor_sync(0xffffffffu, a, off);
        if (lane < LPK) sRed[(warp * MAX_GROUP + h) * HD + c * VEC + e] = a;
      }
    }
  }
  __syncthreads();  // sRed complete; sM/sL final (or initial, if empty)

  const long long row0 = (long long)bi * hq + h0;
  for (int idx = tid; idx < g * HD; idx += THREADS) {
    const int h = idx / HD;
    const int d = idx - h * HD;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += sRed[(w * MAX_GROUP + h) * HD + d];
    ws_acc[((row0 + h) * num_splits + split) * HD + d] = a;
  }
  for (int h = tid; h < g; h += THREADS) {
    float* ml = ws_ml + ((row0 + h) * num_splits + split) * 2;
    ml[0] = sM[h];
    ml[1] = sL[h];
  }

  // Arrival: the partial is visible device-wide before the ticket is taken.
  __threadfence();
  __syncthreads();
  int* counter = counters + (long long)bi * hkv + hk;
  if (tid == 0) s_last = atomicAdd(counter, 1) == num_splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (tid == 0) *counter = 0;  // every split has arrived: ready for reuse

  // Merge, in split index order.  Only splits that saw a valid key (l > 0;
  // such a split has l >= 1) take part, so an empty split's m never enters
  // an exponent.  Loads go to L2 (__ldcg): the other blocks wrote there.
  for (int idx = tid; idx < g * HD; idx += THREADS) {
    const int h = idx / HD;
    const int d = idx - h * HD;
    const float* ml = ws_ml + (row0 + h) * num_splits * 2;
    const float* pa = ws_acc + (row0 + h) * num_splits * HD;
    float m = NEG_INF;
    for (int s = 0; s < num_splits; ++s)
      if (__ldcg(ml + 2 * s + 1) > 0.f) m = fmaxf(m, __ldcg(ml + 2 * s));
    float l = 0.f;
    float a = 0.f;
    for (int s = 0; s < num_splits; ++s) {
      const float ls = __ldcg(ml + 2 * s + 1);
      if (ls > 0.f) {
        const float w = expf(__ldcg(ml + 2 * s) - m);
        l = fmaf(w, ls, l);
        a = fmaf(w, __ldcg(pa + s * HD + d), a);
      }
    }
    o[bi * st.o_b + (h0 + h) * st.o_h + d] =
        from_float<T>(a / fmaxf(l, 1e-30f));
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* length, void* o, float* ws_acc, float* ws_ml,
                   int* counters, int b, int hq, int hkv, int S,
                   int num_splits, int tiles_per_split, const Strides& st,
                   int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, HD>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_decode_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  flash_decode_kernel<T, HD>
      <<<dim3(num_splits, hkv, b), THREADS, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), length, static_cast<T*>(o), ws_acc,
          ws_ml, counters, S, hq, hkv, hq / hkv, tiles_per_split,
          num_splits, st, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const int* length, void* o, float* ws_acc,
                        float* ws_ml, int* counters, int b, int hq, int hkv,
                        int S, int num_splits, int tiles_per_split,
                        const Strides& st, int window, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, length, o, ws_acc, ws_ml, counters, b,
                           hq, hkv, S, num_splits, tiles_per_split, st,
                           window, stream);
    case 64:
      return launch<T, 64>(q, k, v, length, o, ws_acc, ws_ml, counters, b,
                           hq, hkv, S, num_splits, tiles_per_split, st,
                           window, stream);
    case 128:
      return launch<T, 128>(q, k, v, length, o, ws_acc, ws_ml, counters, b,
                            hq, hkv, S, num_splits, tiles_per_split, st,
                            window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides: 10 element strides, (batch,
// head) of q, (batch, head, seq) of k and v, (batch, head) of o; the
// head_dim axis must be contiguous, and q, k and v 16-byte aligned with
// their strides multiples of 16 bytes.  length: a device int32 scalar.
// ws_acc [b, hq, num_splits, hd] and ws_ml [b, hq, num_splits, 2] are
// float32 scratch the caller allocates; counters [b, hkv] int32 must be 0
// at launch, used by no launch in flight on another stream, and are 0
// again when the launch ends.  Returns the cudaError_t of the launch.
int repro_flash_decode(const void* q, const void* k, const void* v,
                       const int* length, void* o, float* ws_acc,
                       float* ws_ml, int* counters, int dtype, int b, int hq,
                       int hkv, int S, int hd, int num_splits,
                       int tiles_per_split, const long long* strides,
                       int window, int device, void* stream) {
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
  const long long vec = dtype == 0 ? 4 : 8;
  for (int i = 0; i < 8; ++i)
    if (strides[i] % vec) return cudaErrorMisalignedAddress;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16)
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, length, o, ws_acc, ws_ml,
                              counters, b, hq, hkv, S, num_splits,
                              tiles_per_split, st, window, s);
  if (dtype == 1)
    return dispatch_hd<bf16>(hd, q, k, v, length, o, ws_acc, ws_ml, counters,
                             b, hq, hkv, S, num_splits, tiles_per_split, st,
                             window, s);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
