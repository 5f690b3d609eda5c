// Online-softmax attention (flash attention, forward) for the model path.
//
// Replaces flash_attention_tpu (src/repro/kernels/flash_attention.py:81),
// whose grid walks (B * H, q tiles, kv tiles) with the kv axis sequential
// and the running max / sum / accumulator carried in VMEM scratch across
// grid steps.  Here the kv axis is a loop inside one block, and the block
// owns one (batch, kv head, tile of 64 query rows): the rows are the
// (query position, query head) pairs of that kv head, in position-major
// order, so the G query heads that share a kv head (GQA) read each K/V
// tile once from device memory -- the TPU kernel re-reads it per query
// head.
//
//   q [B, Sq, H, D], k [B, Skv, KH, D], v [B, Skv, KH, Dv] (float32 or
//   bfloat16), q_pos [Sq], kv_pos [Skv] int32  ->  out [B, Sq, H, Dv] in
//   q's dtype.  Query head h reads kv head h / G.  A kv slot with a
//   negative position is masked; with causal, a pair needs
//   0 <= q_pos - kv_pos (< window when window > 0).  Scores are
//   (q * D^-0.5) . k, then cap * tanh(s / cap) when cap > 0.  A row with
//   no unmasked slot gives 0.  Accumulation is float32 throughout.
//
// What it takes on the model path (kernels/flash_attention.py::
// choose_kernel): float32 prefill -- no serving or training path runs
// float32 attention; the float32 decode-vs-forward and gradient checks
// do -- and bfloat16 pairs the tensor-core kernel (flash_attention_wgmma.cu)
// does not take: D or Dv not a multiple of 8, D > 192 or Dv > 128.  Every
// bfloat16 call of the repo's configurations goes to that kernel or to
// split-KV; this one also runs any call forced onto it.
//
// Per kv tile of 64 slots: the slots' positions decide first whether any
// pair of the tile can be unmasked (a tile wholly outside the causal /
// window range, or of unwritten cache slots, is skipped before its K/V
// are read); then K and V are staged in shared memory as float32, the
// 64 x 64 score tile is computed with float4 shared-memory reads (each of
// the 256 threads owns 4 rows x 4 slots), the online softmax runs with 4
// threads per row, and the output accumulator -- 2 rows x up to 256
// columns per thread -- stays in registers for the whole kv loop.
//
// Bound on the H100: at decode (Sq = 1) the bytes of K and V; at prefill
// (Sq ~ Skv ~ 1e3, D = 128) the 4 * D operations per unmasked pair, which
// this kernel runs on the float32 CUDA cores, not the tensor cores, so it
// sits far from the bf16 tensor-core bound.  Known limits, for a redesign:
// no tensor cores (wgmma / mma.sync), no overlap of the K/V loads with
// compute (no cp.async / TMA ring), and at decode one block per (batch,
// kv head) -- B * KH = 64 blocks on 132 SMs -- with no split of the kv
// axis across blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;     // (query position, head) rows per block
constexpr int kSlots = 64;    // kv slots per tile
constexpr int kSStride = kSlots + 1;
constexpr int kMaxDim = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// DV_CH: 32-column chunks of the output accumulator each thread keeps
// (Dv padded to 4 must be <= 32 * DV_CH).
template <typename T, int DV_CH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ q_pos,
                       const int* __restrict__ kv_pos, T* __restrict__ out,
                       int Sq, int Skv, int H, int KH, int D, int Dv,
                       int causal, int window, float cap, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int G = H / KH;
  const int Dp = (D + 3) & ~3;          // D padded to a float4
  const int Dvp = (Dv + 3) & ~3;
  // row stride with (stride / 4) odd: the float4 reads of 8 neighbouring
  // rows hit 32 distinct banks
  const int QS = (Dp % 8 == 0) ? Dp + 4 : Dp;
  float* Qs = smem;                     // [kRows][QS]   q * scale
  float* Ks = Qs + kRows * QS;          // [kSlots][QS]
  float* Vs = Ks + kSlots * QS;         // [kSlots][Dvp]
  float* Ss = Vs + kSlots * Dvp;        // [kRows][kSStride] scores, then p
  float* corr_s = Ss + kRows * kSStride;    // [kRows]
  float* l_s = corr_s + kRows;              // [kRows]
  int* qp_s = reinterpret_cast<int*>(l_s + kRows);   // [kRows]
  int* kp_s = qp_s + kRows;                          // [kSlots]
  __shared__ int q_lo, q_hi;

  const int tid = threadIdx.x;
  const int b = blockIdx.z, kh = blockIdx.y;
  const int row0 = blockIdx.x * kRows;  // first (position, head) row
  const int n_rows_all = Sq * G;
  const int n_rows = min(kRows, n_rows_all - row0);

  // ---- query tile: float32, pre-scaled; positions of the rows ----------
  for (int idx = tid; idx < kRows * Dp; idx += kThreads) {
    const int r = idx / Dp, d = idx - r * Dp;
    float x = 0.0f;
    if (r < n_rows && d < D) {
      const int rg = row0 + r, i = rg / G, g = rg - i * G;
      x = to_f(q[(((size_t)b * Sq + i) * H + kh * G + g) * D + d]) * scale;
    }
    Qs[r * QS + d] = x;
  }
  for (int r = tid; r < kRows; r += kThreads) {
    qp_s[r] = r < n_rows ? q_pos[(row0 + r) / G] : 0;
  }
  __syncthreads();
  if (tid == 0) {
    int lo = qp_s[0], hi = qp_s[0];
    for (int r = 1; r < n_rows; ++r) {
      lo = min(lo, qp_s[r]);
      hi = max(hi, qp_s[r]);
    }
    q_lo = lo;
    q_hi = hi;
  }

  // phase A: rows ra + 16 i, slots sa + 16 j
  const int ra = tid / 16, sa = tid % 16;
  // phase B: row rb, slots 16 * quarter + c
  const int rb = tid / 4, quarter = tid % 4;
  // phase C: rows rc + 32 i, columns 4 * cc + 32 j
  const int rc = tid / 8, cc = tid % 8;

  float m_run = -INFINITY, l_run = 0.0f;   // phase-B row statistics
  float4 acc[2][DV_CH];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < DV_CH; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);

  const size_t kv_base = (size_t)b * Skv * KH + kh;
  for (int s0 = 0; s0 < Skv; s0 += kSlots) {
    __syncthreads();   // the previous tile's K/V/S reads are done
    // ---- positions of the tile; skip it if no pair can be unmasked -----
    int live = 0;
    if (tid < kSlots) {
      const int s = s0 + tid;
      const int p = s < Skv ? kv_pos[s] : -1;
      kp_s[tid] = p;
      if (p >= 0) {
        live = !causal ||
               (p <= q_hi && (window <= 0 || p > q_lo - window));
      }
    }
    if (!__syncthreads_or(live)) continue;

    // ---- K and V tiles to shared memory (float32, zero padded) ---------
    for (int idx = tid; idx < kSlots * Dp; idx += kThreads) {
      const int s = idx / Dp, d = idx - s * Dp;
      float x = 0.0f;
      if (s0 + s < Skv && d < D) {
        x = to_f(k[(kv_base + (size_t)(s0 + s) * KH) * D + d]);
      }
      Ks[s * QS + d] = x;
    }
    for (int idx = tid; idx < kSlots * Dvp; idx += kThreads) {
      const int s = idx / Dvp, d = idx - s * Dvp;
      float x = 0.0f;
      if (s0 + s < Skv && d < Dv) {
        x = to_f(v[(kv_base + (size_t)(s0 + s) * KH) * Dv + d]);
      }
      Vs[s * Dvp + d] = x;
    }
    __syncthreads();

    // ---- phase A: scores of 4 rows x 4 slots per thread ----------------
    {
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
      for (int d = 0; d < Dp; d += 4) {
        float4 kk[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) kk[j] = ld4(Ks + (sa + 16 * j) * QS + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (ra + 16 * i < n_rows) {
            const float4 qq = ld4(Qs + (ra + 16 * i) * QS + d);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              sc[i][j] += qq.x * kk[j].x + qq.y * kk[j].y + qq.z * kk[j].z +
                          qq.w * kk[j].w;
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Ss[(ra + 16 * i) * kSStride + sa + 16 * j] = sc[i][j];
    }
    __syncthreads();

    // ---- phase B: online softmax, 4 threads per row --------------------
    {
      const int qp = qp_s[rb];
      float* srow = Ss + rb * kSStride + 16 * quarter;
      const int* kp = kp_s + 16 * quarter;
      float tmax = -INFINITY;
#pragma unroll 4
      for (int c = 0; c < 16; ++c) {
        float s = srow[c];
        if (cap > 0.0f) s = cap * tanhf(s / cap);
        const int p = kp[c];
        bool ok = p >= 0;
        if (causal) {
          const int rel = qp - p;
          ok = ok && rel >= 0 && (window <= 0 || rel < window);
        }
        s = ok ? s : -INFINITY;
        srow[c] = s;
        tmax = fmaxf(tmax, s);
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m_run, tmax);
      float corr = 1.0f, psum = 0.0f;
      if (m_new == -INFINITY) {     // nothing unmasked in this row yet
#pragma unroll 4
        for (int c = 0; c < 16; ++c) srow[c] = 0.0f;
      } else {
        corr = (m_run == -INFINITY) ? 0.0f : expf(m_run - m_new);
#pragma unroll 4
        for (int c = 0; c < 16; ++c) {
          const float s = srow[c];
          const float p = (s == -INFINITY) ? 0.0f : expf(s - m_new);
          srow[c] = p;
          psum += p;
        }
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      l_run = l_run * corr + psum;
      m_run = m_new;
      if (quarter == 0) corr_s[rb] = corr;
    }
    __syncthreads();

    // ---- phase C: acc = acc * corr + p . V -----------------------------
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rc + 32 * i;
      if (r < n_rows) {
        const float cr = corr_s[r];
#pragma unroll
        for (int j = 0; j < DV_CH; ++j) {
          acc[i][j].x *= cr;
          acc[i][j].y *= cr;
          acc[i][j].z *= cr;
          acc[i][j].w *= cr;
        }
      }
    }
    for (int s = 0; s < kSlots; ++s) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = rc + 32 * i;
        if (r < n_rows) {
          const float p = Ss[r * kSStride + s];
#pragma unroll
          for (int j = 0; j < DV_CH; ++j) {
            const int col = 4 * cc + 32 * j;
            if (col < Dvp) {
              const float4 vv = ld4(Vs + s * Dvp + col);
              acc[i][j].x += p * vv.x;
              acc[i][j].y += p * vv.y;
              acc[i][j].z += p * vv.z;
              acc[i][j].w += p * vv.w;
            }
          }
        }
      }
    }
  }

  // ---- epilogue: out = acc / max(l, 1e-20) -------------------------------
  __syncthreads();
  if (quarter == 0) l_s[rb] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rc + 32 * i;
    if (r < n_rows) {
      const float inv = 1.0f / fmaxf(l_s[r], 1e-20f);
      const int rg = row0 + r, qi = rg / G, g = rg - qi * G;
      T* o = out + (((size_t)b * Sq + qi) * H + kh * G + g) * Dv;
#pragma unroll
      for (int j = 0; j < DV_CH; ++j) {
        const int col = 4 * cc + 32 * j;
        const float vals[4] = {acc[i][j].x, acc[i][j].y, acc[i][j].z,
                               acc[i][j].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (col + e < Dv) o[col + e] = from_f<T>(vals[e] * inv);
        }
      }
    }
  }
}

size_t smem_bytes(int D, int Dv) {
  const int Dp = (D + 3) & ~3, Dvp = (Dv + 3) & ~3;
  const int QS = (Dp % 8 == 0) ? Dp + 4 : Dp;
  const size_t floats = (size_t)kRows * QS + (size_t)kSlots * QS +
                        (size_t)kSlots * Dvp + (size_t)kRows * kSStride +
                        2 * kRows;
  return floats * 4 + (size_t)(kRows + kSlots) * 4;
}

template <typename T, int DV_CH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* kv_pos, void* out, int B,
                   int Sq, int Skv, int H, int KH, int D, int Dv, int causal,
                   int window, float cap, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, Dv);
  auto kern = flash_attention_kernel<T, DV_CH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int G = H / KH;
  const dim3 grid((Sq * G + kRows - 1) / kRows, KH, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, kv_pos, static_cast<T*>(out), Sq, Skv,
      H, KH, D, Dv, causal, window, cap, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v,
                         const int* q_pos, const int* kv_pos, void* out,
                         int B, int Sq, int Skv, int H, int KH, int D, int Dv,
                         int causal, int window, float cap,
                         cudaStream_t stream) {
  const int Dvp = (Dv + 3) & ~3;
  if (Dvp <= 32)
    return launch<T, 1>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, H, KH, D,
                        Dv, causal, window, cap, stream);
  if (Dvp <= 64)
    return launch<T, 2>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, H, KH, D,
                        Dv, causal, window, cap, stream);
  if (Dvp <= 128)
    return launch<T, 4>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, H, KH, D,
                        Dv, causal, window, cap, stream);
  return launch<T, 8>(q, k, v, q_pos, kv_pos, out, B, Sq, Skv, H, KH, D, Dv,
                      causal, window, cap, stream);
}

// The template launch_dtype runs for Dv (as a function pointer).
template <typename T>
const void* kernel_for(int Dv) {
  const int Dvp = (Dv + 3) & ~3;
  if (Dvp <= 32)
    return reinterpret_cast<const void*>(flash_attention_kernel<T, 1>);
  if (Dvp <= 64)
    return reinterpret_cast<const void*>(flash_attention_kernel<T, 2>);
  if (Dvp <= 128)
    return reinterpret_cast<const void*>(flash_attention_kernel<T, 4>);
  return reinterpret_cast<const void*>(flash_attention_kernel<T, 8>);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means none; logit_cap
// <= 0 means none.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* kv_pos, void* out, int B, int Sq, int Skv, int H, int KH,
    int D, int Dv, int causal, int window, int dtype, float logit_cap,
    void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || D <= 0 ||
      Dv <= 0 || D > kMaxDim || Dv > kMaxDim || Skv < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  if (dtype == 0)
    return (int)launch_dtype<float>(q, k, v, qp, kp, out, B, Sq, Skv, H, KH,
                                    D, Dv, causal, window, logit_cap, s);
  if (dtype == 1)
    return (int)launch_dtype<__nv_bfloat16>(q, k, v, qp, kp, out, B, Sq, Skv,
                                            H, KH, D, Dv, causal, window,
                                            logit_cap, s);
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory flash_attention_launch requests at D, Dv
// (*dyn) and the static shared memory of the template it runs for dtype
// (*stat).  Returns the attribute call's error.
extern "C" int flash_attention_smem(int D, int Dv, int dtype, int* dyn,
                                    int* stat) {
  if (D <= 0 || Dv <= 0 || D > kMaxDim || Dv > kMaxDim ||
      (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  *dyn = (int)smem_bytes(D, Dv);
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(
      &a, dtype == 0 ? kernel_for<float>(Dv) : kernel_for<__nv_bfloat16>(Dv));
  *stat = e == cudaSuccess ? (int)a.sharedSizeBytes : -1;
  return (int)e;
}
