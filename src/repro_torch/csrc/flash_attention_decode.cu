// Flash attention (forward) for calls with few query rows per (batch, kv
// head) -- decode against the cache -- as split-KV: the kv axis is cut
// into splits of a few 64-slot chunks, one block per (split, kv head,
// batch), and a second kernel combines the splits' partial results.
//
// Replaces flash_attention_tpu (src/repro/kernels/flash_attention.py:81)
// for Sq * G <= 16 rows per (batch, kv head); the function is the one
// csrc/flash_attention.cu computes:
//
//   q [B, Sq, H, D], k [B, Skv, KH, D], v [B, Skv, KH, Dv] (float32 or
//   bfloat16, one dtype; D and Dv <= 256, rows of a multiple of 16
//   bytes), q_pos [Sq], kv_pos [Skv] int32  ->  out [B, Sq, H, Dv] in q's
//   dtype.  Query head h reads kv head h / G.  A kv slot with a negative
//   position is masked; with causal, a pair needs 0 <= q_pos - kv_pos
//   (< window when window > 0).  Scores are (q * D^-0.5) . k, then
//   cap * tanh(s / cap) when cap > 0.  A row with no unmasked slot gives
//   0.  Accumulation is float32 throughout.
//
// Why split: at decode a (batch, kv head) has Sq * G = 4 rows, so one block
// per (batch, kv head), as csrc/flash_attention.cu has it, puts 64 blocks
// on 132 SMs and walks the 1064 slots in series.  Here the wrapper sizes
// the splits for ~512 blocks (6 splits of 3 chunks x 64 pairs = 384 at
// the serving shape: one wave at 3 blocks per SM).
//
// Split kernel, per block: the positions of its chunks decide first which
// chunks hold an unmasked (row, slot) pair; a split with none writes
// m = -inf, l = 0 and reads no K/V.  The live chunks' K and V go to two
// shared-memory buffers with 16-byte cp.async copies (slots past Skv
// zero-filled), the next chunk landing while this one is computed: scores
// of every (row, slot) pair (K rows padded to an odd number of 16-byte
// units: conflict-free vector reads), the running max and sum per row (a
// warp per row), then acc = acc * corr + p . V in registers (a thread per
// column pair and share of the slots).  It writes the float32 partials
// (m, l, acc[Dv]) of each row to scratch the wrapper allocates.
// Combine kernel: out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s
// over the splits with m_s > -inf (M their max); 0 when there are none.
// Given an lse buffer it also writes each row's log-sum-exp of its
// scores, M + log(sum_s e^(m_s - M) l_s) (-inf when nothing is unmasked):
// what a caller needs to combine this call's output with attention over
// other kv slots (sharded serving's ranks, each holding a block of the
// cache).
//
// Bound on the H100: the bytes of K and V of the written slots (decode
// reads each once, 4 rows per kv head are far below the tensor cores'
// ridge).  Known limits: the partials cost 2 * (Dv + 2) * 4 bytes per row
// and split of extra traffic; a block's barriers (4 per chunk) leave the
// SM's loads to the other blocks and the prefetch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 64;      // kv slots per block
constexpr int kMaxRows = 16;
constexpr int kMaxChunksPerSplit = 16;
constexpr size_t kMaxSmem = 232448;   // a block's shared memory on sm_90
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

// 16 bytes of T as floats
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// two neighbouring elements as floats
__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float& a,
                                      float& b) {
  const float2 v =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  a = v.x;
  b = v.y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// bytes of a K row in shared memory: a whole number of 16-byte units,
// odd, so the 8 lanes of a 16-byte read phase hit distinct banks
__host__ __device__ __forceinline__ int k_stride(int D, int esz) {
  const int units = (D * esz + 15) / 16;
  return 16 * (units % 2 ? units : units + 1);
}

struct Shape {
  int Sq, Skv, H, KH, D, Dv;
  int cps;      // chunks per split
  int splits;   // ceil(chunks / cps)
  int nbuf;     // K/V buffers: 2 (the next chunk lands during this one's
                // work) where they fit in shared memory, else 1
  int causal, window;
  float cap, scale;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_attention_split_kernel(const T* __restrict__ q,
                                 const T* __restrict__ k,
                                 const T* __restrict__ v,
                                 const int* __restrict__ q_pos,
                                 const int* __restrict__ kv_pos,
                                 float* __restrict__ ml,
                                 float* __restrict__ acc, const Shape sh) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) uint8_t smem[];
  const int G = sh.H / sh.KH;
  const int n_rows = sh.Sq * G;
  const int RP = (n_rows + 3) & ~3;       // rows padded to a float4
  const int KS = k_stride(sh.D, sizeof(T));
  const int VS = sh.Dv * (int)sizeof(T);
  const int pairs = sh.Dv / 2, parts = kThreads / pairs;
  uint8_t* Kb = smem;                                   // nbuf x [64][KS]
  uint8_t* Vb = Kb + sh.nbuf * kChunk * KS;             // nbuf x [64][VS]
  float* Qs = reinterpret_cast<float*>(Vb + sh.nbuf * kChunk * VS);
  float* Ss = Qs + n_rows * sh.D;         // [rows][64] scores
  float* Pt = Ss + n_rows * kChunk;       // [64][RP] probabilities
  float* red = Pt + kChunk * RP;          // [parts][RP][Dv] p . V shares
  float* m_run = red + parts * RP * sh.Dv;   // [RP] running max
  float* l_run = m_run + RP;                 // [RP] running sum
  float* corr = l_run + RP;                  // [RP] this chunk's correction
  int* kp = reinterpret_cast<int*>(corr + RP);   // [cps * 64] positions
  int* qp = kp + sh.cps * kChunk;                // [rows]
  int* live = qp + n_rows;                       // [cps] live chunks
  int* n_live = live + sh.cps;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int n_chunks = (sh.Skv + kChunk - 1) / kChunk;
  const int c0 = split * sh.cps;
  const int n_c = min(sh.cps, n_chunks - c0);
  const size_t part = ((size_t)b * sh.KH + kh) * sh.splits + split;

  for (int i = tid; i < n_c * kChunk; i += kThreads) {
    const int s = c0 * kChunk + i;
    kp[i] = s < sh.Skv ? kv_pos[s] : -1;
  }
  for (int r = tid; r < n_rows; r += kThreads) qp[r] = q_pos[r / G];
  for (int r = tid; r < RP; r += kThreads) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.0f;
  }
  __syncthreads();
  // ---- live chunks: some (row, slot) pair unmasked; a warp per chunk --
  for (int c = warp; c < n_c; c += kThreads / 32) {
    bool any = false;
    for (int e = lane; e < kChunk; e += 32) {
      const int p = kp[c * kChunk + e];
      bool ok = p >= 0 && !sh.causal;
      for (int r = 0; r < n_rows && p >= 0 && !ok; ++r) {
        const int rel = qp[r] - p;
        ok = rel >= 0 && (sh.window <= 0 || rel < sh.window);
      }
      any = any || ok;
    }
    any = __any_sync(0xffffffffu, any);
    if (lane == 0) live[c] = any;
  }
  __syncthreads();
  if (tid == 0) {   // the flags become the list of live chunks, in place
    int count = 0;
    for (int c = 0; c < n_c; ++c) {
      if (live[c]) live[count++] = c;
    }
    *n_live = count;
  }
  __syncthreads();
  const int nl = *n_live;
  if (nl == 0) {   // nothing unmasked in this split: m = -inf, l = 0
    for (int r = tid; r < n_rows; r += kThreads) {
      ml[(part * n_rows + r) * 2] = -INFINITY;
      ml[(part * n_rows + r) * 2 + 1] = 0.0f;
    }
    return;
  }

  // ---- K, V of a chunk -> shared-memory buffer (16-byte cp.async; slots
  // past Skv zero-filled), one commit group per chunk ---------------------
  const int K16 = sh.D * (int)sizeof(T) / 16, V16 = VS / 16;
  auto load_chunk = [&](int c, int buf) {
    const int s0 = (c0 + c) * kChunk;
    const size_t row0 = ((size_t)b * sh.Skv + s0) * sh.KH + kh;
    uint8_t* Ks = Kb + buf * kChunk * KS;
    uint8_t* Vs = Vb + buf * kChunk * VS;
    for (int idx = tid; idx < kChunk * K16; idx += kThreads) {
      const int r = idx / K16, piece = idx - r * K16;
      const bool ok = s0 + r < sh.Skv;
      cp_async16(Ks + r * KS + piece * 16,
                 ok ? k + (row0 + (size_t)r * sh.KH) * sh.D + piece * VEC : k,
                 ok);
    }
    for (int idx = tid; idx < kChunk * V16; idx += kThreads) {
      const int r = idx / V16, piece = idx - r * V16;
      const bool ok = s0 + r < sh.Skv;
      cp_async16(Vs + r * VS + piece * 16,
                 ok ? v + (row0 + (size_t)r * sh.KH) * sh.Dv + piece * VEC
                    : v,
                 ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  load_chunk(live[0], 0);
  // q rows of this kv head, scaled, as float32 (while the copies land)
  for (int idx = tid; idx < n_rows * sh.D; idx += kThreads) {
    const int r = idx / sh.D, d = idx - r * sh.D;
    const int i = r / G, g = r - i * G;
    Qs[idx] = to_f(q[(((size_t)b * sh.Sq + i) * sh.H + kh * G + g) * sh.D +
                     d]) *
              sh.scale;
  }

  // p . V accumulators: a thread per (column pair, share of the slots),
  // rows in groups of 4
  const int pair = tid % pairs, share = tid / pairs;
  const bool pv = tid < pairs * parts;
  float a[kMaxRows / 4][4][2] = {};

  for (int li = 0; li < nl; ++li) {
    const int buf = sh.nbuf == 2 ? li & 1 : 0, c = live[li];
    if (sh.nbuf == 2 && li + 1 < nl) {   // the next chunk lands meanwhile
      load_chunk(live[li + 1], buf ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const uint8_t* Ks = Kb + buf * kChunk * KS;
    const T* Vt = reinterpret_cast<const T*>(Vb + buf * kChunk * VS);
    const int* kpc = kp + c * kChunk;

    // ---- scores: a warp takes one row and 32 neighbouring slots --------
    for (int idx = tid; idx < n_rows * kChunk; idx += kThreads) {
      const int r = idx / kChunk, e = idx - r * kChunk;
      const float* qr = Qs + r * sh.D;
      const uint8_t* kr = Ks + e * KS;
      float s = 0.0f;
      for (int piece = 0; piece < K16; ++piece) {
        float f[VEC];
        unpack16(*reinterpret_cast<const uint4*>(kr + piece * 16), f);
#pragma unroll
        for (int x = 0; x < VEC; x += 4) {
          const float4 qq =
              *reinterpret_cast<const float4*>(qr + piece * VEC + x);
          s += qq.x * f[x] + qq.y * f[x + 1] + qq.z * f[x + 2] +
               qq.w * f[x + 3];
        }
      }
      if (sh.cap > 0.0f) s = sh.cap * tanhf(s / sh.cap);
      const int p = kpc[e];
      bool ok = p >= 0;
      if (sh.causal) {
        const int rel = qp[r] - p;
        ok = ok && rel >= 0 && (sh.window <= 0 || rel < sh.window);
      }
      Ss[idx] = ok ? s : -INFINITY;
    }
    __syncthreads();

    // ---- running max and sum: a warp per row; p stored slot-major -------
    for (int r = warp; r < RP; r += kThreads / 32) {
      if (r >= n_rows) {   // padding rows: p = 0
        Pt[lane * RP + r] = 0.0f;
        Pt[(lane + 32) * RP + r] = 0.0f;
        if (lane == 0) corr[r] = 0.0f;
        continue;
      }
      const float* sr = Ss + r * kChunk;
      const float x0 = sr[lane], x1 = sr[lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int o = 16; o > 0; o /= 2) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      }
      const float m_old = m_run[r];
      const float m_new = fmaxf(m_old, mx);
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;
      const float p0 = expf(x0 - m_use), p1 = expf(x1 - m_use);
      Pt[lane * RP + r] = p0;
      Pt[(lane + 32) * RP + r] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o /= 2) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      }
      __syncwarp();
      if (lane == 0) {
        const float cr = expf(m_old - m_use);   // 0 while nothing was seen
        corr[r] = cr;
        l_run[r] = l_run[r] * cr + sum;
        m_run[r] = m_new;
      }
    }
    __syncthreads();

    // ---- a = a * corr + p . V ---------------------------------------------
    if (pv) {
#pragma unroll
      for (int gi = 0; gi < kMaxRows / 4; ++gi) {
        const int r0 = 4 * gi;
        if (r0 >= n_rows) break;
        const float4 cr = *reinterpret_cast<const float4*>(corr + r0);
        const float crs[4] = {cr.x, cr.y, cr.z, cr.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[gi][i][0] *= crs[i];
          a[gi][i][1] *= crs[i];
        }
        for (int e = share; e < kChunk; e += parts) {
          float v0, v1;
          load2(Vt + e * (VS / (int)sizeof(T)) + 2 * pair, v0, v1);
          const float4 pp = *reinterpret_cast<const float4*>(Pt + e * RP + r0);
          const float pr[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a[gi][i][0] += pr[i] * v0;
            a[gi][i][1] += pr[i] * v1;
          }
        }
      }
    }
    __syncthreads();   // this buffer, Ss and Pt are free again
    if (sh.nbuf == 1 && li + 1 < nl) load_chunk(live[li + 1], 0);
  }

  // ---- partials: (m, l) and the shares of acc summed ----------------------
  if (pv) {
#pragma unroll
    for (int gi = 0; gi < kMaxRows / 4; ++gi) {
      const int r0 = 4 * gi;
      if (r0 >= n_rows) break;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* dst = red + ((size_t)share * RP + r0 + i) * sh.Dv + 2 * pair;
        dst[0] = a[gi][i][0];
        dst[1] = a[gi][i][1];
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < n_rows * sh.Dv; idx += kThreads) {
    float sum = 0.0f;
    for (int sp = 0; sp < parts; ++sp) sum += red[sp * RP * sh.Dv + idx];
    acc[part * n_rows * sh.Dv + idx] = sum;
  }
  for (int r = tid; r < n_rows; r += kThreads) {
    ml[(part * n_rows + r) * 2] = m_run[r];
    ml[(part * n_rows + r) * 2 + 1] = l_run[r];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_attention_combine_kernel(const float* __restrict__ ml,
                                   const float* __restrict__ acc,
                                   T* __restrict__ out,
                                   float* __restrict__ lse, const Shape sh) {
  const int G = sh.H / sh.KH;
  const int n_rows = sh.Sq * G;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n_rows * sh.Dv) return;
  const int r = idx / sh.Dv, d = idx - r * sh.Dv;
  const size_t part0 = ((size_t)b * sh.KH + kh) * sh.splits;
  // batches of 8 chunks, loads first; each batch rescales to the running
  // max of the chunks seen
  constexpr int kBatch = 8;
  float M = -INFINITY, L = 0.0f, o = 0.0f;
  for (int s0 = 0; s0 < sh.splits; s0 += kBatch) {
    float m[kBatch], l[kBatch], a[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      m[u] = -INFINITY;
      l[u] = a[u] = 0.0f;
      if (s0 + u < sh.splits) {
        const size_t pr = (part0 + s0 + u) * n_rows + r;
        const float2 m_l = *reinterpret_cast<const float2*>(ml + pr * 2);
        m[u] = m_l.x;
        l[u] = m_l.y;
        a[u] = acc[pr * sh.Dv + d];
      }
    }
    float Mb = M;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) Mb = fmaxf(Mb, m[u]);
    if (Mb == -INFINITY) continue;      // nothing unmasked yet
    const float c = expf(M - Mb);       // 0 while nothing was seen
    L *= c;
    o *= c;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      // a chunk with nothing unmasked has m = -inf and an unwritten acc
      const float w = m[u] == -INFINITY ? 0.0f : expf(m[u] - Mb);
      L += w * l[u];
      o += w == 0.0f ? 0.0f : w * a[u];
    }
    M = Mb;
  }
  o = M == -INFINITY ? 0.0f : o / fmaxf(L, 1e-20f);
  const int i = r / G, g = r - i * G;
  out[(((size_t)b * sh.Sq + i) * sh.H + kh * G + g) * sh.Dv + d] =
      from_f<T>(o);
  // lse [B, H, Sq]: one thread a row writes it
  if (lse != nullptr && d == 0) {
    lse[((size_t)b * sh.H + kh * G + g) * sh.Sq + i] =
        M == -INFINITY ? -INFINITY : M + logf(L);
  }
}

size_t smem_bytes(int D, int Dv, int esz, int n_rows, int cps, int nbuf) {
  const size_t RP = (n_rows + 3) & ~3, parts = kThreads / (Dv / 2);
  return nbuf * (size_t)kChunk * (k_stride(D, esz) + Dv * esz) +
         4 * ((size_t)n_rows * D + (size_t)n_rows * kChunk + kChunk * RP +
              parts * RP * Dv + 3 * RP) +
         4 * ((size_t)cps * kChunk + n_rows + cps + 1);
}

// K/V buffers a block holds: 2 (the next chunk lands during this one's
// math) where they fit the block's shared memory, else 1.
int nbuf_for(int D, int Dv, int esz, int n_rows, int cps) {
  return smem_bytes(D, Dv, esz, n_rows, cps, 2) <= kMaxSmem ? 2 : 1;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* q_pos,
           const int* kv_pos, void* out, float* ml, float* acc, float* lse,
           int B, Shape sh, cudaStream_t stream) {
  const int n_rows = sh.Sq * (sh.H / sh.KH);
  sh.nbuf = nbuf_for(sh.D, sh.Dv, sizeof(T), n_rows, sh.cps);
  const size_t smem =
      smem_bytes(sh.D, sh.Dv, sizeof(T), n_rows, sh.cps, sh.nbuf);
  auto split = flash_attention_split_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      split, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  split<<<dim3(sh.splits, sh.KH, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, kv_pos, ml, acc, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_rows * sh.Dv + kThreads - 1) / kThreads;
  flash_attention_combine_kernel<T><<<dim3(blocks, sh.KH, B), kThreads, 0,
                                      stream>>>(ml, acc,
                                                static_cast<T*>(out), lse,
                                                sh);
  return (int)cudaGetLastError();
}

}  // namespace

// A split is cps consecutive 64-slot chunks (1 <= cps <= 16); ml
// [B, KH, splits, Sq*G, 2] and acc [B, KH, splits, Sq*G, Dv] are float32
// scratch, splits = ceil(ceil(Skv / 64) / cps) (the wrapper's
// split_kv_chunks_per_split).  lse: null, or float32 [B, H, Sq] that
// receives each row's log-sum-exp (the combine kernel's comment).  dtype:
// 0 = float32, 1 = bfloat16.  window <= 0 means none; logit_cap <= 0
// means none.  Returns cudaGetLastError() after the launches.
extern "C" int flash_attention_decode_launch(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* kv_pos, void* out, void* ml, void* acc, void* lse, int B,
    int Sq, int Skv, int H, int KH, int D, int Dv, int causal, int window,
    int dtype, int cps, float logit_cap, void* stream) {
  const int esz = dtype == 0 ? 4 : 2;
  if (B <= 0 || Sq <= 0 || Skv < 0 || H <= 0 || KH <= 0 || H % KH != 0 ||
      D <= 0 || Dv <= 0 || D > kMaxDim || Dv > kMaxDim ||
      (D * esz) % 16 != 0 || (Dv * esz) % 16 != 0 ||
      Sq * (H / KH) > kMaxRows || (dtype != 0 && dtype != 1) || cps < 1 ||
      cps > kMaxChunksPerSplit) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Skv == 0) {   // nothing to attend: every row gives 0
    cudaMemsetAsync(out, 0, (size_t)B * Sq * H * Dv * esz, s);
    // the wrapper fills an lse itself (-inf) and never launches here
    if (lse != nullptr) return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
  }
  Shape sh;
  sh.Sq = Sq;
  sh.Skv = Skv;
  sh.H = H;
  sh.KH = KH;
  sh.D = D;
  sh.Dv = Dv;
  sh.cps = cps;
  sh.splits = ((Skv + kChunk - 1) / kChunk + cps - 1) / cps;
  sh.causal = causal;
  sh.window = window;
  sh.cap = logit_cap;
  sh.scale = 1.0f / sqrtf((float)D);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  float* m = static_cast<float*>(ml);
  float* a = static_cast<float*>(acc);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) {
    return launch<float>(q, k, v, qp, kp, out, m, a, l, B, sh, s);
  }
  return launch<__nv_bfloat16>(q, k, v, qp, kp, out, m, a, l, B, sh, s);
}

// The dynamic shared memory flash_attention_decode_launch requests for its
// split kernel at D, Dv, dtype, n_rows = Sq * (H / KH) rows a kv head and
// cps chunks a split, after its choice of K/V buffers (*dyn), and that
// kernel's static shared memory (*stat).  Returns the attribute call's
// error.
extern "C" int flash_attention_decode_smem(int D, int Dv, int dtype,
                                           int n_rows, int cps, int* dyn,
                                           int* stat) {
  const int esz = dtype == 0 ? 4 : 2;
  if (D <= 0 || Dv <= 1 || D > kMaxDim || Dv > kMaxDim || n_rows <= 0 ||
      n_rows > kMaxRows || cps < 1 || cps > kMaxChunksPerSplit ||
      (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  *dyn = (int)smem_bytes(D, Dv, esz, n_rows, cps,
                         nbuf_for(D, Dv, esz, n_rows, cps));
  cudaFuncAttributes a;
  const cudaError_t e =
      dtype == 0
          ? cudaFuncGetAttributes(&a, flash_attention_split_kernel<float>)
          : cudaFuncGetAttributes(
                &a, flash_attention_split_kernel<__nv_bfloat16>);
  *stat = e == cudaSuccess ? (int)a.sharedSizeBytes : -1;
  return (int)e;
}
