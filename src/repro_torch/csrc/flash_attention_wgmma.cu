// Flash attention (forward) on Hopper's tensor cores, for prefill.
//
// Replaces flash_attention_tpu (src/repro/kernels/flash_attention.py:81)
// for bfloat16 inputs at every (D, Dv) with both multiples of 8, D <= 192
// and Dv <= 128: the configurations' 32 (smoke), (48, 32) (the MLA
// smoke), 64, 120 (h2o-danube-3-4b), 128 and MLA's (192, 128).  The
// Pallas kernel takes D == Dv only; at (192, 128) this kernel computes the
// JAX package's attend (src/repro/models/layers.py:321) as its MLA
// prefill calls it (:494): K of 128 + 64 rope dims, V of 128.  The
// function is the one csrc/flash_attention.cu computes (that kernel stays
// for float32 and for the pairs this one does not take):
//
//   q [B, Sq, H, D], k [B, Skv, KH, D], v [B, Skv, KH, Dv] bfloat16,
//   q_pos [Sq], kv_pos [Skv] int32  ->  out [B, Sq, H, Dv] bfloat16.
//   Query head h reads kv head
//   h / G.  A kv slot with a negative position is masked; with causal, a
//   pair needs 0 <= q_pos - kv_pos (< window when window > 0).  Scores
//   are (q . k) * D^-0.5, then cap * tanh(s / cap) when cap > 0.  A row
//   with no unmasked slot gives 0.  Products and sums in float32; P is
//   rounded to bfloat16 before P . V (the tensor cores' operand type).
//
// One block owns one (batch, kv head, tile of 128 rows); a row is a
// (query position, query head) pair of that kv head, position-major, so
// the G query heads that share a kv head read each K/V tile once.  With
// G <= 128 a tile holds 128 / G positions x G heads; with G > 128 it holds
// 128 heads of one position.  Rows of the tile past the real ones are
// computed and never written.
//
// Warp roles (288 threads): warps 0-7 are two consumer warpgroups of 64
// rows each; warp 8 is the producer.  Its first lane sets up the
// mbarriers, loads the query tile once, and then keeps a ring of kStages
// K/V tiles (64 slots each) in flight with TMA: one mbarrier per stage for
// "full" (the TMA's transaction bytes) and one for "empty" (one arrival
// per consumer warp).  Each consumer warpgroup, per tile:
//   S = Q K^T      D / 16 steps of wgmma m64n64k16, Q and K from shared
//                  memory (K-major);
//   scale / softcap / mask / online softmax on S in registers (exp2, the
//                  running max and sum per row; a quad of lanes shares a
//                  row);
//   O = O * corr + P V   wgmma m64n{Dv}k16: P converted to bfloat16 in
//                  registers is the A operand, V in shared memory the B
//                  operand read MN-major (transposed by the instruction);
//                  O stays in the accumulator registers for the whole kv
//                  loop.
// The softmax of tile it + 1 runs while P V of tile it is in flight on
// the tensor cores.  Tiles are swizzled 128-byte rows (SWIZZLE_128B): a
// Q or K row of D columns is NCH = ceil(D / 64) boxes of 64 columns (3 at
// D = 192, 2 at 120, 1 at 32), a V row and O's row NCV = ceil(Dv / 64)
// (2 at Dv = 128); the wgmma descriptors step from box to box by the box's
// pitch (kQChunk for Q, kKVChunk for K and V).  Head dims that are not a
// multiple of 64 ride in zero-padded boxes: TMA fills the columns past D
// (or Dv) with zeros, which add nothing to a score, and O's columns past
// Dv are computed from zero V columns and never written.  A row is D x 2
// bytes, a multiple of TMA's 16-byte stride rule when D is a multiple of
// 8.  The template is on (NCH, NCV, CAP); the scale and the output's row
// pitch take the real D and Dv from Params.  Registers per consumer
// thread depend on NCV alone, since Q stays in shared memory: 32 floats of
// S, 32 NCV of O, 16 words of P.
//
// Tile skipping: before any K/V is requested, every warp scans the kv
// positions and marks each 64-slot tile live (it holds a slot some row of
// the block may attend: position >= 0, and with causal inside
// [q_lo - window, q_hi]) and masked (some pair of it is masked, or it runs
// past Skv); producer and consumers walk the same list of live tiles, and
// only masked tiles pay for the per-element mask.  Slots past Skv are
// zero-filled by TMA.  The logit cap is a template parameter, so a model
// without one runs no tanh.
//
// Bound on the H100: the 2 * (D + Dv) operations of each unmasked (row,
// slot) pair (4 * D where Dv == D) at the dense bf16 tensor-core rate, or
// the bytes of q, the attended K/V rows and the output at 3.35 TB/s,
// whichever is longer.  Known limits: 64-slot tiles (m64n64 S products at
// half the width wgmma allows); the softmax's exp2 and max per element on
// two warpgroups, with no third to ping-pong; one block per SM, so each
// block's start (position scan, query load) is not hidden by another
// block; a padded box does the products of its zero columns too (D 120
// runs D 128's S products, D 32 D 64's).  Shared memory a block: 1 KB of
// alignment, Q (NCH boxes of 16 KB) and kStages stages of K (NCH) and V
// (NCV) boxes of 8 KB, then the barriers and the tile list: 132 KB at
// NCH = NCV = 2 (D 65-128); 169 KB at (3, 2), 48 KB of Q and 3 x 40 KB of
// ring, under the 227 KB a block may use.
//
// The TMA descriptors come from libcuda's cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so the library links no
// libcuda of its own.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;              // rows per block
constexpr int kSlots = 64;              // kv slots per tile
constexpr int kStages = 3;              // K/V ring depth
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * (kConsumerWarps + 1);
constexpr int kCols = 64;               // bf16 columns of one 128-byte box
constexpr int kQChunk = kRows * 128;    // bytes of one 64-column Q box
constexpr int kKVChunk = kSlots * 128;  // bytes of one 64-column K or V box
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kLive = 1, kMasked = 2;   // kv tile flags

struct Params {
  const int* q_pos;
  const int* kv_pos;
  __nv_bfloat16* out;
  int Sq, Skv, H, KH, G;
  int Dv;           // output columns (the row pitch of out)
  int GB;           // query heads per box (min(G, 128))
  int P;            // query positions per box (128 / GB)
  int head_tiles;   // tiles along the heads of one kv head
  int n_tiles;      // kv tiles of 64 slots
  int causal, window;
  float sl2;        // D^-0.5 * log2(e): scores to the log2 domain
  float cap_in;     // D^-0.5 / cap
  float cap_out;    // cap * log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers --------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA ----------------------------------------------------------------
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma --------------------------------------------------------------
// Shared-memory matrix descriptor, 128-byte swizzle: start address, the
// leading byte offset (between 64-column boxes along M/N of an MN-major
// operand; unused for K-major), the stride byte offset (between 8-row
// groups: 1024 bytes).
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo) {
  const uint32_t a = smem_u32(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F16(i) F4(i), F4(i + 4), F4(i + 8), F4(i + 12)
#define F32(i) F16(i), F16(i + 16)
#define R32                                                               \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31"
#define R64_HI                                                             \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
  "%60, %61, %62, %63"

// d[64 x 64] (+)= A[64 x 16] (shared, K-major) . B[16 x 64] (shared,
// K-major); accumulate when acc != 0
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" R32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : F32(0)
      : "l"(da), "l"(db), "r"(acc));
}

// d[64 x 64] += A[64 x 16] (registers) . B[16 x 64] (shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 128] += A[64 x 16] (registers) . B[16 x 128] (shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" R32
      ", " R64_HI "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F32(0), F32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x on the special-function unit (2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S = Q K^T of one kv tile (issued, not waited): D / 16 steps of k16
template <int NCH>
__device__ __forceinline__ void issue_qk(float (&sc)[32], const uint8_t* Qw,
                                         const uint8_t* Ks) {
#pragma unroll
  for (int kk = 0; kk < 4 * NCH; ++kk) {
    const int c = kk / 4, off = (kk % 4) * 32;
    wgmma_ss_n64(sc, make_desc(Qw + c * kQChunk + off, 16),
                 make_desc(Ks + c * kKVChunk + off, 16), kk > 0);
  }
}

// O += P V of one kv tile (issued, not waited): P's k16 slices from
// registers, V's 16-slot slices (two 8-row groups of 1024 bytes) from
// shared memory, its 64-column boxes kKVChunk apart (the leading byte
// offset)
template <int NCV>
__device__ __forceinline__ void issue_pv(float (&o)[32 * NCV],
                                         const uint32_t (&pf)[16],
                                         const uint8_t* Vs) {
#pragma unroll
  for (int kk = 0; kk < kSlots / 16; ++kk) {
    const uint32_t a[4] = {pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2],
                           pf[4 * kk + 3]};
    const uint64_t dv = make_desc(Vs + kk * 2048, kKVChunk);
    if constexpr (NCV == 2) {
      wgmma_rs_n128(o, a, dv);
    } else {
      wgmma_rs_n64(o, a, dv);
    }
  }
}

// positions of this thread's 16 columns of a kv tile (-1 past Skv)
__device__ __forceinline__ void load_kv_pos(int (&kp)[16], int s0, int quad,
                                            const Params& prm) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int s = s0 + 8 * j + 2 * quad + e;
      kp[2 * j + e] = s < prm.Skv ? __ldg(prm.kv_pos + s) : -1;
    }
}

// Scale, softcap (CAP) and mask (MASKED: a tile with some masked pair)
// the scores of one tile, update the running max and sum of this
// thread's two rows (log2 domain; a quad of lanes shares a row) and leave
// P in sc; corr is the factor that takes O from the old running max to
// the new one.  Accumulator element 4j + 2h + e is (row h, column
// 8j + 2 quad + e).
template <bool CAP, bool MASKED>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[32], float (&corr)[2], float (&m_run)[2], float (&l_run)[2],
    const int (&kp)[16], const int (&qp)[2], const Params& prm) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = sc[4 * j + 2 * h + e];
        x = CAP ? prm.cap_out * tanhf(x * prm.cap_in) : x * prm.sl2;
        if (MASKED) {
          const int p = kp[2 * j + e];
          bool ok = p >= 0;
          if (prm.causal) {
            const int rel = qp[h] - p;
            ok = ok && rel >= 0 && (prm.window <= 0 || rel < prm.window);
          }
          x = ok ? x : -INFINITY;
        }
        sc[4 * j + 2 * h + e] = x;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[h], mx);
    const float m_use = m_new == -INFINITY ? 0.0f : m_new;
    corr[h] = ex2(m_run[h] - m_use);     // 0 while nothing was seen
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = ex2(sc[4 * j + 2 * h + e] - m_use);
        sc[4 * j + 2 * h + e] = p;
        sum += p;
      }
    l_run[h] = l_run[h] * corr[h] + sum;   // this lane's share of the row
    m_run[h] = m_new;
  }
}

template <bool CAP>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[32], float (&corr)[2], float (&m_run)[2], float (&l_run)[2],
    const int (&kp)[16], int masked, const int (&qp)[2], const Params& prm) {
  if (masked) {
    softmax_tile<CAP, true>(sc, corr, m_run, l_run, kp, qp, prm);
  } else {
    softmax_tile<CAP, false>(sc, corr, m_run, l_run, kp, qp, prm);
  }
}

// P as bf16 A fragments: register 4kk + i of the k16 slice kk packs
// accumulator elements 8kk + 2i and 8kk + 2i + 1
__device__ __forceinline__ void pack_p(const float (&sc)[32],
                                       uint32_t (&pf)[16]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pf[4 * kk + i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
    }
}

template <int NCV>
__device__ __forceinline__ void rescale(float (&o)[32 * NCV],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < 8 * NCV; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      o[4 * j + 2 * h] *= corr[h];
      o[4 * j + 2 * h + 1] *= corr[h];
    }
}

// NCH: 64-column boxes of a Q or K row; NCV: of a V or O row
template <int NCH, int NCV, bool CAP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const Params prm) {
  constexpr int kStageBytes = (NCH + NCV) * kKVChunk;   // K and V of a tile
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles need 1024-byte alignment
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* Qs = smem;                                   // NCH x [128][64]
  uint8_t* KVs = Qs + NCH * kQChunk;                    // kStages x (K, V)
  uint64_t* bars = reinterpret_cast<uint64_t*>(KVs + kStages * kStageBytes);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;
  int* ints = reinterpret_cast<int*>(bars + 1 + 2 * kStages);
  int* n_live = ints;
  int* flags = ints + 4;                 // [n_tiles]
  int* live = flags + prm.n_tiles;       // [n_tiles]

  const int tid = threadIdx.x;
  const int b = blockIdx.z, kh = blockIdx.y;
  // heaviest (latest) query tiles first: under causal masking they walk
  // the most kv tiles
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int p0 = (tile / prm.head_tiles) * prm.P;
  const int g0 = (tile % prm.head_tiles) * prm.GB;
  const int n_pos = min(prm.P, prm.Sq - p0);

  const int warp = tid / 32, lane = tid % 32;
  if (tid == 32 * kConsumerWarps) {
    // the producer's lane: barriers, then the query tile at once
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(q_full, NCH * prm.P * prm.GB * 128);
    for (int c = 0; c < NCH; ++c) {
      tma_load_4d(Qs + c * kQChunk, &tq, q_full, c * kCols, kh * prm.G + g0,
                  p0, b);
    }
  }
  // ---- kv tiles: live (some slot a row of this block may attend) and
  // masked (some pair of the tile is masked, or the tile runs past Skv).
  // Each warp takes the positions' range itself and 4 tiles at a time,
  // all loads issued before any is used.
  {
    int lo = 0x7fffffff, hi = -0x7fffffff - 1;
    for (int i = lane; i < n_pos; i += 32) {
      const int qp = prm.q_pos[p0 + i];
      lo = min(lo, qp);
      hi = max(hi, qp);
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    constexpr int kWarps = kThreads / 32, kUnroll = 4;
    for (int t0 = warp; t0 < prm.n_tiles; t0 += kWarps * kUnroll) {
      int pos[kUnroll][2];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int t = t0 + kWarps * u, s = t * kSlots + lane + 32 * k;
          pos[u][k] = t < prm.n_tiles && s < prm.Skv ? prm.kv_pos[s] : -1;
        }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        bool any = false, all = true;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int p = pos[u][k];
          bool some = p >= 0, every = p >= 0;
          if (prm.causal) {
            some = some && p <= hi && (prm.window <= 0 || p > lo - prm.window);
            every =
                every && p <= lo && (prm.window <= 0 || p > hi - prm.window);
          }
          any = any || some;
          all = all && every;
        }
        any = __any_sync(0xffffffffu, any);
        all = __all_sync(0xffffffffu, all);
        const int t = t0 + kWarps * u;
        if (lane == 0 && t < prm.n_tiles) {
          flags[t] = (any ? kLive : 0) | (all ? 0 : kMasked);
        }
      }
    }
  }
  __syncthreads();
  if (tid < 32) {
    int count = 0;
    for (int t0 = 0; t0 < prm.n_tiles; t0 += 32) {
      const int t = t0 + tid;
      const int f = t < prm.n_tiles ? flags[t] : 0;
      const unsigned m = __ballot_sync(0xffffffffu, f & kLive);
      if (f & kLive) {
        live[count + __popc(m & ((1u << tid) - 1))] =
            2 * t + ((f & kMasked) ? 1 : 0);
      }
      count += __popc(m);
    }
    if (tid == 0) *n_live = count;
  }
  __syncthreads();
  const int n_it = *n_live;

  if (warp == kConsumerWarps) {
    // ================= producer: one lane drives the TMA ring ============
    if (lane == 0) {
      for (int it = 0; it < n_it; ++it) {
        const int st = it % kStages, round = it / kStages;
        if (round > 0) mbar_wait(&empty[st], (round & 1) ^ 1);
        uint8_t* Ks = KVs + st * kStageBytes;
        uint8_t* Vs = Ks + NCH * kKVChunk;
        mbar_expect_tx(&full[st], kStageBytes);
        const int s0 = (live[it] >> 1) * kSlots;
        for (int c = 0; c < NCH; ++c) {
          tma_load_4d(Ks + c * kKVChunk, &tk, &full[st], c * kCols, kh, s0,
                      b);
        }
        for (int c = 0; c < NCV; ++c) {
          tma_load_4d(Vs + c * kKVChunk, &tv, &full[st], c * kCols, kh, s0,
                      b);
        }
      }
    }
    return;
  }

  // ================= consumers: two warpgroups of 64 rows ================
  // Pipelined per warpgroup: the softmax of tile it + 1 runs while the
  // P . V product of tile it is in flight.  The S product of tile it + 1
  // is waited for before P . V is issued: left in flight too (waiting
  // with wait_group 1), ptxas serializes every wgmma of the kernel
  // (advisory C7514), which costs more than the overlap gains.
  const int wg = warp / 4;
  const int quad = lane % 4;
  // this thread's rows: h = 0 -> rA, h = 1 -> rA + 8
  const int rA = 64 * wg + 16 * (warp % 4) + lane / 4;
  int qp[2];
  bool row_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rA + 8 * h;
    const int i = p0 + r / prm.GB, g = g0 + r % prm.GB;
    row_ok[h] = r < prm.P * prm.GB && i < prm.Sq && g < prm.G;
    qp[h] = row_ok[h] ? prm.q_pos[i] : 0;
  }

  float o[32 * NCV];
#pragma unroll
  for (int i = 0; i < 32 * NCV; ++i) o[i] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};
  float sc[32], corr[2];
  uint32_t pf[16];
  int kp[16];

  mbar_wait(q_full, 0);
  const uint8_t* Qw = Qs + wg * 64 * 128;   // this warpgroup's 64 rows
  if (n_it > 0) {
    const int e = live[0];
    if (e & 1) load_kv_pos(kp, (e >> 1) * kSlots, quad, prm);
    mbar_wait(&full[0], 0);
    fence_regs(sc);
    wg_fence();
    issue_qk<NCH>(sc, Qw, KVs);
    wg_commit();
    wg_wait();
    fence_regs(sc);
    softmax_tile<CAP>(sc, corr, m_run, l_run, kp, e & 1, qp, prm);
    pack_p(sc, pf);
  }
  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages;
    const uint8_t* Vs = KVs + st * kStageBytes + NCH * kKVChunk;
    const bool next = it + 1 < n_it;
    const int e = next ? live[it + 1] : 0;
    if (next) {
      if (e & 1) load_kv_pos(kp, (e >> 1) * kSlots, quad, prm);
      const int sn = (it + 1) % kStages;
      mbar_wait(&full[sn], ((it + 1) / kStages) & 1);
      fence_regs(sc);
      wg_fence();
      issue_qk<NCH>(sc, Qw, KVs + sn * kStageBytes);
      wg_commit();
      wg_wait();
      fence_regs(sc);
    }
    rescale<NCV>(o, corr);
    fence_regs(o);
    wg_fence();
    issue_pv<NCV>(o, pf, Vs);
    wg_commit();
    if (next) softmax_tile<CAP>(sc, corr, m_run, l_run, kp, e & 1, qp, prm);
    wg_wait();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
    if (next) pack_p(sc, pf);
  }

  // ---- epilogue: out = O / l, columns below Dv (Dv is a multiple of 8,
  // so a lane's column pair lies wholly on one side) ----------------------
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (!row_ok[h]) continue;
    const float inv = 1.0f / fmaxf(l, 1e-20f);
    const int r = rA + 8 * h;
    const int i = p0 + r / prm.GB, g = g0 + r % prm.GB;
    __nv_bfloat16* dst =
        prm.out +
        (((size_t)b * prm.Sq + i) * prm.H + kh * prm.G + g) * prm.Dv;
#pragma unroll
    for (int j = 0; j < 8 * NCV; ++j) {
      if (8 * j < prm.Dv) {
        *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * quad) = pack_bf16(
            o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
      }
    }
  }
}

// ---- host side ------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A 4-D bf16 map over [d3, d2, d1, d0] (d0 innermost), box
// {64, box1, box2, 1}, 128-byte swizzle, zero fill out of bounds (the
// columns of a box past d0 too).
CUresult make_map(CUtensorMap* map, const void* base, int d0, int d1, int d2,
                  int d3, int box1, int box2) {
  const cuuint64_t dims[4] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2,
                              (cuuint64_t)d3};
  const cuuint64_t strides[3] = {(cuuint64_t)d0 * 2, (cuuint64_t)d0 * d1 * 2,
                                 (cuuint64_t)d0 * d1 * d2 * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kCols, (cuuint32_t)box1,
                             (cuuint32_t)box2, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// alignment, Q, the K/V ring (K and V boxes counted apart), the
// barriers, the live-tile count and the tile flags and list
size_t smem_bytes(int NCH, int NCV, int n_tiles) {
  return 1024 + (size_t)NCH * kQChunk +
         (size_t)kStages * (NCH + NCV) * kKVChunk + 8 * (1 + 2 * kStages) +
         4 * (4 + 2 * (size_t)n_tiles);
}

template <int NCH, int NCV, bool CAP>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, const Params& prm, int B,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(NCH, NCV, prm.n_tiles);
  auto kern = flash_attention_wgmma_kernel<NCH, NCV, CAP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int pos_tiles = (prm.Sq + prm.P - 1) / prm.P;
  const dim3 grid(pos_tiles * prm.head_tiles, prm.KH, B);
  kern<<<grid, kThreads, smem, stream>>>(tq, tk, tv, prm);
  return (int)cudaGetLastError();
}

template <int NCH, int NCV>
int launch_cap(const CUtensorMap& tq, const CUtensorMap& tk,
               const CUtensorMap& tv, const Params& prm, int B, bool cap,
               cudaStream_t stream) {
  return cap ? launch<NCH, NCV, true>(tq, tk, tv, prm, B, stream)
             : launch<NCH, NCV, false>(tq, tk, tv, prm, B, stream);
}

// The template the launcher runs for nch / ncv 64-column boxes and a
// softcap (as a function pointer).
template <int NCH, int NCV>
const void* kernel_cap(bool cap) {
  return cap ? reinterpret_cast<const void*>(
                   flash_attention_wgmma_kernel<NCH, NCV, true>)
             : reinterpret_cast<const void*>(
                   flash_attention_wgmma_kernel<NCH, NCV, false>);
}

const void* kernel_for(int nch, int ncv, bool cap) {
  if (ncv == 1) {
    if (nch == 1) return kernel_cap<1, 1>(cap);
    if (nch == 2) return kernel_cap<2, 1>(cap);
    return kernel_cap<3, 1>(cap);
  }
  if (nch == 1) return kernel_cap<1, 2>(cap);
  if (nch == 2) return kernel_cap<2, 2>(cap);
  return kernel_cap<3, 2>(cap);
}

}  // namespace

// bfloat16 only; D and Dv multiples of 8 with 8 <= D <= 192 and
// 8 <= Dv <= 128 (any other pair returns cudaErrorInvalidValue).  The
// scores' scale is D^-0.5 (the query/key dim).  window <= 0 means none;
// logit_cap <= 0 means none.  Returns cudaGetLastError() after the
// launch, or 10000 + the CUresult of a failed tensor-map encode, or -1
// when libcuda's cuTensorMapEncodeTiled cannot be reached.
extern "C" int flash_attention_wgmma_launch(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* kv_pos, void* out, int B, int Sq, int Skv, int H, int KH,
    int D, int Dv, int causal, int window, float logit_cap, void* stream) {
  const bool dims_ok = D % 8 == 0 && Dv % 8 == 0 && D >= 8 && D <= 192 &&
                       Dv >= 8 && Dv <= 128;
  if (B <= 0 || Sq <= 0 || Skv < 0 || H <= 0 || KH <= 0 || H % KH != 0 ||
      !dims_ok) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Skv == 0) {   // nothing to attend: every row gives 0
    cudaMemsetAsync(out, 0, (size_t)B * Sq * H * Dv * 2, s);
    return (int)cudaGetLastError();
  }
  if (encode_tiled() == nullptr) return -1;
  Params prm;
  prm.q_pos = static_cast<const int*>(q_pos);
  prm.kv_pos = static_cast<const int*>(kv_pos);
  prm.out = static_cast<__nv_bfloat16*>(out);
  prm.Sq = Sq;
  prm.Skv = Skv;
  prm.H = H;
  prm.KH = KH;
  prm.Dv = Dv;
  prm.G = H / KH;
  prm.GB = prm.G < kRows ? prm.G : kRows;
  prm.P = kRows / prm.GB;
  prm.head_tiles = (prm.G + prm.GB - 1) / prm.GB;
  prm.n_tiles = (Skv + kSlots - 1) / kSlots;
  prm.causal = causal;
  prm.window = window;
  const float scale = 1.0f / sqrtf((float)D);
  prm.sl2 = scale * kLog2e;
  prm.cap_in = logit_cap > 0.0f ? scale / logit_cap : 0.0f;
  prm.cap_out = logit_cap * kLog2e;
  CUtensorMap tq, tk, tv;
  CUresult r = make_map(&tq, q, D, H, Sq, B, prm.GB, prm.P);
  if (r == CUDA_SUCCESS) r = make_map(&tk, k, D, KH, Skv, B, 1, kSlots);
  if (r == CUDA_SUCCESS) r = make_map(&tv, v, Dv, KH, Skv, B, 1, kSlots);
  if (r != CUDA_SUCCESS) return 10000 + (int)r;
  const bool cap = logit_cap > 0.0f;
  const int nch = (D + kCols - 1) / kCols, ncv = (Dv + kCols - 1) / kCols;
  if (ncv == 1) {
    if (nch == 1) return launch_cap<1, 1>(tq, tk, tv, prm, B, cap, s);
    if (nch == 2) return launch_cap<2, 1>(tq, tk, tv, prm, B, cap, s);
    return launch_cap<3, 1>(tq, tk, tv, prm, B, cap, s);
  }
  if (nch == 1) return launch_cap<1, 2>(tq, tk, tv, prm, B, cap, s);
  if (nch == 2) return launch_cap<2, 2>(tq, tk, tv, prm, B, cap, s);
  return launch_cap<3, 2>(tq, tk, tv, prm, B, cap, s);
}

// The dynamic shared memory flash_attention_wgmma_launch requests at D, Dv
// and Skv kv slots (*dyn) and the static shared memory of the template it
// runs, with a softcap when cap != 0 (*stat).  Returns the attribute
// call's error (cudaErrorInvalidValue for dims it does not take).
extern "C" int flash_attention_wgmma_smem(int D, int Dv, int Skv, int cap,
                                          int* dyn, int* stat) {
  if (D % 8 != 0 || Dv % 8 != 0 || D < 8 || D > 192 || Dv < 8 ||
      Dv > 128 || Skv < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int nch = (D + kCols - 1) / kCols, ncv = (Dv + kCols - 1) / kCols;
  *dyn = (int)smem_bytes(nch, ncv, (Skv + kSlots - 1) / kSlots);
  cudaFuncAttributes a;
  const cudaError_t e =
      cudaFuncGetAttributes(&a, kernel_for(nch, ncv, cap != 0));
  *stat = e == cudaSuccess ? (int)a.sharedSizeBytes : -1;
  return (int)e;
}
