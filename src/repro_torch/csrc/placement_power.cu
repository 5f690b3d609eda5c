// Batched full evaluation of the CFN placement objective (paper Eq. 1 + 2).
//
// Replaces placement_power_tpu (src/repro/kernels/placement_power.py:160),
// which builds one-hot [bc, J, P] / [bc, L, P, K] operands so the TPU's
// matrix unit can do the gathers.  Here the loads of a candidate X[b, :]
// -- omega[P] (each VM's GFLOPS at its node), theta[P] (each virtual
// link's bitrate at both endpoint nodes, once when they coincide) and
// lambda[N] (the bitrate along each link's <= K route ids, read straight
// from the int32 CSR route table, sentinel N) -- are accumulated on chip,
// then reduced to (objective, net, proc, violation).
//
// What bounds it on the H100: the bytes of X (B * J * 4) and of the route
// rows the links touch (the 12.3 MB table at P = 468, K = 14 stays in L2);
// the arithmetic is a few adds per VM and per route id.  What keeps a
// kernel far from that bound is contention: nearly every route crosses the
// same few OLT, metro and core nodes, and shared-memory float atomics are
// compare-and-swap loops on this card (ATOMS.CAST.SPIN), so adds into
// lambda spin on a handful of addresses; and a block per candidate leaves
// most of the 132 SMs idle at the main path's B = 32.
//
// The design:
//
//   * A thread-block CLUSTER of cs CTAs evaluates one candidate (cs from
//     placement_power_cluster_size: 8 at B <= 33, 1 from B = 133 on).  CTA
//     rank r accumulates its share of the VMs and links; the cluster then
//     reduces the three load vectors through distributed shared memory
//     (map_shared_rank), each rank summing one slice of the nodes across
//     the ranks and scoring it; rank 0 adds the ranks' partial sums in rank
//     order.
//   * No atomics.  Each warp adds omega and theta into its own copies
//     (8 x 2P floats), lanes that share a node summing first
//     (__match_any_sync, then one write by the lowest lane); each half-warp
//     adds lambda into its own copy (16 x (N + 1) floats), where the ids
//     of one route are distinct.  42 KB of shared memory at city scale; the
//     copies are summed at the end, in a fixed order, so the result does
//     not change from run to run.
//   * The route walk is spread across lanes: a half-warp takes 16 links at
//     a time; for each, lane k reads id k of the route row (one coalesced
//     56-byte read at K = 14), and the 16 rows are in flight together, so
//     a link's ids are not K dependent loads.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kActiveEps = 1.0e-6f;
constexpr float kPenalty = 1.0e4f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;

__device__ __forceinline__ float relu(float x) { return fmaxf(x, 0.0f); }
// x / y (y > 0) as "/" rounds it; a zero numerator (an idle node) skips the
// division, whose range check would send the warp down its slow path.
__device__ __forceinline__ float fdiv(float x, float y) {
  const float q = __fdiv_rn(x == 0.0f ? 1.0f : x, y);
  return x == 0.0f ? x : q;
}

// p in the shared memory of cluster rank `rank` (p + 0 is a prvalue, so the
// pointer overload of map_shared_rank is the one chosen).
__device__ __forceinline__ float* at_rank(float* p, int rank) {
  return cg::this_cluster().map_shared_rank(p + 0, rank);
}

// Adds v at dst[key] for every lane of the warp whose key >= 0, with no
// atomics: dst is a copy only this warp writes, and no two lanes write one
// address at once.  When the keys are distinct each lane adds its own;
// otherwise lanes with equal keys (__match_any_sync) sum their values in
// lane order and the lowest of them adds the sum.  (Shared-memory float
// atomics are compare-and-swap loops on this card, and a hot node's lanes
// would spin in them.)
__device__ __forceinline__ void warp_add(float* dst, int key, float v) {
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  if (__all_sync(0xffffffffu, peers == (1u << (threadIdx.x & 31)))) {
    if (key >= 0) dst[key] += v;
  } else {
    float s = 0.0f;
#pragma unroll
    for (int src = 0; src < 32; ++src) {
      const float y = __shfl_sync(0xffffffffu, v, src);
      s += (peers >> src & 1u) ? y : 0.0f;
    }
    if (key >= 0 && __ffs(peers) - 1 == (int)(threadIdx.x & 31))
      dst[key] += s;
  }
  __syncwarp();
}

// Sum of v over the block; the result is valid in thread 0.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) s += red[w];
  }
  return s;
}

// 5 CTAs a SM: as many as their 42 KB of shared memory (city scale) allow
__global__ void __launch_bounds__(kThreads, 5)
placement_power_kernel(const int* __restrict__ X,
                       const int* __restrict__ link_src,
                       const int* __restrict__ link_dst,
                       const float* __restrict__ F,
                       const float* __restrict__ H,
                       const int* __restrict__ route,
                       const float* __restrict__ pp,
                       const float* __restrict__ nn,
                       float* __restrict__ out,
                       int J, int L, int P, int N, int K) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / cs;
  const int V = 2 * P + N + 1;  // one load vector: omega | theta | lambda
  extern __shared__ float smem[];
  float* ot = smem;                        // [kWarps][2P] omega | theta
  float* lam = ot + kWarps * 2 * P;        // [2 * kWarps][N + 1] lambda
  float* acc = lam + 2 * kWarps * (N + 1); // [V] this CTA's loads
  __shared__ float red[kWarps];
  __shared__ float part[kMaxCluster * 3];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < kWarps * 2 * P + 2 * kWarps * (N + 1); i += kThreads)
    smem[i] = 0.0f;
  __syncthreads();

  const int* x = X + (size_t)b * J;
  float* om_w = ot + warp * 2 * P;         // this warp's copies
  float* th_w = om_w + P;
  float* lam_h = lam + (tid >> 4) * (N + 1);  // this half-warp's copy

  // ---- this rank's VMs, 32 a warp at a time, 4 rounds' loads at once ----
  const int jc = (J + cs - 1) / cs, j0 = rank * jc, j1 = min(J, j0 + jc);
  for (int base = j0 + 32 * warp; base < j1; base += 4 * kThreads) {
    int key[4];
    float val[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = base + u * kThreads + lane;
      key[u] = j < j1 ? x[j] : -1;
      val[u] = j < j1 ? F[j] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) warp_add(om_w, key[u], val[u]);
  }

  // ---- this rank's links, 32 a warp at a time -----------------------------
  // Lane i takes link i's endpoints and adds its theta (warp-aggregated);
  // then each half-warp walks its 16 links' routes: for link i, lane k
  // reads id k of the route row (one coalesced read of K ids), all 16 rows
  // in flight before the adds.  A route's ids are distinct, so the 16
  // lanes of one add never meet; __syncwarp orders one link's adds before
  // the next's.
  const int lc = (L + cs - 1) / cs, l0 = rank * lc, l1 = min(L, l0 + lc);
  const int k0 = lane & 15;
  const unsigned hmask = 0xffffu << (lane & 16);  // this half-warp's lanes
  for (int base = l0 + 32 * warp; base < l1; base += kThreads) {
    const int l = base + lane;
    int a = -1, bb = -1;
    float h = 0.0f;
    if (l < l1) {
      a = x[link_src[l]];
      bb = x[link_dst[l]];
      h = H[l];
    }
    const int row = a != bb ? a * P + bb : -1;  // -1: no route to walk
    warp_add(th_w, a, h);
    warp_add(th_w, bb != a ? bb : -1, h);
    for (int kk = 0; kk < K; kk += 16) {
      const int k = kk + k0;
      int ids[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int ri = __shfl_sync(hmask, row, i, 16);
        ids[i] = (k < K && ri >= 0) ? route[(size_t)ri * K + k] : N;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float hi = __shfl_sync(hmask, h, i, 16);
        if (ids[i] < N) lam_h[ids[i]] += hi;  // sentinel N pads a route
        __syncwarp(hmask);
      }
    }
  }
  __syncthreads();

  // ---- the copies -> this CTA's loads ---------------------------------------
  for (int i = tid; i < V; i += kThreads) {
    float s = 0.0f;
    if (i < 2 * P) {
      for (int w = 0; w < kWarps; ++w) s += ot[w * 2 * P + i];
    } else {
      for (int w = 0; w < 2 * kWarps; ++w) s += lam[w * (N + 1) + i - 2 * P];
    }
    acc[i] = s;
  }
  cluster.sync();  // every rank's acc is complete and visible

  // ---- this rank's slice of the nodes: reduce across ranks, score ---------
  const int I = P + N, ic = (I + cs - 1) / cs, i0 = rank * ic,
            i1 = min(I, i0 + ic);
  float net = 0.0f, proc = 0.0f, viol = 0.0f;
  for (int i = i0 + tid; i < i1; i += kThreads) {
    if (i < P) {
      const int p = i;
      float om = 0.0f, th = 0.0f;
      for (int q = 0; q < cs; ++q) {
        const float* aq = at_rank(acc, q);
        om += aq[p];
        th += aq[P + p];
      }
      const float E = pp[p], C_pr = pp[P + p], NS = pp[2 * P + p];
      const float pi_pr = pp[3 * P + p], pue_pr = pp[4 * P + p];
      const float EL = pp[5 * P + p], C_lan = pp[6 * P + p];
      const float pi_lan = pp[7 * P + p], lan_share = pp[8 * P + p];
      const float phi = (om > kActiveEps || th > kActiveEps) ? 1.0f : 0.0f;
      proc += pue_pr * (E * om + ceilf(fdiv(om, C_pr)) * pi_pr +
                        fdiv(EL * th, 1e3f) + phi * lan_share * pi_lan);
      viol += relu(om - NS * C_pr) + relu(fdiv(th, 1e3f) - C_lan);
    } else {
      const int n = i - P;
      float lm = 0.0f;
      for (int q = 0; q < cs; ++q)
        lm += at_rank(acc, q)[2 * P + n];
      const float eps = nn[n], C_net = nn[N + n], pi_net = nn[2 * N + n];
      const float pue_net = nn[3 * N + n], idle_share = nn[4 * N + n];
      const float beta = lm > kActiveEps ? 1.0f : 0.0f;
      net += pue_net * (fdiv(eps * lm, 1e3f) + beta * idle_share * pi_net);
      viol += relu(fdiv(lm, 1e3f) - C_net);
    }
  }
  net = block_sum(net, red);
  proc = block_sum(proc, red);
  viol = block_sum(viol, red);
  if (tid == 0) {
    float* p0 = at_rank(part, 0);
    p0[3 * rank] = net;
    p0[3 * rank + 1] = proc;
    p0[3 * rank + 2] = viol;
  }
  cluster.sync();  // rank 0 holds every partial; no remote access after
  if (rank == 0 && tid == 0) {
    float s_net = 0.0f, s_proc = 0.0f, s_viol = 0.0f;
    for (int q = 0; q < cs; ++q) {
      s_net += part[3 * q];
      s_proc += part[3 * q + 1];
      s_viol += part[3 * q + 2];
    }
    float* o = out + (size_t)b * 4;
    o[0] = s_net + s_proc + kPenalty * s_viol;
    o[1] = s_net;
    o[2] = s_proc;
    o[3] = s_viol;
  }
}

}  // namespace

// X [B, J] int32 (pins applied), link_src/link_dst [L] int32, F [J],
// H [L], route [P*P, K] int32, pp [9, P], nn [5, N] -> out [B, 4].  cs CTAs
// (a cluster, 1 <= cs <= 8) per candidate.  Returns cudaGetLastError()
// after the launch (or the error of the attribute call before it).
extern "C" int placement_power_launch(const int* X, const int* link_src,
                                      const int* link_dst, const float* F,
                                      const float* H, const int* route,
                                      const float* pp, const float* nn,
                                      float* out, int B, int J, int L, int P,
                                      int N, int K, int cs, void* stream) {
  if (cs < 1 || cs > kMaxCluster) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(kWarps * 2 * P + 2 * kWarps * (N + 1) + 2 * P + N + 1) *
      sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      placement_power_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)B * cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, placement_power_kernel, X, link_src, link_dst,
                         F, H, route, pp, nn, out, J, L, P, N, K);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
