// Fused Metropolis annealing of the CFN placement: whole chains in one launch.
//
// Replaces fused_anneal_tpu (src/repro/kernels/placement_power.py:377).
//
// What bounds it on the H100: each chain is a strictly sequential walk of T
// small steps, so the time is T times the latency of one step's dependent
// path; bytes (a few MB of proposals and route rows) and operations are
// orders of magnitude below the card's rates.  The design therefore cuts
// the per-step critical path:
//
//   * ONE WARP RUNS ONE CHAIN.  A step has no block barrier: __syncwarp and
//     warp shuffles only.  The chain's placement X[J], its best placement
//     bX[J] and its loads omega[P], theta[P], lambda[N] stay in shared
//     memory for all T steps; cpb chains (warps) share one block.
//   * The per-node parameters are staged in shared memory once per block
//     (8 x P and 4 x (N + 1) floats), so no step reads them from global
//     memory.
//   * The touched route ids: slot s = (route r, position k), r = leg * D + d
//     (leg 0 removal at p_old, leg 1 insertion at p_new; d the incident
//     link), M = 2 * D * K slots, lane s % 32 takes slot s (two slots a lane
//     at city scale, M = 56; SPL slots a lane at most).  A route's own ids
//     are distinct (shortest paths), so an id is shared only ACROSS routes:
//     each valid slot ORs bit r into a per-chain table tab[id] ((N + 1) x
//     ceil(2D / 32) 32-bit words, set and cleared every step; native
//     shared-memory atomics).  The lowest set bit marks the id's first slot,
//     which sums the routes' signed bitrates in route (= slot) order -- a
//     loop of 2D shuffles from the lanes that hold them -- then snaps and
//     scores the id once: no O(M^2) scan.
//   * d_net and d_viol: each lane sums its slots in slot order, then a
//     __shfl_xor_sync butterfly over the 32 lanes.  The processing terms at
//     p_old / p_new run on six lanes at once (Eq.(2) before and after at
//     both nodes, the violation change at each), gathered by shuffles.
//   * The route ids of step t + 1 are read during step t, from the
//     placement as it is before step t's commit; step t + 1 reads them
//     again only if step t moved a VM they depend on (its own VM or one at
//     the other end of its links).  The proposals (j, p_new, u, T) of 32
//     steps sit in the lanes' registers, the next 32 already in flight;
//     F[j] and the incident-link rows are loaded two steps ahead.  So the
//     one load that depends on the chain state -- the route row, an L2 hit
//     (12.3 MB table at P = 468, K = 14) -- is off the step's path.
//   * Every division by 1000 is three inline operations (div1e3, rounded
//     as "/" rounds), and the divisions left skip zero numerators, so no
//     step takes the division's slow path; D = 1, 2 (chains of VMs) are
//     compile-time constants (template DT), so their loops unroll.
//   * The best placement follows the live one through a log of the moves
//     accepted since the last improvement: an improvement replays the log
//     onto bX (a full copy only when the log overflowed).
//   * Variant GX (global state): when a chain's X and bX do not fit in
//     shared memory (at city_p468, J > 26267 VMs), they live in global
//     memory -- X in a [C, J] scratch the wrapper allocates, bX in the
//     output itself -- and everything else stays in shared memory.  A step
//     reads X only at the moved VM and its D neighbours and writes it only
//     at the moved VM, so the variant adds about D + 1 L1/L2 accesses a
//     step; the warp that writes X is the only one that reads it, so
//     __syncwarp orders it as it orders shared memory.  The arithmetic and
//     its order are those of the shared variant.
//
// The arithmetic is that of fused_anneal_ref, operation for operation and
// in its order, with products and sums rounded separately (__fmul_rn /
// __fadd_rn: no fused multiply-add), so the kernel and its plain version
// accept the same moves.  The Metropolis test is
// delta < 0 || u < expf(-max(delta, 0) / max(T, 1e-9)), with expf.
#include <cuda_runtime.h>

namespace {

constexpr float kActiveEps = 1.0e-6f;
constexpr float kPenalty = 1.0e4f;
constexpr float kSnapGflops = 1.0e-3f;
constexpr float kSnapMbps = 1.0e-2f;
constexpr int kLog = 128;        // accepted moves remembered for bX
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float relu(float x) { return fmaxf(x, 0.0f); }
__device__ __forceinline__ float snap(float x, float e) {
  return fabsf(x) < e ? 0.0f : x;
}
__device__ __forceinline__ float fm(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float fa(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float fs(float a, float b) {
  return __fsub_rn(a, b);
}
// x / y (y > 0), IEEE-rounded like "/".  A zero numerator -- an idle node,
// a padding slot -- skips the division: its range check would send the
// whole warp down the division's slow path.
__device__ __forceinline__ float fdiv(float x, float y) {
  const float q = __fdiv_rn(x == 0.0f ? 1.0f : x, y);
  return x == 0.0f ? x : q;
}
// x / 1000, IEEE-rounded like "/", in three inline operations: q0 = x * r
// with r = RN(1/1000), the exact remainder e = x - 1000 q0 by one FMA, and
// q0 + e r rounded once by another.  Before that last rounding q0 + e r
// lies within (1000 r - 1) * 2 ulp < 1e-7 ulp of x / 1000, while x / 1000
// (x = X 2^F, X < 2^24) is never nearer than 0.002 ulp to a rounding
// midpoint, so the rounding is that of x / 1000 -- for 0 (which keeps its
// sign) and every |x| >= 1e-30, away from the subnormal quotients.  The
// inputs here are loads snapped to 0 or >= 1e-2 and products of their
// differences, all inside that range.
__device__ __forceinline__ float div1e3(float x) {
  const float q0 = __fmul_rn(x, 1e-3f);
  const float q = __fmaf_rn(__fmaf_rn(-q0, 1e3f, x), 1e-3f, q0);
  return x == 0.0f ? x : q;
}

// Shared-memory rows of the staged per-node parameters.
enum { kE, kCpr, kPi, kPue, kEL, kSharePi, kCap, kClan, kProcRows };
enum { kEps, kPueN, kIdlePi, kCnet, kNetRows };

// Eq.(2) power of one processing node, as fused_anneal_ref's proc():
// pue * (E*om + ceil(om/C)*pi + EL*th/1e3 + phi*share_pi).
__device__ __forceinline__ float proc_power(float om, float th,
                                            const float* pk, int P, int p) {
  const float phi = (om > kActiveEps || th > kActiveEps) ? 1.0f : 0.0f;
  float s = fm(pk[kE * P + p], om);
  s = fa(s, fm(ceilf(fdiv(om, pk[kCpr * P + p])), pk[kPi * P + p]));
  s = fa(s, div1e3(fm(pk[kEL * P + p], th)));
  s = fa(s, fm(phi, pk[kSharePi * P + p]));
  return fm(pk[kPue * P + p], s);
}

// Capacity-violation change at one processing node.
__device__ __forceinline__ float proc_viol(float om, float om2, float th,
                                           float th2, const float* pk, int P,
                                           int p) {
  const float cap = pk[kCap * P + p], C_lan = pk[kClan * P + p];
  float v = fs(relu(fs(om2, cap)), relu(fs(om, cap)));
  v = fa(v, relu(fs(div1e3(th2), C_lan)));
  return fs(v, relu(fs(div1e3(th), C_lan)));
}

struct ChainSmem {
  unsigned* tab;            // [N + 1][W] route bits per node id
  int* X;                   // [J] live placement (global memory under GX)
  int* bX;                  // [J] best placement (global memory under GX)
  float* omega;             // [P]
  float* theta;             // [P]
  float* lam;               // [N + 1] (entry N is never written)
  int* inc_o;               // [2][D] incident rows of steps t, t + 1
  float* inc_h;             // [2][D]
  int* log;                 // [kLog] moves accepted since the last best
};

// 32-bit words of route bits per node id (2D routes)
__host__ __device__ inline int words(int D) { return (2 * D + 31) / 32; }

// Shared memory of one chain; X and bX only when they live there (!gx).
__host__ __device__ inline size_t chain_bytes(int J, int P, int N, int D,
                                              bool gx) {
  const size_t b = 4 * ((size_t)(N + 1) * words(D) + (gx ? 0 : 2 * (size_t)J)
                        + 2 * P + (N + 1) + 4 * D + kLog);
  return (b + 15) & ~(size_t)15;
}

__host__ __device__ inline size_t param_bytes(int P, int N) {
  const size_t b = 4 * ((size_t)kProcRows * P + (size_t)kNetRows * (N + 1));
  return (b + 15) & ~(size_t)15;
}

// Chain c's state: under gx, X and bX are its rows of the global scratch
// Xg and of the output bXg, and the shared memory holds the rest.
__device__ ChainSmem carve(unsigned char* base, int J, int P, int N, int D,
                           bool gx, int* Xg, int* bXg) {
  ChainSmem m;
  m.tab = reinterpret_cast<unsigned*>(base);
  int* rest = reinterpret_cast<int*>(m.tab + (N + 1) * words(D));
  m.X = gx ? Xg : rest;
  m.bX = gx ? bXg : rest + J;
  m.omega = reinterpret_cast<float*>(gx ? rest : rest + 2 * J);
  m.theta = m.omega + P;
  m.lam = m.theta + P;
  m.inc_o = reinterpret_cast<int*>(m.lam + (N + 1));
  m.inc_h = reinterpret_cast<float*>(m.inc_o + 2 * D);
  m.log = reinterpret_cast<int*>(m.inc_h + 2 * D);
  return m;
}

// Proposals of the 32 steps from t0 on: lane l gets step t0 + l's.
__device__ __forceinline__ void chunk(const int* jprop, const int* pprop,
                                      const float* uprop, const float* temps,
                                      size_t row, int T, int t0, int lane,
                                      int& jv, int& pv, float& uv,
                                      float& tv) {
  const int t = t0 + lane;
  if (t < T) {
    jv = jprop[row + t];
    pv = pprop[row + t];
    uv = uprop[row + t];
    tv = temps[t];
  }
}

// Incident rows of VM jj: lane d gets link d's (other VM, bitrate, jj is
// its source); D <= 32.
__device__ __forceinline__ void inc_row(const int* inc_other,
                                        const float* inc_h,
                                        const int* inc_src, int jj, int D,
                                        int lane, int& o, float& h, int& sv) {
  o = 0;
  h = 0.f;
  sv = 0;
  if (lane < D) {
    o = inc_other[(size_t)jj * D + lane];
    h = inc_h[(size_t)jj * D + lane];
    sv = inc_src[(size_t)jj * D + lane];
  }
}

// Route ids of one step's slots (moving VM jj to pnew; its rows o_r, h_r,
// s_r in lanes d < D), reading the placement X as it is now.  Slot i of
// this lane is route (leg1, dd) position kk; N for padding.
template <int SPL>
__device__ __forceinline__ void route_ids(
    const int* X, const int* route, int jj, int pnew, int o_r, float h_r,
    int s_r, const int (&dd)[SPL], const int (&kk)[SPL],
    const bool (&in_m)[SPL], const bool (&leg1)[SPL], int P, int N, int K,
    int (&ids)[SPL]) {
  const int pold = X[jj];
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    const int o = __shfl_sync(kFull, o_r, dd[i]);
    const float h = __shfl_sync(kFull, h_r, dd[i]);
    const int src = __shfl_sync(kFull, s_r, dd[i]);
    ids[i] = N;
    if (in_m[i] && h != 0.0f) {
      const int a = leg1[i] ? pnew : pold;
      const int q = (o == jj) ? a : X[o];
      const int rw = src ? a * P + q : q * P + a;
      ids[i] = route[(size_t)rw * K + kk[i]];
    }
  }
}

// SPL: slots a lane holds (M <= 32 * SPL); DT: D when it is known at
// compile time (the chains' D = 1, 2), 0 otherwise; GX: X and bX in global
// memory (Xs the [C, J] scratch of X), else in shared memory.
template <int SPL, int DT, bool GX>
__global__ void fused_anneal_kernel(
    const int* __restrict__ X0, const int* __restrict__ jprop,
    const int* __restrict__ pprop, const float* __restrict__ uprop,
    const float* __restrict__ temps, const int* __restrict__ inc_other,
    const float* __restrict__ inc_h, const int* __restrict__ inc_src,
    const float* __restrict__ omega0, const float* __restrict__ theta0,
    const float* __restrict__ lam0, const float* __restrict__ obj0,
    const float* __restrict__ F, const int* __restrict__ route,
    const float* __restrict__ pp, const float* __restrict__ nn,
    int* __restrict__ bX_out, float* __restrict__ stats,
    int* __restrict__ Xs, int C, int J, int T, int D_arg, int P, int N,
    int K) {
  const int D = DT > 0 ? DT : D_arg;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* pk = reinterpret_cast<float*>(smem_raw);  // [kProcRows][P]
  float* nk = pk + kProcRows * P;                   // [kNetRows][N + 1]

  // ---- per-node parameters, once per block (fused_anneal_ref's pk, nk) --
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    pk[kE * P + p] = pp[p];
    pk[kCpr * P + p] = pp[P + p];
    pk[kPi * P + p] = pp[3 * P + p];
    pk[kPue * P + p] = pp[4 * P + p];
    pk[kEL * P + p] = pp[5 * P + p];
    pk[kSharePi * P + p] = fm(pp[8 * P + p], pp[7 * P + p]);
    pk[kCap * P + p] = fm(pp[2 * P + p], pp[P + p]);
    pk[kClan * P + p] = pp[6 * P + p];
  }
  for (int n = threadIdx.x; n <= N; n += blockDim.x) {
    const bool in = n < N;
    nk[kEps * (N + 1) + n] = in ? nn[n] : 0.0f;
    nk[kPueN * (N + 1) + n] = in ? nn[3 * N + n] : 0.0f;
    nk[kIdlePi * (N + 1) + n] = in ? fm(nn[4 * N + n], nn[2 * N + n]) : 0.0f;
    nk[kCnet * (N + 1) + n] = in ? nn[N + n] : 0.0f;
  }
  __syncthreads();  // the only block barrier: chains never meet again

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * (blockDim.x >> 5) + warp;
  if (c >= C) return;
  ChainSmem m = carve(smem_raw + param_bytes(P, N) +
                          (size_t)warp * chain_bytes(J, P, N, D, GX),
                      J, P, N, D, GX, GX ? Xs + (size_t)c * J : nullptr,
                      bX_out + (size_t)c * J);
  const int M = 2 * D * K, W = words(D);

  for (int i = lane; i < J; i += 32) {
    const int v = X0[(size_t)c * J + i];
    m.X[i] = v;
    m.bX[i] = v;
  }
  for (int p = lane; p < P; p += 32) {
    m.omega[p] = omega0[(size_t)c * P + p];
    m.theta[p] = theta0[(size_t)c * P + p];
  }
  for (int n = lane; n <= N; n += 32)
    m.lam[n] = n < N ? lam0[(size_t)c * N + n] : 0.0f;
  for (int n = lane; n < (N + 1) * W; n += 32) m.tab[n] = 0u;
  float obj = obj0[c], bobj = obj;
  int n_log = 0;

  // proposals of 32 steps in the lanes' registers: lane l holds step t0 + l
  const size_t row = (size_t)c * T;
  int jc = 0, pc = 0, jn = 0, pnx = 0;
  float uc = 0.f, tc = 0.f, un = 0.f, tn = 0.f;
  chunk(jprop, pprop, uprop, temps, row, T, 0, lane, jc, pc, uc, tc);
  chunk(jprop, pprop, uprop, temps, row, T, 32, lane, jn, pnx, un, tn);
  // step t (j, pn, u, Tt, Fj; its rows oc/hc in registers and staged in
  // shared memory) and step t + 1 (j1 ... F1; its rows o1/h1/s1)
  int j = __shfl_sync(kFull, jc, 0), pn = __shfl_sync(kFull, pc, 0);
  float u = __shfl_sync(kFull, uc, 0), Tt = __shfl_sync(kFull, tc, 0);
  int j1 = __shfl_sync(kFull, jc, 1), p1 = __shfl_sync(kFull, pc, 1);
  float u1 = __shfl_sync(kFull, uc, 1), T1 = __shfl_sync(kFull, tc, 1);
  float Fj = F[j], F1 = T > 1 ? F[j1] : 0.f;
  int oc, sc, o1 = 0, s1 = 0;
  float hc, h1 = 0.f;
  inc_row(inc_other, inc_h, inc_src, j, D, lane, oc, hc, sc);
  if (T > 1) inc_row(inc_other, inc_h, inc_src, j1, D, lane, o1, h1, s1);
  if (lane < D) {
    m.inc_o[lane] = oc;
    m.inc_h[lane] = hc;
  }
  __syncwarp();

  // this lane's slots s = lane + 32 i: route rr = leg * D + d, position kk
  int rr[SPL], kk[SPL], dd[SPL];
  bool in_m[SPL], leg1[SPL];
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    const int s = lane + 32 * i;
    rr[i] = s / K;
    kk[i] = s - rr[i] * K;
    in_m[i] = s < M;
    leg1[i] = rr[i] >= D;
    dd[i] = min(leg1[i] ? rr[i] - D : rr[i], D - 1);
  }
  int sid[SPL];           // step t's ids as read during step t - 1
  bool fresh = true;      // sid unusable: step 0, or a move changed them
  int jprev = -1;

  for (int t = 0; t < T; ++t) {
    const int buf = t & 1, slot = t & 31;
    const int* io = m.inc_o + buf * D;
    const float* ih = m.inc_h + buf * D;

    // ---- step t + 2's proposal, F and incident rows: loads in flight ----
    const int n2 = (slot + 2) & 31;
    const bool hi2 = slot >= 30;
    const int j2 = __shfl_sync(kFull, hi2 ? jn : jc, n2);
    const int p2 = __shfl_sync(kFull, hi2 ? pnx : pc, n2);
    const float u2 = __shfl_sync(kFull, hi2 ? un : uc, n2);
    const float T2 = __shfl_sync(kFull, hi2 ? tn : tc, n2);
    int o2 = 0, s2 = 0;
    float h2 = 0.f, F2 = 0.f;
    if (t + 2 < T) {
      F2 = F[j2];
      inc_row(inc_other, inc_h, inc_src, j2, D, lane, o2, h2, s2);
    }

    // ---- step t's route ids: read during step t - 1 unless its move -----
    // ---- changed an endpoint they depend on -----------------------------
    const int po = m.X[j];
    int id[SPL];
    if (!fresh)
      fresh = jprev == j ||
              __any_sync(kFull, lane < D && hc != 0.0f && oc == jprev);
    if (fresh) {
      route_ids<SPL>(m.X, route, j, pn, oc, hc, sc, dd, kk, in_m, leg1, P, N,
                     K, id);
    } else {
#pragma unroll
      for (int i = 0; i < SPL; ++i) id[i] = sid[i];
    }
    // ... and step t + 1's, read now (valid unless step t moves an input)
    if (t + 1 < T)
      route_ids<SPL>(m.X, route, j1, p1, o1, h1, s1, dd, kk, in_m, leg1, P,
                     N, K, sid);
    // lane r holds route r's signed bitrate (and route r + 32's)
    const float hh_a = lane < 2 * D ? (lane >= D ? ih[lane - D] : -ih[lane])
                                    : 0.0f;
    const float hh_b = lane + 32 < 2 * D ? ih[lane + 32 - D] : 0.0f;

    // ---- processing terms at p_old / p_new ------------------------------
    float H_tot = 0.f, sr = 0.f, si = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float h = ih[d];
      const int o = io[d];
      const int q = m.X[o];
      const int q_rm = (o == j) ? po : q, q_in = (o == j) ? pn : q;
      H_tot = fa(H_tot, h);
      sr = fa(sr, q_rm == po ? h : 0.0f);
      si = fa(si, q_in == pn ? h : 0.0f);
    }
    float s_old = 0.f, s_new = 0.f;  // over [-h removal..., +h insertion...]
#pragma unroll
    for (int leg = 0; leg < 2; ++leg) {
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float hh = leg ? ih[d] : -ih[d];
        const int o = io[d];
        const int q = (o == j) ? (leg ? pn : po) : m.X[o];
        s_old = fa(s_old, q == po ? hh : 0.0f);
        s_new = fa(s_new, q == pn ? hh : 0.0f);
      }
    }
    const float alpha = fa(-fs(H_tot, sr), s_old);
    const float beta = fa(fs(H_tot, si), s_new);
    const bool same = po == pn;
    const float om0 = m.omega[po], om1 = m.omega[pn];
    const float th0 = m.theta[po], th1 = m.theta[pn];
    const float om0n = snap(fa(om0, same ? fa(-Fj, Fj) : -Fj), kSnapGflops);
    const float om1n = snap(fa(om1, same ? fs(Fj, Fj) : Fj), kSnapGflops);
    const float th0n = snap(fa(th0, same ? fa(alpha, beta) : alpha), kSnapMbps);
    const float th1n = snap(fa(th1, same ? fa(beta, alpha) : beta), kSnapMbps);
    // lanes 0-3: Eq.(2) at (p_old new, p_old old, p_new new, p_new old);
    // lanes 4, 5: the violation change at p_old, p_new -- in parallel
    const bool odd = lane & 1, at_new = lane & 2;
    const float pv = proc_power(
        at_new ? (odd ? om1 : om1n) : (odd ? om0 : om0n),
        at_new ? (odd ? th1 : th1n) : (odd ? th0 : th0n), pk, P,
        at_new ? pn : po);
    const float vv = proc_viol(odd ? om1 : om0, odd ? om1n : om0n,
                               odd ? th1 : th0, odd ? th1n : th0n, pk, P,
                               odd ? pn : po);
    const float d_proc = fa(
        fs(__shfl_sync(kFull, pv, 0), __shfl_sync(kFull, pv, 1)),
        fs(__shfl_sync(kFull, pv, 2), __shfl_sync(kFull, pv, 3)));
    const float d_viol_pr =
        fa(__shfl_sync(kFull, vv, 4), __shfl_sync(kFull, vv, 5));

    // ---- per node id: route bits, first slot aggregates and scores ------
    float lo[SPL], lo_v[SPL], eps[SPL], pue[SPL], idle[SPL], C_net[SPL];
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      const int n = id[i];
      lo[i] = m.lam[n];  // entry N is 0 and never written
      eps[i] = nk[kEps * (N + 1) + n];
      pue[i] = nk[kPueN * (N + 1) + n];
      idle[i] = nk[kIdlePi * (N + 1) + n];
      C_net[i] = nk[kCnet * (N + 1) + n];
      lo_v[i] = relu(fs(div1e3(lo[i]), C_net[i]));
      if (n < N) atomicOr(&m.tab[n * W + (rr[i] >> 5)], 1u << (rr[i] & 31));
    }
    __syncwarp();
    unsigned bits[SPL][2];
    bool first[SPL];
#pragma unroll
    for (int i = 0; i < SPL; ++i) {  // row N of the table stays 0
      bits[i][0] = m.tab[id[i] * W];
      bits[i][1] = W > 1 ? m.tab[id[i] * W + 1] : 0u;
      const int low = bits[i][0] ? __ffs(bits[i][0]) - 1
                                 : 31 + __ffs(bits[i][1]);
      first[i] = id[i] < N && low == rr[i];
    }
    // a node id's signed bitrates summed in route order (route r's from
    // lane r % 32)
    float tot[SPL];
#pragma unroll
    for (int i = 0; i < SPL; ++i) tot[i] = 0.0f;
#pragma unroll 4
    for (int r = 0; r < 2 * D; ++r) {
      const float x = __shfl_sync(kFull, r < 32 ? hh_a : hh_b, r & 31);
#pragma unroll
      for (int i = 0; i < SPL; ++i) {
        const unsigned w = r < 32 ? bits[i][0] : bits[i][1];
        const float add = fa(tot[i], x);
        tot[i] = (w >> (r & 31) & 1u) ? add : tot[i];
      }
    }
    float v_net = 0.f, v_viol = 0.f, ln[SPL];
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      ln[i] = snap(fa(lo[i], tot[i]), kSnapMbps);
      const float b_d = (ln[i] > kActiveEps ? 1.0f : 0.0f) -
                        (lo[i] > kActiveEps ? 1.0f : 0.0f);
      const float dn = fm(pue[i], fa(div1e3(fm(eps[i], fs(ln[i], lo[i]))),
                                     fm(b_d, idle[i])));
      const float dv = fs(relu(fs(div1e3(ln[i]), C_net[i])), lo_v[i]);
      const float vn = fa(v_net, dn), vv2 = fa(v_viol, dv);
      v_net = first[i] ? vn : v_net;
      v_viol = first[i] ? vv2 : v_viol;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v_net = fa(v_net, __shfl_xor_sync(kFull, v_net, o));
      v_viol = fa(v_viol, __shfl_xor_sync(kFull, v_viol, o));
    }
    const float d_viol = fa(d_viol_pr, v_viol);
    const float delta = fa(fa(d_proc, v_net), fm(kPenalty, d_viol));
    const bool acc =
        delta < 0.0f || u < expf(fdiv(-fmaxf(delta, 0.0f), fmaxf(Tt, 1e-9f)));
    __syncwarp();  // every lane has read tab / lam / X before the commit

    // ---- commit, best tracking --------------------------------------------
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      if (first[i]) {
        m.tab[id[i] * W] = 0u;
        if (W > 1) m.tab[id[i] * W + 1] = 0u;
        if (acc) m.lam[id[i]] = ln[i];
      }
    }
    if (acc) {
      obj = fa(obj, delta);
      if (lane == 0) {
        m.X[j] = pn;
        m.omega[po] = om0n;
        m.omega[pn] = om1n;
        m.theta[po] = th0n;
        m.theta[pn] = th1n;
        if (n_log < kLog) m.log[n_log] = j;
      }
      ++n_log;
    }
    if (lane < D) {
      m.inc_o[(buf ^ 1) * D + lane] = o1;
      m.inc_h[(buf ^ 1) * D + lane] = h1;
    }
    __syncwarp();
    if (obj < bobj) {
      bobj = obj;
      if (n_log <= kLog) {
        for (int i = lane; i < n_log; i += 32) {
          const int jj = m.log[i];
          m.bX[jj] = m.X[jj];
        }
      } else {
        for (int i = lane; i < J; i += 32) m.bX[i] = m.X[i];
      }
      n_log = 0;
      __syncwarp();  // the log is reused
    }

    fresh = false;
    if (acc) jprev = j;
    else jprev = -1;
    j = j1;
    pn = p1;
    u = u1;
    Tt = T1;
    Fj = F1;
    oc = o1;
    hc = h1;
    sc = s1;
    j1 = j2;
    p1 = p2;
    u1 = u2;
    T1 = T2;
    F1 = F2;
    o1 = o2;
    h1 = h2;
    s1 = s2;
    if (slot == 31) {
      jc = jn;
      pc = pnx;
      uc = un;
      tc = tn;
      chunk(jprop, pprop, uprop, temps, row, T, t + 33, lane, jn, pnx, un, tn);
    }
  }

  if (!GX)  // under GX, bX is the output row itself
    for (int i = lane; i < J; i += 32) bX_out[(size_t)c * J + i] = m.bX[i];
  if (lane == 0) {
    stats[2 * c] = bobj;
    stats[2 * c + 1] = obj;
  }
}

template <int SPL, int DT, bool GX>
int launch(int cpb, size_t smem, cudaStream_t stream, const int* X0,
           const int* jprop, const int* pprop, const float* uprop,
           const float* temps, const int* inc_other, const float* inc_h,
           const int* inc_src, const float* omega0, const float* theta0,
           const float* lam0, const float* obj0, const float* F,
           const int* route, const float* pp, const float* nn, int* bX,
           float* stats, int* Xs, int C, int J, int T, int D, int P, int N,
           int K) {
  cudaError_t e = cudaFuncSetAttribute(
      fused_anneal_kernel<SPL, DT, GX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (C + cpb - 1) / cpb;
  fused_anneal_kernel<SPL, DT, GX><<<grid, 32 * cpb, smem, stream>>>(
      X0, jprop, pprop, uprop, temps, inc_other, inc_h, inc_src, omega0,
      theta0, lam0, obj0, F, route, pp, nn, bX, stats, Xs, C, J, T, D, P, N,
      K);
  return (int)cudaGetLastError();
}

// The template fused_anneal_launch runs for M = 2 D K route slots and D
// (its FA_DISPATCH, as a function pointer).
template <bool GX>
const void* kernel_for(int M, int D) {
  if (M <= 64 && D == 1)
    return reinterpret_cast<const void*>(fused_anneal_kernel<2, 1, GX>);
  if (M <= 64 && D == 2)
    return reinterpret_cast<const void*>(fused_anneal_kernel<2, 2, GX>);
  if (M <= 64)
    return reinterpret_cast<const void*>(fused_anneal_kernel<2, 0, GX>);
  if (M <= 256)
    return reinterpret_cast<const void*>(fused_anneal_kernel<8, 0, GX>);
  return reinterpret_cast<const void*>(fused_anneal_kernel<32, 0, GX>);
}

}  // namespace

// X [C, J] int32 (pins applied); jprop/pprop/uprop [C, T]; temps [T];
// inc_other/inc_h/inc_src [J, D]; omega0/theta0 [C, P], lam0 [C, N],
// obj0 [C]; F [J]; route [P*P, K] int32 (a row's ids distinct); pp [9, P];
// nn [5, N] -> bX [C, J] int32, stats [C, 2] = (best objective, final
// objective).  cpb chains (warps) per block; global_x: the chains' X and bX
// in global memory, Xs a [C, J] int32 scratch (unused otherwise); needs
// D <= 32 and M = 2 * D * K <= 1024.  Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for shapes it does not take).
extern "C" int fused_anneal_launch(
    const int* X0, const int* jprop, const int* pprop, const float* uprop,
    const float* temps, const int* inc_other, const float* inc_h,
    const int* inc_src, const float* omega0, const float* theta0,
    const float* lam0, const float* obj0, const float* F, const int* route,
    const float* pp, const float* nn, int* bX, float* stats, int* Xs, int C,
    int J, int T, int D, int P, int N, int K, int cpb, int global_x,
    void* stream) {
  const int M = 2 * D * K;
  if (D > 32 || M > 1024 || cpb < 1 || cpb > 32 ||
      (global_x && Xs == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      param_bytes(P, N) + (size_t)cpb * chain_bytes(J, P, N, D, global_x);
  cudaStream_t s = (cudaStream_t)stream;
#define FA_ARGS                                                              \
  cpb, smem, s, X0, jprop, pprop, uprop, temps, inc_other, inc_h, inc_src,   \
      omega0, theta0, lam0, obj0, F, route, pp, nn, bX, stats, Xs, C, J, T,  \
      D, P, N, K
#define FA_DISPATCH(GX)                                        \
  do {                                                         \
    if (M <= 64 && D == 1) return launch<2, 1, GX>(FA_ARGS);   \
    if (M <= 64 && D == 2) return launch<2, 2, GX>(FA_ARGS);   \
    if (M <= 64) return launch<2, 0, GX>(FA_ARGS);             \
    if (M <= 256) return launch<8, 0, GX>(FA_ARGS);            \
    return launch<32, 0, GX>(FA_ARGS);                         \
  } while (0)
  if (global_x) FA_DISPATCH(true);
  FA_DISPATCH(false);
#undef FA_DISPATCH
#undef FA_ARGS
}

// The dynamic shared memory fused_anneal_launch requests for cpb chains a
// block of J VMs (P, N, D, K as there; global_x its variant) in *dyn, and
// the static shared memory of the template it runs in *stat.  Returns the
// attribute call's error (cudaErrorInvalidValue for shapes it does not
// take).
extern "C" int fused_anneal_smem(int J, int P, int N, int D, int K, int cpb,
                                 int global_x, int* dyn, int* stat) {
  const int M = 2 * D * K;
  if (D > 32 || M > 1024 || cpb < 1 || cpb > 32)
    return (int)cudaErrorInvalidValue;
  *dyn = (int)(param_bytes(P, N) +
               (size_t)cpb * chain_bytes(J, P, N, D, global_x));
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(
      &a, global_x ? kernel_for<true>(M, D) : kernel_for<false>(M, D));
  *stat = e == cudaSuccess ? (int)a.sharedSizeBytes : -1;
  return (int)e;
}
