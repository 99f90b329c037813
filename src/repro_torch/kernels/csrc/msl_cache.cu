// Multi-step LRU row transition kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of src/repro/kernels/msl_cache.py:
//
//   msl_access_kernel  <- msl_access_kernel_call (body _kernel, _transition):
//       one stateless mixed-op transition per pre-gathered set row.
//   msl_onepass_kernel <- msl_onepass_kernel_call (body _onepass_kernel,
//       _chain_body): queries sorted by set id; each same-set chain is applied
//       in rank order, the updated row handed from one member to the next.
//
// Layout.  One warp holds one set row: lane a < A keeps lane a's C int32
// planes in registers.  The probe and the empty-slot search are ballots, the
// cost victim a warp min-reduce plus a ballot, and rotate_insert is one
// __shfl_up_sync by a lane (the GPU form of the paper's vpermd).  Lanes >= A
// are masked out of every ballot and of the min, so A <= 32.  The plane
// counts C and KP are template parameters (C <= 8), so every per-plane loop
// unrolls into straight-line code with no branch.
//
// What bounds them.  msl_access moves B*(2*A*C + KP + V + C + 2) int32 words
// and does a few hundred integer operations per row: it is bound by memory
// bytes, and each warp does its one row and exits.  msl_onepass moves about
// the same bytes, but a chain of L queries on one set is L dependent
// transitions.  At Zipf 0.99 and B = 8192 the hottest set takes some 400
// queries of a batch, so the kernel is bound by the latency of its longest
// chain, not by bytes.  The design keeps that chain's critical path short:
// the row stays in registers for the whole chain; the warp loads the
// operands of 32 chain members at once (lane t holds member t) and hands
// each to the transition by shuffles, so no global load waits inside the
// chain; each member's scalar outputs are kept by its lane and stored
// 32 at a time; and the transition branches only on the configuration
// (cost plane, set_lru), never on a query.
//
// The TPU kernel's block-local chain ranks, per-block round counts and the
// cross-block carry exist because TPU grid cells run in order.  CUDA blocks
// run in no order, so here a warp finds its own chain: a position whose set
// id equals its predecessor's is not a head and exits; a head walks its
// whole chain, however long, and no chain is ever split.
//
// Plain C interface, loaded with ctypes: every launcher returns
// cudaGetLastError() of its launch (cudaErrorInvalidValue, without
// launching, for plane counts it was not built for).

#include <climits>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPlanes = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kEmpty = INT_MIN;    // EMPTY_KEY sentinel
constexpr int kWarpsPerBlock = 8;

// Opcodes: an ABI shared with the Python packages (core/multistep.py).
constexpr int OP_ACCESS = 0;
constexpr int OP_DELETE = 2;
constexpr int OP_LOOKUP = 3;
constexpr int OP_CHAIN_GET = 4;
constexpr int OP_CHAIN_PUT = 5;

// Geometry beside the template plane counts: V + cost_planes == C - KP.
struct Geometry {
  int A, V, M, P, cost_planes, set_lru;
};

// Per-query operands.  A missing ops vector means OP_ACCESS, a missing
// chain_live vector means live, missing costs mean cost 0; with those
// defaults the mixed-op transition equals the ACCESS-only one.
struct Operands {
  const int* qk;      // (B, KP)
  const int* qv;      // (B, V)
  const int* ops;     // (B,) or null
  const int* live;    // (B,) or null
  const int* costs;   // (B,) or null
};

template <int C>
struct Query {
  int item[C];   // the item an insert writes: [key | value | cost]
  int op;
  int live;
};

struct Outputs {
  int* rows;   // (B, A, C)
  int* hit;    // (B,)
  int* pos;    // (B,)
  int* val;    // (B, max(V, 1))
  int* ev;     // (B, C)
};

template <int C>
struct Result {
  int hit, pos;
  int val[C];  // the hit item's planes; the value planes are [KP, KP+V)
  int ev[C];
};

__device__ __forceinline__ int top_lane(unsigned mask) {
  return mask ? 31 - __clz(mask) : -1;
}

template <int C, int KP>
__device__ __forceinline__ void load_query(const Geometry& g, const Operands& in,
                                           int i, Query<C>& q) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (c < KP) {
      q.item[c] = in.qk[(size_t)i * KP + c];
    } else if (c < KP + g.V) {
      q.item[c] = in.qv[(size_t)i * g.V + (c - KP)];
    } else {
      q.item[c] = in.costs != nullptr ? in.costs[i] : 0;
    }
  }
  q.op = in.ops != nullptr ? in.ops[i] : OP_ACCESS;
  q.live = in.live != nullptr ? in.live[i] : 1;
}

template <int C>
__device__ __forceinline__ void load_row(const Geometry& g, const int* row,
                                         int lane, int r[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) r[c] = lane < g.A ? row[lane * C + c] : 0;
}

template <int C>
__device__ __forceinline__ void store_row(const Geometry& g, int* row, int lane,
                                          const int r[C]) {
  if (lane < g.A) {
#pragma unroll
    for (int c = 0; c < C; ++c) row[lane * C + c] = r[c];
  }
}

// Apply query q to the row the warp holds in r (lane a < A holds r[0..C)).
// On return r holds the new row and every lane holds the same outputs.
// vec_start is (lane / P) * P: a shuffle of it from lane x gives x's
// vector start without a division.  Mirrors _transition of the Pallas
// kernel and row_apply_ev of the plain version, bit for bit.
template <int C, int KP>
__device__ __forceinline__ void transition(const Geometry& g, int lane, int vec_start,
                                           int r[C], const Query<C>& q,
                                           Result<C>& out) {
  static_assert(KP >= 1 && KP <= 2 && C >= KP && C <= kMaxPlanes, "plane counts");
  const bool in_row = lane < g.A;

  // probe: highest lane whose key planes match (keys are unique in a row)
  bool eq = in_row && r[0] == q.item[0];
  if (KP == 2) eq = eq && r[KP - 1] == q.item[KP - 1];
  const int pos = top_lane(__ballot_sync(kFull, eq));
  const bool hit = pos >= 0;
  const int pos_c = hit ? pos : 0;

  // get path: promote within the vector, or upgrade across vectors
  const int vs_get = __shfl_sync(kFull, vec_start, pos_c);
  int lo_get = pos_c != vs_get ? vs_get : max(pos_c - 1, 0);
  if (g.set_lru) lo_get = 0;

  // put path: deepest empty lane, else the victim
  const int e = top_lane(__ballot_sync(kFull, in_row && r[0] == kEmpty));
  int victim = g.A - 1;
  if (g.cost_planes) {  // warp-uniform
    const int seg_lo = g.set_lru ? 0 : (g.M - 1) * g.P;
    const int cand = (in_row && lane >= seg_lo) ? r[C - 1] : INT_MAX;
    const int cmin = __reduce_min_sync(kFull, cand);
    victim = top_lane(__ballot_sync(kFull, in_row && cand == cmin));
  }
  const int pos_ins = e >= 0 ? e : victim;
  const int lo_put = g.set_lru ? 0 : __shfl_sync(kFull, vec_start, pos_ins);

  const bool is_chain = q.op == OP_CHAIN_GET || q.op == OP_CHAIN_PUT;
  const bool dead = is_chain && q.live == 0;
  const bool is_putop = q.op == OP_ACCESS || (q.op == OP_CHAIN_PUT && !dead);
  const bool use_put = is_putop && !hit;
  const bool is_del = q.op == OP_DELETE;
  const bool keep = q.op == OP_LOOKUP || dead;
  const bool zero_out = is_del || dead;
  const bool no_ev = hit || !is_putop;
  const int lo = use_put ? lo_put : lo_get;
  const int hi = use_put ? pos_ins : pos_c;

#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int x = r[c];
    const int at_pos = __shfl_sync(kFull, x, pos_c);
    const int shifted = __shfl_up_sync(kFull, x, 1);
    const int displaced = __shfl_sync(kFull, x, hi);
    const int item = use_put ? q.item[c] : at_pos;
    const int rotated = lane == lo ? item : ((lane > lo && lane <= hi) ? shifted : x);
    const int killed = (c == 0 && hit && lane == pos_c) ? kEmpty : x;
    r[c] = is_del ? killed : (keep ? x : rotated);
    out.val[c] = zero_out ? 0 : at_pos;
    out.ev[c] = no_ev ? (c < KP ? kEmpty : 0) : displaced;
  }
  out.hit = hit && !dead;
  out.pos = zero_out ? -1 : pos;
}

// Store query i's scalar outputs.
template <int C, int KP>
__device__ __forceinline__ void store_result(const Geometry& g, const Outputs& o,
                                             int i, const Result<C>& res) {
  o.hit[i] = res.hit;
  o.pos[i] = res.pos;
  if (g.V == 0) o.val[i] = 0;  // the one-plane dummy value output
#pragma unroll
  for (int c = KP; c < C; ++c) {
    if (c < KP + g.V) o.val[(size_t)i * g.V + (c - KP)] = res.val[c];
  }
#pragma unroll
  for (int c = 0; c < C; ++c) o.ev[(size_t)i * C + c] = res.ev[c];
}

template <int C, int KP>
__global__ void msl_access_kernel(Geometry g, int B, const int* __restrict__ rows,
                                  Operands in, Outputs out) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= B) return;  // whole warps exit together
  const size_t row_off = (size_t)i * g.A * C;
  int r[C];
  load_row<C>(g, rows + row_off, lane, r);
  Query<C> q;
  load_query<C, KP>(g, in, i, q);
  Result<C> res;
  transition<C, KP>(g, lane, (lane / g.P) * g.P, r, q, res);
  store_row<C>(g, out.rows + row_off, lane, r);
  if (lane == 0) store_result<C, KP>(g, out, i, res);
}

template <int C, int KP>
__global__ void msl_onepass_kernel(Geometry g, int B, const int* __restrict__ rows,
                                   Operands in, const int* __restrict__ sids,
                                   const int* __restrict__ served, Outputs out) {
  const int head = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (head >= B) return;
  const int sid = sids[head];
  if (head > 0 && sids[head - 1] == sid) return;  // not a chain head

  const int vec_start = (lane / g.P) * g.P;
  int r[C];
  load_row<C>(g, rows + (size_t)head * g.A * C, lane, r);

  // Walk the chain 32 members at a time.  Members are contiguous, so the
  // lanes holding one form a prefix of the warp.
  for (int base = head;; base += 32) {
    const int j = base + lane;
    const bool member = j < B && sids[j] == sid;
    Query<C> w;
    int w_served = 0;
    if (member) {
      load_query<C, KP>(g, in, j, w);
      w_served = served[j];
    }
    const int n = __popc(__ballot_sync(kFull, member));
    Result<C> mine;  // the outputs of member `lane`, kept by that lane
    for (int t = 0; t < n; ++t) {
      Query<C> q;
#pragma unroll
      for (int c = 0; c < C; ++c) q.item[c] = __shfl_sync(kFull, w.item[c], t);
      q.op = __shfl_sync(kFull, w.op, t);
      q.live = __shfl_sync(kFull, w.live, t);
      const bool srv = __shfl_sync(kFull, w_served, t) != 0;

      int nr[C];
#pragma unroll
      for (int c = 0; c < C; ++c) nr[c] = r[c];
      Result<C> res;
      transition<C, KP>(g, lane, vec_start, nr, q, res);
      // an unserved member passes the row on untouched and reports
      // hit 0, pos -1, value 0, ev 0
#pragma unroll
      for (int c = 0; c < C; ++c) r[c] = srv ? nr[c] : r[c];
      store_row<C>(g, out.rows + (size_t)(base + t) * g.A * C, lane, r);
      if (lane == t) {
        mine.hit = srv ? res.hit : 0;
        mine.pos = srv ? res.pos : -1;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          mine.val[c] = srv ? res.val[c] : 0;
          mine.ev[c] = srv ? res.ev[c] : 0;
        }
      }
    }
    if (lane < n) store_result<C, KP>(g, out, j, mine);
    if (n < 32) break;
  }
}

int blocks_for(int B) { return (B + kWarpsPerBlock - 1) / kWarpsPerBlock; }

// Call f(std::integral_constant<int, C>, std::integral_constant<int, KP>)
// for the built plane counts: KP in {1, 2}, KP <= C <= kMaxPlanes.
template <typename F>
int with_planes(int C, int KP, F&& f) {
  using std::integral_constant;
#define MSL_CASE(c, kp)                                              \
  if (C == c && KP == kp) {                                          \
    f(integral_constant<int, c>{}, integral_constant<int, kp>{});   \
    return static_cast<int>(cudaGetLastError());                     \
  }
  MSL_CASE(1, 1) MSL_CASE(2, 1) MSL_CASE(3, 1) MSL_CASE(4, 1)
  MSL_CASE(5, 1) MSL_CASE(6, 1) MSL_CASE(7, 1) MSL_CASE(8, 1)
  MSL_CASE(2, 2) MSL_CASE(3, 2) MSL_CASE(4, 2) MSL_CASE(5, 2)
  MSL_CASE(6, 2) MSL_CASE(7, 2) MSL_CASE(8, 2)
#undef MSL_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int msl_access_launch(const int* rows, const int* qk, const int* qv,
                      const int* ops, const int* live, const int* costs,
                      int* rows_out, int* hit, int* pos, int* val, int* ev,
                      int B, int A, int C, int KP, int V, int M, int P,
                      int cost_planes, int set_lru, void* stream) {
  const Geometry g{A, V, M, P, cost_planes, set_lru};
  const Operands in{qk, qv, ops, live, costs};
  const Outputs out{rows_out, hit, pos, val, ev};
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  return with_planes(C, KP, [&](auto c, auto kp) {
    msl_access_kernel<decltype(c)::value, decltype(kp)::value>
        <<<blocks_for(B), kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
            g, B, rows, in, out);
  });
}

int msl_onepass_launch(const int* rows, const int* qk, const int* qv,
                       const int* ops, const int* live, const int* costs,
                       const int* sids, const int* served,
                       int* rows_out, int* hit, int* pos, int* val, int* ev,
                       int B, int A, int C, int KP, int V, int M, int P,
                       int cost_planes, int set_lru, void* stream) {
  const Geometry g{A, V, M, P, cost_planes, set_lru};
  const Operands in{qk, qv, ops, live, costs};
  const Outputs out{rows_out, hit, pos, val, ev};
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  return with_planes(C, KP, [&](auto c, auto kp) {
    msl_onepass_kernel<decltype(c)::value, decltype(kp)::value>
        <<<blocks_for(B), kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
            g, B, rows, in, sids, served, out);
  });
}

}  // extern "C"
