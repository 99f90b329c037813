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
// and adds a third, msl_seq_kernel, the sequential engine (its note is
// below the one-pass kernel's).
//
// Layout.  A group of W lanes holds one set row: lane a < A of the group
// keeps way a's C int32 planes in registers.  The probe and the empty-slot
// search are ballots, the cost victim a minimum plus a ballot, and
// rotate_insert is one __shfl_up_sync by a lane (the GPU form of the
// paper's vpermd).  A vector's first lane is found from a bit mask of vector
// starts (a find-last-set), not by a shuffle.  Lanes >= A are masked out of
// every ballot and of the minimum, so A <= 32.  The one-pass kernel takes
// W = 32, one row per warp; the access kernel the power of two at or above
// A; the sequential kernel W = 32.  The plane counts C and KP are template
// parameters (C <= 8), so every per-plane loop unrolls into straight-line
// code.
//
// msl_access: what bounds it.  It moves B*(2*A*C + KP + V + C + 2) int32
// words, 232 bytes a row at the main geometry (A = 8, C = 3), but one row
// per warp costs some 200 warp instructions per row (220 in SASS at C = 3),
// and lanes A..31 (24 of 32 at A = 8) idle through all of them: at B = 8192
// on an H100 that is 62 warps per SM and 3.06 us, against a byte bound of
// 0.57 us.  So issuing instructions for idle lanes bounds it, not bytes.  The
// design gives each row a group of W lanes, W the power of two at or above
// A, so a warp holds R = 32 / W rows (R = 4 at A = 8) and each instruction
// works for R rows: ballots are shifted down to the group's bits and
// shuffles take width W (the Group primitives).  The warp's R rows are
// contiguous, so each plane's load and store is one instruction for them
// all, as is each query operand's load.  Staging the rows in shared memory
// and copying them in 16-byte words, and spreading the scalar outputs over
// a group's lanes, both measured slower (more instructions per warp) and
// were left out.  At A > 16 a warp holds one row.
//
// msl_onepass: what bounds it.  It moves about the same bytes, but a chain of
// L queries on one set is L dependent transitions.  At Zipf 0.99 and
// B = 8192 the hottest key alone takes some 400 queries of a batch, all on
// one set, so walked member by member the kernel is bound by the latency of
// its longest chain, nearly 200 times its byte bound.  The design does three
// things about it.
//
//  * Runs, not members.  transition() is a pure function of (row, query).
//    When it leaves the row as it was (an ACCESS hit at lane 0, a LOOKUP, a
//    dead chain member, a DELETE miss, an unserved member), every following
//    member with the same operands (all C item planes, op, live, served) has
//    the same inputs and so the same outputs and the same rows_after.  The
//    warp finds such a run with one ballot over the loaded window (bit t:
//    member t's operands equal member t-1's), gives its lanes the result
//    together, stores its rows_after once per member with 32-wide coalesced
//    stores from a copy of the row in shared memory, and jumps past it.  The
//    fixed-point flag and the last member's operands carry across windows.
//    A hot key's run then costs the few transitions that bring it to lane 0,
//    plus its stores.  The row is compared (one __any_sync) only where the
//    next member could join a run, so a chain with no repeats pays nothing.
//  * Loads ahead.  The warp loads the operands of 32 members at once (lane t
//    holds member t) and, while it walks a full window, has the next one's
//    loads in flight, so a long chain waits on memory about once.  A run's
//    rows_after go out as 16-byte stores where a row is a whole number of
//    them.
//  * A short dependent path.  What does not depend on the row is taken off
//    the path from one transition to the next: the empty-slot and victim
//    search read the row alone, the vector starts come from a mask (no
//    shuffle), an unserved member is a uniform branch, and each member's
//    outputs are kept by a select on the lanes of its run, not a branch on
//    one lane.  What is left is one warp issuing a long run of mostly
//    dependent instructions per transition, so a chain with no repeats
//    runs no faster than walking member by member.  chip_smoke.py measures
//    both rates (chain_step_ns, run_member_ns); PERF.md keeps them.
//
// The TPU kernel's block-local chain ranks, per-block round counts and the
// cross-block carry exist because TPU grid cells run in order.  CUDA blocks
// run in no order, so here a warp finds its own chain: a position whose set
// id equals its predecessor's is not a head and exits; a head walks its
// whole chain, however long, and no chain is ever split.
//
// msl_seq_kernel replaces no Pallas kernel.  It is the counterpart of the
// JAX package's sequential engine (src/repro/core/engine.py:290-351,
// make_sequential_engine), one jitted lax.scan over the whole query stream:
// one device program, here one launch of one warp that walks the stream in
// order, as the paper's single SIMD unit does.  It is the oracle the batched
// engines are held against, so it shares transition() with them but none of
// their conflict handling.
//
// msl_seq: what bounds it.  Every query reads its set's row and the next
// query may need the row it wrote, so the stream is one chain of N dependent
// transitions, each behind a row load and ahead of a row store: latency, not
// bandwidth (fig07's 2M-query stream needs some 42 MB moved, 13 us at HBM
// rate).  The design keeps the dependent path to the transition itself:
//
//  * The row stays in registers while consecutive queries hit its set, and
//    is stored only when the stream moves to another set.
//  * Operands come in windows: lane t loads query base + t's set id and
//    operands (one coalesced load per plane for 32 queries), and the next
//    window's loads are in flight while this one is walked; a query's
//    operands then cost C + 3 shuffles, not a load.
//  * The next query's row is loaded while this query's transition runs,
//    whenever its set differs from the one held.  That is safe: every other
//    set's latest row has already been stored, by the same lane that now
//    loads it (lane a holds way a of every row), so no fence is needed.
//  * Outputs are kept by lane t for query base + t and stored 32 wide once
//    per window.
//
// Plain C interface, loaded with ctypes: every launcher returns
// cudaGetLastError() of its launch (cudaErrorInvalidValue, without
// launching, for plane counts or a geometry it was not built for).

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
  unsigned vstarts;  // bit x set for every vector's first lane x = k * P < A
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

// (x / P) * P for a lane x < A, from the mask of vector starts.
__device__ __forceinline__ int vec_start(unsigned vstarts, int x) {
  return top_lane(vstarts & ((2u << x) - 1u));
}

// A lane's place in its group of W lanes (W a power of two; a warp holds
// 32 / W groups, one set row each).  Every lane of the warp executes every
// call, whatever its group: ballots are taken over the whole warp and
// shifted down to the group's bits, shuffles take width W so that their
// source lanes are group-local, and the minimum is a butterfly inside W.
// At W = 32 these are the plain warp-wide primitives.
template <int W>
struct Group {
  static_assert(W >= 1 && W <= 32 && (W & (W - 1)) == 0, "group width");
  int lane;  // lane within the group
  int base;  // the group's first lane in the warp

  __device__ __forceinline__ explicit Group(int warp_lane)
      : lane(warp_lane & (W - 1)), base(warp_lane & ~(W - 1)) {}

  __device__ __forceinline__ unsigned ballot(bool p) const {
    const unsigned b = __ballot_sync(kFull, p);
    if constexpr (W == 32) {
      return b;
    } else {
      return (b >> base) & ((1u << W) - 1u);
    }
  }
  __device__ __forceinline__ int shfl(int x, int src) const {
    if constexpr (W == 1) return x;
    else return __shfl_sync(kFull, x, src, W);
  }
  __device__ __forceinline__ int shfl_up1(int x) const {
    if constexpr (W == 1) return x;
    else return __shfl_up_sync(kFull, x, 1, W);
  }
  __device__ __forceinline__ int min(int x) const {
    if constexpr (W == 32) {
      return __reduce_min_sync(kFull, x);
    } else {
#pragma unroll
      for (int o = W / 2; o > 0; o >>= 1) {
        const int y = __shfl_xor_sync(kFull, x, o, W);
        x = y < x ? y : x;
      }
      return x;
    }
  }
};

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

// Apply query q to the row the lane group holds in r (group lane a < A
// holds r[0..C)).  On return r holds the new row and every lane of the
// group holds the same outputs.  Mirrors _transition of the Pallas kernel
// and row_apply_ev of the plain version, bit for bit.  The put path comes
// first: it reads the row alone, so it can run while the query's operands
// arrive.  Lanes A..W-1 of a group are kept out of every ballot and of the
// minimum.
template <int C, int KP, int W>
__device__ __forceinline__ void transition(const Geometry& g, const Group<W>& grp, int r[C],
                                           const Query<C>& q, Result<C>& out) {
  static_assert(KP >= 1 && KP <= 2 && C >= KP && C <= kMaxPlanes, "plane counts");
  const int lane = grp.lane;
  const bool in_row = lane < g.A;

  // put path: deepest empty lane, else the victim
  const int e = top_lane(grp.ballot(in_row && r[0] == kEmpty));
  int victim = g.A - 1;
  if (g.cost_planes) {  // warp-uniform
    const int seg_lo = g.set_lru ? 0 : (g.M - 1) * g.P;
    const int cand = (in_row && lane >= seg_lo) ? r[C - 1] : INT_MAX;
    const int cmin = grp.min(cand);
    victim = top_lane(grp.ballot(in_row && cand == cmin));
  }
  const int pos_ins = e >= 0 ? e : victim;
  const int lo_put = g.set_lru ? 0 : vec_start(g.vstarts, pos_ins);

  // probe: highest lane whose key planes match (keys are unique in a row)
  bool eq = in_row && r[0] == q.item[0];
  if (KP == 2) eq = eq && r[KP - 1] == q.item[KP - 1];
  const int pos = top_lane(grp.ballot(eq));
  const bool hit = pos >= 0;
  const int pos_c = hit ? pos : 0;

  // get path: promote within the vector, or upgrade across vectors
  const int vs_get = vec_start(g.vstarts, pos_c);
  int lo_get = pos_c != vs_get ? vs_get : max(pos_c - 1, 0);
  if (g.set_lru) lo_get = 0;

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
    const int at_pos = grp.shfl(x, pos_c);
    const int shifted = grp.shfl_up1(x);
    const int displaced = grp.shfl(x, hi);
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

// One warp holds R = 32 / W set rows, W the power of two at or above A:
// lane l of group s holds way l of row i0 + s.  The warp's R rows are one
// contiguous run of R * A * C words, and lane s * A + l reads and writes
// the C words of its way, so each plane's load or store is one instruction
// for the warp's R rows; each lane loads its own query's operands, one load
// instruction per operand plane for the warp's R queries, and lane 0 of
// each group stores its row's scalar outputs.  A group past B computes on
// zeros and the last query and stores nothing; only a warp whose first row
// is past B returns early, so every lane reaches every ballot and shuffle.
// At R = 1 it compiles to the code of a one-row-per-warp kernel.
template <int C, int KP, int W>
__global__ void msl_access_kernel(Geometry g, int B, const int* __restrict__ rows,
                                  Operands in, Outputs out) {
  constexpr int R = 32 / W;
  const int lane = threadIdx.x & 31;
  const int i0 = ((blockIdx.x * blockDim.x + threadIdx.x) >> 5) * R;
  if (i0 >= B) return;  // whole warps exit together
  const Group<W> grp(lane);
  const int i = i0 + lane / W;                          // the group's row
  const bool row_in = R == 1 || i < B;
  const bool mine = row_in && grp.lane < g.A;
  const size_t tile = (size_t)i0 * g.A * C;             // the warp's rows
  const int way = ((lane / W) * g.A + grp.lane) * C;    // this lane's way in them
  const int* src = rows + tile;
  int* dst = out.rows + tile;
  int r[C];
#pragma unroll
  for (int c = 0; c < C; ++c) r[c] = mine ? src[way + c] : 0;
  Query<C> q;
  load_query<C, KP>(g, in, R == 1 ? i0 : min(i, B - 1), q);
  Result<C> res;
  transition<C, KP, W>(g, grp, r, q, res);
  if (mine) {
#pragma unroll
    for (int c = 0; c < C; ++c) dst[way + c] = r[c];
  }
  if (row_in && grp.lane == 0) store_result<C, KP>(g, out, i, res);
}

// One chain member's operands.
template <int C>
struct Member {
  Query<C> q;
  int served;
};

// Up to 32 chain members: lane t holds member base + t.
template <int C>
struct Window {
  Member<C> m;
  bool member;   // position base + t belongs to the chain
};

// Load the window at positions j = base + lane.  The chain's first window
// loads operands only where j is a member; a window loaded ahead loads them
// wherever j < B, together with the set ids, so that no load waits on
// another.
template <int C, int KP>
__device__ __forceinline__ Window<C> load_window(const Geometry& g, const Operands& in,
                                                 const int* sids, const int* served,
                                                 int B, int sid, int j, bool ahead) {
  Window<C> w;
  const bool in_batch = j < B;
  w.member = in_batch && sids[j] == sid;
#pragma unroll
  for (int c = 0; c < C; ++c) w.m.q.item[c] = 0;
  w.m.q.op = OP_ACCESS;
  w.m.q.live = 1;
  w.m.served = 0;
  if (ahead ? in_batch : w.member) {
    load_query<C, KP>(g, in, j, w.m.q);
    w.m.served = served[j];
  }
  return w;
}

// Lane t's query on every lane.
template <int C>
__device__ __forceinline__ Query<C> shfl_query(const Query<C>& q, int t) {
  Query<C> m;
#pragma unroll
  for (int c = 0; c < C; ++c) m.item[c] = __shfl_sync(kFull, q.item[c], t);
  m.op = __shfl_sync(kFull, q.op, t);
  m.live = __shfl_sync(kFull, q.live, t);
  return m;
}

// Member t's operands on every lane.
template <int C>
__device__ __forceinline__ Member<C> fetch(const Window<C>& w, int t) {
  Member<C> m;
  m.q = shfl_query<C>(w.m.q, t);
  m.served = __shfl_sync(kFull, w.m.served, t);
  return m;
}

// Bit t: member t's operands equal member t-1's.  For t = 0 the member
// before the window is `before` (on every lane), if there is one.
template <int C>
__device__ __forceinline__ unsigned repeat_mask(const Window<C>& w, const Member<C>& before,
                                                bool has_before, int lane) {
  bool eq = w.member && (lane > 0 || has_before);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int up = __shfl_up_sync(kFull, w.m.q.item[c], 1);
    eq = eq && (lane > 0 ? up : before.q.item[c]) == w.m.q.item[c];
  }
  const int op = __shfl_up_sync(kFull, w.m.q.op, 1);
  const int live = __shfl_up_sync(kFull, w.m.q.live, 1);
  const int srv = __shfl_up_sync(kFull, w.m.served, 1);
  eq = eq && (lane > 0 ? op : before.q.op) == w.m.q.op;
  eq = eq && (lane > 0 ? live : before.q.live) == w.m.q.live;
  eq = eq && (lane > 0 ? srv : before.served) == w.m.served;
  return __ballot_sync(kFull, eq);
}

// The first member at or after s whose bit in `repeats` is clear: the end
// of the run through s - 1 (32 if it fills the window).
__device__ __forceinline__ int run_end(unsigned repeats, int s) {
  if (s >= 32) return 32;
  const unsigned breaks = ~repeats & (kFull << s);
  return breaks ? __ffs(breaks) - 1 : 32;
}

// Copy k rows of `units` words each from the one row at `src` to `dst`,
// 32 lanes at a time: lane i writes words i, i + 32, ... of the k copies.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, int units, int k, int lane) {
  const int step = 32 % units;
  int o = lane % units;
  for (int i = lane; i < k * units; i += 32) {
    dst[i] = src[o];
    o += step;
    if (o >= units) o -= units;
  }
}

// Store the row the warp holds as rows_after of k consecutive members,
// starting at dst: for one member from the A lanes that hold it; for a run,
// through the warp's copy in shared memory (`stage`), 32 lanes at a time,
// in 16-byte words where a row is a whole number of them.
template <int C>
__device__ __forceinline__ void store_rows(const Geometry& g, int* dst, int k, int lane,
                                           const int r[C], int* stage) {
  if (k == 1) {
    store_row<C>(g, dst, lane, r);
    return;
  }
  const int ac = g.A * C;
  __syncwarp();
  if (lane < g.A) {
#pragma unroll
    for (int c = 0; c < C; ++c) stage[lane * C + c] = r[c];
  }
  __syncwarp();
  if (ac % 4 == 0) {
    copy_rows(reinterpret_cast<int4*>(dst), reinterpret_cast<const int4*>(stage), ac / 4,
              k, lane);
  } else {
    copy_rows(dst, stage, ac, k, lane);
  }
}

template <int C, int KP>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
msl_onepass_kernel(Geometry g, int B, const int* __restrict__ rows, Operands in,
                   const int* __restrict__ sids, const int* __restrict__ served,
                   Outputs out) {
  __shared__ __align__(16) int stage_s[kWarpsPerBlock][32 * kMaxPlanes];
  const int head = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (head >= B) return;
  const int sid = sids[head];
  if (head > 0 && sids[head - 1] == sid) return;  // not a chain head

  const int ac = g.A * C;
  int* stage = stage_s[threadIdx.x >> 5];
  const Group<32> warp(lane);
  int r[C];
  load_row<C>(g, rows + (size_t)head * ac, lane, r);

  Window<C> w = load_window<C, KP>(g, in, sids, served, B, sid, head + lane, false);
  int n = __popc(__ballot_sync(kFull, w.member));
  unsigned repeats = repeat_mask<C>(w, w.m, false, lane);
  bool fixed = false;  // the last member walked left the row as it was
  Result<C> last;      // its outputs (the same on every lane)

  for (int base = head;; base += 32) {
    const bool full = n == 32;
    Window<C> next;  // in flight while w is walked
    if (full) next = load_window<C, KP>(g, in, sids, served, B, sid, base + 32 + lane, true);

    Result<C> mine;  // the outputs of member `lane`, kept by that lane
    // a run carried over from the last window
    int t = fixed ? run_end(repeats, 0) : 0;
    if (t > 0) {
      if (lane < t) mine = last;
      store_rows<C>(g, out.rows + (size_t)base * ac, t, lane, r, stage);
    }
    while (t < n) {
      const Member<C> m = fetch<C>(w, t);
      int nr[C];
#pragma unroll
      for (int c = 0; c < C; ++c) nr[c] = r[c];
      Result<C> res;
      transition<C, KP, 32>(g, warp, nr, m.q, res);
      if (m.served == 0) {
        // an unserved member passes the row on untouched and reports
        // hit 0, pos -1, value 0, ev 0
#pragma unroll
        for (int c = 0; c < C; ++c) {
          nr[c] = r[c];
          res.val[c] = 0;
          res.ev[c] = 0;
        }
        res.hit = 0;
        res.pos = -1;
      }

      int end = t + 1;
      if (end == 32 || ((repeats >> end) & 1u)) {  // a run could follow
        bool changed = false;
#pragma unroll
        for (int c = 0; c < C; ++c) changed = changed || nr[c] != r[c];
        fixed = !__any_sync(kFull, changed);
        if (fixed) end = run_end(repeats, end);
      } else {
        fixed = false;
      }
#pragma unroll
      for (int c = 0; c < C; ++c) r[c] = nr[c];
      last = res;
      if (lane >= t && lane < end) mine = res;
      store_rows<C>(g, out.rows + (size_t)(base + t) * ac, end - t, lane, r, stage);
      t = end;
    }
    if (lane < n) store_result<C, KP>(g, out, base + lane, mine);
    if (!full) break;

    const Member<C> before = fetch<C>(w, 31);
    n = __popc(__ballot_sync(kFull, next.member));
    if (n == 0) break;
    repeats = repeat_mask<C>(next, before, true, lane);
    w = next;
  }
}

// One query of the stream as a window holds it (lane t: query base + t).
template <int C>
struct Slot {
  Query<C> q;
  int sid;  // its set; -1 past the end of the stream
};

template <int C, int KP>
__device__ __forceinline__ Slot<C> load_slot(const Geometry& g, const Operands& in,
                                             const int* sids, int N, int j) {
  Slot<C> s;
  if (j < N) {
    s.sid = sids[j];
    load_query<C, KP>(g, in, j, s.q);
  } else {
    s.sid = -1;
#pragma unroll
    for (int c = 0; c < C; ++c) s.q.item[c] = 0;
    s.q.op = OP_ACCESS;
    s.q.live = 1;
  }
  return s;
}

// The whole stream of N >= 1 queries, in order, on one warp: query i
// applies transition() to row sids[i] of `table`, which is updated in
// place.  Lane a < A holds way a of the row in registers.  `table` is
// neither const nor restrict: the kernel reads back rows it wrote.
template <int C, int KP>
__global__ void __launch_bounds__(32)
msl_seq_kernel(Geometry g, int N, int* table, const int* __restrict__ sids, Operands in,
               Outputs out) {
  const int lane = threadIdx.x & 31;
  const Group<32> warp(lane);
  const size_t ac = (size_t)g.A * C;
  int held = sids[0];
  int r[C];
  load_row<C>(g, table + held * ac, lane, r);
  Slot<C> w = load_slot<C, KP>(g, in, sids, N, lane);

  for (int base = 0; base < N; base += 32) {
    const Slot<C> next = load_slot<C, KP>(g, in, sids, N, base + 32 + lane);  // in flight
    const int n = min(32, N - base);
    Result<C> mine;  // the outputs of query base + lane
    for (int t = 0; t < n; ++t) {
      const Query<C> q = shfl_query<C>(w.q, t);
      const int s_next = t < 31 ? __shfl_sync(kFull, w.sid, t + 1)
                                : __shfl_sync(kFull, next.sid, 0);
      const bool move = s_next >= 0 && s_next != held;  // warp-uniform
      int nr[C] = {};
      if (move) load_row<C>(g, table + s_next * ac, lane, nr);  // lands during the transition
      Result<C> res;
      transition<C, KP, 32>(g, warp, r, q, res);
      if (lane == t) mine = res;
      if (move) {
        store_row<C>(g, table + held * ac, lane, r);
#pragma unroll
        for (int c = 0; c < C; ++c) r[c] = nr[c];
        held = s_next;
      }
    }
    if (lane < n) store_result<C, KP>(g, out, base + lane, mine);
    w = next;
  }
  store_row<C>(g, table + held * ac, lane, r);
}

int blocks_for(int B) { return (B + kWarpsPerBlock - 1) / kWarpsPerBlock; }

// The access kernel's lane-group width: the power of two at or above A.
int group_width(int A) {
  int w = 1;
  while (w < A) w <<= 1;
  return w;
}

// Blocks of the access kernel: one warp per 32 / W rows, from shapes alone.
int access_blocks(int B, int W) {
  const int rows_per_warp = 32 / W;
  return blocks_for((B + rows_per_warp - 1) / rows_per_warp);
}

// Call f(std::integral_constant<int, W>) for a group width W in {1, ..., 32}.
template <typename F>
void with_width(int W, F&& f) {
  using std::integral_constant;
  switch (W) {
    case 1: f(integral_constant<int, 1>{}); break;
    case 2: f(integral_constant<int, 2>{}); break;
    case 4: f(integral_constant<int, 4>{}); break;
    case 8: f(integral_constant<int, 8>{}); break;
    case 16: f(integral_constant<int, 16>{}); break;
    default: f(integral_constant<int, 32>{}); break;
  }
}

// The mask of vector starts, or 0 for a geometry the kernels do not take.
unsigned vstarts_for(int A, int P) {
  if (A <= 0 || A > 32 || P <= 0) return 0;
  unsigned mask = 0;
  for (int x = 0; x < A; x += P) mask |= 1u << x;
  return mask;
}

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
  const Geometry g{A, V, M, P, cost_planes, set_lru, vstarts_for(A, P)};
  const Operands in{qk, qv, ops, live, costs};
  const Outputs out{rows_out, hit, pos, val, ev};
  if (g.vstarts == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const int W = group_width(A);
  return with_planes(C, KP, [&](auto c, auto kp) {
    with_width(W, [&](auto w) {
      msl_access_kernel<decltype(c)::value, decltype(kp)::value, decltype(w)::value>
          <<<access_blocks(B, decltype(w)::value), kWarpsPerBlock * 32, 0,
             static_cast<cudaStream_t>(stream)>>>(g, B, rows, in, out);
    });
  });
}

int msl_onepass_launch(const int* rows, const int* qk, const int* qv,
                       const int* ops, const int* live, const int* costs,
                       const int* sids, const int* served,
                       int* rows_out, int* hit, int* pos, int* val, int* ev,
                       int B, int A, int C, int KP, int V, int M, int P,
                       int cost_planes, int set_lru, void* stream) {
  const Geometry g{A, V, M, P, cost_planes, set_lru, vstarts_for(A, P)};
  const Operands in{qk, qv, ops, live, costs};
  const Outputs out{rows_out, hit, pos, val, ev};
  if (g.vstarts == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  return with_planes(C, KP, [&](auto c, auto kp) {
    msl_onepass_kernel<decltype(c)::value, decltype(kp)::value>
        <<<blocks_for(B), kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
            g, B, rows, in, sids, served, out);
  });
}

// The sequential engine: one warp over the N queries, `table` (S, A, C)
// updated in place.
int msl_seq_launch(int* table, const int* sids, const int* qk, const int* qv,
                   const int* ops, const int* live, const int* costs,
                   int* hit, int* pos, int* val, int* ev,
                   int N, int A, int C, int KP, int V, int M, int P,
                   int cost_planes, int set_lru, void* stream) {
  const Geometry g{A, V, M, P, cost_planes, set_lru, vstarts_for(A, P)};
  const Operands in{qk, qv, ops, live, costs};
  const Outputs out{nullptr, hit, pos, val, ev};
  if (g.vstarts == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0) return static_cast<int>(cudaGetLastError());
  return with_planes(C, KP, [&](auto c, auto kp) {
    msl_seq_kernel<decltype(c)::value, decltype(kp)::value>
        <<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(g, N, table, sids, in, out);
  });
}

}  // extern "C"
