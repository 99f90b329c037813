// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paged_attn_decode_call of
// src/repro/kernels/paged_attn.py (body _paged_attn_kernel): one new token
// per row attends over the row's sequence without a contiguous copy of it.
// Positions [0, prefix_len) live in the shared page pool
// (n_pages, page_tokens, KVH, Dh), reached through the row's block table;
// positions [prefix_len, cur_len] live in the row's own tail
// (B, Tmax, KVH, Dh) at tail position pos - prefix_len.
//
// What it computes, as the TPU kernel does: q is scaled by Dh^-0.5 in bf16;
// scores are f32 dot products of f32-converted bf16 values, then the
// optional tanh softcap, then the mask (the position exists, and
// cur - pos < window when window > 0); a softmax (m, l, acc) in f32;
// masked probabilities are zeroed explicitly, because NEG_INF is finite; a
// row with l = 0 gives 0.  GQA: the rep = H / KVH query heads of one KV head
// share each K/V row.  A row must have cur_len >= prefix_len (the serving
// engine writes the new token into the tail at cur_len - prefix_len): the
// positions walked are [lo, cur_len], with lo the window's first position.
//
// Shapes it takes, as the reference's paged path serves them: Dh in
// {16, 24, 32, 64, 96, 128, 256} (one template instance each) and any
// rep = H / KVH from 1 to kMaxRep = 16.  Which instance does what:
//   * Dh 96, rep 1: phi3-mini-3.8b (the serving path of chip_smoke.py).
//   * Dh 128, rep 9: starcoder2-7b; rep 8: command-r-35b and qwen2-vl-72b.
//   * Dh 256, rep 4: gemma3-1b (MQA), the only instance whose shared memory
//     passes the 48 KB static limit at every rep (77 KB at rep 4, 103 KB at
//     rep 16): all instances take dynamic shared memory, sized per launch
//     from rep, and paged_attn_prepare() raises each instance's limit to
//     its size at kMaxRep once, when the library is loaded (never inside a
//     CUDA-graph capture, which the megastep engine makes of this launch).
//   * Dh 16, rep 4: command-r-smoke, qwen2-vl-smoke (and the MoE smoke
//     configs); Dh 24, rep 3: starcoder2-smoke; Dh 32, rep 4:
//     gemma3-smoke.  These are for tests: correct and simple.
//
// What bounds it.  A launch reads each walked K/V row once, 2 * Dh * 2
// bytes per position and KV head, and q, the output, the block tables and
// the lengths once (chip_smoke.py's bound_ms counts exactly these).  At the
// serving path's decode tick (phi3-mini: B = 4, KVH = 32, Dh = 96, rows of
// 71-74 positions, 290 in all) that is 3.61 MB, 1.08 us at 3.35 TB/s.  It
// does 4 * H * Dh flops per position, far below the card's f32 rate, so
// bytes bound it.  But 3.61 MB over 128 (row, KV head) pairs is 28 KB each:
// a pair's time is the latency of its dependent loads (lengths and block
// table, then K and V), not bandwidth, and one block per pair walking its
// positions in turn leaves most of the card idle.
//
// Design: every load in flight at once, split over a cluster.
//  * Grid (KVH, B, S), launched as thread block clusters of (1, 1, S): the S
//    blocks of one (KV head, row) split the positions [lo, cur] evenly.  The
//    row's length is read on the device, so the host never syncs.  The host
//    sets S from shapes alone: one tile of kTile positions per block at the
//    static bound NP * pt + tmax (capped by the window), at most kMaxSplits =
//    8 (the portable cluster size), and no more than keeps the grid within
//    one wave of kBlocksPerSM = 4 blocks per SM, since a second wave doubles
//    the latency chain.  At the serving path's shapes (bound 512, 128 pairs)
//    S = 4: 512 blocks of 17-19 positions each.
//  * Each block loads its row's lengths, block-table entries and q at once,
//    then stages its K and V rows in shared memory with 16-byte cp.async
//    copies before any arithmetic: one thread per position finds its row
//    (through the block table or the tail), then every copy of the tile is
//    issued at once.  A position without a row is zero-filled and masked.
//    A block with more than one tile double-buffers them: tile k+1's copies
//    fly while tile k is computed.  Staged rows are padded by 16 bytes so
//    that neighbouring rows start in different banks.
//  * Scores: four threads per position; thread quarter j takes the 16-byte
//    chunks j, j + 4, ... of Dh (at Dh 16 and 24 some quarters have none)
//    for all rep heads, reduced by shuffles.  Softmax: one warp per head, a
//    lane per position (kTile = 32).  p * V: a value-pass slot is one
//    (head, 16-byte chunk), rep * Dh / 8 slots in all.  With fewer slots
//    than threads, each thread owns one slot over every G-th position, and
//    the G groups' sums are added at the end through a buffer over the K
//    stages (at least kThreads * 8 floats, which the K stages alone are not
//    at Dh 16); with more (rep 9 or 16 at Dh 128, rep 8 and up at Dh 256),
//    each thread owns up to kSlots slots over every position.
//  * Each block keeps its partial (m, l, acc) in shared memory; after
//    cluster.sync(), the ranks split the rep * Dh outputs (rank j takes
//    j * 128 + tid, every S * 128-th: at phi3-mini's 96 outputs rank 0 alone,
//    at starcoder2-7b's 1152 and gemma3-1b's 1024 all eight), read every
//    rank's partial of theirs over distributed shared memory in one round,
//    rescale them by exp(m_j - M) and write the output; a second
//    cluster.sync() keeps every rank's shared memory alive until all are
//    done.  A block whose share of the positions is empty contributes
//    m = NEG_INF, l = 0.  One launch, no global scratch.  Every sum is taken
//    in a fixed order, so a launch is deterministic.
//
// Plain C interface, loaded with ctypes: the launcher returns the error of
// its launch, or cudaErrorInvalidValue, without launching, for a head dim
// or GQA ratio it was not built for; paged_attn_splits gives the cluster
// size the launcher picks for a shape; paged_attn_prepare sets the shared
// memory limits once.

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;          // positions per tile: a lane each in the softmax
constexpr int kMaxRep = 16;        // query heads per KV head
constexpr int kMaxSplits = 8;      // blocks per cluster
constexpr int kPad = 8;            // bf16 padding per staged row (16 bytes)
constexpr int kTablePages = 64;    // block-table entries a block keeps in shared memory
constexpr int kBlocksPerSM = 4;    // the grid is kept to one wave of this many blocks per SM
constexpr float kNegInf = -1e30f;  // finite, as the reference's NEG_INF

struct Args {
  const __nv_bfloat16* q;        // (B, H, Dh), unscaled
  const __nv_bfloat16* pool_k;   // (n_pages, pt, KVH, Dh)
  const __nv_bfloat16* pool_v;
  const int* block_table;        // (B, NP)
  const __nv_bfloat16* tail_k;   // (B, Tmax, KVH, Dh)
  const __nv_bfloat16* tail_v;
  const int* prefix_len;         // (B,)
  const int* cur_len;            // (B,)
  __nv_bfloat16* out;            // (B, H, Dh)
  int H, KVH, n_pages, pt, NP, tmax, window;
  float softcap, q_scale;
};

__host__ __device__ constexpr int align16(int n) { return (n + 15) / 16 * 16; }

// Byte offsets of a block's shared-memory arrays for head dim dh and rep
// query heads per KV head; K's stages start at 0, `total` is the size.
struct Layout {
  int v, bt, valid, q, acc, s, m, l, alpha, total;
};

__host__ __device__ inline Layout smem_layout(int dh, int rep) {
  const int stages = 2 * kTile * (dh + kPad) * 2;  // two tiles of bf16 rows, K or V
  const int red = kThreads * 8 * 4;                // the value pass's group sums, over K
  Layout o;
  o.v = align16(stages > red ? stages : red);
  o.bt = o.v + stages;                             // the row's first block-table entries
  o.valid = o.bt + kTablePages * 4;                // the staged position exists and is walked
  o.q = o.valid + align16(2 * kTile);              // scaled q of the rep heads, f32
  o.acc = o.q + rep * dh * 4;                      // this block's partial p * V
  o.s = o.acc + rep * dh * 4;                      // scores, then probabilities
  o.m = o.s + rep * kTile * 4;
  o.l = o.m + align16(rep * 4);
  o.alpha = o.l + align16(rep * 4);
  o.total = o.alpha + align16(rep * 4);
  return o;
}

__device__ __forceinline__ void unpack8(const uint4& raw, float* f) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h2[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// 16 bytes from global to shared memory, or 16 zero bytes when src_bytes = 0.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Element offset of position pos's K/V row for KV head g of row b, through
// the block table (pos < plen) or the tail; -1 where the row has no such
// position.  `in_tail` says which tensor the offset is into.
template <int DH>
__device__ __forceinline__ long long row_offset(const Args& a, const int* bt, int b, int g,
                                                int pos, int plen, bool& in_tail) {
  in_tail = false;
  if (pos < plen) {
    const int j = pos / a.pt;
    if (j >= a.NP) return -1;
    const int entry = j < kTablePages ? bt[j] : a.block_table[static_cast<size_t>(b) * a.NP + j];
    const int page = min(max(entry, 0), a.n_pages - 1);
    return ((static_cast<long long>(page) * a.pt + (pos - j * a.pt)) * a.KVH + g) * DH;
  }
  if (pos - plen >= a.tmax) return -1;
  in_tail = true;
  return ((static_cast<long long>(b) * a.tmax + (pos - plen)) * a.KVH + g) * DH;
}

// Stage the K and V rows of positions [t0, t0 + kTile) in stage `st`.
// Thread (t, quarter) = (tid / 4, tid % 4) finds position t0 + t's row
// (through the block table or the tail; none at or past `p1`, or where the
// row has no such position) and copies the 16-byte chunks quarter,
// quarter + 4, ... of its K and V rows: the K chunks it dots in the score
// pass.  Every copy of the tile is in flight at once; a position without a
// row is zero-filled and marked invalid.
template <int DH>
__device__ __forceinline__ void stage_tile(const Args& a, __nv_bfloat16* sk, __nv_bfloat16* sv,
                                           unsigned char* valid, const int* bt, int st, int t0,
                                           int p1, int b, int g, int plen) {
  constexpr int kChunks = DH / 8;
  static_assert(kThreads == 4 * kTile, "four threads per staged position");
  const int t = threadIdx.x / 4, qtr = threadIdx.x % 4;
  const int pos = t0 + t;
  bool in_tail = false;
  const long long off = pos < p1 ? row_offset<DH>(a, bt, b, g, pos, plen, in_tail) : -1;
  if (qtr == 0) valid[st * kTile + t] = off >= 0;
  const __nv_bfloat16* kb = in_tail ? a.tail_k : a.pool_k;
  const __nv_bfloat16* vb = in_tail ? a.tail_v : a.pool_v;
  const int bytes = off >= 0 ? 16 : 0;
  __nv_bfloat16* kr = sk + (st * kTile + t) * (DH + kPad);
  __nv_bfloat16* vr = sv + (st * kTile + t) * (DH + kPad);
#pragma unroll
  for (int cc = 0; cc < (kChunks + 3) / 4; ++cc) {
    const int e = (cc * 4 + qtr) * 8;
    if (e < DH) {
      cp_async16(kr + e, off >= 0 ? kb + off + e : kb, bytes);
      cp_async16(vr + e, off >= 0 ? vb + off + e : vb, bytes);
    }
  }
  cp_async_commit();
}

template <int DH>
__global__ void __launch_bounds__(kThreads) paged_attn_kernel(const Args a) {
  static_assert(DH % 8 == 0, "Dh is a whole number of 16-byte chunks");
  constexpr int kChunks = DH / 8;  // 16-byte chunks of one head's row
  constexpr int kRow = DH + kPad;  // bf16 per staged row
  // value-pass slots a thread owns at most: rep * kChunks over kThreads
  constexpr int kSlots = (kMaxRep * kChunks + kThreads - 1) / kThreads;
  cg::cluster_group cluster = cg::this_cluster();
  const int g = blockIdx.x;  // KV head
  const int b = blockIdx.y;  // row
  const int split = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rep = a.H / a.KVH;
  const int head0 = g * rep;

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout o = smem_layout(DH, rep);
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sv = reinterpret_cast<__nv_bfloat16*>(smem + o.v);
  int* sbt = reinterpret_cast<int*>(smem + o.bt);
  unsigned char* svalid = smem + o.valid;
  float* sq = reinterpret_cast<float*>(smem + o.q);
  float* sacc = reinterpret_cast<float*>(smem + o.acc);
  float* ss = reinterpret_cast<float*>(smem + o.s);
  float* sm_m = reinterpret_cast<float*>(smem + o.m);
  float* sm_l = reinterpret_cast<float*>(smem + o.l);
  float* sm_alpha = reinterpret_cast<float*>(smem + o.alpha);

  // the row's lengths, its block table and q, all loaded at once
  const int plen = a.prefix_len[b];
  const int cur = a.cur_len[b];
  for (int j = tid; j < min(a.NP, kTablePages); j += kThreads) {
    sbt[j] = a.block_table[static_cast<size_t>(b) * a.NP + j];
  }
  const __nv_bfloat16* qrow = a.q + (static_cast<size_t>(b) * a.H + head0) * DH;
  for (int i = tid; i < rep * DH; i += kThreads) {
    // q * scale rounded to bf16: the reference scales q in its own dtype
    sq[i] = __bfloat162float(__float2bfloat16(__bfloat162float(qrow[i]) * a.q_scale));
  }
  if (tid < rep) {
    sm_m[tid] = kNegInf;
    sm_l[tid] = 0.f;
  }
  // this block's share [p0, p1) of the walked positions [lo, cur]
  const int lo = a.window > 0 ? max(0, cur - a.window + 1) : 0;
  const int per = (max(cur - lo + 1, 0) + splits - 1) / splits;
  const int p0 = lo + split * per;
  const int p1 = min(p0 + per, cur + 1);
  const int n_tiles = p0 < p1 ? (p1 - p0 + kTile - 1) / kTile : 0;
  __syncthreads();
  if (n_tiles > 0) stage_tile<DH>(a, sk, sv, svalid, sbt, 0, p0, p1, b, g, plen);

  // value pass: slot = (head, chunk) = (own / kChunks, own % kChunks).  With
  // fewer slots than threads, `groups` groups of `owners` threads split the
  // positions; otherwise one group, each thread slots tid + j * kThreads.
  const int owners = rep * kChunks;
  const bool grouped = owners < kThreads;
  const int groups = grouped ? kThreads / owners : 1;
  const int group = grouped ? tid / owners : 0;
  const int own0 = grouped ? tid % owners : tid;
  const bool active = group < groups;
  float acc[kSlots][8];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[j][i] = 0.f;
  }

  for (int k = 0; k < n_tiles; ++k) {
    const int st = k & 1;
    const int t0 = p0 + k * kTile;
    if (k + 1 < n_tiles) {
      stage_tile<DH>(a, sk, sv, svalid, sbt, st ^ 1, t0 + kTile, p1, b, g, plen);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // each thread dots the K chunks it copied itself; V and the valid flags
    // are read by others only after the next barrier

    // -- scores: thread (t, quarter) dots the chunks of Dh it staged -------
    {
      const int t = tid / 4, qtr = tid % 4;
      float dot[kMaxRep];
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) dot[r] = 0.f;
      const __nv_bfloat16* krow = sk + (st * kTile + t) * kRow;
#pragma unroll
      for (int cc = 0; cc < (kChunks + 3) / 4; ++cc) {
        const int c = cc * 4 + qtr;
        if (c < kChunks) {
          float kf[8];
          unpack8(*reinterpret_cast<const uint4*>(krow + c * 8), kf);
#pragma unroll
          for (int r = 0; r < kMaxRep; ++r) {
            if (r < rep) {
              const float* qr = sq + r * DH + c * 8;
#pragma unroll
              for (int i = 0; i < 8; ++i) dot[r] = fmaf(qr[i], kf[i], dot[r]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r < rep) {  // rep is the same for the whole block
          dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], 1);
          dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], 2);
        }
      }
      if (qtr == 0) {
        const bool valid = svalid[st * kTile + t];
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r) {
          if (r < rep) {
            float s = dot[r];
            if (a.softcap > 0.f) s = tanhf(s / a.softcap) * a.softcap;
            ss[r * kTile + t] = valid ? s : kNegInf;
          }
        }
      }
    }
    __syncthreads();

    // -- softmax: one warp per query head, a lane per position -------------
    for (int r = warp; r < rep; r += kWarps) {
      const float sc = ss[r * kTile + lane];
      float mx = sc;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_prev = sm_m[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p = svalid[st * kTile + lane] ? expf(sc - m_new) : 0.f;
      ss[r * kTile + lane] = p;
      float sum = p;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sm_alpha[r] = alpha;
        sm_l[r] = alpha * sm_l[r] + sum;
        sm_m[r] = m_new;
      }
    }
    __syncthreads();

    // -- p * V: each owned slot over every groups-th position before p1 ---
    // (later positions of the tile have p = 0 and zero-filled rows)
    const int tile_n = min(kTile, p1 - t0);
    if (active) {
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int own = own0 + j * kThreads;
        if (own < owners) {
          const int r = own / kChunks, c = own % kChunks;
          const float alpha = sm_alpha[r];
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[j][i] *= alpha;
          const float* pr = ss + r * kTile;
#pragma unroll 4
          for (int t = group; t < tile_n; t += groups) {
            float vf[8];
            unpack8(*reinterpret_cast<const uint4*>(sv + (st * kTile + t) * kRow + c * 8), vf);
            const float p = pr[t];
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[j][i] = fmaf(p, vf[i], acc[j][i]);
          }
        }
      }
    }
    __syncthreads();  // stage st is free for tile k + 2
  }

  // this block's partial p * V into sacc (slot own's 8 dims start at own * 8)
  if (grouped) {
    // the groups' sums, staged over the K stages, added in group order
    float* red = reinterpret_cast<float*>(smem);
    if (active) {
#pragma unroll
      for (int i = 0; i < 8; ++i) red[(group * owners + own0) * 8 + i] = acc[0][i];
    }
    __syncthreads();
    if (group == 0) {
      for (int g2 = 1; g2 < groups; ++g2) {
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[0][i] += red[(g2 * owners + own0) * 8 + i];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) sacc[own0 * 8 + i] = acc[0][i];
    }
  } else {
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int own = own0 + j * kThreads;
      if (own < owners) {
#pragma unroll
        for (int i = 0; i < 8; ++i) sacc[own * 8 + i] = acc[j][i];
      }
    }
  }

  // the cluster's ranks combine the partials over distributed shared
  // memory, rank j the outputs j * kThreads + tid, every splits * kThreads-th
  cluster.sync();
  for (int i = split * kThreads + tid; i < rep * DH; i += splits * kThreads) {
    const int r = i / DH;
    float m[kMaxSplits], l[kMaxSplits], ov[kMaxSplits];  // every rank's, read at once
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j) {
      m[j] = kNegInf;
      l[j] = ov[j] = 0.f;
      if (j < splits) {
        m[j] = cluster.map_shared_rank(sm_m, j)[r];
        l[j] = cluster.map_shared_rank(sm_l, j)[r];
        ov[j] = cluster.map_shared_rank(sacc, j)[i];
      }
    }
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j) mx = fmaxf(mx, m[j]);
    float lsum = 0.f, osum = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxSplits; ++j) {
      const float w = expf(m[j] - mx);
      lsum += w * l[j];
      osum += w * ov[j];
    }
    a.out[(static_cast<size_t>(b) * a.H + head0) * DH + i] =
        __float2bfloat16_rn(lsum == 0.f ? 0.f : osum / lsum);  // no valid position: 0
  }
  cluster.sync();  // every rank's shared memory lives until all are done
}

// Blocks per cluster: one tile per block at the static bound NP * pt + tmax
// (capped by the window), at most kMaxSplits, and no more than keeps the
// grid of B * KVH clusters within one wave of kBlocksPerSM blocks per SM.
int splits_for(int B, int KVH, int NP, int pt, int tmax, int window) {
  long long bound = static_cast<long long>(NP) * pt + tmax;
  if (window > 0 && window < bound) bound = window;
  long long s = (bound + kTile - 1) / kTile;
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  const long long wave = static_cast<long long>(kBlocksPerSM) * sms / max(B * KVH, 1);
  if (s > wave) s = wave;
  return static_cast<int>(s < 1 ? 1 : (s > kMaxSplits ? kMaxSplits : s));
}

template <int DH>
cudaError_t prepare() {
  return cudaFuncSetAttribute(paged_attn_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_layout(DH, kMaxRep).total);
}

template <int DH>
cudaError_t launch(const Args& a, int B, int splits, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.KVH, B, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_layout(DH, a.H / a.KVH).total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, paged_attn_kernel<DH>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// Raise every instance's dynamic shared-memory limit to its size at kMaxRep.
// Called once, when the library is loaded.
int paged_attn_prepare() {
  cudaError_t err = cudaSuccess;
  const cudaError_t errs[] = {prepare<16>(), prepare<24>(), prepare<32>(), prepare<64>(),
                              prepare<96>(), prepare<128>(), prepare<256>()};
  for (const cudaError_t e : errs) {
    if (e != cudaSuccess && err == cudaSuccess) err = e;
  }
  return static_cast<int>(err);
}

int paged_attn_splits(int B, int KVH, int NP, int pt, int tmax, int window) {
  return splits_for(B, KVH, NP, pt, tmax, window);
}

int paged_attn_launch(const void* q, const void* pool_k, const void* pool_v,
                      const int* block_table, const void* tail_k, const void* tail_v,
                      const int* prefix_len, const int* cur_len, void* out,
                      int B, int H, int KVH, int Dh, int n_pages, int pt, int NP, int tmax,
                      int window, float softcap, float q_scale, void* stream) {
  if (KVH <= 0 || H % KVH != 0 || H / KVH > kMaxRep || n_pages <= 0 || pt <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const Args a{static_cast<const __nv_bfloat16*>(q),
               static_cast<const __nv_bfloat16*>(pool_k),
               static_cast<const __nv_bfloat16*>(pool_v),
               block_table,
               static_cast<const __nv_bfloat16*>(tail_k),
               static_cast<const __nv_bfloat16*>(tail_v),
               prefix_len, cur_len,
               static_cast<__nv_bfloat16*>(out),
               H, KVH, n_pages, pt, NP, tmax, window, softcap, q_scale};
  const int splits = splits_for(B, KVH, NP, pt, tmax, window);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 16: return static_cast<int>(launch<16>(a, B, splits, s));
    case 24: return static_cast<int>(launch<24>(a, B, splits, s));
    case 32: return static_cast<int>(launch<32>(a, B, splits, s));
    case 64: return static_cast<int>(launch<64>(a, B, splits, s));
    case 96: return static_cast<int>(launch<96>(a, B, splits, s));
    case 128: return static_cast<int>(launch<128>(a, B, splits, s));
    case 256: return static_cast<int>(launch<256>(a, B, splits, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
