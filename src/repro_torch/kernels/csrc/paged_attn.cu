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
// cur - pos < window when window > 0); an online softmax (m, l, acc) in f32;
// masked probabilities are zeroed explicitly, because NEG_INF is finite; a
// row with l = 0 gives 0.  GQA: the rep = H / KVH query heads of one KV head
// share each K/V load.  A row must have cur_len >= prefix_len (the serving
// engine writes the new token into the tail at cur_len - prefix_len): the
// positions walked are [lo, cur_len], with lo the window's first position.
//
// What bounds it.  A launch reads each valid K/V row once, 2 * Dh * 2 bytes
// per position and KV head: about 4.3 MB for 4 rows of ~88 positions at
// KVH = 32, Dh = 96, or 1.3 us at 3.35 TB/s.  It does 4 * H * Dh flops per
// position, far below the tensor cores' rate, so bytes bound it; at these
// sizes the launch itself (a few us) costs more than the bytes.
//
// Design.  The TPU kernel carries (m, l, acc) across a sequential grid axis
// and fetches both candidate blocks (pool page and tail block) every step.
// Here one block of 128 threads owns one (row, KV head) and walks the row's
// positions in tiles of 128 inside the block, loading only the block that
// holds each position:
//   * score pass: thread t takes position base + t, finds its K row through
//     the block table or the tail, reads it with 16-byte loads (Dh = 96 is
//     12 of them; no power of two is assumed) and dots it with the rep
//     query heads held in shared memory as f32;
//   * softmax pass: one warp per query head reduces the tile's max and sum
//     with shuffles and updates that head's m and l;
//   * value pass: thread (g, r, c) owns 8 output dims (one 16-byte chunk)
//     of query head r and accumulates p * V in f32 registers over every
//     G-th position of the tile, from position g on; the G = 128 /
//     (rep * Dh/8) groups split the tile's positions, so more loads are in
//     flight (at rep 1, Dh 96: 10 groups of 12 threads), and their partial
//     sums are added in shared memory at the end.  Neighbouring threads
//     read neighbouring chunks of a V row.
// At B = 4, KVH = 32 that is 128 blocks on 132 SMs.  Split-KV, cp.async/TMA
// and tensor-core dots are later work.
//
// Plain C interface, loaded with ctypes: the launcher returns
// cudaGetLastError() of its launch, or cudaErrorInvalidValue, without
// launching, for a head dim or GQA ratio it was not built for.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;      // one block per (row, KV head)
constexpr int kTile = kThreads;    // positions per tile: one per thread
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 8;         // query heads per KV head
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

__device__ __forceinline__ void unpack8(const uint4& raw, float* f) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h2[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads) paged_attn_kernel(const Args a) {
  constexpr int kChunks = DH / 8;  // 16-byte chunks of one head's row
  const int g = blockIdx.x;        // KV head
  const int b = blockIdx.y;        // row
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rep = a.H / a.KVH;
  const int head0 = g * rep;

  __shared__ float q_s[kMaxRep * DH];       // scaled q of the rep heads, f32
  __shared__ float s_s[kMaxRep * kTile];    // scores, then probabilities
  __shared__ long long off_s[kTile];        // element offset of the K/V row; -1: masked
  __shared__ unsigned char tail_s[kTile];   // 1: the row lives in the tail
  __shared__ float m_s[kMaxRep], l_s[kMaxRep], alpha_s[kMaxRep];
  __shared__ float red_s[kThreads * 8];     // the groups' partial sums

  const int plen = a.prefix_len[b];
  const int cur = a.cur_len[b];
  const __nv_bfloat16* qrow = a.q + (static_cast<size_t>(b) * a.H + head0) * DH;
  for (int i = tid; i < rep * DH; i += kThreads) {
    // q * scale rounded to bf16: the reference scales q in its own dtype
    q_s[i] = __bfloat162float(__float2bfloat16(__bfloat162float(qrow[i]) * a.q_scale));
  }
  if (tid < rep) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  const int owners = rep * kChunks;         // threads per value-pass group
  const int groups = kThreads / owners;
  const int group = tid / owners, own = tid % owners;
  const int r_own = own / kChunks, c_own = own % kChunks;
  const bool active = group < groups;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  const int lo = a.window > 0 ? max(0, cur - a.window + 1) : 0;
  __syncthreads();

  for (int base = lo; base <= cur; base += kTile) {
    // -- score pass: thread tid takes position base + tid ------------------
    const int pos = base + tid;
    long long off = -1;
    bool in_tail = false;
    if (pos <= cur) {
      if (pos < plen) {
        const int j = pos / a.pt;
        if (j < a.NP) {
          const int page = min(max(a.block_table[static_cast<size_t>(b) * a.NP + j], 0),
                               a.n_pages - 1);
          off = ((static_cast<long long>(page) * a.pt + pos % a.pt) * a.KVH + g) * DH;
        }
      } else if (pos - plen < a.tmax) {
        off = ((static_cast<long long>(b) * a.tmax + (pos - plen)) * a.KVH + g) * DH;
        in_tail = true;
      }
    }
    off_s[tid] = off;
    tail_s[tid] = in_tail;
    float dot[kMaxRep];
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) dot[r] = 0.f;
    if (off >= 0) {
      const uint4* krow = reinterpret_cast<const uint4*>((in_tail ? a.tail_k : a.pool_k) + off);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        float kf[8];
        unpack8(krow[c], kf);
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r) {
          if (r < rep) {
            const float* qr = q_s + r * DH + c * 8;
#pragma unroll
            for (int i = 0; i < 8; ++i) dot[r] = fmaf(qr[i], kf[i], dot[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r < rep) {
        float s = dot[r];
        if (a.softcap > 0.f) s = tanhf(s / a.softcap) * a.softcap;
        s_s[r * kTile + tid] = off >= 0 ? s : kNegInf;
      }
    }
    __syncthreads();

    // -- softmax pass: one warp per query head -----------------------------
    for (int r = warp; r < rep; r += kWarps) {
      float* sr = s_s + r * kTile;
      float mx = kNegInf;
      for (int t = lane; t < kTile; t += 32) mx = fmaxf(mx, sr[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < kTile; t += 32) {
        const float p = off_s[t] >= 0 ? expf(sr[t] - m_new) : 0.f;
        sr[t] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // -- value pass: thread (group, r_own, c_own), every groups-th position
    if (active) {
      const float alpha = alpha_s[r_own];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] *= alpha;
      const float* pr = s_s + r_own * kTile;
      const int n = min(kTile, cur - base + 1);
#pragma unroll 4
      for (int t = group; t < n; t += groups) {
        const long long o = off_s[t];
        if (o < 0) continue;
        const uint4* vrow = reinterpret_cast<const uint4*>((tail_s[t] ? a.tail_v : a.pool_v) + o);
        float vf[8];
        unpack8(vrow[c_own], vf);
        const float p = pr[t];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = fmaf(p, vf[i], acc[i]);
      }
    }
    __syncthreads();
  }

  if (active) {
#pragma unroll
    for (int i = 0; i < 8; ++i) red_s[(group * owners + own) * 8 + i] = acc[i];
  }
  __syncthreads();
  if (group == 0) {
    for (int g2 = 1; g2 < groups; ++g2) {
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] += red_s[(g2 * owners + own) * 8 + i];
    }
    float l = l_s[r_own];
    if (l == 0.f) l = 1.f;  // a row with no valid position gives 0
    uint4 packed;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int i = 0; i < 4; ++i) h2[i] = __floats2bfloat162_rn(acc[2 * i] / l, acc[2 * i + 1] / l);
    __nv_bfloat16* orow = a.out + (static_cast<size_t>(b) * a.H + head0 + r_own) * DH;
    reinterpret_cast<uint4*>(orow)[c_own] = packed;
  }
}

template <int DH>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  paged_attn_kernel<DH><<<dim3(a.KVH, B), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 32: return static_cast<int>(launch<32>(a, B, s));
    case 64: return static_cast<int>(launch<64>(a, B, s));
    case 96: return static_cast<int>(launch<96>(a, B, s));
    case 128: return static_cast<int>(launch<128>(a, B, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
