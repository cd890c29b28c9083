// Hamming distances of 256-bit binary descriptors: descriptor matching and
// the MILD loop-closure feature scores.
//
// Replaces: onepiece_tpu/ops/hamming.py:41 hamming_table (XLA, not Pallas: a
// +-1 bf16 matmul on the MXU) and its consumers :52 match_descriptors, :78
// match_descriptors_windowed and lcdetection/mild.py:55 _similarity_scores.
//
// What it computes. Descriptors are 8 words of 32 bits (int32 in the port,
// the JAX package's uint32 words bit for bit); d(a, b) = sum over the words
// of __popc(a ^ b).
//   hamming_match: per query, over the M targets in index order, the best
//     target (lowest index on ties), the best distance and the second
//     distance (the second entry of the sorted row: equal to the best on a
//     tie, as `top_k(-d, 2)` gives it). A target that is invalid, or
//     outside the query's window when one is given (|du| <= w and |dv| <= w
//     with du = uv_pred - uv_b in float32), counts as 257.
//   hamming_table: the whole (N, M) int32 table.
//   mild_feature_scores: fs[n, k] = sum over f of lut[d(q_n, db_kf)] where
//     db_valid[k, f], k < g and d < 64, and 0 where q_valid[n] is false;
//     lut holds exp(-max(d, 10)^2 / 900) as the host computed it, so every
//     term is bit-equal to the plain version's.
//
// What bounds it on Hopper: the popcounts. A pair costs 8 XOR, 8 __popc and
// 7 adds; the inputs are 32 bytes a descriptor, the outputs 16 bytes a query
// or 4 bytes a (query, keyframe). __popc issues at 16 a clock on an SM, a
// quarter of the integer ALU rate, so it sets the bound. On the sparse path
// most entries are invalid (125 valid targets of 1,000 on the orbit; 173
// valid queries of 1,000 and ~135 valid features a keyframe on the loop), so
// the work is ~1-8 M popcounts: a few microseconds, near the card's least
// kernel duration. What costs time is then latency and idle SMs, not the
// popcount rate, and the design spends no work, load or lane on an invalid
// entry. The tensor cores (a +-1 int8 or a b1 `.and.popc` mma) would need the
// bound recounted against their rate and gain nothing at this size, so the
// kernels stay on __popc.
//
// Both kernels count valid entries with one scan over the block: each thread
// reads its kPer consecutive flags in 4-byte loads, and a warp scan and a
// prefix over the warps give its first slot, so valid entries keep their
// index order. Only valid rows are staged in shared memory, 16 bytes at a
// time, loaded into registers and then stored. (cp.async staging of the same
// rows measured several times slower on an H100; byte loads behind a branch
// each waited for the one before; a shared store of a value just loaded
// holds back every load after it, so loads go out first.) No host read, and
// one launch per call.
//
// hamming_match: a CTA of kWarps warps, a group of kLanes lanes a query
// (one warp). The group splits the compacted targets among its lanes (lane
// j takes list entries j, j + kLanes, ...), so 1,000 queries are 125 CTAs
// of 8 over the 132 SMs. The CTA lists the valid targets' indices in shared
// memory, then stages their rows (kBatch rows' loads a thread in flight). Each lane walks its targets in increasing index order
// with a strict `<`, keeping (best, index, second): the first two entries of
// the stable sort of its own targets. The lanes then merge their partials by
// shuffles: if (b1, i1) < (b2, i2) lexicographically the union's is (b1, i1,
// min(s1, b2)), else (b2, i2, min(s2, b1)). Every partial starts at (257, 0,
// 257), which is what the sorted row gives where no target (or one) is
// valid. In the windowed form the window is tested first and only a target
// inside it is read. Staged descriptors are split into two int4 planes, so
// lanes reading consecutive targets hit distinct banks. The index is written
// as int64, so the wrapper launches nothing else.
//
// mild_feature_scores: a grid of kChunks x min(N_CAP, R) CTAs, R the keyframe
// rows the card holds at once (from the occupancy API), so no CTA waits for
// another to end; CTA (c, y) takes keyframes y, y + R, ... For each, it lists
// the valid queries and the keyframe's valid features in one scan and takes
// the queries of rank c, c + kChunks, ... (the loop's 173 valid queries of
// 1,000 over 8 CTAs of every live keyframe: 312 live CTAs at g = 39). Its
// first keyframe is listed before g is tested (g is read from device memory
// as int64), so the flags, g and the term table come in one trip to memory;
// a keyframe k >= g gets 0 in this CTA's slice of its column, and a later one
// in the stride is known dead without a load. Live, the CTA stages the listed
// rows; its warps compute the (query, feature) distances together, kUnit
// queries by 32 features a warp at a time (kUnit independent popcount chains
// a thread), into a byte table (min(d, 64)) in the lists' room; then each
// query's thread adds its terms, lut[d] or +0 past the cut, in f order (+0
// leaves the sum's bits as they were). Those are the same additions in the
// same order as a walk over all f that skips the invalid features and the far
// ones, so fs is bit-equal from run to run (no atomics) and to a thread per
// (query, keyframe) that walks f. Last, the CTA writes 0 in the invalid
// queries' rows it owns (row % kChunks == c). (Loading every feature row with
// its flag, to save the second trip, measured slower: every CTA then reads
// 32 KB.)

#include <cuda_runtime.h>

namespace {

constexpr int kMasked = 257;  // HAMMING_MAX + 1
constexpr int kLut = 64;      // MILD: distances below 64 contribute
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 1024;              // indices a compaction covers
constexpr int kPer = kTile / kThreads;   // flags each thread compacts
static_assert(kPer % 4 == 0 && kPer <= 32, "flag_bits reads whole 4-byte words into 32 bits");
constexpr int kBatch = 4;                // staged rows whose loads a thread keeps in flight
static_assert(kPer % kBatch == 0, "whole batches");
constexpr int kUnit = 8;                 // mild_feature_scores: queries a thread scores at once
constexpr int kLanes = 32;               // hamming_match: lanes a query
constexpr int kQueriesPerBlock = kThreads / kLanes;
constexpr int kChunks = 8;               // mild_feature_scores: CTAs a keyframe
constexpr int kMildBlocksPerSm = 3;      // mild_feature_scores: registers capped so 3 CTAs fit an SM
constexpr int kMine = kTile / kChunks;   // mild_feature_scores: queries of a tile a CTA takes
static_assert(kTile % kChunks == 0 && kMine <= kThreads, "a CTA's share of a query tile fits its threads");
static_assert(kTile < 65536, "a tile's count fits in 16 bits");

__device__ __forceinline__ int distance(int4 qa, int4 qb, int4 x, int4 y) {
  return __popc(static_cast<unsigned>(qa.x ^ x.x)) + __popc(static_cast<unsigned>(qa.y ^ x.y)) +
         __popc(static_cast<unsigned>(qa.z ^ x.z)) + __popc(static_cast<unsigned>(qa.w ^ x.w)) +
         __popc(static_cast<unsigned>(qb.x ^ y.x)) + __popc(static_cast<unsigned>(qb.y ^ y.y)) +
         __popc(static_cast<unsigned>(qb.z ^ y.z)) + __popc(static_cast<unsigned>(qb.w ^ y.w));
}

// The flags [first, first + kPer) of a mask of m as bits: 4-byte loads where
// the address allows, else kPer independent byte loads (a load behind a
// branch on the one before would wait for it).
__device__ __forceinline__ unsigned flag_bits(const unsigned char* __restrict__ flag, int first, int m) {
  if (first >= m) return 0;
  unsigned bits = 0;
  const unsigned char* p = flag + first;
  if (first + kPer <= m && (reinterpret_cast<size_t>(p) & 3) == 0) {
    unsigned v[kPer / 4];
#pragma unroll
    for (int w = 0; w < kPer / 4; ++w) v[w] = reinterpret_cast<const unsigned*>(p)[w];
#pragma unroll
    for (int e = 0; e < kPer; ++e) bits |= ((v[e / 4] >> (8 * (e % 4))) & 0xffu ? 1u : 0u) << e;
    return bits;
  }
  unsigned char v[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) v[e] = flag[min(first + e, m - 1)];
#pragma unroll
  for (int e = 0; e < kPer; ++e) bits |= (first + e < m && v[e] ? 1u : 0u) << e;
  return bits;
}

// Lists the set flags of up to two masks at once, by one scan over the block
// of the two counts packed in an int (each under 2^16): each thread passes
// the bits of its kPer flags of each from `flag_bits` (first_a = base_a +
// threadIdx.x * kPer), and the set indices of mask a go to list_a[0, count.x)
// in increasing order, those of mask b to list_b[0, count.y) (bits_b = 0 for
// none). Called by every thread of the block; the lists are ready to read on
// return. A list must not be read after a later call has started (its
// barriers order the reads first).
__device__ int2 compact(unsigned bits_a, int first_a, int* list_a, unsigned bits_b, int first_b, int* list_b,
                        int* warp_total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int own = __popc(bits_a) << 16 | __popc(bits_b);
  int incl = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int slot = incl - own, count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int t = warp_total[w];
    slot += w < warp ? t : 0;
    count += t;
  }
  int slot_a = slot >> 16, slot_b = slot & 0xffff;
  for (; bits_a; bits_a &= bits_a - 1) list_a[slot_a++] = first_a + __ffs(bits_a) - 1;
  for (; bits_b; bits_b &= bits_b - 1) list_b[slot_b++] = first_b + __ffs(bits_b) - 1;
  __syncthreads();
  return make_int2(count >> 16, count & 0xffff);
}

// Rows list[e] for e = threadIdx.x, + kThreads, ... < count (at most kPer),
// -1 past count.
__device__ __forceinline__ void my_rows(const int* list, int count, int (&rows)[kPer]) {
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int e = threadIdx.x + r * kThreads;
    rows[r] = e < count ? list[e] : -1;
  }
}

__global__ void __launch_bounds__(kThreads) hamming_match_kernel(
    const int4* __restrict__ a,             // (N, 2) int4 = (N, 8) words
    const int4* __restrict__ b,             // (M, 2) int4
    const unsigned char* __restrict__ vb,   // (M,) bool
    const float2* __restrict__ uv_pred,     // (N,) or null
    const float2* __restrict__ uv_b,        // (M,) or null
    float window, int n, int m,
    long long* __restrict__ best_out,  // (N,)
    int* __restrict__ dist_out) {      // (2, N): best, second
  __shared__ int4 lo[kTile];  // words 0-3 of the listed targets
  __shared__ int4 hi[kTile];  // words 4-7
  __shared__ float2 tuv[kTile];
  __shared__ int list[kTile];
  __shared__ int warp_total[kWarps];
  const int lane = threadIdx.x % kLanes;
  const int q = blockIdx.x * kQueriesPerBlock + threadIdx.x / kLanes;
  const bool windowed = uv_pred != nullptr;
  int4 qa = make_int4(0, 0, 0, 0), qb = qa;
  float2 pq = make_float2(0.f, 0.f);
  if (q < n) {
    qa = a[2 * q];
    qb = a[2 * q + 1];
    if (windowed) pq = uv_pred[q];
  }
  int best = kMasked, arg = 0, second = kMasked;
  for (int base = 0; base < m; base += kTile) {
    const int first = base + threadIdx.x * kPer;
    const int count = compact(flag_bits(vb, first, m), first, list, 0u, 0, nullptr, warp_total).x;
    int rows[kPer];
    my_rows(list, count, rows);
#pragma unroll
    for (int r0 = 0; r0 < kPer; r0 += kBatch) {  // kBatch rows' loads in flight, then their stores
      int4 x[kBatch], y[kBatch];
      float2 u[kBatch];
#pragma unroll
      for (int r = 0; r < kBatch; ++r) {
        const int t = rows[r0 + r];
        if (t < 0) continue;
        x[r] = b[2 * t];
        y[r] = b[2 * t + 1];
        if (windowed) u[r] = uv_b[t];
      }
#pragma unroll
      for (int r = 0; r < kBatch; ++r) {
        const int e = threadIdx.x + (r0 + r) * kThreads;
        if (rows[r0 + r] < 0) continue;
        lo[e] = x[r];
        hi[e] = y[r];
        if (windowed) tuv[e] = u[r];
      }
    }
    __syncthreads();
    if (q < n) {
#pragma unroll 4
      for (int e = lane; e < count; e += kLanes) {
        if (windowed) {
          const float2 u = tuv[e];
          if (!(fabsf(pq.x - u.x) <= window && fabsf(pq.y - u.y) <= window)) continue;
        }
        const int d = distance(qa, qb, lo[e], hi[e]);
        // strict < over increasing indices: the lowest index wins a tie, and
        // a tie with the best moves it into second
        if (d < best) {
          second = best;
          best = d;
          arg = list[e];
        } else if (d < second) {
          second = d;
        }
      }
    }
    __syncthreads();  // the tile is consumed before the next pass lists over it
  }
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) {
    const int b2 = __shfl_xor_sync(0xffffffffu, best, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, arg, o);
    const int s2 = __shfl_xor_sync(0xffffffffu, second, o);
    if (b2 < best || (b2 == best && i2 < arg)) {
      second = min(s2, best);
      best = b2;
      arg = i2;
    } else {
      second = min(second, b2);
    }
  }
  if (lane == 0 && q < n) {
    best_out[q] = arg;
    dist_out[q] = best;
    dist_out[n + q] = second;
  }
}

__global__ void hamming_table_kernel(const int4* __restrict__ a, const int4* __restrict__ b, int n, int m,
                                     int* __restrict__ out) {  // (N, M)
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
  if (j >= m) return;
  out[static_cast<long long>(i) * m + j] = distance(a[2 * i], a[2 * i + 1], b[2 * j], b[2 * j + 1]);
}

// 0 in column `col` of fs (stride n_cap) for the invalid queries among this
// thread's kPer flags that CTA c owns (row % kChunks == c): each invalid row
// of a live column is written once. After the scores, so that these stores
// do not sit before the staging loads.
__device__ __forceinline__ void zero_invalid(float* col, unsigned qbits, int qfirst, int n, int n_cap, int c) {
  for (int e = 0; e < kPer; ++e)
    if (qfirst + e < n && !(qbits >> e & 1u) && (qfirst + e) % kChunks == c)
      col[static_cast<long long>(qfirst + e) * n_cap] = 0.f;
}

__global__ void __launch_bounds__(kThreads, kMildBlocksPerSm) mild_feature_scores_kernel(
    const int4* __restrict__ q_desc,             // (N, 2) int4
    const unsigned char* __restrict__ q_valid,   // (N,)
    const int4* __restrict__ db,                 // (N_CAP, F, 2) int4
    const unsigned char* __restrict__ db_valid,  // (N_CAP, F)
    const long long* __restrict__ g,             // () keyframes in use
    const float* __restrict__ lut,               // (64,)
    int n, int n_cap, int f,
    float* __restrict__ fs) {  // (N, N_CAP)
  __shared__ int4 flo[kTile], fhi[kTile];  // words 0-3 and 4-7 of the listed features
  __shared__ int4 qlo[kMine], qhi[kMine];  // this CTA's queries
  __shared__ int lists[2 * kTile];         // the query and feature lists, then the distances
  __shared__ float slut[kLut + 1];         // the terms, and 0 for a distance of kLut or more
  __shared__ int warp_total[kWarps];
  int* qlist = lists;
  int* flist = lists + kTile;
  unsigned char* dist = reinterpret_cast<unsigned char*>(lists);  // (mine, width) once the lists are read
  constexpr int kRoom = 2 * kTile * sizeof(int);
  const int c = blockIdx.x;
  // loads go out before any store that would wait for one of them
  const float lut_v = threadIdx.x < kLut ? lut[threadIdx.x] : 0.f;
  const long long live_rows = *g;  // keyframes in use
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = (n + kChunks - 1) / kChunks;
  for (int k = blockIdx.y; k < n_cap; k += gridDim.y) {  // a stride over the keyframes
    float* col = fs + k;
    bool dead = k != blockIdx.y && k >= live_rows;  // known without a load past the first
    const unsigned char* vrow = db_valid + static_cast<long long>(k) * f;
    const int4* row = db + static_cast<long long>(k) * f * 2;
    // feature tiles outer: a query's sum goes on from where the last tile
    // left it in fs (stored and reloaded exactly), so it runs in f order
    for (int fbase = 0; !dead && fbase < max(f, 1); fbase += kTile) {  // once where F = 0
      int before = 0;  // valid queries of the earlier query tiles
      for (int qbase = 0; qbase < n; qbase += kTile) {
        const int qfirst = qbase + threadIdx.x * kPer, ffirst = fbase + threadIdx.x * kPer;
        const unsigned qbits = flag_bits(q_valid, qfirst, n), fbits = flag_bits(vrow, ffirst, f);
        // the first keyframe is compacted before g is tested, so that its
        // flags, g and the term table are all read at once
        const int2 cnt = compact(qbits, qfirst, qlist, fbits, ffirst, flist, warp_total);
        if (k >= live_rows) {  // the whole block
          dead = true;
          break;
        }
        if (threadIdx.x <= kLut) slut[threadIdx.x] = lut_v;  // read after the staging barrier
        // this CTA's queries: global rank c, c + kChunks, ... of the tile's
        const int j0 = ((c - before) % kChunks + kChunks) % kChunks;
        const int mine = cnt.x > j0 ? (cnt.x - j0 + kChunks - 1) / kChunks : 0;
        before += cnt.x;
        if (mine == 0) {  // the same in the whole block
          if (fbase == 0) zero_invalid(col, qbits, qfirst, n, n_cap, c);
          __syncthreads();  // the lists are read before the next pass
          continue;
        }
        int frows[kPer];
        my_rows(flist, cnt.y, frows);
        const int i = threadIdx.x < mine ? qlist[j0 + threadIdx.x * kChunks] : -1;
        float acc = 0.f;
        int4 qa = make_int4(0, 0, 0, 0), qb = qa;
        if (i >= 0) {
          qa = q_desc[2 * i];
          qb = q_desc[2 * i + 1];
          if (fbase > 0) acc = col[static_cast<long long>(i) * n_cap];
        }
#pragma unroll
        for (int r0 = 0; r0 < kPer; r0 += kBatch) {  // kBatch rows' loads in flight, then their stores
          int4 x[kBatch], y[kBatch];
#pragma unroll
          for (int r = 0; r < kBatch; ++r) {
            if (frows[r0 + r] < 0) continue;
            x[r] = row[2 * frows[r0 + r]];
            y[r] = row[2 * frows[r0 + r] + 1];
          }
#pragma unroll
          for (int r = 0; r < kBatch; ++r) {
            if (frows[r0 + r] < 0) continue;
            flo[threadIdx.x + (r0 + r) * kThreads] = x[r];
            fhi[threadIdx.x + (r0 + r) * kThreads] = y[r];
          }
        }
        if (i >= 0) {
          qlo[threadIdx.x] = qa;
          qhi[threadIdx.x] = qb;
        }
        __syncthreads();  // staged; the lists are dead, their room takes the distances
        // min(d, kLut) of (query, feature) pairs, in chunks of `width`
        // features: a warp takes kUnit queries by 32 features at a time
        // (kUnit independent popcount chains a thread); then each query's
        // thread adds its row's terms in f order. width / 4 is odd, so those
        // rows start in distinct banks.
        const int width = ((kRoom / mine) & ~7) - 4;
        for (int f0 = 0; f0 < cnt.y; f0 += width) {
          const int w = min(width, cnt.y - f0);
          const int blocks = (w + 31) / 32, units = (mine + kUnit - 1) / kUnit * blocks;
          for (int u = warp; u < units; u += kWarps) {
            const int qg = u / blocks * kUnit, fj = (u % blocks) * 32 + lane;
            if (fj >= w) continue;
            const int4 x = flo[f0 + fj], y = fhi[f0 + fj];
            // no branch between the chains: a row past mine repeats the last
            // row's pair and writes the same byte there
#pragma unroll
            for (int r = 0; r < kUnit; ++r) {
              const int q = min(qg + r, mine - 1);
              dist[q * width + fj] = static_cast<unsigned char>(min(distance(qlo[q], qhi[q], x, y), kLut));
            }
          }
          __syncthreads();
          if (i >= 0) {  // in f order; slut[kLut] = +0 leaves acc as it was
            const unsigned* drow = reinterpret_cast<const unsigned*>(dist + threadIdx.x * width);
            int j = 0;
#pragma unroll 4
            for (; j + 4 <= w; j += 4) {  // 4 distances a load
              const unsigned d4 = drow[j >> 2];
              acc += slut[d4 & 0xffu];
              acc += slut[d4 >> 8 & 0xffu];
              acc += slut[d4 >> 16 & 0xffu];
              acc += slut[d4 >> 24];
            }
            for (; j < w; ++j) acc += slut[dist[threadIdx.x * width + j]];
          }
          __syncthreads();  // the distances are read before the next chunk
        }
        if (i >= 0) col[static_cast<long long>(i) * n_cap] = acc;
        if (fbase == 0) zero_invalid(col, qbits, qfirst, n, n_cap, c);
      }
    }
    if (dead)  // a column past g is all 0: this CTA's slice of its rows
      for (int r = c * rows + threadIdx.x; r < min(n, (c + 1) * rows); r += kThreads)
        col[static_cast<long long>(r) * n_cap] = 0.f;
  }
}

}  // namespace

extern "C" int hamming_match(const int* a, const int* b, const unsigned char* valid_b, const float* uv_pred,
                             const float* uv_b, float window, int n, int m, long long* best, int* dist,
                             void* stream) {
  if (n == 0) return (int)cudaSuccess;
  if ((uv_pred == nullptr) != (uv_b == nullptr)) return (int)cudaErrorInvalidValue;
  hamming_match_kernel<<<(n + kQueriesPerBlock - 1) / kQueriesPerBlock, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const int4*>(a), reinterpret_cast<const int4*>(b), valid_b,
      reinterpret_cast<const float2*>(uv_pred), reinterpret_cast<const float2*>(uv_b), window, n, m, best, dist);
  return (int)cudaGetLastError();
}

extern "C" int hamming_table(const int* a, const int* b, int n, int m, int* out, void* stream) {
  if (n == 0 || m == 0) return (int)cudaSuccess;
  if (n > 65535) return (int)cudaErrorInvalidValue;  // gridDim.y
  const dim3 grid((m + 255) / 256, n);
  hamming_table_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(reinterpret_cast<const int4*>(a),
                                                             reinterpret_cast<const int4*>(b), n, m, out);
  return (int)cudaGetLastError();
}

extern "C" int mild_feature_scores(const int* q_desc, const unsigned char* q_valid, const int* db,
                                   const unsigned char* db_valid, const long long* g, const float* lut, int n,
                                   int n_cap, int f, float* fs, void* stream) {
  if (n == 0 || n_cap == 0) return (int)cudaSuccess;
  // as many keyframe rows as the card holds at once, so that no CTA waits
  // for another to end (asked once per device)
  static int rows_by_device[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int& rows = rows_by_device[dev & 63];
  if (rows == 0) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mild_feature_scores_kernel, kThreads, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    rows = max(1, per_sm * sms / kChunks);
  }
  mild_feature_scores_kernel<<<dim3(kChunks, min(n_cap, rows)), kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const int4*>(q_desc), q_valid, reinterpret_cast<const int4*>(db), db_valid, g, lut, n,
      n_cap, f, fs);
  return (int)cudaGetLastError();
}
