// K5 route: group one phase's judged outbox rows by destination host.
//
// Replaces the flat route of shadow_tpu/device/engine.py (`_flat_sorted`
// with outbox_compact off, the per-destination segment bounds of
// `_host_windows`, the windows `_seg_take` reads): the exchangeable rows
// (t < DROP_T) are grouped by destination host, in (src, column) order
// within a destination, i.e. by their flat index src*OB + column. The
// outputs are those of the plain version (kernels.route_plain): `perm`
// holds the live rows' flat indices in that order, `starts[d]` and
// `counts[d]` bound destination d's segment. That order decides which
// arrivals past IN the merge cuts and counts as overflow.
//
// A stable LSD radix sort of (destination, 32-bit row index) pairs,
// one-sweep style, in three kinds of launch:
// (1) `route_compact_kernel`: one read of every row (a thread's loads of
//     a tile all in flight at once); the live rows, in row order, go to
//     a dense list (ranks from the warps' ballots, each tile's offset
//     by decoupled look-back over the tiles' live counts, one warp
//     reading 32 predecessors at once), and the
//     histogram of every pass's digit is taken on the way
//     (shared-memory counters, one global add a bin a block);
// (2) one `route_pass_kernel` a digit of RB = 8 bits of the destination,
//     lowest first: each tile of TILE rows ranks its rows stably within
//     their digit (rounds in row order; within a round, ranks within a
//     warp from __match_any_sync and the warps' counts in shared
//     memory), finds the digit's earlier tiles' counts by decoupled
//     look-back (one digit a thread) and scatters to the digit's bucket
//     (an exclusive scan of the pass's histogram). Stable passes leave
//     every destination's rows in row order, so no segment sort
//     remains, whatever a segment's length. A block takes its first
//     tile before anything else, so the blocks past the list's tiles
//     leave after one atomic; a pass whose digit is equal for every
//     live row is the identity and returns at once (a counter says
//     which passes moved rows, so which buffer holds them);
// (3) `route_bounds_kernel`: `starts` and `counts` of every destination, the
//     empty ones included, by binary search over the sorted
//     destinations; `perm` from the sorted row indices; and the reset
//     of the scratch words the next call reads as zero (look-back
//     status, histograms, tile counters), so no memset runs.
// That is 2 + ceil(bits(ND - 1) / 8) launches: 3 at 250 destinations,
// 4 at 10,000-65,536, 5 up to 16,777,216 (keyed: 10). Tiles are taken in order
// from an atomic counter by a grid of at most MAX_GRID blocks, so a
// tile's look-back waits only on tiles whose blocks already run.
//
// The rows come through a `Rows` view (common.cuh): an outbox, or the
// exchange's wire buffers on a mesh rank. Three modes, one set of
// kernels: the outbox grouped over its own H destinations (one device);
// a mesh rank's outbox, H_loc senders, over the H_pad destinations of
// the whole mesh (ND != H, lo = 0), whose shard segments K12 and K13
// pack; and a destination window [lo, lo + ND) over received rows (a
// rank's own hosts: the reference's `_host_windows` at my_shard after
// the exchange), where the rows past the window (forwards a two_phase
// rank relayed) are not live. `keyed` orders a destination's rows by
// their 64-bit key channel (dst*SPAN + src*OB + column) instead of by
// position: two_phase's arrivals come in peer order (engine.py:
// 1800-1806, 1854) and the reference re-sorts them by key (1985-1991).
// A key orders its row by destination first (src*OB + column < SPAN,
// device/kernels.py `_flat_keys`), so keyed rows are sorted by the
// key's eight bytes alone (the passes over its high zero bytes are
// identities): the order is (destination, key), keys being unique.
//
// Under the window loop every kernel returns at once where the control
// block's RUN word is 0 (common.cuh `Ctl`), and leaves its outputs and
// scratch as they were.
//
// The replica axis of an ensemble campaign is blockIdx.y of every
// kernel: replica r's rows through the view's replica strides (an
// outbox's r * F; on a mesh rank the wire buffers [nb, R, C, bw] of
// every replica, both regions of two_phase's `recv1 | recv2`), its perm,
// starts and counts from r * F and r * ND, its scratch `words` int64 on;
// perm holds row indices within the replica's rows.
//
// Bound on the H100: bytes (t of every row, m of live rows, perm of
// live rows written, starts and counts written); the passes' traffic
// over the live rows (8 bytes a row read and written a pass) is above
// it.
#include "common.cuh"

using namespace shadow;

namespace {

constexpr int RB = 8;                   // radix bits a pass
constexpr int BINS = 1 << RB;
constexpr int THREADS = 256;            // one digit a thread in look-back
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 8;                // rows a thread a pass tile
constexpr int TILE = THREADS * ITEMS;
// the compaction's blocks and tiles: more threads and rows, so that
// fewer tiles chain their look-back over the whole outbox
constexpr int CTHREADS = 2 * THREADS;
constexpr int CWARPS = CTHREADS / 32;
constexpr int CITEMS = 16;
constexpr int CTILE = CTHREADS * CITEMS;
constexpr int KEY_PASSES = 8;           // a 64-bit key
constexpr int MAX_PASSES = KEY_PASSES;
constexpr int MAX_GRID = 1024;
static_assert(THREADS == BINS, "one digit a thread");

// look-back status words: the flag in the top two bits (0: not yet
// published), a count below; counts stay below 2^30 (F is checked)
constexpr uint32_t ST_AGG = 1u << 30;
constexpr uint32_t ST_PRE = 2u << 30;
constexpr uint32_t ST_VAL = ST_AGG - 1;
// counters: live rows, tiles taken by the compaction and each pass,
// whether each pass moved rows (1) or was the identity, blocks of the
// bounds kernel done
constexpr int CTR_LIVE = 0;
constexpr int CTR_COMPACT = 1;
constexpr int CTR_PASS = 2;
constexpr int CTR_MOVED = CTR_PASS + MAX_PASSES;
constexpr int CTR_DONE = CTR_MOVED + MAX_PASSES;
constexpr int CTR_N = CTR_DONE + 1;

__host__ __device__ inline int64_t ntiles(int64_t n) {
    return (n + TILE - 1) / TILE;
}

__host__ __device__ inline int64_t ctiles(int64_t n) {
    return (n + CTILE - 1) / CTILE;
}

// One replica's scratch, carved from int64 words: two buffers of the
// rows in flight (destination, index, and keyed their key), the
// compaction's and the passes' look-back status, the histograms and the
// counters. Everything after the buffers is zero between calls.
struct Work {
    uint64_t* key[2];
    uint32_t* dst[2];
    uint32_t* idx[2];
    uint32_t* cstat;    // [ctiles(F)]
    uint32_t* pstat[2]; // [ntiles(F) * BINS] each
    uint32_t* hist;     // [MAX_PASSES * BINS]
    uint32_t* ctr;      // [CTR_N]
};

__host__ __device__ inline int64_t work_words(int64_t F, bool keyed) {
    const int64_t nt = ntiles(F);
    const int64_t u32 = 4 * F + ctiles(F) + 2 * nt * BINS +
                        MAX_PASSES * BINS + CTR_N;
    return (keyed ? 2 * F : 0) + (u32 + 1) / 2;
}

__device__ inline Work carve(int64_t* base, int64_t F, bool keyed) {
    Work w;
    uint64_t* k = (uint64_t*)base;
    w.key[0] = k;
    w.key[1] = k + F;
    uint32_t* u = (uint32_t*)(keyed ? k + 2 * F : k);
    w.dst[0] = u;
    w.dst[1] = u + F;
    w.idx[0] = u + 2 * F;
    w.idx[1] = u + 3 * F;
    const int64_t nt = ntiles(F);
    w.cstat = u + 4 * F;
    w.pstat[0] = w.cstat + ctiles(F);
    w.pstat[1] = w.pstat[0] + nt * BINS;
    w.hist = w.pstat[1] + nt * BINS;
    w.ctr = w.hist + MAX_PASSES * BINS;
    return w;
}

__device__ __forceinline__ uint32_t load_volatile(const uint32_t* p) {
    return *(const volatile uint32_t*)p;
}

__device__ __forceinline__ void store_volatile(uint32_t* p, uint32_t v) {
    *(volatile uint32_t*)p = v;
}

// the exclusive prefix of `own` over the tiles before `tile`, from
// their status words (decoupled look-back); publishes this tile's
// aggregate first and its inclusive prefix last. The predecessors'
// words are read LOOK_BACK at a time, all in flight together: tiles
// that run at once publish their aggregates at once, and a walk of one
// word at a time would cost a load's latency a tile.
constexpr int LOOK_BACK = 16;

__device__ uint32_t look_back(uint32_t* stat, int64_t tile,
                              int64_t stride, uint32_t own) {
    if (tile == 0) {
        store_volatile(stat, ST_PRE | own);
        return 0;
    }
    store_volatile(stat, ST_AGG | own);
    uint32_t excl = 0;
    bool done = false;
    for (int64_t t0 = tile - 1; !done; t0 -= LOOK_BACK) {
        uint32_t s[LOOK_BACK];
#pragma unroll
        for (int i = 0; i < LOOK_BACK; ++i)
            // before tile 0 (never reached: tile 0 is a prefix)
            s[i] = t0 - i >= 0 ? load_volatile(stat + (t0 - i - tile) * stride)
                               : ST_PRE;
#pragma unroll
        for (int i = 0; i < LOOK_BACK; ++i) {
            if (done) break;
            while ((s[i] & ~ST_VAL) == 0)
                s[i] = load_volatile(stat + (t0 - i - tile) * stride);
            excl += s[i] & ST_VAL;
            done = (s[i] & ST_PRE) != 0;
        }
    }
    store_volatile(stat, ST_PRE | (excl + own));
    return excl;
}

// `look_back` by one warp over one status word a tile: its lanes read
// 32 predecessors at once, and the warp sums them up to the nearest
// inclusive prefix
__device__ uint32_t look_back_warp(uint32_t* stat, int64_t tile,
                                   uint32_t own, int lane) {
    if (tile == 0) {
        if (lane == 0) store_volatile(stat, ST_PRE | own);
        return 0;
    }
    if (lane == 0) store_volatile(stat, ST_AGG | own);
    uint32_t excl = 0;
    for (int64_t t0 = tile - 1;; t0 -= 32) {
        const int64_t t = t0 - lane;
        // before tile 0 (never summed: tile 0 is a prefix)
        uint32_t s = t >= 0 ? load_volatile(stat + (t - tile)) : ST_PRE;
        while (__any_sync(0xffffffffu, (s & ~ST_VAL) == 0))
            if ((s & ~ST_VAL) == 0) s = load_volatile(stat + (t - tile));
        const unsigned pre = __ballot_sync(0xffffffffu, (s & ST_PRE) != 0);
        const int first = pre ? __ffs(pre) - 1 : 31;
        excl += __reduce_add_sync(0xffffffffu,
                                  lane <= first ? (s & ST_VAL) : 0u);
        if (pre) break;
    }
    if (lane == 0) store_volatile(stat, ST_PRE | (excl + own));
    return excl;
}

// the digit of pass p: the key's byte p (keyed), else the
// destination's
__device__ __forceinline__ uint32_t digit(int p, int kpass, uint32_t d,
                                         uint64_t k) {
    return p < kpass ? (uint32_t)(k >> (RB * p)) & (BINS - 1)
                     : (d >> (RB * (p - kpass))) & (BINS - 1);
}

// (1) the live rows in row order, and every pass's histogram
template <class View, bool KEYED>
__global__ void __launch_bounds__(CTHREADS)
route_compact_kernel(int64_t F, int ND, int lo, View rows, int64_t* work,
               int64_t words, int npass, const int64_t* ctl) {
    const int64_t r = blockIdx.y;
    if (phase_off(replica_ctl(ctl, r))) return;
    const int kpass = KEYED ? KEY_PASSES : 0;
    const Work w = carve(work + r * words, F, KEYED);
    __shared__ uint32_t hist[MAX_PASSES * BINS];
    __shared__ uint32_t wsum[CITEMS][CWARPS];
    __shared__ int64_t tile_s;
    __shared__ uint32_t base_s;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const uint32_t lt = (1u << lane) - 1;
    for (int b = tid; b < npass * BINS; b += CTHREADS) hist[b] = 0;
    const int64_t nt = ctiles(F);
    uint32_t mine = 0;      // live rows this block listed
    for (;;) {
        if (tid == 0) tile_s = atomicAdd(&w.ctr[CTR_COMPACT], 1u);
        __syncthreads();
        const int64_t tile = tile_s;
        if (tile >= nt) break;
        // the tile's rows, striped: all of a thread's loads in flight
        // at once, t first, then m of the rows t says are live
        int64_t tt[CITEMS];
        uint32_t dd[CITEMS];
        uint64_t kk[CITEMS];
#pragma unroll
        for (int j = 0; j < CITEMS; ++j) {
            const int64_t i = tile * CTILE + j * CTHREADS + tid;
            tt[j] = i < F ? rows.at(CH_T, r, i) : INF;
        }
        uint32_t live_bits = 0;
#pragma unroll
        for (int j = 0; j < CITEMS; ++j) {
            const int64_t i = tile * CTILE + j * CTHREADS + tid;
            dd[j] = 0;
            kk[j] = 0;
            if (tt[j] < DROP_T) {
                const int32_t d = hi32(rows.at(CH_M, r, i)) - lo;
                dd[j] = (uint32_t)d;
                if (d >= 0 && d < ND) live_bits |= 1u << j;
            }
        }
        if (KEYED) {
#pragma unroll
            for (int j = 0; j < CITEMS; ++j)
                if (live_bits >> j & 1)
                    kk[j] = (uint64_t)rows.at(
                        CH_KEY, r, tile * CTILE + j * CTHREADS + tid);
        }
        // ranks in row order: the rounds' warp counts, one barrier
        uint32_t bal[CITEMS];
#pragma unroll
        for (int j = 0; j < CITEMS; ++j) {
            bal[j] = __ballot_sync(0xffffffffu, live_bits >> j & 1);
            if (lane == 0) wsum[j][warp] = __popc(bal[j]);
        }
        __syncthreads();
        uint32_t rank[CITEMS], running = 0;
#pragma unroll
        for (int j = 0; j < CITEMS; ++j) {
            uint32_t pre = running;
#pragma unroll
            for (int v = 0; v < CWARPS; ++v) {
                const uint32_t c = wsum[j][v];
                pre += v < warp ? c : 0;
                running += c;
            }
            rank[j] = pre + __popc(bal[j] & lt);
        }
        if (warp == 0) {
            const uint32_t base =
                look_back_warp(w.cstat + tile, tile, running, lane);
            if (lane == 0) {
                base_s = base;
                mine += running;
            }
        }
        __syncthreads();
        const uint32_t base = base_s;
#pragma unroll
        for (int j = 0; j < CITEMS; ++j) {
            if (!(live_bits >> j & 1)) continue;
            const uint32_t pos = base + rank[j];
            w.dst[0][pos] = dd[j];
            w.idx[0][pos] = (uint32_t)(tile * CTILE + j * CTHREADS + tid);
            if (KEYED) w.key[0][pos] = kk[j];
            for (int p = 0; p < npass; ++p)
                atomicAdd(&hist[p * BINS + digit(p, kpass, dd[j], kk[j])],
                          1u);
        }
        __syncthreads();
    }
    for (int b = tid; b < npass * BINS; b += CTHREADS)
        if (hist[b]) atomicAdd(&w.hist[b], hist[b]);
    if (tid == 0 && mine) atomicAdd(&w.ctr[CTR_LIVE], mine);
}

// how many of passes [0, p) moved rows (the kernels before wrote it)
__device__ __forceinline__ int passes_moved(const Work& w, int p) {
    int j = 0;
    for (int q = 0; q < p; ++q) j += w.ctr[CTR_MOVED + q];
    return j;
}

// (2) one stable pass by the digit of pass p, from buffer j % 2 into
// buffer (j + 1) % 2, j the passes before it that moved rows
template <bool KEYED>
__global__ void __launch_bounds__(THREADS)
route_pass_kernel(int64_t F, int p, int64_t* work, int64_t words,
            const int64_t* ctl) {
    const int64_t r = blockIdx.y;
    if (phase_off(replica_ctl(ctl, r))) return;
    const int kpass = KEYED ? KEY_PASSES : 0;
    const Work w = carve(work + r * words, F, KEYED);
    const uint32_t L = w.ctr[CTR_LIVE];
    if (L == 0) return;
    __shared__ uint32_t gstart[BINS];
    __shared__ uint32_t excl_s[BINS];
    __shared__ uint32_t run[BINS];
    __shared__ uint16_t wc[WARPS][BINS];
    __shared__ uint32_t wsum[WARPS];
    __shared__ int64_t tile_s;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const uint32_t lt = (1u << lane) - 1;
    const int64_t nt = ntiles(L);
    // a tile first: the blocks past the list's tiles leave at once
    if (tid == 0) tile_s = atomicAdd(&w.ctr[CTR_PASS + p], 1u);
    __syncthreads();
    int64_t tile = tile_s;
    if (tile >= nt) return;
    // every live row's digit alike: the identity
    if (__syncthreads_or(w.hist[p * BINS + tid] == L)) return;
    const int in = passes_moved(w, p) & 1, out = in ^ 1;
    if (tile == 0 && tid == 0) w.ctr[CTR_MOVED + p] = 1;
    // the digit's bucket: an exclusive scan of the pass's histogram
    {
        const uint32_t c = w.hist[p * BINS + tid];
        uint32_t x = c;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
            if (lane >= o) x += y;
        }
        if (lane == 31) wsum[warp] = x;
        run[tid] = 0;
        for (int v = 0; v < WARPS; ++v) wc[v][tid] = 0;
        __syncthreads();
        uint32_t pre = 0;
        for (int v = 0; v < warp; ++v) pre += wsum[v];
        gstart[tid] = pre + x - c;
        __syncthreads();
    }
    const uint32_t* __restrict__ dsrc = w.dst[in];
    const uint32_t* __restrict__ isrc = w.idx[in];
    const uint64_t* __restrict__ ksrc = w.key[in];
    for (;;) {
        // the next moving pass's status word of this tile and digit
        // starts at zero (it has the same tiles)
        w.pstat[out][tile * BINS + tid] = 0;
        uint32_t dd[ITEMS], ii[ITEMS], rank[ITEMS];
        uint64_t kk[ITEMS];
#pragma unroll
        for (int q = 0; q < ITEMS; ++q) {
            const int64_t e = tile * TILE + q * THREADS + tid;
            const bool valid = e < L;
            dd[q] = valid ? dsrc[e] : 0;
            ii[q] = valid ? isrc[e] : 0;
            kk[q] = KEYED && valid ? ksrc[e] : 0;
        }
#pragma unroll
        for (int q = 0; q < ITEMS; ++q) {
            // rounds past the list's end: none (the same for every
            // thread of the block)
            if (tile * TILE + q * THREADS >= L) break;
            const bool valid = tile * TILE + q * THREADS + tid < L;
            // BINS: no digit (past the list's end)
            const uint32_t dg = valid ? digit(p, kpass, dd[q], kk[q]) : BINS;
            const uint32_t peers = __match_any_sync(0xffffffffu, dg);
            const bool leader = (peers & lt) == 0;
            if (valid && leader) wc[warp][dg] = (uint16_t)__popc(peers);
            __syncthreads();
            if (valid) {
                uint32_t rk = run[dg] + __popc(peers & lt);
                for (int v = 0; v < warp; ++v) rk += wc[v][dg];
                rank[q] = rk;
            }
            __syncthreads();
            if (valid && leader) {
                atomicAdd(&run[dg], (uint32_t)__popc(peers));
                wc[warp][dg] = 0;
            }
            __syncthreads();
        }
        // this tile's count of digit tid, its earlier tiles' by
        // look-back
        excl_s[tid] = gstart[tid] +
                      look_back(w.pstat[in] + tile * BINS + tid, tile, BINS,
                                run[tid]);
        __syncthreads();
#pragma unroll
        for (int q = 0; q < ITEMS; ++q) {
            const int64_t e = tile * TILE + q * THREADS + tid;
            if (e >= L) continue;
            const uint32_t pos =
                excl_s[digit(p, kpass, dd[q], kk[q])] + rank[q];
            w.dst[out][pos] = dd[q];
            w.idx[out][pos] = ii[q];
            if (KEYED) w.key[out][pos] = kk[q];
        }
        run[tid] = 0;
        if (tid == 0) tile_s = atomicAdd(&w.ctr[CTR_PASS + p], 1u);
        __syncthreads();
        tile = tile_s;
        if (tile >= nt) break;
    }
}

// first index of the sorted destinations [0, L) at or past d
__device__ __forceinline__ uint32_t lower_bound(const uint32_t* a,
                                                uint32_t L, uint32_t d) {
    uint32_t lo_ = 0, hi = L;
    while (lo_ < hi) {
        const uint32_t mid = (lo_ + hi) >> 1;
        if (a[mid] < d)
            lo_ = mid + 1;
        else
            hi = mid;
    }
    return lo_;
}

// (3) starts and counts of every destination, perm, and the scratch
// reset
template <bool KEYED>
__global__ void __launch_bounds__(THREADS)
route_bounds_kernel(int64_t F, int ND, int npass, int64_t* work, int64_t words,
              int64_t* perm, int64_t* starts, int64_t* counts,
              const int64_t* ctl) {
    const int64_t r = blockIdx.y;
    if (phase_off(replica_ctl(ctl, r))) return;
    const Work w = carve(work + r * words, F, KEYED);
    const uint32_t L = w.ctr[CTR_LIVE];
    // the passes that moved rows: the sorted rows lie in buffer moved % 2
    const int moved = passes_moved(w, npass);
    const int fin = moved & 1;
    const uint32_t* __restrict__ dsorted = w.dst[fin];
    const int tid = threadIdx.x, lane = tid & 31;
    const int64_t gthreads = (int64_t)gridDim.x * THREADS;
    const int64_t g0 = (int64_t)blockIdx.x * THREADS + tid;
    starts += r * ND;
    counts += r * ND;
    perm += r * F;
    // destinations in warp-aligned strides, so that a lane takes its
    // upper bound from the next lane's search
    for (int64_t d0 = g0 - lane; d0 < ND; d0 += gthreads) {
        const int64_t d = d0 + lane;
        const uint32_t s = d < ND ? lower_bound(dsorted, L, (uint32_t)d) : L;
        uint32_t e = __shfl_down_sync(0xffffffffu, s, 1);
        if (lane == 31)
            e = d + 1 < ND ? lower_bound(dsorted, L, (uint32_t)(d + 1)) : L;
        if (d < ND) {
            starts[d] = s;
            counts[d] = (int64_t)(d + 1 < ND ? e : L) - s;
        }
    }
    const uint32_t* __restrict__ isorted = w.idx[fin];
    for (int64_t i = g0; i < L; i += gthreads) perm[i] = isorted[i];
    // status words back to zero: the compaction's, and the last moving
    // pass's (each pass zeroed the other array for its successor)
    const int64_t nct = ctiles(F);
    for (int64_t x = g0; x < nct; x += gthreads) w.cstat[x] = 0;
    if (moved > 0) {
        uint32_t* st = w.pstat[(moved - 1) & 1];
        const int64_t n = ntiles(L) * BINS;
        for (int64_t x = g0; x < n; x += gthreads) st[x] = 0;
    }
    // the last block out zeroes the histograms and counters, which
    // every block has read
    __shared__ bool last;
    __syncthreads();
    if (tid == 0) {
        __threadfence();
        last = atomicAdd(&w.ctr[CTR_DONE], 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int b = tid; b < npass * BINS; b += THREADS) w.hist[b] = 0;
    if (tid < CTR_N) w.ctr[tid] = 0;
}

int dst_passes(int ND) {
    int bits = 0;
    while (bits < 32 && (uint64_t)(ND - 1) >> bits) ++bits;
    return (bits + RB - 1) / RB;
}

template <class View, bool KEYED>
int launch(int R, int64_t F, int ND, int lo, const View& rows,
           int64_t* perm, int64_t* starts, int64_t* counts, int64_t* work,
           int64_t words, const int64_t* ctl, cudaStream_t st) {
    // keyed: the key's bytes alone (it orders a row by destination
    // first); else the destination's
    const int npass = KEYED ? KEY_PASSES : dst_passes(ND);
    const int64_t nt = ntiles(F), nct = ctiles(F);
    const unsigned cgrid = (unsigned)(nct < MAX_GRID ? (nct > 0 ? nct : 1)
                                                     : MAX_GRID);
    const unsigned grid = (unsigned)(nt < MAX_GRID ? (nt > 0 ? nt : 1)
                                                   : MAX_GRID);
    route_compact_kernel<View, KEYED><<<dim3(cgrid, R), CTHREADS, 0, st>>>(
        F, ND, lo, rows, work, words, npass, ctl);
    for (int p = 0; p < npass; ++p)
        route_pass_kernel<KEYED><<<dim3(grid, R), THREADS, 0, st>>>(
            F, p, work, words, ctl);
    const int64_t nb = (ND + THREADS - 1) / THREADS;
    const unsigned bgrid = (unsigned)(nb < MAX_GRID ? nb : MAX_GRID);
    route_bounds_kernel<KEYED><<<dim3(bgrid, R), THREADS, 0, st>>>(
        F, ND, npass, work, words, perm, starts, counts, ctl);
    return (int)cudaGetLastError();
}

}  // namespace

// F rows a replica (all rows of `rows`), destinations [lo, lo + ND);
// work holds `words` = work_words(F, keyed) int64 a replica
// (kernels.route_work_words), zeroed before the first call.
extern "C" int shadow_route(int R, long long F, int ND, int lo, int keyed,
                            const Rows* rows, int64_t* perm,
                            int64_t* starts, int64_t* counts,
                            int64_t* work, long long words,
                            const int64_t* ctl, void* stream) {
    if (R < 1 || R > 65535 || rows == nullptr || F < 0 ||
        F >= (1ll << 30) || words != work_words(F, keyed != 0) ||
        (R > 1 && (rows->rs == 0 || (rows->n_a != F && rows->rs_b == 0))) ||
        (keyed && rows->a[CH_KEY] == nullptr))
        return (int)cudaErrorInvalidValue;
    if (ND <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    if (keyed)
        return launch<Rows, true>(R, F, ND, lo, *rows, perm, starts,
                                  counts, work, words, ctl, st);
    // an outbox reads through plain pointers
    if (is_outbox(*rows, F))
        return launch<OutboxRows, false>(R, F, ND, lo, OutboxRows(*rows),
                                         perm, starts, counts, work, words,
                                         ctl, st);
    return launch<Rows, false>(R, F, ND, lo, *rows, perm, starts, counts,
                               work, words, ctl, st);
}
