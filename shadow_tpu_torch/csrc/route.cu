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
// No comparison sort of the whole outbox: (1) a per-destination count of
// live rows; (2) an exclusive scan of the counts into `starts`, by hand:
// a scan within blocks of SCAN_BLOCK counts, a scan of the block
// totals, and an add-back that also seeds the scatter cursors; (3) a
// scatter of flat indices with per-destination atomic cursors, which
// leaves each segment in arbitrary order; (4) a sort of each segment by
// flat index, which makes `perm` deterministic: one thread per segment
// of at most SHORT rows (an insertion sort in registers), one block per
// longer segment (a rank sort through shared-memory tiles; a segment
// longer than IN arises only in a run that overflows, and still comes
// out in order). Flat indices are unique, so ranks are too.
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
// After all_to_all a row's position already is its key's order (blocks
// by source shard, each in its segment's key order) and after
// all_gather too (blocks by source shard, each in flat order), so those
// keep the cheaper positional sort. Keys of live rows are unique.
//
// Under the window loop each of its kernels returns at once where the
// control block's RUN word is 0 (common.cuh `Ctl`); the memset of the
// counts still runs, which is harmless: only the guarded merge reads
// them.
//
// The replica axis of an ensemble campaign is blockIdx.y of every
// kernel: a scan per replica, over its own outbox [H,OB], counts,
// starts, perm, scattered rows, cursors and block sums (each [R, ...]);
// perm holds flat indices within the replica's outbox. Replica r's rows
// are indexed from r * H (per host) and r * F (per row); the pointers
// stay kernel parameters.
//
// Bound on the H100: bytes (t of every row, m of live rows, perm of live
// rows written, starts and counts written); the scratch traffic (the
// scattered indices read back by the segment sort) is above it.
#include "common.cuh"

using namespace shadow;

namespace {

constexpr int SCAN_BLOCK = 1024;    // counts per scan block
constexpr int SCAN_THREADS = 256;   // 4 counts per thread
constexpr int SHORT = 32;           // longest segment one thread sorts
constexpr int TILE = 1024;          // rank-sort tile, in rows

// row i of replica r, if exchangeable and destined [lo, lo + ND): its
// destination's bucket
template <class View>
__device__ __forceinline__ bool live_dst(const View& rows, int64_t r,
                                         int64_t i, int lo, int ND,
                                         int* dst) {
    if (!(rows.at(CH_T, r, i) < DROP_T)) return false;
    const int32_t d = hi32(rows.at(CH_M, r, i)) - lo;
    *dst = d;
    return d >= 0 && d < ND;
}

template <class View>
__global__ void count_kernel(int64_t F, int ND, int lo, View rows,
                             unsigned long long* counts,
                             const int64_t* ctl) {
    const int64_t r = blockIdx.y;
    if (phase_off(replica_ctl(ctl, r))) return;
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    int d;
    if (i < F && live_dst(rows, r, i, lo, ND, &d))
        atomicAdd(&counts[r * ND + d], 1ull);
}

// exclusive scan of SCAN_BLOCK counts per block; block totals out
__global__ void scan_blocks_kernel(int H, int nb,
                                   const int64_t* __restrict__ counts,
                                   int64_t* starts, int64_t* block_sums,
                                   const int64_t* ctl) {
    const int64_t r = blockIdx.y;
    if (phase_off(replica_ctl(ctl, r))) return;
    const int64_t rh = r * H;
    __shared__ int64_t sm[SCAN_THREADS];
    const int tid = threadIdx.x;
    const int64_t base = (int64_t)blockIdx.x * SCAN_BLOCK + tid * 4;
    int64_t v[4], sum = 0;
    for (int j = 0; j < 4; ++j) {
        v[j] = base + j < H ? counts[rh + base + j] : 0;
        sum += v[j];
    }
    sm[tid] = sum;
    __syncthreads();
    // Hillis-Steele inclusive scan of the per-thread sums
    for (int off = 1; off < SCAN_THREADS; off <<= 1) {
        const int64_t x = tid >= off ? sm[tid - off] : 0;
        __syncthreads();
        sm[tid] += x;
        __syncthreads();
    }
    int64_t run = sm[tid] - sum;
    for (int j = 0; j < 4; ++j) {
        if (base + j < H) starts[rh + base + j] = run;
        run += v[j];
    }
    if (tid == SCAN_THREADS - 1) block_sums[r * nb + blockIdx.x] = sm[tid];
}

// exclusive scan of the block totals in place, one block, chunk by chunk
__global__ void scan_sums_kernel(int nb, int64_t* block_sums,
                                 const int64_t* ctl) {
    const int64_t r = blockIdx.y;
    if (phase_off(replica_ctl(ctl, r))) return;
    const int64_t rb = r * nb;
    __shared__ int64_t sm[SCAN_THREADS];
    __shared__ int64_t carry;
    const int tid = threadIdx.x;
    if (tid == 0) carry = 0;
    __syncthreads();
    for (int base = 0; base < nb; base += SCAN_THREADS) {
        const int i = base + tid;
        const int64_t x0 = i < nb ? block_sums[rb + i] : 0;
        sm[tid] = x0;
        __syncthreads();
        for (int off = 1; off < SCAN_THREADS; off <<= 1) {
            const int64_t x = tid >= off ? sm[tid - off] : 0;
            __syncthreads();
            sm[tid] += x;
            __syncthreads();
        }
        if (i < nb) block_sums[rb + i] = carry + sm[tid] - x0;
        __syncthreads();
        if (tid == SCAN_THREADS - 1) carry += sm[tid];
        __syncthreads();
    }
}

__global__ void add_back_kernel(int H, int nb,
                                const int64_t* __restrict__ block_sums,
                                int64_t* starts, int64_t* cursor,
                                const int64_t* ctl) {
    const int64_t r = blockIdx.y;
    if (phase_off(replica_ctl(ctl, r))) return;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= H) return;
    const int64_t g = r * H + i;
    const int64_t s = starts[g] + block_sums[r * nb + i / SCAN_BLOCK];
    starts[g] = s;
    cursor[g] = s;
}

template <class View>
__global__ void scatter_kernel(int64_t F, int ND, int lo, View rows,
                               unsigned long long* cursor,
                               int64_t* scattered,
                               const int64_t* ctl) {
    const int64_t r = blockIdx.y;
    if (phase_off(replica_ctl(ctl, r))) return;
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    int d;
    if (i < F && live_dst(rows, r, i, lo, ND, &d))
        scattered[r * F + (int64_t)atomicAdd(&cursor[r * ND + d], 1ull)] =
            i;
}

// the sort key of row x: its key channel where KEYED, else its
// position; ties (none among live rows) fall to the position
template <bool KEYED>
__device__ __forceinline__ int64_t sort_key(const Rows& rows, int64_t r,
                                            int64_t x) {
    if constexpr (KEYED)
        return rows.at(CH_KEY, r, x);
    else
        return x;
}

// segments of at most SHORT rows: one thread, an insertion sort
template <bool KEYED>
__global__ void sort_short_kernel(int ND, int64_t F, Rows rows,
                                  const int64_t* __restrict__ starts,
                                  const int64_t* __restrict__ counts,
                                  const int64_t* __restrict__ scattered,
                                  int64_t* perm,
                                  const int64_t* ctl) {
    const int64_t r = blockIdx.y;
    if (phase_off(replica_ctl(ctl, r))) return;
    const int d = blockIdx.x * blockDim.x + threadIdx.x;
    if (d >= ND) return;
    const int64_t n = counts[r * ND + d];
    if (n == 0 || n > SHORT) return;
    // the segment's first row, replica r's rows from r * F
    const int64_t s = r * F + starts[r * ND + d];
    int64_t x[SHORT];
#pragma unroll
    for (int i = 0; i < SHORT; ++i) x[i] = i < n ? scattered[s + i] : IMAX;
    if constexpr (KEYED) {
        // (key, position) pairs; the keys of live rows are unique
        int64_t k[SHORT];
#pragma unroll
        for (int i = 0; i < SHORT; ++i)
            k[i] = i < n ? sort_key<KEYED>(rows, r, x[i]) : IMAX;
#pragma unroll
        for (int i = 1; i < SHORT; ++i) {
#pragma unroll
            for (int j = i; j > 0; --j) {
                const bool swap = k[j] < k[j - 1] ||
                                  (k[j] == k[j - 1] && x[j] < x[j - 1]);
                const int64_t ka = k[j - 1], xa = x[j - 1];
                k[j - 1] = swap ? k[j] : ka;
                x[j - 1] = swap ? x[j] : xa;
                k[j] = swap ? ka : k[j];
                x[j] = swap ? xa : x[j];
            }
        }
    } else {
#pragma unroll
        for (int i = 1; i < SHORT; ++i) {
#pragma unroll
            for (int j = i; j > 0; --j) {
                const int64_t a = x[j - 1], b = x[j];
                const bool swap = b < a;
                x[j - 1] = swap ? b : a;
                x[j] = swap ? a : b;
            }
        }
    }
#pragma unroll
    for (int i = 0; i < SHORT; ++i)
        if (i < n) perm[s + i] = x[i];
}

// longer segments: a block owns every gridDim.x-th destination (so that
// neighbouring hot destinations go to different blocks), reads the counts
// of LONG_THREADS of them at once, lists the long ones in shared memory
// and rank-sorts each in turn: row i goes to its segment's start plus the
// number of the segment's rows whose (key, position) is below its own.
// (Stepping one destination at a time, a block waited on each count's
// load in turn.)
constexpr int LONG_THREADS = 256;

template <bool KEYED>
__global__ void sort_long_kernel(int ND, int64_t F, Rows rows,
                                 const int64_t* __restrict__ starts,
                                 const int64_t* __restrict__ counts,
                                 const int64_t* __restrict__ scattered,
                                 int64_t* perm,
                                 const int64_t* ctl) {
    const int64_t r = blockIdx.y;
    if (phase_off(replica_ctl(ctl, r))) return;
    const int64_t rh = r * ND;
    __shared__ int64_t tile_x[TILE];
    __shared__ int64_t tile_k[KEYED ? TILE : 1];
    __shared__ int found[LONG_THREADS];
    __shared__ int n_found;
    for (int64_t k0 = 0; blockIdx.x + k0 * gridDim.x < ND;
         k0 += LONG_THREADS) {
        if (threadIdx.x == 0) n_found = 0;
        __syncthreads();
        const int64_t d = blockIdx.x + (k0 + threadIdx.x) * gridDim.x;
        if (d < ND && counts[rh + d] > SHORT)
            found[atomicAdd(&n_found, 1)] = (int)d;
        __syncthreads();
        const int nf = n_found;
        for (int f = 0; f < nf; ++f) {
            const int dd = found[f];
            const int64_t n = counts[rh + dd];
            // the segment's first row, replica r's rows from r * F
            const int64_t s = r * F + starts[rh + dd];
            for (int64_t i0 = 0; i0 < n; i0 += LONG_THREADS) {
                const int64_t i = i0 + threadIdx.x;
                const int64_t x = i < n ? scattered[s + i] : IMAX;
                const int64_t kx =
                    i < n ? sort_key<KEYED>(rows, r, x) : IMAX;
                int64_t rank = 0;
                for (int64_t b = 0; b < n; b += TILE) {
                    const int64_t w = n - b < TILE ? n - b : TILE;
                    for (int k = threadIdx.x; k < w; k += LONG_THREADS) {
                        tile_x[k] = scattered[s + b + k];
                        if constexpr (KEYED)
                            tile_k[k] = sort_key<KEYED>(rows, r, tile_x[k]);
                    }
                    __syncthreads();
                    for (int k = 0; k < w; ++k) {
                        if constexpr (KEYED)
                            rank += tile_k[k] < kx ||
                                    (tile_k[k] == kx && tile_x[k] < x);
                        else
                            rank += tile_x[k] < x;
                    }
                    __syncthreads();
                }
                if (i < n) perm[s + rank] = x;
            }
        }
        __syncthreads();
    }
}

template <bool KEYED>
void sort_segments(int R, int ND, int64_t F, const Rows& rows,
                   const int64_t* starts, const int64_t* counts,
                   const int64_t* scattered, int64_t* perm,
                   const int64_t* ctl, cudaStream_t st) {
    const int threads = 256;
    const dim3 dst_grid((unsigned)((ND + threads - 1) / threads), R);
    sort_short_kernel<KEYED><<<dst_grid, threads, 0, st>>>(
        ND, F, rows, starts, counts, scattered, perm, ctl);
    const int long_grid = ND < 1024 ? ND : 1024;
    sort_long_kernel<KEYED><<<dim3(long_grid, R), LONG_THREADS, 0, st>>>(
        ND, F, rows, starts, counts, scattered, perm, ctl);
}

}  // namespace

// The block sums hold at least route_scan_blocks(ND) int64 a replica.
extern "C" int shadow_route_scan_blocks(int ND) {
    return (ND + SCAN_BLOCK - 1) / SCAN_BLOCK;
}

// F rows a replica (all rows of `rows`), destinations [lo, lo + ND);
// scattered holds F entries a replica, cursor ND, block_sums
// shadow_route_scan_blocks(ND).
extern "C" int shadow_route(int R, long long F, int ND, int lo, int keyed,
                            const Rows* rows, int64_t* perm,
                            int64_t* starts, int64_t* counts,
                            int64_t* scattered, int64_t* cursor,
                            int64_t* block_sums, const int64_t* ctl,
                            void* stream) {
    if (R < 1 || R > 65535 || rows == nullptr || F < 0 ||
        (R > 1 && rows->n_a != F) ||
        (keyed && rows->a[CH_KEY] == nullptr))
        return (int)cudaErrorInvalidValue;
    if (ND <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    const int threads = 256;
    const dim3 rows_grid((unsigned)((F + threads - 1) / threads), R);
    const dim3 dst_grid((unsigned)((ND + threads - 1) / threads), R);
    const int nb = shadow_route_scan_blocks(ND);
    cudaError_t err =
        cudaMemsetAsync(counts, 0, sizeof(int64_t) * ND * (size_t)R, st);
    if (err != cudaSuccess) return (int)err;
    // an outbox reads through plain pointers
    const bool ob = is_outbox(*rows, F);
    if (F > 0 && ob)
        count_kernel<<<rows_grid, threads, 0, st>>>(
            F, ND, lo, OutboxRows(*rows), (unsigned long long*)counts, ctl);
    else if (F > 0)
        count_kernel<<<rows_grid, threads, 0, st>>>(
            F, ND, lo, *rows, (unsigned long long*)counts, ctl);
    scan_blocks_kernel<<<dim3(nb, R), SCAN_THREADS, 0, st>>>(
        ND, nb, counts, starts, block_sums, ctl);
    scan_sums_kernel<<<dim3(1, R), SCAN_THREADS, 0, st>>>(nb, block_sums,
                                                          ctl);
    add_back_kernel<<<dst_grid, threads, 0, st>>>(ND, nb, block_sums,
                                                  starts, cursor, ctl);
    if (F > 0 && ob)
        scatter_kernel<<<rows_grid, threads, 0, st>>>(
            F, ND, lo, OutboxRows(*rows), (unsigned long long*)cursor,
            scattered, ctl);
    else if (F > 0)
        scatter_kernel<<<rows_grid, threads, 0, st>>>(
            F, ND, lo, *rows, (unsigned long long*)cursor, scattered, ctl);
    if (keyed)
        sort_segments<true>(R, ND, F, *rows, starts, counts, scattered,
                            perm, ctl, st);
    else
        sort_segments<false>(R, ND, F, *rows, starts, counts, scattered,
                             perm, ctl, st);
    return (int)cudaGetLastError();
}
