// K7 count_paths: the per-path packet counters of one phase.
//
// Replaces shadow_tpu/device/engine.py `_count_paths` (the reference's
// topology_incrementPathPacketCounter): a [V*V] histogram of the packets
// each judged outbox row sent, drop-rolled ones included, at
// (vertex of src) * V + (vertex of dst). A row counts when t < INF (the
// judge marks a dead row DROP_T under the path counters, so it still
// counts) and its kind byte is KIND_PACKET; its weight is the live count
// in the kind word's upper bits (kind >> 8). The reference sorts the
// rows by pair and takes prefix-sum segment totals, a TPU's way round a
// scatter; here the sums are atomic adds. Integer sums are exact in any
// order, so the histogram equals the reference's whatever order the adds
// land in.
//
// Which rows it reads. The outbox outlives a phase (pop_phase.cu): after
// the pop, a host whose pop count is 0 holds only clear rows (t = INF),
// unless the engine's outbox word says the rows came from outside the
// pop (a flush of rows copied in, whose pop counts are 0). So a launch
// given the pop counts may skip the hosts that popped nothing, reading
// every host's rows where the word is set; this is K2's rule
// (judge_outbox.cu), read as K2, the tally and K11 read it. It pays
// where the outbox is large. Where it is small enough to sit in L2, a
// phase's launch is a chain of dependent loads and the rows cost little
// to read, and a pop count read first is one load more on the chain: on
// tgen_10000_nic's 390,000 rows the reads it saves do not pay for it
// (PERF.md). So a launch over `gated_rows` rows or more (the wrapper's
// Kernels.paths_gated_rows, 2^20) reads by the pop counts
// (`count_paths_popped_kernel`), and a smaller one every row
// (`count_paths_rows_kernel`). A large launch given no pop counts reads
// every host's rows through the first where V*V <= SHARED_BINS (its
// shared histogram, below, is what pays there), else through the
// second.
//
// Every row: a thread a row, as before, so that each live row waits on
// one chain of loads: t, m of a row below INF, k and both ends' vertices
// of a packet row.
//
// By the pop counts: a warp takes WARP_HOSTS consecutive hosts, loads
// their pop counts, the outbox word and the RUN word together, lists the
// hosts to read (a ballot; every host where the word is set) and reads
// their rows as one flat list of (host, column) items, UNROLL items a
// lane in flight: t, then m and k of the items below INF (at a fixed
// address where an item is not live, so that no load waits on a branch),
// then both ends' vertices. A warp's hosts are consecutive, and the
// hosts that pop in a phase cluster, so the items of a busy warp are
// mostly one host's columns.
//
// Both sum the packet rows of a warp by pair (`__match_any_sync`, then
// `__reduce_add_sync`): a warp's rows are one or two hosts' columns, one
// source vertex, so where V is small its rows fall on few pairs. Every
// row adds a warp's sums with one 64-bit global atomic a distinct pair.
// By the pop counts, where V*V <= SHARED_BINS, a block adds them into a
// histogram of its own in shared memory and then adds each nonzero bin
// to the global one, one atomic a bin a block: there the rows are many
// and the pairs few, and a warp's global atomics queued on those few
// words. Above SHARED_BINS the warp's sums go to global memory as on the
// rows kernel. (On outboxes of tgen_10000_nic's size the reading by the
// pop counts, shared histogram and all, loses to the rows kernel:
// PERF.md.)
//
// On a mesh rank (H_loc hosts of H_pad, the global ids of the rank's
// first host on from g0) the rows' sources and destinations are global
// ids, which the vertex lookup clips to the Hv = H_pad hosts of the
// world's host_vertex (engine.py:1327-1352 clips to H_pad); on one device
// Hv = H. The rank counts its own outbox into its own [1, V*V] row (the
// reference's [S, V*V], a row a shard), and the run sums the rows.
//
// Under the window loop the launch returns at once where the control
// block's RUN word is 0 (common.cuh `Ctl`). The replica axis of an
// ensemble campaign is blockIdx.y: replica r's rows, pop counts and
// outbox word, into its own histogram, path_cnt [R, 1, V*V].
//
// The design before (a thread a row over every row, one 64-bit global
// atomic a packet row) stays reachable for measurement (`every_row`,
// Kernels.designs_before), never as a fallback.
//
// Bound on the H100: bytes: the pop counts [H] (where the launch reads
// by them); t of the rows of each host read (OB*8); k and m of the
// packet rows and both ends' vertices; each touched histogram entry
// read and written (a block's shared bins are not charged).
#include "common.cuh"

using namespace shadow;

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 65535;
// hosts a warp lists, and the row items a lane keeps in flight
constexpr int WARP_HOSTS = 8;
constexpr int UNROLL = 5;
// the largest V*V whose histogram a block keeps in shared memory (8 KB)
constexpr int SHARED_BINS = 1024;

__device__ __forceinline__ int clamp_host(int32_t x, int H) {
    return x < 0 ? 0 : (x > H - 1 ? H - 1 : x);
}

// every row: a thread a row, the packet rows of a warp summed by pair
__global__ void __launch_bounds__(THREADS)
count_paths_rows_kernel(int64_t rows, int OB, int Hv, int V,
                        const int64_t* __restrict__ ob_t,
                        const int64_t* __restrict__ ob_k,
                        const int64_t* __restrict__ ob_m,
                        const int32_t* __restrict__ host_vertex,
                        unsigned long long* path_cnt, const int64_t* ctl) {
    const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    const int64_t r = blockIdx.y;
    if (i >= rows || phase_off(replica_ctl(ctl, r))) return;
    const int64_t row = r * rows + i;
    if (!(__ldg(ob_t + row) < INF)) return;
    const int64_t fm = __ldg(ob_m + row);
    const int32_t kind = lo32(fm);
    if ((kind & 0xFF) != KIND_PACKET) return;
    const int pair =
        __ldg(host_vertex + clamp_host(hi32(__ldg(ob_k + row)), Hv)) * V +
        __ldg(host_vertex + clamp_host(hi32(fm), Hv));
    // every other lane has returned (an exited lane named in the mask
    // takes no part): the lowest lane of each pair adds the pair's sum
    const unsigned peers = __match_any_sync(FULL, pair);
    const int sum = __reduce_add_sync(peers, kind >> 8);
    if ((int)(threadIdx.x & 31) == __ffs(peers) - 1)
        atomicAdd(path_cnt + r * V * V + pair,
                  (unsigned long long)(int64_t)sum);
}

// The warp's packet rows of one step (`pkt` where the lane holds one)
// summed by pair: the lowest lane of each pair adds the pair's sum.
// Every lane of the warp calls it.
__device__ __forceinline__ void add_pairs(unsigned long long* cnt,
                                          bool pkt, int pair, int w,
                                          int lane) {
    const unsigned live = __ballot_sync(FULL, pkt);
    if (!pkt) return;
    const unsigned peers = __match_any_sync(live, pair);
    const int sum = __reduce_add_sync(peers, w);
    if (lane == __ffs(peers) - 1)
        atomicAdd(cnt + pair, (unsigned long long)(int64_t)sum);
}

// by the pop counts: a warp WARP_HOSTS hosts (warps grid-strided), their
// listed rows as flat items; SHARED: into the block's own histogram
template <bool SHARED>
__global__ void __launch_bounds__(THREADS)
count_paths_popped_kernel(int H, int Hv, int OB, int V,
                          const int64_t* __restrict__ ob_t,
                          const int64_t* __restrict__ ob_k,
                          const int64_t* __restrict__ ob_m,
                          const int32_t* __restrict__ host_vertex,
                          unsigned long long* path_cnt,
                          const int32_t* __restrict__ pops,
                          const int32_t* __restrict__ ob_word,
                          const int64_t* ctl) {
    __shared__ int lists[THREADS / 32][32];
    __shared__ unsigned long long hist[SHARED ? SHARED_BINS : 1];
    const int64_t r = blockIdx.y;
    const int64_t rh = r * H;
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int64_t first =
        ((int64_t)blockIdx.x * (THREADS / 32) + wid) * WARP_HOSTS;
    const int64_t step = (int64_t)gridDim.x * (THREADS / 32) * WARP_HOSTS;
    // the first hosts' pop counts, the outbox word and the RUN word load
    // together: none waits on another
    // (no pop counts: every host's rows)
    int32_t pv = pops != nullptr && lane < WARP_HOSTS && first + lane < H
                     ? __ldg(pops + rh + first + lane)
                     : 0;
    const bool every = ob_word == nullptr || __ldg(ob_word + r) != 0;
    // r is the block's: the whole block returns, before any barrier
    if (phase_off(replica_ctl(ctl, r))) return;
    unsigned long long* cnt = path_cnt + r * V * V;
    const int bins = V * V;
    if (SHARED) {
        for (int b = threadIdx.x; b < bins; b += THREADS) hist[b] = 0;
        __syncthreads();
    }
    unsigned long long* sums = SHARED ? hist : cnt;
    for (int64_t h0 = first; h0 < H; h0 += step) {
        if (h0 != first)
            pv = pops != nullptr && lane < WARP_HOSTS && h0 + lane < H
                     ? __ldg(pops + rh + h0 + lane)
                     : 0;
        const bool mine =
            lane < WARP_HOSTS && h0 + lane < H && (every || pv != 0);
        const unsigned need = __ballot_sync(FULL, mine);
        if (mine) lists[wid][__popc(need & ((1u << lane) - 1u))] = lane;
        __syncwarp();
        const int items = __popc(need) * OB;
        const int64_t base = (rh + h0) * OB;
        for (int i0 = 0; i0 < items; i0 += 32 * UNROLL) {
            int64_t row[UNROLL], t[UNROLL], m[UNROLL], k[UNROLL];
            bool pkt[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                const int i = i0 + u * 32 + lane;
                const int j = i / OB;
                row[u] = i >= items ? base
                         : every    ? base + i
                                    : base + (int64_t)lists[wid][j] * OB +
                                       (i - j * OB);
                t[u] = __ldg(ob_t + row[u]);
            }
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                pkt[u] = i0 + u * 32 + lane < items && t[u] < INF;
                const int64_t at = pkt[u] ? row[u] : base;
                m[u] = __ldg(ob_m + at);
                k[u] = __ldg(ob_k + at);
            }
            int pair[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                pkt[u] = pkt[u] && (lo32(m[u]) & 0xFF) == KIND_PACKET;
                pair[u] =
                    __ldg(host_vertex + clamp_host(hi32(k[u]), Hv)) * V +
                    __ldg(host_vertex + clamp_host(hi32(m[u]), Hv));
            }
#pragma unroll
            for (int u = 0; u < UNROLL; ++u)
                add_pairs(sums, pkt[u], pair[u], lo32(m[u]) >> 8, lane);
        }
        __syncwarp();    // the list, before the next hosts'
    }
    if (SHARED) {
        __syncthreads();
        for (int b = threadIdx.x; b < bins; b += THREADS) {
            const unsigned long long v = hist[b];
            if (v != 0) atomicAdd(cnt + b, v);
        }
    }
}

// the design before: a thread a row over every row, a global atomic a
// packet row
__global__ void count_paths_kernel(int64_t rows, int OB, int Hv, int V,
                                   const int64_t* __restrict__ ob_t,
                                   const int64_t* __restrict__ ob_k,
                                   const int64_t* __restrict__ ob_m,
                                   const int32_t* __restrict__ host_vertex,
                                   unsigned long long* path_cnt,
                                   const int64_t* ctl) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int64_t r = blockIdx.y;
    if (i >= rows || phase_off(replica_ctl(ctl, r))) return;
    const int64_t row = r * rows + i;
    if (!(ob_t[row] < INF)) return;
    const int64_t fm = ob_m[row];
    const int32_t kind = lo32(fm);
    if ((kind & 0xFF) != KIND_PACKET) return;
    const int sh = clamp_host(hi32(ob_k[row]), Hv);
    const int dh = clamp_host(hi32(fm), Hv);
    const int64_t pair = r * (int64_t)V * V +
        (int64_t)host_vertex[sh] * V + (int64_t)host_vertex[dh];
    atomicAdd(&path_cnt[pair], (unsigned long long)(int64_t)(kind >> 8));
}

}  // namespace

// Hv: the hosts of host_vertex (H on one device, H_pad on a mesh rank)
extern "C" int shadow_count_paths(int R, int H, int Hv, int OB, int V,
                                  const int64_t* ob_t, const int64_t* ob_k,
                                  const int64_t* ob_m,
                                  const int32_t* host_vertex,
                                  int64_t* path_cnt, const int64_t* ctl,
                                  const int32_t* pops,
                                  const int32_t* ob_word, int gated_rows,
                                  int every_row, void* stream) {
    if (R < 1 || R > 65535 || V <= 0 || (int64_t)V * V > 65536 ||
        gated_rows < 0 || Hv < H || (pops == nullptr) != (ob_word == nullptr))
        return (int)cudaErrorInvalidValue;
    const int64_t rows = (int64_t)H * OB;
    if (rows <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    auto* cnt = reinterpret_cast<unsigned long long*>(path_cnt);
    const int64_t blocks = (rows + THREADS - 1) / THREADS;
    if (every_row) {
        count_paths_kernel<<<dim3((unsigned)blocks, R), THREADS, 0, st>>>(
            rows, OB, Hv, V, ob_t, ob_k, ob_m, host_vertex, cnt, ctl);
    } else if (rows < gated_rows ||
               (pops == nullptr && (int64_t)V * V > SHARED_BINS)) {
        count_paths_rows_kernel<<<dim3((unsigned)blocks, R), THREADS, 0,
                                  st>>>(rows, OB, Hv, V, ob_t, ob_k, ob_m,
                                        host_vertex, cnt, ctl);
    } else {
        const int64_t per = (int64_t)(THREADS / 32) * WARP_HOSTS;
        const int64_t want = ((int64_t)H + per - 1) / per;
        const int nb = want < MAX_BLOCKS ? (int)want : MAX_BLOCKS;
        if (V * V <= SHARED_BINS)
            count_paths_popped_kernel<true><<<dim3(nb, R), THREADS, 0, st>>>(
                H, Hv, OB, V, ob_t, ob_k, ob_m, host_vertex, cnt, pops,
                ob_word, ctl);
        else
            count_paths_popped_kernel<false>
                <<<dim3(nb, R), THREADS, 0, st>>>(H, Hv, OB, V, ob_t, ob_k,
                                                  ob_m, host_vertex, cnt,
                                                  pops, ob_word, ctl);
    }
    return (int)cudaGetLastError();
}
