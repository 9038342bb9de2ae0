// K2 judge_outbox: the network judgment of one phase's outbox.
//
// Replaces shadow_tpu/device/engine.py `_judge_outbox` with its `_tbl`
// lookup (the dense gather, or under the hierarchical representation
// shadow_tpu/topology/hierarchy.py `gather_parts`, both through the
// views of topo.cuh, of which the kernel is a template; under a fault
// schedule in the epoch of the row's departure time ft,
// engine.py:1428-1430) and shadow_tpu/device/netsem.py
// `packet_drop_mask`: per send row, the path latency and reliability,
// one threefry drop roll per packet keyed by (src host, per-source
// packet seq), the causality bump max(t, win_end) for cross-host rows,
// the survivor bitmask, and the sent/dropped counters. A row whose
// packets all drop gets t = INF, or DROP_T under the path counters (cp),
// so that K7 still counts it (engine.py:1490). The roll compares
// u >= rel in float32, as the reference does. The model NIC judges in
// the pop instead (pop_phase.cu); this kernel does not run there.
//
// A warp judges a host's row: lane i takes columns i, i+32, ... side by
// side (the row is contiguous), so the loads of t, m and v and the
// stores of a send row are coalesced. A row's first packet seq is
// packet_seq (the end of the phase) minus the packets of every column
// from it to the row's end: the warp walks the row's 32-column chunks
// from the last, and a warp suffix sum of the send rows' counts gives
// each lane its base. A lane rolls its own row's packets where no row
// of the chunk has more than the chunk's rolls spread over 32 lanes
// would take rounds (always, in the instantiation for single packets,
// C = 1: PHOLD's); otherwise the chunk's
// rolled packets are numbered by a warp prefix sum of the rows' counts,
// lane i rolls packets i, i+32, ... (its row by a binary search over the
// rows' offsets, its train lane by a select on the row's mask, both in
// the warp's shared words) and sets the survivors' bits there, so a
// train of 32 packets costs one round, not 32 rolls in one lane. Warp
// sums give n_sent and n_drop. Rows are judged in no particular order: a
// roll is keyed by (src, base + j) alone.
//
// Only the hosts that sent are judged. Given the pop counts and the
// engine's outbox word (pop_phase.cu), a host that popped nothing in
// this phase holds an all-INF row (the pop cleared or kept it clear),
// which adds 0 to both counters: it is skipped, unless the word says the
// rows came from outside the pop (a flush of rows copied in, whose pop
// counts are 0), where every host is judged; so is every host of a
// launch given no pop counts. Above LIST_MIN_HOSTS hosts a scan kernel
// lists the hosts that popped (a warp's by one atomic, as K3's scan
// does), and the judge spreads the listed hosts over every warp of its
// grid, host i of the list to warp i mod the grid's warps (busy hosts
// sit in runs of consecutive ids: Tor's relays), the grid as many blocks
// as the card holds at once; the last block out empties the list. At
// and below it, or with `listed` 0 (kept to measure the two against each
// other), the grid has a warp a host, which exits at once where its host
// popped nothing.
//
// The launch reads the window end from the window loop's control block
// and returns at once where its RUN word is 0 (common.cuh `Ctl`). The
// replica axis of an ensemble campaign is blockIdx.y: replica r's warps
// take rows g = r * H + h of the outbox, the counters and the pop
// counts, control block r, outbox word r and list r, and the replica's
// seed key and tables (topo.cuh `at_replica`); the pointers stay kernel
// parameters.
//
// Bound on the H100: bytes (the pop counts of every host; t of the rows
// of the hosts that sent, m and v read, and t/m/v written, for send rows
// only); each rolled packet costs two threefry blocks (~250 integer
// ops), far below the card's integer rate.
#include "common.cuh"
#include "threefry.cuh"
#include "topo.cuh"

using namespace shadow;

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;

// Blocks of 128 an SM must hold: 10 (48 registers). At 12 (40) the
// warp-a-row judge spilled and ran 27-47% slower on the factored tables'
// synthetic rows (PERF.md).
constexpr int JUDGE_MIN_BLOCKS = 10;

constexpr int WARPS = 4;
// hosts above which K2 lists the hosts that popped; at and below it a
// grid of a warp a host costs less than the scan's launch (tgen_10000's
// 10,000 hosts and tor_small's 250 against tor_large's 56,000, PERF.md)
constexpr int LIST_MIN_HOSTS = 32768;

struct JudgeArgs {
    int H, OB, C, cp, g0, Hg;
    int64_t boot_end;
    int64_t *ob_t, *ob_m, *ob_v;
    const int32_t* packet_seq;
    int32_t *n_sent, *n_drop;
    const int32_t* host_vertex;
    const int64_t* seed_key;
    const int64_t* ctl;
    const int32_t* pops;        // [R,H], or null: judge every host
    const int32_t* ob_word;     // [2,R] (with pops)
    int32_t* work;              // [R, 2 + H]: list length, blocks done,
                                // the list
    int listed;
};

// whether replica r judges every host
__device__ __forceinline__ bool every_host(const JudgeArgs& a, int64_t r) {
    return a.pops == nullptr || a.ob_word[r] != 0;
}

// The position of the k-th set bit (from 0) of a mask with more than k.
__device__ __forceinline__ int nth_bit(uint32_t mask, int k) {
    int pos = 0;
    for (int w = 16; w > 0; w >>= 1) {
        const int c = __popc((mask >> pos) & ((1u << w) - 1u));
        if (k >= c) {
            k -= c;
            pos += w;
        }
    }
    return pos;
}

// A warp's shared words: each lane's row (rolled live lanes, first
// packet seq, reliability, offset among the chunk's rolled packets) and
// the survivors its packets' rolls set.
struct Spread {
    uint32_t roll[32], base[32], kept[32];
    float rel[32];
    int off[32];
};

// One host's row, judged by the whole warp; TRAINS: send rows of more
// than one packet (C > 1), whose rolls a chunk may spread.
template <class Topo, bool TRAINS>
__device__ void judge_row(const JudgeArgs& a, const Topo& topo, Key seed,
                          int64_t win_end, int64_t g, int h, int lane,
                          Spread& sp) {
    const int64_t row = g * a.OB;
    // the host's global id (a mesh rank's hosts start at g0): its
    // vertex, its drop key and the self test; destinations are global
    const int gh = a.g0 + h;
    const int vs = __ldg(&a.host_vertex[gh]);
    const Key hkey = purpose_id_key(seed, PURPOSE_PACKET_DROP,
                                    (uint32_t)gh);
    const uint32_t ps_end = (uint32_t)__ldg(&a.packet_seq[g]);
    const uint32_t rolled = a.C >= 32 ? 0xFFFFFFFFu : (1u << a.C) - 1u;
    uint32_t later = 0;         // packets of the columns past the chunk
    int32_t sent = 0, lost = 0;
    for (int c0 = ((a.OB - 1) >> 5) << 5; c0 >= 0; c0 -= 32) {
        const int64_t col = row + c0 + lane;
        int64_t ft = INF, fm = 0, fv = 0;
        if (c0 + lane < a.OB) {
            ft = a.ob_t[col];
            fm = a.ob_m[col];
        }
        const int32_t kindrow = lo32(fm);
        const bool send = ft < INF && (kindrow & 0xFF) == KIND_PACKET;
        const int32_t cnt = kindrow >> 8;
        // the packets from this column to the row's end
        uint32_t suffix = send ? (uint32_t)cnt : 0u;
        for (int o = 1; o < 32; o <<= 1) {
            const uint32_t x = __shfl_down_sync(FULL, suffix, o);
            if (lane + o < 32) suffix += x;
        }
        const uint32_t base = ps_end - later - suffix;
        later += __shfl_sync(FULL, suffix, 0);
        // the row's path, live lanes and the packets it rolls
        const int32_t dst = hi32(fm);
        int64_t latv = 0;
        float relv = 1.0f;
        uint32_t livemask = 0;
        bool lossy = false;
        if (send) {
            const int dh = dst < 0 ? 0 : (dst > a.Hg - 1 ? a.Hg - 1 : dst);
            const int vd = __ldg(&a.host_vertex[dh]);
            const int e = topo.epoch(ft);
            latv = topo.lat(e, vs, vd);
            relv = topo.rel(e, vs, vd);
            fv = a.ob_v[col];
            const uint32_t wbits =
                cnt >= 32 ? 0xFFFFFFFFu : (1u << (cnt < 0 ? 0 : cnt)) - 1u;
            livemask = (uint32_t)hi32(fv) & wbits;
            lossy = relv < 1.0f && ft >= a.boot_end;
        }
        const uint32_t roll = lossy ? livemask & rolled : 0u;
        uint32_t kept = livemask & rolled & ~roll;
        const int n = __popc(roll);
        const int most = TRAINS ? __reduce_max_sync(FULL, (unsigned)n) : 1;
        const int total = TRAINS ? __reduce_add_sync(FULL, (unsigned)n) : 0;
        if (!TRAINS || most <= (total + 31) >> 5) {
            // no row rolls more packets than a spread would take rounds
            for (uint32_t left = roll; left != 0; left &= left - 1) {
                const int j = __ffs(left) - 1;
                if (!(uniform01(fold_in(hkey, base + (uint32_t)j)) >= relv))
                    kept |= 1u << j;
            }
        } else {
            // the chunk's rolled packets, numbered by a warp prefix sum
            int off = n;
            for (int o = 1; o < 32; o <<= 1) {
                const int x = __shfl_up_sync(FULL, off, o);
                if (lane >= o) off += x;
            }
            sp.roll[lane] = roll;
            sp.base[lane] = base;
            sp.rel[lane] = relv;
            sp.off[lane] = off - n;
            sp.kept[lane] = 0;
            __syncwarp();
            for (int pk = lane; pk < total; pk += 32) {
                // the lane whose row holds packet pk: the last with
                // off <= pk
                int owner = 0;
                for (int step = 16; step > 0; step >>= 1)
                    if (sp.off[owner + step] <= pk) owner += step;
                const int j = nth_bit(sp.roll[owner], pk - sp.off[owner]);
                if (!(uniform01(fold_in(hkey, sp.base[owner] + (uint32_t)j))
                      >= sp.rel[owner]))
                    atomicOr(&sp.kept[owner], 1u << j);
            }
            __syncwarp();
            kept |= sp.kept[lane];
            __syncwarp();
        }
        if (!send) continue;
        const int livecnt = __popc(livemask);
        sent += livecnt;
        lost += livecnt - __popc(kept);
        int64_t deliver_t = ft + latv;
        if (dst != gh && deliver_t < win_end) deliver_t = win_end;
        a.ob_t[col] = kept != 0 ? deliver_t : (a.cp ? DROP_T : INF);
        a.ob_m[col] =
            pack2((uint32_t)dst, (uint32_t)(KIND_PACKET | (livecnt << 8)));
        a.ob_v[col] = pack2(kept, (uint32_t)lo32(fv));
    }
    for (int o = 16; o > 0; o >>= 1) {
        sent += __shfl_xor_sync(FULL, sent, o);
        lost += __shfl_xor_sync(FULL, lost, o);
    }
    if (lane == 0) {
        a.n_sent[g] += sent;
        a.n_drop[g] += lost;
    }
}

// (1) the hosts to judge: those that popped, listed in any order (each
// host's judgment is its own), a warp's by one atomic; nothing to list
// where every host is judged
__global__ void __launch_bounds__(256)
judge_scan_kernel(JudgeArgs a) {
    const int64_t r = blockIdx.y;
    if (a.ctl[r * CTL_N + CTL_RUN] == 0 || every_host(a, r)) return;
    const int64_t h = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const bool todo = h < a.H && a.pops[r * a.H + h] != 0;
    const unsigned bal = __ballot_sync(FULL, todo);
    if (!bal) return;
    int32_t* work = a.work + r * (2 + (int64_t)a.H);
    const int lane = threadIdx.x & 31;
    int base = 0;
    if (lane == 0) base = atomicAdd(work, __popc(bal));
    base = __shfl_sync(FULL, base, 0);
    if (todo) work[2 + base + __popc(bal & ((1u << lane) - 1))] = (int)h;
}

// (2) a warp a host: the listed hosts (every host where every host is
// judged) spread over every warp of the grid, or with `listed` 0 the
// warp's own host where it popped
template <class Topo, bool TRAINS>
__global__ void __launch_bounds__(WARPS * 32, JUDGE_MIN_BLOCKS)
judge_outbox_kernel(JudgeArgs a, Topo topo0, TopoStrides rs) {
    const int64_t r = blockIdx.y;
    if (a.ctl[r * CTL_N + CTL_RUN] == 0) return;
    __shared__ Spread spread[WARPS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const bool every = every_host(a, r);
    int32_t* work = a.work + r * (2 + (int64_t)a.H);
    const bool scanned = a.listed && !every;
    const int64_t n = scanned ? *(volatile int32_t*)work : a.H;
    const int64_t win_end = a.ctl[r * CTL_N + CTL_WIN_END];
    const Topo topo = topo0.at_replica(r, rs);
    const Key seed = replica_seed(a.seed_key, r);
    for (int64_t i = (int64_t)blockIdx.x * WARPS + warp; i < n;
         i += (int64_t)gridDim.x * WARPS) {
        const int64_t h = scanned ? work[2 + i] : i;
        if (!a.listed && !every && a.pops[r * a.H + h] == 0) continue;
        judge_row<Topo, TRAINS>(a, topo, seed, win_end, r * a.H + h,
                                (int)h, lane, spread[warp]);
    }
    if (!scanned) return;
    // the last block out empties the list
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence();
        if (atomicAdd(work + 1, 1) == (int)gridDim.x - 1) {
            work[0] = 0;
            work[1] = 0;
        }
    }
}

}  // namespace

// pops and ob_word: both null (judge every host) or both given; work:
// [R, 2 + H] int32, zero when allocated (the list's length and the
// blocks done, zero between launches, then the list).
extern "C" int shadow_judge_outbox(
    int R, int H, int OB, int C, long long boot_end,
    int64_t* ob_t, int64_t* ob_m, int64_t* ob_v, const int32_t* packet_seq,
    int32_t* n_sent, int32_t* n_drop, const int32_t* host_vertex,
    const TopoArgs* topo, const int64_t* seed_key, int cp, int g0, int Hg,
    const int32_t* pops, const int32_t* ob_word, int32_t* work, int listed,
    const int64_t* ctl, void* stream) {
    if (R < 1 || R > 65535 || !topo_ok(topo) || ctl == nullptr ||
        seed_key == nullptr || g0 < 0 || g0 + H > Hg || work == nullptr ||
        (pops == nullptr) != (ob_word == nullptr))
        return (int)cudaErrorInvalidValue;
    if (H > 0) {
        cudaStream_t st = (cudaStream_t)stream;
        const JudgeArgs a{H, OB, C, cp, g0, Hg, (int64_t)boot_end,
                          ob_t, ob_m, ob_v, packet_seq, n_sent, n_drop,
                          host_vertex, seed_key, ctl, pops, ob_word, work,
                          listed && H > LIST_MIN_HOSTS};
        if (a.listed)
            judge_scan_kernel<<<dim3((unsigned)((H + 255) / 256), R), 256,
                                0, st>>>(a);
        const TopoStrides rs = topo_strides(*topo);
        with_topo(*topo, [&](auto view) {
            using Topo = decltype(view);
            auto kernel = C > 1 ? judge_outbox_kernel<Topo, true>
                                : judge_outbox_kernel<Topo, false>;
            // a warp a host: every host's warp, or the blocks the card
            // holds at once (shared by the replicas), whose warps the
            // listed hosts are spread over, whatever their count
            int64_t grid = ((int64_t)H + WARPS - 1) / WARPS;
            if (a.listed) {
                int dev = 0, sms = 0, per_sm = 0;
                cudaGetDevice(&dev);
                cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev);
                cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, kernel, WARPS * 32, 0);
                const int64_t held = (int64_t)sms * per_sm / R;
                grid = grid < held ? grid : (held > 0 ? held : 1);
            }
            kernel<<<dim3((unsigned)grid, R), WARPS * 32, 0, st>>>(a, view,
                                                                  rs);
        });
    }
    return (int)cudaGetLastError();
}
