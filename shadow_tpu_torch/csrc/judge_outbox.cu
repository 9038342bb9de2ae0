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
// so that K7 still counts it (engine.py:1490). One thread owns one host
// row and walks its OB lanes in order, so the per-row packet seq base is
// a running sum and n_sent / n_drop need no atomics. The roll compares
// u >= rel in float32, as the reference does. The model NIC judges in
// the pop instead (pop_phase.cu); this kernel does not run there.
//
// The launch reads the window end from the window loop's control block
// and returns at once where its RUN word is 0 (common.cuh `Ctl`). The
// replica axis of an ensemble campaign is blockIdx.y: replica r's
// thread for host h takes row g = r * H + h of the outbox and the
// counters, control block r, and the replica's seed key and tables
// (topo.cuh `at_replica`); the pointers stay kernel parameters.
//
// Bound on the H100: bytes (t of all H*OB rows; m and v read, and t/m/v
// written, for send rows only); each rolled packet costs two threefry
// blocks (~250 integer ops), far below the card's integer rate. Rows
// are read with a stride of OB*8 bytes between neighbouring threads, so
// loads are not coalesced; that is later work.
#include <type_traits>

#include "common.cuh"
#include "threefry.cuh"
#include "topo.cuh"

using namespace shadow;

namespace {

// Blocks of 128 an SM must hold: the replica's seed and tables raised
// the judge's registers (38 -> 46 on dense tables) and cost it resident
// warps at R = 1 (PERF.md); the cap keeps the standalone occupancy: 12
// blocks (42 registers) on dense tables, 10 (48) on factored ones.
template <class Topo>
constexpr int judge_min_blocks() {
    return std::is_same_v<Topo, DenseTopo<Topo::EPOCHS>> ? 12 : 10;
}

template <class Topo>
__global__ void __launch_bounds__(128, judge_min_blocks<Topo>())
judge_outbox_kernel(
    int H, int OB, int C, int64_t boot_end,
    int64_t* ob_t, int64_t* ob_m, int64_t* ob_v,
    const int32_t* __restrict__ packet_seq, int32_t* n_sent,
    int32_t* n_drop, const int32_t* __restrict__ host_vertex, Topo topo0,
    TopoStrides rs, const int64_t* __restrict__ seed_key, int cp, int g0,
    int Hg, const int64_t* ctl) {
    const int h = blockIdx.x * blockDim.x + threadIdx.x;
    const int64_t r = blockIdx.y;
    if (h >= H || ctl[r * CTL_N + CTL_RUN] == 0) return;
    const int64_t win_end = ctl[r * CTL_N + CTL_WIN_END];
    // replica r: host h's row, its seed and tables
    const int64_t g = r * H + h;
    const Topo topo = topo0.at_replica(r, rs);
    const Key seed = replica_seed(seed_key, r);
    const int64_t row = g * OB;
    // packet_seq is the end of the phase: the first row's base is it
    // minus every packet the row block consumed
    uint32_t tot = 0;
    for (int c = 0; c < OB; ++c) {
        const int32_t kindrow = lo32(ob_m[row + c]);
        if (ob_t[row + c] < INF && (kindrow & 0xFF) == KIND_PACKET)
            tot += (uint32_t)(kindrow >> 8);
    }
    uint32_t base = (uint32_t)packet_seq[g] - tot;
    // the host's global id (a mesh rank's hosts start at g0): its
    // vertex, its drop key and the self test; destinations are global
    const int gh = g0 + h;
    const int vs = host_vertex[gh];
    const Key hkey = purpose_id_key(seed, PURPOSE_PACKET_DROP,
                                    (uint32_t)gh);
    int32_t sent = 0, lost = 0;
    for (int c = 0; c < OB; ++c) {
        const int64_t ft = ob_t[row + c];
        const int64_t fm = ob_m[row + c];
        const int32_t kindrow = lo32(fm);
        if (!(ft < INF && (kindrow & 0xFF) == KIND_PACKET)) continue;
        const int32_t cnt = kindrow >> 8;
        const int32_t dst = hi32(fm);
        const int dh = dst < 0 ? 0 : (dst > Hg - 1 ? Hg - 1 : dst);
        const int vd = host_vertex[dh];
        const int e = topo.epoch(ft);
        const int64_t latv = topo.lat(e, vs, vd);
        const float relv = topo.rel(e, vs, vd);
        const int64_t fv = ob_v[row + c];
        const uint32_t wbits =
            cnt >= 32 ? 0xFFFFFFFFu
                      : (1u << (cnt < 0 ? 0 : cnt)) - 1u;
        const uint32_t livemask = (uint32_t)hi32(fv) & wbits;
        const int livecnt = __popc(livemask);
        uint32_t surv = 0;
        const bool lossy = relv < 1.0f && ft >= boot_end;
        for (int j = 0; j < C; ++j) {
            if (!((livemask >> j) & 1u)) continue;
            bool drop = false;
            if (lossy)
                drop = uniform01(fold_in(hkey, base + (uint32_t)j)) >= relv;
            if (!drop) surv |= 1u << j;
        }
        base += (uint32_t)cnt;
        sent += livecnt;
        lost += livecnt - __popc(surv);
        int64_t deliver_t = ft + latv;
        if (dst != gh && deliver_t < win_end) deliver_t = win_end;
        ob_t[row + c] = surv != 0 ? deliver_t : (cp ? DROP_T : INF);
        ob_m[row + c] =
            pack2((uint32_t)dst, (uint32_t)(KIND_PACKET | (livecnt << 8)));
        ob_v[row + c] = pack2(surv, (uint32_t)lo32(fv));
    }
    n_sent[g] += sent;
    n_drop[g] += lost;
}

}  // namespace

extern "C" int shadow_judge_outbox(
    int R, int H, int OB, int C, long long boot_end,
    int64_t* ob_t, int64_t* ob_m, int64_t* ob_v, const int32_t* packet_seq,
    int32_t* n_sent, int32_t* n_drop, const int32_t* host_vertex,
    const TopoArgs* topo, const int64_t* seed_key, int cp, int g0, int Hg,
    const int64_t* ctl, void* stream) {
    if (R < 1 || R > 65535 || !topo_ok(topo) || ctl == nullptr ||
        seed_key == nullptr || g0 < 0 || g0 + H > Hg)
        return (int)cudaErrorInvalidValue;
    if (H > 0) {
        const int threads = 128;
        const dim3 grid((H + threads - 1) / threads, R);
        const TopoStrides rs = topo_strides(*topo);
        with_topo(*topo, [&](auto view) {
            judge_outbox_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
                H, OB, C, (int64_t)boot_end, ob_t, ob_m,
                ob_v, packet_seq, n_sent, n_drop, host_vertex, view, rs,
                seed_key, cp, g0, Hg, ctl);
        });
    }
    return (int)cudaGetLastError();
}
