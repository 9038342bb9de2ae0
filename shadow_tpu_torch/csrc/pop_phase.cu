// K1 pop_phase, K4 pop_tgen and K6 pop_tor: one phase of pops for every
// host.
//
// Replaces shadow_tpu/device/engine.py `_step` (with `_take_head(s)`, the
// burst branch, the send-mask lane, and the judge hoisted to the flush)
// fused with an app of shadow_tpu/device/apps.py:
//   K1: `PholdDevice.handle` and the app draws
//       chain_key(seed, PURPOSE_APP, gid, app_seq + i);
//   K4: `TgenDevice.handle`, `_server_response`, `burst_mask` and
//       `handle_burst` (no draws: tgen draws nothing);
//   K6: `TorDevice.handle`, `_relay_lane`, `_route`, `burst_mask` and
//       `handle_burst` (routes are keyed draws, not the app's).
// One templated kernel carries all three; the app is a device struct with
// a per-host state and an `event` hook. tgen and Tor clients share one
// window rule (`client_step`).
//
// The reference runs the pop loop in lockstep over all hosts, one launch
// per iteration; here one thread owns one host and loops over its
// iterations, one launch per phase. A host touches only its own heap row
// and outbox row, and a host that stops (head time >= win_end, `dirty`
// from an in-window self-send or timer, or B iterations) stays stopped
// for the phase, so its iterations are a prefix of the lockstep loop's:
// iteration blk writes outbox columns [blk*M_out, (blk+1)*M_out), send
// lanes 0..K-1 then the timer lanes, exactly as the lockstep loop does.
//
// Burst (P > 1): a burst host (tgen: a server; Tor: a relay) whose head
// event is an in-window packet pops the run of consecutive in-window
// KIND_PACKET slots from its head, up to P (slots at or past E read as
// INF); event j of the run answers on lane j at its own popped time.
// Every other runnable host pops one event. The checksum folds each
// popped event in order (the 63-bit truncation between folds makes a
// closed form wrong); `pops[h]` counts iterations, not events.
//
// Event seqs number the iteration's valid sends in lane order, then its
// timers; a send row carries KIND_PACKET | count << 8 and its live-lane
// mask as the hi word of v (all ones for PHOLD and tgen; a Tor train
// forwards the previous hop's survivors, and the packet seq still
// advances by the whole count); a timer row is (t + delay,
// gid << 32 | seq, gid, KIND_TIMER, d0).
//
// The in-window self-send test (`dirty`) reads the host's self latency
// through a view of the path tables (topo.cuh): DenseTopo's diagonal or,
// under the hierarchical representation, HierTopo's self vector (the
// reference's `gather_parts(lat, v, v)`): with one epoch read once per
// host, under a fault schedule per self-send in the epoch of its
// departure (engine.py:1185-1187), since a window may straddle an epoch
// start. The kernel is a template over the view; each entry point
// launches the instantiation its TopoArgs selects.
//
// The model NIC (experimental.model_bandwidth; shadow_tpu/device/
// engine.py `_step` under MB, engine.py:815-822, 846-848, 879-889,
// 1008-1020, 1048-1104, 1118-1160) is a template flag, so the non-NIC
// instantiations are unchanged. Under it P = 1, the iteration's columns
// are K sends, T timers and one READY column, and the pop judges its own
// sends (the reference does not hoist the judge there): a send departs
// from the TX bucket, tx = max(pt, tx_free), the sends of one pop
// serialized in lane order with dropped ones included; latency,
// reliability and the drop rolls are keyed on the pop time pt (the epoch
// too, engine.py:954-958); delivery is depart + latency with the
// causality bump; n_sent and n_drop count here; a dead send is written
// only under the path counters (cp), as DROP_T. A popped KIND_PACKET is
// the RX stage: the app sees nothing, the download bucket and CoDel
// (every select in engine.py:1052-1104's order; the control law read
// from the host-built LAW table) drop it or write a KIND_PACKET_READY row
// at rx_deliver with the popped key, which the app sees as a KIND_PACKET
// when it pops; deliveries count on READY pops; the checksum folds both
// stages. Serialization is size * 8e9 / bw in int64 integer division
// (sizes clamp to 1 GiB, so the product stays below 2^63). The dirty
// mark then reads the written rows' own times: a delivered self-send, a
// timer or a READY row below win_end.
//
// The state audit's clock lane (experimental.state_audit; engine.py:
// 800-813) is a template flag too, and its leaves (the health word `aud`
// and the last popped time `aud_t`) are arguments of the audited
// instantiations alone. Each iteration ORs AUD_CLOCK into the word where
// its first popped time lies below aud_t, then sets aud_t to the largest
// time it popped: under bursts the reference checks only the run's
// first event (`pt = ptP[:, 0]`) and takes the maximum over the active
// columns, and so does this. The 24 audited instantiations build in
// their own translation unit (pop_phase_aud.cu includes this file with
// SHADOW_POP_AUDIT set, so its entry points carry the suffix `_aud`),
// in parallel with the 24 unaudited ones.
//
// A launch reads the window end from the window loop's control block
// (common.cuh `Ctl`; a captured CUDA graph cannot take it by value) and
// returns at once where its RUN word is 0.
//
// The replica axis of an ensemble campaign (shadow_tpu/device/engine.py
// `_run_ens_shard`, a vmap of the whole window loop over [R, ...] state
// and worlds) is blockIdx.y: replica r's thread for host h reads and
// writes state row g = r * H + h (heaps, counters, app words, NIC and
// audit leaves, outbox), reads control block r and takes the seed key
// and the path tables of replica r (topo.cuh `at_replica`), once, before
// the pop loop; the app's columns, the bandwidths, the law table and
// Tor's route key are shared, and h stays the host's id. The pointers
// stay kernel parameters (offsetting them cost the standalone pops up
// to 13%, PERF.md). The body is the standalone pop: a replica's result
// does not depend on R or on the other replicas.
//
// The outbox is an engine buffer that outlives a phase, and a row
// changes only where its host pops: a host that popped nothing in this
// phase and nothing in the previous one holds (INF, 0, 0, 0, 0) in every
// column, since the pop cleared its row the last time it popped and the
// buffer's other writers touch only the live rows of a host that popped
// (K2 judges its send rows, K11 writes INF into rows it drops, K7 reads).
// So a host clears its row only where it popped in the previous phase
// (`pops` read before it is overwritten), or where the rows came from
// outside the pop: the engine's per-replica outbox word (`ob_word`, [2,
// R] int32: the word, then a count of the blocks that read it), set by
// `DeviceEngine._arm` at every entry from outside and by a flush of rows
// copied into the buffer (device/runner.py `flush_phases`), says so; a
// launch given no word clears every row. The last block of a replica to
// read a set word clears it. A host that pops now but not before writes
// its send and timer columns over a row that is already clear. The
// clear is a warp's: the lanes write the contiguous slab of the warp's
// 32 rows, five fields, 32 consecutive words a store, skipping the rows
// that need none. A host whose head lies at or past the window end then
// reads nothing more (no app state, no key) and writes only a nonzero
// pop count back to 0.
//
// Bound on the H100: bytes. Per host it reads its head time and pop
// count; per popping host the popped heap rows and its counters, and it
// writes the outbox cells that change: a cleared row's live cells, the
// popped iterations' send and timer rows. PHOLD's threefry draws cost 73
// integer ops a block, Tor's routes four blocks a relay packet and two a
// client REQ; the model NIC adds seven int64 leaves read and written per
// popping host and two threefry blocks a packet for the in-step drop
// rolls. The clear writes every word of a row it clears (the bound counts
// only the cells that were not clear); a popping host's own loop stays
// sequential (the per-host pop order is the semantics), so its send rows
// are stored by one thread, OB*8 bytes from its neighbours' rows.
#include <type_traits>

#include "common.cuh"
#include "threefry.cuh"
#include "topo.cuh"

namespace shadow {

// The model NIC's arguments: its [R,H] int64 leaves, the hosts'
// bandwidths, the CoDel law table, the [R,H] counters the in-step judge
// adds to and the path-counter flag (the drop key's seed is the
// replica's). mb = 0: no NIC, every pointer null. Outside the unnamed
// namespace: the C entry points take it, and a type of internal linkage
// in their signatures would give them internal linkage too.
struct NicArgs {
    int mb, cp;
    long long boot_end;
    int64_t *tx_free, *rx_free, *cd_fa, *cd_next, *cd_cnt, *cd_last,
        *cd_drop;
    const int64_t *bw_up, *bw_down, *law;
    int32_t *n_sent, *n_drop;
};

inline bool nic_ok(const NicArgs* n) {
    if (n == nullptr) return false;
    if (!n->mb) return true;
    return n->tx_free && n->rx_free && n->cd_fa && n->cd_next &&
           n->cd_cnt && n->cd_last && n->cd_drop && n->bw_up &&
           n->bw_down && n->law && n->n_sent && n->n_drop;
}

}  // namespace shadow

#ifndef SHADOW_POP_AUDIT
#define SHADOW_POP_AUDIT 0
#endif
#if SHADOW_POP_AUDIT
#define POP_ENTRY(name) name##_aud
#else
#define POP_ENTRY(name) name
#endif

using namespace shadow;

namespace {

constexpr bool AUDIT = SHADOW_POP_AUDIT != 0;
constexpr int32_t AUD_CLOCK = 2;
constexpr int32_t KIND_TIMER = 1;
constexpr int32_t KIND_PACKET_READY = 8;
constexpr uint32_t ALL_LANES = 0xFFFFFFFFu;
// the model NIC (shadow_tpu_torch/host/model_nic.py)
constexpr int64_t CODEL_TARGET_NS = 10 * 1000000ll;
constexpr int64_t CODEL_INTERVAL_NS = 100 * 1000000ll;
constexpr int LAW_SIZE = 1024;
constexpr int64_t MAX_SER_BYTES = int64_t(1) << 30;
constexpr int64_t NS_X8 = 8ll * 1000000000ll;
// tgen (shadow_tpu_torch/core/tgen_args.py)
constexpr int32_t TAG_REQ = 1;
constexpr int32_t TAG_DATA = 2;
// Tor (shadow_tpu_torch/core/tor_args.py)
constexpr int32_t TAG_TOR_REQ = 3;
constexpr int32_t TAG_TOR_DATA = 4;
constexpr int32_t CELL_BYTES = 512;
constexpr int32_t CHUNK_CELLS = 16;
constexpr int SEQ_BITS = 12;
constexpr int32_t SEQ_MASK = (1 << SEQ_BITS) - 1;

// int32 arithmetic that wraps as the reference's does (signed overflow
// is undefined in C++)
__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
}
__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a - (uint32_t)b);
}
__device__ __forceinline__ int32_t clampi(int32_t x, int32_t lo,
                                          int32_t hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

struct Event {
    int64_t t;
    int32_t src, kind, size, d0, d1, d2;
};

// One host's model NIC, held in registers for the launch.
struct Nic {
    int64_t tx_free, rx_free, cd_fa, cd_next, cd_cnt, cd_last, cd_drop;
    int64_t bw_up, bw_down;
    int32_t sent, lost;
};

__device__ __forceinline__ int64_t serialize_ns(int32_t size, int64_t bw) {
    const int64_t sz = size < 1 ? 1
                       : ((int64_t)size > MAX_SER_BYTES ? MAX_SER_BYTES
                                                        : (int64_t)size);
    return sz * NS_X8 / bw;
}

// The model NIC's part of a host's outbox: its NIC and the in-step
// judge's keys.
struct NicLanes {
    const int32_t* host_vertex;
    int H;
    bool cp;
    int64_t boot_end;
    Key drop_key;
    const int64_t* law;
    Nic nic;
    int64_t pt;             // the pop's time
    int64_t tx;             // the TX bucket's cursor within the pop
};
struct Absent {};

// The outbox of one host: the current iteration's lane block, the
// running event and packet seqs, and the dirty mark; the tables where
// the epoch axis or the model NIC reads them (one epoch without the NIC
// needs only the host's self latency, read once); under the model NIC
// also its part. An instantiation carries only the members it reads:
// with all of them the one-epoch pop ran 16% slower at 1,000,000 hosts
// (PERF.md).
template <class Topo, bool MB>
struct Lanes {
    int64_t *t, *k, *m, *s, *v;
    int64_t block;          // first column of this iteration
    int K, T, C;
    uint32_t h, es, ps;
    int64_t win_end;
    bool dirty;
    // the iteration's timer (T <= 1), written after every send
    bool timer_on;
    int64_t timer_t;
    int32_t timer_d0;
    int vtx;
    int64_t selflat;        // one epoch: the host's self latency
    std::conditional_t<Topo::EPOCHS || MB, Topo, Absent> topo;
    std::conditional_t<MB, NicLanes, Absent> x;

    // a send row: `count` packets (a train), the lanes set in `mask`
    // live (a forwarded train's survivors)
    __device__ void send(int lane, int64_t lt, uint32_t dst, int32_t size,
                         int32_t d0, int32_t d1, int32_t count,
                         uint32_t mask) {
        const int32_t cnt = clampi(count, 1, C);
        const int64_t col = block + lane;
        if constexpr (MB) {
            judged_send(col, dst, size, d0, d1, cnt, mask);
        } else {
            t[col] = lt;
            k[col] = pack2(h, es);
            m[col] = pack2(dst, (uint32_t)(KIND_PACKET | (cnt << 8)));
            s[col] = pack2((uint32_t)size, (uint32_t)d0);
            v[col] = pack2(mask, (uint32_t)d1);
            // an in-window self-send must land before the next pop,
            // judged on the self latency at its departure
            if (dst == h) {
                int64_t sl = selflat;
                if constexpr (Topo::EPOCHS)
                    sl = topo.self_lat(topo.epoch(lt), vtx);
                if (lt + sl < win_end) dirty = true;
            }
        }
        ++es;
        ps += (uint32_t)cnt;
    }

    // the model NIC's send: TX departure, then the judgment at the pop
    // time, the row's packet seqs from ps
    __device__ void judged_send(int64_t col, uint32_t dst, int32_t size,
                                int32_t d0, int32_t d1, int32_t cnt,
                                uint32_t mask) {
        const int64_t depart = x.tx;
        x.tx += serialize_ns(size, x.nic.bw_up);
        const int e = topo.epoch(x.pt);
        const int dh = (int)dst < 0 ? 0
                       : ((int)dst > x.H - 1 ? x.H - 1 : (int)dst);
        const int vd = x.host_vertex[dh];
        const int64_t latv = topo.lat(e, vtx, vd);
        const float relv = topo.rel(e, vtx, vd);
        const uint32_t wbits = cnt >= 32 ? 0xFFFFFFFFu : (1u << cnt) - 1u;
        const uint32_t live = mask & wbits;
        const bool lossy = relv < 1.0f && x.pt >= x.boot_end;
        uint32_t surv = 0;
        for (int j = 0; j < C; ++j) {
            if (!((live >> j) & 1u)) continue;
            bool drop = false;
            if (lossy)
                drop = uniform01(fold_in(x.drop_key, ps + (uint32_t)j)) >=
                       relv;
            if (!drop) surv |= 1u << j;
        }
        const int livecnt = __popc(live);
        x.nic.sent += livecnt;
        x.nic.lost += livecnt - __popc(surv);
        int64_t deliver = depart + latv;
        if (dst != h && deliver < win_end) deliver = win_end;
        if (surv != 0 || x.cp) {
            t[col] = surv != 0 ? deliver : DROP_T;
            k[col] = pack2(h, es);
            m[col] = pack2(dst, (uint32_t)(KIND_PACKET | (livecnt << 8)));
            s[col] = pack2((uint32_t)size, (uint32_t)d0);
            v[col] = pack2(surv, (uint32_t)d1);
        }
        if (surv != 0 && dst == h && deliver < win_end) dirty = true;
    }

    // the model NIC's RX stage of a popped KIND_PACKET: the download
    // bucket and CoDel; a kept packet becomes the READY row
    __device__ void receive(const Event& e, int64_t pk2) {
        const int64_t dq = x.pt > x.nic.rx_free ? x.pt : x.nic.rx_free;
        const bool below = dq - x.pt < CODEL_TARGET_NS;
        const bool fa0 = x.nic.cd_fa == 0;
        const bool above = !below && !fa0 && dq >= x.nic.cd_fa;
        const bool in_drop = x.nic.cd_drop != 0;
        const bool drop_now = above && in_drop && dq >= x.nic.cd_next;
        const bool drop_first = above && !in_drop;
        const int64_t delta = x.nic.cd_cnt - x.nic.cd_last;
        const int64_t first_cnt =
            (dq - x.nic.cd_next < CODEL_INTERVAL_NS && delta > 1) ? delta
                                                                  : 1;
        const int64_t new_cnt = drop_now ? x.nic.cd_cnt + 1
                                : (drop_first ? first_cnt : x.nic.cd_cnt);
        const int64_t li = new_cnt < 0 ? 0
                           : (new_cnt > LAW_SIZE - 1 ? LAW_SIZE - 1
                                                     : new_cnt);
        const int64_t lw = __ldg(&x.law[li]);
        const int64_t new_next = drop_now ? x.nic.cd_next + lw
                                 : (drop_first ? dq + lw : x.nic.cd_next);
        const int64_t new_last = drop_first ? first_cnt : x.nic.cd_last;
        const int64_t new_fa =
            below ? 0 : (fa0 ? dq + CODEL_INTERVAL_NS : x.nic.cd_fa);
        const int64_t new_drop =
            below ? 0
                  : (fa0 ? x.nic.cd_drop
                         : (above ? (in_drop ? x.nic.cd_drop : 1) : 0));
        x.nic.cd_cnt = new_cnt;
        x.nic.cd_next = new_next;
        x.nic.cd_last = new_last;
        x.nic.cd_fa = new_fa;
        x.nic.cd_drop = new_drop;
        if (drop_now || drop_first) {
            x.nic.lost += 1;
            return;
        }
        const int64_t deliver = dq + serialize_ns(e.size, x.nic.bw_down);
        x.nic.rx_free = deliver;
        const int64_t col = block + K + T;
        t[col] = deliver;
        k[col] = pk2;
        m[col] = pack2(h, (uint32_t)KIND_PACKET_READY);
        s[col] = pack2((uint32_t)e.size, (uint32_t)e.d0);
        v[col] = pack2((uint32_t)e.d2, (uint32_t)e.d1);
        if (deliver < win_end) dirty = true;
    }

    __device__ void timer(int64_t tt, int32_t d0) {
        timer_on = true;
        timer_t = tt;
        timer_d0 = d0;
    }
    __device__ void end_iteration() {
        if (!timer_on) return;
        const int64_t col = block + K;
        t[col] = timer_t;
        k[col] = pack2(h, es);
        m[col] = pack2(h, (uint32_t)KIND_TIMER);
        s[col] = pack2(0, (uint32_t)timer_d0);
        v[col] = 0;
        ++es;
        if (timer_t < win_end) dirty = true;
        timer_on = false;
    }
};

// PHOLD: boot sends msgload messages, a packet one; each send draws one
// u32 for its peer, (self + 1 + bits % (n-1)) % n.
struct PholdApp {
    int32_t* app;           // [R,H,1] received count
    int32_t* app_seq;       // [R,H] draws consumed
    uint32_t n;
    int msgload, size, selfloop;

    struct Host {
        uint32_t received, as;
        Key key;
    };
    // host h's state at row g, its draws keyed by the replica's seed
    __device__ Host load(int64_t g, int h, Key seed) const {
        return Host{(uint32_t)app[g], (uint32_t)app_seq[g],
                    purpose_id_key(seed, PURPOSE_APP, (uint32_t)h)};
    }
    __device__ void store(int64_t g, const Host& st) const {
        app[g] = (int32_t)st.received;
        app_seq[g] = (int32_t)st.as;
    }
    __device__ bool burst(const Host&) const { return false; }
    template <class Out>
    __device__ void event(int, int h, const Event& e, Host& st,
                          Out& out) const {
        const int nsend = e.kind == KIND_BOOT ? msgload
                          : e.kind == KIND_PACKET ? 1 : 0;
        if (e.kind == KIND_PACKET) ++st.received;
        for (int k = 0; k < nsend; ++k) {
            const uint32_t bits = random_bits32(fold_in(st.key, st.as + k));
            uint32_t dst;
            if (selfloop || n == 1)
                dst = bits % n;
            else
                dst = ((uint32_t)h + 1u + bits % (n - 1)) % n;
            out.send(k, e.t, dst, size, 0, 0, 1, ALL_LANES);
        }
        st.as += nsend;
    }
};

// The pull client's window rule, shared by tgen and Tor: a file of
// `total` units fetched in chunks of `chunk`, one REQ per chunk, on the
// state words below. A DATA train (d0 == data_tag, `start` its first
// unit, d2 its survivors) is aligned to the current window; shifts clip
// to 0..31, and a train 32 or more away gives nothing; only fresh
// in-window bits advance it. Boot, a pause timer (d0 < 0), a current
// retry timer (d0 == gen) or a completed chunk sends the next REQ; a
// timer follows: the pause after a download, else the retry.
struct ClientWords {
    int32_t cs, got, done, gen;
    uint32_t mask;
};
struct ClientStep {
    bool send_req, timer;
    int32_t req_start, timer_d0;
    int64_t delay;
};

__device__ ClientStep client_step(const Event& e, int32_t data_tag,
                                  int32_t start, int32_t count_h,
                                  int64_t pause_h, int64_t retry_h,
                                  int32_t total, int32_t chunk,
                                  ClientWords& w) {
    const bool is_data = e.kind == KIND_PACKET && e.d0 == data_tag;
    const bool is_boot = e.kind == KIND_BOOT && count_h > 0;
    const bool is_timer = e.kind == KIND_TIMER;
    const bool timer_pause = is_timer && e.d0 < 0;
    const bool timer_retry = is_timer && e.d0 >= 0 && e.d0 == w.gen;

    const int32_t cs = w.cs;
    const int32_t rest = wsub(total, cs);
    const int32_t chunk_len = rest < chunk ? rest : chunk;
    const int32_t shift = wsub(start, cs);
    const uint32_t surv = (uint32_t)e.d2;
    uint32_t aligned =
        shift >= 0 ? surv << clampi(shift, 0, 31)
                   : surv >> clampi(wsub(0, shift), 0, 31);
    if (shift >= 32 || shift <= -32) aligned = 0;
    const uint32_t wmask =
        chunk_len >= 32 ? 0xFFFFFFFFu
                        : (1u << clampi(chunk_len, 0, 31)) - 1u;
    const uint32_t fresh_bits = aligned & wmask & ~w.mask;
    const bool fresh = is_data && fresh_bits != 0;
    const uint32_t new_mask = fresh ? w.mask | fresh_bits : w.mask;
    const int32_t new_got = fresh ? wadd(w.got, __popc(fresh_bits)) : w.got;
    const bool complete = fresh && new_got >= chunk_len;
    const int32_t next_start = wadd(cs, chunk_len);
    const bool dl_done = complete && next_start >= total;
    const bool cont = complete && !dl_done;

    ClientStep c;
    c.send_req = is_boot || timer_pause || timer_retry || cont;
    c.req_start = cont ? next_start : (timer_retry ? cs : 0);
    const bool reset = c.send_req || dl_done;
    w.cs = cont ? next_start
                : ((is_boot || timer_pause || dl_done) ? 0 : cs);
    w.got = reset ? 0 : new_got;
    w.done = wadd(w.done, dl_done ? 1 : 0);
    w.gen = wadd(w.gen, reset ? 1 : 0);
    w.mask = reset ? 0u : new_mask;
    // the timer: pause and retry exclude each other
    const bool pause_valid = dl_done && w.done < count_h;
    const bool retry_valid = c.send_req && retry_h > 0;
    c.timer = pause_valid || retry_valid;
    c.delay = pause_valid ? pause_h : retry_h;
    c.timer_d0 = pause_valid ? -1 : w.gen;
    return c;
}

// tgen: state words [role, server_gid, chunk_start, got, downloads_done,
// req_gen, seq_mask]; per-host client args count/pause/retry.
struct TgenApp {
    int32_t* app;           // [H,7]
    const int32_t* __restrict__ count;
    const int64_t* __restrict__ pause;
    const int64_t* __restrict__ retry;
    int32_t npkts, last_sz, chunk, mss;

    struct Host {
        int32_t w[7];
    };
    __device__ Host load(int64_t g, int, Key) const {
        Host st;
        for (int i = 0; i < 7; ++i) st.w[i] = app[g * 7 + i];
        return st;
    }
    __device__ void store(int64_t g, const Host& st) const {
        for (int i = 0; i < 7; ++i) app[g * 7 + i] = st.w[i];
    }
    // servers are stateless responders
    __device__ bool burst(const Host& st) const { return st.w[0] == 0; }

    // the stateless answer to a REQ for chunk start d1: the chunk
    // [d1, d1+cnt) as one train of MSS packets, the last one short where
    // the chunk ends the file
    template <class Out>
    __device__ void serve(int lane, const Event& e, Out& out) const {
        if (!(e.kind == KIND_PACKET && e.d0 == TAG_REQ)) return;
        const int32_t cnt = clampi(wsub(npkts, e.d1), 0, chunk);
        if (cnt <= 0) return;
        const bool ends_file = wadd(e.d1, cnt) >= npkts;
        const int32_t bytes =
            ends_file ? (cnt - 1) * mss + last_sz : cnt * mss;
        out.send(lane, e.t, (uint32_t)e.src, bytes, TAG_DATA, e.d1, cnt,
                 ALL_LANES);
    }

    template <class Out>
    __device__ void event(int j, int h, const Event& e, Host& st,
                          Out& out) const {
        const int32_t role = st.w[0];
        if (role == 0) {          // server: every column answers a REQ
            serve(j, e, out);
            return;
        }
        if (role != 1 || j != 0) return;
        // d1 = the train's first packet
        ClientWords w{st.w[2], st.w[3], st.w[4], st.w[5],
                      (uint32_t)st.w[6]};
        const ClientStep c = client_step(e, TAG_DATA, e.d1, count[h],
                                         pause[h], retry[h], npkts, chunk,
                                         w);
        st.w[2] = w.cs;
        st.w[3] = w.got;
        st.w[4] = w.done;
        st.w[5] = w.gen;
        st.w[6] = (int32_t)w.mask;
        if (c.send_req)
            out.send(0, e.t, (uint32_t)st.w[1], 64, TAG_REQ, c.req_start, 1,
                     ALL_LANES);
        if (c.timer) out.timer(e.t + c.delay, c.timer_d0);
    }
};

// Tor: state words [role, chunk_start, got, done, gen, mask] (relays use
// only the role); per-host client args count/pause/retry; the relays'
// host ids in id order. A circuit is a pure function of the client id:
// hop j's draw is random_bits32(fold(fold(route_key, circ), j)), with
// route_key = fold(seed, PURPOSE_TOR_ROUTE) computed once on the host,
// and pick_route makes the three relays distinct. d1 packs
// (circ << SEQ_BITS) | chunk start and is echoed on every hop.
struct TorApp {
    int32_t* app;           // [H,6]
    const int32_t* __restrict__ count;
    const int64_t* __restrict__ pause;
    const int64_t* __restrict__ retry;
    const int32_t* __restrict__ relay_gids;
    uint32_t R;
    Key route_key;
    int32_t cells;

    struct Host {
        int32_t w[6];
    };
    // the route key is shared: a Tor campaign does not sweep seeds
    __device__ Host load(int64_t g, int, Key) const {
        Host st;
        for (int i = 0; i < 6; ++i) st.w[i] = app[g * 6 + i];
        return st;
    }
    __device__ void store(int64_t g, const Host& st) const {
        for (int i = 0; i < 6; ++i) app[g * 6 + i] = st.w[i];
    }
    // relays are stateless responders
    __device__ bool burst(const Host& st) const { return st.w[0] == 0; }

    // a client's REQ needs only its guard (hop 0): two threefry blocks
    __device__ int32_t guard(int32_t circ) const {
        const Key ck = fold_in(route_key, (uint32_t)circ);
        return relay_gids[random_bits32(fold_in(ck, 0u)) % R];
    }
    // a relay needs all three hops to find its place: four blocks
    __device__ void route(int32_t circ, int32_t& G, int32_t& M,
                          int32_t& X) const {
        const Key ck = fold_in(route_key, (uint32_t)circ);
        const uint32_t g = random_bits32(fold_in(ck, 0u)) % R;
        uint32_t m = random_bits32(fold_in(ck, 1u)) % (R - 1);
        if (m >= g) ++m;
        const uint32_t lo = g < m ? g : m, hi = g < m ? m : g;
        uint32_t x = random_bits32(fold_in(ck, 2u)) % (R - 2);
        if (x >= lo) ++x;
        if (x >= hi) ++x;
        G = relay_gids[g];
        M = relay_gids[m];
        X = relay_gids[x];
    }

    // the stateless relay answer to one popped event, on lane `lane`:
    // a REQ goes guard -> middle -> exit; the exit answers with one DATA
    // train of CHUNK_CELLS lanes, the low cnt live (a tail chunk's mask
    // is partial); the middle and the guard forward a train's survivors
    // as its live mask (middle -> guard -> client), and a train with no
    // survivor is not sent
    template <class Out>
    __device__ void relay(int lane, int h, const Event& e,
                          Out& out) const {
        if (e.kind != KIND_PACKET) return;
        const bool req = e.d0 == TAG_TOR_REQ;
        if (!req && !(e.d0 == TAG_TOR_DATA && e.d2 != 0)) return;
        const int32_t circ = e.d1 >> SEQ_BITS;   // arithmetic
        int32_t G, M, X;
        route(circ, G, M, X);
        if (req) {
            if (h == G) {
                out.send(lane, e.t, (uint32_t)M, 64, e.d0, e.d1, 1, 1u);
            } else if (h == M) {
                out.send(lane, e.t, (uint32_t)X, 64, e.d0, e.d1, 1, 1u);
            } else if (h == X) {
                const int32_t cnt =
                    clampi(cells - (e.d1 & SEQ_MASK), 0, CHUNK_CELLS);
                if (cnt > 0)
                    out.send(lane, e.t, (uint32_t)M, CELL_BYTES * cnt,
                             TAG_TOR_DATA, e.d1, CHUNK_CELLS,
                             (1u << cnt) - 1u);
            }
            return;
        }
        const int32_t bytes = CELL_BYTES * __popc((uint32_t)e.d2);
        if (h == M)
            out.send(lane, e.t, (uint32_t)G, bytes, e.d0, e.d1,
                     CHUNK_CELLS, (uint32_t)e.d2);
        else if (h == G)
            out.send(lane, e.t, (uint32_t)circ, bytes, e.d0, e.d1,
                     CHUNK_CELLS, (uint32_t)e.d2);
    }

    template <class Out>
    __device__ void event(int j, int h, const Event& e, Host& st,
                          Out& out) const {
        const int32_t role = st.w[0];
        if (role == 0) {          // relay: every column is a relay lane
            relay(j, h, e, out);
            return;
        }
        if (role != 1 || j != 0) return;
        ClientWords w{st.w[1], st.w[2], st.w[3], st.w[4],
                      (uint32_t)st.w[5]};
        const ClientStep c = client_step(e, TAG_TOR_DATA, e.d1 & SEQ_MASK,
                                         count[h], pause[h], retry[h],
                                         cells, CHUNK_CELLS, w);
        st.w[1] = w.cs;
        st.w[2] = w.got;
        st.w[3] = w.done;
        st.w[4] = w.gen;
        st.w[5] = (int32_t)w.mask;
        if (c.send_req)
            out.send(0, e.t, (uint32_t)guard(h), 64, TAG_TOR_REQ,
                     (int32_t)(((uint32_t)h << SEQ_BITS) |
                               (uint32_t)c.req_start),
                     1, 1u);
        if (c.timer) out.timer(e.t + c.delay, c.timer_d0);
    }
};

// H hosts from global id g0 on (a mesh rank's; 0 and every host on one
// device), of the Hg hosts whose vertices and per-host columns (client
// args, bandwidths) the world holds, each indexed by global id
struct PopArgs {
    int g0, Hg;
    int H, E, K, T, P, B, C;
    const int64_t* ctl;     // the loop's control blocks [R, CTL_N]
    const int64_t* seed_key;    // [R, 2]
    const int64_t *ht, *hk, *hm, *hv, *hw;
    int32_t *head, *event_seq, *packet_seq, *n_exec, *n_deliv;
    int64_t* chk;
    const int32_t* host_vertex;
    int64_t *ob_t, *ob_k, *ob_m, *ob_s, *ob_v;
    int32_t* pops;          // [R,H]: last phase's iterations, then this one's
    int32_t* ob_word;       // [2,R] the outbox word, or null: clear all
};

// The audit's leaves, in the audited instantiations alone.
struct AudLeaves {
    int32_t* aud;
    int64_t* aud_t;
};
template <bool AUD>
using AudArg = std::conditional_t<AUD, AudLeaves, Absent>;
template <bool AUD>
AudArg<AUD> aud_arg(int32_t* aud, int64_t* aud_t) {
    if constexpr (AUD)
        return AudLeaves{aud, aud_t};
    else
        return Absent{};
}

// Blocks of POP_THREADS an SM must hold: the register cap each
// instantiation compiles to. The replica's seed, tables and row index
// raised the pops' registers (tgen's 64 -> 80) and cost them resident
// warps and time at R = 1 (PERF.md); the cap restores the standalone
// occupancy: 10 blocks (48 registers) for PHOLD, 8 (64) for tgen and
// Tor; the model NIC's and the epoch views' instantiations, which need
// more, keep their own.
constexpr int POP_THREADS = 128;
template <class App, class Topo, bool MB>
constexpr int pop_min_blocks() {
    if (MB || Topo::EPOCHS) return 4;
    return std::is_same_v<App, PholdApp> ? 10 : 8;
}

// Whether replica r's rows came from outside the pop (a null word: the
// caller does not say, so they may have). Thread 0 of each block reads
// the word; where it is set, the block counts itself in, and the last
// block of the replica clears the word and the count: every block has
// read the word before the count reaches the grid's width.
__device__ bool outbox_from_outside(int32_t* word, int64_t r) {
    __shared__ int outside;
    if (threadIdx.x == 0) {
        const int w = word == nullptr ? 1 : word[r];
        if (word != nullptr && w != 0) {
            __threadfence();
            unsigned* seen = (unsigned*)&word[gridDim.y + r];
            if (atomicAdd(seen, 1u) == gridDim.x - 1) {
                word[r] = 0;
                *seen = 0;
            }
        }
        outside = w != 0;
    }
    __syncthreads();
    return outside != 0;
}

// Clear (INF, 0, 0, 0, 0) the rows of this warp's 32 hosts whose lane
// says `need`: the lanes walk the warp's contiguous slab of 32 * OB words
// of each field, 32 consecutive words a store, and store only into the
// rows that need it. Every lane of the warp calls it.
__device__ void clear_rows(const PopArgs& a, int64_t r, int OB,
                           bool need) {
    const unsigned rows = __ballot_sync(0xFFFFFFFFu, need);
    if (rows == 0 || OB == 0) return;
    const int lane = threadIdx.x & 31;
    const int64_t h0 = (int64_t)blockIdx.x * blockDim.x +
                       (threadIdx.x & ~31);
    const int64_t base = (r * a.H + h0) * OB;
    int hl = lane / OB, c = lane - hl * OB;   // word i's row and column
    for (int i = lane; i < 32 * OB; i += 32) {
        if ((rows >> hl) & 1u) {
            a.ob_t[base + i] = INF;
            a.ob_k[base + i] = 0;
            a.ob_m[base + i] = 0;
            a.ob_s[base + i] = 0;
            a.ob_v[base + i] = 0;
        }
        for (c += 32; c >= OB; c -= OB) ++hl;
    }
    __syncwarp();
}

template <class App, class Topo, bool MB, bool AUD>
__global__ void __launch_bounds__(POP_THREADS,
                                  pop_min_blocks<App, Topo, MB>())
pop_kernel(PopArgs a, App app, Topo topo0, TopoStrides rs, NicArgs na,
           AudArg<AUD> au) {
    const int h = blockIdx.x * blockDim.x + threadIdx.x;
    const int64_t r = blockIdx.y;
    const int64_t* ctl = a.ctl + r * CTL_N;
    if (ctl[CTL_RUN] == 0) return;
    const int M = a.K + a.T + (MB ? 1 : 0);
    const int OB = a.B * M;
    // replica r: host h's state row; its pop count, head and head time
    // load before the block reads the outbox word and the warp clears
    const int64_t g = r * a.H + h;
    const int64_t hrow = g * a.E;
    const int64_t win_end = ctl[CTL_WIN_END];
    int32_t popped = 0;
    int hd = 0;
    int64_t head_t = INF;
    if (h < a.H) {
        popped = a.pops[g];
        hd = a.head[g];
    }
    const bool outside = outbox_from_outside(a.ob_word, r);
    if (h < a.H && hd < a.E) head_t = a.ht[hrow + hd];
    clear_rows(a, r, OB, h < a.H && (outside || popped != 0));
    if (h >= a.H) return;
    if (!(head_t < win_end)) {
        // nothing in the window: the state stays as it is
        if (popped != 0) a.pops[g] = 0;
        return;
    }
    // the host's global id: its keys, draws, vertex and columns
    const int gh = a.g0 + h;
    // replica r's seed and tables
    const Key seed = replica_seed(a.seed_key, r);
    const Topo topo = topo0.at_replica(r, rs);
    const int64_t row = g * OB;
    Lanes<Topo, MB> out{};
    out.t = a.ob_t;
    out.k = a.ob_k;
    out.m = a.ob_m;
    out.s = a.ob_s;
    out.v = a.ob_v;
    out.block = row;
    out.K = a.K;
    out.T = a.T;
    out.C = a.C;
    out.h = (uint32_t)gh;
    out.es = (uint32_t)a.event_seq[g];
    out.ps = (uint32_t)a.packet_seq[g];
    out.win_end = win_end;
    out.vtx = a.host_vertex[gh];
    if constexpr (Topo::EPOCHS || MB) out.topo = topo;
    if constexpr (!Topo::EPOCHS) out.selflat = topo.self_lat(0, out.vtx);
    if constexpr (MB) {
        out.x.host_vertex = a.host_vertex;
        out.x.H = a.Hg;
        out.x.cp = na.cp != 0;
        out.x.boot_end = (int64_t)na.boot_end;
        out.x.drop_key = purpose_id_key(seed, PURPOSE_PACKET_DROP,
                                        (uint32_t)gh);
        out.x.law = na.law;
        out.x.nic = Nic{na.tx_free[g], na.rx_free[g], na.cd_fa[g],
                        na.cd_next[g], na.cd_cnt[g], na.cd_last[g],
                        na.cd_drop[g], na.bw_up[gh], na.bw_down[gh], 0,
                        0};
    }
    typename App::Host st = app.load(g, gh, seed);
    uint32_t ne = (uint32_t)a.n_exec[g];
    uint32_t nd = (uint32_t)a.n_deliv[g];
    uint64_t c = (uint64_t)a.chk[g];
    int32_t aud = 0;
    int64_t aud_t = 0;
    if constexpr (AUD) {
        aud = au.aud[g];
        aud_t = au.aud_t[g];
    }
    // deliveries count on the pops the app sees as packets
    const int32_t deliv_kind = MB ? KIND_PACKET_READY : KIND_PACKET;
    int blk = 0;
    for (; blk < a.B; ++blk) {
        const int64_t pt = hd < a.E ? a.ht[hrow + hd] : INF;
        if (!(pt < win_end) || out.dirty) break;
        // the run a burst host pops: consecutive in-window packets from
        // its head, up to P; one event otherwise (always under MB)
        int n = 1;
        if (!MB && a.P > 1 && app.burst(st)) {
            int run = 0;
            while (run < a.P) {
                const int i = hd + run;
                if (i >= a.E || !(a.ht[hrow + i] < win_end) ||
                    hi32(a.hm[hrow + i]) != KIND_PACKET)
                    break;
                ++run;
            }
            if (run > 0) n = run;
        }
        out.block = row + (int64_t)blk * M;
        if constexpr (AUD) {
            // the clock lane: the run's first time against the last
            // popped one
            if (pt < aud_t) aud |= AUD_CLOCK;
        }
        for (int j = 0; j < n; ++j) {
            const int64_t slot = hrow + hd + j;
            const int64_t pk2 = a.hk[slot];
            const int64_t pm = a.hm[slot];
            const int64_t pv = a.hv[slot];
            Event e{j == 0 ? pt : a.ht[slot], hi32(pk2), hi32(pm), lo32(pm),
                    hi32(pv), lo32(pv), lo32(a.hw[slot])};
            const int32_t pseq = lo32(pk2);
            if constexpr (AUD) {
                if (e.t > aud_t) aud_t = e.t;
            }
            ++ne;
            if (e.kind == deliv_kind) nd += __popc((uint32_t)e.d2);
            const uint64_t mix =
                ((uint64_t)e.t ^ ((uint64_t)(int64_t)e.src * CHK_SRC) ^
                 ((uint64_t)(int64_t)e.kind * CHK_KIND) ^
                 ((uint64_t)(int64_t)pseq * CHK_SEQ)) & MASK63;
            c = (c * CHK_MUL + mix) & MASK63;
            if constexpr (MB) {
                // the TX bucket starts at max(pt, tx_free) on every pop
                out.x.pt = e.t;
                out.x.tx = e.t > out.x.nic.tx_free ? e.t
                                                   : out.x.nic.tx_free;
                if (e.kind == KIND_PACKET) {
                    out.receive(e, pk2);
                } else {
                    if (e.kind == KIND_PACKET_READY) e.kind = KIND_PACKET;
                    app.event(j, gh, e, st, out);
                }
                out.x.nic.tx_free = out.x.tx;
            } else {
                app.event(j, gh, e, st, out);
            }
        }
        out.end_iteration();
        hd += n;
    }
    app.store(g, st);
    a.head[g] = hd;
    a.event_seq[g] = (int32_t)out.es;
    a.packet_seq[g] = (int32_t)out.ps;
    a.n_exec[g] = (int32_t)ne;
    a.n_deliv[g] = (int32_t)nd;
    a.chk[g] = (int64_t)c;
    a.pops[g] = blk;
    if constexpr (AUD) {
        au.aud[g] = aud;
        au.aud_t[g] = aud_t;
    }
    if constexpr (MB) {
        const Nic& n = out.x.nic;
        na.tx_free[g] = n.tx_free;
        na.rx_free[g] = n.rx_free;
        na.cd_fa[g] = n.cd_fa;
        na.cd_next[g] = n.cd_next;
        na.cd_cnt[g] = n.cd_cnt;
        na.cd_last[g] = n.cd_last;
        na.cd_drop[g] = n.cd_drop;
        na.n_sent[g] += n.sent;
        na.n_drop[g] += n.lost;
    }
}

// Launch the instantiation the tables and the NIC flag select (audited
// in this unit where SHADOW_POP_AUDIT is set, which needs both leaves),
// one grid row of blocks per replica.
template <class App>
int launch(int R, const PopArgs& a, const App& app, const TopoArgs* topo,
           const NicArgs* nic, int32_t* aud, int64_t* aud_t,
           void* stream) {
    if (R < 1 || R > 65535 || !topo_ok(topo) || !nic_ok(nic) ||
        a.g0 < 0 || a.g0 + a.H > a.Hg ||
        (nic->mb && a.P != 1) || a.ctl == nullptr || a.seed_key == nullptr ||
        (AUDIT != (aud != nullptr && aud_t != nullptr)))
        return (int)cudaErrorInvalidValue;
    const AudArg<AUDIT> au = aud_arg<AUDIT>(aud, aud_t);
    const TopoStrides rs = topo_strides(*topo);
    if (a.H > 0) {
        const int threads = POP_THREADS;
        const dim3 grid((a.H + threads - 1) / threads, R);
        with_topo(*topo, [&](auto view) {
            using Topo = decltype(view);
            if (nic->mb)
                pop_kernel<App, Topo, true, AUDIT>
                    <<<grid, threads, 0, (cudaStream_t)stream>>>(
                        a, app, view, rs, *nic, au);
            else
                pop_kernel<App, Topo, false, AUDIT>
                    <<<grid, threads, 0, (cudaStream_t)stream>>>(
                        a, app, view, rs, *nic, au);
        });
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int POP_ENTRY(shadow_pop_phase)(
    int R, int g0, int Hg, int H, int E, int K, int B,
    const int64_t* ht, const int64_t* hk, const int64_t* hm,
    const int64_t* hv, const int64_t* hw,
    int32_t* head, int32_t* event_seq, int32_t* packet_seq,
    int32_t* app_seq, int32_t* app, int32_t* n_exec, int32_t* n_deliv,
    int64_t* chk, const int32_t* host_vertex, const TopoArgs* topo,
    const NicArgs* nic, const int64_t* seed_key, int n_total,
    int msgload, int size,
    int selfloop, int64_t* ob_t, int64_t* ob_k, int64_t* ob_m,
    int64_t* ob_s, int64_t* ob_v, int32_t* pops, int32_t* ob_word,
    int32_t* aud, int64_t* aud_t, const int64_t* ctl, void* stream) {
    const PopArgs a{g0, Hg, H, E, K, 0, 1, B, 1, ctl, seed_key,
                    ht, hk, hm, hv, hw, head, event_seq, packet_seq,
                    n_exec, n_deliv, chk, host_vertex,
                    ob_t, ob_k, ob_m, ob_s, ob_v, pops, ob_word};
    const PholdApp p{app, app_seq, (uint32_t)n_total, msgload, size,
                     selfloop};
    return launch(R, a, p, topo, nic, aud, aud_t, stream);
}

extern "C" int POP_ENTRY(shadow_pop_tgen)(
    int R, int g0, int Hg, int H, int E, int K, int T, int P, int B, int C,
    const int64_t* ht, const int64_t* hk, const int64_t* hm,
    const int64_t* hv, const int64_t* hw,
    int32_t* head, int32_t* event_seq, int32_t* packet_seq, int32_t* app,
    int32_t* n_exec, int32_t* n_deliv, int64_t* chk,
    const int32_t* host_vertex, const TopoArgs* topo, const NicArgs* nic,
    const int64_t* seed_key,
    const int32_t* count, const int64_t* pause, const int64_t* retry,
    int npkts, int last_sz, int chunk, int mss, int64_t* ob_t,
    int64_t* ob_k,
    int64_t* ob_m, int64_t* ob_s, int64_t* ob_v, int32_t* pops,
    int32_t* ob_word, int32_t* aud, int64_t* aud_t, const int64_t* ctl,
    void* stream) {
    if (T > 1 || C > 32) return (int)cudaErrorInvalidValue;
    const PopArgs a{g0, Hg, H, E, K, T, P, B, C, ctl, seed_key,
                    ht, hk, hm, hv, hw, head, event_seq, packet_seq,
                    n_exec, n_deliv, chk, host_vertex,
                    ob_t, ob_k, ob_m, ob_s, ob_v, pops, ob_word};
    const TgenApp g{app, count, pause, retry, npkts, last_sz, chunk, mss};
    return launch(R, a, g, topo, nic, aud, aud_t, stream);
}

extern "C" int POP_ENTRY(shadow_pop_tor)(
    int R, int g0, int Hg, int H, int E, int K, int T, int P, int B, int C,
    const int64_t* ht, const int64_t* hk, const int64_t* hm,
    const int64_t* hv, const int64_t* hw,
    int32_t* head, int32_t* event_seq, int32_t* packet_seq, int32_t* app,
    int32_t* n_exec, int32_t* n_deliv, int64_t* chk,
    const int32_t* host_vertex, const TopoArgs* topo, const NicArgs* nic,
    const int64_t* seed_key,
    const int32_t* count, const int64_t* pause, const int64_t* retry,
    const int32_t* relay_gids, int n_relays, unsigned route_k1,
    unsigned route_k2, int cells, int64_t* ob_t, int64_t* ob_k,
    int64_t* ob_m, int64_t* ob_s, int64_t* ob_v, int32_t* pops,
    int32_t* ob_word, int32_t* aud, int64_t* aud_t, const int64_t* ctl,
    void* stream) {
    if (T > 1 || C > 32 || n_relays < 3) return (int)cudaErrorInvalidValue;
    const PopArgs a{g0, Hg, H, E, K, T, P, B, C, ctl, seed_key,
                    ht, hk, hm, hv, hw, head, event_seq, packet_seq,
                    n_exec, n_deliv, chk, host_vertex,
                    ob_t, ob_k, ob_m, ob_s, ob_v, pops, ob_word};
    const TorApp t{app, count, pause, retry, relay_gids,
                   (uint32_t)n_relays, Key{route_k1, route_k2}, cells};
    return launch(R, a, t, topo, nic, aud, aud_t, stream);
}
