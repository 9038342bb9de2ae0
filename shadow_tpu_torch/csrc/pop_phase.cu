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
// reference's `gather_parts(lat, v, v)`). The kernel is a template over
// the view; each entry point launches the instantiation its TopoArgs
// selects.
//
// Bound on the H100: bytes. Per host it reads the popped heap rows and a
// few counters and writes its outbox row: t of every column, which marks
// the unused ones, and five fields per send or timer. It writes all five
// fields of every column, zeros where unused, so it moves more than the
// bound; PHOLD's threefry draws cost 73 integer ops a block, Tor's routes
// four blocks a relay packet and two a client REQ. Design for
// correctness first: one thread per host writes its row with a stride of
// OB*8 bytes between neighbouring threads, so stores are not coalesced;
// a warp-per-host or transposed outbox is later work.
#include "common.cuh"
#include "threefry.cuh"
#include "topo.cuh"

using namespace shadow;

namespace {

constexpr int32_t KIND_TIMER = 1;
constexpr uint32_t ALL_LANES = 0xFFFFFFFFu;
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

// The outbox of one host: the current iteration's lane block, the
// running event and packet seqs, and the dirty mark.
struct Lanes {
    int64_t *t, *k, *m, *s, *v;
    int64_t block;          // first column of this iteration
    int K, C;
    uint32_t h, es, ps;
    int64_t selflat, win_end;
    bool dirty;
    // the iteration's timer (T <= 1), written after every send
    bool timer_on;
    int64_t timer_t;
    int32_t timer_d0;

    // a send row: `count` packets (a train), the lanes set in `mask`
    // live (a forwarded train's survivors)
    __device__ void send(int lane, int64_t lt, uint32_t dst, int32_t size,
                         int32_t d0, int32_t d1, int32_t count,
                         uint32_t mask) {
        const int32_t cnt = clampi(count, 1, C);
        const int64_t col = block + lane;
        t[col] = lt;
        k[col] = pack2(h, es);
        m[col] = pack2(dst, (uint32_t)(KIND_PACKET | (cnt << 8)));
        s[col] = pack2((uint32_t)size, (uint32_t)d0);
        v[col] = pack2(mask, (uint32_t)d1);
        ++es;
        ps += (uint32_t)cnt;
        // an in-window self-send must land before the next pop
        if (dst == h && lt + selflat < win_end) dirty = true;
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
    int32_t* app;           // [H,1] received count
    int32_t* app_seq;       // [H] draws consumed
    uint32_t n;
    int msgload, size, selfloop;
    Key seed;

    struct Host {
        uint32_t received, as;
        Key key;
    };
    __device__ Host load(int h) const {
        return Host{(uint32_t)app[h], (uint32_t)app_seq[h],
                    purpose_id_key(seed, PURPOSE_APP, (uint32_t)h)};
    }
    __device__ void store(int h, const Host& st) const {
        app[h] = (int32_t)st.received;
        app_seq[h] = (int32_t)st.as;
    }
    __device__ bool burst(const Host&) const { return false; }
    __device__ void event(int, int h, const Event& e, Host& st,
                          Lanes& out) const {
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
    __device__ Host load(int h) const {
        Host st;
        for (int i = 0; i < 7; ++i) st.w[i] = app[(int64_t)h * 7 + i];
        return st;
    }
    __device__ void store(int h, const Host& st) const {
        for (int i = 0; i < 7; ++i) app[(int64_t)h * 7 + i] = st.w[i];
    }
    // servers are stateless responders
    __device__ bool burst(const Host& st) const { return st.w[0] == 0; }

    // the stateless answer to a REQ for chunk start d1: the chunk
    // [d1, d1+cnt) as one train of MSS packets, the last one short where
    // the chunk ends the file
    __device__ void serve(int lane, const Event& e, Lanes& out) const {
        if (!(e.kind == KIND_PACKET && e.d0 == TAG_REQ)) return;
        const int32_t cnt = clampi(wsub(npkts, e.d1), 0, chunk);
        if (cnt <= 0) return;
        const bool ends_file = wadd(e.d1, cnt) >= npkts;
        const int32_t bytes =
            ends_file ? (cnt - 1) * mss + last_sz : cnt * mss;
        out.send(lane, e.t, (uint32_t)e.src, bytes, TAG_DATA, e.d1, cnt,
                 ALL_LANES);
    }

    __device__ void event(int j, int h, const Event& e, Host& st,
                          Lanes& out) const {
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
    __device__ Host load(int h) const {
        Host st;
        for (int i = 0; i < 6; ++i) st.w[i] = app[(int64_t)h * 6 + i];
        return st;
    }
    __device__ void store(int h, const Host& st) const {
        for (int i = 0; i < 6; ++i) app[(int64_t)h * 6 + i] = st.w[i];
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
    __device__ void relay(int lane, int h, const Event& e,
                          Lanes& out) const {
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

    __device__ void event(int j, int h, const Event& e, Host& st,
                          Lanes& out) const {
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

struct PopArgs {
    int H, E, K, T, P, B, C;
    int64_t win_end;
    const int64_t *ht, *hk, *hm, *hv, *hw;
    int32_t *head, *event_seq, *packet_seq, *n_exec, *n_deliv;
    int64_t* chk;
    const int32_t* host_vertex;
    int64_t *ob_t, *ob_k, *ob_m, *ob_s, *ob_v;
    int32_t* pops;
};

template <class App, class Topo>
__global__ void pop_kernel(PopArgs a, App app, Topo topo) {
    const int h = blockIdx.x * blockDim.x + threadIdx.x;
    if (h >= a.H) return;
    const int M = a.K + a.T;
    const int OB = a.B * M;
    const int64_t row = (int64_t)h * OB;
    for (int c = 0; c < OB; ++c) {
        a.ob_t[row + c] = INF;
        a.ob_k[row + c] = 0;
        a.ob_m[row + c] = 0;
        a.ob_s[row + c] = 0;
        a.ob_v[row + c] = 0;
    }
    const int64_t hrow = (int64_t)h * a.E;
    const int vtx = a.host_vertex[h];
    Lanes out{a.ob_t, a.ob_k, a.ob_m, a.ob_s, a.ob_v, row, a.K, a.C,
              (uint32_t)h, (uint32_t)a.event_seq[h],
              (uint32_t)a.packet_seq[h], topo.self_lat(vtx),
              a.win_end, false, false, 0, 0};
    typename App::Host st = app.load(h);
    int hd = a.head[h];
    uint32_t ne = (uint32_t)a.n_exec[h];
    uint32_t nd = (uint32_t)a.n_deliv[h];
    uint64_t c = (uint64_t)a.chk[h];
    int blk = 0;
    for (; blk < a.B; ++blk) {
        const int64_t pt = hd < a.E ? a.ht[hrow + hd] : INF;
        if (!(pt < a.win_end) || out.dirty) break;
        // the run a burst host pops: consecutive in-window packets from
        // its head, up to P; one event otherwise
        int n = 1;
        if (a.P > 1 && app.burst(st)) {
            int run = 0;
            while (run < a.P) {
                const int i = hd + run;
                if (i >= a.E || !(a.ht[hrow + i] < a.win_end) ||
                    hi32(a.hm[hrow + i]) != KIND_PACKET)
                    break;
                ++run;
            }
            if (run > 0) n = run;
        }
        out.block = row + (int64_t)blk * M;
        for (int j = 0; j < n; ++j) {
            const int64_t slot = hrow + hd + j;
            const int64_t pk2 = a.hk[slot];
            const int64_t pm = a.hm[slot];
            const int64_t pv = a.hv[slot];
            Event e{j == 0 ? pt : a.ht[slot], hi32(pk2), hi32(pm), lo32(pm),
                    hi32(pv), lo32(pv), lo32(a.hw[slot])};
            const int32_t pseq = lo32(pk2);
            ++ne;
            if (e.kind == KIND_PACKET) nd += __popc((uint32_t)e.d2);
            const uint64_t mix =
                ((uint64_t)e.t ^ ((uint64_t)(int64_t)e.src * CHK_SRC) ^
                 ((uint64_t)(int64_t)e.kind * CHK_KIND) ^
                 ((uint64_t)(int64_t)pseq * CHK_SEQ)) & MASK63;
            c = (c * CHK_MUL + mix) & MASK63;
            app.event(j, h, e, st, out);
        }
        out.end_iteration();
        hd += n;
    }
    app.store(h, st);
    a.head[h] = hd;
    a.event_seq[h] = (int32_t)out.es;
    a.packet_seq[h] = (int32_t)out.ps;
    a.n_exec[h] = (int32_t)ne;
    a.n_deliv[h] = (int32_t)nd;
    a.chk[h] = (int64_t)c;
    a.pops[h] = blk;
}

template <class App, class Topo>
void launch_on(const PopArgs& a, const App& app, Topo topo,
               cudaStream_t stream) {
    const int threads = 128;
    pop_kernel<App, Topo><<<(a.H + threads - 1) / threads, threads, 0,
                            stream>>>(a, app, topo);
}

template <class App>
int launch(const PopArgs& a, const App& app, const TopoArgs* topo,
           void* stream) {
    if (!topo_ok(topo)) return (int)cudaErrorInvalidValue;
    if (a.H > 0) {
        if (topo->hier)
            launch_on(a, app, hier_topo(*topo), (cudaStream_t)stream);
        else
            launch_on(a, app, dense_topo(*topo), (cudaStream_t)stream);
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int shadow_pop_phase(
    int H, int E, int K, int B, long long win_end,
    const int64_t* ht, const int64_t* hk, const int64_t* hm,
    const int64_t* hv, const int64_t* hw,
    int32_t* head, int32_t* event_seq, int32_t* packet_seq,
    int32_t* app_seq, int32_t* app, int32_t* n_exec, int32_t* n_deliv,
    int64_t* chk, const int32_t* host_vertex, const TopoArgs* topo,
    unsigned seed1, unsigned seed2, int n_total, int msgload, int size,
    int selfloop, int64_t* ob_t, int64_t* ob_k, int64_t* ob_m,
    int64_t* ob_s, int64_t* ob_v, int32_t* pops, void* stream) {
    const PopArgs a{H, E, K, 0, 1, B, 1, (int64_t)win_end,
                    ht, hk, hm, hv, hw, head, event_seq, packet_seq,
                    n_exec, n_deliv, chk, host_vertex,
                    ob_t, ob_k, ob_m, ob_s, ob_v, pops};
    const PholdApp p{app, app_seq, (uint32_t)n_total, msgload, size,
                     selfloop, Key{seed1, seed2}};
    return launch(a, p, topo, stream);
}

extern "C" int shadow_pop_tgen(
    int H, int E, int K, int T, int P, int B, int C, long long win_end,
    const int64_t* ht, const int64_t* hk, const int64_t* hm,
    const int64_t* hv, const int64_t* hw,
    int32_t* head, int32_t* event_seq, int32_t* packet_seq, int32_t* app,
    int32_t* n_exec, int32_t* n_deliv, int64_t* chk,
    const int32_t* host_vertex, const TopoArgs* topo,
    const int32_t* count, const int64_t* pause, const int64_t* retry,
    int npkts, int last_sz, int chunk, int mss, int64_t* ob_t,
    int64_t* ob_k,
    int64_t* ob_m, int64_t* ob_s, int64_t* ob_v, int32_t* pops,
    void* stream) {
    if (T > 1 || C > 32) return (int)cudaErrorInvalidValue;
    const PopArgs a{H, E, K, T, P, B, C, (int64_t)win_end,
                    ht, hk, hm, hv, hw, head, event_seq, packet_seq,
                    n_exec, n_deliv, chk, host_vertex,
                    ob_t, ob_k, ob_m, ob_s, ob_v, pops};
    const TgenApp g{app, count, pause, retry, npkts, last_sz, chunk, mss};
    return launch(a, g, topo, stream);
}

extern "C" int shadow_pop_tor(
    int H, int E, int K, int T, int P, int B, int C, long long win_end,
    const int64_t* ht, const int64_t* hk, const int64_t* hm,
    const int64_t* hv, const int64_t* hw,
    int32_t* head, int32_t* event_seq, int32_t* packet_seq, int32_t* app,
    int32_t* n_exec, int32_t* n_deliv, int64_t* chk,
    const int32_t* host_vertex, const TopoArgs* topo,
    const int32_t* count, const int64_t* pause, const int64_t* retry,
    const int32_t* relay_gids, int R, unsigned route_k1,
    unsigned route_k2, int cells, int64_t* ob_t, int64_t* ob_k,
    int64_t* ob_m, int64_t* ob_s, int64_t* ob_v, int32_t* pops,
    void* stream) {
    if (T > 1 || C > 32 || R < 3) return (int)cudaErrorInvalidValue;
    const PopArgs a{H, E, K, T, P, B, C, (int64_t)win_end,
                    ht, hk, hm, hv, hw, head, event_seq, packet_seq,
                    n_exec, n_deliv, chk, host_vertex,
                    ob_t, ob_k, ob_m, ob_s, ob_v, pops};
    const TorApp t{app, count, pause, retry, relay_gids, (uint32_t)R,
                   Key{route_k1, route_k2}, cells};
    return launch(a, t, topo, stream);
}
