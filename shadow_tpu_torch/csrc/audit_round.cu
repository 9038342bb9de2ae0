// K8 audit_round: the state audit's round-end health word.
//
// Replaces shadow_tpu/device/engine.py `_audit_round` (engine.py:
// 2066-2108): on one device `_axis_sum64` is a plain sum, on a mesh rank
// it is the mesh's (below, "On a mesh"). Per host:
// AUD_HEAP where the heap rows are out of (t, key) order or head lies
// outside [0, E]; AUD_COUNTER where n_exec, n_sent, n_drop, n_deliv,
// event_seq, packet_seq or app_seq is negative. Globally, event-row
// conservation: sum(aud_tx) - (sum(n_exec) + live rows (slots >= head
// with t < INF) + sum(overflow) + sum(x_overflow)), in int64; where it
// is not 0, every host's word takes AUD_CONSERVE, as the reference
// broadcasts its verdict. Bits are ORed into `aud`, never cleared.
//
// Every host's heap row and counters are read at every round end: the
// audit exists to catch a corruption anywhere (a state loaded from
// outside, a kernel's fault), so unlike the tally, K2 and K11 it skips
// no host.
//
// Design: one launch. A block audits tiles of TILE consecutive hosts
// (grid-strided over the tiles). Its threads first read the tile's
// head, the seven counters, overflow, x_overflow and aud_tx, a thread a
// host (coalesced): the head's range and the counters' signs give a
// host's AUD_HEAP and AUD_COUNTER bits, the counters its share of the
// balance, and the head goes to shared memory. The tile's heap rows are
// one contiguous span of ht (TILE * E words), which the block streams
// with 16-byte loads (two words a load where E is even and the rows
// 16-byte aligned, else one), UNROLL loads a thread issued before the
// first is used: four while the grid fits the card at once, else two,
// whose fewer registers keep more blocks resident (at 1,000,000 hosts
// two ran 0.3103 ms where four had run 0.3430: PERF.md).
// Each word is compared with its right neighbour inside
// its row, never across a row's end: the neighbour is the next lane's
// first word (a shuffle; the warp's last lane loads it). A word's row
// is its index in the span over E (a multiply by a reciprocal fixed
// when the kernel is launched). Keys are read only where two times tie
// (the INF-padded tail ties, and its keys are compared as the reference
// compares them): a lane loads its keys where one of its words ties
// with a neighbour, so the next lane's first key is a shuffle too. A
// word out of order marks its row's host in shared memory; a word at or
// past its row's head with t < INF counts as live. Each tile then ORs
// its hosts' bits into their words (atomicOr, where a bit is set).
// The balance is one int64 partial a block (integer sums are exact in
// any order); the last block of a replica to take its ticket
// (common.cuh `ticket_take`, `ticket_last`, as K9 and the tally use
// them; the tickets go back to 0, so a graph replay needs no memset)
// sums the partials and, where the balance is not 0, ORs AUD_CONSERVE
// into every word of its replica (atomicOr: a tile's ORs may land in
// any order around it). That path runs only on a corrupt state, which
// ends the run, and may be slow.
//
// On a mesh (a rank's hosts; the reference's `_axis_sum64` over the
// device axis) the balance is global: a row leaves one rank and lands on
// another, so a rank's own balance may be non-zero where the sum over
// the ranks is 0. There the launch is given `balance` ([R] int64): the
// last block writes the rank's balance there and decides nothing; the
// engine sums the word over the ranks (device/mesh.py `all_sum`) and
// `shadow_audit_conserve` (audit_conserve_kernel) ORs AUD_CONSERVE into
// every host of the rank where the summed word is not 0. The heap and
// counter bits are decided in the streamed launch as on one device.
//
// Under the window loop the launch returns at once unless the control
// block's ROUND_END word is set (common.cuh `Ctl`): the audit runs once
// per round, at its end. The replica axis of an ensemble campaign is
// blockIdx.y: replica r's blocks audit its hosts (rows g = r * H + h)
// under its control block's ROUND_END, with its own partials and
// tickets, its balance its own.
//
// The design before (a warp a host, lane 0 reading the counters after
// the row's votes; a memset of the sum and a second launch for the
// broadcast) stays reachable for measurement (`warp_per_host`,
// Kernels.designs_before), never as a fallback.
//
// Bound on the H100: bytes: t of every heap slot (H*E*8), the key of
// every slot in a run of tied times (each once), head and the seven
// counters, overflow, x_overflow (int32) and aud_tx (int64) of every
// host, and the word read and written where a bit is set; there is no
// arithmetic to speak of.
#include "common.cuh"

using namespace shadow;

namespace {

constexpr int32_t AUD_HEAP = 1;
constexpr int32_t AUD_COUNTER = 4;
constexpr int32_t AUD_CONSERVE = 8;
constexpr unsigned FULL = 0xFFFFFFFFu;

// the tiled design: hosts a tile = threads a block, loads a thread in
// flight (UNROLL_ONE_WAVE while the grid fits the card at once, else
// UNROLL_WAVES: fewer registers, more blocks resident), the grid's cap
// (blocks stride over the tiles past it)
constexpr int TILE = 256;
constexpr int UNROLL_ONE_WAVE = 4;
constexpr int UNROLL_WAVES = 2;
constexpr int MAX_TILE_BLOCKS = 32768;
// a word's row in its tile's span: (n * recip) >> RECIP_SHIFT, exact for
// n < TILE * E when E <= MAX_E
constexpr int RECIP_SHIFT = 40;
constexpr int MAX_E = 65535;

// the design before: warps a block, the grid's cap
constexpr int WARPS = 8;
constexpr int MAX_BLOCKS = 2048;

struct Counters {
    const int32_t *n_exec, *n_sent, *n_drop, *n_deliv, *event_seq,
        *packet_seq, *app_seq, *overflow, *x_overflow;
};

__device__ __forceinline__ bool skip(const int64_t* ctl) {
    return ctl != nullptr && ctl[CTL_ROUND_END] == 0;
}

struct AuditArgs {
    int H, E;
    const int64_t* ht;
    const int64_t* hk;
    const int32_t* head;
    Counters c;
    const int64_t* aud_tx;
    int32_t* aud;
    long long* partial;     // [R, nb]
    unsigned* tickets;      // [R, ticket_words(nb)], zero between launches
    long long* balance;     // [R] on a mesh rank (the sum is the mesh's),
                            // else null (the last block decides)
    const int64_t* ctl;
    unsigned long long recip;   // ceil(2^RECIP_SHIFT / E)
};

// W consecutive words at p (16-byte aligned where W = 2)
template <int W>
__device__ __forceinline__ void load_words(const int64_t* p, int64_t* v) {
    if constexpr (W == 2) {
        const longlong2 x = __ldg(reinterpret_cast<const longlong2*>(p));
        v[0] = x.x;
        v[1] = x.y;
    } else {
        v[0] = __ldg(p);
    }
}

// One tile's heap span, n = nh * E words at t (keys at k), W words a
// load: marks bad[row] where a word breaks its row's (t, key) order;
// returns this thread's count of live words (slot >= hd[row], t < INF).
// Every thread of the block calls it (the shuffles need whole warps).
template <int W, int UNROLL>
__device__ __forceinline__ long long audit_span(const AuditArgs& a,
                                                const int64_t* t,
                                                const int64_t* k, int n,
                                                const int* hd, int* bad) {
    const int E = a.E;
    const int lane = threadIdx.x & 31;
    const int nq = n / W;           // loads of W words; n is a multiple
    long long live = 0;
    for (int q0 = 0; q0 < nq; q0 += TILE * UNROLL) {
        int64_t v[UNROLL][W], nx[UNROLL];
        int wq[UNROLL], slot[UNROLL], row[UNROLL];
        bool ok[UNROLL];
        // the times: UNROLL loads in flight, and the warp's last lane's
        // right neighbours
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int q = q0 + u * TILE + threadIdx.x;
            ok[u] = q < nq;
            const int w = q * W;
            wq[u] = w;
            row[u] = ok[u] ? (int)(((unsigned long long)w * a.recip) >>
                                   RECIP_SHIFT)
                           : 0;
            slot[u] = ok[u] ? w - row[u] * E : E;
            if (ok[u]) {
                load_words<W>(t + w, v[u]);
            } else {
#pragma unroll
                for (int j = 0; j < W; ++j) v[u][j] = INF;
            }
            nx[u] = lane == 31 && slot[u] + W < E ? __ldg(t + w + W) : INF;
        }
        // the ties, and the keys where a word ties with a neighbour
        int64_t kv[UNROLL][W], kn[UNROLL];
        bool tie[UNROLL][W];    // word j with word j + 1 (the last: with
                                // the next lane's first)
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int64_t right =
                __shfl_down_sync(FULL, (long long)v[u][0], 1);
            const int64_t left =
                __shfl_up_sync(FULL, (long long)v[u][W - 1], 1);
            if (lane != 31) nx[u] = right;
            const bool in_row = slot[u] + W < E;
            bool any = lane > 0 && slot[u] > 0 && slot[u] < E &&
                       left == v[u][0];
#pragma unroll
            for (int j = 0; j < W; ++j) {
                tie[u][j] = j + 1 < W ? v[u][j] == v[u][j + 1]
                                      : in_row && v[u][W - 1] == nx[u];
                any = any || tie[u][j];
            }
            any = any && ok[u];
            if (any) {
                load_words<W>(k + wq[u], kv[u]);
            } else {
#pragma unroll
                for (int j = 0; j < W; ++j) kv[u][j] = 0;
            }
            kn[u] = lane == 31 && tie[u][W - 1] ? __ldg(k + wq[u] + W) : 0;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int64_t right =
                __shfl_down_sync(FULL, (long long)kv[u][0], 1);
            if (lane != 31) kn[u] = right;
            if (!ok[u]) continue;
            bool sorted = true;
#pragma unroll
            for (int j = 0; j < W; ++j) {
                const bool last = j + 1 == W;
                if (last && slot[u] + W >= E) continue;
                const int64_t tr = last ? nx[u] : v[u][j + 1];
                const int64_t kr = last ? kn[u] : kv[u][j + 1];
                sorted = sorted && (v[u][j] < tr ||
                                    (tie[u][j] && kv[u][j] <= kr));
            }
            if (!sorted) bad[row[u]] = 1;
            const int h = hd[row[u]];
#pragma unroll
            for (int j = 0; j < W; ++j)
                live += slot[u] + j >= h && v[u][j] < INF;
        }
    }
    return live;
}

template <int W, int UNROLL>
__global__ void __launch_bounds__(TILE)
audit_tiles_kernel(AuditArgs a) {
    const int64_t r = blockIdx.y;
    if (skip(replica_ctl(a.ctl, r))) return;
    __shared__ int hd[TILE];
    __shared__ int bad[TILE];
    __shared__ long long part[TILE / 32];
    __shared__ int last;
    const int E = a.E;
    const Counters& c = a.c;
    bad[threadIdx.x] = 0;
    long long acc = 0;
    const int64_t tiles = ((int64_t)a.H + TILE - 1) / TILE;
    for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int64_t h0 = tile * TILE;
        const int nh = (int)min((int64_t)TILE, (int64_t)a.H - h0);
        const int64_t g0 = r * a.H + h0;
        // the tile's hosts, a thread a host
        int32_t word = 0;
        if ((int)threadIdx.x < nh) {
            const int64_t g = g0 + threadIdx.x;
            const int h = __ldg(a.head + g);
            const int32_t ne = __ldg(c.n_exec + g);
            const int32_t ov = __ldg(c.overflow + g);
            const int32_t xo = __ldg(c.x_overflow + g);
            const int64_t tx = __ldg(a.aud_tx + g);
            const bool neg = ne < 0 || __ldg(c.n_sent + g) < 0 ||
                             __ldg(c.n_drop + g) < 0 ||
                             __ldg(c.n_deliv + g) < 0 ||
                             __ldg(c.event_seq + g) < 0 ||
                             __ldg(c.packet_seq + g) < 0 ||
                             __ldg(c.app_seq + g) < 0;
            if (h < 0 || h > E) word |= AUD_HEAP;
            if (neg) word |= AUD_COUNTER;
            acc += (long long)tx - (long long)ne - (long long)ov -
                   (long long)xo;
            hd[threadIdx.x] = h;
        }
        __syncthreads();
        // the tile's heap span
        const int64_t* t = a.ht + g0 * E;
        const int64_t* k = a.hk + g0 * E;
        const int n = nh * E;
        acc -= audit_span<W, UNROLL>(a, t, k, n, hd, bad);
        __syncthreads();
        if ((int)threadIdx.x < nh) {
            if (bad[threadIdx.x]) {
                word |= AUD_HEAP;
                bad[threadIdx.x] = 0;
            }
            if (word) atomicOr(a.aud + g0 + threadIdx.x, word);
        }
        // the next tile's first barrier orders these reads of hd and
        // bad before its writes
    }
    // the block's partial, then its ticket; the last block's sum
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
    __syncthreads();
    const int nb = gridDim.x;
    unsigned* tk = a.tickets + r * ticket_words(nb);
    if (threadIdx.x == 0) {
        long long s = 0;
        for (int i = 0; i < TILE / 32; ++i) s += part[i];
        a.partial[r * nb + blockIdx.x] = s;
        last = ticket_last(tk, nb, ticket_take(tk));
    }
    __syncthreads();
    if (!last) return;
    long long s = 0;
    for (int i = threadIdx.x; i < nb; i += TILE)
        s += __ldcg(a.partial + r * nb + i);
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
    __syncthreads();
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
    __syncthreads();
    s = 0;
    for (int i = 0; i < TILE / 32; ++i) s += part[i];
    if (a.balance != nullptr) {
        if (threadIdx.x == 0) a.balance[r] = s;
        return;
    }
    if (s == 0) return;
    for (int64_t h = threadIdx.x; h < a.H; h += TILE)
        atomicOr(a.aud + r * a.H + h, AUD_CONSERVE);
}

// the design before: a warp a host, then a second launch broadcasting
//
// At most 32 registers, 8 blocks an SM: the replica's row index took it
// to 34 registers and 6 blocks, and the standalone audit lost time at
// 1,000,000 hosts (PERF.md).
__global__ void __launch_bounds__(32 * WARPS, 8)
audit_hosts_kernel(int H, int E, const int64_t* __restrict__ ht,
                   const int64_t* __restrict__ hk,
                   const int32_t* __restrict__ head, Counters c,
                   const int64_t* __restrict__ aud_tx, int32_t* aud,
                   unsigned long long* sum, const int64_t* ctl) {
    const int64_t r = blockIdx.y;
    if (skip(replica_ctl(ctl, r))) return;
    const int64_t rh = r * H;
    __shared__ long long part[WARPS];
    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    long long acc = 0;
    for (int64_t h = (int64_t)blockIdx.x * WARPS + w; h < H;
         h += (int64_t)gridDim.x * WARPS) {
        const int64_t g = rh + h;
        const int hd = head[g];
        const int64_t* t = ht + g * E;
        const int64_t* k = hk + g * E;
        bool ok = true;
        int live = 0;
        for (int j = lane; j < E; j += 32) {
            const int64_t tj = t[j];
            if (j >= hd && tj < INF) ++live;
            if (j + 1 < E) {
                const int64_t tn = t[j + 1];
                if (!(tj < tn || (tj == tn && k[j] <= k[j + 1])))
                    ok = false;
            }
        }
        ok = __all_sync(FULL, ok);
        live = __reduce_add_sync(FULL, live);
        if (lane == 0) {
            int32_t word = 0;
            if (!ok || hd < 0 || hd > E) word |= AUD_HEAP;
            if (c.n_exec[g] < 0 || c.n_sent[g] < 0 || c.n_drop[g] < 0 ||
                c.n_deliv[g] < 0 || c.event_seq[g] < 0 ||
                c.packet_seq[g] < 0 || c.app_seq[g] < 0)
                word |= AUD_COUNTER;
            if (word) aud[g] |= word;
            acc += (long long)aud_tx[g] - (long long)c.n_exec[g] -
                   (long long)live - (long long)c.overflow[g] -
                   (long long)c.x_overflow[g];
        }
    }
    if (lane == 0) part[w] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
        long long s = 0;
        for (int i = 0; i < WARPS; ++i) s += part[i];
        if (s != 0) atomicAdd(&sum[r], (unsigned long long)s);
    }
}

// every host of replica r where its balance sum[r] is not 0: the design
// before's second launch, and a mesh rank's conserve pass on the word
// summed over the ranks
__global__ void audit_conserve_kernel(int H, int32_t* aud,
                                      const unsigned long long* sum,
                                      const int64_t* ctl) {
    const int64_t r = blockIdx.y;
    if (skip(replica_ctl(ctl, r)) || sum[r] == 0) return;
    for (int64_t h = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; h < H;
         h += (int64_t)gridDim.x * blockDim.x)
        aud[r * H + h] |= AUD_CONSERVE;
}

int conserve_blocks(int H) {
    const int64_t want = ((int64_t)H + 255) / 256;
    return want < 1 ? 1 : (want < MAX_BLOCKS ? (int)want : MAX_BLOCKS);
}

int tile_blocks(int H) {
    const int64_t want = ((int64_t)H + TILE - 1) / TILE;
    return want < 1 ? 1 : (want < MAX_TILE_BLOCKS ? (int)want
                                                 : MAX_TILE_BLOCKS);
}

}  // namespace

// The scratch of the tiled design at H hosts, a replica: int64 partials
// and unsigned tickets (zero when allocated).
extern "C" int shadow_audit_round_blocks(int H) { return tile_blocks(H); }
extern "C" int shadow_audit_round_tickets(int H) {
    return ticket_words(tile_blocks(H));
}

// sum: R int64 (the design before); partial, tickets: the tiled
// design's scratch (shadow_audit_round_blocks/_tickets words a
// replica); balance: R int64 on a mesh rank (the tiled design only),
// where the launch writes the rank's balance and ORs no AUD_CONSERVE
// (shadow_audit_conserve does, on the mesh's sum), else null
extern "C" int shadow_audit_round(
    int R, int H, int E, const int64_t* ht, const int64_t* hk,
    const int32_t* head,
    const int32_t* n_exec, const int32_t* n_sent, const int32_t* n_drop,
    const int32_t* n_deliv, const int32_t* event_seq,
    const int32_t* packet_seq, const int32_t* app_seq,
    const int32_t* overflow, const int32_t* x_overflow,
    const int64_t* aud_tx, int32_t* aud, int64_t* sum, int64_t* partial,
    unsigned* tickets, const int64_t* ctl, int warp_per_host,
    int64_t* balance, void* stream) {
    // a mesh rank's mode is the tiled design's alone
    if (R < 1 || R > 65535 ||
        (warp_per_host ? sum == nullptr || balance != nullptr
                       : (partial == nullptr || tickets == nullptr)))
        return (int)cudaErrorInvalidValue;
    if (H <= 0 || E <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    const Counters c{n_exec, n_sent, n_drop, n_deliv, event_seq,
                     packet_seq, app_seq, overflow, x_overflow};
    if (!warp_per_host) {
        if (E > MAX_E) return (int)cudaErrorInvalidValue;
        const AuditArgs a{H, E, ht, hk, head, c, aud_tx, aud,
                          (long long*)partial, tickets,
                          (long long*)balance, ctl,
                          ((1ull << RECIP_SHIFT) + E - 1) / E};
        // two words a load where every row starts 16-byte aligned
        const bool wide = E % 2 == 0 &&
                          (reinterpret_cast<uintptr_t>(ht) & 15) == 0 &&
                          (reinterpret_cast<uintptr_t>(hk) & 15) == 0;
        const dim3 grid(tile_blocks(H), R);
        auto one_wave = wide ? audit_tiles_kernel<2, UNROLL_ONE_WAVE>
                             : audit_tiles_kernel<1, UNROLL_ONE_WAVE>;
        auto waves = wide ? audit_tiles_kernel<2, UNROLL_WAVES>
                          : audit_tiles_kernel<1, UNROLL_WAVES>;
        int dev = 0, sms = 0, per_sm = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, one_wave,
                                                      TILE, 0);
        const bool fits = (int64_t)grid.x * R <= (int64_t)sms * per_sm;
        auto kernel = fits ? one_wave : waves;
        kernel<<<grid, TILE, 0, st>>>(a);
        return (int)cudaGetLastError();
    }
    cudaError_t err = cudaMemsetAsync(sum, 0, sizeof(int64_t) * R, st);
    if (err != cudaSuccess) return (int)err;
    const int64_t want = ((int64_t)H + WARPS - 1) / WARPS;
    const int blocks = want < MAX_BLOCKS ? (int)want : MAX_BLOCKS;
    audit_hosts_kernel<<<dim3(blocks, R), 32 * WARPS, 0, st>>>(
        H, E, ht, hk, head, c, aud_tx, aud, (unsigned long long*)sum, ctl);
    audit_conserve_kernel<<<dim3(conserve_blocks(H), R), 256, 0, st>>>(
        H, aud, (const unsigned long long*)sum, ctl);
    return (int)cudaGetLastError();
}

// A mesh rank's conserve pass: AUD_CONSERVE into every host of replica r
// where total[r], its balance summed over the ranks, is not 0 (under the
// window loop only where the control block's ROUND_END word is set).
extern "C" int shadow_audit_conserve(int R, int H, int32_t* aud,
                                     const int64_t* total,
                                     const int64_t* ctl, void* stream) {
    if (R < 1 || R > 65535 || total == nullptr)
        return (int)cudaErrorInvalidValue;
    if (H <= 0) return (int)cudaGetLastError();
    audit_conserve_kernel<<<dim3(conserve_blocks(H), R), 256, 0,
                            (cudaStream_t)stream>>>(
        H, aud, (const unsigned long long*)total, ctl);
    return (int)cudaGetLastError();
}
