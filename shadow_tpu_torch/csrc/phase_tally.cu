// phase_tally: the tallies that close one phase, after its judge and path
// counters.
//
// Replaces the state updates of shadow_tpu/device/engine.py between the
// judge and the route: `occ_ob`, each host's high-water mark of
// exchangeable outbox rows (t < DROP_T, engine.py:1941-1943);
// `occ_phases += 1` (1944); under the state audit the conservation
// ledger `aud_tx += those rows` (1945-1951); and `_phase`'s `occ_trips`,
// the high-water mark of pop-loop iterations (2135-2136), here the
// largest per-host pop count. As torch ops between the launches they
// would run in every slot of the captured window loop; as one kernel
// they return at once where the loop's control block says the phase
// does not run (common.cuh `Ctl`), so a slot after the loop is done
// changes no byte of state (`occ_phases` is not idempotent).
//
// Only the rows that can hold an exchangeable row are read. The outbox
// outlives a phase (pop_phase.cu): after the pop, a host whose pop count
// is 0 holds only clear rows (t = INF), so it adds 0 to occ_ob and
// aud_tx and is skipped, unless the engine's outbox word says the rows
// came from outside the pop (a flush of rows copied in, whose pop counts
// are 0), where every host's row is read; so is every host's of a
// launch given no word. This is K2's rule (judge_outbox.cu), and the
// word is read as K2 read it: the pop has cleared it where the phase
// popped, and a flush without a pop leaves it set.
//
// Design: each thread loads the pop count of a host (a warp's 32
// consecutive hosts a load, coalesced; above MAX_BLOCKS blocks of a
// host a thread, LOADS_BIG hosts a thread, loaded together) and keeps
// the largest; a warp's ballot says which of its 32 hosts to read, and
// each of those hosts' lanes loads its occ_ob (and aud_tx) beside the
// rows. The warp reads the rows of those hosts alone, eight hosts' rows
// side by side at a time, and a ballot a chunk of 32 columns counts a
// host's live words (tally.cuh `count_rows`, `tally_count`). Each block
// writes the largest pop count of its hosts as one partial, and takes
// its ticket before it reads any row: the ticket's release then waits
// on no store of the block, and the rows are read while the ticket is
// in flight (common.cuh `ticket_take`, `ticket_last`); the last block
// of a replica to finish reduces the partials into occ_trips and counts
// the phase, from the words thread 0 loaded at the start. The RUN word
// loads beside the pop counts. In the captured window loop K9 does all
// of this itself (loop_control.cu, the tally folded in), so this kernel
// runs where K9 does not follow the phase on the card: the Python loop,
// `outbox_compact`, a mesh, a public flush. The grid is sized to the
// hosts: a host a thread, at most MAX_BLOCKS blocks. The replica axis
// of an ensemble campaign is blockIdx.y: replica r's blocks read its
// rows g = r * H + h of the outbox and pop counts, its outbox word,
// partials and tickets, and keep its own marks (occ_trips and
// occ_phases are [R, 1]).
//
// The design before (a warp a host reading every row, one atomicMax a
// block on occ_trips) stays reachable for measurement (`every_row`,
// Kernels.designs_before), never as a fallback.
//
// Bound on the H100: bytes: pops [H] read; for each host read, t of its
// row (OB*8), occ_ob read and written, aud_tx read and written under the
// audit.
#include "tally.cuh"

using namespace shadow;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_BLOCKS = 1024;
constexpr int LOADS_BIG = 4;
// the every-row design's (the parent's) grid cap
constexpr int EVERY_ROW_BLOCKS = 2048;

template <int LOADS>
__global__ void __launch_bounds__(THREADS)
phase_tally_kernel(TallyArgs a, const int64_t* ctl, unsigned* tickets) {
    const int64_t r = blockIdx.y;
    const bool off = phase_off(replica_ctl(ctl, r));
    const bool every = a.ob_word == nullptr || a.ob_word[r] != 0;
    int32_t trips = 0, phases = 0;
    if (threadIdx.x == 0) {
        trips = a.occ_trips[r];
        phases = a.occ_phases[r];
    }
    __shared__ int most_w[WARPS];
    __shared__ int last;
    const int lane = threadIdx.x & 31;
    const int64_t rh = r * a.H;
    // the loops' bound is the block's, so that a warp's lanes stay
    // together for its ballots
    const int64_t first = (int64_t)blockIdx.x * THREADS * LOADS;
    const int64_t step = (int64_t)gridDim.x * THREADS * LOADS;
    // the block's largest pop count first: its partial and its ticket
    // go out before any of the block's stores, and the rows are read
    // while the ticket is in flight
    int most = INT32_MIN;
    for (int64_t b0 = first; b0 < a.H; b0 += step) {
#pragma unroll
        for (int i = 0; i < LOADS; ++i) {
            const int64_t h = b0 + i * THREADS + threadIdx.x;
            if (h < a.H) {
                const int32_t pv = __ldg(a.pops + rh + h);
                if (pv > most) most = pv;
            }
        }
    }
    if (off) return;
    most = block_max(most, most_w);
    const int nb = gridDim.x;
    unsigned* tk = tickets + r * ticket_words(nb);
    unsigned taken = 0;
    if (threadIdx.x == 0) {
        a.partial[r * nb + blockIdx.x] = most;
        taken = ticket_take(tk);
    }
    // then the rows (the pop counts again, from L1)
    for (int64_t b0 = first; b0 < a.H; b0 += step) {
        const int64_t h0 = b0 + threadIdx.x;
        int32_t pv[LOADS];
#pragma unroll
        for (int i = 0; i < LOADS; ++i) {
            const int64_t h = h0 + i * THREADS;
            pv[i] = h < a.H ? __ldg(a.pops + rh + h) : 0;
        }
#pragma unroll
        for (int i = 0; i < LOADS; ++i) {
            const int64_t h = h0 + i * THREADS;
            tally_store(a, rh + h,
                        tally_count(a, rh, h, pv[i], every, lane));
        }
    }
    if (threadIdx.x == 0) last = ticket_last(tk, nb, taken);
    __syncthreads();
    if (last && threadIdx.x < 32) tally_close(a, r, nb, trips, phases);
}

// the every-row design: a warp a host, one atomicMax a block
__global__ void phase_tally_rows_kernel(TallyArgs a, const int64_t* ctl) {
    const int64_t r = blockIdx.y;
    if (phase_off(replica_ctl(ctl, r))) return;
    const int64_t rh = r * a.H;
    __shared__ int trips;
    if (threadIdx.x == 0) trips = 0;
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    int most = 0;
    for (int64_t h = (int64_t)blockIdx.x * WARPS + w; h < a.H;
         h += (int64_t)gridDim.x * WARPS) {
        const int64_t g = rh + h;
        const int64_t row = g * a.OB;
        int n = 0;
        for (int c = lane; c < a.OB; c += 32) n += a.ob_t[row + c] < DROP_T;
        n = __reduce_add_sync(TALLY_FULL, n);
        if (lane == 0) {
            if (n > a.occ_ob[g]) a.occ_ob[g] = n;
            if (a.aud_tx) a.aud_tx[g] += n;
            if (a.pops[g] > most) most = a.pops[g];
        }
    }
    if (lane == 0) atomicMax(&trips, most);
    __syncthreads();
    if (threadIdx.x == 0) {
        atomicMax(&a.occ_trips[r], trips);
        if (blockIdx.x == 0) a.occ_phases[r] += 1;
    }
}

// hosts a thread
int loads(int H) {
    return (int64_t)H > (int64_t)THREADS * MAX_BLOCKS ? LOADS_BIG : 1;
}

int blocks(int H) {
    const int64_t per = (int64_t)THREADS * loads(H);
    const int64_t want = ((int64_t)H + per - 1) / per;
    return want < 1 ? 1 : (want < MAX_BLOCKS ? (int)want : MAX_BLOCKS);
}

}  // namespace

// The scratch of a launch at H hosts, a replica: int32 partials and
// unsigned tickets (zero when allocated).
extern "C" int shadow_phase_tally_blocks(int H) { return blocks(H); }
extern "C" int shadow_phase_tally_tickets(int H) {
    return ticket_words(blocks(H));
}

extern "C" int shadow_phase_tally(int R, int H, int OB,
                                  const int64_t* ob_t,
                                  const int32_t* pops, int32_t* occ_ob,
                                  int32_t* occ_trips, int32_t* occ_phases,
                                  int64_t* aud_tx, const int64_t* ctl,
                                  const int32_t* ob_word, int32_t* partial,
                                  unsigned* tickets, int every_row,
                                  void* stream) {
    if (R < 1 || R > 65535 ||
        (!every_row && (partial == nullptr || tickets == nullptr)))
        return (int)cudaErrorInvalidValue;
    if (H > 0) {
        cudaStream_t st = (cudaStream_t)stream;
        const TallyArgs a{H, OB, ob_t, pops, occ_ob, occ_trips,
                          occ_phases, aud_tx, ob_word, partial};
        const dim3 grid(blocks(H), R);
        if (every_row) {
            const int64_t want = ((int64_t)H + WARPS - 1) / WARPS;
            const int nb = want < EVERY_ROW_BLOCKS ? (int)want
                                                   : EVERY_ROW_BLOCKS;
            phase_tally_rows_kernel<<<dim3(nb, R), THREADS, 0, st>>>(a,
                                                                     ctl);
        } else if (loads(H) == 1) {
            phase_tally_kernel<1><<<grid, THREADS, 0, st>>>(a, ctl,
                                                            tickets);
        } else {
            phase_tally_kernel<LOADS_BIG><<<grid, THREADS, 0, st>>>(
                a, ctl, tickets);
        }
    }
    return (int)cudaGetLastError();
}
