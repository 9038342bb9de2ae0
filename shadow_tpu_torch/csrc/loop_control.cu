// K9 loop_control: the window loop's control step, on the device.
//
// Replaces the loop of shadow_tpu/device/engine.py `_run_shard` and
// `_round` (engine.py:2116-2206): `next_time` (`_take_head` and
// `_axis_min`, a plain minimum on one device), `more()` (another phase
// while some host's head lies below win_end), the round count, the stop
// test against `stop` and `max_rounds` (`cond`), and the next window
// `min(next + lookahead, final_stop)` (`body`); the port's plain
// version is the Python loop of device/engine.py (`run`/`window`).
//
// It runs after every phase of the captured window loop and works on
// the loop's control block (common.cuh `Ctl`): with the minimum head
// time `nxt` over hosts, a phase that leaves some head below WIN_END
// sets RUN, so the next slot's phase continues the window; otherwise
// the round has ended: ROUNDS += 1 and ROUND_END is set (the audit reads
// it); then, where nxt >= STOP or ROUNDS has reached MAX_ROUNDS, DONE is
// set and RUN cleared, else WIN_END = min(nxt + LOOKAHEAD, FINAL_STOP)
// and RUN set. `start` (the call before the first slot) skips the phase
// and round bookkeeping. Once DONE is set the step only clears RUN and
// ROUND_END, so the slots after it change nothing.
//
// Design: one launch a step. A grid-strided minimum over hosts, where
// each thread loads the heads of LOADS hosts before any of their head
// times (the head time's address depends on the head, so the loads of a
// thread's hosts overlap instead of waiting one after another), writes
// one partial a block; the last block of a replica to finish
// (common.cuh `ticket_take`, `ticket_last`: tickets reset by the blocks
// that take them, so a graph replay needs no memset) reduces the
// partials and takes the decisions in thread 0, on the control words
// the block loaded at the start into shared memory (only that block
// writes them, after every block has taken its ticket). The DONE word
// loads beside the heads, not before them. The grid is sized to the
// hosts: LOADS, the least of 1, 2 and 4 that keeps the grid within one
// ticket group (at 10,000 hosts 40 blocks of a host a thread, at
// 100,000 98 blocks of four), else a host a thread and at most
// MAX_BLOCKS blocks (at 1,000,000 hosts 3,907 blocks, more than the
// card holds at once, which kept more loads in flight than fewer blocks
// of eight hosts a thread); with the tally folded in, a host a thread
// (`loads`). An ensemble campaign (shadow_tpu/device/engine.py
// `_run_ens_shard`, which vmaps `_run_shard` over the replicas) has one
// control block per replica, [R, CTL_N]: the replica is blockIdx.y,
// with its own partials and tickets, so a finished replica stays DONE
// while the others run on, as the vmapped while_loop freezes a finished
// replica's carry; a DONE replica's blocks leave without a partial and
// its block 0 clears RUN and ROUND_END.
//
// `loop_control_tally` is the same step with the phase's tallies folded
// in (phase_tally.cu's work, tally.cuh): in the captured window loop the
// outbox still holds the judged rows when K9 runs (the route and the
// merge only read it), so where the phase ran (RUN set, not `start`)
// each thread also loads its hosts' pop counts beside their heads, and
// the rows of the hosts that popped (every host's under the outbox
// word, FOLD_HOSTS rows a step) beside their head times; the block's
// largest pop count is a second partial, its occ_ob and aud_tx stores
// wait until its ticket is out (the ticket's release then waits on
// none of them), and the last block raises occ_trips and counts the
// phase before it decides. The phase then launches no tally of its own
// (PERF.md gives the two against each other on the main path).
// The engine folds only where nothing rewrites the outbox after the
// judge: not under `outbox_compact` (K11 compacts it), and not in the
// Python loop, which takes K9's decisions on the host.
//
// The design before (two launches a step: the minimum, then a block of
// 1,024 threads a replica reducing the partials and deciding) stays
// reachable for measurement (`split`, Kernels.designs_before), never
// as a fallback.
//
// Bound on the H100: bytes: head [H] int32 read, and one head time a
// host whose head lies within its heap: an 8-byte load at a stride of
// E*8 bytes, so each is its own 32-byte sector (H*4 + hosts*32 bytes a
// replica); folded, the tally's bytes besides (phase_tally.cu).
#include "tally.cuh"

using namespace shadow;

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 4096;
// the folded kernel reads 4 rows a step (8 loads a lane in flight) and
// keeps 4 blocks an SM (at most 64 registers): with 8 rows a step and
// the control words in registers it held 2, too few for K9's gather
constexpr int FOLD_HOSTS = 4;
constexpr int FOLD_MIN_BLOCKS = 4;
// the split design's (the parent's) grid: a host a thread
constexpr int SPLIT_THREADS = 256;
constexpr int SPLIT_MAX_BLOCKS = 1024;
constexpr int SPLIT_CONTROL_THREADS = 1024;

struct LoopArgs {
    int H, E;
    const int64_t* ht;
    const int32_t* head;
    int64_t* partial;           // [R, nb]: each block's minimum
    unsigned* tickets;          // [R, ticket_words(nb)]
    int64_t* ctl;
    int start;
};

__device__ int64_t block_min(int64_t v) {
    __shared__ int64_t part[32];
    for (int off = 16; off > 0; off >>= 1) {
        const int64_t o = __shfl_down_sync(0xFFFFFFFFu, v, off);
        if (o < v) v = o;
    }
    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    if (lane == 0) part[w] = v;
    __syncthreads();
    const int nw = (blockDim.x + 31) >> 5;
    v = threadIdx.x < nw ? part[threadIdx.x] : INF;
    if (w == 0) {
        for (int off = 16; off > 0; off >>= 1) {
            const int64_t o = __shfl_down_sync(0xFFFFFFFFu, v, off);
            if (o < v) v = o;
        }
    }
    return v;   // in thread 0
}

// The decisions on control block c, given the minimum head time m and
// the block's words w as they were (one thread).
__device__ void decide(int64_t* c, const int64_t* w, int64_t m,
                       int start) {
    c[CTL_NXT] = m;
    c[CTL_ROUND_END] = 0;
    int64_t rounds = w[CTL_ROUNDS];
    if (!start) {
        c[CTL_PHASES] = w[CTL_PHASES] + 1;
        if (m < w[CTL_WIN_END]) {       // the window goes on
            c[CTL_RUN] = 1;
            return;
        }
        c[CTL_ROUNDS] = ++rounds;
        c[CTL_ROUND_END] = 1;
    }
    if (m >= w[CTL_STOP] || rounds >= w[CTL_MAX_ROUNDS]) {
        c[CTL_DONE] = 1;
        c[CTL_RUN] = 0;
        return;
    }
    const int64_t end = m + w[CTL_LOOKAHEAD];
    c[CTL_WIN_END] = end < w[CTL_FINAL_STOP] ? end : w[CTL_FINAL_STOP];
    c[CTL_RUN] = 1;
}

// One step of replica blockIdx.y, with the tally folded in where TALLY.
template <int LOADS, bool TALLY>
__device__ __forceinline__ void loop_step(const LoopArgs& a,
                                          const TallyArgs& ta) {
    const int64_t r = blockIdx.y;
    int64_t* c = a.ctl + r * CTL_N;
    const int64_t done = c[CTL_DONE];
    // the phase ran: its tallies are this step's
    const bool tally = TALLY && !a.start && c[CTL_RUN] != 0;
    const bool every = TALLY && (ta.ob_word == nullptr ||
                                 ta.ob_word[r] != 0);
    // the control words as they were, for the last block's decisions
    // (in shared memory: registers held across the kernel cost the
    // folded kernel its occupancy)
    __shared__ int64_t w[CTL_N];
    int32_t trips = 0, phases = 0;
    if (threadIdx.x < CTL_N) w[threadIdx.x] = c[threadIdx.x];
    if (TALLY && threadIdx.x == 0) {
        trips = ta.occ_trips[r];
        phases = ta.occ_phases[r];
    }
    __shared__ int most_w[THREADS / 32];
    __shared__ int last;
    const int lane = threadIdx.x & 31;
    const int H = a.H, E = a.E;
    const int64_t rh = r * H;
    const int64_t first = (int64_t)blockIdx.x * THREADS * LOADS;
    const int64_t step = (int64_t)gridDim.x * THREADS * LOADS;
    // this thread's hosts: their heads (and pop counts), then their head
    // times (and the rows to tally, counted beside them); the loop's
    // bound is the block's, so that a warp's lanes stay together for the
    // tally's ballots. The last pass's tally stores wait until the
    // block's ticket is out (its release then waits on none of them).
    int64_t m = INF;
    int most = INT32_MIN;
    TallyCount kept[LOADS];
    int64_t kept_h0 = 0;
    for (int64_t b0 = first; b0 < H; b0 += step) {
        const int64_t h0 = b0 + threadIdx.x;
        int hd[LOADS];
        int32_t pv[LOADS];
#pragma unroll
        for (int i = 0; i < LOADS; ++i) {
            const int64_t h = h0 + i * THREADS;
            hd[i] = h < H ? __ldg(a.head + rh + h) : E;
            if (TALLY) pv[i] = h < H && tally ? __ldg(ta.pops + rh + h)
                                               : 0;
        }
        // the head times load; they are compared after the tally's rows
        // have gone out too, so that both are in flight together
        int64_t ht[LOADS];
#pragma unroll
        for (int i = 0; i < LOADS; ++i)
            ht[i] = hd[i] < E ? __ldg(a.ht + (rh + h0 + i * THREADS) * E +
                                      (hd[i] < 0 ? 0 : hd[i]))
                              : INF;
        if (tally) {
            const bool final_pass = b0 + step >= H;
#pragma unroll
            for (int i = 0; i < LOADS; ++i) {
                const int64_t h = h0 + i * THREADS;
                if (h < H && pv[i] > most) most = pv[i];
                const TallyCount tc = tally_count<FOLD_HOSTS>(
                    ta, rh, h, pv[i], every, lane);
                if (final_pass)
                    kept[i] = tc;
                else
                    tally_store(ta, rh + h, tc);
            }
            kept_h0 = h0;
        }
#pragma unroll
        for (int i = 0; i < LOADS; ++i)
            if (ht[i] < m) m = ht[i];
    }
    if (done) {
        if (blockIdx.x == 0 && threadIdx.x == 0) {
            c[CTL_RUN] = 0;
            c[CTL_ROUND_END] = 0;
        }
        return;
    }
    const int nb = gridDim.x;
    unsigned* tk = a.tickets + r * ticket_words(nb);
    m = block_min(m);
    if (tally) most = block_max(most, most_w);
    unsigned taken = 0;
    if (threadIdx.x == 0) {
        a.partial[r * nb + blockIdx.x] = m;
        if (tally) ta.partial[r * nb + blockIdx.x] = most;
        taken = ticket_take(tk);
    }
    if (tally && kept_h0 < H) {
#pragma unroll
        for (int i = 0; i < LOADS; ++i)
            tally_store(ta, rh + kept_h0 + i * THREADS, kept[i]);
    }
    if (threadIdx.x == 0) last = ticket_last(tk, nb, taken);
    __syncthreads();
    if (!last) return;
    if (tally && threadIdx.x < 32) tally_close(ta, r, nb, trips, phases);
    m = INF;
    for (int i = threadIdx.x; i < nb; i += THREADS) {
        const int64_t p = __ldcg(a.partial + r * nb + i);
        if (p < m) m = p;
    }
    m = block_min(m);
    if (threadIdx.x == 0) decide(c, w, m, a.start);
}

template <int LOADS>
__global__ void __launch_bounds__(THREADS)
loop_control_kernel(LoopArgs a) {
    loop_step<LOADS, false>(a, TallyArgs{});
}

template <int LOADS>
__global__ void __launch_bounds__(THREADS, FOLD_MIN_BLOCKS)
loop_control_tally_kernel(LoopArgs a, TallyArgs ta) {
    loop_step<LOADS, true>(a, ta);
}

// the split design: the minimum, a host a thread ...
__global__ void head_min_kernel(int H, int E,
                                const int64_t* __restrict__ ht,
                                const int32_t* __restrict__ head,
                                int64_t* partial, const int64_t* ctl) {
    const int64_t r = blockIdx.y;
    if (ctl[r * CTL_N + CTL_DONE]) return;
    const int64_t rh = r * H;
    int64_t m = INF;
    for (int64_t h = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; h < H;
         h += (int64_t)gridDim.x * blockDim.x) {
        const int hd = head[rh + h];
        if (hd < E) {
            const int64_t t = ht[(rh + h) * E + (hd < 0 ? 0 : hd)];
            if (t < m) m = t;
        }
    }
    m = block_min(m);
    if (threadIdx.x == 0) partial[r * gridDim.x + blockIdx.x] = m;
}

// ... then a block a replica that reduces the partials and decides
__global__ void control_kernel(int nb, const int64_t* __restrict__ partial,
                               int64_t* ctl, int start) {
    ctl += (int64_t)blockIdx.x * CTL_N;
    partial += (int64_t)blockIdx.x * nb;
    if (ctl[CTL_DONE]) {
        if (threadIdx.x == 0) {
            ctl[CTL_RUN] = 0;
            ctl[CTL_ROUND_END] = 0;
        }
        return;
    }
    int64_t m = INF;
    for (int i = threadIdx.x; i < nb; i += blockDim.x)
        if (partial[i] < m) m = partial[i];
    m = block_min(m);
    if (threadIdx.x == 0) decide(ctl, ctl, m, start);
}

// hosts a thread: the split design 1; with the tally folded in 1 (a
// warp's rows to tally are read one chunk of 32 hosts after another, so
// more hosts a thread lengthen its chain of loads)
int loads(int H, int split, bool folded) {
    if (split || folded) return 1;
    for (int l = 1; l <= 4; l <<= 1)
        if ((int64_t)H <= (int64_t)THREADS * l * TICKET_GROUP) return l;
    return 1;
}

int blocks(int H, int split, bool folded) {
    const int64_t per = (int64_t)(split ? SPLIT_THREADS : THREADS) *
                        loads(H, split, folded);
    const int64_t want = ((int64_t)H + per - 1) / per;
    const int cap = split ? SPLIT_MAX_BLOCKS : MAX_BLOCKS;
    return want < 1 ? 1 : (want < cap ? (int)want : cap);
}


}  // namespace

// The scratch of a launch at H hosts, a replica: nb partials (int64;
// folded, nb int32 besides) and tickets (unsigned, zero when allocated;
// the split design takes none).
extern "C" int shadow_loop_control_blocks(int H, int split, int folded) {
    return blocks(H, split, folded);
}
extern "C" int shadow_loop_control_tickets(int H, int split, int folded) {
    return split ? 0 : ticket_words(blocks(H, 0, folded));
}

// ob_t null: no tally folded in (then OB, pops, the occupancy leaves,
// aud_tx, ob_word and tally_partial are not read); tally_partial: [R,
// nb] int32.
extern "C" int shadow_loop_control(
    int R, int H, int E, const int64_t* ht, const int32_t* head,
    int64_t* partial, unsigned* tickets, int64_t* ctl, int start, int split,
    int OB, const int64_t* ob_t, const int32_t* pops, int32_t* occ_ob,
    int32_t* occ_trips, int32_t* occ_phases, int64_t* aud_tx,
    const int32_t* ob_word, int32_t* tally_partial, void* stream) {
    if (R < 1 || R > 65535 || (!split && tickets == nullptr) ||
        (ob_t != nullptr && (split || tally_partial == nullptr)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int nb = blocks(H, split, ob_t != nullptr);
    if (split) {
        head_min_kernel<<<dim3(nb, R), SPLIT_THREADS, 0, st>>>(
            H, E, ht, head, partial, ctl);
        control_kernel<<<R, SPLIT_CONTROL_THREADS, 0, st>>>(nb, partial,
                                                            ctl, start);
        return (int)cudaGetLastError();
    }
    const LoopArgs a{H, E, ht, head, partial, tickets, ctl, start};
    const TallyArgs ta{H, OB, ob_t, pops, occ_ob, occ_trips, occ_phases,
                       aud_tx, ob_word, tally_partial};
    const dim3 grid(nb, R);
    if (ob_t != nullptr)
        loop_control_tally_kernel<1><<<grid, THREADS, 0, st>>>(a, ta);
    else if (loads(H, 0, false) == 1)
        loop_control_kernel<1><<<grid, THREADS, 0, st>>>(a);
    else if (loads(H, 0, false) == 2)
        loop_control_kernel<2><<<grid, THREADS, 0, st>>>(a);
    else
        loop_control_kernel<4><<<grid, THREADS, 0, st>>>(a);
    return (int)cudaGetLastError();
}
