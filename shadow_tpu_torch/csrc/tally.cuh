// The phase's tallies on a warp's hosts, shared by phase_tally.cu (the
// standalone tally) and loop_control.cu (K9 with the tally folded in).
//
// What they compute is phase_tally.cu's: each host's count of
// exchangeable outbox rows (t < DROP_T) into its high-water mark occ_ob
// and, under the audit, its ledger aud_tx; the largest pop count. The
// rows read are those of the hosts whose pop count is nonzero, or of
// every host where the engine's outbox word is set (phase_tally.cu says
// why that is exact).
#pragma once
#include "common.cuh"

namespace shadow {

constexpr unsigned TALLY_FULL = 0xFFFFFFFFu;
// the rows a warp loads together (HOSTS hosts, count_rows' parameter,
// TALLY_CHUNKS chunks of 32 columns each): 8 hosts, 16 loads a lane in
// flight, in the standalone tally
constexpr int TALLY_HOSTS = 8;
constexpr int TALLY_CHUNKS = 2;

// The tally's rows and leaves of one launch (replica r's rows and hosts
// g = r * H + h).
struct TallyArgs {
    int H, OB;
    const int64_t* ob_t;
    const int32_t* pops;
    int32_t *occ_ob, *occ_trips, *occ_phases;
    int64_t* aud_tx;            // null: no audit
    const int32_t* ob_word;     // [2,R], or null: read every host
    int32_t* partial;           // [R, nb]: each block's largest pop count
};

// The exchangeable rows of the hosts of `need` among the warp's 32
// hosts whose rows start at t0; lane i returns host i's count (where
// its bit of `need` is set). The warp takes the hosts of `need` HOSTS
// at a time and reads their rows side by side, lane l columns l, l +
// 32, ... of each, HOSTS * TALLY_CHUNKS loads in flight before the
// first is used; a ballot a chunk counts a host's
// live words, which its own lane keeps. The addresses are a host's bit
// and a column: a warp whose hosts mostly popped spends its time on the
// loads, not on arithmetic. (Loads numbered over the run of the hosts'
// rows, each address from a division and a select of the host's bit,
// made a busy warp the launch's critical path: the hosts that pop in a
// phase sit together in a few warps.) No shared memory, no atomics.
template <int HOSTS>
__device__ __forceinline__ int count_rows(const int64_t* __restrict__ t0,
                                          int OB, unsigned need, int lane) {
    int mine = 0;
    for (unsigned rest = need; rest != 0;) {
        int j[HOSTS];
#pragma unroll
        for (int g = 0; g < HOSTS; ++g) {
            j[g] = rest != 0 ? __ffs(rest) - 1 : -1;
            rest &= rest - 1u;
        }
        for (int c0 = 0; c0 < OB; c0 += 32 * TALLY_CHUNKS) {
            int64_t t[HOSTS][TALLY_CHUNKS];
#pragma unroll
            for (int g = 0; g < HOSTS; ++g)
#pragma unroll
                for (int k = 0; k < TALLY_CHUNKS; ++k) {
                    const int col = c0 + 32 * k + lane;
                    t[g][k] = j[g] >= 0 && col < OB
                                  ? __ldg(t0 + (int64_t)j[g] * OB + col)
                                  : INF;
                }
#pragma unroll
            for (int g = 0; g < HOSTS; ++g) {
                int n = 0;
#pragma unroll
                for (int k = 0; k < TALLY_CHUNKS; ++k)
                    n += __popc(__ballot_sync(TALLY_FULL,
                                              t[g][k] < DROP_T));
                if (lane == j[g]) mine += n;
            }
        }
    }
    return mine;
}

// A host's tally: whether its rows are read, their count of
// exchangeable rows, its occ_ob and aud_tx as they were.
struct TallyCount {
    bool mine;
    int n;
    int32_t ob0;
    int64_t tx0;
};

// A warp's 32 consecutive hosts, this lane's host h of replica r (rh =
// r * H) with pop count pv: the rows of the hosts to read (a nonzero pop
// count, or every host where `every`) counted, each such host's lane
// loading its occ_ob (and aud_tx) beside the rows, HOSTS rows a step
// (`count_rows`); `tally_store` writes them. Every lane of the warp
// calls it.
template <int HOSTS = TALLY_HOSTS>
__device__ __forceinline__ TallyCount tally_count(const TallyArgs& a,
                                                  int64_t rh, int64_t h,
                                                  int32_t pv, bool every,
                                                  int lane) {
    TallyCount tc{h < a.H && (every || pv != 0), 0, 0, 0};
    const unsigned need = __ballot_sync(TALLY_FULL, tc.mine);
    if (need == 0) return tc;
    const int64_t g = rh + h;
    if (tc.mine) {
        tc.ob0 = a.occ_ob[g];
        if (a.aud_tx) tc.tx0 = a.aud_tx[g];
    }
    tc.n = count_rows<HOSTS>(a.ob_t + (g - lane) * a.OB, a.OB, need, lane);
    return tc;
}

__device__ __forceinline__ void tally_store(const TallyArgs& a, int64_t g,
                                            const TallyCount& tc) {
    if (!tc.mine) return;
    if (tc.n > tc.ob0) a.occ_ob[g] = tc.n;
    if (a.aud_tx) a.aud_tx[g] = tc.tx0 + tc.n;
}

// A block's largest pop count (warp maxima through `most_w`, one word a
// warp), in thread 0; every thread calls it.
__device__ __forceinline__ int block_max(int most, int* most_w) {
    most = __reduce_max_sync(TALLY_FULL, most);
    if ((threadIdx.x & 31) == 0) most_w[threadIdx.x >> 5] = most;
    __syncthreads();
    if (threadIdx.x == 0)
        for (int i = 1; i < (int)(blockDim.x >> 5); ++i)
            if (most_w[i] > most) most = most_w[i];
    return most;
}

// The last block's close of replica r's tally, in warp 0: the largest of
// the nb partials raises occ_trips (its value `trips` as thread 0 loaded
// it before any block wrote), and the phase is counted (`phases`, the
// same).
__device__ __forceinline__ void tally_close(const TallyArgs& a, int64_t r,
                                            int nb, int32_t trips,
                                            int32_t phases) {
    const int lane = threadIdx.x & 31;
    int most = INT32_MIN;
    for (int i = lane; i < nb; i += 32) {
        const int p = __ldcg(a.partial + r * nb + i);
        if (p > most) most = p;
    }
    most = __reduce_max_sync(TALLY_FULL, most);
    if (threadIdx.x == 0) {
        if (most > trips) a.occ_trips[r] = most;
        a.occ_phases[r] = phases + 1;
    }
}

}  // namespace shadow
