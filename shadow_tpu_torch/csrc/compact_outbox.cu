// K11 compact_outbox: the outbox compaction of `outbox_compact`.
//
// Replaces two branches of shadow_tpu/device/engine.py that keep at most
// CX = min(outbox_compact, OB) exchangeable rows (t < DROP_T) of each
// sender's outbox row before the flush's sort, and count the live rows
// beyond CX into x_overflow[sender]:
//
// * the window rule, the `CX < OB` branch of `_flat_sorted`
//   (engine.py:1299-1321): a row sort by skey = dst*SPAN + okey
//   (okey = sender*OB + column), so a row keeps its CX live rows of
//   smallest (dst, column);
// * the global rule, `_compact_flat` (engine.py:1858-1878), under
//   `merge_strategy: global`: a stable row sort by t, so a row keeps its
//   CX live rows of smallest (t, column).
//
// The two keep different rows when a row overflows; the kernel is a
// template over the rule. It writes t = INF into the rows it drops, so
// that K5 route no longer sees them as exchangeable; the kept rows keep
// their flat index sender*OB + column, which is the order `_flat_sorted`
// keeps inside a destination, so K5 and K3 run unchanged and the result
// equals the reference's whenever the arrivals fit their windows. It
// runs after the occupancy marks, the audit's aud_tx ledger
// (phase_tally) and K7, which read the full judged outbox
// (engine.py:1938-1956).
//
// Only the rows that can hold an exchangeable row are read: after the
// pop, a host whose pop count is 0 holds only clear rows (t = INF,
// pop_phase.cu), which the compaction leaves as they are; so it reads
// the rows of the hosts that popped, or every row where the engine's
// outbox word says the rows came from outside the pop (a flush of rows
// copied in, whose pop counts are 0; a launch given no pop counts reads
// every row too). This is the rule of K2 (judge_outbox.cu) and
// phase_tally.cu, and the word is read as they read it. The kernel only
// removes rows (t = INF where it drops one) and adds none, so a host
// that popped nothing still holds clear rows after it: the outbox
// invariant the next pop and K2 rest on is kept.
//
// Design: a warp takes WARP_HOSTS consecutive hosts: its first lanes
// load their pop counts and a ballot says which of them to read; the
// warp reads their rows HOSTS at a time side by side, lane l columns l,
// l + 32, ... of each (KPL columns a lane, OB <= 32 * KPL), HOSTS * KPL
// loads in flight before the first is used, and a ballot a chunk counts
// a host's live rows. A row with at most CX live rows, the usual case
// (the engine compacts at the uncompacted run's largest occ_ob), costs
// that read alone. An overflowing row is ranked from the registers that
// hold it: each lane keeps the keys of its own columns, hi32(m) (an
// int32) under the window rule, m read once per live column, and t
// under the global rule; the warp broadcasts the live columns' keys in
// column order, two a step (a shuffle each), each lane counting the
// keys that rank before its own by (key, column); a column ranked CX or
// later is dropped. The row is not read again. A few hosts a warp, few
// loads in flight and at most 64 registers keep many warps resident:
// the ranking of overflowing rows is a chain of shuffles, which only
// other warps hide (PERF.md: 32 hosts a warp and 16 loads in
// flight lost to the design before on overflowing rows). Rows wider than
// 256 columns (KPL would pass 8) take a warp a host, its keys in the
// warp's shared memory, each lane ranking its columns against them
// (`compact_wide_kernel`). The replica axis of an ensemble campaign is
// blockIdx.y (replica r's rows g = r * H + h, its pop counts and outbox
// word); every launch returns where its control block's RUN word is 0
// (common.cuh `Ctl`).
//
// The design before (a warp a row reading every host's row, a lane
// ranking each of its columns by walking the row again from L1) stays
// reachable for measurement (`every_row`, Kernels.designs_before), never
// as a fallback.
//
// Bound on the H100: bytes: the pop counts of every host; t of the rows
// of the hosts that popped (every host's under the word) read (OB*8 a
// row); m read for the live columns of overflowing rows (window rule);
// t written for the dropped rows; x_overflow read and written for the
// overflowing senders.
#include <type_traits>

#include "common.cuh"

using namespace shadow;

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int MAX_OB = 32 * 64;
// the design: threads a block, a warp's hosts (lanes 0 to WARP_HOSTS - 1
// load their pop counts), the loads a lane keeps in flight over the rows
// it reads together, the blocks an SM should hold, the grid's cap, the
// widest row ranked from registers (columns a lane), and the wide
// kernel's warps a block and grid cap
constexpr int THREADS = 256;
constexpr int WARP_HOSTS = 4;
constexpr int IN_FLIGHT = 4;
constexpr int MIN_BLOCKS = 4;
constexpr int MAX_ROW_BLOCKS = 16384;
constexpr int MAX_KPL = 8;
constexpr int WIDE_WARPS = 2;
constexpr int MAX_WIDE_BLOCKS = 32768;
// the design before's
constexpr int WARPS = 8;
constexpr int MAX_BLOCKS = 2048;

struct CompactArgs {
    int H, OB, CX;
    int64_t* ob_t;
    const int64_t* ob_m;
    int32_t* x_overflow;
    const int32_t* pops;        // [R,H], or null: every row
    const int32_t* ob_word;     // [2,R] (with pops)
    const int64_t* ctl;
};

// whether replica r reads every row
__device__ __forceinline__ bool read_all(const CompactArgs& a, int64_t r) {
    return a.pops == nullptr || a.ob_word[r] != 0;
}

// whether host h of replica r (rh = r * H) has rows to read
__device__ __forceinline__ bool to_read(const CompactArgs& a, int64_t rh,
                                        int64_t h, bool every) {
    return h < a.H && (every || __ldg(a.pops + rh + h) != 0);
}

// whether the live key k2 of column (i2, s) ranks before key k of column
// (i, lane): by (key, column), column 32 i + lane
template <class Key>
__device__ __forceinline__ bool before(Key k2, int i2, int s, Key k, int i,
                                       int lane) {
    return k2 < k || (k2 == k && (i2 < i || (i2 == i && s < lane)));
}

// The overflowing row at `row` (n > CX live columns), its t in
// registers (lane l: columns 32 i + l): drop the live columns ranked CX
// or later by (key, column), and count them into the sender's
// x_overflow (`g`). Keys: t under the global rule, hi32(m) (an int32)
// under the window rule; only live columns' keys are broadcast, two a
// step.
template <bool GLOBAL, int KPL>
__device__ __forceinline__ void rank_row(const CompactArgs& a, int64_t row,
                                         const int64_t* t, int n,
                                         int64_t g, int lane) {
    using Key = typename std::conditional<GLOBAL, long long, int>::type;
    Key key[KPL];
    unsigned live[KPL];
    int rank[KPL];
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
        const int col = 32 * i + lane;
        const bool lv = col < a.OB && t[i] < DROP_T;
        live[i] = __ballot_sync(FULL, lv);
        if constexpr (GLOBAL)
            key[i] = t[i];
        else
            key[i] = lv ? hi32(__ldg(a.ob_m + row + col)) : 0;
        rank[i] = 0;
    }
#pragma unroll
    for (int i2 = 0; i2 < KPL; ++i2) {
        for (unsigned rest = live[i2]; rest != 0;) {
            const int s0 = __ffs(rest) - 1;
            rest &= rest - 1u;
            const bool two = rest != 0;
            const int s1 = two ? __ffs(rest) - 1 : s0;
            rest &= rest - 1u;
            const Key k0 = __shfl_sync(FULL, key[i2], s0);
            const Key k1 = __shfl_sync(FULL, key[i2], s1);
#pragma unroll
            for (int i = 0; i < KPL; ++i)
                rank[i] += before(k0, i2, s0, key[i], i, lane) +
                           (two && before(k1, i2, s1, key[i], i, lane));
        }
    }
#pragma unroll
    for (int i = 0; i < KPL; ++i)
        if (((live[i] >> lane) & 1u) && rank[i] >= a.CX)
            a.ob_t[row + 32 * i + lane] = INF;
    if (lane == 0) a.x_overflow[g] += n - a.CX;
}

// rows of at most 32 * KPL columns: a warp's WARP_HOSTS consecutive
// hosts, HOSTS rows a step side by side
template <bool GLOBAL, int KPL>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
compact_rows_kernel(CompactArgs a) {
    constexpr int HOSTS = IN_FLIGHT / KPL > 0 ? IN_FLIGHT / KPL : 1;
    constexpr int PER_BLOCK = THREADS / 32 * WARP_HOSTS;
    const int64_t r = blockIdx.y;
    if (phase_off(replica_ctl(a.ctl, r))) return;
    const bool every = read_all(a, r);
    const int lane = threadIdx.x & 31;
    const int64_t rh = r * a.H;
    for (int64_t b0 = (int64_t)blockIdx.x * PER_BLOCK; b0 < a.H;
         b0 += (int64_t)gridDim.x * PER_BLOCK) {
        const int64_t h0 = b0 + (threadIdx.x >> 5) * WARP_HOSTS;
        unsigned need = __ballot_sync(
            FULL, lane < WARP_HOSTS && to_read(a, rh, h0 + lane, every));
        const int64_t base = (rh + h0) * a.OB;
        while (need != 0) {
            int j[HOSTS];
#pragma unroll
            for (int q = 0; q < HOSTS; ++q) {
                j[q] = need != 0 ? __ffs(need) - 1 : -1;
                need &= need - 1u;
            }
            // the rows are rewritten only by this warp, after it has read
            // them: plain loads, not the read-only path
            int64_t t[HOSTS][KPL];
#pragma unroll
            for (int q = 0; q < HOSTS; ++q)
#pragma unroll
                for (int i = 0; i < KPL; ++i) {
                    const int col = 32 * i + lane;
                    t[q][i] = j[q] >= 0 && col < a.OB
                                  ? a.ob_t[base + (int64_t)j[q] * a.OB + col]
                                  : INF;
                }
#pragma unroll
            for (int q = 0; q < HOSTS; ++q) {
                if (j[q] < 0) break;
                int n = 0;
#pragma unroll
                for (int i = 0; i < KPL; ++i)
                    n += __popc(__ballot_sync(FULL, t[q][i] < DROP_T));
                if (n > a.CX)
                    rank_row<GLOBAL, KPL>(a, base + (int64_t)j[q] * a.OB,
                                          t[q], n, rh + h0 + j[q], lane);
            }
        }
    }
}

// rows of more than 32 * MAX_KPL columns: a warp a host, its row's keys
// in the warp's shared memory (OB words a warp)
template <bool GLOBAL>
__global__ void __launch_bounds__(32 * WIDE_WARPS)
compact_wide_kernel(CompactArgs a) {
    extern __shared__ int64_t slab_all[];
    const int64_t r = blockIdx.y;
    if (phase_off(replica_ctl(a.ctl, r))) return;
    const bool every = read_all(a, r);
    const int lane = threadIdx.x & 31;
    int64_t* slab = slab_all + (threadIdx.x >> 5) * a.OB;
    const int64_t rh = r * a.H;
    for (int64_t h = (int64_t)blockIdx.x * WIDE_WARPS + (threadIdx.x >> 5);
         h < a.H; h += (int64_t)gridDim.x * WIDE_WARPS) {
        if (!to_read(a, rh, h, every)) continue;
        const int64_t g = rh + h;
        const int64_t row = g * a.OB;
        int n = 0;
        for (int c0 = 0; c0 < a.OB; c0 += 32) {
            const int c = c0 + lane;
            const int64_t tc = c < a.OB ? a.ob_t[row + c] : INF;
            const bool lv = tc < DROP_T;
            n += __popc(__ballot_sync(FULL, lv));
            if (c < a.OB) slab[c] = lv ? tc : IMAX;
        }
        if (n > a.CX) {
            if (!GLOBAL)
                for (int c = lane; c < a.OB; c += 32)
                    if (slab[c] != IMAX)
                        slab[c] = (int64_t)hi32(__ldg(a.ob_m + row + c));
            __syncwarp();
            for (int c = lane; c < a.OB; c += 32) {
                const int64_t kc = slab[c];
                if (kc == IMAX) continue;
                int rank = 0;
                for (int c2 = 0; c2 < a.OB; ++c2) {
                    const int64_t k2 = slab[c2];
                    rank += k2 < kc || (k2 == kc && c2 < c);
                }
                if (rank >= a.CX) a.ob_t[row + c] = INF;
            }
            if (lane == 0) a.x_overflow[g] += n - a.CX;
        }
        __syncwarp();   // the slab's reads, before the next row's writes
    }
}

// the design before: a warp a row, every host's
template <bool GLOBAL>
__global__ void compact_outbox_kernel(int H, int OB, int CX,
                                      int64_t* ob_t,
                                      const int64_t* __restrict__ ob_m,
                                      int32_t* x_overflow,
                                      const int64_t* ctl) {
    const int64_t r = blockIdx.y;
    if (phase_off(replica_ctl(ctl, r))) return;
    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    for (int64_t h = (int64_t)blockIdx.x * WARPS + w; h < H;
         h += (int64_t)gridDim.x * WARPS) {
        const int64_t g = r * H + h;
        const int64_t row = g * OB;
        int live = 0;
        for (int c = lane; c < OB; c += 32) live += ob_t[row + c] < DROP_T;
        live = __reduce_add_sync(FULL, live);
        if (live <= CX) continue;
        // rank each live column this lane owns among the row's live
        // columns, by (t, column) or (dst, column)
        uint64_t drops = 0;
        for (int c = lane, i = 0; c < OB; c += 32, ++i) {
            const int64_t tc = ob_t[row + c];
            if (!(tc < DROP_T)) continue;
            const int64_t kc = GLOBAL ? tc : (int64_t)hi32(ob_m[row + c]);
            int rank = 0;
            for (int c2 = 0; c2 < OB; ++c2) {
                const int64_t t2 = ob_t[row + c2];
                if (!(t2 < DROP_T)) continue;
                const int64_t k2 =
                    GLOBAL ? t2 : (int64_t)hi32(ob_m[row + c2]);
                rank += (k2 < kc || (k2 == kc && c2 < c)) ? 1 : 0;
            }
            if (rank >= CX) drops |= uint64_t(1) << i;
        }
        __syncwarp();
        for (int c = lane, i = 0; c < OB; c += 32, ++i)
            if ((drops >> i) & 1u) ob_t[row + c] = INF;
        if (lane == 0) x_overflow[g] += live - CX;
    }
}

template <bool GLOBAL>
void launch(const CompactArgs& a, int R, cudaStream_t st) {
    const int kpl = (a.OB + 31) / 32;
    if (kpl > MAX_KPL) {
        const int64_t want = ((int64_t)a.H + WIDE_WARPS - 1) / WIDE_WARPS;
        const int nb = want < MAX_WIDE_BLOCKS ? (int)want : MAX_WIDE_BLOCKS;
        compact_wide_kernel<GLOBAL><<<dim3(nb, R), 32 * WIDE_WARPS,
                                      WIDE_WARPS * a.OB * sizeof(int64_t),
                                      st>>>(a);
        return;
    }
    constexpr int per = THREADS / 32 * WARP_HOSTS;
    const int64_t want = ((int64_t)a.H + per - 1) / per;
    const dim3 grid(want < MAX_ROW_BLOCKS ? (int)want : MAX_ROW_BLOCKS, R);
    if (kpl == 1)
        compact_rows_kernel<GLOBAL, 1><<<grid, THREADS, 0, st>>>(a);
    else if (kpl == 2)
        compact_rows_kernel<GLOBAL, 2><<<grid, THREADS, 0, st>>>(a);
    else if (kpl <= 4)
        compact_rows_kernel<GLOBAL, 4><<<grid, THREADS, 0, st>>>(a);
    else
        compact_rows_kernel<GLOBAL, 8><<<grid, THREADS, 0, st>>>(a);
}

}  // namespace

// pops and ob_word: both null (read every row) or both given
extern "C" int shadow_compact_outbox(int R, int H, int OB, int CX,
                                     int global_rule, int64_t* ob_t,
                                     const int64_t* ob_m,
                                     int32_t* x_overflow,
                                     const int32_t* pops,
                                     const int32_t* ob_word,
                                     const int64_t* ctl, int every_row,
                                     void* stream) {
    if (R < 1 || R > 65535 || OB < 1 || OB > MAX_OB || CX < 1 || CX > OB ||
        (pops == nullptr) != (ob_word == nullptr))
        return (int)cudaErrorInvalidValue;
    if (H <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    if (!every_row) {
        const CompactArgs a{H, OB, CX, ob_t, ob_m, x_overflow, pops,
                            ob_word, ctl};
        if (global_rule)
            launch<true>(a, R, st);
        else
            launch<false>(a, R, st);
        return (int)cudaGetLastError();
    }
    const int64_t want = ((int64_t)H + WARPS - 1) / WARPS;
    const int blocks = want < MAX_BLOCKS ? (int)want : MAX_BLOCKS;
    const dim3 grid(blocks, R);
    if (global_rule)
        compact_outbox_kernel<true><<<grid, 32 * WARPS, 0, st>>>(
            H, OB, CX, ob_t, ob_m, x_overflow, ctl);
    else
        compact_outbox_kernel<false><<<grid, 32 * WARPS, 0, st>>>(
            H, OB, CX, ob_t, ob_m, x_overflow, ctl);
    return (int)cudaGetLastError();
}
