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
// One warp owns one sender row; its lanes read the row's columns side
// by side (coalesced). A row with at most CX live rows, the usual case,
// costs one read of its t column and a warp reduction. An overflowing
// row ranks each live column among the row's live columns (a lane walks
// the row once per column it owns, the row being broadcast from L1),
// collects its drops in a 64-bit mask (OB <= 2048), and writes them
// after __syncwarp, so that no lane reads a t another lane has
// rewritten. The replica axis of an ensemble campaign is blockIdx.y;
// every launch returns where its control block's RUN word is 0
// (common.cuh `Ctl`).
//
// Bound on the H100: bytes: t of every outbox row read (H*OB*8), m read
// for the live columns of overflowing rows (window rule), t written for
// the dropped rows, x_overflow read and written for the overflowing
// senders.
#include "common.cuh"

using namespace shadow;

namespace {

constexpr int WARPS = 8;
constexpr int MAX_BLOCKS = 2048;
constexpr int MAX_OB = 32 * 64;

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
        live = __reduce_add_sync(0xFFFFFFFFu, live);
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

}  // namespace

extern "C" int shadow_compact_outbox(int R, int H, int OB, int CX,
                                     int global_rule, int64_t* ob_t,
                                     const int64_t* ob_m,
                                     int32_t* x_overflow,
                                     const int64_t* ctl, void* stream) {
    if (R < 1 || R > 65535 || OB < 1 || OB > MAX_OB || CX < 1 || CX > OB)
        return (int)cudaErrorInvalidValue;
    if (H > 0) {
        const int64_t want = ((int64_t)H + WARPS - 1) / WARPS;
        const int blocks = want < MAX_BLOCKS ? (int)want : MAX_BLOCKS;
        const dim3 grid(blocks, R);
        if (global_rule)
            compact_outbox_kernel<true><<<grid, 32 * WARPS, 0,
                                          (cudaStream_t)stream>>>(
                H, OB, CX, ob_t, ob_m, x_overflow, ctl);
        else
            compact_outbox_kernel<false><<<grid, 32 * WARPS, 0,
                                           (cudaStream_t)stream>>>(
                H, OB, CX, ob_t, ob_m, x_overflow, ctl);
    }
    return (int)cudaGetLastError();
}
