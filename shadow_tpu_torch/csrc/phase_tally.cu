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
// Bound on the H100: bytes: t of every outbox row (H*OB*8) read, pops
// [H] read, occ_ob [H] read and written, aud_tx [H] read and written
// under the audit. One warp owns one host and its lanes read the row's
// columns side by side (coalesced), summed by a warp reduction; each
// block takes the largest pop count of its hosts and adds it with one
// atomicMax; block 0 counts the phase. A grid of at most 2,048 blocks
// strides over the hosts. The replica axis of an ensemble campaign is
// blockIdx.y: replica r's blocks read its rows g = r * H + h of the
// outbox and pop counts and keep its own marks (occ_trips and
// occ_phases are [R, 1]); the pointers stay kernel parameters.
#include "common.cuh"

using namespace shadow;

namespace {

constexpr int WARPS = 8;
constexpr int MAX_BLOCKS = 2048;

__global__ void phase_tally_kernel(int H, int OB,
                                   const int64_t* __restrict__ ob_t,
                                   const int32_t* __restrict__ pops,
                                   int32_t* occ_ob, int32_t* occ_trips,
                                   int32_t* occ_phases, int64_t* aud_tx,
                                   const int64_t* ctl) {
    const int64_t r = blockIdx.y;
    if (phase_off(replica_ctl(ctl, r))) return;
    const int64_t rh = r * H;
    __shared__ int trips;
    if (threadIdx.x == 0) trips = 0;
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    int most = 0;
    for (int64_t h = (int64_t)blockIdx.x * WARPS + w; h < H;
         h += (int64_t)gridDim.x * WARPS) {
        const int64_t g = rh + h;
        const int64_t row = g * OB;
        int n = 0;
        for (int c = lane; c < OB; c += 32) n += ob_t[row + c] < DROP_T;
        n = __reduce_add_sync(0xFFFFFFFFu, n);
        if (lane == 0) {
            if (n > occ_ob[g]) occ_ob[g] = n;
            if (aud_tx) aud_tx[g] += n;
            if (pops[g] > most) most = pops[g];
        }
    }
    if (lane == 0) atomicMax(&trips, most);
    __syncthreads();
    if (threadIdx.x == 0) {
        atomicMax(&occ_trips[r], trips);
        if (blockIdx.x == 0) occ_phases[r] += 1;
    }
}

}  // namespace

extern "C" int shadow_phase_tally(int R, int H, int OB,
                                  const int64_t* ob_t,
                                  const int32_t* pops, int32_t* occ_ob,
                                  int32_t* occ_trips, int32_t* occ_phases,
                                  int64_t* aud_tx, const int64_t* ctl,
                                  void* stream) {
    if (R < 1 || R > 65535) return (int)cudaErrorInvalidValue;
    if (H > 0) {
        const int64_t want = ((int64_t)H + WARPS - 1) / WARPS;
        const int blocks = want < MAX_BLOCKS ? (int)want : MAX_BLOCKS;
        phase_tally_kernel<<<dim3(blocks, R), 32 * WARPS, 0,
                             (cudaStream_t)stream>>>(
            H, OB, ob_t, pops, occ_ob, occ_trips, occ_phases, aud_tx, ctl);
    }
    return (int)cudaGetLastError();
}
