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
// Design: a grid-strided minimum over hosts, one partial a block (at
// most 1,024 blocks, no atomics), then one block that reduces the
// partials and takes the decisions in thread 0. An ensemble campaign
// (shadow_tpu/device/engine.py `_run_ens_shard`, which vmaps `_run_shard`
// over the replicas) has one control block per replica, [R, CTL_N]: the
// replica is blockIdx.y of the minimum's grid (partials [R, nblocks]) and
// blockIdx.x of the decisions' grid, one block per replica on its own
// control block, so a finished replica stays DONE while the others run
// on, as the vmapped while_loop freezes a finished replica's carry.
// Bound on the H100: bytes: head [H] int32 and one heap time per host
// (H*12 bytes a replica); the heap time is one 8-byte load per host
// row, so the rows' stride of E*8 bytes makes every load its own
// 32-byte sector.
#include "common.cuh"

using namespace shadow;

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 1024;

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
    if (threadIdx.x != 0) return;
    ctl[CTL_NXT] = m;
    ctl[CTL_ROUND_END] = 0;
    if (!start) {
        ctl[CTL_PHASES] += 1;
        if (m < ctl[CTL_WIN_END]) {     // the window goes on
            ctl[CTL_RUN] = 1;
            return;
        }
        ctl[CTL_ROUNDS] += 1;
        ctl[CTL_ROUND_END] = 1;
    }
    if (m >= ctl[CTL_STOP] || ctl[CTL_ROUNDS] >= ctl[CTL_MAX_ROUNDS]) {
        ctl[CTL_DONE] = 1;
        ctl[CTL_RUN] = 0;
        return;
    }
    const int64_t end = m + ctl[CTL_LOOKAHEAD];
    ctl[CTL_WIN_END] =
        end < ctl[CTL_FINAL_STOP] ? end : ctl[CTL_FINAL_STOP];
    ctl[CTL_RUN] = 1;
}

}  // namespace

// `partial` holds at least loop_control_blocks(H) int64 a replica.
extern "C" int shadow_loop_control_blocks(int H) {
    const int want = (H + THREADS - 1) / THREADS;
    return want < 1 ? 1 : (want < MAX_BLOCKS ? want : MAX_BLOCKS);
}

extern "C" int shadow_loop_control(int R, int H, int E, const int64_t* ht,
                                   const int32_t* head, int64_t* partial,
                                   int64_t* ctl, int start, void* stream) {
    if (R < 1 || R > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int nb = shadow_loop_control_blocks(H);
    head_min_kernel<<<dim3(nb, R), THREADS, 0, st>>>(H, E, ht, head,
                                                     partial, ctl);
    control_kernel<<<R, MAX_BLOCKS, 0, st>>>(nb, partial, ctl, start);
    return (int)cudaGetLastError();
}
