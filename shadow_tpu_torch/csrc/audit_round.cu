// K8 audit_round: the state audit's round-end health word.
//
// Replaces shadow_tpu/device/engine.py `_audit_round` (engine.py:
// 2072-2108) with `_axis_sum64` on one device (a plain sum). Per host:
// AUD_HEAP where the heap rows are out of (t, key) order or head lies
// outside [0, E]; AUD_COUNTER where n_exec, n_sent, n_drop, n_deliv,
// event_seq, packet_seq or app_seq is negative. Globally, event-row
// conservation: sum(aud_tx) - (sum(n_exec) + live rows (slots >= head
// with t < INF) + sum(overflow) + sum(x_overflow)), in int64; where it
// is not 0, every host's word takes AUD_CONSERVE, as the reference
// broadcasts its verdict. Bits are ORed into `aud`, never cleared.
//
// Design: the first kernel gives one warp to one host: its lanes read
// the row's slots side by side (coalesced), each comparing slot j with
// slot j+1 (a key is read only where two times tie), `__all_sync` and a
// warp sum give the order verdict and the live count; lane 0 writes the
// word where a bit is set and adds the host's share of the balance to a
// block total, which one 64-bit atomicAdd a block adds to a device
// scalar (integer sums are exact in any order). A second kernel reads
// that scalar and, where it is not 0, ORs AUD_CONSERVE into every word.
// Under the window loop both return at once unless the control block's
// ROUND_END word is set (common.cuh `Ctl`): the audit runs once per
// round, at its end.
//
// The replica axis of an ensemble campaign is blockIdx.y of both
// kernels: replica r's blocks audit its hosts (rows g = r * H + h) under
// its control block's ROUND_END, and its row balance is its own int64
// sum, sum[r]; the pointers stay kernel parameters.
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
constexpr int WARPS = 8;
constexpr int MAX_BLOCKS = 2048;

struct Counters {
    const int32_t *n_exec, *n_sent, *n_drop, *n_deliv, *event_seq,
        *packet_seq, *app_seq, *overflow, *x_overflow;
};

__device__ __forceinline__ bool skip(const int64_t* ctl) {
    return ctl != nullptr && ctl[CTL_ROUND_END] == 0;
}

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
        ok = __all_sync(0xFFFFFFFFu, ok);
        live = __reduce_add_sync(0xFFFFFFFFu, live);
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

__global__ void audit_conserve_kernel(int H, int32_t* aud,
                                      const unsigned long long* sum,
                                      const int64_t* ctl) {
    const int64_t r = blockIdx.y;
    if (skip(replica_ctl(ctl, r)) || sum[r] == 0) return;
    for (int64_t h = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; h < H;
         h += (int64_t)gridDim.x * blockDim.x)
        aud[r * H + h] |= AUD_CONSERVE;
}

}  // namespace

extern "C" int shadow_audit_round(
    int R, int H, int E, const int64_t* ht, const int64_t* hk,
    const int32_t* head,
    const int32_t* n_exec, const int32_t* n_sent, const int32_t* n_drop,
    const int32_t* n_deliv, const int32_t* event_seq,
    const int32_t* packet_seq, const int32_t* app_seq,
    const int32_t* overflow, const int32_t* x_overflow,
    const int64_t* aud_tx, int32_t* aud, int64_t* sum, const int64_t* ctl,
    void* stream) {
    // sum holds R int64
    if (R < 1 || R > 65535) return (int)cudaErrorInvalidValue;
    if (H <= 0 || E <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(sum, 0, sizeof(int64_t) * R, st);
    if (err != cudaSuccess) return (int)err;
    const Counters c{n_exec, n_sent, n_drop, n_deliv, event_seq,
                     packet_seq, app_seq, overflow, x_overflow};
    const int64_t want = ((int64_t)H + WARPS - 1) / WARPS;
    const int blocks = want < MAX_BLOCKS ? (int)want : MAX_BLOCKS;
    audit_hosts_kernel<<<dim3(blocks, R), 32 * WARPS, 0, st>>>(
        H, E, ht, hk, head, c, aud_tx, aud, (unsigned long long*)sum, ctl);
    const int64_t want2 = ((int64_t)H + 255) / 256;
    audit_conserve_kernel<<<dim3(want2 < MAX_BLOCKS ? (int)want2
                                                    : MAX_BLOCKS, R),
                            256, 0, st>>>(
        H, aud, (const unsigned long long*)sum, ctl);
    return (int)cudaGetLastError();
}
