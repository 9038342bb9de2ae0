// Shared constants and bit helpers of the port's CUDA kernels.
//
// The encodings are the reference engine's (shadow_tpu/device/engine.py):
// heap and outbox rows are packed int64 words, `hi32`/`lo32` split a word
// into two int32 halves, and INF/DROP_T/IMAX are its sentinels.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace shadow {

constexpr int64_t INF = int64_t(1) << 62;
constexpr int64_t DROP_T = INF - 1;
constexpr int64_t IMAX = INT64_MAX;

constexpr int32_t KIND_BOOT = 0;
constexpr int32_t KIND_PACKET = 2;

constexpr uint32_t PURPOSE_PACKET_DROP = 1;
constexpr uint32_t PURPOSE_APP = 3;

// trace checksum (utils/checksum.py), folded in uint64: signed overflow
// is undefined in C++, and the 63-bit mask commutes with the wrap
constexpr uint64_t MASK63 = (uint64_t(1) << 63) - 1;
constexpr uint64_t CHK_MUL = 1000003ull;
constexpr uint64_t CHK_SRC = 2654435761ull;
constexpr uint64_t CHK_KIND = 1315423911ull;
constexpr uint64_t CHK_SEQ = 2246822519ull;

// The window loop's control block (device/kernels.py CTL_FIELDS, in
// this order): one int64 word each. The loop's kernels read the window
// end from it; RUN says whether the slot's phase runs (every kernel of
// a phase returns at once where it is 0, so a slot after DONE changes no
// byte of state) and ROUND_END whether the round-end audit runs.
enum Ctl : int {
    CTL_WIN_END = 0,
    CTL_STOP,
    CTL_FINAL_STOP,
    CTL_LOOKAHEAD,
    CTL_MAX_ROUNDS,
    CTL_NXT,
    CTL_ROUNDS,
    CTL_PHASES,
    CTL_DONE,
    CTL_RUN,
    CTL_ROUND_END,
    CTL_N
};

// A launch given no control block always runs; one given a block runs
// only while its RUN word is set.
__device__ __forceinline__ bool phase_off(const int64_t* ctl) {
    return ctl != nullptr && ctl[CTL_RUN] == 0;
}

// Ensemble campaigns: R replicas of the state, [R, H, ...], and one
// control block each, [R, CTL_N]. Every kernel takes the replica as a
// grid dimension (blockIdx.y, or blockIdx.z where y is taken), offsets
// each pointer once by the replica's stride, and returns where that
// replica's RUN word is 0: a finished replica changes no byte while the
// others run on. A standalone run is R = 1.
__device__ __forceinline__ const int64_t* replica_ctl(const int64_t* ctl,
                                                     int64_t r) {
    return ctl == nullptr ? nullptr : ctl + r * CTL_N;
}

// A grid-wide reduction in one launch (K9, phase_tally): each block
// writes its partial, then takes a ticket; the last block of a replica
// to take one reduces the partials (read with __ldcg, from L2). A ticket
// is one atomic add with release order at device scope (the block's
// partial before it); the block that finds itself last then fences, so
// that every block's partial is visible to it. The add does not order
// the block's later loads, so the block goes on with other work while
// it is in flight (`ticket_take`, then `ticket_last` on its result).
// The tickets have two levels, so that no word takes more than
// TICKET_GROUP atomics a launch: a block counts itself into its group's
// word, the last block of a group into the replica's word (a grid of at
// most TICKET_GROUP blocks takes one level). Each word is set back to 0
// by the block that takes its last ticket, so the next launch (a graph
// replay) needs no memset. A replica's tickets are ticket_words(nb)
// unsigned words (a word a 32-byte sector), zero before the first
// launch.
constexpr int TICKET_GROUP = 128;
constexpr int TICKET_STRIDE = 8;

__host__ __device__ __forceinline__ int ticket_words(int nb) {
    return TICKET_STRIDE * (1 + (nb + TICKET_GROUP - 1) / TICKET_GROUP);
}

__device__ __forceinline__ unsigned ticket_add(unsigned* word) {
    unsigned old;
    asm volatile("atom.release.gpu.add.u32 %0, [%1], 1;"
                 : "=r"(old) : "l"(word) : "memory");
    return old;
}

// Thread 0 of a block, after writing the block's partial: counts the
// block into its group's word; returns the count before it.
__device__ __forceinline__ unsigned ticket_take(unsigned* tk) {
    return ticket_add(tk + TICKET_STRIDE * (1 + blockIdx.x / TICKET_GROUP));
}

// Thread 0, with ticket_take's count: whether its block is the
// replica's last (which has then acquired every block's partial); the
// caller shares that with the block (__syncthreads) before the block
// reads the partials.
__device__ __forceinline__ bool ticket_last(unsigned* tk, int nb,
                                            unsigned taken) {
    const int g = blockIdx.x / TICKET_GROUP;
    const int ng = (nb + TICKET_GROUP - 1) / TICKET_GROUP;
    const int in_g = min(TICKET_GROUP, nb - g * TICKET_GROUP);
    if (taken != (unsigned)(in_g - 1)) return false;
    tk[TICKET_STRIDE * (1 + g)] = 0;
    if (ng > 1) {
        __threadfence();    // the group's partials, before the next level
        if (ticket_add(tk) != (unsigned)(ng - 1)) return false;
        *tk = 0;
    }
    __threadfence();        // every partial, before the caller reads them
    return true;
}

// The rows a route, a pack or the merge reads (device/kernels.py `Rows`):
// one or two regions, each a base per channel (t, k, m, s, v, key; null
// where the region lacks one), its block width and the stride between
// its blocks; a region of one block (an outbox, its rows the flat index
// h*OB + column) has stride 0. Row i < n_a lies in the first region,
// row n_a + i in the second. Replica r's channels of the first region
// start rs * r elements on, of the second rs_b * r (an ensemble
// campaign's outbox, or a mesh rank's wire buffers [nb, R, C, bw], whose
// replica lies inside each peer's block).
enum Chan : int { CH_T = 0, CH_K, CH_M, CH_S, CH_V, CH_KEY, CH_N };

struct Rows {
    const int64_t* a[CH_N];
    long long n_a, bw_a, bs_a;
    const int64_t* b[CH_N];
    long long bw_b, bs_b;
    long long rs, rs_b;

    // rows are read-only while a kernel reads them: through the
    // read-only data cache (__ldg), as the __restrict__ pointers of the
    // kernels before these views were
    __device__ __forceinline__ int64_t at(int c, int64_t r,
                                          int64_t i) const {
        if (i < n_a) {
            const int64_t* p = a[c] + r * rs;
            if (bs_a == 0) return __ldg(p + i);
            const int64_t blk = i / bw_a;
            return __ldg(p + blk * bs_a + (i - blk * bw_a));
        }
        i -= n_a;
        const int64_t blk = i / bw_b;
        return __ldg(b[c] + r * rs_b + blk * bs_b + (i - blk * bw_b));
    }
};

// A `Rows` view of one outbox region (stride 0, no second region): its
// channels as plain pointers, replica r's rows rs elements on. Kernels
// that read an outbox take it in place of `Rows`, as the one-device path
// did before the mesh: the same loads, no branch on the region.
struct OutboxRows {
    const int64_t* a[CH_N];
    long long rs;

    __host__ __device__ explicit OutboxRows(const Rows& r) : rs(r.rs) {
        for (int c = 0; c < CH_N; ++c) a[c] = r.a[c];
    }
    __device__ __forceinline__ int64_t at(int c, int64_t r,
                                          int64_t i) const {
        return __ldg(a[c] + r * rs + i);
    }
};

// whether a Rows view is one outbox region of F rows a replica
inline bool is_outbox(const Rows& r, long long F) {
    return r.bs_a == 0 && r.n_a == F;
}

__device__ __forceinline__ int64_t pack2(uint32_t hi, uint32_t lo) {
    return (int64_t)(((uint64_t)hi << 32) | (uint64_t)lo);
}
__device__ __forceinline__ int32_t hi32(int64_t x) {
    return (int32_t)(uint32_t)((uint64_t)x >> 32);
}
__device__ __forceinline__ int32_t lo32(int64_t x) {
    return (int32_t)(uint32_t)(uint64_t)x;
}

}  // namespace shadow
