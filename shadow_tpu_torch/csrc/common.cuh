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
