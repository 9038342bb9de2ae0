// Threefry-2x32 counter RNG as device functions: the same algorithm, bit
// for bit, as shadow_tpu/device/prng.py (threefry2x32, fold_in,
// random_bits32, uniform01, purpose_id_key) and its torch port
// (shadow_tpu_torch/device/prng.py). Keys chain seed -> purpose -> id ->
// seq; each fold is threefry(k, (0, data)). A bit-exact simulation needs
// these bits, so no other generator stands in.
#pragma once
#include <cstdint>

namespace shadow {

struct Key {
    uint32_t a, b;
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k1, uint32_t k2,
                                             uint32_t& x0, uint32_t& x1) {
    const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
    const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
    x0 += ks[0];
    x1 += ks[1];
#pragma unroll
    for (int block = 0; block < 5; ++block) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            x0 += x1;
            x1 = rotl32(x1, rot[block % 2][i]) ^ x0;
        }
        x0 += ks[(block + 1) % 3];
        x1 += ks[(block + 2) % 3] + (uint32_t)(block + 1);
    }
}

__device__ __forceinline__ Key fold_in(Key k, uint32_t data) {
    uint32_t x0 = 0, x1 = data;
    threefry2x32(k.a, k.b, x0, x1);
    return Key{x0, x1};
}

__device__ __forceinline__ uint32_t random_bits32(Key k) {
    uint32_t x0 = 0, x1 = 0;
    threefry2x32(k.a, k.b, x0, x1);
    return x0 ^ x1;
}

// uniform in [0, 1): (bits >> 9) | 0x3F800000 read as float32, minus 1
__device__ __forceinline__ float uniform01(Key k) {
    const uint32_t bits = random_bits32(k);
    return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ Key purpose_id_key(Key seed, uint32_t purpose,
                                              uint32_t id) {
    return fold_in(fold_in(seed, purpose), id);
}

// A replica's seed key, from the campaign's [R, 2] int64 key words
// (ensemble/spec.py `seed_key_np`; [1, 2] for a standalone run).
__device__ __forceinline__ Key replica_seed(const int64_t* key, int64_t r) {
    return Key{(uint32_t)key[2 * r], (uint32_t)key[2 * r + 1]};
}

}  // namespace shadow
