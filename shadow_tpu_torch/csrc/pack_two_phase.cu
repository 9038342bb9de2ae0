// K13 pack_two_phase: the two hops of the two_phase exchange on a mesh
// rank.
//
// Replaces shadow_tpu/device/engine.py `_pack_two_phase` and `_tp_mask`
// (engine.py:1737-1856). The mesh's S = g * ng ranks form ng groups of g
// (device/capacity.py group_split); rank s is (group a, rank b).
//
// Phase 1 (`shadow_pack_two_phase`), from K5's route of the rank's outbox
// over the H_pad destinations (shard d's rows are the segment of
// destinations [d*H_loc, (d+1)*H_loc), in key order): buffer b of [g, 6,
// CAP] goes to the in-group peer (a, b) and holds the rows of every
// destination shard of rank b, (a', b) for a' = 0..ng-1 in turn (the
// rank's own shard ships nothing), cut at CAP: slot j lies in the group
// block a* whose range holds it. The reference keys its buffers by peer
// offset (b - my_b) % g; indexing them by the peer's rank lets one
// all_to_all_single with per-peer splits stand for its ppermutes, and the
// arrivals' order does not matter (the merge orders them by key). A row
// whose place (its rank plus the earlier groups' counts) is CAP or later
// is lost on the sending rank: 1 into its sender's x_overflow by an
// integer atomic. `occ_x` as K12's.
//
// Phase 2 (`shadow_pack_two_phase2`), from K5's keyed route of the phase-1
// arrivals over the H_pad destinations (every arrival is destined rank b:
// this shard, or (a', b) in another group, to forward): buffer i of
// [ng-1, 6, CAP2] holds the first CAP2 rows destined (a', b), a' the i-th
// other group in ascending order (the reference's buffer of group offset
// (a' - my_g) % ng). A row of another shard ranked CAP2 or later is lost
// here, at the intermediate: it adds 1 at its global source gid (key %
// SPAN) / OB to `hist` [H_pad] int32, which the mesh sums so that each
// rank adds its own hosts' counts to x_overflow (engine.py:1820-1838).
//
// Bound on the H100: bytes (the routed rows read, the buffers written).
#include "common.cuh"

using namespace shadow;

namespace {

constexpr int MAX_GROUPS = 64;   // ng (and S / g) at most

__device__ __forceinline__ void segment(const int64_t* starts,
                                        const int64_t* counts, int S,
                                        int H_loc, int d, int64_t* st,
                                        int64_t* n) {
    const int64_t s = starts[(int64_t)d * H_loc];
    const int64_t last = (int64_t)S * H_loc - 1;
    const int64_t e = d + 1 < S ? starts[(int64_t)(d + 1) * H_loc]
                                : starts[last] + counts[last];
    *st = s;
    *n = e - s;
}

// the wire row of row x (t, k, m, s, v, key), or the fills
__device__ __forceinline__ void put(int64_t* out, int64_t cap, int64_t j,
                                    const Rows& rows, int64_t x, bool ok,
                                    int64_t key) {
    out[j] = ok ? rows.at(CH_T, 0, x) : INF;
    out[cap + j] = ok ? rows.at(CH_K, 0, x) : IMAX;
    out[2 * cap + j] = ok ? rows.at(CH_M, 0, x) : 0;
    out[3 * cap + j] = ok ? rows.at(CH_S, 0, x) : 0;
    out[4 * cap + j] = ok ? rows.at(CH_V, 0, x) : 0;
    out[5 * cap + j] = ok ? key : IMAX;
}

// phase 1, buffer b = blockIdx.y
__global__ void phase1_kernel(int S, int shard, int H_loc, int OB, int G,
                              int NG, int CAP, Rows rows,
                              const int64_t* __restrict__ perm,
                              const int64_t* __restrict__ starts,
                              const int64_t* __restrict__ counts,
                              int64_t* send) {
    const int b = blockIdx.y;
    __shared__ int64_t seg_st[MAX_GROUPS], off[MAX_GROUPS + 1];
    if (threadIdx.x == 0) {
        off[0] = 0;
        for (int a = 0; a < NG; ++a) {
            const int d = a * G + b;
            int64_t st, n;
            segment(starts, counts, S, H_loc, d, &st, &n);
            if (d == shard) n = 0;
            seg_st[a] = st;
            off[a + 1] = off[a] + n;
        }
    }
    __syncthreads();
    const int64_t span = (int64_t)S * H_loc * OB;
    const int64_t base = (int64_t)shard * H_loc * OB;
    int64_t* out = send + (int64_t)b * 6 * CAP;
    for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         j < CAP; j += (int64_t)gridDim.x * blockDim.x) {
        const bool ok = j < off[NG];
        int a = 0;
        while (a < NG - 1 && off[a + 1] <= j) ++a;
        const int64_t x = ok ? perm[seg_st[a] + (j - off[a])] : 0;
        const int64_t key =
            ok ? (int64_t)hi32(rows.at(CH_M, 0, x)) * span + base + x : IMAX;
        put(out, CAP, j, rows, x, ok, key);
    }
}

// phase 1's loss and occ_x, shard d = blockIdx.y
__global__ void phase1_lost_kernel(int S, int shard, int H_loc, int OB,
                                   int G, int CAP,
                                   const int64_t* __restrict__ perm,
                                   const int64_t* __restrict__ starts,
                                   const int64_t* __restrict__ counts,
                                   int32_t* x_overflow, int32_t* occ_x) {
    const int d = blockIdx.y;
    int64_t st, n;
    segment(starts, counts, S, H_loc, d, &st, &n);
    if (d == shard) n = 0;
    if (blockIdx.x == 0 && threadIdx.x == 0)
        occ_x[d] = max(occ_x[d], (int32_t)n);
    // the rows of earlier groups of d's rank in the same buffer
    int64_t before = 0;
    for (int a = 0; a < d / G; ++a) {
        const int e = a * G + d % G;
        int64_t s2, n2;
        segment(starts, counts, S, H_loc, e, &s2, &n2);
        if (e != shard) before += n2;
    }
    const int64_t first = CAP - before > 0 ? CAP - before : 0;
    for (int64_t j = first + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         j < n; j += (int64_t)gridDim.x * blockDim.x)
        atomicAdd(&x_overflow[perm[st + j] / OB], 1);
}

// phase 2, buffer i = blockIdx.y
__global__ void phase2_kernel(int S, int shard, int H_loc, int G, int CAP2,
                              Rows rows, const int64_t* __restrict__ perm,
                              const int64_t* __restrict__ starts,
                              const int64_t* __restrict__ counts,
                              int64_t* send) {
    const int i = blockIdx.y;
    const int my_g = shard / G, my_b = shard % G;
    const int a = i + (i >= my_g ? 1 : 0);
    int64_t st, n;
    segment(starts, counts, S, H_loc, a * G + my_b, &st, &n);
    int64_t* out = send + (int64_t)i * 6 * CAP2;
    for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         j < CAP2; j += (int64_t)gridDim.x * blockDim.x) {
        const bool ok = j < n;
        const int64_t x = ok ? perm[st + j] : 0;
        put(out, CAP2, j, rows, x, ok, ok ? rows.at(CH_KEY, 0, x) : IMAX);
    }
}

// phase 2's loss by global source, shard d = blockIdx.y
__global__ void phase2_lost_kernel(int S, int shard, int H_loc, int OB,
                                   int CAP2, Rows rows,
                                   const int64_t* __restrict__ perm,
                                   const int64_t* __restrict__ starts,
                                   const int64_t* __restrict__ counts,
                                   int32_t* hist) {
    const int d = blockIdx.y;
    if (d == shard) return;
    int64_t st, n;
    segment(starts, counts, S, H_loc, d, &st, &n);
    const int64_t span = (int64_t)S * H_loc * OB;
    for (int64_t j = CAP2 + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         j < n; j += (int64_t)gridDim.x * blockDim.x) {
        const int64_t key = rows.at(CH_KEY, 0, perm[st + j]);
        atomicAdd(&hist[(key % span) / OB], 1);
    }
}

bool groups_ok(int S, int shard, int G, int NG) {
    return S >= 1 && S <= 65535 && shard >= 0 && shard < S && G >= 1 &&
           NG >= 1 && G * NG == S && NG <= MAX_GROUPS && G <= 65535;
}

}  // namespace

extern "C" int shadow_pack_two_phase(long long F, int S, int shard,
                                     int H_loc, int OB, int G, int NG,
                                     int CAP, const Rows* rows,
                                     const int64_t* perm,
                                     const int64_t* starts,
                                     const int64_t* counts, int64_t* send,
                                     int32_t* x_overflow, int32_t* occ_x,
                                     void* stream) {
    if (rows == nullptr || !groups_ok(S, shard, G, NG) || CAP < 1 ||
        F != (long long)H_loc * OB)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int threads = 256;
    int gx = (CAP + threads - 1) / threads;
    if (gx > 1024) gx = 1024;
    phase1_kernel<<<dim3(gx, G), threads, 0, st>>>(
        S, shard, H_loc, OB, G, NG, CAP, *rows, perm, starts, counts, send);
    phase1_lost_kernel<<<dim3(gx, S), threads, 0, st>>>(
        S, shard, H_loc, OB, G, CAP, perm, starts, counts, x_overflow,
        occ_x);
    return (int)cudaGetLastError();
}

extern "C" int shadow_pack_two_phase2(long long F, int S, int shard,
                                      int H_loc, int OB, int G, int NG,
                                      int CAP2, const Rows* rows,
                                      const int64_t* perm,
                                      const int64_t* starts,
                                      const int64_t* counts, int64_t* send,
                                      int32_t* hist, void* stream) {
    if (rows == nullptr || !groups_ok(S, shard, G, NG) || CAP2 < 1 ||
        rows->a[CH_KEY] == nullptr || F < 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int threads = 256;
    int gx = (CAP2 + threads - 1) / threads;
    if (gx > 1024) gx = 1024;
    if (NG > 1)
        phase2_kernel<<<dim3(gx, NG - 1), threads, 0, st>>>(
            S, shard, H_loc, G, CAP2, *rows, perm, starts, counts, send);
    phase2_lost_kernel<<<dim3(gx, S), threads, 0, st>>>(
        S, shard, H_loc, OB, CAP2, *rows, perm, starts, counts, hist);
    return (int)cudaGetLastError();
}
