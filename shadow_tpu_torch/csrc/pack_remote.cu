// K12 pack_remote: pack a mesh rank's remote rows for the all_to_all.
//
// Replaces shadow_tpu/device/engine.py `_shard_edges`, `_shard_segments`,
// `_within_shard_rank`, `_lost_to_local`, `_seg_take` and `_pack_remote`
// (engine.py:1635-1716). On the port the rank's outbox is first routed by
// K5 over the H_pad destinations of the whole mesh, so destination shard
// d's rows are the contiguous segment of destinations [d*H_loc,
// (d+1)*H_loc): it starts at starts[d*H_loc] and a row's rank is its
// position in it, in the order of the row's key dst*SPAN + src*OB +
// column (SPAN = H_pad*OB). One pass over (shard, slot) writes the [S, C,
// CAP] send buffer, shard-major so that each peer's block is contiguous
// for the collective, channels t, k, m, s, v (and the key, C = 6, which
// the window merge orders by; the global merge ships none, C = 5), with
// the reference's fills past a segment's count (t INF, k and key IMAX,
// the rest 0); the rank's own shard ships nothing (its rows bypass the
// pack as the merge's second block). Rows ranked CAP or later in a
// remote segment are lost: each adds 1 to its sender's x_overflow (the
// local row of its flat index) by an integer atomic, whose sums do not
// depend on the order. `occ_x` [1, S] takes each remote segment's count
// as its high-water mark.
//
// An ensemble campaign on the mesh (the reference's `_run_ens_shard`,
// engine.py:2285-2312, which vmaps the shard's program inside the
// shard_map) packs every replica into one buffer [S, R, C, CAP]: peer
// d's block holds each replica's C x CAP packs in turn, so that one
// collective moves every replica's rows. Replica r (blockIdx.z) reads
// its outbox rows, route, x_overflow [R, H_loc] and occ_x [R, 1, S] at
// its own offsets and returns where its control block's RUN word is 0
// (its slots keep what its last pack wrote; no rank reads them in a
// phase the replica does not run). A standalone rank is R = 1.
//
// One thread per (shard, slot, replica), a grid-stride loop past CAP over
// the lost rows. Bound on the H100: bytes (the routed rows read, five or
// six channels, and the [S, R, C, CAP] buffer written).
#include "common.cuh"

using namespace shadow;

namespace {

// shard d's segment of a route over S*H_loc destinations
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

__global__ void pack_remote_kernel(int S, int shard, int H_loc, int OB,
                                   int CAP, int C, Rows rows,
                                   const int64_t* __restrict__ perm,
                                   const int64_t* __restrict__ starts,
                                   const int64_t* __restrict__ counts,
                                   int64_t* send, int32_t* x_overflow,
                                   int32_t* occ_x, const int64_t* ctl) {
    const int d = blockIdx.y;
    const int64_t r = blockIdx.z;
    if (phase_off(replica_ctl(ctl, r))) return;
    const int64_t F = (int64_t)H_loc * OB, D = (int64_t)S * H_loc;
    perm += r * F;
    starts += r * D;
    counts += r * D;
    x_overflow += r * H_loc;
    occ_x += r * S;
    int64_t st, n;
    segment(starts, counts, S, H_loc, d, &st, &n);
    if (d == shard) n = 0;
    if (blockIdx.x == 0 && threadIdx.x == 0)
        occ_x[d] = max(occ_x[d], (int32_t)n);
    const int64_t span = (int64_t)S * H_loc * OB;
    const int64_t base = (int64_t)shard * H_loc * OB;
    int64_t* out = send + ((int64_t)d * gridDim.z + r) * C * CAP;
    const int64_t lim = n > CAP ? n : CAP;
    for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         j < lim; j += (int64_t)gridDim.x * blockDim.x) {
        if (j >= CAP) {
            // past CAP: lost, on the sender's row
            atomicAdd(&x_overflow[perm[st + j] / OB], 1);
            continue;
        }
        if (j < n) {
            const int64_t x = perm[st + j];
            const int64_t m = rows.at(CH_M, r, x);
            out[j] = rows.at(CH_T, r, x);
            out[CAP + j] = rows.at(CH_K, r, x);
            out[2 * CAP + j] = m;
            out[3 * CAP + j] = rows.at(CH_S, r, x);
            out[4 * CAP + j] = rows.at(CH_V, r, x);
            if (C > 5) out[5 * CAP + j] = (int64_t)hi32(m) * span + base + x;
        } else {
            out[j] = INF;
            out[CAP + j] = IMAX;
            out[2 * CAP + j] = 0;
            out[3 * CAP + j] = 0;
            out[4 * CAP + j] = 0;
            if (C > 5) out[5 * CAP + j] = IMAX;
        }
    }
}

}  // namespace

// R replicas (1 standalone); ctl null or [R, CTL_N].
extern "C" int shadow_pack_remote(int R, long long F, int S, int shard,
                                  int H_loc, int OB, int CAP, int C,
                                  const Rows* rows, const int64_t* perm,
                                  const int64_t* starts,
                                  const int64_t* counts, int64_t* send,
                                  int32_t* x_overflow, int32_t* occ_x,
                                  const int64_t* ctl, void* stream) {
    if (rows == nullptr || R < 1 || R > 65535 || S < 1 || S > 65535 ||
        shard < 0 || shard >= S || CAP < 1 || (C != 5 && C != 6) ||
        F != (long long)H_loc * OB || (R > 1 && rows->rs == 0))
        return (int)cudaErrorInvalidValue;
    const int threads = 256;
    int gx = (CAP + threads - 1) / threads;
    if (gx > 1024) gx = 1024;
    pack_remote_kernel<<<dim3(gx, S, R), threads, 0,
                         (cudaStream_t)stream>>>(
        S, shard, H_loc, OB, CAP, C, *rows, perm, starts, counts, send,
        x_overflow, occ_x, ctl);
    return (int)cudaGetLastError();
}
