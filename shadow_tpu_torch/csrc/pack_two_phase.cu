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
// The send buffers are kept between phases (the engine allocates them
// once and this kernel is their only writer), each with a device word:
// the slots its last pack filled with rows. A pack writes its n rows
// into [0, n) and the fills (t INF, k and key IMAX, the rest 0) into
// [n, n_prev) alone: the slots past both hold the fills already. After
// every pack the buffer is byte for byte what a pack into a fresh buffer
// writes. A buffer's word starts at its capacity (every slot unknown);
// a launch given no words fills every slot and keeps none.
//
// An ensemble campaign on the mesh (the reference's vmapped
// `_run_ens_shard`) packs every replica at once: the buffers are [g, R,
// 6, CAP] and [ng-1, R, 6, CAP2] (each peer's block holds every
// replica's rows, so that one collective a hop moves them all), a (buffer,
// replica) pair q = b * R + r keeps its own fill word and tickets
// (`filled` [g, R] / [ng-1, R]), and replica r (blockIdx.z) reads its own
// outbox rows or arrivals, route, x_overflow [R, H_loc], occ_x [R, 1, S]
// and `hist` [R, H_pad]. A replica whose control block's RUN word is 0
// returns at once: its buffers and fill words stay as its last pack left
// them, which is what its next pack reads. A standalone rank is R = 1.
//
// Design: one launch a half, grid (blocks, buffers [+ 1], replicas). Every block
// of buffer b computes b's segments (a thread a group) and their offsets
// (a warp's scan) into shared memory and walks the slots [0, max(n_raw,
// n_prev)): a row's group by a binary search over the offsets, the
// buffer's slots below its capacity written (a row or a fill), the slots
// past it lost (n_raw is the buffer's rows before the cut). Block 0 of
// each buffer raises occ_x for its shards (phase 1); phase 2's last row
// of blocks counts the loss of the other shards of this rank's
// arrivals, which the route gives none of where the inputs are a real
// mesh's. Each block reads its buffer's word first and takes a ticket
// (common.cuh `ticket_take`), whose answer it waits for after its slots:
// the buffer's last block writes the new word, after every block of the
// buffer has read the old one (`FillWord`).
//
// The design before (every slot written by a kernel a half, thread 0
// walking the groups, a linear search a slot, and a loss kernel over a
// grid a shard) stays reachable for measurement (`before`,
// Kernels.designs_before), never as a fallback.
//
// Bound on the H100: bytes: the routed rows read (their perm entry and
// five channels, phase 2 also the key), the slots [0, max(n, n_prev))
// written (six channels), each lost row's perm entry (and key) read and
// its counter written, the segment bounds.
#include "common.cuh"

using namespace shadow;

namespace {

constexpr int MAX_GROUPS = 64;   // ng (and S / g) at most
constexpr int THREADS = 256;

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
                                    const Rows& rows, int64_t r, int64_t x,
                                    bool ok, int64_t key) {
    out[j] = ok ? rows.at(CH_T, r, x) : INF;
    out[cap + j] = ok ? rows.at(CH_K, r, x) : IMAX;
    out[2 * cap + j] = ok ? rows.at(CH_M, r, x) : 0;
    out[3 * cap + j] = ok ? rows.at(CH_S, r, x) : 0;
    out[4 * cap + j] = ok ? rows.at(CH_V, r, x) : 0;
    out[5 * cap + j] = ok ? key : IMAX;
}

// A buffer's groups in shared memory: group a's rows are the slots
// [off[a], off[a+1]) of the buffer before the cut, from perm[st[a]] on.
struct Groups {
    int64_t st[MAX_GROUPS];
    int64_t off[MAX_GROUPS + 1];
};

// The offsets from the groups' counts n[0..ng) (in off[1..ng]), by warp
// 0: two groups a lane, an inclusive scan of the pairs.
__device__ __forceinline__ void scan_groups(Groups& gr, int ng) {
    if (threadIdx.x >= 32) return;
    const int l = threadIdx.x;
    const int64_t v0 = 2 * l < ng ? gr.off[2 * l + 1] : 0;
    const int64_t v1 = 2 * l + 1 < ng ? gr.off[2 * l + 2] : 0;
    int64_t s = v0 + v1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int64_t x = __shfl_up_sync(0xFFFFFFFFu, s, o);
        if (l >= o) s += x;
    }
    __syncwarp();
    if (2 * l < ng) gr.off[2 * l + 1] = s - v1;
    if (2 * l + 1 < ng) gr.off[2 * l + 2] = s;
    if (l == 0) gr.off[0] = 0;
}

// the group of slot j < off[ng]: the first a with off[a+1] > j
__device__ __forceinline__ int group_of(const Groups& gr, int ng,
                                        int64_t j) {
    int lo = 0, hi = ng - 1;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (gr.off[mid + 1] <= j) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// A kept buffer's fill word, read and rewritten by thread 0 of each of
// its blocks: `open` reads the word as the last pack left it (at most
// the capacity; the capacity where the launch keeps no words) and takes
// the block's ticket, whose answer thread 0 waits for only in `close`,
// after the block's slots; there the buffer's last block writes the new
// word, after every block of the buffer has read the old one.
struct FillWord {
    int32_t* word;      // null: no words kept
    unsigned* tk;
    unsigned taken;

    __device__ __forceinline__ FillWord(int32_t* filled, unsigned* tickets,
                                        int b)
        : word(filled == nullptr ? nullptr : filled + b),
          tk(filled == nullptr
                 ? nullptr
                 : tickets + (int64_t)b * ticket_words(gridDim.x)),
          taken(0) {}

    __device__ __forceinline__ int64_t open(int64_t cap) {
        if (word == nullptr) return cap;
        const int64_t prev = *word < cap ? *word : cap;
        taken = ticket_take(tk);
        return prev;
    }

    __device__ __forceinline__ void close(int64_t n) {
        if (word != nullptr && ticket_last(tk, gridDim.x, taken))
            *word = (int32_t)n;
    }
};

// phase 1, buffer b = blockIdx.y
__global__ void __launch_bounds__(THREADS)
pack1_kernel(int S, int shard, int H_loc, int OB, int G, int NG, int CAP,
             Rows rows, const int64_t* __restrict__ perm,
             const int64_t* __restrict__ starts,
             const int64_t* __restrict__ counts, int64_t* send,
             int32_t* x_overflow, int32_t* occ_x, int32_t* filled,
             unsigned* tickets, const int64_t* ctl) {
    const int b = blockIdx.y;
    const int64_t r = blockIdx.z;
    if (phase_off(replica_ctl(ctl, r))) return;
    const int64_t q = (int64_t)b * gridDim.z + r;
    const int64_t D = (int64_t)S * H_loc;
    perm += r * H_loc * OB;
    starts += r * D;
    counts += r * D;
    x_overflow += r * H_loc;
    occ_x += r * S;
    __shared__ Groups gr;
    __shared__ int64_t prev;
    FillWord fw(filled, tickets, q);
    if (threadIdx.x < NG) {
        const int a = threadIdx.x;
        const int d = a * G + b;
        int64_t st, n;
        segment(starts, counts, S, H_loc, d, &st, &n);
        if (d == shard) n = 0;
        gr.st[a] = st;
        gr.off[a + 1] = n;
        if (blockIdx.x == 0) occ_x[d] = max(occ_x[d], (int32_t)n);
    }
    if (threadIdx.x == 0) prev = fw.open(CAP);
    __syncthreads();
    scan_groups(gr, NG);
    __syncthreads();
    const int64_t raw = gr.off[NG];
    const int64_t hi = raw > prev ? raw : prev;
    const int64_t span = (int64_t)S * H_loc * OB;
    const int64_t base = (int64_t)shard * H_loc * OB;
    int64_t* out = send + q * 6 * CAP;
    for (int64_t j = (int64_t)blockIdx.x * THREADS + threadIdx.x; j < hi;
         j += (int64_t)gridDim.x * THREADS) {
        const bool ok = j < raw;
        int64_t x = 0;
        if (ok) {
            const int a = group_of(gr, NG, j);
            x = perm[gr.st[a] + (j - gr.off[a])];
        }
        if (j >= CAP) {
            atomicAdd(&x_overflow[x / OB], 1);
            continue;
        }
        const int64_t key =
            ok ? (int64_t)hi32(rows.at(CH_M, r, x)) * span + base + x : IMAX;
        put(out, CAP, j, rows, r, x, ok, key);
    }
    if (threadIdx.x == 0) fw.close(raw < CAP ? raw : CAP);
}

// phase 2, buffer i = blockIdx.y < NG - 1; the row past them counts the
// loss of the shards of no buffer. F: the arrivals' rows a replica.
__global__ void __launch_bounds__(THREADS)
pack2_kernel(int S, int shard, int H_loc, int OB, int G, int NG, int CAP2,
             int64_t F, Rows rows, const int64_t* __restrict__ perm,
             const int64_t* __restrict__ starts,
             const int64_t* __restrict__ counts, int64_t* send,
             int32_t* hist, int32_t* filled, unsigned* tickets,
             const int64_t* ctl) {
    const int64_t r = blockIdx.z;
    if (phase_off(replica_ctl(ctl, r))) return;
    const int64_t D = (int64_t)S * H_loc;
    perm += r * F;
    starts += r * D;
    counts += r * D;
    hist += r * D;
    const int my_g = shard / G, my_b = shard % G;
    const int64_t span = (int64_t)S * H_loc * OB;
    const int64_t stride = (int64_t)gridDim.x * THREADS;
    const int64_t first = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if ((int)blockIdx.y == NG - 1) {
        for (int d = 0; d < S; ++d) {
            if (d == shard || d % G == my_b) continue;
            int64_t st, n;
            segment(starts, counts, S, H_loc, d, &st, &n);
            for (int64_t j = CAP2 + first; j < n; j += stride) {
                const int64_t key = rows.at(CH_KEY, r, perm[st + j]);
                atomicAdd(&hist[(key % span) / OB], 1);
            }
        }
        return;
    }
    const int i = blockIdx.y;
    const int a = i + (i >= my_g ? 1 : 0);
    const int64_t q = (int64_t)i * gridDim.z + r;
    __shared__ int64_t seg[2], prev;
    FillWord fw(filled, tickets, q);
    if (threadIdx.x == 0) {
        segment(starts, counts, S, H_loc, a * G + my_b, &seg[0], &seg[1]);
        prev = fw.open(CAP2);
    }
    __syncthreads();
    const int64_t st = seg[0], raw = seg[1];
    const int64_t hi = raw > prev ? raw : prev;
    int64_t* out = send + q * 6 * CAP2;
    for (int64_t j = first; j < hi; j += stride) {
        const bool ok = j < raw;
        const int64_t x = ok ? perm[st + j] : 0;
        const int64_t key = ok ? rows.at(CH_KEY, r, x) : IMAX;
        if (j >= CAP2)
            atomicAdd(&hist[(key % span) / OB], 1);
        else
            put(out, CAP2, j, rows, r, x, ok, key);
    }
    if (threadIdx.x == 0) fw.close(raw < CAP2 ? raw : CAP2);
}

// ---- the design before --------------------------------------------------

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
        put(out, CAP, j, rows, 0, x, ok, key);
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
        put(out, CAP2, j, rows, 0, x, ok, ok ? rows.at(CH_KEY, 0, x) : IMAX);
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

// The design before's blocks a buffer.
int before_blocks(int cap) {
    const int gx = (cap + THREADS - 1) / THREADS;
    return gx > 1024 ? 1024 : gx;
}

// Blocks a buffer: two blocks an SM over the launch's `nbuf` rows, at
// most one a THREADS slots of the capacity.
int blocks(int nbuf, int cap) {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (sms < 1) sms = 1;
    }
    const int want = (cap + THREADS - 1) / THREADS;
    int per = 2 * sms / (nbuf < 1 ? 1 : nbuf);
    if (per < 1) per = 1;
    return want < per ? want : per;
}

}  // namespace

// The unsigned tickets (zero when allocated) of a half's launch over
// `nbuf` kept buffers (a campaign's (buffer, replica) pairs) of capacity
// `cap`.
extern "C" int shadow_pack_two_phase_tickets(int nbuf, int cap) {
    return nbuf * ticket_words(blocks(nbuf, cap));
}

// R replicas (1 standalone; the design before takes R = 1 only); ctl
// null or [R, CTL_N].
extern "C" int shadow_pack_two_phase(int R, long long F, int S, int shard,
                                     int H_loc, int OB, int G, int NG,
                                     int CAP, const Rows* rows,
                                     const int64_t* perm,
                                     const int64_t* starts,
                                     const int64_t* counts, int64_t* send,
                                     int32_t* x_overflow, int32_t* occ_x,
                                     int32_t* filled, unsigned* tickets,
                                     int before, const int64_t* ctl,
                                     void* stream) {
    if (rows == nullptr || !groups_ok(S, shard, G, NG) || CAP < 1 ||
        R < 1 || R > 65535 || (before && R != 1) ||
        (R > 1 && rows->rs == 0) || F != (long long)H_loc * OB ||
        (filled != nullptr && tickets == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (before) {
        const int gx = before_blocks(CAP);
        phase1_kernel<<<dim3(gx, G), THREADS, 0, st>>>(
            S, shard, H_loc, OB, G, NG, CAP, *rows, perm, starts, counts,
            send);
        phase1_lost_kernel<<<dim3(gx, S), THREADS, 0, st>>>(
            S, shard, H_loc, OB, G, CAP, perm, starts, counts, x_overflow,
            occ_x);
        return (int)cudaGetLastError();
    }
    pack1_kernel<<<dim3(blocks(G * R, CAP), G, R), THREADS, 0, st>>>(
        S, shard, H_loc, OB, G, NG, CAP, *rows, perm, starts, counts, send,
        x_overflow, occ_x, filled, tickets, ctl);
    return (int)cudaGetLastError();
}

extern "C" int shadow_pack_two_phase2(int R, long long F, int S,
                                      int shard, int H_loc, int OB, int G,
                                      int NG, int CAP2, const Rows* rows,
                                      const int64_t* perm,
                                      const int64_t* starts,
                                      const int64_t* counts, int64_t* send,
                                      int32_t* hist, int32_t* filled,
                                      unsigned* tickets, int before,
                                      const int64_t* ctl, void* stream) {
    if (rows == nullptr || !groups_ok(S, shard, G, NG) || CAP2 < 1 ||
        R < 1 || R > 65535 || (before && R != 1) ||
        rows->a[CH_KEY] == nullptr || F < 0 ||
        (filled != nullptr && tickets == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (before) {
        const int gx = before_blocks(CAP2);
        if (NG > 1)
            phase2_kernel<<<dim3(gx, NG - 1), THREADS, 0, st>>>(
                S, shard, H_loc, G, CAP2, *rows, perm, starts, counts,
                send);
        phase2_lost_kernel<<<dim3(gx, S), THREADS, 0, st>>>(
            S, shard, H_loc, OB, CAP2, *rows, perm, starts, counts, hist);
        return (int)cudaGetLastError();
    }
    pack2_kernel<<<dim3(blocks((NG - 1) * R, CAP2), NG, R), THREADS, 0,
                   st>>>(S, shard, H_loc, OB, G, NG, CAP2, (int64_t)F, *rows,
                         perm, starts, counts, send, hist, filled, tickets,
                         ctl);
    return (int)cudaGetLastError();
}
