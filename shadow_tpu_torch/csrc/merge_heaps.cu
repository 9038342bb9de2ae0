// K3 merge_heaps: merge each host's arrivals into its sorted event heap.
//
// Replaces the window-path merge of shadow_tpu/device/engine.py
// (`_exchange` with merge_global=False: the `_host_windows`/`_seg_take`
// arrival windows and the per-row lexicographic sort of
// [live heap | arrivals]; `_merge_rows` is the global-sort variant of the
// same function). Per host: the live heap rows (slots >= head; consumed
// slots read as t=INF, key=IMAX and keep their payloads) and the first IN
// rows of its arrival segment (through the route's sort permutation),
// ordered by (t, key, column), the first E kept. The column breaks ties,
// so the order equals the stable lexicographic sort of the plain
// version, and which rows survive an overflow follows that order, never
// the arrival order. Rows past E with t < INF, and arrivals past IN,
// count into `overflow`; `occ_in` and `occ_heap` take their high-water
// marks; head resets to 0.
//
// The work follows the hosts that change. A scan kernel lists the hosts
// that changed (head != 0 or arrivals; every host of a fresh state), a
// warp's by one atomic, and the merge kernel spreads the listed hosts
// over every warp of its grid, a warp a host, with the row in the warp's
// own slice of shared memory:
// - a host with head == 0 and no arrivals keeps its heap: no heap byte
//   moves;
// - a changed host merges. Its live tail [head, E) is already sorted by
//   (t, key): only K3 writes heap rows, and the pops only advance head.
//   The consumed slots enter as (INF, IMAX) rows at their column's
//   place, which is a fixed shift of the tail (`seq_pos`); the <= IN
//   arrivals are ranked among themselves by counting (ties to the
//   column); each row's output slot is its place in its own sorted list
//   plus the rows of the other list below it, found by binary search
//   (the co-rank of a merge path). The slot's source goes to shared
//   memory, and the warp writes the five heap fields in slot order,
//   coalesced. Each arrival's five fields are read once.
// - a host whose tail is out of order (a state edited from outside: the
//   audit's `heap_swap`) takes the same steps with ranks by counting
//   over the whole row, which is the full sort.
// The tail is checked only where the caller asks (`flags`): the engine
// sets its fresh word when a state enters it (a run, a resume, a flush
// called from outside), and the first merge then checks every host's
// tail (and for an unchanged host raises occ_heap to its live rows,
// which a state from outside may exceed) and clears the word, unless a
// heap keeps a row past INF (an edited state), whose place the
// unchanged-host rule cannot see. Without flags every merge checks.
//
// A mesh rank merges two arrival blocks (engine.py:1955-2061): the rows
// it received and its own self-shard rows, which never moved, each
// windowed to IN on its own, ordered after the heap's and the first
// block's columns; arrivals past IN of either block count into
// `overflow`, and `occ_in` takes the larger of the two blocks' counts
// (the window merge) or their sum (`occ_sum`, the global merge's one
// sorted segment). Arrivals come through `Rows` views (common.cuh): an
// outbox or the exchange's wire buffers.
//
// Under the window loop the launch returns at once where the control
// block's RUN word is 0 (common.cuh `Ctl`). The replica axis of an
// ensemble campaign is blockIdx.y: replica r's hosts, arrivals and
// flags, from that replica's outbox and route; on a mesh rank both of its
// blocks, the rows it received ([nb, R, C, bw] wire buffers) and its own
// segment of its outbox's route over H_pad.
//
// Bound on the H100: bytes, at these inputs: head and the counts of
// every host; of a changed host its five heap fields read and written
// and its accepted arrivals (five fields and their perm entry); the
// check of a fresh state reads t and key of every row besides.
#include "common.cuh"

using namespace shadow;

namespace {

constexpr int WARPS = 4;
constexpr int MAX_GRID = 2048;      // merge blocks a replica

// (t, key, column) below (t, key, column)
__device__ __forceinline__ bool row_less(int64_t ta, int64_t ka, int ca,
                                         int64_t tb, int64_t kb, int cb) {
    if (ta != tb) return ta < tb;
    if (ka != kb) return ka < kb;
    return ca < cb;
}

// one arrival block: its rows (an outbox through plain pointers, or any
// `Rows` view) and the route's perm, starts and counts
template <class View>
struct Block {
    View rows;
    const int64_t* perm;
    const int64_t* starts;
    const int64_t* counts;
    int64_t F;      // perm entries a replica
    int64_t SC;     // a replica's stride in starts and counts
};

// a warp's slice of shared memory: the row's W = E + nblk*IN columns
// (t, key and the three packed payload fields), the sorted arrivals'
// columns and each output slot's source column
struct Slice {
    int64_t *t, *k, *m, *v, *w;
    int32_t *ys, *src;
};

__host__ __device__ inline size_t slice_bytes(int E, int W) {
    // ys [W - E] and src [E] int32, rounded to whole int64 words
    return 5 * sizeof(int64_t) * (size_t)W +
           sizeof(int32_t) * (size_t)((W + 1) / 2 * 2);
}

__device__ inline Slice carve(char* base, int E, int W) {
    Slice s;
    int64_t* p = (int64_t*)base;
    s.t = p;
    s.k = p + W;
    s.m = p + 2 * W;
    s.v = p + 3 * W;
    s.w = p + 4 * W;
    s.ys = (int32_t*)(p + 5 * W);
    s.src = s.ys + (W - E);
    return s;
}

// a host's scalars, from the lane that read them
struct Host {
    int hd_raw;         // head as the state holds it
    int hd;             // head clamped to [0, E]
    int nin_a, nin_b;   // accepted arrivals of each block
    int64_t s0_a, s0_b;
};

// slot position in the heap's sorted sequence: the tail's first p rows
// (below (INF, IMAX)), then the consumed slots [0, hd), then the rest of
// the tail
__device__ __forceinline__ int seq_pos(int j, int hd, int p) {
    if (j < hd) return p + j;
    const int l = j - hd;
    return l < p ? l : l + hd;
}

// whether the first merge of a state from outside the engine (flags
// null: every merge) runs
__device__ __forceinline__ bool fresh_state(const int32_t* flags,
                                            int64_t r) {
    return flags == nullptr || *(const volatile int32_t*)(flags + r) != 0;
}

// (1) the hosts to merge: head != 0 or arrivals (every host of a fresh
// state), listed in any order (each host's merge is its own), a warp's
// by one atomic; the list is work[2 ..], its length work[0]
template <bool TWO>
__global__ void __launch_bounds__(256)
merge_scan_kernel(int H, const int32_t* head, const int64_t* counts_a,
                  const int64_t* counts_b, int64_t sc_b, int32_t* work,
                  const int64_t* ctl, const int32_t* flags) {
    const int64_t r = blockIdx.y;
    if (phase_off(replica_ctl(ctl, r))) return;
    const bool verify = fresh_state(flags, r);
    const int64_t h = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    bool todo = false;
    if (h < H)
        todo = verify || head[r * H + h] != 0 ||
               __ldg(counts_a + r * H + h) > 0 ||
               (TWO && __ldg(counts_b + r * sc_b + h) > 0);
    const unsigned bal = __ballot_sync(0xffffffffu, todo);
    if (!bal) return;
    const int lane = threadIdx.x & 31;
    int base = 0;
    if (lane == 0) base = atomicAdd(work + r * (2 + (int64_t)H), __popc(bal));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (todo)
        work[r * (2 + (int64_t)H) + 2 + base +
             __popc(bal & ((1u << lane) - 1))] = (int32_t)h;
}

// (2) a warp a listed host, the list's hosts spread over every warp of
// the grid
template <class ViewA, bool TWO>
__global__ void __launch_bounds__(WARPS * 32)
merge_heaps_kernel(int H, int E, int IN, int occ_sum, int64_t* ht,
                   int64_t* hk, int64_t* hm, int64_t* hv, int64_t* hw,
                   int32_t* head, Block<ViewA> A, Block<Rows> B,
                   int32_t* overflow, int32_t* occ_in, int32_t* occ_heap,
                   const int64_t* ctl, int32_t* flags, int32_t* work) {
    const int64_t r = blockIdx.y;
    if (phase_off(replica_ctl(ctl, r))) return;
    constexpr int nblk = TWO ? 2 : 1;
    const int W = E + nblk * IN;
    const int R = gridDim.y;
    const int64_t rh = r * H;
    ht += rh * E;
    hk += rh * E;
    hm += rh * E;
    hv += rh * E;
    hw += rh * E;
    head += rh;
    overflow += rh;
    occ_in += rh;
    occ_heap += rh;
    work += r * (2 + (int64_t)H);
    const bool verify = fresh_state(flags, r);
    const int listed = *(volatile int32_t*)work;
    __shared__ int abnormal_s;
    if (threadIdx.x == 0) abnormal_s = 0;
    __syncthreads();
    extern __shared__ __align__(16) char smem[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const Slice s = carve(smem + warp * slice_bytes(E, W), E, W);
    const int64_t* __restrict__ perm_a = A.perm + r * A.F;
    const int64_t* __restrict__ perm_b = B.perm + r * B.F;
    bool abnormal = false;
    for (int i = blockIdx.x * WARPS + warp; i < listed;
         i += gridDim.x * WARPS) {
        const int64_t h = work[2 + i];
        const int64_t row = h * E;
        Host x;
        x.hd_raw = head[h];
        x.hd = x.hd_raw < 0 ? 0 : (x.hd_raw > E ? E : x.hd_raw);
        const int64_t ca = __ldg(A.counts + rh + h);
        const int64_t cb = TWO ? __ldg(B.counts + r * B.SC + h) : 0;
        x.s0_a = __ldg(A.starts + rh + h);
        x.s0_b = TWO ? __ldg(B.starts + r * B.SC + h) : 0;
        x.nin_a = ca < IN ? (int)ca : IN;
        x.nin_b = cb < IN ? (int)cb : IN;
        const int n_r = x.nin_a + x.nin_b;
        // a host with head != 0 or arrivals rewrites its row: its
        // payloads and arrivals load with its times and keys, one round
        // of loads in flight; a checked host with neither loads t and
        // key first, and the rest only where its row turns out to move
        const bool moves = x.hd_raw != 0 || n_r > 0;
        int n_lt = 0, g = 0, p = 0;
        for (int j = lane; j < E; j += 32) {
            int64_t t = INF, k = IMAX;
            if (j >= x.hd) {
                t = ht[row + j];
                k = hk[row + j];
            }
            if (moves) {
                s.m[j] = hm[row + j];
                s.v[j] = hv[row + j];
                s.w[j] = hw[row + j];
            }
            s.t[j] = t;
            s.k[j] = k;
            n_lt += t < INF;
            g += t > INF;
            p += t < INF || (t == INF && k < IMAX);
        }
        // the accepted arrivals' five fields, each read once
        for (int a = lane; a < n_r; a += 32) {
            const bool first = a < x.nin_a;
            const int col = first ? E + a : E + IN + (a - x.nin_a);
            int64_t ft, fk, fm, fs, fv;
            if (!TWO || first) {
                const int64_t i = __ldg(perm_a + x.s0_a + a);
                ft = A.rows.at(CH_T, r, i);
                fk = A.rows.at(CH_K, r, i);
                fm = A.rows.at(CH_M, r, i);
                fs = A.rows.at(CH_S, r, i);
                fv = A.rows.at(CH_V, r, i);
            } else {
                const int64_t i = __ldg(perm_b + x.s0_b + a - x.nin_a);
                ft = B.rows.at(CH_T, r, i);
                fk = B.rows.at(CH_K, r, i);
                fm = B.rows.at(CH_M, r, i);
                fs = B.rows.at(CH_S, r, i);
                fv = B.rows.at(CH_V, r, i);
            }
            s.t[col] = ft;
            s.k[col] = fk;
            s.m[col] = pack2((uint32_t)(lo32(fm) & 0xFF), (uint32_t)hi32(fs));
            s.v[col] = pack2((uint32_t)lo32(fs), (uint32_t)lo32(fv));
            s.w[col] = (int64_t)((uint64_t)fv >> 32);
        }
        n_lt = __reduce_add_sync(0xffffffffu, n_lt);
        g = __reduce_add_sync(0xffffffffu, g);
        p = __reduce_add_sync(0xffffffffu, p);
        __syncwarp();
        bool sorted = true;
        if (verify) {
            bool ok = true;
            for (int j = x.hd + lane; j + 1 < E; j += 32)
                ok &= !row_less(s.t[j + 1], s.k[j + 1], 0, s.t[j], s.k[j],
                                0);
            sorted = __all_sync(0xffffffffu, ok);
        }
        const bool keep = !moves && sorted && g == 0;
        if (!keep) {
            if (!moves) {
                for (int j = lane; j < E; j += 32) {
                    s.m[j] = hm[row + j];
                    s.v[j] = hv[row + j];
                    s.w[j] = hw[row + j];
                }
                __syncwarp();
            }
            // the arrivals' order among themselves: ys[rank] = column
            for (int a = lane; a < n_r; a += 32) {
                const int col = a < x.nin_a ? E + a : E + IN + (a - x.nin_a);
                const int64_t t = s.t[col], k = s.k[col];
                int rank = 0;
                for (int c = 0; c < n_r; ++c) {
                    const int cc = c < x.nin_a ? E + c
                                               : E + IN + (c - x.nin_a);
                    rank += row_less(s.t[cc], s.k[cc], cc, t, k, col);
                }
                s.ys[rank] = col;
            }
            __syncwarp();
            // heap slots: place in the heap's order plus the arrivals
            // below
            const int n_empty = nblk * IN - n_r;
            for (int j = lane; j < E; j += 32) {
                const int64_t t = s.t[j], k = s.k[j];
                int q;
                if (sorted) {
                    q = seq_pos(j, x.hd, p);
                } else {
                    q = 0;
                    for (int c = 0; c < E; ++c)
                        q += row_less(s.t[c], s.k[c], c, t, k, j);
                }
                int cross;
                if (t < INF || (t == INF && k < IMAX)) {
                    // arrivals strictly below (t, key): ties go to the
                    // heap's lower column
                    int lo_ = 0, hi = n_r;
                    while (lo_ < hi) {
                        const int mid = (lo_ + hi) >> 1;
                        const int c = s.ys[mid];
                        if (row_less(s.t[c], s.k[c], 1, t, k, 0))
                            lo_ = mid + 1;
                        else
                            hi = mid;
                    }
                    cross = lo_;
                } else {
                    cross = n_r + (t > INF ? n_empty : 0);
                }
                const int pos = q + cross;
                if (pos < E) s.src[pos] = j;
            }
            // arrivals: their rank plus the heap rows at or below them
            for (int a = lane; a < n_r; a += 32) {
                const int col = s.ys[a];
                const int64_t t = s.t[col], k = s.k[col];
                int cross = 0;
                if (sorted) {
                    // the tail's first p rows are the heap's rows below
                    // (INF, IMAX), in order
                    int lo_ = 0, hi = p;
                    while (lo_ < hi) {
                        const int mid = (lo_ + hi) >> 1;
                        const int c = x.hd + mid;
                        if (!row_less(t, k, 0, s.t[c], s.k[c], 0))
                            lo_ = mid + 1;
                        else
                            hi = mid;
                    }
                    cross = lo_;
                } else {
                    for (int c = 0; c < E; ++c)
                        cross += !row_less(t, k, 0, s.t[c], s.k[c], 0);
                }
                const int pos = a + cross;
                if (pos < E) s.src[pos] = col;
            }
            // empty arrival columns come before the heap's rows past
            // INF only
            for (int i = lane; i < n_empty && n_r + i + E - g < E; i += 32) {
                const int na = IN - x.nin_a;
                const int col = i < na ? E + x.nin_a + i
                                       : E + IN + x.nin_b + (i - na);
                s.src[n_r + i + E - g] = col;
            }
            __syncwarp();
            // write the row in slot order
            for (int o = lane; o < E; o += 32) {
                const int c = s.src[o];
                const bool arrived =
                    c >= E && (c < E + IN ? c - E < x.nin_a
                                          : c - E - IN < x.nin_b);
                int64_t t = INF, k = IMAX, m = 0, v = 0, w = 0;
                if (c < E || arrived) {
                    t = s.t[c];
                    k = s.k[c];
                    m = s.m[c];
                    v = s.v[c];
                    w = s.w[c];
                }
                ht[row + o] = t;
                hk[row + o] = k;
                hm[row + o] = m;
                hv[row + o] = v;
                hw[row + o] = w;
                if (o == E - 1 && t > INF) abnormal = true;
            }
        }
        if (lane == 0) {
            const int n_all = n_lt + n_r;
            const int64_t over_in = (ca > IN ? ca - IN : 0) +
                                    (cb > IN ? cb - IN : 0);
            overflow[h] += (int32_t)over_in + (n_all > E ? n_all - E : 0);
            const int64_t arrived = occ_sum ? ca + cb : (ca > cb ? ca : cb);
            occ_in[h] = max(occ_in[h], (int32_t)arrived);
            occ_heap[h] = max(occ_heap[h], n_all < E ? n_all : E);
            if (x.hd_raw != 0) head[h] = 0;
        }
        __syncwarp();
    }
    // the last block out empties the list and, after a fresh state's
    // check, clears the fresh word unless some heap kept a row past INF
    if (__any_sync(0xffffffffu, abnormal) && lane == 0)
        atomicOr(&abnormal_s, 1);
    __syncthreads();
    if (threadIdx.x == 0) {
        if (flags != nullptr && abnormal_s) atomicOr(flags + R + r, 1);
        __threadfence();
        if (atomicAdd(work + 1, 1) == (int)gridDim.x - 1) {
            __threadfence();
            work[0] = 0;
            work[1] = 0;
            if (flags != nullptr && verify) {
                const int keep_fresh = atomicExch(flags + R + r, 0);
                *(volatile int32_t*)(flags + r) = keep_fresh ? 1 : 0;
            }
        }
    }
}

// a block and its view type, for the host's dispatch
template <class View>
struct Launch {
    using ViewT = View;
    Block<View> block;
};

}  // namespace

// rows_b null: one arrival block. The second block's starts and counts
// of replica r lie sc_b words on (a mesh rank's own segment of its
// outbox's route over H_pad: sc_b = H_pad). flags: null, or [2, R] int32 (fresh, and a heap past
// INF seen, zero between launches). work: [R, 2 + H] int32, zero when
// allocated (the list's length and the blocks done, zero between
// launches, then the list).
extern "C" int shadow_merge_heaps(
    int R, int H, int E, int IN, int64_t* ht, int64_t* hk, int64_t* hm,
    int64_t* hv, int64_t* hw, int32_t* head, const Rows* rows_a,
    const int64_t* perm_a, const int64_t* starts_a,
    const int64_t* counts_a, long long F_a, const Rows* rows_b,
    const int64_t* perm_b, const int64_t* starts_b,
    const int64_t* counts_b, long long F_b, long long sc_b, int occ_sum,
    int32_t* overflow, int32_t* occ_in, int32_t* occ_heap,
    const int64_t* ctl, int32_t* flags, int32_t* work, void* stream) {
    const int nblk = rows_b == nullptr ? 1 : 2;
    if (R < 1 || R > 65535 || rows_a == nullptr || E < 1 || IN < 0 ||
        (nblk == 2 && R > 1 && (rows_b->rs == 0 || sc_b < H)))
        return (int)cudaErrorInvalidValue;
    const int W = E + nblk * IN;
    const size_t smem = WARPS * slice_bytes(E, W);
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    const Block<Rows> B{nblk == 2 ? *rows_b : *rows_a, perm_b, starts_b,
                        counts_b, (int64_t)F_b, (int64_t)sc_b};
    cudaStream_t st = (cudaStream_t)stream;
    if (H <= 0) return (int)cudaGetLastError();
    const dim3 scan_grid((unsigned)((H + 255) / 256), R);
    if (nblk == 2)
        merge_scan_kernel<true><<<scan_grid, 256, 0, st>>>(
            H, head, counts_a, counts_b, (int64_t)sc_b, work, ctl, flags);
    else
        merge_scan_kernel<false><<<scan_grid, 256, 0, st>>>(
            H, head, counts_a, counts_b, (int64_t)sc_b, work, ctl, flags);
    // enough warps to spread the listed hosts, whatever their count
    const int blocks = (H + WARPS - 1) / WARPS;
    const unsigned grid = (unsigned)(blocks < MAX_GRID ? blocks : MAX_GRID);
    // one outbox block (the one-device path) reads through plain
    // pointers
    auto launch = [&](auto A) -> int {
        using View = typename decltype(A)::ViewT;
        auto kernel = nblk == 2 ? merge_heaps_kernel<View, true>
                                : merge_heaps_kernel<View, false>;
        if (smem > 48 * 1024) {
            const cudaError_t err = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)smem);
            if (err != cudaSuccess) return (int)err;
        }
        kernel<<<dim3(grid, R), WARPS * 32, smem, st>>>(
            H, E, IN, occ_sum, ht, hk, hm, hv, hw, head, A.block, B,
            overflow, occ_in, occ_heap, ctl, flags, work);
        return (int)cudaGetLastError();
    };
    if (nblk == 1 && is_outbox(*rows_a, F_a))
        return launch(Launch<OutboxRows>{Block<OutboxRows>{
            OutboxRows(*rows_a), perm_a, starts_a, counts_a,
            (int64_t)F_a, (int64_t)H}});
    return launch(Launch<Rows>{Block<Rows>{*rows_a, perm_a, starts_a,
                                           counts_a, (int64_t)F_a,
                                           (int64_t)H}});
}
