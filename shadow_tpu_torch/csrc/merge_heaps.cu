// K3 merge_heaps: merge each host's arrivals into its sorted event heap.
//
// Replaces the window-path merge of shadow_tpu/device/engine.py
// (`_exchange` with merge_global=False: the `_host_windows`/`_seg_take`
// arrival windows and the per-row lexicographic sort of
// [live heap | arrivals]; `_merge_rows` is the global-sort variant of the
// same function). One block owns one destination host: it loads the live
// heap rows (slots >= head; consumed slots read as t=INF, key=IMAX) and
// the first IN rows of its arrival segment (through the route's sort
// permutation), sorts (t, key, column) ascending in shared memory with a
// bitonic network over E+IN rounded up to a power of two, and writes the
// first E rows back. The column breaks ties, so the order equals the
// stable lexicographic sort of the plain version, and which rows survive
// an overflow follows the sort, never the arrival order. Rows past E with
// t < INF, and arrivals past IN, count into `overflow`; `occ_in` and
// `occ_heap` take their high-water marks; head resets to 0.
//
// A mesh rank merges two arrival blocks (engine.py:1955-2061): the rows
// it received and its own self-shard rows, which never moved, each
// windowed to IN on its own; the sort runs over [heap | first | second],
// W = E + 2*IN rounded up to a power of two (256 at E = IN = 64: 6.5 KB
// of shared memory), arrivals past IN of either block count into
// `overflow`, and `occ_in` takes the larger of the two blocks' counts
// (the window merge) or their sum (`occ_sum`, the global merge's one
// sorted segment). Arrivals come through `Rows` views (common.cuh): an
// outbox or the exchange's wire buffers.
//
// Under the window loop the launch returns at once where the control
// block's RUN word is 0 (common.cuh `Ctl`). The replica axis of an
// ensemble campaign is blockIdx.y: block (h, r) merges host h of replica
// r, from that replica's outbox and route.
//
// Bound on the H100: bytes (t of every heap slot and the other fields of
// live slots read, all H*E*5 int64 written, plus the accepted arrival
// rows); the bitonic network is log2(W)^2/2 shared-memory passes, cheap
// at W = 128.
#include "common.cuh"

using namespace shadow;

namespace {

__device__ __forceinline__ bool row_less(int64_t ta, int64_t ka, int ia,
                                         int64_t tb, int64_t kb, int ib) {
    if (ta != tb) return ta < tb;
    if (ka != kb) return ka < kb;
    return ia < ib;
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
};

// Blocks of up to 256 threads an SM must hold: the one-block merge is
// capped at 32 registers, so that 2,048 threads stay resident, as the
// kernel ran before it read through row views (40 registers cost it
// about 7% at 1,000,000 hosts); the two-block merge keeps its own.
template <bool TWO>
constexpr int merge_min_blocks() {
    return TWO ? 1 : 8;
}

template <class ViewA, bool TWO>
__global__ void __launch_bounds__(256, merge_min_blocks<TWO>())
merge_heaps_kernel(
    int E, int IN, int W2, int occ_sum, int64_t* ht, int64_t* hk,
    int64_t* hm, int64_t* hv, int64_t* hw, int32_t* head, Block<ViewA> A,
    Block<Rows> B, int32_t* overflow, int32_t* occ_in, int32_t* occ_heap,
    const int64_t* ctl) {
    const int64_t r = blockIdx.y;
    if (phase_off(replica_ctl(ctl, r))) return;
    constexpr int nblk = TWO ? 2 : 1;
    // replica r: H = gridDim.x hosts
    const int64_t rh = r * gridDim.x;
    ht += rh * E;
    hk += rh * E;
    hm += rh * E;
    hv += rh * E;
    hw += rh * E;
    head += rh;
    overflow += rh;
    occ_in += rh;
    occ_heap += rh;
    extern __shared__ int64_t smem[];
    int64_t* st = smem;                 // [W2] time
    int64_t* sk = st + W2;              // [W2] key
    int64_t* om = sk + W2;              // [E] kept rows' payloads
    int64_t* ov = om + E;
    int64_t* ow = ov + E;
    int32_t* si = (int32_t*)(ow + E);   // [W2] source column
    __shared__ int n_over, n_live;

    const int h = blockIdx.x;
    const int tid = threadIdx.x;
    const int64_t hrow = (int64_t)h * E;
    const int hd = head[h];
    // each block's count, window and first sorted row (scalars: an
    // array indexed by the block would live in local memory)
    const int64_t* __restrict__ perm_a = A.perm + r * A.F;
    const int64_t* __restrict__ perm_b = B.perm;
    const int64_t cnt_a = __ldg(A.counts + rh + h);
    const int64_t s0_a = __ldg(A.starts + rh + h);
    const int nin_a = cnt_a < IN ? (int)cnt_a : IN;
    const int64_t cnt_b = TWO ? __ldg(B.counts + h) : 0;
    const int64_t s0_b = TWO ? __ldg(B.starts + h) : 0;
    const int nin_b = cnt_b < IN ? (int)cnt_b : IN;
    if (tid == 0) {
        n_over = 0;
        n_live = 0;
    }
    for (int j = tid; j < W2; j += blockDim.x) {
        int64_t t = INT64_MAX, k = IMAX;   // padding sorts last
        if (j < E) {
            if (j >= hd) {
                t = ht[hrow + j];
                k = hk[hrow + j];
            } else {
                t = INF;
            }
        } else if (j < E + IN) {
            const int a = j - E;
            t = INF;
            if (a < nin_a) {
                const int64_t x = __ldg(perm_a + s0_a + a);
                t = A.rows.at(CH_T, r, x);
                k = A.rows.at(CH_K, r, x);
            }
        } else if (TWO && j < E + nblk * IN) {
            const int a = j - E - IN;
            t = INF;
            if (a < nin_b) {
                const int64_t x = __ldg(perm_b + s0_b + a);
                t = B.rows.at(CH_T, 0, x);
                k = B.rows.at(CH_K, 0, x);
            }
        }
        st[j] = t;
        sk[j] = k;
        si[j] = j;
    }
    __syncthreads();
    for (int size = 2; size <= W2; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int i = tid; i < W2; i += blockDim.x) {
                const int l = i ^ stride;
                if (l > i) {
                    const bool up = (i & size) == 0;
                    const bool gt = row_less(st[l], sk[l], si[l], st[i],
                                             sk[i], si[i]);
                    if (gt == up) {
                        const int64_t t = st[i], k = sk[i];
                        const int32_t c = si[i];
                        st[i] = st[l];
                        sk[i] = sk[l];
                        si[i] = si[l];
                        st[l] = t;
                        sk[l] = k;
                        si[l] = c;
                    }
                }
            }
            __syncthreads();
        }
    }
    // gather the kept rows' payloads before any heap slot is rewritten
    int over = 0, live = 0;
    for (int j = tid; j < W2; j += blockDim.x) {
        if (j >= E) {
            if (j < E + nblk * IN && st[j] < INF) ++over;
            continue;
        }
        if (st[j] < INF) ++live;
        const int src = si[j];
        int64_t m = 0, v = 0, w = 0;
        if (src < E) {
            m = hm[hrow + src];
            v = hv[hrow + src];
            w = hw[hrow + src];
        } else if (src < E + nblk * IN) {
            // each block read through its own parameter: a pointer to
            // either would copy both to local memory
            int64_t fm = 0, fs = 0, fv = 0;
            if (!TWO || src < E + IN) {
                const int a = src - E;
                if (a < nin_a) {
                    const int64_t x = __ldg(perm_a + s0_a + a);
                    fm = A.rows.at(CH_M, r, x);
                    fs = A.rows.at(CH_S, r, x);
                    fv = A.rows.at(CH_V, r, x);
                }
            } else {
                const int a = src - E - IN;
                if (a < nin_b) {
                    const int64_t x = __ldg(perm_b + s0_b + a);
                    fm = B.rows.at(CH_M, 0, x);
                    fs = B.rows.at(CH_S, 0, x);
                    fv = B.rows.at(CH_V, 0, x);
                }
            }
            m = pack2((uint32_t)(lo32(fm) & 0xFF), (uint32_t)hi32(fs));
            v = pack2((uint32_t)lo32(fs), (uint32_t)lo32(fv));
            w = (int64_t)((uint64_t)fv >> 32);
        }
        om[j] = m;
        ov[j] = v;
        ow[j] = w;
    }
    if (over) atomicAdd(&n_over, over);
    if (live) atomicAdd(&n_live, live);
    __syncthreads();
    for (int j = tid; j < E; j += blockDim.x) {
        ht[hrow + j] = st[j];
        hk[hrow + j] = sk[j];
        hm[hrow + j] = om[j];
        hv[hrow + j] = ov[j];
        hw[hrow + j] = ow[j];
    }
    if (tid == 0) {
        const int64_t over_in = (cnt_a > IN ? cnt_a - IN : 0) +
                                (cnt_b > IN ? cnt_b - IN : 0);
        overflow[h] += (int32_t)over_in + n_over;
        const int64_t arrived =
            occ_sum ? cnt_a + cnt_b : (cnt_a > cnt_b ? cnt_a : cnt_b);
        occ_in[h] = max(occ_in[h], (int32_t)arrived);
        occ_heap[h] = max(occ_heap[h], n_live);
        head[h] = 0;
    }
}

// a block and its view type, for the host's dispatch
template <class View>
struct Launch {
    using ViewT = View;
    Block<View> block;
};

}  // namespace

// rows_b null: one arrival block. A second block runs a standalone
// state (R = 1).
extern "C" int shadow_merge_heaps(
    int R, int H, int E, int IN, int64_t* ht, int64_t* hk, int64_t* hm,
    int64_t* hv, int64_t* hw, int32_t* head, const Rows* rows_a,
    const int64_t* perm_a, const int64_t* starts_a,
    const int64_t* counts_a, long long F_a, const Rows* rows_b,
    const int64_t* perm_b, const int64_t* starts_b,
    const int64_t* counts_b, long long F_b, int occ_sum,
    int32_t* overflow, int32_t* occ_in, int32_t* occ_heap,
    const int64_t* ctl, void* stream) {
    const int nblk = rows_b == nullptr ? 1 : 2;
    if (R < 1 || R > 65535 || rows_a == nullptr || (nblk == 2 && R != 1))
        return (int)cudaErrorInvalidValue;
    int W2 = 1;
    while (W2 < E + nblk * IN) W2 <<= 1;
    const size_t smem = sizeof(int64_t) * (2 * (size_t)W2 + 3 * (size_t)E) +
                        sizeof(int32_t) * (size_t)W2;
    const Block<Rows> B{nblk == 2 ? *rows_b : *rows_a, perm_b, starts_b,
                        counts_b, (int64_t)F_b};
    const int threads = W2 < 256 ? W2 : 256;
    cudaStream_t st = (cudaStream_t)stream;
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
        if (H > 0)
            kernel<<<dim3(H, R), threads, smem, st>>>(
                E, IN, W2, occ_sum, ht, hk, hm, hv, hw, head, A.block,
                B, overflow, occ_in, occ_heap, ctl);
        return (int)cudaGetLastError();
    };
    if (nblk == 1 && is_outbox(*rows_a, F_a))
        return launch(Launch<OutboxRows>{Block<OutboxRows>{
            OutboxRows(*rows_a), perm_a, starts_a, counts_a,
            (int64_t)F_a}});
    return launch(Launch<Rows>{Block<Rows>{*rows_a, perm_a, starts_a,
                                           counts_a, (int64_t)F_a}});
}
