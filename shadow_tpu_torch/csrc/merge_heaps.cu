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

__global__ void merge_heaps_kernel(
    int E, int IN, int W2, int64_t F, int64_t* ht, int64_t* hk,
    int64_t* hm, int64_t* hv, int64_t* hw, int32_t* head,
    const int64_t* __restrict__ ob_t, const int64_t* __restrict__ ob_k,
    const int64_t* __restrict__ ob_m, const int64_t* __restrict__ ob_s,
    const int64_t* __restrict__ ob_v, const int64_t* __restrict__ perm,
    const int64_t* __restrict__ starts, const int64_t* __restrict__ counts,
    int32_t* overflow, int32_t* occ_in, int32_t* occ_heap,
    const int64_t* ctl) {
    const int64_t r = blockIdx.y;
    if (phase_off(replica_ctl(ctl, r))) return;
    // replica r: H = gridDim.x hosts, F outbox rows
    const int64_t rh = r * gridDim.x;
    ht += rh * E;
    hk += rh * E;
    hm += rh * E;
    hv += rh * E;
    hw += rh * E;
    head += rh;
    ob_t += r * F;
    ob_k += r * F;
    ob_m += r * F;
    ob_s += r * F;
    ob_v += r * F;
    perm += r * F;
    starts += rh;
    counts += rh;
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
    const int64_t cnt = counts[h];
    const int nin = cnt < IN ? (int)cnt : IN;
    const int64_t s0 = starts[h];
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
            if (a < nin) {
                const int64_t r = perm[s0 + a];
                t = ob_t[r];
                k = ob_k[r];
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
            if (j < E + IN && st[j] < INF) ++over;
            continue;
        }
        if (st[j] < INF) ++live;
        const int src = si[j];
        int64_t m = 0, v = 0, w = 0;
        if (src < E) {
            m = hm[hrow + src];
            v = hv[hrow + src];
            w = hw[hrow + src];
        } else if (src - E < nin) {
            const int64_t r = perm[s0 + (src - E)];
            const int64_t fs = ob_s[r], fv = ob_v[r];
            m = pack2((uint32_t)(lo32(ob_m[r]) & 0xFF), (uint32_t)hi32(fs));
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
        const int64_t over_in = cnt > IN ? cnt - IN : 0;
        overflow[h] += (int32_t)over_in + n_over;
        occ_in[h] = max(occ_in[h], (int32_t)cnt);
        occ_heap[h] = max(occ_heap[h], n_live);
        head[h] = 0;
    }
}

}  // namespace

extern "C" int shadow_merge_heaps(
    int R, int H, int E, int IN, long long F, int64_t* ht, int64_t* hk,
    int64_t* hm, int64_t* hv, int64_t* hw, int32_t* head,
    const int64_t* ob_t, const int64_t* ob_k, const int64_t* ob_m,
    const int64_t* ob_s, const int64_t* ob_v, const int64_t* perm,
    const int64_t* starts, const int64_t* counts, int32_t* overflow,
    int32_t* occ_in, int32_t* occ_heap, const int64_t* ctl, void* stream) {
    if (R < 1 || R > 65535) return (int)cudaErrorInvalidValue;
    int W2 = 1;
    while (W2 < E + IN) W2 <<= 1;
    const size_t smem = sizeof(int64_t) * (2 * (size_t)W2 + 3 * (size_t)E) +
                        sizeof(int32_t) * (size_t)W2;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            merge_heaps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    if (H > 0) {
        const int threads = W2 < 256 ? W2 : 256;
        merge_heaps_kernel<<<dim3(H, R), threads, smem,
                             (cudaStream_t)stream>>>(
            E, IN, W2, (int64_t)F, ht, hk, hm, hv, hw, head, ob_t, ob_k,
            ob_m, ob_s, ob_v, perm, starts, counts, overflow, occ_in,
            occ_heap, ctl);
    }
    return (int)cudaGetLastError();
}
