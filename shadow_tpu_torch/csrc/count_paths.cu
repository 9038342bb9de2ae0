// K7 count_paths: the per-path packet counters of one phase.
//
// Replaces shadow_tpu/device/engine.py `_count_paths` (the reference's
// topology_incrementPathPacketCounter): a [V*V] histogram of the packets
// each judged outbox row sent, drop-rolled ones included, at
// (vertex of src) * V + (vertex of dst). A row counts when t < INF (the
// judge marks a dead row DROP_T under the path counters, so it still
// counts) and its kind byte is KIND_PACKET; its weight is the live count
// in the kind word's upper bits (kind >> 8). The reference sorts the
// rows by pair and takes prefix-sum segment totals, a TPU's way round a
// scatter; here one thread takes one outbox row and adds its weight with
// a 64-bit atomicAdd. Integer sums are exact in any order, so the
// histogram equals the reference's whatever order the atomics land in.
//
// Under the window loop the launch returns at once where the control
// block's RUN word is 0 (common.cuh `Ctl`). The replica axis of an
// ensemble campaign is blockIdx.y: replica r's rows add to its own
// histogram, path_cnt [R, 1, V*V].
//
// Bound on the H100: bytes: t of every row (H*OB*8), k and m of the
// packet rows, and the histogram's touched entries; the atomics on a
// few hot pairs (V*V <= 65536, so the histogram sits in L2) serialize
// there, which is later work (a per-block shared-memory histogram).
#include "common.cuh"

using namespace shadow;

namespace {

__global__ void count_paths_kernel(int64_t rows, int OB, int H, int V,
                                   const int64_t* __restrict__ ob_t,
                                   const int64_t* __restrict__ ob_k,
                                   const int64_t* __restrict__ ob_m,
                                   const int32_t* __restrict__ host_vertex,
                                   unsigned long long* path_cnt,
                                   const int64_t* ctl) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int64_t r = blockIdx.y;
    if (i >= rows || phase_off(replica_ctl(ctl, r))) return;
    const int64_t row = r * rows + i;
    if (!(ob_t[row] < INF)) return;
    const int64_t fm = ob_m[row];
    const int32_t kind = lo32(fm);
    if ((kind & 0xFF) != KIND_PACKET) return;
    const int32_t src = hi32(ob_k[row]);
    const int32_t dst = hi32(fm);
    const int sh = src < 0 ? 0 : (src > H - 1 ? H - 1 : src);
    const int dh = dst < 0 ? 0 : (dst > H - 1 ? H - 1 : dst);
    const int64_t pair = r * (int64_t)V * V +
        (int64_t)host_vertex[sh] * V + (int64_t)host_vertex[dh];
    atomicAdd(&path_cnt[pair], (unsigned long long)(int64_t)(kind >> 8));
}

}  // namespace

extern "C" int shadow_count_paths(int R, int H, int OB, int V,
                                  const int64_t* ob_t, const int64_t* ob_k,
                                  const int64_t* ob_m,
                                  const int32_t* host_vertex,
                                  int64_t* path_cnt, const int64_t* ctl,
                                  void* stream) {
    if (R < 1 || R > 65535 || V <= 0 || (int64_t)V * V > 65536)
        return (int)cudaErrorInvalidValue;
    const int64_t rows = (int64_t)H * OB;
    if (rows > 0) {
        const int threads = 256;
        const int64_t blocks = (rows + threads - 1) / threads;
        count_paths_kernel<<<dim3((unsigned)blocks, R), threads, 0,
                             (cudaStream_t)stream>>>(
            rows, OB, H, V, ob_t, ob_k, ob_m, host_vertex,
            reinterpret_cast<unsigned long long*>(path_cnt), ctl);
    }
    return (int)cudaGetLastError();
}
