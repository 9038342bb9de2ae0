// K10 judge_batch: the hybrid policy's batched network judgment.
//
// Replaces shadow_tpu/device/judge.py `DeviceJudge._judge` (judge.py:80-105,
// called from `judge_batch` at :116): for each of N deferred packets
// (send time now, src and dst host, per-source packet seq), the path
// latency and reliability between the hosts' vertices in the epoch of
// the send time (the dense gather, or the factored two-level lookup of
// shadow_tpu/topology/hierarchy.py `gather_parts`, through the views of
// topo.cuh, of which the kernel is a template), and the drop roll of
// shadow_tpu/device/netsem.py `packet_drop_mask`: a packet drops iff
// rel < 1, now >= bootstrap_end and uniform01(fold(seed, DROP, src, seq))
// >= rel, compared in float32 (threefry.cuh, as K2 rolls). Outputs
// delivered[i] (0/1) and deliver_time[i] = now[i] + latency.
//
// The reference pads a batch to a power-of-two bucket so that XLA
// compiles few shapes; this launch takes N as it is. One thread per
// packet: the four input columns are read side by side (coalesced) from
// the one buffer the host copied in, and the two outputs written side by
// side into the one buffer the host copies back (device/judge.py).
// The packet's seq is the batch's int32 column read as u32, as the
// reference reads it.
//
// Bound on the H100: bytes where nothing is lossy (20 bytes in and 9
// out per packet, plus the table cells the batch touches); each rolled
// packet costs four threefry blocks here (~290 integer operations; two
// are the minimum, the (seed, purpose) and (., src) folds being per
// source), so a fully lossy batch is bound by the integer rate instead.
#include "common.cuh"
#include "threefry.cuh"
#include "topo.cuh"

using namespace shadow;

namespace {

template <class Topo>
__global__ void __launch_bounds__(256)
judge_batch_kernel(int64_t N, int H, int64_t boot_end,
                   const int64_t* __restrict__ now,
                   const int32_t* __restrict__ src,
                   const int32_t* __restrict__ dst,
                   const int32_t* __restrict__ seq,
                   const int32_t* __restrict__ host_vertex, Topo topo,
                   const int64_t* __restrict__ seed_key,
                   int64_t* __restrict__ deliver_time,
                   uint8_t* __restrict__ delivered) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= N) return;
    const int64_t t = now[i];
    int s = src[i], d = dst[i];
    s = s < 0 ? 0 : (s > H - 1 ? H - 1 : s);
    d = d < 0 ? 0 : (d > H - 1 ? H - 1 : d);
    const int vs = __ldg(&host_vertex[s]);
    const int vd = __ldg(&host_vertex[d]);
    const int e = topo.epoch(t);
    const int64_t lat = topo.lat(e, vs, vd);
    const float rel = topo.rel(e, vs, vd);
    bool drop = false;
    if (rel < 1.0f && t >= boot_end) {
        const Key seed = replica_seed(seed_key, 0);
        const Key k = purpose_id_key(seed, PURPOSE_PACKET_DROP,
                                     (uint32_t)src[i]);
        drop = uniform01(fold_in(k, (uint32_t)seq[i])) >= rel;
    }
    delivered[i] = drop ? 0 : 1;
    deliver_time[i] = t + lat;
}

}  // namespace

extern "C" int shadow_judge_batch(
    long long N, int H, long long boot_end, const int64_t* now,
    const int32_t* src, const int32_t* dst, const int32_t* seq,
    const int32_t* host_vertex, const TopoArgs* topo,
    const int64_t* seed_key, int64_t* deliver_time, uint8_t* delivered,
    void* stream) {
    if (N < 0 || H < 1 || !topo_ok(topo) || seed_key == nullptr ||
        topo->rs_ept != 0 || topo->rs_tab != 0 || topo->rs_core != 0 ||
        topo->rs_acc != 0 || topo->rs_self != 0)
        return (int)cudaErrorInvalidValue;
    if (N > 0) {
        const int threads = 256;
        const long long blocks = (N + threads - 1) / threads;
        if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
        with_topo(*topo, [&](auto view) {
            judge_batch_kernel<<<(unsigned)blocks, threads, 0,
                                 (cudaStream_t)stream>>>(
                (int64_t)N, H, (int64_t)boot_end, now, src, dst, seq,
                host_vertex, view, seed_key, deliver_time, delivered);
        });
    }
    return (int)cudaGetLastError();
}
