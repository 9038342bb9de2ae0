// K10 judge_batch: the hybrid policy's batched network judgment.
//
// Replaces shadow_tpu/device/judge.py `DeviceJudge._judge` (judge.py:80-105,
// called from `judge_batch` at :116): for each of N deferred packets
// (send time now, src and dst host, per-source packet seq), the path
// latency and reliability between the hosts' vertices in the epoch of
// the send time (the dense gather, or the factored two-level lookup of
// shadow_tpu/topology/hierarchy.py `gather_parts`), and the drop roll of
// shadow_tpu/device/netsem.py `packet_drop_mask`: a packet drops iff
// rel < 1, now >= bootstrap_end and uniform01(fold(seed, DROP, src, seq))
// >= rel, compared in float32 (threefry.cuh, as K2 rolls). Outputs
// delivered[i] (0/1) and deliver_time[i] = now[i] + latency. The
// packet's seq is the batch's int32 column read as u32, as the reference
// reads it. The reference pads a batch to a power-of-two bucket so that
// XLA compiles few shapes; a launch takes N as it is.
//
// Bound on the H100: bytes where nothing is lossy (20 bytes in and 9 out
// a packet, plus the table cells the batch touches); a rolled packet
// costs two threefry blocks at the least (the seq fold and the uniform;
// the (seed, purpose) and (., src) folds are per sender), so a lossy
// batch of few senders is bound by the integer rate.
//
// The design (`judge_kernel`), over tables built once, at DeviceJudge's
// construction (device/kernels.py `judge_tables`):
// * the drop keys, purpose_id_key(seed, DROP, h) of every host h, an
//   [H, 2] table: a rolled packet costs two threefry blocks (the seq
//   fold and the uniform), not four, and reads its key only when it
//   rolls. A sender outside [0, H) (its lookup reads `host_row`, the
//   roll its raw id) takes the full chain from its raw id, as the
//   reference does: the table is never read at another index;
// * dense: host_vertex and the [(T,) V, V] gathers, as before;
// * factored, one epoch: a record a host {vertex, cluster, acc_lat,
//   acc_rel bits} (16 bytes); under the [T] epoch axis {vertex,
//   cluster} (8 bytes) with the access pair packed [T, V] {lat, rel
//   bits}; the core pair packed [(T,) C, C] {lat, rel bits}. A lookup is
//   one load an end and one for the core (which waits on the records
//   alone), where topo.cuh's HierTopo waits on host_vertex, then cl and
//   the access vectors, then the core. Same-vertex pairs read
//   self_lat/self_rel by vertex. The composition is the reference's
//   (topo.cuh): int32 additions, (acc_s * core) * acc_d with __fmul_rn,
//   never contracted; the core offset is computed once;
// * a thread a packet in blocks of 256, both ends' loads issued before
//   either is used; the epoch starts read once a block into shared
//   memory.
// `shadow_judge_flush` is a flush in one call: a CUDA graph built at
// construction (`shadow_judge_graph`) of the copy in from the pinned
// buffer, an empty kernel (`judge_flush_mark`), the launch and the copy
// out, with events between; a flush sets the nodes' sizes and pointers,
// launches the graph on the caller's stream, waits for its last event
// and reads the elapsed times. The device runs the graph's nodes back to
// back, so the pair around the launch holds no host time (a stream's
// pair held the host's launch call after a short copy in); the empty
// kernel moves the pair's first event from the copy engine's end of the
// copy to the compute engine, so the pair holds no hand-off between the
// two either (PERF.md, PR 15).
//
// The design before (`judge_batch_before_kernel`, `shadow_judge_batch`;
// `Kernels.designs_before`, kept to measure against): a thread a packet
// over topo.cuh's views, the full four-block chain a rolled packet.
#include "common.cuh"
#include "threefry.cuh"
#include "topo.cuh"

#include <type_traits>

using namespace shadow;

namespace {

// The host row a judged id reads, as the reference's numpy and jax
// indexing read it: an id in [-H, -1] reads host id + H, every other id
// outside [0, H) the nearest end. The drop roll keys on the raw id.
__device__ __forceinline__ int host_row(int id, int H) {
    const int i = id < 0 ? id + H : id;
    return i < 0 ? 0 : (i > H - 1 ? H - 1 : i);
}

// ---------------------------------------------------------------------
// the design before
// ---------------------------------------------------------------------
template <class Topo>
__global__ void __launch_bounds__(256)
judge_batch_before_kernel(int64_t N, int H, int64_t boot_end,
                          const int64_t* __restrict__ now,
                          const int32_t* __restrict__ src,
                          const int32_t* __restrict__ dst,
                          const int32_t* __restrict__ seq,
                          const int32_t* __restrict__ host_vertex,
                          Topo topo, const int64_t* __restrict__ seed_key,
                          int64_t* __restrict__ deliver_time,
                          uint8_t* __restrict__ delivered) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= N) return;
    const int64_t t = now[i];
    int s = src[i], d = dst[i];
    s = host_row(s, H);
    d = host_row(d, H);
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

// ---------------------------------------------------------------------
// the design
// ---------------------------------------------------------------------
struct Path {
    int32_t lat;
    float rel;
};

// A view reads an end's lookup data, end(h), and gives a pair's (lat,
// rel) in epoch e, path(e, s, d).

// Dense [(T,) V, V] tables: an end is its vertex.
template <bool EP>
struct DenseJudge {
    static constexpr bool EPOCHS = EP;
    using End = int;
    const int32_t* hv;
    const int32_t* lat;
    const float* rel;
    int V;

    __device__ __forceinline__ End end(int h) const { return __ldg(&hv[h]); }
    __device__ __forceinline__ Path path(int e, End s, End d) const {
        int64_t cell = (int64_t)s * V + d;
        if (EP) cell += (int64_t)e * V * V;
        return Path{__ldg(&lat[cell]), __ldg(&rel[cell])};
    }
};

__device__ __forceinline__ Path compose(int32_t lat_s, float rel_s, int2 core,
                                        int32_t lat_d, float rel_d) {
    return Path{lat_s + core.x + lat_d,
                __fmul_rn(__fmul_rn(rel_s, __int_as_float(core.y)), rel_d)};
}

// Factored tables, one epoch: an end is its host's record {vertex,
// cluster, acc_lat, acc_rel bits}.
struct HierJudge1 {
    static constexpr bool EPOCHS = false;
    using End = int4;
    const int4* rec;
    const int2* core;
    const int32_t* self_lat;
    const float* self_rel;
    int C;

    __device__ __forceinline__ End end(int h) const { return __ldg(&rec[h]); }
    __device__ __forceinline__ Path path(int, const End& s,
                                         const End& d) const {
        if (s.x == d.x)
            return Path{__ldg(&self_lat[s.x]), __ldg(&self_rel[s.x])};
        const int2 c = __ldg(&core[s.y * C + d.y]);
        return compose(s.z, __int_as_float(s.w), c, d.z, __int_as_float(d.w));
    }
};

// Factored tables under the [T] epoch axis: an end is its host's record
// {vertex, cluster}; the access pair of epoch e is one 8-byte load from
// [T, V].
struct HierJudgeEp {
    static constexpr bool EPOCHS = true;
    using End = int2;
    const int2* rec;
    const int2* acc;
    const int2* core;
    const int32_t* self_lat;
    const float* self_rel;
    int C, V;

    __device__ __forceinline__ End end(int h) const { return __ldg(&rec[h]); }
    __device__ __forceinline__ Path path(int e, End s, End d) const {
        const int64_t ev = (int64_t)e * V;
        if (s.x == d.x)
            return Path{__ldg(&self_lat[ev + s.x]),
                        __ldg(&self_rel[ev + s.x])};
        const int2 as = __ldg(&acc[ev + s.x]);
        const int2 ad = __ldg(&acc[ev + d.x]);
        const int2 c = __ldg(&core[(int64_t)e * C * C + s.y * C + d.y]);
        return compose(as.x, __int_as_float(as.y), c, ad.x,
                       __int_as_float(ad.y));
    }
};

// epoch starts a block holds in shared memory; more are read from L1/L2
constexpr int SHARED_EPOCHS = 64;
constexpr int JUDGE_THREADS = 256;

// An empty kernel: in the flush graph it follows the copy in, so that
// the event opening K10's pair is recorded on the compute engine, not
// at the copy engine's end of the copy.
__global__ void judge_flush_mark() {}

template <class View>
__global__ void __launch_bounds__(JUDGE_THREADS)
judge_kernel(int64_t N, int H, int64_t boot_end, int T,
             const int64_t* __restrict__ ept,
             const int64_t* __restrict__ now,
             const int32_t* __restrict__ src,
             const int32_t* __restrict__ dst,
             const int32_t* __restrict__ seq, View view,
             const uint2* __restrict__ keys,
             const int64_t* __restrict__ seed_key,
             int64_t* __restrict__ deliver_time,
             uint8_t* __restrict__ delivered) {
    __shared__ int64_t s_ept[View::EPOCHS ? SHARED_EPOCHS : 1];
    const int64_t* starts = ept;
    if (View::EPOCHS && T <= SHARED_EPOCHS) {
        for (int j = threadIdx.x; j < T; j += blockDim.x)
            s_ept[j] = __ldg(&ept[j]);
        __syncthreads();
        starts = s_ept;
    }
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= N) return;
    const int64_t t = now[i];
    const int s = src[i], d = dst[i];
    const auto es = view.end(host_row(s, H));
    const auto ed = view.end(host_row(d, H));
    int e = 0;
    if (View::EPOCHS) {
        e = -1;
        for (int j = 0; j < T; ++j) e += t >= starts[j] ? 1 : 0;
        e = e < 0 ? 0 : e;
    }
    const Path p = view.path(e, es, ed);
    bool drop = false;
    if (p.rel < 1.0f && t >= boot_end) {
        // the table's key where the sender lies in [0, H), else the
        // chain of its raw id (read here, not beside the ends: loaded
        // early, the key cost the dense view 9%, PERF.md PR 15)
        Key k;
        if ((uint32_t)s < (uint32_t)H) {
            const uint2 kk = __ldg(&keys[s]);
            k = Key{kk.x, kk.y};
        } else {
            k = purpose_id_key(replica_seed(seed_key, 0),
                               PURPOSE_PACKET_DROP, (uint32_t)s);
        }
        drop = uniform01(fold_in(k, (uint32_t)seq[i])) >= p.rel;
    }
    delivered[i] = drop ? 0 : 1;
    deliver_time[i] = t + (int64_t)p.lat;
}

}  // namespace

// The judge's tables as device/kernels.py `JudgeArgs` holds them: the
// epoch starts [T], the seed key [1, 2] and the drop keys [H, 2] always;
// dense: host_vertex and the [(T,) V, V] pair; factored: the host
// records ([H, 4] {vertex, cluster, acc_lat, acc_rel} one epoch, [H, 2]
// {vertex, cluster} under epochs), the access pair [T, V, 2] (epochs
// only), the core pair [(T,) C, C, 2] and the self vectors [(T,) V].
// Other pointers null.
struct JudgeArgs {
    int H, hier, V, C, T;
    const int64_t* epoch_times;
    const int64_t* seed_key;
    const int32_t* keys;
    const int32_t* host_vertex;
    const int32_t* lat;
    const float* rel;
    const int32_t* records;
    const int32_t* access;
    const int32_t* core;
    const int32_t* self_lat;
    const float* self_rel;
};

namespace {

bool judge_args_ok(const JudgeArgs* a) {
    if (a == nullptr || a->H < 1 || a->V < 1 || a->T < 1 ||
        !a->epoch_times || !a->seed_key || !a->keys)
        return false;
    if (a->hier)
        return a->C > 0 && a->records && a->core && a->self_lat &&
               a->self_rel && (a->T == 1 || a->access);
    return a->host_vertex && a->lat && a->rel;
}

// Call f(view) with the view the tables select.
template <class F>
int with_view(const JudgeArgs& a, F&& f) {
    if (a.hier) {
        const int2* core = reinterpret_cast<const int2*>(a.core);
        if (a.T > 1)
            return f(HierJudgeEp{reinterpret_cast<const int2*>(a.records),
                                 reinterpret_cast<const int2*>(a.access),
                                 core, a.self_lat, a.self_rel, a.C, a.V});
        return f(HierJudge1{reinterpret_cast<const int4*>(a.records), core,
                            a.self_lat, a.self_rel, a.C});
    }
    if (a.T > 1)
        return f(DenseJudge<true>{a.host_vertex, a.lat, a.rel, a.V});
    return f(DenseJudge<false>{a.host_vertex, a.lat, a.rel, a.V});
}

// The launch of K10 on N packets whose columns lie at `in` (now | src |
// dst | seq, packed) and whose outputs go to `out` (deliver_time |
// delivered): the kernel of the view and its arguments, as a launch or
// a graph's kernel node takes them.
template <class View>
struct JudgeLaunch {
    int64_t N, boot_end;
    int H, T;
    const int64_t* ept;
    const int64_t *now;
    const int32_t *src, *dst, *seq;
    View view;
    const uint2* keys;
    const int64_t* seed_key;
    int64_t* deliver_time;
    uint8_t* delivered;
    void* params[14];

    JudgeLaunch(const JudgeArgs& a, const View& v, long long n,
                long long boot, const int64_t* now_, const int32_t* src_,
                const int32_t* dst_, const int32_t* seq_, int64_t* t_out,
                uint8_t* d_out)
        : N(n), boot_end(boot), H(a.H), T(a.T), ept(a.epoch_times),
          now(now_), src(src_), dst(dst_), seq(seq_), view(v),
          keys(reinterpret_cast<const uint2*>(a.keys)),
          seed_key(a.seed_key), deliver_time(t_out), delivered(d_out),
          params{&N, &H, &boot_end, &T, &ept, &now, &src, &dst, &seq,
                 &view, &keys, &seed_key, &deliver_time, &delivered} {}

    unsigned blocks() const {
        return (unsigned)((N + JUDGE_THREADS - 1) / JUDGE_THREADS);
    }
    cudaKernelNodeParams node() {
        cudaKernelNodeParams k = {};
        k.func = (void*)judge_kernel<View>;
        k.gridDim = dim3(blocks());
        k.blockDim = dim3(JUDGE_THREADS);
        k.kernelParams = params;
        return k;
    }
    int launch(cudaStream_t st) {
        judge_kernel<View><<<blocks(), JUDGE_THREADS, 0, st>>>(
            N, H, boot_end, T, ept, now, src, dst, seq, view, keys,
            seed_key, deliver_time, delivered);
        return (int)cudaGetLastError();
    }
};

// f(launch) with K10's launch on N packets of the packed buffers
template <class F>
int with_flush_launch(const JudgeArgs& a, long long N, long long boot_end,
                      void* dev_in, void* dev_out, F&& f) {
    char* in = static_cast<char*>(dev_in);
    char* out = static_cast<char*>(dev_out);
    return with_view(a, [&](const auto& view) {
        using View = std::decay_t<decltype(view)>;
        JudgeLaunch<View> l(
            a, view, N, boot_end, reinterpret_cast<const int64_t*>(in),
            reinterpret_cast<const int32_t*>(in + 8 * N),
            reinterpret_cast<const int32_t*>(in + 12 * N),
            reinterpret_cast<const int32_t*>(in + 16 * N),
            reinterpret_cast<int64_t*>(out),
            reinterpret_cast<uint8_t*>(out + 8 * N));
        return f(l);
    });
}

// A judge's flush graph: event 0, the copy in, the mark, event 1, K10,
// event 2, the copy out, event 3, each node after the one before.
struct JudgeFlush {
    cudaGraph_t graph = nullptr;
    cudaGraphExec_t exec = nullptr;
    cudaGraphNode_t copy_in = nullptr, kernel = nullptr, copy_out = nullptr;
    cudaEvent_t ev[4] = {};
};

}  // namespace

// K10 on device columns (now int64, src/dst/seq int32) into deliver_time
// int64 and delivered uint8.
extern "C" int shadow_judge_launch(const JudgeArgs* a, long long N,
                                   long long boot_end, const int64_t* now,
                                   const int32_t* src, const int32_t* dst,
                                   const int32_t* seq,
                                   int64_t* deliver_time, uint8_t* delivered,
                                   void* stream) {
    if (N < 0 || !judge_args_ok(a) ||
        (N + JUDGE_THREADS - 1) / JUDGE_THREADS > 0x7FFFFFFFLL)
        return (int)cudaErrorInvalidValue;
    if (N == 0) return (int)cudaSuccess;
    return with_view(*a, [&](const auto& view) {
        using View = std::decay_t<decltype(view)>;
        JudgeLaunch<View> l(*a, view, N, boot_end, now, src, dst, seq,
                            deliver_time, delivered);
        return l.launch((cudaStream_t)stream);
    });
}

extern "C" void shadow_judge_graph_free(void* state);

// A judge's flush graph over its four buffers (host in, device in,
// device out, host out: 20 and 9 bytes a packet, at least one packet)
// and its four timing events, instantiated on one packet; *state takes
// it. Free it with shadow_judge_graph_free.
extern "C" int shadow_judge_graph(const JudgeArgs* a, const void* host_in,
                                  void* dev_in, void* dev_out,
                                  void* host_out, void* const* events,
                                  void** state) {
    if (!judge_args_ok(a) || !events || !state)
        return (int)cudaErrorInvalidValue;
    JudgeFlush* f = new JudgeFlush;
    for (int j = 0; j < 4; ++j) f->ev[j] = (cudaEvent_t)events[j];
    cudaError_t err;
    cudaGraphNode_t n[8];
    cudaKernelNodeParams mark = {};
    mark.func = (void*)judge_flush_mark;
    mark.gridDim = dim3(1);
    mark.blockDim = dim3(1);
#define SHADOW_TRY(x)                   \
    if ((err = (x)) != cudaSuccess) {   \
        shadow_judge_graph_free(f);     \
        return (int)err;                \
    }
    SHADOW_TRY(cudaGraphCreate(&f->graph, 0));
    SHADOW_TRY(cudaGraphAddEventRecordNode(&n[0], f->graph, nullptr, 0,
                                           f->ev[0]));
    SHADOW_TRY(cudaGraphAddMemcpyNode1D(&n[1], f->graph, &n[0], 1, dev_in,
                                        host_in, 20,
                                        cudaMemcpyHostToDevice));
    SHADOW_TRY(cudaGraphAddKernelNode(&n[2], f->graph, &n[1], 1, &mark));
    SHADOW_TRY(cudaGraphAddEventRecordNode(&n[3], f->graph, &n[2], 1,
                                           f->ev[1]));
    SHADOW_TRY((cudaError_t)with_flush_launch(
        *a, 1, 0, dev_in, dev_out, [&](auto& l) {
            const cudaKernelNodeParams k = l.node();
            return (int)cudaGraphAddKernelNode(&n[4], f->graph, &n[3], 1,
                                               &k);
        }));
    SHADOW_TRY(cudaGraphAddEventRecordNode(&n[5], f->graph, &n[4], 1,
                                           f->ev[2]));
    SHADOW_TRY(cudaGraphAddMemcpyNode1D(&n[6], f->graph, &n[5], 1, host_out,
                                        dev_out, 9,
                                        cudaMemcpyDeviceToHost));
    SHADOW_TRY(cudaGraphAddEventRecordNode(&n[7], f->graph, &n[6], 1,
                                           f->ev[3]));
    SHADOW_TRY(cudaGraphInstantiate(&f->exec, f->graph, 0));
#undef SHADOW_TRY
    f->copy_in = n[1];
    f->kernel = n[4];
    f->copy_out = n[6];
    *state = f;
    return (int)cudaSuccess;
}

extern "C" void shadow_judge_graph_free(void* state) {
    JudgeFlush* f = static_cast<JudgeFlush*>(state);
    if (f == nullptr) return;
    if (f->exec) cudaGraphExecDestroy(f->exec);
    if (f->graph) cudaGraphDestroy(f->graph);
    delete f;
}

// One flush of N packets through the judge's graph (`state`): their
// columns, packed now | src | dst | seq (20 N bytes), in the pinned
// `host_in`, copied to `dev_in`; K10 into `dev_out`, packed deliver_time
// | delivered (9 N bytes), copied back to the pinned `host_out`. Waits
// for the graph's last event and writes the kernel's ms to ms[0] and the
// two copies' to ms[1].
extern "C" int shadow_judge_flush(const JudgeArgs* a, void* state,
                                  long long N, long long boot_end,
                                  const void* host_in, void* dev_in,
                                  void* dev_out, void* host_out, float* ms,
                                  void* stream) {
    JudgeFlush* f = static_cast<JudgeFlush*>(state);
    if (N < 0 || !judge_args_ok(a) || !f || !ms ||
        (N + JUDGE_THREADS - 1) / JUDGE_THREADS > 0x7FFFFFFFLL)
        return (int)cudaErrorInvalidValue;
    ms[0] = ms[1] = 0.f;
    if (N == 0) return (int)cudaSuccess;
    cudaError_t err;
#define SHADOW_TRY(x)                                 \
    if ((err = (x)) != cudaSuccess) return (int)err
    SHADOW_TRY(cudaGraphExecMemcpyNodeSetParams1D(
        f->exec, f->copy_in, dev_in, host_in, (size_t)N * 20,
        cudaMemcpyHostToDevice));
    SHADOW_TRY((cudaError_t)with_flush_launch(
        *a, N, boot_end, dev_in, dev_out, [&](auto& l) {
            const cudaKernelNodeParams k = l.node();
            return (int)cudaGraphExecKernelNodeSetParams(f->exec, f->kernel,
                                                         &k);
        }));
    SHADOW_TRY(cudaGraphExecMemcpyNodeSetParams1D(
        f->exec, f->copy_out, host_out, dev_out, (size_t)N * 9,
        cudaMemcpyDeviceToHost));
    SHADOW_TRY(cudaGraphLaunch(f->exec, (cudaStream_t)stream));
    SHADOW_TRY(cudaEventSynchronize(f->ev[3]));
    float c_in = 0.f, c_out = 0.f;
    SHADOW_TRY(cudaEventElapsedTime(&ms[0], f->ev[1], f->ev[2]));
    SHADOW_TRY(cudaEventElapsedTime(&c_in, f->ev[0], f->ev[1]));
    SHADOW_TRY(cudaEventElapsedTime(&c_out, f->ev[2], f->ev[3]));
#undef SHADOW_TRY
    ms[1] = c_in + c_out;
    return (int)cudaGetLastError();
}

// The design before: a thread a packet over topo.cuh's views.
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
            judge_batch_before_kernel<<<(unsigned)blocks, threads, 0,
                                        (cudaStream_t)stream>>>(
                (int64_t)N, H, (int64_t)boot_end, now, src, dst, seq,
                host_vertex, view, seed_key, deliver_time, delivered);
        });
    }
    return (int)cudaGetLastError();
}
