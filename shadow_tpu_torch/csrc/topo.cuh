// The path tables as the kernels read them: two device-side views with
// one interface, epoch(t), lat(e, sv, dv), rel(e, sv, dv) and
// self_lat(e, v), so the judge (K2) and the pops (K1, K4, K6) are
// templates over the view.
//
// DenseTopo: the [V,V] int32 latency and float32 reliability matrices,
// one gather per lookup (shadow_tpu/device/engine.py `_tbl`).
//
// HierTopo: the cluster-factored tables of `representation: hierarchical`
// (shadow_tpu/topology/hierarchy.py `gather_parts`): a [C,C] core pair
// over the hubs and [V] vectors of cluster, access terms and self paths.
// A lookup is two levels: the vertices' clusters and access terms, then
// the core entry of the cluster pair;
//   lat = sv == dv ? self_lat[sv] : acc_lat[sv] + core_lat[cs*C+cd] +
//                                   acc_lat[dv]           (int32)
//   rel = sv == dv ? self_rel[sv] : (acc_rel[sv] * core_rel[cs*C+cd]) *
//                                   acc_rel[dv]           (float32)
// The additions are int32, as the reference's int32 leaves add, and the
// engine's max_composed_latency check keeps every sum inside int32; the
// caller widens to int64 afterwards. The two float32 multiplies are
// __fmul_rn: round to nearest each, in the reference's order, never
// contracted. sv == dv takes the self vector for any two hosts on one
// vertex, not only for a host and itself.
//
// Fault epochs (faults.py): under a link-fault schedule every table has a
// leading [T] axis ([T,V,V] dense; [T,C,C] core and [T,V] access and self
// vectors factored, with the one [V] cl vector every epoch shares) and
// `epoch_times` [T] holds the epoch starts, epoch_times[0] = 0. A lookup
// at time t reads epoch e = (number of starts <= t) - 1, the reference's
// `_ep_of`; T is small (a handful of fault edges), so epoch() is a linear
// count over the starts, all in the read-only cache, not a binary search.
// A row time of INF selects the last epoch, harmlessly: such rows are
// not sends. The views are templates over EP: EP = false (one epoch) is
// the single-epoch code with no epoch arithmetic at all, epoch() a
// constant 0.
//
// Ensemble campaigns (shadow_tpu_torch/ensemble/) stack R replicas' tables
// on a leading axis: each leaf but cl carries it ([R,(T,)V,V] dense;
// [R,(T,)C,C] and [R,(T,)V] factored; epoch_times [R,T]), and
// `TopoStrides` holds the elements between one replica's leaf and the
// next's, 0 for a leaf every replica shares (cl always; every leaf of a
// standalone run). A kernel takes the view of its replica with
// `at_replica(r, strides)` once, before any lookup, so the lookups
// themselves are the standalone code.
//
// Bound on the H100: at V = 1,000,200, C = 200 the factored tables are
// 28.5 MB (the [V] vectors 24 MB, the core pair 320 KB), 6 epochs of the
// changed leaves add at most 6x that, so they sit mostly in the 50 MB L2
// after first touch. A lookup costs five loads where the dense view costs
// one (the clusters and access terms of both ends, then the core entry,
// which waits on the clusters), plus T start times for the epoch, all
// through the read-only cache; the kernels that call it stay bound by
// their own row traffic.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace shadow {

// The host's description of the tables, passed by pointer through the
// C interface: `hier` selects the view, T the epoch count; the other
// view's pointers are null.
struct TopoArgs {
    int hier;
    int V, C, T;
    const int64_t* epoch_times;  // [(R,)T]
    const int32_t* lat;          // dense [(R,)(T,)V,V]
    const float* rel;
    const int32_t* core_lat;     // factored [(R,)(T,)C,C]
    const float* core_rel;
    const int32_t* cl;           // factored [V], shared by every epoch
                                 // and every replica
    const int32_t* acc_lat;      // factored [(R,)(T,)V]
    const float* acc_rel;
    const int32_t* self_lat;
    const float* self_rel;
    // replica strides in elements (0: shared): epoch_times, the dense
    // pair, the core pair, the access pair, the self pair
    long long rs_ept, rs_tab, rs_core, rs_acc, rs_self;
};

struct TopoStrides {
    long long ept, tab, core, acc, slf;
};

inline TopoStrides topo_strides(const TopoArgs& t) {
    return TopoStrides{t.rs_ept, t.rs_tab, t.rs_core, t.rs_acc, t.rs_self};
}

// e = (number of epoch starts <= t) - 1
__device__ __forceinline__ int epoch_index(const int64_t* __restrict__ ept,
                                           int T, int64_t t) {
    int e = -1;
    for (int i = 0; i < T; ++i) e += t >= __ldg(&ept[i]) ? 1 : 0;
    return e < 0 ? 0 : e;
}

template <bool EP>
struct DenseTopo {
    static constexpr bool EPOCHS = EP;
    const int32_t* tab_lat;
    const float* tab_rel;
    const int64_t* ept;
    int V, T;

    __device__ __forceinline__ int epoch(int64_t t) const {
        return EP ? epoch_index(ept, T, t) : 0;
    }
    __device__ __forceinline__ int64_t at(int e, int sv, int dv) const {
        const int64_t cell = (int64_t)sv * V + dv;
        return EP ? (int64_t)e * V * V + cell : cell;
    }
    __device__ __forceinline__ int32_t lat(int e, int sv, int dv) const {
        return __ldg(&tab_lat[at(e, sv, dv)]);
    }
    __device__ __forceinline__ float rel(int e, int sv, int dv) const {
        return __ldg(&tab_rel[at(e, sv, dv)]);
    }
    __device__ __forceinline__ int32_t self_lat(int e, int v) const {
        return lat(e, v, v);
    }
    __device__ __forceinline__ DenseTopo at_replica(
        int64_t r, const TopoStrides& s) const {
        DenseTopo v = *this;
        v.tab_lat += r * s.tab;
        v.tab_rel += r * s.tab;
        v.ept += r * s.ept;
        return v;
    }
};

template <bool EP>
struct HierTopo {
    static constexpr bool EPOCHS = EP;
    const int32_t* core_lat;
    const float* core_rel;
    const int32_t* cl;
    const int32_t* acc_lat;
    const float* acc_rel;
    const int32_t* slf_lat;
    const float* slf_rel;
    const int64_t* ept;
    int C, V, T;

    __device__ __forceinline__ int epoch(int64_t t) const {
        return EP ? epoch_index(ept, T, t) : 0;
    }
    // offsets of epoch e in the [T,C,C] and [T,V] leaves
    __device__ __forceinline__ int64_t core(int e, int sv, int dv) const {
        const int64_t cell = (int64_t)__ldg(&cl[sv]) * C + __ldg(&cl[dv]);
        return EP ? (int64_t)e * C * C + cell : cell;
    }
    __device__ __forceinline__ int64_t vec(int e, int v) const {
        return EP ? (int64_t)e * V + v : (int64_t)v;
    }
    __device__ __forceinline__ int32_t lat(int e, int sv, int dv) const {
        if (sv == dv) return __ldg(&slf_lat[vec(e, sv)]);
        return __ldg(&acc_lat[vec(e, sv)]) +
               __ldg(&core_lat[core(e, sv, dv)]) +
               __ldg(&acc_lat[vec(e, dv)]);
    }
    __device__ __forceinline__ float rel(int e, int sv, int dv) const {
        if (sv == dv) return __ldg(&slf_rel[vec(e, sv)]);
        return __fmul_rn(__fmul_rn(__ldg(&acc_rel[vec(e, sv)]),
                                   __ldg(&core_rel[core(e, sv, dv)])),
                         __ldg(&acc_rel[vec(e, dv)]));
    }
    __device__ __forceinline__ int32_t self_lat(int e, int v) const {
        return __ldg(&slf_lat[vec(e, v)]);
    }
    __device__ __forceinline__ HierTopo at_replica(
        int64_t r, const TopoStrides& s) const {
        HierTopo v = *this;
        v.core_lat += r * s.core;
        v.core_rel += r * s.core;
        v.acc_lat += r * s.acc;
        v.acc_rel += r * s.acc;
        v.slf_lat += r * s.slf;
        v.slf_rel += r * s.slf;
        v.ept += r * s.ept;
        return v;
    }
};

template <bool EP>
inline DenseTopo<EP> dense_topo(const TopoArgs& t) {
    return DenseTopo<EP>{t.lat, t.rel, t.epoch_times, t.V, t.T};
}

template <bool EP>
inline HierTopo<EP> hier_topo(const TopoArgs& t) {
    return HierTopo<EP>{t.core_lat, t.core_rel, t.cl, t.acc_lat, t.acc_rel,
                        t.self_lat, t.self_rel, t.epoch_times, t.C, t.V,
                        t.T};
}

// Whether the view `t` selects has all its tables and its epoch starts.
inline bool topo_ok(const TopoArgs* t) {
    if (t == nullptr || t->V <= 0 || t->T <= 0 || !t->epoch_times ||
        t->rs_ept < 0 || t->rs_tab < 0 || t->rs_core < 0 || t->rs_acc < 0 ||
        t->rs_self < 0)
        return false;
    if (t->hier)
        return t->C > 0 && t->core_lat && t->core_rel && t->cl &&
               t->acc_lat && t->acc_rel && t->self_lat && t->self_rel;
    return t->lat && t->rel;
}

// Call f(view) with the instantiation `t` selects: dense or factored,
// one epoch or T > 1.
template <class F>
inline void with_topo(const TopoArgs& t, F&& f) {
    if (t.hier) {
        if (t.T > 1) f(hier_topo<true>(t));
        else f(hier_topo<false>(t));
    } else {
        if (t.T > 1) f(dense_topo<true>(t));
        else f(dense_topo<false>(t));
    }
}

}  // namespace shadow
