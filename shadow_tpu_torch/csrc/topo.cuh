// The path tables as the kernels read them: two device-side views with
// one interface, lat(sv, dv), rel(sv, dv) and self_lat(v), so the judge
// (K2) and the pops (K1, K4, K6) are templates over the view.
//
// DenseTopo: the [V,V] int32 latency and float32 reliability matrices,
// one gather per lookup (shadow_tpu/device/engine.py `_tbl`, T=1).
//
// HierTopo: the cluster-factored tables of `representation: hierarchical`
// (shadow_tpu/topology/hierarchy.py `gather_parts`, single epoch): a
// [C,C] core pair over the hubs and [V] vectors of cluster, access terms
// and self paths. A lookup is two levels: the vertices' clusters and
// access terms, then the core entry of the cluster pair;
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
// Bound on the H100: at V = 1,000,200, C = 200 the tables are 28.5 MB
// (the [V] vectors 24 MB, the core pair 320 KB), so they sit in the
// 50 MB L2 after first touch. A lookup costs five loads where the dense
// view costs one (the clusters and access terms of both ends, then the
// core entry, which waits on the clusters), all through the read-only
// cache; the kernels that call it stay bound by their own row traffic.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace shadow {

// The host's description of the tables, passed by pointer through the
// C interface: `hier` selects the view; the other view's pointers are
// null.
struct TopoArgs {
    int hier;
    int V, C;
    const int32_t* lat;        // dense [V,V]
    const float* rel;
    const int32_t* core_lat;   // factored [C,C]
    const float* core_rel;
    const int32_t* cl;         // factored [V]
    const int32_t* acc_lat;
    const float* acc_rel;
    const int32_t* self_lat;
    const float* self_rel;
};

struct DenseTopo {
    const int32_t* tab_lat;
    const float* tab_rel;
    int V;

    __device__ __forceinline__ int32_t lat(int sv, int dv) const {
        return __ldg(&tab_lat[(int64_t)sv * V + dv]);
    }
    __device__ __forceinline__ float rel(int sv, int dv) const {
        return __ldg(&tab_rel[(int64_t)sv * V + dv]);
    }
    __device__ __forceinline__ int32_t self_lat(int v) const {
        return lat(v, v);
    }
};

struct HierTopo {
    const int32_t* core_lat;
    const float* core_rel;
    const int32_t* cl;
    const int32_t* acc_lat;
    const float* acc_rel;
    const int32_t* slf_lat;
    const float* slf_rel;
    int C;

    __device__ __forceinline__ int64_t core(int sv, int dv) const {
        return (int64_t)__ldg(&cl[sv]) * C + __ldg(&cl[dv]);
    }
    __device__ __forceinline__ int32_t lat(int sv, int dv) const {
        if (sv == dv) return __ldg(&slf_lat[sv]);
        return __ldg(&acc_lat[sv]) + __ldg(&core_lat[core(sv, dv)]) +
               __ldg(&acc_lat[dv]);
    }
    __device__ __forceinline__ float rel(int sv, int dv) const {
        if (sv == dv) return __ldg(&slf_rel[sv]);
        return __fmul_rn(__fmul_rn(__ldg(&acc_rel[sv]),
                                   __ldg(&core_rel[core(sv, dv)])),
                         __ldg(&acc_rel[dv]));
    }
    __device__ __forceinline__ int32_t self_lat(int v) const {
        return __ldg(&slf_lat[v]);
    }
};

inline DenseTopo dense_topo(const TopoArgs& t) {
    return DenseTopo{t.lat, t.rel, t.V};
}

inline HierTopo hier_topo(const TopoArgs& t) {
    return HierTopo{t.core_lat, t.core_rel, t.cl, t.acc_lat, t.acc_rel,
                    t.self_lat, t.self_rel, t.C};
}

// Whether the view `t` selects has all its tables.
inline bool topo_ok(const TopoArgs* t) {
    if (t == nullptr || t->V <= 0) return false;
    if (t->hier)
        return t->C > 0 && t->core_lat && t->core_rel && t->cl &&
               t->acc_lat && t->acc_rel && t->self_lat && t->self_rel;
    return t->lat && t->rel;
}

}  // namespace shadow
