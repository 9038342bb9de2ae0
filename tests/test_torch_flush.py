"""The flush's route (K5) and merge (K3) as csrc/route.cu and
csrc/merge_heaps.cu compute them, on the CPU.

The invariants K3 rests on, over every merge of PHOLD, tgen, a cut Tor
and a campaign at R = 3 (run by the port's plain path): at every merge
entry each host's rows [head, E) are in (t, key) order; a host with
head 0 and no arrivals leaves `merge_heaps_plain` bit-identical in every
leaf but occ_heap, which rises to its live rows; the audit's
`heap_swap` corruption leaves a row out of order, which the plain merge
re-sorts.

Numpy mirrors of the two kernels' algorithms, used by nothing else:
`route_mirror` (the compaction by tiles, the stable 8-bit radix passes
with their per-tile ranks and look-back offsets, the identity passes
skipped, the bounds by binary search) and `merge_mirror` (per host: the
unchanged host kept, the merge of the sorted tail with the ranked
arrivals by co-rank, the full sort where a checked tail is out of
order, the fresh word cleared unless a heap keeps a row past INF), held
equal to `route_plain`/`route_rows_plain` (keyed too) and
`merge_heaps_plain` on every merge of those runs, on the five audit
corruptions run on, and on adversarial outboxes (every live row to one
destination, an empty outbox, 2^20 destinations, keyed rows in S = 4
peer runs, two arrival blocks). Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

INF = 1 << 62
DROP_T = INF - 1
IMAX = (1 << 63) - 1
BINS = 256
# the mirror's tile, small so that a test's outbox spans many tiles
# (csrc/route.cu's pass tile is 2048 rows)
TILE = 64

# tests/test_torch_audit.py's PHOLD, tgen and Tor, and BUSY (PHOLD
# without loss at msgload 4 with self-sends and a 50 ms runahead)
PHOLD = """
general: {stop_time: 2s, seed: 5}
network:
  graph:
    type: gml
    inline: |
      graph [ directed 0
        node [ id 0 bandwidth_down "100 Mbit" bandwidth_up "100 Mbit" ]
        node [ id 1 bandwidth_down "100 Mbit" bandwidth_up "100 Mbit" ]
        edge [ source 0 target 0 latency "30 ms" packet_loss 0.1 ]
        edge [ source 0 target 1 latency "10 ms" packet_loss 0.1 ]
        edge [ source 1 target 1 latency "30 ms" packet_loss 0.1 ] ]
experimental:
  scheduler_policy: tpu
  event_capacity: 64
  outbox_capacity: 16
  judge_placement: flush
  merge_strategy: window
hosts:
  left:
    quantity: 8
    network_node_id: 0
    processes: [{path: model:phold, args: msgload=2, start_time: 100ms}]
  right:
    quantity: 8
    network_node_id: 1
    processes: [{path: model:phold, args: msgload=2, start_time: 150ms}]
"""

TGEN = """
general: {stop_time: 3s, seed: 11}
network:
  graph:
    type: gml
    inline: |
      graph [ directed 0
        node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        node [ id 1 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        edge [ source 0 target 0 latency "10 ms" packet_loss 0.15 ]
        edge [ source 0 target 1 latency "20 ms" packet_loss 0.15 ]
        edge [ source 1 target 1 latency "10 ms" packet_loss 0.15 ] ]
experimental:
  scheduler_policy: tpu
  event_capacity: 192
  outbox_capacity: 256
  burst_pops: 8
hosts:
  server:
    network_node_id: 0
    processes: [{path: model:tgen_server, start_time: 10ms}]
  client:
    quantity: 6
    network_node_id: 1
    processes:
    - {path: model:tgen_client, start_time: 100ms,
       args: server=server size=200KiB count=40 pause=50ms retry=300ms}
"""

TOR = """
general: {stop_time: 4s, seed: 1}
network:
  graph:
    type: gml
    inline: |
      graph [ directed 0
        node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        node [ id 1 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        edge [ source 0 target 0 latency "20 ms" packet_loss 0.05 ]
        edge [ source 0 target 1 latency "40 ms" packet_loss 0.05 ]
        edge [ source 1 target 1 latency "20 ms" packet_loss 0.05 ] ]
experimental:
  scheduler_policy: tpu
  event_capacity: 96
  outbox_capacity: 48
hosts:
  relay:
    quantity: 8
    network_node_id: 0
    processes: [{path: model:tor_relay, start_time: 100ms}]
  client:
    quantity: 8
    network_node_id: 1
    processes:
    - {path: model:tor_client, start_time: 1s,
       args: cells=48 count=2 pause=500ms retry=2s}
"""

# tests/test_torch_ensemble.py's SMALL, a campaign of three seeds
CAMPAIGN = """
general: {stop_time: 1500ms, seed: 1}
network:
  graph:
    type: gml
    inline: |
      graph [ directed 0
        node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        node [ id 1 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        edge [ source 0 target 0 latency "10 ms" packet_loss 0.0 ]
        edge [ source 0 target 1 latency "5 ms" packet_loss 0.02 ]
        edge [ source 1 target 1 latency "10 ms" packet_loss 0.0 ] ]
experimental:
  scheduler_policy: tpu
ensemble: {replicas: 3, vary: {seed: [1, 5, 9]}}
hosts:
  server:
    network_node_id: 0
    processes: [{path: "model:tgen_server", start_time: 50ms}]
  client:
    quantity: 4
    network_node_id: 1
    processes:
    - path: model:tgen_client
      args: server=server size=60KiB count=2 pause=100ms retry=300ms
      start_time: 100ms
"""

BUSY = PHOLD.replace("packet_loss 0.1", "packet_loss 0.0").replace(
    "msgload=2", "msgload=4 selfloop=1").replace(
    "  judge_placement: flush", "  runahead: 50 ms\n  judge_placement: flush")
RUNS = {"phold": PHOLD, "tgen": TGEN, "tor": TOR}
# BUSY paused at PAUSE (windows clamped to STOP), run on to RESUME
PAUSE, RESUME, STOP = 300_000_000, 1_000_000_000, 2_000_000_000
CORRUPTIONS = ("counter", "heap_swap", "head", "clock", "lost_row")


def corrupt(name: str, arrays: dict) -> dict:
    """tests/test_torch_audit.py's corruptions of a paused state's numpy
    leaves: a negative counter; a host's first heap row swapped with its
    earliest row of a strictly later time; a head past E at the host
    with the most live rows; an aud_t above that host's next event; its
    last live row deleted."""
    a = {k: np.array(v, copy=True) for k, v in arrays.items()}
    ht = a["ht"]
    E = ht.shape[1]
    live = (ht < INF).sum(-1)
    busiest = int(np.argmax(live))
    if name == "counter":
        a["n_sent"][0] = -7
    elif name == "heap_swap":
        later = np.where((ht > ht[:, :1]) & (ht < INF), ht, INF)
        h, j = np.unravel_index(int(np.argmin(later)), ht.shape)
        for f in ("ht", "hk", "hm", "hv", "hw"):
            a[f][h, [0, j]] = a[f][h, [j, 0]]
    elif name == "head":
        a["head"][busiest] = E + 3
    elif name == "clock":
        a["aud_t"][busiest] = ht[busiest, 0] + 1
    elif name == "lost_row":
        j = int(live[busiest]) - 1
        a["ht"][busiest, j], a["hk"][busiest, j] = INF, IMAX
        for f in ("hm", "hv", "hw"):
            a[f][busiest, j] = 0
    return a


# ----------------------------------------------------------------------
# K5: csrc/route.cu in numpy
# ----------------------------------------------------------------------
def _dst_passes(nd: int) -> int:
    return (max(0, int(nd - 1).bit_length()) + 7) // 8


def _stable_pass(dg: np.ndarray, tile: int) -> np.ndarray:
    """One radix pass's target positions: the digit's bucket (an
    exclusive scan of the pass's histogram), plus the digit's count in
    the tiles before (the look-back), plus the row's rank among its
    tile's rows of that digit in list order (the rounds)."""
    L = dg.shape[0]
    hist = np.bincount(dg, minlength=BINS)
    gstart = np.cumsum(hist) - hist
    tl = np.arange(L) // tile
    cnt = np.zeros((int(tl[-1]) + 1, BINS), np.int64)
    np.add.at(cnt, (tl, dg), 1)
    before = np.cumsum(cnt, axis=0) - cnt
    group = tl * BINS + dg
    order = np.argsort(group, kind="stable")
    first = np.searchsorted(group[order], group[order])
    local = np.empty(L, np.int64)
    local[order] = np.arange(L) - first
    return gstart[dg] + before[tl, dg] + local


def route_mirror(t, m, lo: int, nd: int, key=None, tile: int = TILE):
    """(perm [L], starts [nd], counts [nd]) of the live rows (t <
    DROP_T, destination hi32(m) - lo in [0, nd)) as K5 computes them:
    listed in row order tile by tile, then the destination's passes
    (keyed: the key's 8 byte passes instead), each stable, a pass whose
    digit every row shares skipped; the bounds by binary search."""
    t, m = np.asarray(t), np.asarray(m)
    d = (m >> 32).astype(np.int32).astype(np.int64) - lo
    live = (t < DROP_T) & (d >= 0) & (d < nd)
    # the compaction: each tile's offset is its predecessors' live count
    F = t.shape[0]
    tl = np.arange(F) // tile
    per_tile = np.bincount(tl[live], minlength=(F + tile - 1) // tile)
    offset = np.cumsum(per_tile) - per_tile
    rank = np.cumsum(live) - 1 - np.concatenate([[0], np.cumsum(
        live)])[tl * tile]
    pos = offset[tl[live]] + rank[live]
    L = int(live.sum())
    assert np.array_equal(np.sort(pos), np.arange(L))
    dst = np.empty(L, np.int64)
    idx = np.empty(L, np.int64)
    dst[pos], idx[pos] = d[live], np.flatnonzero(live)
    keyed = key is not None
    kk = np.empty(L, np.uint64)
    if keyed:
        kk[pos] = np.asarray(key)[live].astype(np.uint64)
    # keyed: the key's 8 bytes alone (a key orders its row by
    # destination first)
    kpass = 8 if keyed else 0
    moved = 0
    for p in range(8 if keyed else _dst_passes(nd)):
        if L == 0:
            break
        if p < kpass:
            dg = ((kk >> np.uint64(8 * p)) & np.uint64(BINS - 1)).astype(
                np.int64)
        else:
            dg = (dst >> (8 * (p - kpass))) & (BINS - 1)
        if (np.bincount(dg, minlength=BINS) == L).any():
            continue            # the identity
        to = _stable_pass(dg, tile)
        assert np.array_equal(np.sort(to), np.arange(L))
        for a in (dst, idx, kk):
            a[to] = a.copy()
        moved += 1
    edges = np.searchsorted(dst, np.arange(nd + 1), side="left")
    return idx, edges[:-1], np.diff(edges), moved


# ----------------------------------------------------------------------
# K3: csrc/merge_heaps.cu in numpy
# ----------------------------------------------------------------------
def _less(a, b) -> bool:
    """(t, key, column) tuples, lexicographic."""
    return a < b


def _merge_host(heap, hd_raw, arr_a, arr_b, E, IN, two, verify):
    """One host as one warp of K3 treats it: heap = (t, k, m, v, w)
    int lists of its E slots, arr_a/arr_b its accepted arrivals'
    (t, k, m', v', w') in segment order. Returns (new heap or None where
    it is kept, rows below INF, branch, whether a row past INF
    stays)."""
    hd = min(max(hd_raw, 0), E)
    W = E + (2 if two else 1) * IN
    st = [heap[0][j] if j >= hd else INF for j in range(E)]
    sk = [heap[1][j] if j >= hd else IMAX for j in range(E)]
    n_lt = sum(x < INF for x in st)
    g = sum(x > INF for x in st)
    p = sum(st[j] < INF or (st[j] == INF and sk[j] < IMAX)
            for j in range(E))
    ok = all((st[j], sk[j]) <= (st[j + 1], sk[j + 1])
             for j in range(hd, E - 1))
    in_order = ok if verify else True
    n_a, n_b = len(arr_a), len(arr_b)
    n_r = n_a + n_b
    if hd_raw == 0 and n_r == 0 and in_order and g == 0:
        return None, n_lt, "kept", False
    cols = {j: (st[j], sk[j], heap[2][j], heap[3][j], heap[4][j])
            for j in range(E)}
    real = [E + a for a in range(n_a)] + [E + IN + a for a in range(n_b)]
    for c, row in zip(real, list(arr_a) + list(arr_b)):
        cols[c] = row
    # the arrivals' order among themselves, by counting
    ys = [None] * n_r
    for c in real:
        ys[sum(_less((cols[e][0], cols[e][1], e), (cols[c][0], cols[c][1],
                                                    c)) for e in real)] = c
    n_empty = W - E - n_r
    src = [None] * E

    def put(pos, c):
        if pos < E:
            assert src[pos] is None
            src[pos] = c

    for j in range(E):
        t, k = st[j], sk[j]
        if in_order:       # the tail's shift: seq_pos
            q = p + j if j < hd else ((j - hd) if j - hd < p else j)
        else:
            q = sum(_less((st[c], sk[c], c), (t, k, j)) for c in range(E))
        if t < INF or (t == INF and k < IMAX):
            # co-rank: the arrivals strictly below (t, key), a prefix of
            # the ranked arrivals (the kernel's binary search)
            below = [(cols[c][0], cols[c][1]) < (t, k) for c in ys]
            cross = sum(below)
            assert below == sorted(below, reverse=True)
        else:
            cross = n_r + (n_empty if t > INF else 0)
        put(q + cross, j)
    for a, c in enumerate(ys):
        t, k = cols[c][0], cols[c][1]
        if in_order:       # the tail's first p rows at or below it
            at_or_below = [(st[hd + i], sk[hd + i]) <= (t, k)
                           for i in range(p)]
            cross = sum(at_or_below)
            assert at_or_below == sorted(at_or_below, reverse=True)
        else:
            cross = sum((st[i], sk[i]) <= (t, k) for i in range(E))
        put(a + cross, c)
    for i in range(n_empty):
        na = IN - n_a
        c = E + n_a + i if i < na else E + IN + n_b + (i - na)
        put(n_r + i + E - g, c)
    assert None not in src
    out = [cols.get(c, (INF, IMAX, 0, 0, 0)) for c in src]
    new = tuple([row[f] for row in out] for f in range(5))
    branch = "merged" if in_order else "sorted"
    return new, n_lt + n_r, branch, new[0][E - 1] > INF


def _arrivals(rows, perm, s0, cnt, IN):
    """The accepted arrivals of a segment, packed as K3 stores them."""
    out = []
    for a in range(min(int(cnt), IN)):
        i = int(perm[s0 + a])
        fm, fs, fv = (int(rows[f][i]) for f in "msv")
        m = (((fm & 0xFF) << 32) | ((fs >> 32) & 0xFFFFFFFF))
        v = ((fs & 0xFFFFFFFF) << 32) | (fv & 0xFFFFFFFF)
        out.append((int(rows["t"][i]), int(rows["k"][i]),
                    np.int64(np.uint64(m)).item(),
                    np.int64(np.uint64(v)).item(), (fv >> 32) & 0xFFFFFFFF))
    return out


def merge_mirror(state: dict, rows: dict, perm, starts, counts, E: int,
                 IN: int, verify: bool, second=None, occ_sum=False):
    """K3 on numpy leaves (one replica): the hosts a warp walks (every
    host where `verify`, else those with head != 0 or arrivals), each as
    `_merge_host`; returns (new leaves, branch per host, whether the
    fresh word stays set)."""
    s = {k: np.array(v, copy=True) for k, v in state.items()}
    H = s["head"].shape[0]
    branch = np.array(["untouched"] * H, dtype=object)
    abnormal = False
    for h in range(H):
        ca = int(counts[h])
        cb = int(second[3][h]) if second is not None else 0
        hd = int(s["head"][h])
        if not (verify or hd != 0 or ca > 0 or cb > 0):
            continue
        arr_a = _arrivals(rows, perm, int(starts[h]), ca, IN)
        arr_b = [] if second is None else _arrivals(
            second[0], second[1], int(second[2][h]), cb, IN)
        heap = tuple(s[f][h].tolist() for f in ("ht", "hk", "hm", "hv",
                                                "hw"))
        new, n_all, branch[h], past = _merge_host(
            heap, hd, arr_a, arr_b, E, IN, second is not None, verify)
        abnormal |= verify and past
        if new is not None:
            for f, col in zip(("ht", "hk", "hm", "hv", "hw"), new):
                s[f][h] = col
        over_in = max(ca - IN, 0) + max(cb - IN, 0)
        s["overflow"][h] += over_in + max(n_all - E, 0)
        arrived = ca + cb if occ_sum else max(ca, cb)
        s["occ_in"][h] = max(int(s["occ_in"][h]), arrived)
        s["occ_heap"][h] = max(int(s["occ_heap"][h]), min(n_all, E))
        s["head"][h] = 0
    return s, branch, verify and abnormal


def tails_in_order(ht, hk, head) -> np.ndarray:
    """[H] bool: rows [head, E) in (t, key) order."""
    E = ht.shape[1]
    ok = (ht[:, :-1] < ht[:, 1:]) | ((ht[:, :-1] == ht[:, 1:])
                                     & (hk[:, :-1] <= hk[:, 1:]))
    return (ok | (np.arange(E - 1)[None, :] < head[:, None])).all(1)


# ----------------------------------------------------------------------
# the engine's merges, watched
# ----------------------------------------------------------------------
def _np(state: dict) -> dict:
    return {k: v.numpy().copy() for k, v in state.items()}


class Watch:
    """Kernels whose merge checks, before the plain merge runs: the
    tails' order, the route against `route_mirror`; after it, the
    unchanged hosts' leaves and `merge_mirror` (checking every heap at
    the first merge after `arm`, then as the fresh word says)."""

    def __init__(self):
        from shadow_tpu_torch.device.kernels import Kernels

        class Watched(Kernels):
            def merge_heaps(k, state, ob, perm, starts, counts, p,
                            ctl=None, second=None, occ_sum=False,
                            fresh=None):
                self.check(k, state, ob, perm, starts, counts, p, ctl,
                           second, occ_sum)

        self.kernels = Watched()
        self.fresh = True
        self.merges = 0
        self.rises = 0
        self.kept = 0
        self.branches = {}

    def arm(self):
        self.fresh = True

    def check(self, k, state, ob, perm, starts, counts, p, ctl, second,
              occ_sum):
        from shadow_tpu_torch.device.kernels import (
            CTL,
            Kernels,
            at_replica,
            n_replicas,
        )

        R = n_replicas(state)
        before = _np(state)
        Kernels.merge_heaps(k, state, ob, perm, starts, counts, p, ctl,
                            second, occ_sum)
        after = _np(state)
        fresh = False
        for r in range(R or 1):
            one = (lambda d: d) if R is None else (
                lambda d: {f: v[r] for f, v in d.items()})
            c = ctl if R is None or ctl is None else ctl[r]
            if c is not None and int(c[CTL["run"]]) == 0:
                continue
            b, a = one(before), one(after)
            o = ob if R is None else at_replica(ob, r)
            pr, sr, cr = ((perm, starts, counts) if R is None else
                          (perm[r], starts[r], counts[r]))
            fresh |= self._one(b, a, o, pr.numpy(), sr.numpy(),
                               cr.numpy(), p, second, occ_sum)
        self.fresh = fresh

    def _one(self, b, a, ob, perm, starts, counts, p, second, occ_sum):
        E, IN = p.E, p.IN
        # the invariant: at merge entry every tail is in order (a state
        # from outside excepted: the first merge after `arm` checks)
        in_order = tails_in_order(b["ht"], b["hk"], b["head"])
        if not self.fresh:
            assert in_order.all(), np.flatnonzero(~in_order)
        rows = {f: ob[f].reshape(-1).numpy() for f in "tkmsv"}
        H, OB = ob["t"].shape
        # K5's mirror against the route the engine took
        L = int(counts.sum())
        got = route_mirror(rows["t"], rows["m"], 0, H)
        np.testing.assert_array_equal(got[0], perm[:L])
        np.testing.assert_array_equal(got[1], starts)
        np.testing.assert_array_equal(got[2], counts)
        # a host left as it is: every leaf equal, occ_heap at its live
        # rows where it was below
        arrived = counts if second is None else counts + second[3].numpy()
        same = (b["head"] == 0) & (arrived == 0) & in_order
        live = (b["ht"] < INF).sum(1)
        for f, v in b.items():
            if f == "occ_heap" or v.ndim == 0 or v.shape[0] != H:
                continue
            np.testing.assert_array_equal(a[f][same], v[same], err_msg=f)
        np.testing.assert_array_equal(
            a["occ_heap"][same], np.maximum(b["occ_heap"], live)[same])
        self.rises += int((same & (b["occ_heap"] < live)).sum())
        self.kept += int(same.sum())
        # K3's mirror against the plain merge
        mine, branch, fresh = merge_mirror(b, rows, perm, starts, counts,
                                           E, IN, self.fresh, second,
                                           occ_sum)
        for f in ("ht", "hk", "hm", "hv", "hw", "head", "overflow",
                  "occ_in", "occ_heap"):
            np.testing.assert_array_equal(mine[f], a[f], err_msg=f)
        for x in branch:
            self.branches[x] = self.branches.get(x, 0) + 1
        self.merges += 1
        return fresh


def _run(name: str):
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner

    watch = Watch()
    if name == "campaign":
        from shadow_tpu_torch.ensemble.campaign import EnsembleRunner

        er = EnsembleRunner(load_config_str(CAMPAIGN), device="cpu",
                            kernels=watch.kernels)
        er.run()
        return watch
    stats = runner.run(load_config_str(RUNS[name]), device="cpu",
                       kernels=watch.kernels)
    assert stats.ok
    return watch


@pytest.mark.parametrize("name", ["phold", "tgen", "tor", "campaign"])
def test_every_merge_keeps_the_invariants_and_equals_both_mirrors(
        name, tmp_path, monkeypatch):
    """Every merge of a run: tails in order at entry, unchanged hosts
    bit-identical but occ_heap, K5's and K3's mirrors equal to the plain
    route and merge; after the first merge every host is trusted."""
    # the campaign's record goes to a temporary directory
    monkeypatch.setenv("SHADOW_TPU_OCC_DIR", str(tmp_path))
    watch = _run(name)
    assert watch.merges > 20
    assert watch.kept > 0 and watch.branches.get("merged", 0) > 0
    # the first merge after the run's entry checks every host
    assert watch.branches.get("kept", 0) > 0
    if name == "phold":
        # boot heaps of hosts that start later rise at the first merge
        assert watch.rises > 0
    assert watch.branches.get("sorted", 0) == 0


def _paused_busy():
    """BUSY paused at PAUSE by the port's plain path: (engine, numpy
    leaves)."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner

    engine, sim = runner.make_engine(load_config_str(
        BUSY, ["experimental.state_audit=true"]), device="cpu")
    state = engine.init_state(sim.start_times, sim.stop_times)
    state, _ = engine.run(state, PAUSE, STOP)
    return engine, _np(state)


def test_heap_swap_leaves_a_row_out_of_order_the_merge_resorts():
    """The swapped host's tail is out of order; a merge with no
    arrivals re-sorts it (the plain merge, and the mirror checking
    every heap, by the full sort), where trusting the order would have
    kept it."""
    from shadow_tpu_torch.device import kernels as K
    from shadow_tpu_torch.device.engine import state_from_numpy

    engine, leaves = _paused_busy()
    bad = corrupt("heap_swap", leaves)
    in_order = tails_in_order(bad["ht"], bad["hk"], bad["head"])
    assert in_order.sum() == len(in_order) - 1
    h = int(np.flatnonzero(~in_order)[0])
    p = engine.params
    H = bad["head"].shape[0]
    ob = {f: torch.full((H, p.OB), INF if f == "t" else 0,
                        dtype=torch.int64) for f in "tkmsv"}
    route = K.route_plain(ob)
    state = state_from_numpy(bad, "cpu")
    K.merge_heaps_plain(state, ob, *route, p)
    out = _np(state)
    assert tails_in_order(out["ht"], out["hk"], out["head"]).all()
    rows = {f: v.reshape(-1).numpy() for f, v in ob.items()}
    perm, starts, counts = (x.numpy() for x in route)
    checked, branch, _ = merge_mirror(bad, rows, perm, starts, counts,
                                      p.E, p.IN, True)
    assert branch[h] == "sorted"
    for f in ("ht", "hk", "hm", "hv", "hw", "occ_heap"):
        np.testing.assert_array_equal(checked[f], out[f], err_msg=f)
    trusting, _, _ = merge_mirror(bad, rows, perm, starts, counts, p.E,
                                  p.IN, False)
    assert not np.array_equal(trusting["ht"][h], out["ht"][h])


@pytest.mark.parametrize("corruption", CORRUPTIONS)
def test_mirrors_equal_the_plain_flush_on_a_corrupted_state(corruption):
    """Each corruption of the paused state run on to RESUME: every merge
    watched, the first checking every heap."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner
    from shadow_tpu_torch.device.engine import state_from_numpy

    _, leaves = _paused_busy()
    watch = Watch()
    engine, _ = runner.make_engine(load_config_str(
        BUSY, ["experimental.state_audit=true"]), device="cpu",
        kernels=watch.kernels)
    state = state_from_numpy(corrupt(corruption, leaves), "cpu")
    engine.run(state, RESUME, STOP)
    assert watch.merges > 5


def _outbox(rng, H, OB, hot_share=0.1, live_share=0.15):
    """A judged outbox as chip_smoke.py's `random_outbox` makes it."""
    shape = (H, OB)
    live = rng.random(shape) < live_share
    t = rng.integers(10**9, 3 * 10**9, shape)
    t = np.where(rng.random(shape) < 0.01, DROP_T, t)
    t = np.where(live, t, INF).astype(np.int64)
    dst = rng.integers(0, H, shape)
    dst = np.where(rng.random(shape) < hot_share,
                   rng.integers(0, min(16, H), shape), dst)
    k = ((np.arange(H * OB).reshape(shape) // OB) << 32) | \
        rng.integers(0, 2**32, shape)
    m = (dst.astype(np.int64) << 32) | (2 | (1 << 8))
    s = rng.integers(-2**63, 2**63 - 1, shape, dtype=np.int64)
    v = rng.integers(-2**63, 2**63 - 1, shape, dtype=np.int64)
    return {f: torch.from_numpy(np.ascontiguousarray(a))
            for f, a in zip("tkmsv", (t, k, m, s, v))}


def _keyed_runs(rng, S, H_pad, OB, cap):
    """S peer blocks [S, 6, cap], each a run of live rows in key order
    (chip_smoke.py's `keyed_runs`)."""
    wire = np.zeros((S, 6, cap), np.int64)
    per, span = H_pad // S, H_pad * OB
    for b in range(S):
        n = int(cap * 0.6)
        flat = rng.choice(per * OB, n, replace=False) + b * per * OB
        dst = np.where(rng.random(n) < 0.1, rng.integers(0, 16, n),
                       rng.integers(0, H_pad, n))
        key = np.sort(dst * span + flat)
        wire[b, 0] = INF
        wire[b, 0, :n] = rng.integers(10**9, 3 * 10**9, n)
        wire[b, 2, :n] = ((key // span) << 32) | 2
        wire[b, 5, :n] = key
    return torch.from_numpy(wire)


@pytest.mark.parametrize("case", ["one_destination", "empty", "2^20",
                                  "keyed_runs", "window"])
def test_route_mirror_on_adversarial_rows(case):
    from shadow_tpu_torch.device import kernels as K

    rng = np.random.default_rng(7)
    if case == "keyed_runs":
        rows = K.Rows(_keyed_runs(rng, 4, 2000, 30, 1500))
        f = rows.fields(("t", "m", "key"))
        want = K.route_rows_plain(rows, 0, 2000, True)
        got = route_mirror(f["t"].numpy(), f["m"].numpy(), 0, 2000,
                           f["key"].numpy())
        assert got[3] >= 3      # the key's varying bytes moved
    elif case == "window":
        rows = K.Rows(_keyed_runs(rng, 4, 2000, 30, 1500))
        f = rows.fields(("t", "m"))
        want = K.route_rows_plain(rows, 500, 500, False)
        got = route_mirror(f["t"].numpy(), f["m"].numpy(), 500, 500)
    else:
        H, OB = (1 << 20, 1) if case == "2^20" else (3000, 30)
        ob = _outbox(rng, H, OB, live_share=0.05 if H > 4000 else 0.15)
        if case == "one_destination":
            ob["m"] = (ob["m"] & 0xFFFFFFFF) | (7 << 32)
        elif case == "empty":
            ob["t"].fill_(INF)
        want = K.route_plain(ob)
        got = route_mirror(ob["t"].reshape(-1).numpy(),
                           ob["m"].reshape(-1).numpy(), 0, H,
                           tile=2048 if case == "2^20" else TILE)
        if case == "2^20":
            assert got[3] == 3      # three destination bytes
        if case == "one_destination":
            assert got[3] == 0      # every pass the identity
    L = int(want[2].sum())
    np.testing.assert_array_equal(got[0], want[0][:L].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    np.testing.assert_array_equal(got[2], want[2].numpy())


def _random_heaps(rng, H, E):
    """Heaps as the engine's merges leave them: in (t, key) order, heads
    inside their live rows, occ_heap at least the live rows; seeded
    counters."""
    n_live = rng.integers(0, E + 1, H)
    live = np.arange(E)[None, :] < n_live[:, None]
    ht = np.where(live, np.sort(rng.integers(0, 2 * 10**9, (H, E)), 1),
                  INF)
    hk = np.where(live, np.sort(rng.integers(0, 2**62, (H, E)), 1), IMAX)
    return {"ht": ht, "hk": hk,
            "hm": rng.integers(0, 2**40, (H, E)),
            "hv": rng.integers(-2**63, 2**63 - 1, (H, E), dtype=np.int64),
            "hw": rng.integers(0, 2**32, (H, E)),
            "head": np.minimum(rng.integers(0, 4, H) * (rng.random(H) < 0.5),
                               n_live).astype(np.int32),
            "overflow": rng.integers(0, 5, H).astype(np.int32),
            "occ_in": rng.integers(0, 8, H).astype(np.int32),
            "occ_heap": np.maximum(rng.integers(0, E, H),
                                   n_live).astype(np.int32)}


@pytest.mark.parametrize("case", ["one_destination", "empty",
                                  "two_blocks"])
def test_merge_mirror_on_adversarial_outboxes(case):
    """K3's mirror, checking every heap and trusting their order,
    against merge_heaps_plain: every live row to one host (arrivals past
    IN), no arrivals at all, and a mesh rank's two arrival blocks (the
    window merge and the global merge's occ_in)."""
    from shadow_tpu_torch.device import kernels as K

    rng = np.random.default_rng(11)
    H, OB, E, IN = 400, 12, 32, 16
    p = K.PhaseParams(E=E, K=1, T=0, P=1, B=12, IN=IN, C=1, boot_end=0,
                      seed=(0, 0), app=None)
    ob = _outbox(rng, H, OB)
    if case == "one_destination":
        ob["m"] = (ob["m"] & 0xFFFFFFFF) | (3 << 32)
    elif case == "empty":
        ob["t"].fill_(INF)
    route = K.route_plain(ob)
    heaps = _random_heaps(rng, H, E)
    rows = {f: v.reshape(-1).numpy() for f, v in ob.items()}
    perm, starts, counts = (x.numpy() for x in route)
    for occ_sum in ((False, True) if case == "two_blocks" else (False,)):
        second = None
        if case == "two_blocks":
            own = _outbox(rng, H, OB)
            sr = K.route_plain(own)
            second = (own, *sr)
        want = {k: torch.from_numpy(v.copy()) for k, v in heaps.items()}
        K.merge_heaps_plain(want, ob, *route, p, None, second, occ_sum)
        want = _np(want)
        for verify in (True, False):
            got, branch, _ = merge_mirror(
                heaps, rows, perm, starts, counts, E, IN, verify,
                None if second is None else (
                    {f: v.reshape(-1).numpy() for f, v in own.items()},
                    *(x.numpy() for x in sr)), occ_sum)
            for f in want:
                np.testing.assert_array_equal(got[f], want[f], err_msg=f)
            assert (branch == "kept").any() == verify
            assert (branch == "merged").any()
