#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (shadow_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase, as the check runs it
    python3 chip_smoke.py --phases build,kernels   # a short first call

Phases, in order; any failure exits non-zero before the last line:

1. build: print the card's name and power limit (nvidia-smi), the torch
   and CUDA versions and the CUDA toolkit's (`nvcc --version`), then
   build the CUDA kernels (fourteen; the pops and the judges each
   instantiated on dense and on factored tables, with one epoch and
   with a fault schedule's epoch axis, the pops also with and without
   the model NIC, and with and without the state audit's clock lane, in
   two sources) from
   shadow_tpu_torch/csrc/ into shadow_tpu_torch/_build/ (one nvcc per
   source, all started together; timed as set-up; ptxas register and
   shared-memory use is printed).
2. kernels: each kernel against its plain PyTorch version on seeded
   inputs, exact equality on every output, times by CUDA events
   (median of several runs):
   - K1 pop_phase, K2 judge_outbox, K3 merge_heaps at the PHOLD
     full-width shapes (100,000 hosts, E=64, OB=30, V=2), ids and seqs
     at 0 and 0xFFFFFFFF, overflowing rows, times past the merge's T_CAP;
   - K4 pop_tgen at 100,000 hosts and tgen_10000's layout (E=48, P=8,
     T=1, B=4, OB=36, C=32, V=6): burst runs cut by a non-packet slot,
     by win_end and by slot E, client DATA trains with random d2 and
     shifts past +-32, pause and retry timers (some in-window, setting
     dirty, some stale); K2 on its outbox (trains of up to 32 packets,
     lossy paths) and K3 at E=IN=48;
   - K6 pop_tor at examples/tor_large.yaml's layout and full width
     (56,000 hosts, 5,600 relays, E=96, P=8, T=1, B=4, OB=36, C=16,
     V=6), on heaps built from the port's own routes so that every
     relay branch fires (REQ forwarded by guard and middle, served by
     the exit, DATA trains forwarded by middle and guard): burst runs
     cut by a non-packet slot, by win_end and by slot E, tail chunks
     (cells - start < 16), trains with holed masks, with d2 == 0 and
     shifted past +-32 at clients, pause and current and stale retry
     timers (some in-window, setting dirty); K2 on its outbox (C=16,
     holed masks) and K3 at E=96, IN=64;
   - K5 route at the PHOLD shape (3,000,000 rows), tgen_10000's
     (360,000 rows) and tor_large's (2,016,000 rows), each with
     destinations past IN, beside torch.sort + searchsorted on the
     same input;
   - K3 (every row above and below) twice: checking every heap's
     order (a state from outside the engine) and trusting it (the main
     path after a run's first merge, on the same heaps in (t, key)
     order), beside the library's merge (a stable sort by key, then by
     time, over [H, E+IN], the five fields taken along it, cut to E),
     with the shares of hosts left as they are, merged and sorted in
     full;
   - K5 and K3 where the data is hardest (`flush_adversarial`): every
     live row of a 3,000,000-row outbox to one destination, an empty
     outbox, 1,000,000 destinations, keyed rows in S = 4 peer runs
     (K5's keyed mode), every output bit for bit;
   - the pop and K2, then K5 and K3, on one real phase's inputs
     (`real_phase_rows`): phold (100,000 hosts), tgen_10000, tor_large
     and phold_1m_hier paused half way by the graph loop; the pop and K2
     on the engine's own buffers as its last phase left them (outbox,
     pop counts, outbox word), with the shares of hosts that pop, rows
     cleared and rows left, the pop clearing every row and K2 judging
     every host beside them, K2 as a warp a host; K9 on the paused
     state, beside its design before; then that phase popped and judged
     (the skip rule checked: no host that popped nothing holds an
     exchangeable row), phase_tally on it with the word as the pop left
     it and set, and K9 with the tally folded in, each beside its design
     before, then routed and merged;
   - the pop and K2 where the outbox is hardest (`outbox_adversarial`,
     on phold's paused state): every cell and pop count random under a
     set outbox word; every host popped last phase and none now; K2 on
     rows copied in from outside with pop counts 0 (a mesh rank's
     `flush_phases`), which must judge every host;
   - the `_hier` instantiations, which look the path tables up in two
     levels (the reference's `gather_parts`): K1 and K2 on the factored
     tables of examples/tgen_1000000.yaml (V=1,000,200, C=200) at its
     1,000,000 hosts, tiled as that file tiles them, with its hubs made
     lossy (PHOLD_1M_HUB_LOSS) so that drops roll, K2's send rows
     retargeted to every kind of pair (same vertex, the sender itself,
     same cluster, another cluster), and K2 again on the tables as
     shipped; K4 and K6 at their shapes on a factored 6-vertex star;
   - the model NIC (`_nic`): K1 at the PHOLD shapes with self-sends and
     the path counters' DROP_T rows, K4 at tgen_10000's layout and K6 at
     tor_large's (P = 1, the READY column), on random NIC leaves (idle
     and standing queues, CoDel on both sides of its target, in and out
     of its dropping state, its count past the law table) and heaps
     whose packet rows are half RX stage, half READY;
   - the epoch axis (`_ep`, six epochs, EPOCH_TIMES): K4 and K2 at
     tgen_10000's layout on its dense tables stacked over the epochs,
     K4 on a factored star stacked the same way, and K1 and K2 on
     phold_1m_hier_faults' own six factored epochs at 1,000,000 hosts;
   - K7 count_paths on 3,900,000 outbox rows over 256 vertices (V*V =
     65,536) and over 6 (tgen_10000's: few pairs, on which the design
     before's atomics queue), every row read, given pop counts with the
     word clear on an outbox as the rule leaves it (30% and 0.6% of the
     hosts popped), and with the word set, each beside its design before
     (`Kernels.designs_before`: an atomic a packet row, every row) and
     torch.bincount on the same pairs and weights; then
     (`paths_real_rows`) on one real phase of tgen_10000_nic, the NIC
     PHOLD and the link-fault tgen paused half way, the engine's own
     buffers, pop counts and word (the rule checked: no host that popped
     nothing holds a row below INF), the word clear and set;
   - the audited pops (`_aud`, the state audit's clock lane) on the
     same phases' inputs with random audit leaves (aud_t above a tenth
     of the hosts' next events): K1, K4 and K6 at their shapes, K1_hier
     at 1,000,000 hosts and K4_nic;
   - K8 audit_round at 100,000 and 1,000,000 hosts, E=64 (heaps with
     swapped rows, tied times, heads past E and below 0, negative
     counters; the row ledger balanced and off by one); K9 loop_control
     at 1,000,000 hosts in each of its branches, beside torch.gather +
     amin and its design before (two launches, `Kernels.designs_before`);
     phase_tally at the PHOLD shapes, with and without the audit's
     ledger, given no outbox word, the word set (every row read) and the
     word clear on an outbox as the skip rule leaves it (the rows of hosts
     with pop count 0 clear), beside its design before (every row read,
     `Kernels.designs_before`); K9 with the tally folded in
     (`loop_control_tally`) at the PHOLD shapes in K9's branches, the
     word clear and set, with and without the audit, beside the two
     launched apart and the designs before;
   - the replica axis of an ensemble campaign (`replica_kernels`): K1
     (dense and `_nic`) at the PHOLD shapes, K4 (dense, `_hier`, `_ep`,
     `_aud`) and K2 (dense, `_hier`, `_ep`) at tgen_10000's layout at
     100,000 hosts, K7 on K2's outbox (also with pop counts and outbox
     words, as phase_tally), K6 at tor_large's, K5, K3 and
     phase_tally at the PHOLD shapes (also with outbox words, two
     replicas' clear on outboxes as the rule leaves them), K8, K9 and
     K9 with the tally folded in at 100,000 hosts, each
     at R = REPLICAS (4) on four replicas' seeded states, tables, seed
     keys and window ends, equal to four R = 1 launches and to its
     plain version, and again with one replica's control block stopping
     it, which must keep every byte; R = 1 and R = 4 times;
   - K10 judge_batch (the hybrid policy's batched judge) at JUDGE_N =
     1,048,576 packets on each of its four views: phold.yaml's dense
     tables (2% loss) at 100,000 hosts, examples/tgen_1000000.yaml's
     factored tables (hubs lossy as PHOLD_1M_HUB_LOSS) at its 1,000,000
     hosts, phold_1m_hier_faults' six factored epochs and the dense
     tables stacked over EPOCH_TIMES; send times 1 ns either side of
     every epoch start and of the bootstrap end, packet seqs at 0 and
     2^31-1, every kind of pair; beside the design before
     (`Kernels.designs_before`) on the same inputs; both designs also
     on JUDGE_OUTSIDE_N packets a quarter of whose senders and
     destinations lie outside [0, H);
   - K11 compact_outbox at the PHOLD shapes (100,000 hosts, OB = 30)
     with CX 4 and 16, by the window rule and the global rule, and each
     rule at R = 4 against four R = 1 launches, a stopped replica
     keeping every byte;
   - the host mesh's kernels (`mesh_kernels`) on one rank's judged
     outbox at the PHOLD shapes (H_loc = 50,000 at S = 2, 25,000 at
     S = 4, OB = 30, a tenth of the rows at 16 hot hosts of another
     shard), routed over the H_pad destinations: K12 pack_remote at S =
     2 and 4 at dense_auto_cap and at CAP/64 (rows lost), beside
     index_select of the same rows into [5, S*CAP]; K13 pack_two_phase
     (phase 1) at S = 4 at its auto CAP and at CAP/64; K5's keyed route
     of the phase-1 arrivals over H_pad and K13's phase 2 at its auto
     CAP2 and at CAP2/64 (rows lost at the intermediate); K13 on send
     buffers kept from pack to pack (`two_phase_real_rows`: rank 0's
     rows of TP_PHASES successive phases of phold.yaml at S = 4, at the
     auto capacities from half way, timed beside the design before, and
     at TP_SMALL_CAPS from boot, rows overflowing both halves, an empty
     outbox at step TP_EMPTY_AT of each; `two_phase_adversarial`: fills
     of CAP, 0, CAP and a tenth), every buffer after every pack equal to
     the plain version's fresh one; K5's window
     over a rank's received [S, 6, CAP] rows and K3 merging them with
     the rank's self-shard rows (two arrival blocks, the window and
     the global merge's occ_in), every output bit for bit;
   - the exchange's kernels with a campaign's replica axis
     (`mesh_replica_kernels`, R = 4, each replica its own outbox): K12,
     K5's window and K3's second block at S = 2 (H_loc 50,000, the auto
     CAP), both K13 halves and K5's keyed mode over two_phase's two
     received regions at S = 4, each against four R = 1 launches and its
     batched plain version, a stopped replica keeping every byte, timed
     at R = 1 and R = 4 beside the library call on the four replicas at
     once; and a rank's K1, K2, K7 and K8's rank mode at R = 4 with g0 >
     0 (`rank_replica_kernels`);
   - the audit, the model NIC and the path counters as a mesh rank runs
     them (`mesh_state_kernels`, rank 1 of 2 at H_loc 50,000): K8's
     rank mode (`audit_round_rank`: the rank's balance written, nothing
     decided) on two ranks' seeded states and the conserve pass
     (`audit_conserve`) on their summed word, with the ledgers balanced,
     moved between the ranks (balances non-zero, summing to 0: no
     AUD_CONSERVE, where the one-launch K8 on one rank would set it) and
     broken (AUD_CONSERVE on every host of both ranks); K1_nic on the
     rank's hosts at their global ids, reading its slice of the [H_pad]
     bandwidth columns; K7 on the rank's outbox (global sources, the
     destinations over H_pad and a few outside) into its row; each
     bit-equal to its plain version.
3. parity: the window loop captured into a CUDA graph on the card (the
   main path, K9 with the phase's tallies folded in), the Python loop
   on the card (the standalone tally) and the CPU plain path must
   give identical totals, rounds, per-host events_executed /
   trace_checksum (and downloads) and every state leaf, and the
   audited graph run the same with a zero health word: the PHOLD test
   shape at 2 x 1,000 hosts, loss 0.01, 1 s;
   the tgen test config (tests/test_tgen_device.py) at loss 0.25,
   retry=120ms with TGEN_PARITY_CLIENTS clients; examples/tor_small.yaml
   with its stop_time cut to TOR_PARITY_STOP (past its 5 s bootstrap,
   so drops roll); and STAR_PARITY_YAML (a star_clusters tgen run cut
   from examples/tgen_1000000.yaml's shape) four ways: card and CPU,
   hierarchical and dense tables; then the model NIC (PHOLD with the
   path counters, tgen, Tor, each on constrained links), tests/
   test_faults.py's link-fault config with the path counters, and
   examples/tgen_faults_hier.yaml's link faults (card hierarchical ==
   card dense == CPU), the path counters compared too; then the
   state audit: five seeded corruptions (BUSY_YAML paused at 300 ms:
   a negative counter, two heap rows swapped, a head past E, aud_t
   above a host's next event, a live row deleted) run on to 1 s on the
   card and on the CPU plain path, every leaf and the words equal and
   each word tripping its invariant, and a run paused at 300 ms and
   resumed equal to an unpaused one; then ensemble campaigns
   (`campaign_parity`): examples/ensemble_seed_sweep.yaml as shipped
   and STAR_PARITY_YAML with link faults over latency_scale [1.0, 2.0]
   and fault_schedule [base, none], each through the graph loop and the
   Python loop on the card and the CPU plain path, replica by replica,
   each replica equal to its standalone graph run, and the sweep with
   replica_batch 2 equal to the whole campaign; then the hybrid policy
   (`hybrid_parity`, HYBRID_PARITY: tests/test_hybrid.py's lossy PHOLD
   and its selfloop case, examples/tgen_faults.yaml and
   tgen_faults_hier.yaml under tpu, the latter also with its host
   faults alone, and again with mesh_shards 2, whose fall-back logs the
   reference's warning and equals the run without the mesh, a PHOLD +
   tgen mix, a cut tor_small with a relay crash), each on the card with
   K10 on every flush (under
   torch.profiler, K10's device ms a flush printed), on the CPU plain
   path and on the port's serial policy: traces, per-host leaves,
   totals and path counters equal; then the outbox compaction
   (`compact_parity`): the PHOLD above and examples/tgen_10000.yaml cut
   to COMPACT_STOP, at the uncompacted run's largest occ_ob (equal to
   the uncompacted run) and at half of it (by each rule for the
   PHOLD, by the global rule for tgen_10000), three ways; then the
   capacity planner and the segmented advance (`plan_parity`,
   `campaign_plan_parity`): tests/test_capacity.py's PHOLD planned from
   a 600 ms warm-up (no re-plan, its knobs unlike the static ones)
   against the static card run and the CPU's planned run, a forced
   overflow (a 50 ms warm-up: re-plans and replays, the static trace,
   clean final marks) and the planned run's OCC record replayed through
   `capacity_plan: <path>`; tests/test_device_heartbeats.py's config
   with heartbeats every 500 ms, its 24 `[shadow-heartbeat] [node]` rows
   equal to the CPU's, its trace and rounds the run's without
   heartbeats; examples/ensemble_seed_sweep.yaml planned with heartbeats
   every second, each replica equal to its standalone graph run, one
   `[ensemble-heartbeat]` line per replica per boundary.
4. full: through the port's CLI entry function on the card (the
   captured window loop, K9 with the tally folded in; under
   outbox_compact K9 and the tally apart), each run with the kernel
   launch counts set to
   0 just before and read just after; fails on any overflow or on a
   kernel of the path that never launched; its wall, rounds, phases and
   host syncs printed; then the same graph run under torch.profiler for
   its kernels' device time, the same config in timing mode (the Python
   loop, a CUDA event pair around each launch) for that loop's per-kernel
   breakdown, and, for phold, tgen_10000, tgen_10000_nic and tor_small,
   the Python loop untimed, for walls of both loops in one call (counts
   equal): examples/phold.yaml at 2 x 50,000 hosts;
   examples/tgen_10000.yaml as shipped (10,000 hosts, 30 s); and the
   same file with every group's quantity x10 (tgen_100000.yaml's host
   set, 100,000 hosts, without its multi-chip runner keys);
   examples/tor_small.yaml as shipped (250 hosts, 60 s) and
   examples/tor_large.yaml as shipped (56,000 hosts, 60 s); and
   PHOLD_1M_YAML (phold_1m_hier: PHOLD on 1,000,000 hosts on
   examples/tgen_1000000.yaml's factored topology, 1 s);
   examples/tgen_10000.yaml under the model NIC and the path counters
   (tgen_10000_nic); PHOLD_1M_YAML with PHOLD_1M_FAULTS
   (phold_1m_hier_faults, six factored epochs); phold_1m_hier again
   with `state_audit` (the audit's share of its wall, and K8's device
   time from its profiled graph run); then the campaigns
   (`campaign_full`, CAMPAIGN_RUNS): examples/tgen_10000.yaml as shipped
   with 8 replicas over seeds 1-8 (80,000 hosts in one loop) and
   examples/tor_small.yaml with 8 replicas over latency scales and loss
   deltas, each through the CLI's entry function (the graph loop),
   profiled, in timing mode, and each replica against its standalone
   graph run, whose walls are summed beside the campaign's; then
   (`hybrid_full`) examples/tgen_faults.yaml and tgen_faults_hier.yaml
   as shipped under tpu (the hybrid policy) and again with K10 on every
   flush, and a hybrid PHOLD at 2 x HYB_FULL_HOSTS hosts with host and
   link faults (HYB_FULL_OVERRIDES) against the port's serial run of
   it, each under torch.profiler, with its wall, events/s, flushes on
   the card against the CPU, the flushes' share of the wall and, a
   device flush, packets, K10's device ms (the profiler's), the kernel
   and copy ms of the judge's event pairs and the judge's host wall;
   the real flushes of tgen_faults_hier.yaml with K10 on every flush and
   of the hybrid PHOLD recorded (`recorded_flushes`) and replayed
   (`judge_real_rows`): both designs equal to the plain version on each,
   K10 alone a flush by CUDA events, the judge's host wall a flush in
   turns and its K10 device ms by the profiler, both designs; and
   (`compact_full`) PHOLD at 100,000 hosts and
   examples/tgen_10000.yaml as shipped under outbox_compact at the
   uncompacted run's largest occ_ob, beside the uncompacted wall; then
   (`plan_full`) examples/tgen_100000.yaml as shipped (100,000 hosts to
   30 s, planned from a 3 s warm-up, 2.5 s segments) with heartbeats
   every 5 s (its 500,000 node rows counted, not printed), and again
   without them, each against its static unsegmented graph run: the
   build and warm-up walls, both plans, segments, host syncs and graph
   captures (none per segment), the walls and events/s, the peak
   against the estimate; and tgen_10000.yaml in 2.5 s segments against
   its unsegmented graph run, in turns: the price of a boundary. Every
   device run must be admitted and its measured peak device memory lie within
   capacity.FOOTPRINT_TOLERANCE of its admission estimate.
5. supervise (device/checkpoint.py, device/supervise.py,
   device/chaos.py): examples/tgen_100000.yaml as shipped (planned, 2.5 s
   segments) with rotating checkpoints every 10 s, keep 2, through the
   CLI's entry function: two `.t` entries, equal to its uninterrupted
   planned run, the graph captures, a save's wall and bytes, the rotated
   wall beside the unrotated; the same config through
   `python -m shadow_tpu_torch.cli` in a child process on the card,
   SIGTERM once its first entry exists: exit 75, the signal-to-exit
   wall, the resume from the base path (a load's wall and bytes) equal
   to the uninterrupted run, the child's rounds and the resume's summing
   to its; `checkpoint_save_time` half way on phold.yaml (2 x 50,000
   hosts) and on tor_small cut to TOR_PARITY_STOP, resumed equal to the
   card's uninterrupted run and (tor_small) the CPU plain path's;
   tgen_10000 x 8 in replica batches of 4 with rotation, drained in its
   second batch and resumed from the batch's entry, its replicas equal
   to the uninterrupted campaign's; tgen_10000 in 2.5 s segments with a
   chaos `dispatch_error` at segment 3 (one retry from the validated
   copy, equal, the copy's and the replayed segment's walls) and its
   third rotation entry truncated by `checkpoint_corrupt` (the base path
   resolves to the second, resumed equal); the parity PHOLD under
   `failover: hybrid` with one error and no retry (the hybrid rerun
   equal to the device run, the failover checkpoint resumed on the card
   equal).
6. mesh: the host mesh, S ranks spawned on device 0 over gloo (the
   check's machine shows one card; `torch.cuda.device_count()` is
   printed): `runner.flush_phases` (`mesh_flush`: rows of a one-card
   pop copied into each rank's outbox, pop counts 0) on 2 card ranks
   against 2 CPU ranks, every leaf; parity (`mesh_parity`): PHOLD 2 x 1,000 lossy, the tgen
   config at loss 0.25, tor_small cut to TOR_PARITY_STOP and the star
   with link faults, each under all_to_all, two_phase and all_gather,
   window and global merges, at S = 4 (at S = 2 three of them), and the
   NIC PHOLD with the path counters and BUSY_YAML's PHOLD audited under
   all_to_all and two_phase at S = 4 and all_to_all at S = 2 (their NIC
   and audit leaves too, path_cnt's rows summed, health words zero), held
   against the one-device card run (traces, totals, every per-host
   leaf but occ_in, the phases), the kernels each rank launched
   checked; a2a/window at S = 2 and two_phase/global at S = 4 also
   against the same ranks on the CPU plain path (a CPU oracle, below;
   every leaf); one undersized capacity per schedule that has one
   (the PHOLD at S = 4: the direct pack, two_phase's phase 1, its
   phase 2), card against CPU, x_overflow equal per sender, the run not
   ok; in the same spawns the tgen config planned (MESH_PLAN: a 3 s
   warm-up in 1 s segments, `exchange: auto`) at S = 2 and 4, equal to
   the one-device run, its chosen schedule and estimates printed.
   Ensemble campaigns (`mesh_campaign_parity`, MESH_CAMPAIGNS, in the
   same spawns): examples/ensemble_seed_sweep.yaml at S = 2 and 4 under
   every schedule and merge, the star campaign of the parity phase at
   S = 2 and a PHOLD latency sweep with an undersized capacity, every
   replica held against the one-device campaign on the card (every
   per-host leaf but occ_in, the record, the totals; not where rows are
   lost) and every run against the same ranks on the CPU (a CPU oracle,
   every leaf; the lossy sweep's x_overflow per replica and sender); the
   exchange's collectives a flush equal to a standalone run's; the sweep
   saved half way at S = 2 and resumed, its checkpoint refused on a pool
   of one rank.
   Full (`mesh_full`, MESH_FULL): phold.yaml at 2 x 50,000 hosts cut to
   MESH_PHOLD_STOP at S = 2 and 4 and tgen_10000.yaml cut to 5 s at S = 2,
   exchange_capacity set by
   hand, untimed for the wall beside the one-device graph wall of this
   call, then in timing mode for each rank's split of the flush (the
   pops and K2, K5, the pack, the staging copies, the collective, the
   second route, the merge) and the bytes it sent; counts equal to one
   device's, x_overflow 0, every rank's peak within
   FOOTPRINT_TOLERANCE of its admission estimate. Then
   (`mesh_state_full`, MESH_STATE_FULL) phold.yaml at 2 x 50,000 hosts
   audited at S = 2 (health word zero, every per-host leaf equal to its
   one-device graph run, the balance's all_sum a round, the audit's
   cost a rank: the all_sum's seconds and K8's device ms over the mesh
   wall)
   and tgen_10000.yaml under the model NIC and the path counters cut to
   3 s at S = 2 (the summed path_cnt equal), each beside its one-device
   graph run, peaks within FOOTPRINT_TOLERANCE of the estimates; the
   campaign at full width (`mesh_campaign_full`, MESH_CAMPAIGN_FULL):
   tgen_10000.yaml x 8 seeds cut to 5 s at S = 2, every replica equal
   to the one-device campaign of this call, the exchange's collectives
   a flush equal to tgen_10000_s2's, each rank's peak, estimate, bytes
   a flush and collective and staging seconds. Then
   (`mesh_supervise`) phold.yaml at S = 2 saved half way and resumed at
   S = 2, equal to one device, and its checkpoint refused on a pool of
   one rank with the reference's message. Then the mesh shrink
   (`mesh_shrink`, `shrink_jobs`, `failover: shrink`): tests/
   test_chaos.py's SHRINK (6 PHOLD hosts, 800 ms, a device loss of shard
   1 at dispatch 2) under two_phase, 4 ranks -> 3, equal to the
   uninterrupted run on 3 of the 4 card ranks (every per-host leaf) and
   to the same shrink on 4 CPU ranks (a CPU oracle, every leaf), its
   rotation entries stamping 3 shards, the one at 600 ms resumed without
   mesh_shards (adopted on 3 ranks) equal; the 2-seed campaign's shrink
   equal replica by replica to the one-device card campaign; phold.yaml
   at S = 4 cut to MESH_PHOLD_STOP, planned, a device loss at its second
   1 s segment, equal host for host to its one-device card run; each
   run's wall, reshards, exchange and the shrink's walls (probe, gather,
   group, rebuild) printed. Every card run of the phase but
   the flush's goes in one spawn at S = 2 and one at S = 4
   (`mesh_card_runs`): a spawn's ranks take about 20 s to reach the
   card; the flush's check runs beside the first spawn.
7. boot: examples/tgen_1000000.yaml as shipped built (timed), admitted
   and booted (engine and init_state) on the card; not run.
8. the `kernels` JSON line, then the card line, then the result line.

The CPU oracles (the CPU plain path's runs of the parity phase, the
hybrid runs' CPU and serial twins, the full hybrid PHOLD's serial run,
the mesh's CPU ranks) start before the build, in worker processes and
threads at a lower priority (`start_oracles`), and run beside the
build, the kernels phase and the parity phase; the phases read their
results, and the full phase starts once every one has ended, so that
none runs beside the timed phases. The end of the output has a line an
oracle: when it ran and how long its reader waited.

`--phases build,plan` makes the planner's and the segmented advance's
checks alone (the mesh's planned runs in spawns of their own);
`--phases build,supervise` the supervise phase alone (it runs the
uninterrupted runs it compares with itself where the parity and full
phases did not).

It imports nothing of jax or of the shadow_tpu package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import logging
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PHASES = ("build", "kernels", "parity", "full", "supervise", "mesh",
          "boot")
# H100 SXM (NVIDIA data sheet): HBM rate, and the integer ALU rate:
# 64 INT32 lanes per SM x 132 SMs x 1.98 GHz boost. (The 67 TFLOP/s
# float32 peak is 128 lanes with an FMA counted as two operations.)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# integer operations per threefry-2x32 block (csrc/threefry.cuh): one
# three-input xor for the third key word, two key adds, then five
# blocks of four rounds of add, rotate (one funnel shift on sm_90) and
# xor, each block ending in two key injections (the second an add of
# three terms): 1 + 2 + 5 * (4 * 3 + 2)
THREEFRY_OPS = 73
FULL_HOSTS_PER_GROUP = 50_000
FULL_STOP = "10s"           # examples/phold.yaml's own stop_time

PARITY_YAML = """
general: {stop_time: 1s, seed: 5}
network:
  graph:
    type: gml
    inline: |
      graph [ directed 0
        node [ id 0 bandwidth_down "100 Mbit" bandwidth_up "100 Mbit" ]
        node [ id 1 bandwidth_down "100 Mbit" bandwidth_up "100 Mbit" ]
        edge [ source 0 target 0 latency "30 ms" packet_loss 0.01 ]
        edge [ source 0 target 1 latency "10 ms" packet_loss 0.01 ]
        edge [ source 1 target 1 latency "30 ms" packet_loss 0.01 ] ]
experimental: {scheduler_policy: tpu, event_capacity: 64,
               outbox_capacity: 16}
hosts:
  left:
    quantity: 1000
    network_node_id: 0
    processes: [{path: model:phold, args: msgload=2, start_time: 100ms}]
  right:
    quantity: 1000
    network_node_id: 1
    processes: [{path: model:phold, args: msgload=2, start_time: 150ms}]
"""

# tests/test_tgen_device.py's TGEN_YAML at loss 0.25 and retry=120ms,
# with more clients, and the server heap and arrival window widened so
# that every client's request fits one flush
TGEN_PARITY_CLIENTS = 200
TGEN_PARITY_YAML = f"""
general: {{stop_time: 6s, seed: 1}}
network:
  graph:
    type: gml
    inline: |
      graph [ directed 0
        node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        node [ id 1 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        edge [ source 0 target 0 latency "10 ms" packet_loss 0.25 ]
        edge [ source 0 target 1 latency "20 ms" packet_loss 0.25 ]
        edge [ source 1 target 1 latency "10 ms" packet_loss 0.25 ] ]
experimental: {{scheduler_policy: tpu, event_capacity: 256,
               outbox_capacity: 256}}
hosts:
  server:
    network_node_id: 0
    processes: [{{path: model:tgen_server, start_time: 10ms}}]
  client:
    quantity: {TGEN_PARITY_CLIENTS}
    network_node_id: 1
    processes:
    - {{path: model:tgen_client, start_time: 100ms,
       args: server=server size=200KiB count=2 pause=200ms retry=120ms}}
"""
# examples/tor_small.yaml's stop_time cut for the card == CPU parity
# run (the plain path on the CPU takes about a minute there at 60 s)
TOR_PARITY_STOP = "15s"
# examples/tgen_10000.yaml's groups and quantities
TGEN_QUANTITY = {"server_nyc": 100, "server_lon": 100, "server_sin": 100,
                 "client_nyc": 1600, "client_lon": 1600,
                 "client_fra": 1600, "client_sfo": 1600,
                 "client_sin": 1600, "client_syd": 1700}

# examples/tgen_1000000.yaml's network block cut to 8 clusters of 120
# spokes (V=968 <= 2048: the build verifies the factored tables against
# dense), with lossy hubs; one server per cluster on its first spoke and
# a client on every spoke from vertex 9, tiled as that file tiles them
# (`server=server` cycling over the 8 servers); its client args; the
# capacities raised until nothing overflows (IN 64 overflows)
STAR_PARITY_YAML = """
general: {stop_time: 2s, seed: 1}
network:
  topology:
    representation: hierarchical
  graph:
    type: star_clusters
    clusters: 8
    spokes_per_cluster: 120
    hub_latency: 10 ms
    access_latency: 1 ms
    hub_packet_loss: 0.02
experimental:
  scheduler_policy: tpu
  event_capacity: 128
  exchange_in_capacity: 128
hosts:
  server:
    quantity: 8
    network_node_id: 8
    network_node_stride: 120
    processes:
    - path: model:tgen_server
      start_time: 10ms
  client:
    quantity: 952
    network_node_id: 9
    network_node_stride: 1
    processes:
    - path: model:tgen_client
      args: server=server size=50KiB count=2 pause=200ms retry=500ms
      start_time: 100ms
"""
# the full run at a million hosts: examples/tgen_1000000.yaml's network
# and experimental blocks verbatim, plus hub_packet_loss so that drops
# roll (access stays lossless: the factored form's reliability-exactness
# condition), and examples/phold.yaml's PHOLD (msgload=3 size=512, seed
# 7, start 10 ms) on one host per spoke, for tgen_1000000.yaml's 1 s
PHOLD_1M_HUB_LOSS = 0.02
# its windows (the rounds every run of it has counted)
PHOLD_1M_ROUNDS = 449
PHOLD_1M_YAML = f"""
general: {{stop_time: 1s, seed: 7}}
network:
  topology:
    representation: hierarchical
  graph:
    type: star_clusters
    clusters: 200
    spokes_per_cluster: 5000
    hub_latency: 10 ms
    access_latency: 1 ms
    hub_packet_loss: {PHOLD_1M_HUB_LOSS}
experimental:
  scheduler_policy: tpu
  admission: auto
  device_memory_budget: 8 GiB
hosts:
  peer:
    quantity: 1000000
    network_node_id: 200
    network_node_stride: 1
    processes:
    - path: model:phold
      args: msgload=3 size=512
      start_time: 10ms
"""

# phold_1m_hier's link-fault schedule (phold_1m_hier_faults): hubs 0-1
# degrade x3 latency and +5% loss over 200-500 ms, the access link of
# spoke 200 (hub 0's first) x2 latency over 300-500 ms, hubs 2-3 down
# from 400 ms to 600 ms (rerouted through another hub): six epochs
# starting at 0, 200, 300, 400, 500 and 600 ms; the lookahead stays the
# 1 ms access latency
PHOLD_1M_FAULTS = (
    "network.faults=["
    "{kind: degrade, time: 200ms, duration: 300ms, source: 0, target: 1,"
    " latency_multiplier: 3, extra_packet_loss: 0.05},"
    "{kind: degrade, time: 300ms, duration: 200ms, source: 0,"
    " target: 200, latency_multiplier: 2},"
    "{kind: link_down, time: 400ms, source: 2, target: 3},"
    "{kind: link_up, time: 600ms, source: 2, target: 3}]")
# examples/tgen_10000.yaml under the model NIC and the path counters
# (tgen_10000_nic); bursts are off there (P = 1), and the shipped
# capacities hold
TGEN_NIC = ("experimental.model_bandwidth=true",
            "experimental.count_paths=true")

# tests/test_model_nic.py's config at 2 Mbit and loss 0.05 (CoDel drops
# and drop rolls both), with the path counters
NIC_PHOLD_YAML = """
general: {stop_time: 3s, seed: 3}
network:
  graph:
    type: gml
    inline: |
      graph [
        directed 0
        node [ id 0 bandwidth_down "2 Mbit" bandwidth_up "2 Mbit" ]
        node [ id 1 bandwidth_down "2 Mbit" bandwidth_up "2 Mbit" ]
        edge [ source 0 target 0 latency "10 ms" packet_loss 0.05 ]
        edge [ source 0 target 1 latency "10 ms" packet_loss 0.05 ]
        edge [ source 1 target 1 latency "10 ms" packet_loss 0.05 ]
      ]
experimental:
  scheduler_policy: tpu
  model_bandwidth: true
  count_paths: true
  event_capacity: 96
  outbox_capacity: 48
hosts:
  left:
    quantity: 8
    network_node_id: 0
    processes: [{path: model:phold, args: msgload=3 size=4096,
                 start_time: 10ms}]
  right:
    quantity: 8
    network_node_id: 1
    processes: [{path: model:phold, args: msgload=3 size=4096,
                 start_time: 10ms}]
"""
# a tgen server and 20 clients whose downlink (2 Mbit) is slower than
# the server's uplink (20 Mbit): chunks queue at the clients, retries
# pile on, lossy paths; 3 s (tests/test_torch_nic.py's config with 20
# clients, not 4)
NIC_TGEN_YAML = """
general: {stop_time: 3s, seed: 4}
network:
  graph:
    type: gml
    inline: |
      graph [ directed 0
        node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        node [ id 1 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        edge [ source 0 target 0 latency "10 ms" packet_loss 0.1 ]
        edge [ source 0 target 1 latency "20 ms" packet_loss 0.1 ]
        edge [ source 1 target 1 latency "10 ms" packet_loss 0.1 ] ]
experimental: {scheduler_policy: tpu, model_bandwidth: true,
               event_capacity: 128, outbox_capacity: 64}
hosts:
  server:
    network_node_id: 0
    bandwidth_up: 20 Mbit
    processes: [{path: model:tgen_server, start_time: 10ms}]
  client:
    quantity: 20
    network_node_id: 1
    bandwidth_down: 2 Mbit
    processes:
    - {path: model:tgen_client, start_time: 100ms,
       args: server=server size=100KiB count=2 pause=200ms retry=300ms}
"""
# tests/test_torch_nic.py's Tor config (16 relays, 32 clients whose
# vertex has a 1 Mbit downlink, loss 0.05, retries), 8 s
NIC_TOR_YAML = """
general: {stop_time: 8s, seed: 1}
network:
  graph:
    type: gml
    inline: |
      graph [
        directed 0
        node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        node [ id 1 bandwidth_down "1 Mbit" bandwidth_up "1 Gbit" ]
        edge [ source 0 target 0 latency "20 ms" packet_loss 0.05 ]
        edge [ source 0 target 1 latency "40 ms" packet_loss 0.05 ]
        edge [ source 1 target 1 latency "20 ms" packet_loss 0.05 ]
      ]
experimental:
  scheduler_policy: tpu
  model_bandwidth: true
  event_capacity: 96
  outbox_capacity: 48
hosts:
  relay:
    quantity: 16
    network_node_id: 0
    processes: [{path: model:tor_relay, start_time: 100ms}]
  client:
    quantity: 32
    network_node_id: 1
    processes:
    - {path: model:tor_client, start_time: 1s,
       args: cells=48 count=2 pause=500ms retry=2s}
"""
# tests/test_faults.py's FAULT_YAML with its LINK_FAULTS, on the tpu
# policy, with the path counters
FAULT_YAML = """
general: {stop_time: 8s, seed: 3}
network:
  graph:
    type: gml
    inline: |
      graph [ directed 0
        node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        node [ id 1 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        edge [ source 0 target 0 latency "10 ms" packet_loss 0.0 ]
        edge [ source 0 target 1 latency "20 ms" packet_loss 0.0 ]
        edge [ source 1 target 1 latency "10 ms" packet_loss 0.0 ]
      ]
  faults:
    - {kind: degrade, time: 2500ms, duration: 1s, source: 0,
       target: 1, latency_multiplier: 3, extra_packet_loss: 0.2}
    - {kind: link_down, time: 4s, source: 0, target: 1}
    - {kind: link_up, time: 5s, source: 0, target: 1}
experimental:
  scheduler_policy: tpu
  count_paths: true
  event_capacity: 256
  outbox_capacity: 256
hosts:
  server:
    network_node_id: 0
    processes:
    - path: model:tgen_server
      start_time: 10ms
  client:
    quantity: 3
    network_node_id: 1
    processes:
    - path: model:tgen_client
      args: server=server size=200KiB count=40 pause=50ms retry=300ms
      start_time: 100ms
"""
# examples/tgen_faults_hier.yaml on the tpu policy with its link faults
# alone (its host crash and restart go to the hybrid policy, not
# ported), cut to FAULTS_HIER_STOP
FAULTS_HIER_STOP = "8s"
FAULTS_HIER = [
    "experimental.scheduler_policy=tpu",
    f"general.stop_time={FAULTS_HIER_STOP}",
    "network.faults=["
    "{kind: degrade, time: 2s, duration: 1s, source: 0, target: 1,"
    " latency_multiplier: 3, extra_packet_loss: 0.05},"
    "{kind: degrade, time: 4s, duration: 1s, source: 0, target: 2,"
    " latency_multiplier: 2},"
    "{kind: link_down, time: 6s, source: 0, target: 1},"
    "{kind: link_up, time: 7s, source: 0, target: 1}]"]

REPLACES = {
    "pop_phase": "shadow_tpu/device/engine.py:737",
    "pop_tgen": "shadow_tpu/device/engine.py:742",
    "pop_tor": "shadow_tpu/device/apps.py:548",
    "judge_outbox": "shadow_tpu/device/engine.py:1388",
    "route": "shadow_tpu/device/engine.py:1291",
    "merge_heaps": "shadow_tpu/device/engine.py:1550",
    # gather_parts at its two call sites: the judge's lookup
    # (engine.py:1428-1430) and the pop's self latency (engine.py:1186)
    "judge_outbox_hier": "shadow_tpu/topology/hierarchy.py:192",
    "pop_phase_hier": "shadow_tpu/device/engine.py:1186",
    # the model_bandwidth branch of _step, fused into each pop
    "pop_phase_nic": "shadow_tpu/device/engine.py:1008",
    "pop_tgen_nic": "shadow_tpu/device/engine.py:1008",
    "pop_tor_nic": "shadow_tpu/device/engine.py:1008",
    # _tbl/_ep_of with the epoch axis: the judge's lookup and the pop's
    # self latency, dense and factored (gather_parts with e)
    "judge_outbox_ep": "shadow_tpu/device/engine.py:638",
    "pop_tgen_ep": "shadow_tpu/device/engine.py:1186",
    "judge_outbox_ep_hier": "shadow_tpu/topology/hierarchy.py:192",
    "pop_tgen_ep_hier": "shadow_tpu/device/engine.py:1186",
    "pop_phase_ep_hier": "shadow_tpu/device/engine.py:1186",
    "count_paths": "shadow_tpu/device/engine.py:1327",
    # the state audit: the clock lane of _step, fused into each pop,
    # _audit_round, and the tallies between the judge and the route
    "pop_phase_aud": "shadow_tpu/device/engine.py:800",
    "pop_tgen_aud": "shadow_tpu/device/engine.py:800",
    "pop_tor_aud": "shadow_tpu/device/engine.py:800",
    "pop_phase_hier_aud": "shadow_tpu/device/engine.py:800",
    "pop_tgen_nic_aud": "shadow_tpu/device/engine.py:800",
    "audit_round": "shadow_tpu/device/engine.py:2072",
    # _audit_round on a mesh: the shard's int64 difference before
    # `_axis_sum64`, and the conserve bit from the mesh's sum
    "audit_round_rank": "shadow_tpu/device/engine.py:2072",
    "audit_conserve": "shadow_tpu/device/engine.py:2099",
    "phase_tally": "shadow_tpu/device/engine.py:1941",
    # the window loop: _round/_phase/_run_shard/_axis_min
    "loop_control": "shadow_tpu/device/engine.py:2116",
    # the same with the tallies between the judge and the route folded in
    "loop_control_tally": "shadow_tpu/device/engine.py:2116",
    # the hybrid policy's batched judge, on each view of the tables
    **dict.fromkeys(("judge_batch", "judge_batch_hier", "judge_batch_ep",
                     "judge_batch_ep_hier"),
                    "shadow_tpu/device/judge.py:80"),
    # the compaction: the window merge's CX < OB branch of _flat_sorted
    # and the global merge's _compact_flat
    "compact_outbox": "shadow_tpu/device/engine.py:1299",
    "compact_outbox_global": "shadow_tpu/device/engine.py:1858",
    # the host mesh: _shard_edges ... _pack_remote; _pack_two_phase and
    # _tp_mask (both halves); the windows of _host_windows at my_shard
    # after the exchange (all_gather's `(kg, pg)` order too) and the
    # two_phase arrivals' key re-sort; the window merge's second block
    "pack_remote": "shadow_tpu/device/engine.py:1635",
    "pack_two_phase": "shadow_tpu/device/engine.py:1742",
    "pack_two_phase2": "shadow_tpu/device/engine.py:1808",
    "route_window": "shadow_tpu/device/engine.py:2008",
    "route_keyed": "shadow_tpu/device/engine.py:1989",
    "merge_heaps2": "shadow_tpu/device/engine.py:2033",
}
SOURCES = {
    "pop_phase": "shadow_tpu_torch/csrc/pop_phase.cu",
    "pop_tgen": "shadow_tpu_torch/csrc/pop_phase.cu",
    "pop_tor": "shadow_tpu_torch/csrc/pop_phase.cu",
    "judge_outbox": "shadow_tpu_torch/csrc/judge_outbox.cu",
    "route": "shadow_tpu_torch/csrc/route.cu",
    "merge_heaps": "shadow_tpu_torch/csrc/merge_heaps.cu",
    "judge_outbox_hier": "shadow_tpu_torch/csrc/judge_outbox.cu",
    "pop_phase_hier": "shadow_tpu_torch/csrc/pop_phase.cu",
    "pop_phase_nic": "shadow_tpu_torch/csrc/pop_phase.cu",
    "pop_tgen_nic": "shadow_tpu_torch/csrc/pop_phase.cu",
    "pop_tor_nic": "shadow_tpu_torch/csrc/pop_phase.cu",
    "judge_outbox_ep": "shadow_tpu_torch/csrc/judge_outbox.cu",
    "pop_tgen_ep": "shadow_tpu_torch/csrc/pop_phase.cu",
    "judge_outbox_ep_hier": "shadow_tpu_torch/csrc/judge_outbox.cu",
    "pop_tgen_ep_hier": "shadow_tpu_torch/csrc/pop_phase.cu",
    "pop_phase_ep_hier": "shadow_tpu_torch/csrc/pop_phase.cu",
    "count_paths": "shadow_tpu_torch/csrc/count_paths.cu",
    **dict.fromkeys(("pop_phase_aud", "pop_tgen_aud", "pop_tor_aud",
                     "pop_phase_hier_aud", "pop_tgen_nic_aud"),
                    "shadow_tpu_torch/csrc/pop_phase_aud.cu"),
    "audit_round": "shadow_tpu_torch/csrc/audit_round.cu",
    "audit_round_rank": "shadow_tpu_torch/csrc/audit_round.cu",
    "audit_conserve": "shadow_tpu_torch/csrc/audit_round.cu",
    "phase_tally": "shadow_tpu_torch/csrc/phase_tally.cu",
    "loop_control": "shadow_tpu_torch/csrc/loop_control.cu",
    "loop_control_tally": "shadow_tpu_torch/csrc/loop_control.cu",
    **dict.fromkeys(("judge_batch", "judge_batch_hier", "judge_batch_ep",
                     "judge_batch_ep_hier"),
                    "shadow_tpu_torch/csrc/judge_batch.cu"),
    **dict.fromkeys(("compact_outbox", "compact_outbox_global"),
                    "shadow_tpu_torch/csrc/compact_outbox.cu"),
    "pack_remote": "shadow_tpu_torch/csrc/pack_remote.cu",
    "pack_two_phase": "shadow_tpu_torch/csrc/pack_two_phase.cu",
    "pack_two_phase2": "shadow_tpu_torch/csrc/pack_two_phase.cu",
    "route_window": "shadow_tpu_torch/csrc/route.cu",
    "route_keyed": "shadow_tpu_torch/csrc/route.cu",
    "merge_heaps2": "shadow_tpu_torch/csrc/merge_heaps.cu",
}
# the kernels line's rows, in order
ROWS = ("pop_phase", "pop_tgen", "pop_tor", "judge_outbox", "route",
        "merge_heaps", "pop_phase_hier", "judge_outbox_hier",
        "pop_phase_nic", "pop_tgen_nic", "pop_tor_nic", "judge_outbox_ep",
        "pop_tgen_ep", "judge_outbox_ep_hier", "pop_tgen_ep_hier",
        "pop_phase_ep_hier", "count_paths", "pop_phase_aud",
        "pop_tgen_aud", "pop_tor_aud", "pop_phase_hier_aud",
        "pop_tgen_nic_aud", "audit_round", "loop_control", "phase_tally",
        "loop_control_tally", "judge_batch", "judge_batch_hier",
        "judge_batch_ep", "judge_batch_ep_hier", "compact_outbox",
        "compact_outbox_global",
        "pack_remote", "pack_two_phase", "pack_two_phase2",
        "route_window", "route_keyed", "merge_heaps2",
        "audit_round_rank", "audit_conserve")
AUDIT = "experimental.state_audit=true"
# tests/test_torch_audit.py's BUSY: PHOLD without loss at msgload 4,
# with self-sends and a 50 ms runahead, so that every host keeps several
# events at several times within a window; the seeded corruptions of
# its state paused at CORRUPT_PAUSE, run on to CORRUPT_RESUME
BUSY_YAML = """
general: {stop_time: 2s, seed: 5}
network:
  graph:
    type: gml
    inline: |
      graph [ directed 0
        node [ id 0 bandwidth_down "100 Mbit" bandwidth_up "100 Mbit" ]
        node [ id 1 bandwidth_down "100 Mbit" bandwidth_up "100 Mbit" ]
        edge [ source 0 target 0 latency "30 ms" packet_loss 0.0 ]
        edge [ source 0 target 1 latency "10 ms" packet_loss 0.0 ]
        edge [ source 1 target 1 latency "30 ms" packet_loss 0.0 ] ]
experimental: {scheduler_policy: tpu, event_capacity: 64,
               outbox_capacity: 16, runahead: 50 ms}
hosts:
  left:
    quantity: 8
    network_node_id: 0
    processes: [{path: model:phold, args: msgload=4 selfloop=1,
                 start_time: 100ms}]
  right:
    quantity: 8
    network_node_id: 1
    processes: [{path: model:phold, args: msgload=4 selfloop=1,
                 start_time: 150ms}]
"""
CORRUPT_PAUSE, CORRUPT_RESUME, CORRUPT_STOP = 300_000_000, 10**9, 2 * 10**9
CORRUPTIONS = {"counter": "counter-negativity",
               "heap_swap": "clock-monotonicity",
               "head": "packet-conservation",
               "clock": "clock-monotonicity",
               "lost_row": "packet-conservation"}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------
# phase 2 inputs: seeded, full width
# ----------------------------------------------------------------------
def random_state(rng, H, E, dev):
    from shadow_tpu_torch.device.kernels import IMAX, INF

    n_live = rng.integers(0, E + 1, H)
    n_live[rng.random(H) < 0.05] = E          # full heaps
    slot = np.arange(E)[None, :]
    live = slot < n_live[:, None]
    ht = np.sort(rng.integers(0, 2 * 10**9, (H, E)), axis=1)
    ht = np.where(live, ht, INF).astype(np.int64)
    src = rng.integers(0, 2**32, (H, E), dtype=np.uint64)
    seq = rng.integers(0, 2**32, (H, E), dtype=np.uint64)
    src[:, 0], seq[:, 1] = 0xFFFFFFFF, 0xFFFFFFFF
    seq[:, 2] = 0
    hk = ((src << np.uint64(32)) | seq).view(np.int64)
    hk = np.where(live, hk, IMAX)
    kind = rng.choice(np.array([0, 1, 2, 2, 2, 3], np.int64), (H, E))
    hm = (kind << 32) | rng.integers(0, 2**31, (H, E))
    head = np.minimum(rng.integers(0, 4, H), n_live).astype(np.int32)
    i32 = np.iinfo(np.int32)

    def counters():
        c = rng.integers(i32.min, i32.max, H, dtype=np.int64)
        c[:3] = [-1, 0, i32.max]
        return c.astype(np.int32)

    arrays = {
        "ht": ht, "hk": hk, "hm": hm,
        "hv": rng.integers(-2**63, 2**63 - 1, (H, E), dtype=np.int64),
        "hw": rng.integers(0, 2**32, (H, E), dtype=np.int64),
        "head": head, "event_seq": counters(), "packet_seq": counters(),
        "app_seq": counters(), "app": counters()[:, None],
        "n_exec": counters(), "n_sent": counters(), "n_drop": counters(),
        "n_deliv": counters(), "overflow": rng.integers(0, 5, H),
        "x_overflow": np.zeros(H, np.int32),
        "chk": rng.integers(0, 2**63 - 1, H, dtype=np.int64),
        "occ_heap": rng.integers(0, E, H), "occ_ob": np.zeros(H),
        "occ_in": rng.integers(0, 8, H), "occ_x": np.zeros((1, 1)),
        "occ_trips": np.zeros(1), "occ_phases": np.zeros(1),
    }
    from shadow_tpu_torch.device.engine import state_from_numpy

    return state_from_numpy(arrays, dev)


def random_outbox(rng, H, OB, torch, dev):
    """A judged outbox: 15% live rows, a tenth of them aimed at 16 hot
    hosts (past IN), times past T_CAP among them, DROP_T markers."""
    from shadow_tpu_torch.device.kernels import DROP_T, INF

    shape = (H, OB)
    live = rng.random(shape) < 0.15
    t = rng.integers(10**9, 3 * 10**9, shape)
    big = rng.random(shape) < 0.02
    t = np.where(big, rng.integers(2**46, 2**61, shape), t)
    t = np.where(rng.random(shape) < 0.01, DROP_T, t)
    t = np.where(live, t, INF).astype(np.int64)
    dst = rng.integers(0, H, shape)
    hot = rng.random(shape) < 0.1
    dst = np.where(hot, rng.integers(0, 16, shape), dst)
    row = np.arange(H * OB, dtype=np.int64).reshape(shape)
    k = ((row // OB) << 32) | rng.integers(0, 2**32, shape)
    m = (dst.astype(np.int64) << 32) | (2 | (1 << 8))
    s = rng.integers(-2**63, 2**63 - 1, shape, dtype=np.int64)
    v = (rng.integers(0, 2**32, shape).astype(np.int64) << 32) | \
        rng.integers(0, 2**32, shape)
    return {f: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for f, a in zip("tkmsv", (t, k, m, s, v))}


def clone(d):
    return {k: v.clone() for k, v in d.items()}


def max_abs_err(a: dict, b: dict, keys) -> float:
    err = 0.0
    for k in keys:
        x, y = a[k], b[k]
        if x.dtype == y.dtype and bool((x == y).all()):
            continue
        err = max(err, float((x.double() - y.double()).abs().max()))
        err = max(err, 1.0)       # any integer mismatch is >= 1
    return err


def window_block(K, win_end, dev):
    """A control block with `run` set and the window end `win_end`: what
    the window loop hands the pop and the judge (made outside the timed
    calls, which would otherwise copy one to the card first)."""
    return K.control_block(dev, run=1, win_end=win_end)


# device cycles (about 1.2 ms) the card sleeps before each timed call,
# while the host enqueues it
SLEEP_CYCLES = 2_000_000


def time_median(torch, run, make, reps):
    """Median device ms of run(inputs) over `reps` fresh input
    copies, by CUDA events around the call alone. The card sleeps
    (SLEEP_CYCLES) before the first event, so the host's work of the
    call (the wrapper's checks, the launch) is enqueued before the
    event runs and the time is the device's."""
    times = []
    for _ in range(reps):
        args = make()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        run(*args)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def finish(r):
    """Bound ms and what sets it, from the bytes and integer operations
    the function must move and do at these inputs."""
    r["bound_ms"] = 1e3 * max(r["bytes"] / HBM_BYTES_PER_S,
                              r["ops"] / INT32_OPS_PER_S)
    r["bound_by"] = ("bytes" if r["bytes"] / HBM_BYTES_PER_S
                     >= r["ops"] / INT32_OPS_PER_S else "operations")
    return r


def report_line(name, r):
    extra = "".join(f", {k} {r[k]:.4f} ms" for k in
                    ("torch_sort_ms", "library_ms") if r.get(k) is not None)
    print(f"[kernels] {name}: equal to plain (max abs err {r['err']}); "
          f"{r['shape']}; kernel {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
          f"(by {r['bound_by']}: {r['bytes']} B, {r['ops']} integer "
          f"operations){extra}", flush=True)


def phold_kernels(torch, K, scratch, rng, H, dev, world=None,
                  lossless=None):
    """K1, K2 and K3 at the PHOLD full-width shapes, on a 2-vertex dense
    world; given a world of factored tables (`million_world`), K1 and
    K2 on it instead (their `_hier` instantiations), with K1's send rows
    retargeted so that K2 sees every kind of pair, and K2 also on the
    `lossless` world's tables, where nothing may drop."""
    from shadow_tpu_torch.device.apps import PholdDevice
    from shadow_tpu_torch.device.engine import STATE_DTYPES
    from shadow_tpu_torch.device.prng import seed_key

    E, IN, msgload = 64, 64, 3
    KS = max(1, msgload)
    B = 32 // KS
    OB = B * KS
    hier = world is not None
    if not hier:
        world = {
            "host_vertex": torch.from_numpy(
                rng.integers(0, 2, H).astype(np.int32)).to(dev),
            "lat": torch.tensor([[30_000_000, 50_000_000],
                                 [50_000_000, 30_000_000]],
                                dtype=torch.int32, device=dev),
            "rel": torch.tensor([[0.98, 0.9], [0.9, 0.98]],
                                dtype=torch.float32, device=dev),
            "epoch_times": torch.zeros(1, dtype=torch.int64, device=dev),
        }
    win_end = 10**9
    state0 = random_state(rng, H, E, dev)
    state_keys = list(STATE_DTYPES)
    ob_keys = list(K.OB_FIELDS)

    def params(selfloop):
        app = PholdDevice(n_hosts_total=H, msgload=msgload, size=512,
                          selfloop=selfloop)
        return K.PhaseParams(E=E, K=KS, T=0, P=1, B=B, IN=IN, C=1,
                             boot_end=5 * 10**8, seed=seed_key(7),
                             app=app)

    def empty_ob():
        return {f: torch.empty((H, OB), dtype=torch.int64, device=dev)
                for f in ob_keys}

    out = {"pop_phase": {"err": 0.0}}
    # K1, with and without self-sends (the dirty stop)
    for selfloop in (0, 1):
        p = params(selfloop)
        sk, sp = clone(state0), clone(state0)
        obk, obp = empty_ob(), empty_ob()
        pk = torch.empty(H, dtype=torch.int32, device=dev)
        pp = torch.empty_like(pk)
        scratch.pop(sk, obk, pk, world, win_end, p)
        K.pop_plain(sp, obp, pp, world, win_end, p)
        torch.cuda.synchronize()
        err = max(max_abs_err(sk, sp, state_keys),
                  max_abs_err(obk, obp, ob_keys),
                  max_abs_err({"pops": pk}, {"pops": pp}, ["pops"]))
        check(err == 0.0, f"pop_phase (selfloop={selfloop}) differs "
              f"from its plain version (max abs err {err})")
        check(int(pk.sum()) > 0, "pop_phase popped nothing")
        out["pop_phase"]["err"] = max(out["pop_phase"]["err"], err)
        if selfloop == 0:
            pops0, ob_k1, state_k1 = pk, obk, sk
    p = params(0)

    win = window_block(K, win_end, dev)

    def k1_args():
        return (clone(state0), empty_ob(),
                torch.empty(H, dtype=torch.int32, device=dev), world,
                win, p)

    out["pop_phase"]["ms"] = time_median(torch, scratch.pop,
                                         k1_args, 7)
    out["pop_phase"]["plain_ms"] = time_median(torch, K.pop_plain,
                                               k1_args, 3)
    total_pops = int(pops0.sum())
    sends = int((ob_k1["t"] < K.INF).sum())
    # bytes the function must move: downstream reads only t of an
    # unused outbox column, and all five fields of a send
    out["pop_phase"]["bytes"] = (
        H * OB * 8 + sends * 4 * 8     # outbox written
        + total_pops * 4 * 8           # popped rows: t, key, meta, d2
        + H * 8                        # the head time that stopped it
        + H * (7 * 4 + 8) * 2          # per-host counters read+written
        + H * 4 * 2                    # host vertex, pop count
        + (H * 4 if hier else 0))      # the self-latency vector
    out["pop_phase"]["ops"] = (2 * H + 2 * sends) * THREEFRY_OPS
    out["pop_phase"]["shape"] = f"H={H} E={E} OB={OB} pops={total_pops}"
    finish(out["pop_phase"])
    out["pop_phase_aud"] = aud_pop_case(
        torch, K, scratch, rng, "pop_phase" + (K.HIER if hier else ""),
        state0, world, p, win_end, dev, out["pop_phase"])

    if hier:
        # K2 on K1's outbox, its destinations retargeted to every kind
        # of pair
        pairs = retarget(torch, K, ob_k1, world, rng)
        out["judge_outbox"] = judge_case(
            torch, K, scratch, state_k1, ob_k1, world, win_end, p, H, OB,
            pairs)
        if lossless is not None:
            err, sk = judge_compare(torch, K, scratch, state_k1, ob_k1,
                                    lossless, win_end, p)
            check(bool((sk["n_drop"] == state_k1["n_drop"]).all()),
                  "judge_outbox on lossless factored tables dropped a "
                  "packet")
            out["judge_outbox"]["err_on_shipped_tables"] = err
        return out
    # K2 on K1's real outbox
    out["judge_outbox"] = judge_case(torch, K, scratch, state_k1, ob_k1,
                                     world, win_end, p, H, OB)
    # K3 on a synthetic judged outbox with hot destinations
    out["merge_heaps"] = merge_case(torch, K, scratch, rng, state0, p, H,
                                    OB, dev)
    return out


def judge_compare(torch, K, scratch, state, ob, world, win_end, p):
    """K2 against the plain judge on one outbox: exact on every state
    leaf and outbox field. Returns (error, the kernel's state)."""
    from shadow_tpu_torch.device.engine import STATE_DTYPES

    sk, sp = clone(state), clone(state)
    obk, obp = clone(ob), clone(ob)
    scratch.judge_outbox(sk, obk, world, win_end, p)
    K.judge_outbox_plain(sp, obp, world, win_end, p)
    torch.cuda.synchronize()
    err = max(max_abs_err(sk, sp, list(STATE_DTYPES)),
              max_abs_err(obk, obp, list(K.OB_FIELDS)))
    tables = "factored" if isinstance(world["lat"], tuple) else "dense"
    check(err == 0.0, f"judge_outbox (C={p.C}, {tables} tables) differs "
          f"from its plain version (max abs err {err})")
    return err, sk


def judge_case(torch, K, scratch, state, ob, world, win_end, p, H, OB,
               pairs=None):
    """K2 against the plain judge, timed. `pairs` (factored tables,
    from `retarget`) adds the table bytes the lookups touch to the
    bound and the kinds of pair to the shape."""
    err, sk = judge_compare(torch, K, scratch, state, ob, world, win_end, p)
    dropped = int(((sk["n_drop"].long() - state["n_drop"].long())
                   & 0xFFFFFFFF).sum())
    check(dropped > 0, "judge_outbox dropped nothing: the roll went "
          "untested")
    is_send = (ob["t"] < K.INF) & ((ob["m"] & 0xFF) == 2)
    sends = int(is_send.sum())
    packets = int(torch.where(is_send, (ob["m"] & K.U32) >> 8, 0).sum())
    if p.C > 1:
        check(int(((ob["m"] & K.U32) >> 8)[is_send].max()) == p.C,
              "judge_outbox: no full train in the outbox")

    win = window_block(K, win_end, state["head"].device)

    def k2_args():
        return (clone(state), clone(ob), world, win, p)

    return finish({
        "err": err,
        "ms": time_median(torch, scratch.judge_outbox, k2_args, 7),
        "plain_ms": time_median(torch, K.judge_outbox_plain, k2_args, 3),
        # t of every row; m and v read, t/m/v written, for sends; the
        # destination's vertex per send; per-host counters and vertex;
        # on factored tables, the table entries the lookups touch
        "bytes": (H * OB * 8 + sends * (2 * 8 + 3 * 8 + 4) + H * 4 * 6
                  + (pairs["table_bytes"] if pairs else 0)),
        "ops": (2 * H + 2 * packets) * THREEFRY_OPS,
        "shape": f"H={H} OB={OB} C={p.C} sends={sends} "
                 f"packets={packets} dropped={dropped}"
                 + ("".join(f" {k}={v}" for k, v in pairs.items())
                    if pairs else "")})


def retarget(torch, K, ob, world, rng):
    """Rewrite the destinations of an outbox's send rows so that the
    factored lookup meets every kind of pair: a tenth go to a host in
    the sender's own cluster, a tenth to the sender itself, a tenth to
    another host on the sender's vertex where there is one; the rest
    keep PHOLD's uniform destinations (nearly all in another cluster).
    Returns the count of each kind and the table bytes the lookups
    touch (each entry read once)."""
    hv = world["host_vertex"].long()
    cl = world["lat"][1].long()
    H, OB = ob["t"].shape
    dev = hv.device
    host_cl = cl[hv]
    C = int(world["lat"][0].shape[-1])
    T = int(world["epoch_times"].shape[0])
    order = torch.argsort(host_cl, stable=True)
    counts = torch.bincount(host_cl, minlength=C)
    starts = torch.cumsum(counts, 0) - counts
    u = torch.from_numpy(rng.random((H, OB))).to(dev)
    same_cl = order[(starts[host_cl][:, None]
                     + (u * counts[host_cl][:, None]).long()).clamp(
                         max=H - 1)]
    # the other host on the sender's vertex (itself where it is alone)
    by_v = torch.argsort(hv, stable=True)
    sv = hv[by_v]
    partner = torch.arange(H, device=dev)
    pair = sv[1:] == sv[:-1]
    partner[by_v[:-1][pair]] = by_v[1:][pair]
    partner[by_v[1:][pair]] = by_v[:-1][pair]
    gid = torch.arange(H, device=dev)[:, None].expand(H, OB)
    send = (ob["t"] < K.INF) & ((ob["m"] & 0xFF) == 2)
    pick = torch.from_numpy(rng.random((H, OB))).to(dev)
    dst = ob["m"] >> 32
    dst = torch.where(pick < 0.1, same_cl, torch.where(
        pick < 0.2, gid, torch.where(pick < 0.3, partner[:, None]
                                     .expand(H, OB), dst)))
    ob["m"] = torch.where(send, (dst << 32) | (ob["m"] & K.U32), ob["m"])
    d = ob["m"] >> 32
    sv_, dv_ = hv[:, None].expand(H, OB), hv[d]
    same_v = send & (sv_ == dv_)
    kinds = {
        "self_sends": int((same_v & (d == gid)).sum()),
        "same_vertex_other_host": int((same_v & (d != gid)).sum()),
        "same_cluster": int((send & ~same_v & (cl[sv_] == cl[dv_])).sum()),
        "cross_cluster": int((send & (cl[sv_] != cl[dv_])).sum())}
    for k, n in kinds.items():
        check(n > 0, f"judge_outbox on factored tables: no {k} pair")
    # cl, acc_lat and acc_rel of every vertex a lookup names, the self
    # vectors of sv == dv pairs, and the core pair
    touched = torch.unique(torch.cat([sv_[send], dv_[send]]))
    selfv = torch.unique(sv_[same_v])
    kinds["table_bytes"] = int(touched.numel() * 12 + selfv.numel() * 8
                               + C * C * 8 * T)
    return kinds


def million_world(dev):
    """examples/tgen_1000000.yaml built as shipped: its 1,000,000 hosts
    tiled as the file tiles them (a server on each cluster's first
    spoke, a client on every spoke from vertex 201, so that clients
    4,999, 9,999, ... share servers 1-199's vertices) on its factored
    tables (V=1,000,200, C=200). Returns (config, built simulation,
    world(hub_loss)), the last giving the engine world on the card with
    the tables' `hub_packet_loss` set to `hub_loss`."""
    from shadow_tpu_torch.config import load_config
    from shadow_tpu_torch.core.build import build
    from shadow_tpu_torch.device.apps import PholdDevice
    from shadow_tpu_torch.device.engine import DeviceEngine, EngineConfig
    from shadow_tpu_torch.topology.generate import generate_star_clusters

    cfg = load_config(os.path.join(REPO, "examples", "tgen_1000000.yaml"))
    sim = build(cfg)
    H = len(sim.host_vertex)

    def world(hub_loss):
        ht = sim.topology.hier if hub_loss == 0 else generate_star_clusters(
            {**cfg.network.graph_params, "hub_packet_loss": hub_loss},
            representation="hierarchical").hier
        return DeviceEngine(
            EngineConfig(n_hosts=H), PholdDevice(n_hosts_total=H),
            sim.host_vertex, ht.lat_parts(), ht.rel_parts(),
            device=dev).world

    return cfg, sim, world


def star_world(torch, world, dev):
    """`world` with its dense tables replaced by the factored tables
    of a 2-hub star with 2 spokes each (V=6, the dense worlds' vertex
    count), lossy hubs and access."""
    from shadow_tpu_torch.topology.generate import generate_star_clusters

    ht = generate_star_clusters(
        {"clusters": 2, "spokes_per_cluster": 2, "hub_latency": "40 ms",
         "access_latency": "6 ms", "hub_packet_loss": 0.05,
         "access_packet_loss": 0.01}, representation="hierarchical").hier
    lat = tuple(torch.from_numpy(np.asarray(a, np.int32)).to(dev)
                for a in ht.lat_parts())
    rel = tuple(lat[1] if i == 1 else torch.from_numpy(
        np.asarray(a, np.float32)).to(dev)
        for i, a in enumerate(ht.rel_parts()))
    check(ht.n_vertices == 6, "star_world: need 6 vertices")
    return {**world, "lat": lat, "rel": rel}


def hier_kernels(torch, K, scratch, rng, dev):
    """K1 and K2 on the factored tables of examples/tgen_1000000.yaml
    at its full width (1,000,000 hosts), with hub_packet_loss 0.02 as
    in the full run phold_1m_hier; K2 also on the tables as shipped
    (lossless: nothing may drop)."""
    cfg, sim, world = million_world(dev)
    check(cfg.network.graph_params.get("hub_packet_loss", 0.0) == 0.0,
          "tgen_1000000.yaml: expected lossless tables")
    out = phold_kernels(torch, K, scratch, rng, len(sim.host_vertex), dev,
                        world=world(PHOLD_1M_HUB_LOSS),
                        lossless=world(0.0))
    return {"pop_phase_hier": out["pop_phase"],
            "judge_outbox_hier": out["judge_outbox"],
            "pop_phase_hier_aud": out["pop_phase_aud"]}


def merge_case(torch, K, scratch, rng, state0, p, H, OB, dev):
    """K3 on a synthetic judged outbox with hot destinations, against
    its plain version: every host's heap checked (no fresh words, as a
    state from outside the engine), and trusting the heaps' order on
    the same heaps in (t, key) order (`lex_sorted`), as the main path
    runs it; timed both ways, the latter as the row's ms."""
    E, IN = p.E, p.IN
    ob3 = random_outbox(rng, H, OB, torch, dev)
    route = K.route_plain(ob3)
    err, over = merge_compare(torch, K, scratch, state0, ob3, route, p)
    check(over > 0, "merge_heaps overflowed nothing: the overflow "
          "path went untested")
    return merge_row(torch, K, scratch, lex_sorted(torch, K, state0), ob3,
                     route, p, err, f"H={H} E={E} IN={IN} overflow={over}")


def lex_sorted(torch, K, state):
    """A copy of `state` as the engine's merges leave one: each host's
    five heap fields in (t, key) order (stable; a random state's rows
    are in time order, and a tie may hold its keys out of order) and
    occ_heap at least its live rows (a random state's is random)."""
    out = clone(state)
    _, o1 = torch.sort(state["hk"], dim=1, stable=True)
    _, o2 = torch.sort(state["ht"].gather(1, o1), dim=1, stable=True)
    order = o1.gather(1, o2)
    for f in K.HEAP_FIELDS:
        out[f] = state[f].gather(1, order).contiguous()
    live = (out["ht"] < K.INF).sum(1).to(torch.int32)
    out["occ_heap"] = torch.maximum(out["occ_heap"], live)
    return out


def trusted(K, dev, R=1):
    """K3's words of an engine whose heaps came from its own merges:
    their order holds, no host is checked."""
    flags = K.merge_flags(dev, R)
    flags[0] = 0
    return flags


def tails_sorted(torch, state):
    """[H] bool: each host's rows [head, E) in (t, key) order."""
    ht, hk = state["ht"], state["hk"]
    E = ht.shape[-1]
    j = torch.arange(E - 1, device=ht.device)[None, :]
    ok = (ht[:, :-1] < ht[:, 1:]) | ((ht[:, :-1] == ht[:, 1:])
                                     & (hk[:, :-1] <= hk[:, 1:]))
    return (ok | (j < state["head"].long()[:, None])).all(1)


def flush_shares(torch, state, counts):
    """Shares of the hosts a merge leaves as they are (head 0, no
    arrivals), merges (tail in order) and sorts in full, and their
    counts; from head and the counts, in Python."""
    head = state["head"].long()
    changed = (head != 0) | (counts.long() > 0)
    ok = tails_sorted(torch, state)
    H = head.shape[0]
    n = {"unchanged": int((~changed).sum()),
         "merged": int((changed & ok).sum()),
         "full_sort": int((changed & ~ok).sum())}
    return {**{k: v / H for k, v in n.items()}, "hosts": n}


def merge_bytes(state, counts, E, IN, verify, second_counts=None):
    """Bytes K3 must move at these inputs: head and the counts of every
    host; of a changed host its starts, its five heap fields read and
    written, its head written and its three counters read and written;
    the accepted arrivals' five fields and perm entry; checking a fresh
    state, t and key of every unchanged host's row and two of its
    counters."""
    head = state["head"].long()
    cnt = [counts.long()] + ([] if second_counts is None
                             else [second_counts.long()])
    H = head.shape[0]
    changed = int(((head != 0) | (sum(cnt) > 0)).sum())
    accepted = sum(int(c.clamp(max=IN).sum()) for c in cnt)
    b = H * (4 + 8 * len(cnt)) + changed * (
        8 * len(cnt) + E * 5 * 8 * 2 + 4 + 3 * 4 * 2) + accepted * 6 * 8
    if verify:
        b += (H - changed) * (E * 16 + 2 * 4 * 2)
    return b


def merge_columns(torch, K, state, ob, perm, starts, counts, IN):
    """The [H, E+IN] columns (t, key and the packed payloads) of the
    heap and the arrival windows, as the plain merge builds them."""
    E = state["ht"].shape[1]
    dev = perm.device
    live = torch.arange(E, device=dev)[None, :] >= \
        state["head"].long()[:, None]
    a = torch.arange(IN, device=dev)[None, :]
    ok = a < counts.clamp(max=IN)[:, None]
    pidx = perm[(starts[:, None] + a).clamp(0, perm.shape[0] - 1)]
    flat = {f: ob[f].reshape(-1)[pidx] for f in K.OB_FIELDS}
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    fm, fs, fv = (torch.where(ok, flat[f], zero) for f in "msv")
    return (torch.cat([torch.where(live, state["ht"], K.INF),
                       torch.where(ok, flat["t"], K.INF)], 1),
            torch.cat([torch.where(live, state["hk"], K.IMAX),
                       torch.where(ok, flat["k"], K.IMAX)], 1),
            torch.cat([state["hm"], K.pack2(K.lo32(fm) & 0xFF,
                                            K.hi32(fs))], 1),
            torch.cat([state["hv"], K.pack2(K.lo32(fs), K.lo32(fv))], 1),
            torch.cat([state["hw"], (fv >> 32) & 0xFFFFFFFF], 1))


def merge_library(torch, E):
    """K3's function in PyTorch calls on the columns of
    `merge_columns`: a stable sort by key, then by time, the five
    fields taken along the order, cut to E."""
    def run(ct, ck, cm, cv, cw):
        _, o1 = torch.sort(ck, dim=1, stable=True)
        _, o2 = torch.sort(ct.gather(1, o1), dim=1, stable=True)
        order = o1.gather(1, o2)[:, :E]
        return [x.take_along_dim(order, 1) for x in (ct, ck, cm, cv, cw)]
    return run


def merge_compare(torch, K, scratch, state0, ob, route, p, fresh=None):
    """K3 against its plain version from `state0` (fresh words `fresh`,
    or None: every heap checked); (err, rows it overflowed)."""
    from shadow_tpu_torch.device.engine import STATE_DTYPES

    sk, sp = clone(state0), clone(state0)
    scratch.merge_heaps(sk, ob, *route, p, fresh=fresh)
    K.merge_heaps_plain(sp, ob, *route, p)
    torch.cuda.synchronize()
    err = max_abs_err(sk, sp, list(STATE_DTYPES))
    check(err == 0.0, f"merge_heaps (E={p.E}, IN={p.IN}, "
          f"{'trusting the order' if fresh is not None else 'checked'}) "
          f"differs from its plain version (max abs err {err})")
    over = int(((sk["overflow"].long() - state0["overflow"].long())
                & 0xFFFFFFFF).sum())
    return err, over


def merge_row(torch, K, scratch, state0, ob, route, p, err, shape):
    """K3 on `state0` (heaps in order) against its plain version
    trusting the order, then its row: ms trusting the order (the main
    path's merge after the first), ms checking every heap, plain and
    library ms, its bound, the hosts' shares."""
    dev = route[0].device
    E, IN = p.E, p.IN
    fresh = trusted(K, dev)
    err2, _ = merge_compare(torch, K, scratch, state0, ob, route, p, fresh)
    cols = merge_columns(torch, K, state0, ob, *route, IN)

    def args(f=None):
        return lambda: (clone(state0), ob, *route, p, None, None, False, f)

    shares = flush_shares(torch, state0, route[2])
    return finish({
        "err": max(err, err2),
        "ms": time_median(torch, scratch.merge_heaps, args(fresh), 7),
        "checked_ms": time_median(torch, scratch.merge_heaps, args(), 7),
        "plain_ms": time_median(torch, K.merge_heaps_plain, lambda: (
            clone(state0), ob, *route, p), 3),
        "library_ms": time_median(torch, merge_library(torch, E),
                                  lambda: cols, 7),
        "bytes": merge_bytes(state0, route[2], E, IN, False),
        "checked_bytes": merge_bytes(state0, route[2], E, IN, True),
        "ops": 0, "shares": shares,
        "shape": f"{shape} arrivals={int(route[2].sum())} accepted="
                 f"{int(route[2].clamp(max=IN).sum())} hosts unchanged/"
                 f"merged/sorted {shares['hosts']}"})


def pop_case(torch, K, scratch, name, state0, world, p, win_end, dev):
    """A burst pop (K4 or K6) against the plain pop on one phase's
    inputs: exact on every state leaf, outbox field and pop count; a
    burst, a timer and a host stopped dirty must all occur. Returns the
    kernel's state and outbox, the error, the counts and both times."""
    from shadow_tpu_torch.device.engine import STATE_DTYPES

    H, E, OB = state0["head"].shape[0], p.E, p.OB
    win = window_block(K, win_end, dev)

    def args():
        return (clone(state0), {f: torch.empty(
            (H, OB), dtype=torch.int64, device=dev) for f in K.OB_FIELDS},
            torch.empty(H, dtype=torch.int32, device=dev), world, win, p)

    ka, pa = args(), args()
    scratch.pop(*ka)
    K.pop_plain(*pa)
    torch.cuda.synchronize()
    (sk, obk, pk), (sp, obp, pp) = ka[:3], pa[:3]
    err = max(max_abs_err(sk, sp, list(STATE_DTYPES)),
              max_abs_err(obk, obp, list(K.OB_FIELDS)),
              max_abs_err({"pops": pk}, {"pops": pp}, ["pops"]))
    check(err == 0.0, f"{name} differs from its plain version (max abs "
          f"err {err})")
    popped = int(((sk["n_exec"].long() - state0["n_exec"].long())
                  & 0xFFFFFFFF).sum())
    iters = int(pk.sum())
    live = obk["t"] < K.INF
    col = torch.arange(OB, device=dev)[None, :] % p.M_out
    timers = int((live & (col == p.K)).sum())
    burst_lanes = int((live & (col > 0) & (col < p.K)).sum())
    dirty = int(((pk < p.B) & (sk["head"] < E) & (
        sk["ht"].gather(1, sk["head"].clamp(max=E - 1).long()[:, None])[
            :, 0] < win_end)).sum())
    check(popped > iters and burst_lanes > 0, f"{name}: no burst ran")
    check(timers > 0 and dirty > 0, f"{name}: no timer, or no host "
          "stopped dirty")
    rows = int(live.sum())
    return {"state": sk, "ob": obk, "err": err, "popped": popped,
            "rows": rows,
            "counts": f"iterations={iters} events={popped} rows={rows} "
                      f"burst_lanes={burst_lanes} timers={timers} "
                      f"dirty={dirty}",
            "ms": time_median(torch, scratch.pop, args, 7),
            "plain_ms": time_median(torch, K.pop_plain, args, 3)}


def factored_pop(torch, K, scratch, name, state0, world, p, win_end, dev):
    """A burst pop (K4 or K6) on the same phase's inputs with its
    tables factored (`star_world`): its `_hier` instantiation against
    the plain pop."""
    c = pop_case(torch, K, scratch, f"{name} on factored tables", state0,
                 star_world(torch, world, dev), p, win_end, dev)
    check(scratch.launches[name + K.HIER] > 0,
          f"{name}: the factored instantiation never launched")
    return {"err": c["err"], "ms": c["ms"], "plain_ms": c["plain_ms"]}


def tgen_inputs(torch, K, rng, H, E, dev):
    """State, world and params of one tgen phase at tgen_10000's layout,
    with heaps built to exercise every branch of the pop."""
    from shadow_tpu_torch.core.tgen_args import TAG_DATA, TAG_REQ
    from shadow_tpu_torch.device.apps import TgenDevice
    from shadow_tpu_torch.device.engine import state_from_numpy, \
        state_to_numpy
    from shadow_tpu_torch.device.prng import seed_key

    ms = 10**6
    win_end = 10**9
    roles = (rng.random(H) < 0.7).astype(np.int32)     # 1 = client
    count = rng.integers(0, 41, H)
    count[rng.random(H) < 0.05] = 0
    app = TgenDevice(
        roles=roles, server_gid=rng.integers(0, H, H).astype(np.int32),
        size=512 * 1024, count=count,
        pause_ns=rng.choice([100 * ms, 500 * ms], H),
        retry_ns=rng.choice([0, 1 * ms, 120 * ms], H))
    npkts = app.npkts
    st = app.init_state(H)
    st[:, 2] = 32 * rng.integers(0, (npkts + 31) // 32, H)
    st[:, 3] = rng.integers(0, 32, H)
    st[:, 4] = rng.integers(0, 41, H)
    st[:, 5] = rng.integers(0, 1000, H)
    st[:, 6] = rng.integers(0, 2**32, H, dtype=np.uint64).astype(
        np.uint32).view(np.int32)
    gen = st[:, 5].astype(np.int64)[:, None]
    server = (roles == 0)[:, None]
    shape = (H, E)
    n_live = rng.integers(0, E + 1, H)
    live = np.arange(E)[None, :] < n_live[:, None]
    ht = np.sort(rng.integers(win_end // 2, 3 * win_end // 2, shape), 1)
    kind = np.where(server, np.where(rng.random(shape) < 0.85, 2,
                                     rng.choice([0, 1, 3], shape)),
                    rng.choice([0, 1, 2, 2, 2, 2, 3], shape))
    # runs cut by slot E: 5% of servers hold only in-window packets,
    # their head three slots before E
    full = (roles == 0) & (rng.random(H) < 0.05)
    ht[full] = np.sort(rng.integers(0, win_end, (int(full.sum()), E)), 1)
    kind[full] = 2
    live[full] = True
    head = np.minimum(rng.integers(0, 4, H), n_live)
    head[full] = E - 3
    d0 = np.where(server, np.where(rng.random(shape) < 0.9, TAG_REQ,
                                   TAG_DATA),
                  np.where(rng.random(shape) < 0.9, TAG_DATA, TAG_REQ))
    timer_d0 = np.choose(rng.integers(0, 4, shape),
                         [np.full(shape, -1), np.broadcast_to(gen, shape),
                          np.broadcast_to(gen - 1, shape),
                          rng.integers(-5, 2000, shape)])
    d0 = np.where(kind == 1, timer_d0, d0)
    shifts = np.array([-40, -32, -1, 0, 1, 31, 32, 40])
    d1_data = st[:, 2].astype(np.int64)[:, None] + np.where(
        rng.random(shape) < 0.7, rng.choice(shifts, shape),
        rng.integers(-2**31, 2**31, shape))
    d1_req = rng.choice(np.array([0, 32, 320, npkts - 8, npkts - 1, npkts,
                                  npkts + 5, -3, 2**31 - 1, -2**31]), shape)
    d1_req = np.where(rng.random(shape) < 0.5, 32 * rng.integers(0, 12,
                                                                 shape),
                      d1_req)
    d1 = np.where(server, d1_req, d1_data)
    d2 = np.choose(rng.integers(0, 3, shape),
                   [np.zeros(shape, np.int64), np.full(shape, 2**32 - 1),
                    rng.integers(0, 2**32, shape)])
    arrays = state_to_numpy(random_state(rng, H, E, dev))
    arrays.update({
        "ht": np.where(live, ht, K.INF).astype(np.int64),
        "hk": np.where(live, (rng.integers(0, H, shape) << 32)
                       | rng.integers(0, 2**32, shape), K.IMAX),
        "hm": np.where(live, (kind << 32) | rng.integers(0, 2**16, shape),
                       0),
        "hv": np.where(live, (d0 << 32) | (d1 & K.U32), 0),
        "hw": np.where(live, d2, 0),
        "head": head.astype(np.int32), "app": st})
    state = state_from_numpy(arrays, dev)
    V = 6
    lat = rng.integers(5, 140, (V, V)) * ms
    lat = np.minimum(lat, lat.T)
    np.fill_diagonal(lat, 5 * ms)
    world = {
        "host_vertex": torch.from_numpy(
            rng.integers(0, V, H).astype(np.int32)).to(dev),
        "lat": torch.from_numpy(lat.astype(np.int32)).to(dev),
        "rel": torch.from_numpy(rng.uniform(0.9, 0.999, (V, V)).astype(
            np.float32)).to(dev),
        "epoch_times": torch.zeros(1, dtype=torch.int64, device=dev),
        **{k: torch.from_numpy(v.copy()).to(dev)
           for k, v in app.world_columns().items()}}
    p = K.PhaseParams(E=E, K=8, T=1, P=8, B=4, IN=E, C=32,
                      boot_end=win_end // 2, seed=seed_key(11), app=app)
    return state, world, p, win_end


def tgen_kernels(torch, K, scratch, rng, H, dev):
    """K4 at 100,000 hosts, then K2 and K3 at tgen_10000's layout."""
    E = 48
    state0, world, p, win_end = tgen_inputs(torch, K, rng, H, E, dev)
    c = pop_case(torch, K, scratch, "pop_tgen", state0, world, p, win_end,
                 dev)
    OB, sk, obk = p.OB, c["state"], c["ob"]
    out = {"pop_tgen": tgen_pop_row(c, p, H)}
    out["pop_tgen"]["on_factored_tables"] = factored_pop(
        torch, K, scratch, "pop_tgen", state0, world, p, win_end, dev)
    out["pop_tgen_aud"] = aud_pop_case(torch, K, scratch, rng, "pop_tgen",
                                       state0, world, p, win_end, dev,
                                       out["pop_tgen"])
    # K2 on K4's outbox, then K3, at tgen_10000's layout
    out["judge_outbox"] = judge_case(torch, K, scratch, sk, obk, world,
                                     win_end, p, H, OB)
    out["merge_heaps"] = merge_case(torch, K, scratch, rng, state0, p, H,
                                    OB, dev)
    return out


def tor_inputs(torch, K, rng, dev):
    """State, world and params of one Tor phase at tor_large's layout
    (relays are hosts 0..5,599, clients the rest), with heaps built
    from the port's own routes so that every relay branch fires."""
    from shadow_tpu_torch.core.tor_args import (
        CHUNK_CELLS,
        SEQ_BITS,
        TAG_TOR_DATA,
        TAG_TOR_REQ,
    )
    from shadow_tpu_torch.device.apps import TorDevice
    from shadow_tpu_torch.device.engine import state_from_numpy, \
        state_to_numpy
    from shadow_tpu_torch.device.prng import seed_key

    H, R, E, cells = 56_000, 5_600, 96, 256
    ms = 10**6
    win_end = 10**9
    roles = (np.arange(H) >= R).astype(np.int32)
    client = roles == 1
    relay = ~client
    app = TorDevice(
        roles=roles, relay_gids=np.arange(R), seed=1, cells=cells,
        count=np.where(rng.random(H) < 0.05, 0, 3),
        pause_ns=rng.choice([1 * ms, 4000 * ms], H),
        retry_ns=rng.choice([0, 1 * ms, 8000 * ms], H))
    world = {k: torch.from_numpy(v.copy()).to(dev)
             for k, v in app.world_columns().items()}
    # every client's circuit: (relay, circuit) for each of its 3 hops,
    # grouped by relay, so that a relay's packets name circuits it sits
    # on (as guard, middle or exit)
    circs = np.flatnonzero(client)
    hops = torch.stack(app.route(torch.from_numpy(circs.astype(
        np.int32)).to(dev), world), 1).cpu().numpy()         # [N,3]
    on_relay = hops.reshape(-1)
    on_circ = np.repeat(circs, 3)
    order = np.argsort(on_relay, kind="stable")
    first = np.searchsorted(on_relay[order], np.arange(R))
    n_on = np.bincount(on_relay, minlength=R)
    shape = (H, E)
    pick = first[:R, None] + (rng.random((R, E)) * n_on[:, None]).astype(
        np.int64)
    circ = rng.integers(R, H, shape)
    circ[:R] = np.where((rng.random((R, E)) < 0.85) & (n_on[:, None] > 0),
                        on_circ[order[np.minimum(pick, 3 * len(circs) - 1)]],
                        circ[:R])
    circ[client] = np.flatnonzero(client)[:, None]
    st = app.init_state(H)
    cs = CHUNK_CELLS * rng.integers(0, cells // CHUNK_CELLS, H)
    gen = rng.integers(0, 1000, H)
    st[client, 1] = cs[client]
    st[client, 2] = rng.integers(0, CHUNK_CELLS, int(client.sum()))
    st[client, 3] = rng.integers(0, 3, int(client.sum()))
    st[client, 4] = gen[client]
    st[client, 5] = rng.integers(0, 2**16, int(client.sum()))
    n_live = rng.integers(0, E + 1, H)
    live = np.arange(E)[None, :] < n_live[:, None]
    ht = np.sort(rng.integers(win_end // 2, 3 * win_end // 2, shape), 1)
    kind = np.where(relay[:, None],
                    np.where(rng.random(shape) < 0.85, 2,
                             rng.choice([0, 1, 3], shape)),
                    rng.choice([0, 1, 1, 2, 2, 2, 3], shape))
    # runs cut by slot E: 5% of relays hold only in-window packets, their
    # head three slots before E
    full = relay & (rng.random(H) < 0.05)
    ht[full] = np.sort(rng.integers(0, win_end, (int(full.sum()), E)), 1)
    kind[full] = 2
    live[full] = True
    head = np.minimum(rng.integers(0, 4, H), n_live)
    head[full] = E - 3
    d0 = np.where(rng.random(shape) < 0.5, TAG_TOR_REQ, TAG_TOR_DATA)
    d0 = np.where(client[:, None] & (rng.random(shape) < 0.9),
                  TAG_TOR_DATA, d0)
    g2 = gen[:, None]
    timer_d0 = np.choose(rng.integers(0, 4, shape),
                         [np.full(shape, -1), np.broadcast_to(g2, shape),
                          np.broadcast_to(g2 - 1, shape),
                          rng.integers(-5, 2000, shape)])
    d0 = np.where(kind == 1, timer_d0, d0)
    # chunk starts: every chunk, the tail (cells - start < 16), the end
    # and past it; clients' trains shifted around their window
    relay_start = rng.choice(np.array(
        [0, 16, 128, 240, 241, 248, 255, cells, cells + 3, 4095]), shape)
    shifts = np.array([-40, -32, -16, -1, 0, 1, 15, 16, 31, 32, 40])
    client_start = np.clip(cs[:, None] + rng.choice(shifts, shape), 0,
                           4095)
    start = np.where(client[:, None], client_start, relay_start)
    d1 = (circ.astype(np.int64) << SEQ_BITS) | start
    d2 = np.choose(rng.integers(0, 5, shape),
                   [np.zeros(shape, np.int64), np.full(shape, 0xFFFF),
                    np.full(shape, 2**32 - 1),
                    rng.integers(1, 2**16, shape),
                    rng.integers(0, 2**32, shape)])
    arrays = state_to_numpy(random_state(rng, H, E, dev))
    arrays.update({
        "ht": np.where(live, ht, K.INF).astype(np.int64),
        "hk": np.where(live, (rng.integers(0, H, shape) << 32)
                       | rng.integers(0, 2**32, shape), K.IMAX),
        "hm": np.where(live, (kind << 32) | rng.integers(0, 2**16, shape),
                       0),
        "hv": np.where(live, (d0 << 32) | (d1 & K.U32), 0),
        "hw": np.where(live, d2, 0),
        "head": head.astype(np.int32), "app": st})
    state = state_from_numpy(arrays, dev)
    V = 6
    lat = rng.integers(12, 95, (V, V)) * ms
    lat = np.minimum(lat, lat.T)
    np.fill_diagonal(lat, 15 * ms)
    world.update({
        "host_vertex": torch.from_numpy(
            rng.integers(0, V, H).astype(np.int32)).to(dev),
        "lat": torch.from_numpy(lat.astype(np.int32)).to(dev),
        "rel": torch.from_numpy(rng.uniform(0.9, 0.999, (V, V)).astype(
            np.float32)).to(dev),
        "epoch_times": torch.zeros(1, dtype=torch.int64, device=dev)})
    p = K.PhaseParams(E=E, K=8, T=1, P=8, B=4, IN=64, C=16,
                      boot_end=win_end // 2, seed=seed_key(1), app=app)
    return state, world, p, win_end


def tor_branches(torch, K, app, world, ob, dev):
    """Send rows of a Tor outbox by relay branch (the sender's place on
    the row's circuit), with the rows whose live mask is partial."""
    from shadow_tpu_torch.core.tor_args import (
        CHUNK_CELLS,
        SEQ_BITS,
        TAG_TOR_DATA,
        TAG_TOR_REQ,
    )

    H, OB = ob["t"].shape
    send = (ob["t"] < K.INF) & ((ob["m"] & 0xFF) == 2)
    sender = torch.arange(H, device=dev)[:, None].expand(H, OB)[send]
    d0 = K.lo32(ob["s"])[send]
    d1 = K.lo32(ob["v"])[send]
    mask = (ob["v"] >> 32)[send] & K.U32
    G, M, X = app.route(d1 >> SEQ_BITS, world)
    relay = world["client_count"].new_zeros(H, dtype=torch.bool)
    relay[world["relay_gids"].long()] = True
    rs = relay[sender]
    req, data = rs & (d0 == TAG_TOR_REQ), rs & (d0 == TAG_TOR_DATA)
    full = (1 << CHUNK_CELLS) - 1
    return {
        "fwd_req_g": int((req & (sender == G)).sum()),
        "fwd_req_m": int((req & (sender == M)).sum()),
        "serve": int((data & (sender == X)).sum()),
        "fwd_data_m": int((data & (sender == M)).sum()),
        "fwd_data_g": int((data & (sender == G)).sum()),
        "tail_chunks": int((data & (sender == X) & (mask < full)).sum()),
        "holed_trains": int((data & (sender != X)
                             & ((mask & full) != full)).sum()),
        "client_reqs": int((~rs & (d0 == TAG_TOR_REQ)).sum()),
    }


def tor_kernels(torch, K, scratch, rng, dev):
    """K6 at tor_large's full width, then K2 and K3 at its layout."""
    from shadow_tpu_torch.core.tor_args import TAG_TOR_DATA, TAG_TOR_REQ

    state0, world, p, win_end = tor_inputs(torch, K, rng, dev)
    H, E, OB = state0["head"].shape[0], p.E, p.OB
    c = pop_case(torch, K, scratch, "pop_tor", state0, world, p, win_end,
                 dev)
    sk, obk, err = c["state"], c["ob"], c["err"]
    popped, rows = c["popped"], c["rows"]
    branches = tor_branches(torch, K, p.app, world, obk, dev)
    for name, n in branches.items():
        check(n > 0, f"pop_tor: no {name} row in the outbox")
    # the route draws this run's data needs: four threefry blocks for
    # each popped relay REQ or live DATA train (the circuit fold and
    # three hops), two for each client REQ (the fold and the guard)
    slot = torch.arange(E, device=dev)[None, :]
    was_popped = (slot >= state0["head"][:, None]) & \
        (slot < sk["head"][:, None])
    relay = (state0["app"][:, 0] == 0)[:, None]
    pkt = was_popped & relay & ((state0["hm"] >> 32) == 2)
    d0 = state0["hv"] >> 32
    routed = int((pkt & ((d0 == TAG_TOR_REQ) | (
        (d0 == TAG_TOR_DATA) & (state0["hw"] != 0)))).sum())
    blocks = 4 * routed + 2 * branches["client_reqs"]

    R = int(world["relay_gids"].shape[0])
    out = {"pop_tor": finish({
        "err": err, "ms": c["ms"], "plain_ms": c["plain_ms"],
        # t of every outbox column, the other four fields of send and
        # timer rows; the popped heap rows (t, key, meta, d0|d1, d2);
        # the head time that stopped each host; per-host counters read
        # and written (head, event/packet seq, n_exec, n_deliv, chk, six
        # app words); client args, vertex and pop count; the relay ids
        "bytes": (H * OB * 8 + rows * 4 * 8 + popped * 5 * 8 + H * 8
                  + H * (5 * 4 + 8 + 6 * 4) * 2 + H * (4 + 8 + 8)
                  + H * 4 * 2 + R * 4),
        "ops": blocks * THREEFRY_OPS,
        "shape": f"H={H} R={R} E={E} P={p.P} OB={OB} C={p.C} "
                 f"{c['counts']} route_blocks={blocks} "
                 + " ".join(f"{k}={v}" for k, v in branches.items())})}
    out["pop_tor"]["on_factored_tables"] = factored_pop(
        torch, K, scratch, "pop_tor", state0, world, p, win_end, dev)
    out["pop_tor_aud"] = aud_pop_case(torch, K, scratch, rng, "pop_tor",
                                      state0, world, p, win_end, dev,
                                      out["pop_tor"])
    # K2 on K6's outbox (holed masks), then K3 at E=96, IN=64
    out["judge_outbox"] = judge_case(torch, K, scratch, sk, obk, world,
                                     win_end, p, H, OB)
    out["merge_heaps"] = merge_case(torch, K, scratch, rng, state0, p, H,
                                    OB, dev)
    return out


def add_nic(torch, K, rng, state, world, win_end, dev):
    """The model NIC's inputs on one phase's state and world: random
    NIC leaves around the window (queues idle and standing, CoDel
    above and below its target, in and out of its dropping state, its
    count past the law table's end), bandwidths from 100 kbit/s to
    1 Gbit/s, the law table; and half of the heaps' packet rows turned
    into READY rows (the second stage), the rest left to the RX
    stage."""
    from shadow_tpu_torch.core.event import KIND_PACKET, KIND_PACKET_READY
    from shadow_tpu_torch.host.model_nic import LAW

    H = state["head"].shape[0]
    near = rng.integers(win_end // 2, 3 * win_end // 2, (5, H))
    nic = {
        "tx_free": np.where(rng.random(H) < 0.5, 0, near[0]),
        "rx_free": np.where(rng.random(H) < 0.3, 0, near[1]),
        "cd_fa": np.where(rng.random(H) < 0.4, 0, near[2]),
        "cd_next": near[3],
        "cd_cnt": rng.choice(np.array([0, 1, 2, 5, 1023, 1024, 5000]), H),
        "cd_last": rng.choice(np.array([0, 1, 3, 1000]), H),
        "cd_drop": rng.integers(0, 2, H)}
    state = dict(state)
    for k, v in nic.items():
        state[k] = torch.from_numpy(v.astype(np.int64)).to(dev)
    kind = state["hm"] >> 32
    ready = (kind == KIND_PACKET) & torch.from_numpy(
        rng.random(tuple(kind.shape)) < 0.5).to(dev)
    state["hm"] = torch.where(
        ready, (state["hm"] & K.U32) | (KIND_PACKET_READY << 32),
        state["hm"])
    bw = np.array([10**5, 10**6, 10**7, 10**8, 10**9], np.int64)
    world = {**world, "law": torch.from_numpy(LAW).to(dev),
             "bw_up": torch.from_numpy(rng.choice(bw, H)).to(dev),
             "bw_down": torch.from_numpy(rng.choice(bw, H)).to(dev)}
    return state, world


def nic_pop_case(torch, K, scratch, name, state0, world, p, win_end, dev):
    """A pop under the model NIC (K1, K4 or K6 `_nic`) against the plain
    pop on one phase's inputs: exact on every state leaf (the NIC's
    too), outbox field and pop count; READY rows, CoDel drops, dropped
    sends and a host stopped dirty must all occur. Returns the error,
    the counts, both times and the bytes the function must move."""
    from shadow_tpu_torch.device.engine import OPTIONAL_DTYPES, STATE_DTYPES

    H, E, OB, M = state0["head"].shape[0], p.E, p.OB, p.M_out
    keys = list(STATE_DTYPES) + [k for k in OPTIONAL_DTYPES if k in state0]
    win = window_block(K, win_end, dev)

    def args():
        return (clone(state0), {f: torch.empty(
            (H, OB), dtype=torch.int64, device=dev) for f in K.OB_FIELDS},
            torch.empty(H, dtype=torch.int32, device=dev), world, win, p)

    ka, pa = args(), args()
    scratch.pop(*ka)
    K.pop_plain(*pa)
    torch.cuda.synchronize()
    (sk, obk, pk), (sp, obp, pp) = ka[:3], pa[:3]
    err = max(max_abs_err(sk, sp, keys),
              max_abs_err(obk, obp, list(K.OB_FIELDS)),
              max_abs_err({"pops": pk}, {"pops": pp}, ["pops"]))
    check(err == 0.0, f"{name} differs from its plain version (max abs "
          f"err {err})")
    check(scratch.launches[name] > 0, f"{name}: never launched")
    slot = torch.arange(E, device=dev)[None, :]
    popped_slot = (slot >= state0["head"][:, None]) & \
        (slot < sk["head"][:, None])
    kind = state0["hm"] >> 32
    rx_pops = int((popped_slot & (kind == 2)).sum())
    popped = int(popped_slot.sum())
    col = torch.arange(OB, device=dev)[None, :] % M
    live = obk["t"] < K.INF
    ready_rows = int((live & (col == p.K + p.T)).sum())
    send = live & (col < p.K)
    dead = int((send & (obk["t"] == K.DROP_T)).sum())
    rows = int(live.sum())
    sent = int(((sk["n_sent"].long() - state0["n_sent"].long())
                & 0xFFFFFFFF).sum())
    dropped = int(((sk["n_drop"].long() - state0["n_drop"].long())
                   & 0xFFFFFFFF).sum())
    dirty = int(((pk < p.B) & (sk["head"] < E) & (
        sk["ht"].gather(1, sk["head"].clamp(max=E - 1).long()[:, None])[
            :, 0] < win_end)).sum())
    codel = rx_pops - ready_rows
    check(ready_rows > 0 and codel > 0, f"{name}: no READY row or no "
          "CoDel drop")
    check(dropped > codel and dirty > 0, f"{name}: no send dropped or no "
          "host stopped dirty")
    if p.CP:
        check(dead > 0, f"{name}: no dead send kept as DROP_T")
    packets = int(torch.where(send, (obk["m"] & K.U32) >> 8, 0).sum())
    return {"err": err, "popped": popped, "rows": rows,
            "counts": f"iterations={int(pk.sum())} events={popped} "
                      f"rx_pops={rx_pops} ready_rows={ready_rows} "
                      f"codel_drops={codel} sent={sent} "
                      f"dropped={dropped} dead_rows={dead} "
                      f"dirty={dirty}",
            "packets": packets,
            "ms": time_median(torch, scratch.pop, args, 7),
            "plain_ms": time_median(torch, K.pop_plain, args, 3)}


def nic_row(c, H, p, what=""):
    """A `_nic` pop's row from `nic_pop_case`'s result at H hosts."""
    OB, W = p.OB, p.app.n_state_words
    return finish({
        "err": c["err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
        # t of every outbox column, the other four fields of the
        # written rows; the popped heap rows (t, key, meta, d0|d1,
        # d2); the head time that stopped each host; per-host
        # counters read and written (head, event/packet/app seq,
        # n_exec, n_deliv, n_sent, n_drop, chk, the app words, the
        # seven NIC leaves); bandwidths, vertex and pop count; the
        # law table
        "bytes": (H * OB * 8 + c["rows"] * 4 * 8 + c["popped"] * 5 * 8
                  + H * 8 + H * (7 * 4 + 8 + W * 4 + 7 * 8) * 2
                  + H * (2 * 8 + 4 * 2) + 1024 * 8),
        # two threefry blocks for the drop key, two a rolled packet
        "ops": (2 * H + 2 * c["packets"]) * THREEFRY_OPS,
        "shape": f"{what}H={H} E={p.E} K={p.K} T={p.T} B={p.B} OB={OB} "
                 f"C={p.C} cp={int(p.CP)} {c['counts']}"})


def nic_kernels(torch, K, scratch, rng, dev):
    """K1, K4 and K6 under the model NIC (`_nic`): K1 at the PHOLD
    full-width shapes (100,000 hosts, E=64, msgload 3, self-sends, with
    the path counters' DROP_T rows), K4 at tgen_10000's layout at
    100,000 hosts (B = 36 // 3) and K6 at tor_large's (B = 40 // 3),
    each on its lossy dense world."""
    import dataclasses

    from shadow_tpu_torch.device.apps import PholdDevice
    from shadow_tpu_torch.device.prng import seed_key

    out = {}
    H, E = 100_000, 64
    win_end = 10**9
    world = {
        "host_vertex": torch.from_numpy(
            rng.integers(0, 2, H).astype(np.int32)).to(dev),
        "lat": torch.tensor([[3_000_000, 5_000_000],
                             [5_000_000, 3_000_000]],
                            dtype=torch.int32, device=dev),
        "rel": torch.tensor([[0.98, 0.9], [0.9, 0.98]],
                            dtype=torch.float32, device=dev),
        "epoch_times": torch.zeros(1, dtype=torch.int64, device=dev)}
    state0, world = add_nic(torch, K, rng, random_state(rng, H, E, dev),
                            world, win_end, dev)
    app = PholdDevice(n_hosts_total=H, msgload=3, size=512, selfloop=1)
    p = K.PhaseParams(E=E, K=3, T=0, P=1, B=32 // 4, IN=E, C=1,
                      boot_end=win_end // 2, seed=seed_key(7), app=app,
                      MB=True, CP=True)
    cases = {"pop_phase_nic": (state0, world, p, win_end)}
    s, w, p, we = tgen_inputs(torch, K, rng, H, 48, dev)
    s, w = add_nic(torch, K, rng, s, w, we, dev)
    cases["pop_tgen_nic"] = (s, w, dataclasses.replace(
        p, K=1, P=1, B=36 // 3, MB=True), we)
    s, w, p, we = tor_inputs(torch, K, rng, dev)
    s, w = add_nic(torch, K, rng, s, w, we, dev)
    cases["pop_tor_nic"] = (s, w, dataclasses.replace(
        p, K=1, P=1, B=40 // 3, MB=True, CP=True), we)
    for name, (s, w, p, we) in cases.items():
        c = nic_pop_case(torch, K, scratch, name, s, w, p, we, dev)
        out[name] = nic_row(c, s["head"].shape[0], p)
    s, w, p, we = cases["pop_tgen_nic"]
    out["pop_tgen_nic_aud"] = aud_pop_case(
        torch, K, scratch, rng, "pop_tgen_nic", s, w, p, we, dev,
        out["pop_tgen_nic"])
    return out


def stack_epochs(torch, world, epoch_times, dev):
    """`world` with its tables stacked over len(epoch_times) epochs,
    each epoch's latencies scaled by 1, 2 or 3 and its reliabilities
    lowered by 1% an epoch (the self paths too, so that an in-window
    self-send's test changes with the epoch); a factored world keeps
    its one shared cl."""
    T = len(epoch_times)
    scale = torch.tensor([1 + e % 3 for e in range(T)], device=dev)
    keep = torch.tensor([1.0 - 0.01 * e for e in range(T)],
                        dtype=torch.float32, device=dev)

    def lat(a):
        return (a[None] * scale.view(-1, *[1] * a.dim())).to(torch.int32)

    def rel(a):
        return (a[None] * keep.view(-1, *[1] * a.dim())).to(torch.float32)

    if isinstance(world["lat"], tuple):
        cc, cl, acc, slf = world["lat"]
        ccr, _, accr, slfr = world["rel"]
        new_lat = (lat(cc), cl, lat(acc), lat(slf))
        new_rel = (rel(ccr), cl, rel(accr), rel(slfr))
    else:
        new_lat, new_rel = lat(world["lat"]), rel(world["rel"])
    return {**world, "lat": new_lat, "rel": new_rel,
            "epoch_times": torch.tensor(epoch_times, dtype=torch.int64,
                                        device=dev)}


# the epoch starts of the kernels phase's fault tables: six epochs, five
# of them inside the phase's pop times (the heaps hold times from
# win_end / 2 to 3 win_end / 2, win_end = 1 s)
EPOCH_TIMES = [0, 600_000_000, 700_000_000, 800_000_000, 900_000_000,
               950_000_000]


def tgen_pop_row(c, p, H):
    """A K4 row from a `pop_case` at tgen_10000's layout."""
    OB = p.OB
    return finish({
        "err": c["err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
        # t of every outbox column, the other four fields of send and
        # timer rows; the popped heap rows (t, key, meta, d0|d1, d2);
        # the head time that stopped each host; per-host counters read
        # and written (head, event/packet seq, n_exec, n_deliv, chk,
        # seven app words); client args, vertex and pop count
        "bytes": (H * OB * 8 + c["rows"] * 4 * 8 + c["popped"] * 5 * 8
                  + H * 8 + H * (5 * 4 + 8 + 7 * 4) * 2 + H * (4 + 8 + 8)
                  + H * 4 * 2),
        "ops": 0,
        "shape": f"H={H} E={p.E} P={p.P} OB={OB} {c['counts']}"})


def epoch_kernels(torch, K, scratch, rng, dev):
    """The epoch axis (`_ep`, T = 6, EPOCH_TIMES) at tgen_10000's layout
    and 100,000 hosts: K4 on its dense world stacked over the epochs,
    K2 on K4's outbox on the same tables, and K4 on a factored 6-vertex
    star stacked the same way (`_ep_hier`)."""
    H, E = 100_000, 48
    state0, world, p, win_end = tgen_inputs(torch, K, rng, H, E, dev)
    dense = stack_epochs(torch, world, EPOCH_TIMES, dev)
    c = pop_case(torch, K, scratch, "pop_tgen on epoch tables", state0,
                 dense, p, win_end, dev)
    check(scratch.launches["pop_tgen" + K.EP] > 0,
          "pop_tgen: the epoch instantiation never launched")
    out = {"pop_tgen_ep": tgen_pop_row(c, p, H)}
    out["pop_tgen_ep"]["bytes"] += len(EPOCH_TIMES) * 8
    out["judge_outbox_ep"] = judge_case(torch, K, scratch, c["state"],
                                        c["ob"], dense, win_end, p, H, p.OB)
    out["judge_outbox_ep"]["bytes"] += len(EPOCH_TIMES) * 8
    check(scratch.launches["judge_outbox" + K.EP] > 0,
          "judge_outbox: the epoch instantiation never launched")
    fact = stack_epochs(torch, star_world(torch, world, dev), EPOCH_TIMES,
                        dev)
    c = pop_case(torch, K, scratch, "pop_tgen on factored epoch tables",
                 state0, fact, p, win_end, dev)
    check(scratch.launches["pop_tgen" + K.EP + K.HIER] > 0,
          "pop_tgen: the factored epoch instantiation never launched")
    out["pop_tgen_ep_hier"] = tgen_pop_row(c, p, H)
    out["pop_tgen_ep_hier"]["bytes"] += len(EPOCH_TIMES) * 8
    return out


def million_fault_world(dev):
    """phold_1m_hier_faults' tables (PHOLD_1M_YAML's network with
    PHOLD_1M_FAULTS: six factored epochs) under examples/
    tgen_1000000.yaml's 1,000,000 hosts, tiled as that file tiles them
    (`million_world`: some hosts share a vertex): (hosts, the engine
    world on the card)."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.core.build import build
    from shadow_tpu_torch.device.apps import PholdDevice
    from shadow_tpu_torch.device.engine import DeviceEngine, EngineConfig
    from shadow_tpu_torch.topology.hierarchy import world_tables

    _, placed, _ = million_world(dev)
    H = len(placed.host_vertex)
    sim = build(load_config_str(PHOLD_1M_YAML, [PHOLD_1M_FAULTS]))
    lat, rel, ept = world_tables(sim.topology, sim.fault_table)
    check(len(ept) == 6 and sim.lookahead == 10**6,
          f"phold_1m_hier_faults: {len(ept)} epochs, lookahead "
          f"{sim.lookahead} ns (want 6 and 1 ms)")
    return H, DeviceEngine(EngineConfig(n_hosts=H),
                           PholdDevice(n_hosts_total=H), placed.host_vertex,
                           lat, rel, device=dev, epoch_times=ept).world


def hier_fault_kernels(torch, K, scratch, rng, dev):
    """K1 and K2 on phold_1m_hier_faults' factored tables with their
    six epochs (`_ep_hier`), at full width (1,000,000 hosts tiled as
    examples/tgen_1000000.yaml tiles them), K2's send rows retargeted
    to every kind of pair."""
    H, world = million_fault_world(dev)
    out = phold_kernels(torch, K, scratch, rng, H, dev, world=world)
    for n in ("pop_phase", "judge_outbox"):
        check(scratch.launches[n + K.EP + K.HIER] > 0,
              f"{n}: the factored epoch instantiation never launched")
    return {"pop_phase_ep_hier": out["pop_phase"],
            "judge_outbox_ep_hier": out["judge_outbox"]}


def paths_designs(torch, K, kk, make, what):
    """K7 (kk) on `make()`'s inputs (state, outbox, world[, ctl, pop
    counts, outbox words]) bit-equal to its plain version in both
    designs (the design before reads every row whatever the pop
    counts); returns (ms, the design before's ms)."""
    times = {}
    for before in (False, True):
        kk.designs_before = before
        a, b = make(), make()
        kk.count_paths(*a)
        K.count_paths_plain(*b[:4])
        torch.cuda.synchronize()
        err = max_abs_err(a[0], b[0], ["path_cnt"])
        check(err == 0.0, f"count_paths ({what}, the design before "
              f"{before}) differs from its plain version (max abs err "
              f"{err})")
        check(kk.launches["count_paths"] > 0, "count_paths never launched")
        times[before] = time_median(torch, kk.count_paths, make, 7)
    kk.designs_before = False
    return times[False], times[True]


def paths_bytes(K, ob, world, pops, read_all: bool) -> tuple:
    """(bytes, packet rows, pairs touched, hosts whose rows are read, the
    bytes as counted before) of K7 on these inputs: the pop counts of
    every host (where it skips by them), t of the rows of the hosts read
    (those that popped, or every host), k and m of the packet rows with
    both ends' vertices, each histogram entry touched read and written:
    what any count of these inputs must move. The count before read t of
    every row."""
    H, OB = ob["t"].shape[-2:]
    V = K.n_vertices(world)
    hv = world["host_vertex"].long()
    Hv = hv.shape[0]        # a mesh rank's world holds H_pad hosts
    pkt = (ob["t"] < K.INF) & ((ob["m"] & 0xFF) == 2)
    rows = int(pkt.sum())
    cells = hv[(ob["k"] >> 32).clamp(0, Hv - 1)[pkt]] * V + \
        hv[(ob["m"] >> 32).clamp(0, Hv - 1)[pkt]]
    touched = int(cells.unique().numel())
    hosts = H if read_all or pops is None else int((pops != 0).sum())
    rest = rows * (2 * 8 + 2 * 4) + touched * 16
    nbytes = (0 if pops is None else H * 4) + hosts * OB * 8 + rest
    return nbytes, rows, touched, hosts, H * OB * 8 + rest


def paths_library_ms(torch, K, ob, world):
    """torch.bincount over the packet rows' pairs and weights of `ob`:
    the same histogram in one PyTorch call (the pairs and weights made
    outside the timed call)."""
    V = K.n_vertices(world)
    hv = world["host_vertex"].long()
    Hv = hv.shape[0]
    pkt = (ob["t"] < K.INF) & ((ob["m"] & 0xFF) == 2)
    pair = torch.where(pkt, hv[(ob["k"] >> 32).clamp(0, Hv - 1)] * V
                       + hv[(ob["m"] >> 32).clamp(0, Hv - 1)],
                       V * V).view(-1)
    weight = torch.where(pkt, ((ob["m"] & K.U32) << 32 >> 40), 0)
    return time_median(
        torch, lambda x, w: torch.bincount(x, w, V * V + 1),
        lambda: (pair, weight.view(-1).double()), 7)


def paths_outbox(torch, K, rng, H, OB, V, dev):
    """A judged outbox of H hosts x OB columns over V vertices for K7: a
    fifth of the rows live, among them timers, READY rows and DROP_T
    sends, trains of 1 to 32 packets; its world; and pop counts (0 at
    seven tenths of the hosts)."""
    from shadow_tpu_torch.core.event import KIND_PACKET_READY

    shape = (H, OB)
    live = rng.random(shape) < 0.2
    t = rng.integers(10**9, 2 * 10**9, shape)
    t = np.where(rng.random(shape) < 0.05, K.DROP_T, t)
    t = np.where(live, t, K.INF).astype(np.int64)
    kind = rng.choice(np.array([2, 2, 2, 1, KIND_PACKET_READY]), shape)
    cnt = rng.integers(1, 33, shape)
    k = (np.arange(H, dtype=np.int64)[:, None] << 32) | \
        rng.integers(0, 2**32, shape)
    m = (rng.integers(0, H, shape) << 32) | (cnt << 8) | kind
    ob = {f: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
          for f, a in (("t", t), ("k", k), ("m", m))}
    world = {"host_vertex": torch.from_numpy(
        rng.integers(0, V, H).astype(np.int32)).to(dev),
        "lat": torch.zeros((V, V), dtype=torch.int32, device=dev)}
    pops = torch.from_numpy(np.where(
        rng.random(H) < 0.3, rng.integers(1, 9, H), 0).astype(
            np.int32)).to(dev)
    return ob, world, pops


def paths_row(torch, K, kk, ob, world, pops, word, what):
    """K7 on (ob, world) with the pop counts and outbox word given (or
    neither): bit-equal to its plain version in both designs, timed
    beside the design before, the plain version and torch.bincount; given
    pop counts, also both readings at any size (by the pop counts, and a
    thread a row over every row), each bit-equal too."""
    V = K.n_vertices(world)
    dev = ob["t"].device

    def make():
        st = {"path_cnt": torch.zeros((1, V * V), dtype=torch.int64,
                                      device=dev)}
        if pops is None:
            return (st, ob, world)
        return (st, ob, world, None, pops, word.clone())

    ms, parent_ms = paths_designs(torch, K, kk, make, what)
    extra = {}
    if pops is not None:
        # both readings at any size, bit-equal too: by the pop counts
        # (the crossover at 0 rows) and a thread a row over every row (the
        # crossover past any outbox)
        for key, gate in (("by_pops_ms", 0), ("every_row_ms", 2**31 - 1)):
            kk.paths_gated_rows = gate
            a, b = make(), make()
            kk.count_paths(*a)
            K.count_paths_plain(*b[:3])
            torch.cuda.synchronize()
            err = max_abs_err(a[0], b[0], ["path_cnt"])
            check(err == 0.0, f"count_paths ({what}, {key[:-3]}) differs "
                  f"from its plain version (max abs err {err})")
            extra[key] = time_median(torch, kk.count_paths, make, 7)
        kk.paths_gated_rows = K.PATHS_GATED_ROWS
    read_all = pops is None or bool(word[0].any())
    nbytes, rows, touched, hosts, before = paths_bytes(K, ob, world, pops,
                                                       read_all)
    H, OB = ob["t"].shape[-2:]
    return finish({
        "err": 0.0, "ms": ms, "parent_ms": parent_ms, **extra,
        "plain_ms": time_median(torch, lambda *a: K.count_paths_plain(
            *a[:3]), make, 3),
        "library_ms": paths_library_ms(torch, K, ob, world),
        "bytes": nbytes, "ops": 0,
        "bound_ms_as_counted_before": 1e3 * before / HBM_BYTES_PER_S,
        "shape": f"{what}: H={H} OB={OB} V={V} hosts read {hosts}, "
                 f"packet_rows={rows} touched_pairs={touched}"})


def count_paths_case(torch, K, scratch, rng, dev):
    """K7 on a judged outbox of 100,000 hosts x 39 columns (tgen_10000's
    layout under the model NIC, x10, `paths_outbox`) over 256 vertices
    (V*V = 65536, the histogram's largest), every row read; then given
    pop counts with the word clear on the outbox as the rule leaves it
    (the popped hosts' rows read: 30% of the hosts, and 0.6%, a real
    phase's share) and with the word set (every row read); and all
    again over 6 vertices (tgen_10000's V: few pairs, which a block sums
    in shared memory on an outbox this large). Each beside
    its design before, its plain version and torch.bincount on the same
    pairs and weights."""
    H, OB = 100_000, 39
    out, sub = None, {}
    for V in (256, 6):
        ob, world, pops = paths_outbox(torch, K, rng, H, OB, V, dev)
        clear = K.outbox_word(dev)
        clear[0] = 0
        # a real phase's share of popped hosts (tgen_10000_nic: a median
        # of 50 of 10,000) beside the synthetic 30%
        sparse = torch.where(torch.from_numpy(rng.random(H) < 0.02).to(dev),
                             pops, 0)
        for case, o, p, w in (
                ("every row", ob, None, None),
                ("the popped hosts' rows, the word clear",
                 rule_outbox(torch, ob, pops), pops, clear),
                ("0.6% of the hosts popped, the word clear",
                 rule_outbox(torch, ob, sparse), sparse, clear),
                ("the word set", ob, pops, K.outbox_word(dev))):
            r = paths_row(torch, K, scratch, o, world, p, w,
                          f"synthetic, V={V}, {case}")
            check(int((o["t"] == K.DROP_T).sum()) > 0,
                  "count_paths: no DROP_T row")
            if out is None:
                out = r
            else:
                sub[f"V={V}, {case}"] = r
    out["synthetic"] = {"err": 0.0, "rows": sub}
    return out


def paths_real_rows(torch, K, dev):
    """K7 on one real phase of tgen_10000_nic (FULL_RUNS), the NIC PHOLD
    (NIC_PHOLD_YAML), the link-fault tgen (FAULT_YAML) and PHOLD at
    100,000 hosts with the path counters (FULL_RUNS' phold with
    `count_paths`: 3,000,000 rows, read by the pop counts): each run
    paused at half its stop time by the graph loop, then one phase
    popped (and judged, where the NIC does not judge in the pop) on the
    engine's own buffers; the rule checked (every row of a host that
    popped nothing has t = INF); K7 with the engine's pop counts and
    outbox word (clear) and with the word set, each bit-equal to its
    plain version beside the design before, both readings (by the pop
    counts and every row, whichever side of the crossover the outbox
    lies) and torch.bincount."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner

    _, example, ovr, _ = next(r for r in FULL_RUNS
                              if r[0] == "tgen_10000_nic")
    _, phold_example, phold_ovr, _ = next(r for r in FULL_RUNS
                                          if r[0] == "phold")
    out = {}
    for name, load in (
            ("tgen_10000_nic", lambda: full_config(example, ovr)),
            ("nic_phold", lambda: load_config_str(NIC_PHOLD_YAML, [])),
            ("faults_dense", lambda: load_config_str(FAULT_YAML, [])),
            ("phold_paths", lambda: full_config(
                phold_example,
                phold_ovr + ("experimental.count_paths=true",)))):
        engine, sim = runner.make_engine(load(), device=dev.type)
        state = engine.init_state(sim.start_times, sim.stop_times)
        stop = int(engine.config.stop_time)
        engine.run(state, stop=stop // 2, final_stop=stop)
        nt = engine.next_time(state)
        check(nt < K.INF, f"{name}: no event left half way")
        p, kk = engine.params, engine.kernels
        ctl = K.control_block(dev, run=1, win_end=nt + max(
            1, int(engine.config.lookahead)))
        ob, pops, _ = engine._buffers()
        word = engine._outside
        kk.pop(state, ob, pops, engine.world, ctl, p, word)
        if not p.MB:
            kk.judge_outbox(state, ob, engine.world, ctl, p, pops, word)
        torch.cuda.synchronize()
        check(not bool(word[0].any()), f"{name}: the pop left the outbox "
              "word set")
        check(not bool((ob["t"] < K.INF)[pops == 0].any()), f"{name}: a "
              "host that popped nothing holds a row below INF")
        H, OB = ob["t"].shape
        check((H * OB >= K.PATHS_GATED_ROWS) == (name == "phold_paths"),
              f"{name}: {H * OB} outbox rows, on the wrong side of K7's "
              "crossover")
        view = {f: ob[f] for f in ("t", "k", "m")}
        for case, w in (("the word clear", word),
                        ("the word set", K.outbox_word(dev))):
            what = f"{name}'s phase at {nt} ns, {case}"
            out.setdefault(f"{name}, {case}", {})["count_paths"] = \
                paths_row(torch, K, K.Kernels(), view, engine.world, pops,
                          w, what)
        del engine, state, ob
        torch.cuda.empty_cache()
    return out


def route_case(torch, K, scratch, rng, H, OB, IN, dev):
    ob = random_outbox(rng, H, OB, torch, dev)
    row, (_, _, cp) = route_check(torch, K, scratch, ob, "random", IN)
    check(int(cp.max()) > IN, "route: no destination past IN")
    return row


def route_check(torch, K, scratch, ob, what, IN=None):
    """K5 on an outbox against route_plain, every live perm entry,
    starts and counts; timed beside torch.sort + searchsorted of the
    plain version's sort keys. Returns (row, the plain route)."""
    H, OB = ob["t"].shape
    dev = ob["t"].device
    pk, sk_, ck = scratch.route(ob)
    pp, sp, cp = K.route_plain(ob)
    torch.cuda.synchronize()
    L = int(cp.sum())
    err = max_abs_err({"perm": pk[:L], "starts": sk_, "counts": ck},
                      {"perm": pp[:L], "starts": sp, "counts": cp},
                      ["perm", "starts", "counts"])
    check(err == 0.0, f"route ({what}, H={H}, OB={OB}) differs from its "
          f"plain version (max abs err {err})")
    span = H * OB
    okey = torch.arange(span, dtype=torch.int64, device=dev).view(H, OB)
    skey = torch.where(ob["t"] < K.DROP_T,
                       (ob["m"] >> 32) * span + okey, K.IMAX).view(-1)
    bounds = torch.arange(H + 1, dtype=torch.int64, device=dev) * span

    def library(x):
        torch.searchsorted(torch.sort(x)[0], bounds)

    return finish({
        "err": err,
        "ms": time_median(torch, scratch.route, lambda: (ob,), 7),
        "plain_ms": time_median(torch, K.route_plain, lambda: (ob,), 3),
        "library_ms": time_median(torch, library, lambda: (skey,), 7),
        # t of every row, m of live rows, perm of live rows written,
        # starts and counts written
        "bytes": span * 8 + L * 8 * 2 + H * 8 * 2,
        "ops": 0,
        "shape": f"{what}: H={H} OB={OB} rows={span} live={L} "
                 f"longest={int(cp.max()) if H else 0}"
                 + (f" past_IN={int((cp > IN).sum())}" if IN else "")}), \
        (pp, sp, cp)


def keyed_runs(torch, K, rng, S, H_pad, OB, cap, dev):
    """A two_phase rank's received rows as keyed routes see them: S
    peer blocks [S, 6, cap], each a run of live rows in key order (a
    peer's route packs them so) from that peer's senders (dst*SPAN +
    src*OB + column, SPAN = H_pad*OB; a tenth at 16 hot hosts), then
    INF padding."""
    wire = np.zeros((S, 6, cap), np.int64)
    per = H_pad // S
    span = H_pad * OB
    for b in range(S):
        n = int(cap * 0.6)
        flat = rng.choice(per * OB, n, replace=False) + b * per * OB
        dst = rng.integers(0, H_pad, n)
        hot = rng.random(n) < 0.1
        dst = np.where(hot, rng.integers(0, 16, n), dst)
        key = dst * span + flat
        o = np.argsort(key, kind="stable")
        key, dst = key[o], dst[o]
        t = np.full(cap, (1 << 62), np.int64)
        t[:n] = rng.integers(10**9, 3 * 10**9, n)
        wire[b, 0] = t
        wire[b, 1, :n] = rng.integers(0, 2**62, n)
        wire[b, 2, :n] = (dst << 32) | 2
        wire[b, 3, :n] = rng.integers(-2**62, 2**62, n)
        wire[b, 4, :n] = rng.integers(0, 2**62, n)
        wire[b, 5, :n] = key
    return K.Rows(torch.from_numpy(wire).to(dev))


# the adversarial cases' sizes: PHOLD's outbox (3,000,000 rows), the
# million destinations, and a two_phase rank's S = 4 peer blocks
ADV_HOSTS, ADV_OB, ADV_MILLION, ADV_PEERS, ADV_CAP = (100_000, 30,
                                                     1_000_000, 4, 375_000)


def flush_adversarial(torch, K, scratch, rng, dev):
    """K5 and K3 where the data is hardest, each bit-equal to its
    plain version: every live row of a 3,000,000-row outbox to one
    destination, an empty outbox, 1,000,000 destinations (20 bits of
    destination, three passes), and keyed rows in S = 4 peer runs over
    100,000 destinations; the merges checking every heap and trusting
    their order. (R = 4 replicas, one of them finished, are
    `replica_kernels`'.)"""
    from shadow_tpu_torch.device.apps import PholdDevice
    from shadow_tpu_torch.device.engine import EngineConfig, phase_params

    out = {}
    H, OB = ADV_HOSTS, ADV_OB
    p = phase_params(EngineConfig(n_hosts=H, event_capacity=64,
                                  outbox_capacity=OB),
                     PholdDevice(n_hosts_total=H))
    for case in ("one_destination", "empty"):
        ob = random_outbox(rng, H, OB, torch, dev)
        if case == "empty":
            ob["t"].fill_(K.INF)
        else:
            ob["m"] = (ob["m"] & 0xFFFFFFFF) | (7 << 32)
        row, route = route_check(torch, K, scratch, ob, case, p.IN)
        state0 = random_state(rng, H, p.E, dev)
        err, _ = merge_compare(torch, K, scratch, state0, ob, route, p)
        out[case] = {"route": row, "merge_heaps": merge_row(
            torch, K, scratch, lex_sorted(torch, K, state0), ob, route, p,
            err, f"{case}: H={H} E={p.E} IN={p.IN}")}
    H1 = ADV_MILLION
    ob = random_outbox(rng, H1, 3, torch, dev)
    p1 = phase_params(EngineConfig(n_hosts=H1, event_capacity=64,
                                   outbox_capacity=3),
                      PholdDevice(n_hosts_total=H1))
    row, route = route_check(torch, K, scratch, ob, f"{H1} "
                             "destinations", p1.IN)
    state0 = random_state(rng, H1, p1.E, dev)
    err, _ = merge_compare(torch, K, scratch, state0, ob, route, p1)
    out["million_destinations"] = {"route": row, "merge_heaps": merge_row(
        torch, K, scratch, lex_sorted(torch, K, state0), ob, route, p1, err,
        f"{H1} destinations: H={H1} E={p1.E} IN={p1.IN}")}
    del state0
    S, cap = ADV_PEERS, ADV_CAP
    rows = keyed_runs(torch, K, rng, S, H, OB, cap, dev)
    got = scratch.route_rows(rows, 0, H, True)
    want = K.route_rows_plain(rows, 0, H, True)
    torch.cuda.synchronize()
    L = int(want[2].sum())
    err = max(_eq(got[0][:L], want[0][:L]), _eq(got[1], want[1]),
              _eq(got[2], want[2]))
    check(err == 0.0, f"route_keyed (S={S} peer runs) differs from its "
          f"plain version (max abs err {err})")
    keys = rows.fields(("t", "m", "key"))
    live = keys["t"] < K.DROP_T
    # a live row's key orders it by destination first
    order_key = torch.where(live, keys["key"], K.IMAX)
    bounds = torch.arange(H + 1, dtype=torch.int64, device=dev) * (H * OB)

    def library(x):
        torch.searchsorted(torch.sort(x)[0], bounds)

    out["keyed_runs"] = {"route_keyed": finish({
        "err": err,
        "ms": time_median(torch, scratch.route_rows,
                          lambda: (rows, 0, H, True), 7),
        "plain_ms": time_median(torch, K.route_rows_plain,
                                lambda: (rows, 0, H, True), 3),
        "library_ms": time_median(torch, library, lambda: (order_key,), 7),
        # t, m and key of every row, perm of live rows written, starts
        # and counts written
        "bytes": rows.n * 8 * 3 + L * 8 + H * 16,
        "ops": 0,
        "shape": f"S={S} peer runs of {int(cap * 0.6)} live rows, "
                 f"rows={rows.n} live={L} to H_pad={H}"})}
    return out


# the full runs whose real phase the pop, K2, K5 and K3 run on: a state
# paused half way, its engine's buffers as its last phase left them
REAL_PHASES = ("phold", "tgen_10000", "tor_large", "phold_1m_hier")


def same_bytes(torch, a: dict, b: dict) -> float:
    """max_abs_err over every common key of two dicts of tensors."""
    return max_abs_err(a, b, [k for k in a if k in b])


def outbox_kernel_names(K, engine) -> tuple:
    """The launch names of an engine's pop and K2."""
    from shadow_tpu_torch.device.apps import TgenDevice, TorDevice

    p, world = engine.params, engine.world
    flags = (world["epoch_times"].shape[-1] > 1,
             isinstance(world["lat"], tuple))
    app = ("pop_tgen" if isinstance(p.app, TgenDevice) else "pop_tor"
           if isinstance(p.app, TorDevice) else "pop_phase")
    return (K.launch_name(app, p.MB, *flags, p.AUD),
            K.launch_name("judge_outbox", False, *flags))


def pop_judge_case(torch, K, engine, state, ob, pops, word, ctl, what):
    """The pop and K2 of one phase on (state, outbox, pop counts, outbox
    word): each against its plain version, bit for bit (every state
    leaf, outbox field, pop count and the word); returns (the pop's and
    K2's launch names, the kernels' state, outbox, pops and word after
    the pop, the Kernels that ran them)."""
    p, world = engine.params, engine.world
    kk = K.Kernels()
    got = [clone(state), clone(ob), pops.clone(), word.clone()]
    want = [clone(state), clone(ob), pops.clone(), word.clone()]
    kk.pop(got[0], got[1], got[2], world, ctl, p, got[3])
    K.pop_plain(want[0], want[1], want[2], world, ctl, p, want[3])
    torch.cuda.synchronize()
    err = max(same_bytes(torch, got[0], want[0]),
              same_bytes(torch, got[1], want[1]),
              same_bytes(torch, {"pops": got[2], "word": got[3]},
                         {"pops": want[2], "word": want[3]}))
    pop_name, judge_name = outbox_kernel_names(K, engine)
    check(err == 0.0, f"{pop_name} ({what}) differs from its plain "
          f"version (max abs err {err})")
    js, jo = clone(got[0]), clone(got[1])
    ps, po = clone(want[0]), clone(want[1])
    kk.judge_outbox(js, jo, world, ctl, p, got[2], got[3].clone())
    K.judge_outbox_plain(ps, po, world, ctl, p)
    torch.cuda.synchronize()
    jerr = max(same_bytes(torch, js, ps), same_bytes(torch, jo, po))
    check(not js["head"].is_cuda or (kk.launches[pop_name] > 0 and
                                     kk.launches[judge_name] > 0),
          f"{what}: {pop_name} or {judge_name} never launched")
    check(jerr == 0.0, f"{judge_name} ({what}) differs from its plain "
          f"version (max abs err {jerr})")
    return pop_name, judge_name, err, jerr, got, kk


def outbox_rows(torch, K, engine, state, ctl, what):
    """The pop and K2 on the engine's own buffers after its last phase
    (outbox, pop counts and outbox word as the graph loop left them),
    each against its plain version and timed; beside them the pop
    clearing every row (no word: what an unknown buffer costs) and K2
    judging every host, and K2 as a grid of a warp a host that exits
    where its host popped nothing, in place of its list.
    Shares: hosts that pop, rows the rule clears, rows it leaves. The
    bounds count what any pop that keeps the outbox between phases must
    move: each host's head time and pop count, the popped hosts' heap
    rows and counters, and the outbox words that change."""
    p, world = engine.params, engine.world
    ob, pops, _ = engine._buffers()
    word = engine._outside
    check(word is not None and not bool(word.any()),
          f"{what}: the outbox word is set after a run")
    s0, ob0, pops0, word0 = clone(state), clone(ob), pops.clone(), \
        word.clone()
    pop_name, judge_name, err, jerr, got, kk = pop_judge_case(
        torch, K, engine, s0, ob0, pops0, word0, ctl, what)
    sk, obk, pk, wk = got
    H, OB = ob0["t"].shape

    def pop_args(with_word=True):
        return (clone(s0), clone(ob0), pops0.clone(), world, ctl, p,
                word0.clone() if with_word else None)

    def judge_args(skip=True):
        return (clone(sk), clone(obk), world, ctl, p,
                *((pk, wk.clone()) if skip else ()))

    popped_hosts = int((pk != 0).sum())
    cleared = int((pops0 != 0).sum())
    changed = sum(int((ob0[f] != obk[f]).sum()) for f in K.OB_FIELDS)
    events = int(((sk["n_exec"].long() - s0["n_exec"].long())
                  & 0xFFFFFFFF).sum())
    draws = (int(((sk["app_seq"].long() - s0["app_seq"].long())
                  & 0xFFFFFFFF).sum()) if "app_seq" in s0 else 0)
    shares = {"popped": popped_hosts / H, "cleared": cleared / H,
              "left": 1 - cleared / H}
    shape = (f"{what}: H={H} OB={OB} hosts popped {popped_hosts}, rows "
             f"cleared {cleared}, left {H - cleared}, events {events}, "
             f"outbox words changed {changed}")
    pop_row = finish({
        "err": err, "shape": shape, "outbox_shares": shares,
        "ms": time_median(torch, kk.pop, pop_args, 7),
        "plain_ms": time_median(torch, K.pop_plain, pop_args, 3),
        "clear_all_ms": time_median(torch, kk.pop,
                                    lambda: pop_args(False), 7),
        # head and pop count read, the head time; the popped hosts'
        # counters read and written, their popped heap rows (t, key,
        # meta, d2), the pop counts and outbox words that change
        "bytes": (H * 16 + popped_hosts * (7 * 4 + 8) * 2 + events * 32
                  + int((pk != pops0).sum()) * 4 + changed * 8),
        "ops": 2 * draws * THREEFRY_OPS})
    is_send = (obk["t"] < K.INF) & ((obk["m"] & 0xFF) == 2)
    sends = int(is_send.sum())
    packets = int(torch.where(is_send, (obk["m"] & K.U32) >> 8, 0).sum())
    judge_row = {
        "err": jerr, "shape": f"{shape}; sends {sends} packets "
                              f"{packets}",
        "outbox_shares": shares,
        "ms": time_median(torch, kk.judge_outbox, judge_args, 7),
        "plain_ms": time_median(torch, K.judge_outbox_plain,
                                lambda: judge_args(False), 3),
        "every_host_ms": time_median(torch, kk.judge_outbox,
                                     lambda: judge_args(False), 7),
        # pop counts read; t of the popped hosts' rows; m and v of each
        # send row read, t/m/v written; packet_seq, n_sent and n_drop of
        # the popped hosts
        "bytes": (H * 4 + popped_hosts * OB * 8 + sends * 5 * 8
                  + popped_hosts * 12 * 2),
        "ops": 2 * packets * THREEFRY_OPS}
    kk.judge_listed = False
    judge_row["a_warp_a_host_ms"] = time_median(torch, kk.judge_outbox,
                                                judge_args, 7)
    return {pop_name: pop_row, judge_name: finish(judge_row)}


def outbox_adversarial(torch, K, engine, state, ctl, rng):
    """The pop and K2 where the outbox is hardest, on a real phase's
    state (the engine paused half way), each bit-equal to its plain
    version: every cell and pop count random under a set outbox word
    (every row cleared, the word cleared, K2 then skipping by the new
    counts); every host popped last phase (rows random) and none pops
    now (window end 0: every row cleared, K2 skips every host); and K2
    on rows copied in from outside with pop counts 0 under the word
    (a mesh rank's `flush_phases`), which must judge every host."""
    dev = state["head"].device
    ob, pops, _ = engine._buffers()
    H, OB = ob["t"].shape

    def garbage():
        return {f: torch.from_numpy(rng.integers(
            -2**63, 2**63 - 1, (H, OB), dtype=np.int64)).to(dev)
            for f in K.OB_FIELDS}

    rows = {}
    zero = K.control_block(dev, run=1, win_end=0)
    for case, (obx, popsx, set_word, c) in {
        "garbage under the outbox word": (
            garbage(), torch.from_numpy(rng.integers(
                -2**31, 2**31 - 1, H).astype(np.int32)).to(dev), 1, ctl),
        "every host popped last phase, none now": (
            garbage(), torch.ones(H, dtype=torch.int32, device=dev), 0,
            zero)}.items():
        word = K.outbox_word(dev)
        word[0] = set_word
        pop_name, judge_name, err, jerr, got, kk = pop_judge_case(
            torch, K, engine, state, obx, popsx, word, c, case)
        check(not bool(got[3].any()), f"{case}: the word stays set")
        if c is zero:
            check(bool((got[1]["t"] == K.INF).all()) and not bool(
                got[2].any()), f"{case}: a row or a pop count is left")

        def pop_args():
            return (clone(state), clone(obx), popsx.clone(), engine.world,
                    c, engine.params, word.clone())

        rows[case] = {pop_name: finish({
            "err": err, "shape": f"{case}: H={H} OB={OB}",
            "ms": time_median(torch, kk.pop, pop_args, 7),
            "plain_ms": time_median(torch, K.pop_plain, pop_args, 3),
            "bytes": H * OB * 5 * 8 + H * 16, "ops": 0})}
    # rows from outside: the real phase's popped outbox, pop counts 0
    word = K.outbox_word(dev)
    _, _, _, _, got, _ = pop_judge_case(torch, K, engine, state, ob,
                                        pops, word, ctl, "rows to copy")
    sk, obk = got[0], got[1]
    is_send = (obk["t"] < K.INF) & ((obk["m"] & 0xFF) == 2)
    check(bool(is_send.any()), "flush_phases case: no send row")
    zeros = torch.zeros(H, dtype=torch.int32, device=dev)
    kk = K.Kernels()
    ks, ko = clone(sk), clone(obk)
    kk.judge_outbox(ks, ko, engine.world, ctl, engine.params, zeros,
                    K.outbox_word(dev))
    ps, po = clone(sk), clone(obk)
    K.judge_outbox_plain(ps, po, engine.world, ctl, engine.params)
    torch.cuda.synchronize()
    jerr = max(same_bytes(torch, ks, ps), same_bytes(torch, ko, po))
    judge_name = outbox_kernel_names(K, engine)[1]
    check(jerr == 0.0, f"{judge_name} on rows from outside differs from "
          f"its plain version (max abs err {jerr})")
    rows["rows from outside, pop counts 0 (flush_phases)"] = {
        judge_name: finish({
            "err": jerr, "shape": f"H={H} OB={OB} hosts with send rows "
                                  f"{int(is_send.any(1).sum())}",
            "ms": time_median(torch, kk.judge_outbox, lambda: (
                clone(sk), clone(obk), engine.world, ctl, engine.params,
                zeros, K.outbox_word(dev)), 7),
            "plain_ms": time_median(torch, K.judge_outbox_plain, lambda: (
                clone(sk), clone(obk), engine.world, ctl, engine.params),
                3),
            "bytes": H * OB * 8 + int(is_send.sum()) * 5 * 8 + H * 16,
            "ops": 0})}
    return rows


def tally_rows(torch, K, engine, state, ob, pops, ctl, what):
    """phase_tally on one real phase's popped and judged outbox, the
    engine's outbox word as the pop left it (clear: only the popped
    hosts' rows read) and set (every row read), each in both designs and
    bit-equal to its plain version; the share of hosts whose rows are
    read."""
    p = engine.params
    word = engine._outside
    check(not bool(word[0].any()), f"{what}: the pop left the outbox "
          "word set")
    H, OB = ob["t"].shape
    t_live = ob["t"] < K.DROP_T
    check(not bool(t_live[pops == 0].any()), f"{what}: a host that popped "
          "nothing holds an exchangeable row at tally time")
    occ = {k: state[k].clone() for k in ("occ_ob", "occ_trips",
                                         "occ_phases")}
    if p.AUD:
        occ["aud_tx"] = state["aud_tx"].clone()
    set_word = K.outbox_word(state["head"].device)
    kk = K.Kernels()

    def make(w):
        return lambda: (clone(occ), ob, pops, p, ctl, w.clone())

    ms, parent_ms = tally_designs(torch, K, kk, make(word), what)
    every_ms, _ = tally_designs(torch, K, kk, make(set_word),
                                f"{what}, the word set")
    popped = int((pops != 0).sum())
    return {"phase_tally": finish({
        "err": 0.0, "ms": ms, "parent_ms": parent_ms,
        "every_host_ms": every_ms,
        "plain_ms": time_median(torch, K.phase_tally_plain,
                                lambda: make(word)()[:5], 3),
        "tally_shares": {"read": popped / H, "skipped": 1 - popped / H},
        "bytes": tally_bytes(pops, ob, False, p.AUD), "ops": 0,
        "shape": f"{what}: H={H} OB={OB} hosts popped (rows read) "
                 f"{popped}, exchangeable rows {int(t_live.sum())}"})}


def fold_rows(torch, K, engine, state, ob, pops, ctl, what):
    """K9 with the tally folded in on one real phase's popped and judged
    outbox and state (the outbox word as the pop left it), bit-equal to
    the plain tally and step, timed beside the two launched apart and the
    designs before."""
    p = engine.params
    word = engine._outside
    fields = ["occ_ob", "occ_trips", "occ_phases", "head", "ht"] + (
        ["aud_tx"] if p.AUD else [])

    def make():
        return ({k: state[k].clone() if k.startswith(("occ", "aud"))
                 else state[k] for k in fields}, ctl.clone(), ob, pops, p,
                word.clone())

    ms, apart_ms, before_ms = fold_designs(torch, K, K.Kernels(), make,
                                           what)
    H, OB = ob["t"].shape
    popped = int((pops != 0).sum())
    return {"loop_control_tally": finish({
        "err": 0.0, "ms": ms, "apart_ms": apart_ms, "parent_ms": before_ms,
        "plain_ms": time_median(torch, folded_plain,
                                lambda: make()[:5], 3),
        "bytes": loop_bytes(K, state) + tally_bytes(pops, ob, False,
                                                    p.AUD),
        "ops": 0,
        "shape": f"{what}: H={H} OB={OB} hosts popped {popped}; apart "
                 f"{apart_ms:.4f} ms, the designs before "
                 f"{before_ms:.4f} ms"})}


def loop_rows(torch, K, state, ctl, what):
    """K9 on a real state's heads (the block as the window loop hands it
    after the phase: the window going on or not), in both designs,
    bit-equal to its plain version."""
    H, E = state["ht"].shape
    kk = K.Kernels()

    def make():
        return (state, ctl.clone())

    ms, split_ms = loop_designs(torch, K, kk, state, make, what)
    return {"loop_control": finish({
        "err": 0.0, "ms": ms, "parent_ms": split_ms,
        "plain_ms": time_median(torch, K.loop_control_plain, make, 3),
        "bytes": loop_bytes(K, state), "ops": 0,
        "shape": f"{what}: H={H} E={E} heads within the heap "
                 f"{int((state['head'] < E).sum())}"})}


def real_phase_rows(torch, K, scratch, dev):
    """On one real phase's inputs of each of REAL_PHASES: the run paused
    at half its stop time by the graph loop, then the pop and K2 on the
    engine's own buffers as its last phase left them (`outbox_rows`;
    for phold also `outbox_adversarial`), then that phase's pops and
    judge on the engine (window end: the next head time plus the
    lookahead), then the route and the merge of that judged outbox
    against their plain versions, the merge trusting the heaps' order
    (as the main path does after a run's first merge) and checking
    every heap; the shares of hosts left as they are, merged and
    sorted in full, from head and the counts."""
    from shadow_tpu_torch.device import runner

    out, adversarial = {}, {}
    rng = np.random.default_rng(11)
    for name in REAL_PHASES:
        _, example, overrides, _ = next(r for r in FULL_RUNS
                                        if r[0] == name)
        cfg = full_config(example, overrides)
        engine, sim = runner.make_engine(cfg, device=dev.type)
        state = engine.init_state(sim.start_times, sim.stop_times)
        stop = int(engine.config.stop_time)
        engine.run(state, stop=stop // 2, final_stop=stop)
        nt = engine.next_time(state)
        check(nt < K.INF, f"{name}: no event left half way")
        p = engine.params
        ctl = K.control_block(dev, run=1, win_end=nt + max(
            1, int(engine.config.lookahead)))
        rows = outbox_rows(torch, K, engine, state, ctl,
                           f"{name}'s phase at {nt} ns")
        if name == "phold":
            adversarial = outbox_adversarial(torch, K, engine, state, ctl,
                                             rng)
        ob, pops, _ = engine._buffers()
        loop = loop_rows(torch, K, state, ctl, f"{name}'s state at {nt} "
                         "ns")
        engine.kernels.pop(state, ob, pops, engine.world, ctl, p,
                           engine._outside)
        engine.kernels.judge_outbox(state, ob, engine.world, ctl, p, pops,
                                    engine._outside)
        torch.cuda.synchronize()
        tally = tally_rows(torch, K, engine, state, ob, pops, ctl,
                           f"{name}'s phase at {nt} ns")
        tally.update(fold_rows(torch, K, engine, state, ob, pops, ctl,
                               f"{name}'s phase at {nt} ns"))
        row, route = route_check(torch, K, scratch, ob, f"{name}'s phase "
                                 f"at {nt} ns", p.IN)
        err, _ = merge_compare(torch, K, scratch, state, ob, route, p)
        m = merge_row(torch, K, scratch, state, ob, route, p, err,
                      f"{name}'s phase at {nt} ns: "
                      f"H={state['head'].shape[0]} E={p.E} IN={p.IN}")
        out[name] = {**rows, "route": row, "merge_heaps": m, **tally,
                     **loop}
        del engine, state, ob
        torch.cuda.empty_cache()
    return out, adversarial


def add_audit(torch, K, rng, state, p):
    """The audit's leaves on one phase's state, and its params with the
    clock lane on: words with random bits; aud_t one above the head
    event's time at a tenth of the hosts (their first pop trips the
    clock lane), equal to it at three tenths, below it elsewhere."""
    import dataclasses

    H, E = state["ht"].shape
    head = state["head"].long()
    t = state["ht"].gather(1, head.clamp(0, E - 1)[:, None])[:, 0]
    t = torch.where(head < E, t, 0)
    u = torch.from_numpy(rng.random(H)).to(t.device)
    below = (t.double() * u).long()
    state = dict(state)
    state["aud_t"] = torch.where(u < 0.1, t + 1,
                                 torch.where(u < 0.4, t, below))
    state["aud"] = torch.from_numpy(rng.choice(
        np.array([0, 0, 0, 0, 1, 4, 8], np.int32), H)).to(t.device)
    return state, dataclasses.replace(p, AUD=True)


def aud_pop_case(torch, K, scratch, rng, name, state0, world, p, win_end,
                 dev, base):
    """The audited instantiation of a pop (`name` + `_aud`) against the
    plain pop with the clock lane, on one phase's inputs with the
    audit's leaves (`add_audit`): exact on every state leaf, outbox
    field and pop count; the clock lane must trip. The row's bound is
    the unaudited row's (`base`) plus the two leaves read and
    written."""
    from shadow_tpu_torch.device.engine import OPTIONAL_DTYPES, STATE_DTYPES

    state, pa = add_audit(torch, K, rng, state0, p)
    H, OB = state["head"].shape[0], pa.OB
    keys = list(STATE_DTYPES) + [k for k in OPTIONAL_DTYPES if k in state]
    win = window_block(K, win_end, dev)

    def args():
        return (clone(state), {f: torch.empty(
            (H, OB), dtype=torch.int64, device=dev) for f in K.OB_FIELDS},
            torch.empty(H, dtype=torch.int32, device=dev), world, win, pa)

    ka, kp = args(), args()
    scratch.pop(*ka)
    K.pop_plain(*kp)
    torch.cuda.synchronize()
    err = max(max_abs_err(ka[0], kp[0], keys),
              max_abs_err(ka[1], kp[1], list(K.OB_FIELDS)),
              max_abs_err({"pops": ka[2]}, {"pops": kp[2]}, ["pops"]))
    check(err == 0.0, f"{name}{K.AUD} differs from its plain version "
          f"(max abs err {err})")
    check(scratch.launches[name + K.AUD] > 0, f"{name}{K.AUD}: never "
          "launched")
    trips = int((((ka[0]["aud"] & ~state["aud"]) & K.AUD_CLOCK) != 0).sum())
    check(trips > 0, f"{name}{K.AUD}: the clock lane never tripped")
    return finish({
        "err": err,
        "ms": time_median(torch, scratch.pop, args, 7),
        "plain_ms": time_median(torch, K.pop_plain, args, 3),
        "bytes": base["bytes"] + H * (4 + 8) * 2, "ops": base["ops"],
        "shape": f"{base['shape']} clock_trips={trips}"})


def audit_inputs(torch, K, rng, H, E, dev):
    """The leaves K8 reads, seeded: sorted heaps with INF tails, a
    twentieth of them with their first two times tied (keys either
    way), a hundredth with two live rows swapped; heads past E at a
    hundredth of the hosts and below 0 at a two-hundredth; counters
    negative at a thousandth; aud_tx balancing the row ledger."""
    slot = np.arange(E)[None, :]
    n_live = rng.integers(0, E + 1, H)
    ht = np.sort(rng.integers(0, 2 * 10**9, (H, E)), axis=1)
    tie = rng.random(H) < 0.05
    ht[tie, 1] = ht[tie, 0]
    swap = np.flatnonzero((rng.random(H) < 0.01) & (n_live >= 2))
    ht[swap, 0], ht[swap, 1] = ht[swap, 1], ht[swap, 0]
    live = slot < n_live[:, None]
    ht = np.where(live, ht, K.INF)
    hk = np.where(live, rng.integers(0, 2**62, (H, E)), K.IMAX)
    head = np.minimum(rng.integers(0, 4, H), n_live)
    head[rng.random(H) < 0.01] = E + 1
    head[rng.random(H) < 0.005] = -1
    leaves = {k: rng.integers(0, 2**20, H) for k in
              K.AUD_COUNTERS + ("overflow", "x_overflow")}
    for k in K.AUD_COUNTERS:
        leaves[k][rng.random(H) < 0.001] = -1
    after = ((slot >= head[:, None]) & (ht < K.INF)).sum(-1)
    aud_tx = (leaves["n_exec"] + after + leaves["overflow"]
              + leaves["x_overflow"]).astype(np.int64)
    arrays = {"ht": ht, "hk": hk, "head": head, "aud_tx": aud_tx,
              "aud": rng.choice(np.array([0, 0, 0, 2], np.int32), H),
              **leaves}
    return {k: torch.from_numpy(np.ascontiguousarray(
        v.astype(np.int64 if k in ("ht", "hk", "aud_tx") else np.int32)))
        .to(dev) for k, v in arrays.items()}


def audit_bytes(torch, K, state) -> tuple:
    """(bytes, tied slots, words written) of K8 on `state`: t of every
    slot, the keys of the slots in a run of tied times (each once), head,
    the nine int32 counters and aud_tx of every host, and the word of
    each host whose heap or counter bit the audit sets (read and
    written) whatever its word held before: what any audit of these
    inputs must move."""
    tie = state["ht"][:, :-1] == state["ht"][:, 1:]
    no = torch.zeros_like(tie[:, :1])
    tied = int((torch.cat([tie, no], 1) | torch.cat([no, tie], 1)).sum())
    fresh = dict(clone(state), aud=torch.zeros_like(state["aud"]))
    K.audit_round_plain(fresh)
    written = int(((fresh["aud"] & (K.AUD_HEAP | K.AUD_COUNTER))
                   != 0).sum())
    H, E = state["ht"].shape
    return (H * E * 8 + tied * 8 + H * (4 + 9 * 4 + 8) + written * 8,
            tied, written)


def audit_designs(torch, K, kk, cases, what):
    """K8 (kk) on each of `cases` ({case: state}) bit-equal to its plain
    version in both designs (the tiled one and the design before), the
    ledger's verdict AUD_CONSERVE on every host or none; returns (ms,
    the design before's ms), timed on the first case."""
    times = {}
    first = next(iter(cases.values()))
    for before in (False, True):
        kk.designs_before = before
        for case, st in cases.items():
            sk, sp = clone(st), clone(st)
            kk.audit_round(sk)
            K.audit_round_plain(sp)
            torch.cuda.synchronize()
            e = max_abs_err(sk, sp, list(st))
            check(e == 0.0, f"audit_round ({what}, {case}, the design "
                  f"before {before}) differs from its plain version (max "
                  f"abs err {e})")
            conserve = (sk["aud"] & K.AUD_CONSERVE) != 0
            check(bool(conserve.all()) or not bool(conserve.any()),
                  f"audit_round ({what}, {case}): AUD_CONSERVE on some "
                  "hosts only")
        times[before] = time_median(torch, kk.audit_round,
                                    lambda: (clone(first),), 7)
    kk.designs_before = False
    return times[False], times[True]


def off_by_one(state):
    """`state` with one host's aud_tx one row more: the ledger off."""
    off = dict(state, aud_tx=state["aud_tx"].clone())
    off["aud_tx"][0] += 1
    return off


def audit_case(torch, K, scratch, rng, H, E, dev):
    """K8 against its plain version on `audit_inputs`, with the row
    ledger balanced (no AUD_CONSERVE) and off by one (AUD_CONSERVE on
    every host), in both designs; timed on the balanced one."""
    state = audit_inputs(torch, K, rng, H, E, dev)
    ms, parent_ms = audit_designs(
        torch, K, K.Kernels(), {"balanced": state,
                                "off by one": off_by_one(state)},
        f"H={H}")
    sk = clone(state)
    scratch.audit_round(sk)
    conserve = (sk["aud"] & K.AUD_CONSERVE) != 0
    check(not bool(conserve.any()), "audit_round (balanced ledger): "
          "AUD_CONSERVE set")
    bits = {b: int(((sk["aud"] & ~state["aud"]) & b != 0).sum())
            for b in (K.AUD_HEAP, K.AUD_COUNTER)}
    check(all(bits.values()), f"audit_round: a bit never set ({bits})")
    nbytes, tied, written = audit_bytes(torch, K, state)
    return finish({
        "err": 0.0, "ms": ms, "parent_ms": parent_ms,
        "plain_ms": time_median(torch, K.audit_round_plain,
                                lambda: (clone(state),), 3),
        "library_ms": None, "bytes": nbytes, "ops": 0,
        "shape": f"H={H} E={E} tied_slots={tied} words_written={written} "
                 f"heap_bits={bits[K.AUD_HEAP]} "
                 f"counter_bits={bits[K.AUD_COUNTER]}; the design before "
                 f"{parent_ms:.4f} ms"})


# the full runs whose own audited state K8 is checked and timed on, paused
# half way (`audit_real_rows`)
AUDIT_REAL = ("phold", "phold_1m_hier")


def audit_real_rows(torch, K, dev):
    """K8 on each AUDIT_REAL run's own state, audited and paused at half
    its stop time by the graph loop (the leaves the audit reads as the
    main path leaves them), with the ledger as the run keeps it (balanced:
    no bit set) and off by one, in both designs, bit-equal to its plain
    version and timed."""
    from shadow_tpu_torch.device import runner

    out = {}
    for name in AUDIT_REAL:
        _, example, overrides, _ = next(r for r in FULL_RUNS
                                        if r[0] == name)
        cfg = full_config(example, overrides + (AUDIT,))
        engine, sim = runner.make_engine(cfg, device=dev.type)
        state = engine.init_state(sim.start_times, sim.stop_times)
        stop = int(engine.config.stop_time)
        engine.run(state, stop=stop // 2, final_stop=stop)
        check(not bool(state["aud"].any()), f"{name}: a health word set "
              "half way")
        leaves = {k: state[k] for k in ("ht", "hk", "head", "aud",
                                        "aud_tx", "overflow",
                                        "x_overflow") + K.AUD_COUNTERS}
        what = f"{name}'s audited state half way"
        ms, parent_ms = audit_designs(
            torch, K, K.Kernels(), {"as the run keeps it": leaves,
                                    "off by one": off_by_one(leaves)},
            what)
        sk = clone(leaves)
        K.Kernels().audit_round(sk)
        check(not bool(sk["aud"].any()), f"audit_round ({what}): a bit "
              "set on a sound state")
        nbytes, tied, _ = audit_bytes(torch, K, leaves)
        H, E = leaves["ht"].shape
        live = int((leaves["ht"] < K.INF).sum())
        out[f"{name} audited"] = {"audit_round": finish({
            "err": 0.0, "ms": ms, "parent_ms": parent_ms,
            "plain_ms": time_median(torch, K.audit_round_plain,
                                    lambda: (clone(leaves),), 3),
            "bytes": nbytes, "ops": 0,
            "shape": f"{what}: H={H} E={E} live rows {live} tied slots "
                     f"{tied}"})}
        del engine, state, leaves
        torch.cuda.empty_cache()
    return out


def loop_bytes(K, state) -> int:
    """K9's bytes at a state: the head of every host, and one 32-byte
    sector for the head time of each host whose head lies within its
    heap (the rows' stride of E * 8 bytes puts each load in a sector
    of its own)."""
    E = state["ht"].shape[-1]
    return state["head"].numel() * 4 + int((state["head"] < E).sum()) * 32


def loop_designs(torch, K, kk, state, make, what):
    """K9 (kk.loop_control) on `make()`'s state and block in both
    designs, each bit-equal to its plain version; returns (ms, the
    split design's ms: the parent's two launches)."""
    times = {}
    for split in (False, True):
        kk.designs_before = split
        a, b = make(), make()
        kk.loop_control(*a)
        K.loop_control_plain(*b)
        torch.cuda.synchronize()
        check(torch.equal(a[1], b[1]), f"loop_control ({what}, split "
              f"{split}) differs from its plain version: "
              f"{a[1].tolist()} != {b[1].tolist()}")
        times[split] = time_median(torch, kk.loop_control, make, 7)
    kk.designs_before = False
    return times[False], times[True]


def loop_control_case(torch, K, scratch, state, dev):
    """K9 against its plain version on a state's heads in each of its
    branches: the start step, the window going on, the round ending
    into a new window (clamped or not to final_stop), the stop reached,
    max_rounds reached, the loop already done; both designs (one launch,
    and the parent's two); timed on a round's end. The library call is
    torch.gather + amin of the head times."""
    H, E = state["ht"].shape
    m = int(K.head_min_plain(state))
    big = {"stop": K.INF, "final_stop": K.INF, "lookahead": 10**6,
           "max_rounds": 1 << 40, "rounds": 5, "phases": 9, "run": 1}
    cases = {
        "start": ({**big, "run": 0}, True),
        "continue": ({**big, "win_end": m + 1}, False),
        "round_end": ({**big, "win_end": m}, False),
        "clamped": ({**big, "win_end": m, "final_stop": m + 10}, False),
        "stop": ({**big, "win_end": m, "stop": m}, False),
        "max_rounds": ({**big, "win_end": m, "max_rounds": 6}, False),
        "done": ({**big, "done": 1, "round_end": 1}, False)}
    for case, (words, start) in cases.items():
        for split in (False, True):
            scratch.designs_before = split
            ck = K.control_block(dev, **words)
            cp = ck.clone()
            scratch.loop_control(state, ck, start)
            K.loop_control_plain(state, cp, start)
            torch.cuda.synchronize()
            check(torch.equal(ck, cp), f"loop_control ({case}, split "
                  f"{split}) differs from its plain version: "
                  f"{ck.tolist()} != {cp.tolist()}")
    scratch.designs_before = False
    head = state["head"].long().clamp(0, E - 1)[:, None]

    def make():
        return (state, K.control_block(dev, **cases["round_end"][0]))

    ms, split_ms = loop_designs(torch, K, scratch, state, make,
                                "round_end")
    return finish({
        "err": 0.0, "ms": ms, "parent_ms": split_ms,
        "plain_ms": time_median(torch, K.loop_control_plain, make, 3),
        "library_ms": time_median(
            torch, lambda ht, hd: ht.gather(1, hd).amin(),
            lambda: (state["ht"], head), 7),
        "bytes": loop_bytes(K, state), "ops": 0,
        "shape": f"H={H} E={E} branches={','.join(cases)}; "
                 f"one launch (the parent's two: {split_ms:.4f} ms)"})


def rule_outbox(torch, ob, pops):
    """`ob` with the rows of every host whose pop count is 0 cleared
    (t = INF): what the outbox holds at tally time with the engine's
    outbox word clear."""
    from shadow_tpu_torch.device.kernels import INF

    t = torch.where((pops == 0)[:, None], INF, ob["t"])
    return {**ob, "t": t.contiguous()}


def tally_bytes(pops, ob, read_all: bool, aud: bool) -> int:
    """The tally's bytes: every pop count; the rows' t, occ_ob read and
    written (aud_tx too under the audit) of the hosts whose rows are
    read (every host, or those with a nonzero pop count)."""
    H, OB = ob["t"].shape[-2:]
    n = pops.numel() if read_all else int((pops != 0).sum())
    return pops.numel() * 4 + n * (OB * 8 + 8 + (16 if aud else 0))


def tally_designs(torch, K, kk, make, what, word_set=False):
    """phase_tally (kk) on `make()`'s inputs (state, outbox, pops,
    params, ctl, word) bit-equal to its plain version in both designs
    (the parent's reads every row whatever the word); returns (ms, the
    parent design's ms)."""
    times = {}
    for parent in (False, True):
        kk.designs_before = parent
        a, b = make(), make()
        kk.phase_tally(*a)
        K.phase_tally_plain(*b[:5])
        torch.cuda.synchronize()
        err = max_abs_err(a[0], b[0], list(a[0]))
        check(err == 0.0, f"phase_tally ({what}, the parent's design "
              f"{parent}) differs from its plain version (max abs err "
              f"{err})")
        times[parent] = time_median(torch, kk.phase_tally, make, 7)
    kk.designs_before = False
    return times[False], times[True]


def tally_case(torch, K, scratch, rng, H, OB, dev):
    """phase_tally against its plain version at the PHOLD shapes on a
    judged outbox (DROP_T rows among the live ones), with and without
    the audit's ledger: given no outbox word (every host's row read), the
    word set (the same), and the word clear on the outbox as the rule
    leaves it (the rows of hosts with pop count 0 clear: only the popped
    hosts' rows read); each in both designs (the parent's reads every
    row). Timed without the audit, the word clear (every run's case)."""
    ob = random_outbox(rng, H, OB, torch, dev)
    pops = rng.integers(0, 9, H).astype(np.int32)
    pops[rng.random(H) < 0.5] = 0
    pops = torch.from_numpy(pops).to(dev)
    kept = rule_outbox(torch, ob, pops)
    state = {"occ_ob": torch.from_numpy(rng.integers(0, 20, H).astype(
                 np.int32)).to(dev),
             "occ_trips": torch.tensor([3], dtype=torch.int32, device=dev),
             "occ_phases": torch.tensor([7], dtype=torch.int32,
                                        device=dev),
             "aud_tx": torch.from_numpy(rng.integers(0, 2**40, H)).to(dev)}
    params = {aud: K.PhaseParams(E=64, K=3, T=0, P=1, B=OB // 3, IN=64,
                                 C=1, boot_end=0, seed=(0, 0), app=None,
                                 AUD=aud) for aud in (False, True)}
    words = {}
    for w in (0, 1):
        words[w] = K.outbox_word(dev)
        words[w][0] = w
    cases = {"no word": (ob, None), "word set": (ob, words[1]),
             "word clear": (kept, words[0])}
    times = {}
    for aud, p in params.items():
        for case, (o, word) in cases.items():
            sk, sp = clone(state), clone(state)
            scratch.phase_tally(sk, o, pops, p, None, word)
            K.phase_tally_plain(sp, o, pops, p)
            torch.cuda.synchronize()
            err = max_abs_err(sk, sp, list(state))
            check(err == 0.0, f"phase_tally (audit {aud}, {case}) differs "
                  "from its plain version")
            check(bool((sk["aud_tx"] != state["aud_tx"]).any()) == aud,
                  "phase_tally: aud_tx moved where the audit is off, or "
                  "not where it is on")
            if not aud:
                times[case] = tally_designs(
                    torch, K, scratch,
                    lambda o=o, word=word: (clone(state), o, pops,
                                            params[False], None, word),
                    case)

    def make():
        return (clone(state), kept, pops, params[False], None, words[0])

    exch = int((kept["t"] < K.DROP_T).sum())
    popped = int((pops != 0).sum())
    return finish({
        "err": 0.0, "ms": times["word clear"][0],
        "parent_ms": times["word clear"][1],
        "every_host_ms": times["word set"][0],
        "plain_ms": time_median(torch, K.phase_tally_plain,
                                lambda: make()[:5], 3),
        "library_ms": None,
        "bytes": tally_bytes(pops, kept, False, False), "ops": 0,
        "shape": f"H={H} OB={OB} hosts popped {popped}, exchangeable "
                 f"rows {exch}, the word clear; every host read (the word "
                 f"set) {times['word set'][0]:.4f} ms, the parent's design "
                 f"{times['word clear'][1]:.4f} ms"})


class FoldedLoop:
    """`loop_control` of a Kernels with the tally folded in, its inputs
    as separate arguments for replica_check's stacking: (state, ctl,
    outbox, pops, params, word), the word [2] for one replica (the
    wrapper's [2, 1]) or [R, 2] stacked (the wrapper's [2, R])."""

    def __init__(self, kernels):
        self.kernels = kernels

    def loop_control(self, state, ctl, ob, pops, p, word):
        w = word.view(2, 1) if word.dim() == 1 else word.t().contiguous()
        self.kernels.loop_control(state, ctl, False, (ob, pops, p, w))


def folded_plain(state, ctl, ob, pops, p, word=None):
    """The plain versions of K9 with the tally folded in: the tally where
    the phase ran, then the step."""
    from shadow_tpu_torch.device import kernels as K

    K.phase_tally_plain(state, ob, pops, p, ctl)
    K.loop_control_plain(state, ctl)


def fold_designs(torch, K, kk, make, what):
    """`loop_control_tally` (kk) on make()'s (state, ctl, outbox, pops,
    params, word [2, R]) bit-equal to the plain tally and step; timed
    beside the tally and K9 launched apart (this tree's designs) and
    the designs before (the tally reading every row, K9 in two
    launches). Returns (ms, apart ms, the designs before's ms)."""
    def folded(state, ctl, ob, pops, p, word):
        kk.loop_control(state, ctl, False, (ob, pops, p, word))

    def apart(state, ctl, ob, pops, p, word):
        kk.phase_tally(state, ob, pops, p, ctl, word)
        kk.loop_control(state, ctl)

    a, b = make(), make()
    folded(*a)
    folded_plain(*b[:5])
    torch.cuda.synchronize()
    err = max(max_abs_err(a[0], b[0], list(a[0])),
              float((a[1] - b[1]).abs().max()))
    check(err == 0.0, f"loop_control_tally ({what}) differs from its "
          f"plain version (max abs err {err})")
    ms = time_median(torch, folded, make, 7)
    apart_ms = time_median(torch, apart, make, 7)
    kk.designs_before = True
    before_ms = time_median(torch, apart, make, 7)
    kk.designs_before = False
    return ms, apart_ms, before_ms


def fold_case(torch, K, scratch, rng, H, OB, dev):
    """K9 with the tally folded in at the PHOLD shapes: K8's heaps
    (`audit_inputs`, its ledger as aud_tx) and a judged outbox as the
    rule leaves it (the word clear, half the hosts popped) or garbage
    under the word, with and without the audit, in K9's branches (the
    phase ran and the window goes on, the round ends, the stop is
    reached; the loop done: no tally); timed the word clear, beside
    the two launched apart and the designs before."""
    state0 = audit_inputs(torch, K, rng, H, 64, dev)
    state0.update(occ_ob=torch.from_numpy(rng.integers(0, 20, H).astype(
        np.int32)).to(dev),
        occ_trips=torch.tensor([3], dtype=torch.int32, device=dev),
        occ_phases=torch.tensor([7], dtype=torch.int32, device=dev))
    ob = random_outbox(rng, H, OB, torch, dev)
    pops = rng.integers(0, 9, H).astype(np.int32)
    pops[rng.random(H) < 0.5] = 0
    pops = torch.from_numpy(pops).to(dev)
    kept = rule_outbox(torch, ob, pops)
    m = int(K.head_min_plain(state0))
    big = {"stop": K.INF, "final_stop": K.INF, "lookahead": 10**6,
           "max_rounds": 1 << 40, "rounds": 5, "phases": 9, "run": 1}
    branches = {"continue": {**big, "win_end": m + 1},
                "round_end": {**big, "win_end": m},
                "stop": {**big, "win_end": m, "stop": m},
                "done": {**big, "done": 1, "run": 0}}
    words = {}
    for w in (0, 1):
        words[w] = K.outbox_word(dev)
        words[w][0] = w
    leaves = ("occ_ob", "occ_trips", "occ_phases", "aud_tx", "head", "ht")
    err = 0.0
    for aud in (False, True):
        p = K.PhaseParams(E=64, K=3, T=0, P=1, B=OB // 3, IN=64, C=1,
                          boot_end=0, seed=(0, 0), app=None, AUD=aud)
        for case, c in branches.items():
            for o, w in ((kept, 0), (ob, 1)):
                sk = {k: state0[k].clone() for k in leaves}
                sp = {k: state0[k].clone() for k in leaves}
                ck = K.control_block(dev, **c)
                cp = ck.clone()
                scratch.loop_control(sk, ck, False, (o, pops, p, words[w]))
                folded_plain(sp, cp, o, pops, p)
                torch.cuda.synchronize()
                err = max(err, max_abs_err(sk, sp, list(leaves)))
                check(err == 0.0 and torch.equal(ck, cp),
                      f"loop_control_tally ({case}, audit {aud}, word {w}) "
                      f"differs from its plain version")
    p = K.PhaseParams(E=64, K=3, T=0, P=1, B=OB // 3, IN=64, C=1,
                      boot_end=0, seed=(0, 0), app=None)
    fields = ("occ_ob", "occ_trips", "occ_phases", "head", "ht")

    def make():
        return ({k: state0[k].clone() if k.startswith("occ") else state0[k]
                 for k in fields},
                K.control_block(dev, **branches["continue"]), kept, pops,
                p, words[0])

    ms, apart_ms, before_ms = fold_designs(torch, K, scratch, make,
                                           "synthetic")
    popped = int((pops != 0).sum())
    return finish({
        "err": err, "ms": ms, "apart_ms": apart_ms, "parent_ms": before_ms,
        "plain_ms": time_median(torch, folded_plain,
                                lambda: make()[:5], 3),
        "library_ms": None,
        "bytes": loop_bytes(K, state0) + tally_bytes(pops, kept, False,
                                                     False),
        "ops": 0,
        "shape": f"H={H} E=64 OB={OB} hosts popped {popped}, branches="
                 f"{','.join(branches)}, the word clear and set; the tally "
                 f"and K9 launched apart {apart_ms:.4f} ms, the designs "
                 f"before {before_ms:.4f} ms"})


def loop_kernels(torch, K, scratch, rng, dev):
    """K8 at 100,000 and 1,000,000 hosts (E = 64, and an odd E), K9 at
    1,000,000 (on K8's heaps), phase_tally and K9 with the tally folded
    in at the PHOLD shapes."""
    out = {"audit_round": audit_case(torch, K, scratch, rng, 100_000, 64,
                                     dev)}
    big = audit_case(torch, K, scratch, rng, 1_000_000, 64, dev)
    out["audit_round"]["at_1m_hosts"] = big
    # an odd E: one word a load, in one wave of blocks and in several
    out["audit_round"]["odd_e"] = {
        f"H={h}": audit_case(torch, K, scratch, rng, h, 33, dev)
        for h in (100_000, 1_000_000)}
    out["audit_round"]["odd_e"]["err"] = 0.0
    state = audit_inputs(torch, K, rng, 1_000_000, 64, dev)
    out["loop_control"] = loop_control_case(torch, K, scratch, state, dev)
    out["phase_tally"] = tally_case(torch, K, scratch, rng, 100_000, 30,
                                    dev)
    out["loop_control_tally"] = fold_case(torch, K, scratch, rng, 100_000,
                                          30, dev)
    return out


# ----------------------------------------------------------------------
# the replica axis: each kernel on REPLICAS replicas against R = 1
# ----------------------------------------------------------------------
REPLICAS = 4


def vary_world(torch, world, r, dev):
    """Replica r's world made from a standalone one, as a campaign
    varies it: latencies scaled by 1 + r % 3 (every factored leaf but
    the shared cl), reliabilities lowered by 1.5% a replica, and its own
    seed key (seed 101 + r)."""
    from shadow_tpu_torch.device.prng import seed_key

    s, keep = 1 + r % 3, 1.0 - 0.015 * r

    def lat(a):
        return (a.long() * s).to(torch.int32)

    def rel(a):
        return (a * keep).to(torch.float32)

    if isinstance(world["lat"], tuple):
        cc, cl, acc, slf = world["lat"]
        ccr, _, accr, slfr = world["rel"]
        tables = ((lat(cc), cl, lat(acc), lat(slf)),
                  (rel(ccr), cl, rel(accr), rel(slfr)))
    else:
        tables = (lat(world["lat"]), rel(world["rel"]))
    return {**world, "lat": tables[0], "rel": tables[1],
            "seed_key": torch.tensor([list(seed_key(101 + r))],
                                     dtype=torch.int64, device=dev)}


def stack_worlds(torch, worlds):
    """A campaign's world from its replicas' standalone worlds: tables
    (all factored leaves but cl), epoch times and seed keys stacked on
    a leading axis, the other leaves replica 0's (shared)."""
    w0 = worlds[0]

    def stack(key):
        if isinstance(w0[key], tuple):
            return tuple(w0[key][1] if i == 1 else
                         torch.stack([w[key][i] for w in worlds])
                         for i in range(4))
        return torch.stack([w[key] for w in worlds])

    return {**w0, "lat": stack("lat"), "rel": stack("rel"),
            "epoch_times": torch.stack([w["epoch_times"] for w in worlds]),
            "seed_key": torch.cat([w["seed_key"] for w in worlds])}


def stack_arg(torch, vals):
    """One argument of a batched launch from the replicas' own: worlds
    by `stack_worlds`, state and outbox dicts, control blocks and other
    tensors stacked on a leading axis, tuples of tensors element by
    element; anything else (params, flags) replica 0's."""
    v = vals[0]
    if isinstance(v, dict):
        if "epoch_times" in v:
            return stack_worlds(torch, vals)
        return {k: torch.stack([d[k] for d in vals]) for k in v}
    if isinstance(v, torch.Tensor):
        return torch.stack(vals)
    if isinstance(v, tuple):
        return tuple(torch.stack(x) for x in zip(*vals))
    return v


def arg_err(a, b) -> float:
    """max_abs_err of two outputs: tensor dicts, tuples or tensors."""
    if isinstance(a, dict):
        return max_abs_err(a, b, list(a))
    if isinstance(a, tuple):
        return max(arg_err(x, y) for x, y in zip(a, b))
    return max_abs_err({"x": a}, {"x": b}, ["x"])


def clone_arg(x):
    if isinstance(x, dict):
        return clone(x)
    if isinstance(x, tuple):
        return tuple(v.clone() for v in x)
    return x.clone()


def replica_check(torch, K, scratch, name, method, plain, make, outs,
                  ctl_at, freeze, canon=lambda x: x, frozen_canon=None,
                  axes=None):
    """`name` (scratch.<method>, or `method` itself where it is a
    function) on REPLICAS replicas' inputs stacked on a leading axis
    (`axes`: each argument's replica axis, `stack_at`; a campaign rank's
    wire buffers hold the replica inside their peer blocks) against
    REPLICAS launches on each replica's own
    inputs (R = 1) and against its plain version `plain` on the stacked
    inputs, exact on every output (`outs`: the indices of the arguments
    the kernel writes; `canon` drops what a kernel leaves unspecified);
    then again with replica 1's control block (argument `ctl_at`)
    frozen by `freeze(block)`: replica 1's outputs (as `frozen_canon`
    gives them, default `canon`) keep every byte and the others are
    unchanged. `make(r)` gives fresh standalone
    arguments of replica r. Times the R = 1 launch of replica 0 and the
    R = REPLICAS launch (CUDA events, median of 7), and the plain
    version at R = REPLICAS (median of 3)."""
    R = REPLICAS
    fn = getattr(scratch, method) if isinstance(method, str) else method
    singles = []
    for r in range(R):
        a = make(r)
        fn(*a)
        singles.append([canon(a[i]) for i in outs])

    def axis(i):
        return 0 if axes is None else axes[i]

    def batched():
        per = [make(r) for r in range(R)]
        return [stack_at(torch, [a[i] for a in per], axis(i))
                for i in range(len(per[0]))]

    kb, pb = batched(), batched()
    fn(*kb)
    plain(*pb)
    torch.cuda.synchronize()
    err = 0.0
    for j, i in enumerate(outs):
        want = stack_at(torch, [s[j] for s in singles], axis(i))
        err = max(err, arg_err(canon(kb[i]), want),
                  arg_err(canon(kb[i]), canon(pb[i])))
    check(err == 0.0, f"{name} at R={R} differs from {R} launches at "
          f"R=1 or from its plain version (max abs err {err})")
    kf = batched()
    freeze(kf[ctl_at][1])
    frozen_ctl = kf[ctl_at][1].clone()
    before = [clone_arg(kf[i]) for i in outs]
    fn(*kf)
    torch.cuda.synchronize()
    frozen_canon = frozen_canon or canon
    for j, i in enumerate(outs):
        check(arg_err(slice_at(frozen_canon(kf[i]), 1, axis(i)), slice_at(
            frozen_canon(before[j]), 1, axis(i))) == 0.0, f"{name}: a "
              "replica whose control block stops it changed")
        got = canon(kf[i])
        for r in (0, 2, 3):
            check(arg_err(slice_at(got, r, axis(i)), singles[r][j]) == 0.0,
                  f"{name}: replica {r} changed with replica 1 stopped")
    if ctl_at not in outs:
        check(torch.equal(kf[ctl_at][1], frozen_ctl), f"{name}: the "
              "stopped replica's control block changed")
    return {"R": R, "err": err, "stopped_replica_unchanged": True,
            "ms_r1": time_median(torch, fn, lambda: make(0), 7),
            "ms_r4": time_median(torch, fn, batched, 7),
            "plain_ms_r4": time_median(torch, plain, batched, 3)}


def replica_kernels(torch, K, scratch, rng, dev):
    """Every kernel of a phase and of the loop, and the pop's and the
    judge's table views, at R = REPLICAS on four replicas' seeded states,
    worlds (`vary_world`: tables, seed keys) and window ends, against
    four R = 1 launches and the plain versions (`replica_check`)."""
    import dataclasses

    from shadow_tpu_torch.device.apps import PholdDevice
    from shadow_tpu_torch.device.prng import seed_key

    R, out = REPLICAS, {}

    def stop_run(block):
        block[K.CTL["run"]] = 0

    def empty(H, OB):
        return ({f: torch.empty((H, OB), dtype=torch.int64, device=dev)
                 for f in K.OB_FIELDS},
                torch.empty(H, dtype=torch.int32, device=dev))

    def pops_of(states, worlds, p, wins):
        def make(r):
            ob, pops = empty(states[r]["head"].shape[0], p.OB)
            return (clone(states[r]), ob, pops, worlds[r],
                    window_block(K, wins[r], dev), p)
        return make

    def pop_case_r(name, states, worlds, p, wins):
        out[name] = replica_check(
            torch, K, scratch, name, "pop", K.pop_plain,
            pops_of(states, worlds, p, wins), (0, 1, 2), 4, stop_run)

    def varied(state0, world, E):
        """Replicas of one phase's inputs: odd replicas' heads one slot
        on, each replica's tables and seed, window ends 10 ms apart."""
        states = [state0 if r % 2 == 0 else dict(
            state0, head=(state0["head"] + 1).clamp(max=E))
            for r in range(R)]
        worlds = [vary_world(torch, world, r, dev) for r in range(R)]
        return states, worlds

    # K1 at the PHOLD shapes, four random states
    H, E = 100_000, 64
    phold_world = {
        "host_vertex": torch.from_numpy(
            rng.integers(0, 2, H).astype(np.int32)).to(dev),
        "lat": torch.tensor([[30_000_000, 50_000_000],
                             [50_000_000, 30_000_000]],
                            dtype=torch.int32, device=dev),
        "rel": torch.tensor([[0.98, 0.9], [0.9, 0.98]],
                            dtype=torch.float32, device=dev),
        "epoch_times": torch.zeros(1, dtype=torch.int64, device=dev)}
    p1 = K.PhaseParams(E=E, K=3, T=0, P=1, B=10, IN=E, C=1,
                       boot_end=5 * 10**8, seed=seed_key(7),
                       app=PholdDevice(n_hosts_total=H, msgload=3,
                                       size=512, selfloop=1))
    wins = [10**9 + 10**7 * r for r in range(R)]
    states = [random_state(rng, H, E, dev) for _ in range(R)]
    worlds = [vary_world(torch, phold_world, r, dev) for r in range(R)]
    pop_case_r("pop_phase", states, worlds, p1, wins)
    nic_states, nic_worlds = [], []
    for r in range(R):
        s, w = add_nic(torch, K, rng, states[r], worlds[r], wins[r], dev)
        if nic_worlds:      # bandwidths and the law table are shared
            w = {**w, **{k: nic_worlds[0][k]
                         for k in ("bw_up", "bw_down", "law")}}
        nic_states.append(s)
        nic_worlds.append(w)
    pop_case_r("pop_phase_nic", nic_states, nic_worlds,
               dataclasses.replace(p1, B=8, MB=True, CP=True), wins)

    # K4 at tgen_10000's layout: dense, factored, epochs, audited; then
    # K2 (dense, factored, epochs) on each replica's K4 outbox, K7
    E = 48
    state0, world, pt, win_end = tgen_inputs(torch, K, rng, H, E, dev)
    wins = [win_end + 10**7 * r for r in range(R)]
    states, worlds = varied(state0, world, E)
    views = {"": worlds,
             K.HIER: [vary_world(torch, star_world(torch, world, dev), r,
                                 dev) for r in range(R)],
             K.EP: [vary_world(torch, stack_epochs(
                 torch, world, EPOCH_TIMES, dev), r, dev)
                 for r in range(R)]}
    for suffix, ws in views.items():
        pop_case_r("pop_tgen" + suffix, states, ws, pt, wins)
    aud = [add_audit(torch, K, rng, s, pt) for s in states]
    pop_case_r("pop_tgen_aud", [a[0] for a in aud], worlds, aud[0][1],
               wins)
    pj = dataclasses.replace(pt, CP=True)
    for suffix, ws in views.items():
        judged = []
        for r in range(R):
            a = pops_of(states, ws, pt, wins)(r)
            scratch.pop(*a)
            judged.append((a[0], a[1]))

        def judge_make(r, judged=judged, ws=ws):
            return (clone(judged[r][0]), clone(judged[r][1]), ws[r],
                    window_block(K, wins[r], dev), pj)

        out["judge_outbox" + suffix] = replica_check(
            torch, K, scratch, "judge_outbox" + suffix, "judge_outbox",
            K.judge_outbox_plain, judge_make, (0, 1), 3, stop_run)
        if not suffix:
            dense_judged = [judge_make(r) for r in range(R)]
            for a in dense_judged:
                scratch.judge_outbox(*a)
    V = int(world["lat"].shape[-1])

    def paths_make(r):
        return ({"path_cnt": torch.zeros((1, V * V), dtype=torch.int64,
                                         device=dev)},
                clone(dense_judged[r][1]), worlds[r],
                window_block(K, wins[r], dev))

    out["count_paths"] = replica_check(
        torch, K, scratch, "count_paths", "count_paths",
        K.count_paths_plain, paths_make, (0,), 3, stop_run)
    # its bound at R = REPLICAS: count_paths_case's bytes, replica by
    # replica (t of every row; src, dst and weight of each packet row
    # with its two vertices; each histogram cell touched read and
    # written)
    k7 = 0
    hv = world["host_vertex"].long()
    for r in range(R):
        ob = dense_judged[r][1]
        pkt = (ob["t"] < K.INF) & ((ob["m"] & 0xFF) == 2)
        cells = hv[(ob["k"] >> 32)[pkt]] * V + hv[(ob["m"] >> 32)[pkt]]
        k7 += (ob["t"].numel() * 8 + int(pkt.sum()) * (2 * 8 + 2 * 4)
               + torch.unique(cells).numel() * 16)
    out["count_paths"]["bound_ms"] = 1e3 * k7 / HBM_BYTES_PER_S
    # again with pop counts and the engine's outbox words: replicas 0
    # and 2 with the word clear on outboxes as the rule leaves them
    # (only the popped hosts' rows read), 1 and 3 with it set (every row)
    Hj = dense_judged[0][1]["t"].shape[0]
    path_pops = [torch.from_numpy(np.where(
        rng.random(Hj) < 0.3, rng.integers(1, 9, Hj), 0).astype(
            np.int32)).to(dev) for _ in range(R)]
    path_obs = [rule_outbox(torch, dense_judged[r][1], path_pops[r])
                if r % 2 == 0 else dense_judged[r][1] for r in range(R)]

    def paths_word_make(r):
        return ({"path_cnt": torch.zeros((1, V * V), dtype=torch.int64,
                                         device=dev)},
                clone(path_obs[r]), worlds[r],
                window_block(K, wins[r], dev), path_pops[r],
                torch.tensor([r % 2, 0], dtype=torch.int32, device=dev))

    out["count_paths_word"] = replica_check(
        torch, K, WordPaths(scratch), "count_paths with outbox words",
        "count_paths", lambda *a: K.count_paths_plain(*a[:4]),
        paths_word_make, (0,), 3, stop_run)

    # K6 at tor_large's layout
    state0, world, pr, win_end = tor_inputs(torch, K, rng, dev)
    states, worlds = varied(state0, world, pr.E)
    pop_case_r("pop_tor", states, worlds, pr,
               [win_end + 10**7 * r for r in range(R)])

    # K5 and K3 at the PHOLD shapes, K3 at E = IN = 64 on random
    # outboxes with hot destinations; the tallies with the audit's
    # ledger
    H, E, OB = 100_000, 64, 30
    obs = [random_outbox(rng, H, OB, torch, dev) for _ in range(R)]
    routes = [K.route_plain(ob) for ob in obs]
    run1 = window_block(K, 10**9, dev)

    def route_make(r):
        return (obs[r], tuple(torch.full_like(x, -7) for x in routes[r]),
                run1.clone())

    def route_canon(out_):
        perm, starts, counts = out_
        live = torch.arange(perm.shape[-1], device=dev) < \
            counts.sum(-1, keepdim=True)
        return (torch.where(live, perm, -1), starts, counts)

    def route_plain_into(ob, out_, ctl):
        for o, x in zip(out_, K.route_plain(ob)):
            o.copy_(x)

    # the route zeroes every replica's counts, which only the guarded
    # merge reads: a stopped replica keeps its perm and starts
    out["route"] = replica_check(
        torch, K, scratch, "route", "route", route_plain_into, route_make,
        (1,), 2, stop_run, canon=route_canon,
        frozen_canon=lambda out_: out_[:2])
    pm = dataclasses.replace(p1, IN=64)
    states = [random_state(rng, H, E, dev) for _ in range(R)]

    def merge_make(r):
        return (clone(states[r]), obs[r], *routes[r], pm, run1.clone())

    out["merge_heaps"] = replica_check(
        torch, K, scratch, "merge_heaps", "merge_heaps",
        K.merge_heaps_plain, merge_make, (0,), 6, stop_run)
    pa = dataclasses.replace(p1, AUD=True)

    tallies = [({"occ_ob": torch.from_numpy(rng.integers(
                     0, 20, H).astype(np.int32)).to(dev),
                 "occ_trips": torch.tensor([3 * r], dtype=torch.int32,
                                           device=dev),
                 "occ_phases": torch.tensor([7 + r], dtype=torch.int32,
                                            device=dev),
                 "aud_tx": torch.from_numpy(rng.integers(
                     0, 2**40, H)).to(dev)},
                torch.from_numpy(rng.integers(0, 9, H).astype(
                    np.int32)).to(dev)) for r in range(R)]

    def tally_make(r):
        return (clone(tallies[r][0]), obs[r], tallies[r][1], pa,
                run1.clone())

    out["phase_tally"] = replica_check(
        torch, K, scratch, "phase_tally", "phase_tally",
        K.phase_tally_plain, tally_make, (0,), 4, stop_run)
    # again with the engine's outbox words: replicas 0 and 2 with the
    # word clear on outboxes as the rule leaves them (only the popped
    # hosts' rows read), 1 and 3 with it set (every row read)
    kept = [rule_outbox(torch, obs[r], tallies[r][1]) if r % 2 == 0
            else obs[r] for r in range(R)]

    def word_make(r):
        return (clone(tallies[r][0]), kept[r], tallies[r][1], pa,
                run1.clone(), torch.tensor([r % 2, 0], dtype=torch.int32,
                                           device=dev))

    out["phase_tally_word"] = replica_check(
        torch, K, WordTally(scratch), "phase_tally with outbox words",
        "phase_tally", lambda *a: K.phase_tally_plain(*a[:5]), word_make,
        (0,), 4, stop_run)

    # K8 and K9 on audit_inputs' heaps (100,000 hosts, E = 64)
    aud_states = [audit_inputs(torch, K, rng, H, E, dev) for _ in range(R)]

    def audit_make(r):
        return (clone(aud_states[r]),
                K.control_block(dev, round_end=1, run=r % 2))

    def stop_round(block):
        block[K.CTL["round_end"]] = 0

    out["audit_round"] = replica_check(
        torch, K, scratch, "audit_round", "audit_round",
        K.audit_round_plain, audit_make, (0,), 1, stop_round)
    mins = [int(K.head_min_plain(s)) for s in aud_states]
    big = {"stop": K.INF, "final_stop": K.INF, "lookahead": 10**6,
           "max_rounds": 1 << 40, "rounds": 5, "phases": 9, "run": 1}
    words = [{**big, "win_end": mins[0] + 1},
             {**big, "win_end": mins[1]},
             {**big, "win_end": mins[2], "final_stop": mins[2] + 10},
             {**big, "win_end": mins[3], "stop": mins[3]}]

    def loop_make(r):
        return (aud_states[r], K.control_block(dev, **words[r]))

    def stop_loop(block):
        block[K.CTL["done"]] = 1
        block[K.CTL["run"]] = 0
        block[K.CTL["round_end"]] = 0

    out["loop_control"] = replica_check(
        torch, K, scratch, "loop_control", "loop_control",
        K.loop_control_plain, loop_make, (1,), 1, stop_loop)
    # K9 with the tally folded in: replica r's heads with tally r's
    # leaves, outbox (the rule's for the word clear, replicas 0 and 2)
    # and pop counts; a stopped replica (DONE) tallies nothing
    def fold_make(r):
        st = {"head": aud_states[r]["head"], "ht": aud_states[r]["ht"],
              **clone(tallies[r][0])}
        return (st, K.control_block(dev, **words[r]), kept[r],
                tallies[r][1], pa, torch.tensor([r % 2, 0],
                                                dtype=torch.int32,
                                                device=dev))

    out["loop_control_tally"] = replica_check(
        torch, K, FoldedLoop(scratch), "loop_control_tally",
        "loop_control", folded_plain, fold_make, (0, 1), 1, stop_loop)
    # loop_control_case's bytes (every head, a sector for each head
    # time read) over the replicas
    out["loop_control"]["bound_ms"] = 1e3 * sum(
        loop_bytes(K, s) for s in aud_states) / HBM_BYTES_PER_S
    return out


class WordTally:
    """`phase_tally` of a Kernels with the outbox word as its last
    argument in replica_check's stacking: [2] for one replica (the
    wrapper's [2, 1]), [R, 2] stacked (the wrapper's [2, R])."""

    def __init__(self, kernels):
        self.kernels = kernels

    def phase_tally(self, state, ob, pops, p, ctl, word):
        w = word.view(2, 1) if word.dim() == 1 else word.t().contiguous()
        self.kernels.phase_tally(state, ob, pops, p, ctl, w)


class WordPaths:
    """`count_paths` of a Kernels with the pop counts and outbox word as
    its last arguments in replica_check's stacking (as `WordTally`)."""

    def __init__(self, kernels):
        self.kernels = kernels

    def count_paths(self, state, ob, world, ctl, pops, word):
        w = word.view(2, 1) if word.dim() == 1 else word.t().contiguous()
        self.kernels.count_paths(state, ob, world, ctl, pops, w)


# ----------------------------------------------------------------------
# K10 judge_batch and K11 compact_outbox
# ----------------------------------------------------------------------
JUDGE_N = 1 << 20
# the batches' bootstrap end: packets sent before it never drop
JUDGE_BOOT_END = 500_000_000
# bytes a packet brings in (now, src, dst, seq) and takes out
# (deliver_time, delivered)
K_JUDGE_IN, K_JUDGE_OUT = 20, 9
# the batch whose senders and destinations lie partly outside [0, H)
JUDGE_OUTSIDE_N = 1 << 16


def judge_batch_inputs(torch, rng, world, N, boundaries):
    """N deferred packets for K10 on `world`'s hosts: senders uniform;
    destinations a tenth the sender itself, a tenth another host on its
    vertex (itself where it is alone), a tenth the next host id (the
    same cluster, on tiled factored tables), the rest uniform; send
    times a third at 1 ns before, at and after each of `boundaries`, the
    rest uniform in [0, 2 s); packet seqs uniform int32 with 0, 2^31-1,
    -1 (u32 0xFFFFFFFF) and -2^31 among them. (now, src, dst, seq) on
    the world's device."""
    hv = world["host_vertex"].cpu().numpy().astype(np.int64)
    H = len(hv)
    src = rng.integers(0, H, N)
    order = np.argsort(hv, kind="stable")
    pair = hv[order][1:] == hv[order][:-1]
    partner = np.arange(H)
    partner[order[:-1][pair]] = order[1:][pair]
    partner[order[1:][pair]] = order[:-1][pair]
    pick = rng.random(N)
    dst = np.where(pick < 0.1, src, np.where(
        pick < 0.2, partner[src], np.where(
            pick < 0.3, np.minimum(src + 1, H - 1),
            rng.integers(0, H, N))))
    near = (np.repeat(np.asarray(boundaries, np.int64), 3)
            + np.tile(np.array([-1, 0, 1], np.int64), len(boundaries)))
    now = rng.integers(0, 2 * 10**9, N)
    at = rng.random(N) < 1 / 3
    now[at] = near[rng.integers(0, len(near), int(at.sum()))]
    now = np.maximum(now, 0)
    seq = rng.integers(-2**31, 2**31, N)
    seq[:4] = [0, 2**31 - 1, -1, -2**31]
    dev = world["host_vertex"].device
    return (torch.from_numpy(now.astype(np.int64)).to(dev),
            *(torch.from_numpy(a.astype(np.int32)).to(dev)
              for a in (src, dst, seq)))


def judge_work(torch, K, world, now, src, dst, boot_end) -> dict:
    """What K10 must move and compute on one batch, whatever implements
    it: the batch's columns, the host vertices it names and the table
    cells its lookups touch (each once), the epoch starts, and two
    threefry blocks a rolled packet plus one a sender that rolls; with
    the counts of each kind of pair. Senders and destinations in [0, H)."""
    N = now.shape[0]
    hier = isinstance(world["lat"], tuple)
    ept = world["epoch_times"]
    T = int(ept.shape[0])
    hv = world["host_vertex"].long()
    sv, dv = hv[src.long()], hv[dst.long()]
    e = K.epoch_of(now, ept)
    e = torch.zeros_like(now) if e is None else e.long()
    rel = K.table_lookup(world["rel"], sv, dv, None if T == 1 else e)
    rolled = (rel < 1.0) & (now >= boot_end)
    hosts = torch.unique(torch.cat([src, dst])).numel()
    if hier:
        cl = world["lat"][1].long()
        V = cl.shape[0]
        C = int(world["lat"][0].shape[-1])
        same = sv == dv
        verts = torch.unique(torch.cat([sv, dv])).numel()
        ev = torch.unique(torch.cat([e * V + sv, e * V + dv])[
            torch.cat([~same, ~same])]).numel()
        selfv = torch.unique((e * V + sv)[same]).numel()
        core = torch.unique(((e * C + cl[sv]) * C + cl[dv])[~same]).numel()
        # cl of every vertex named, the access pair of every (epoch,
        # vertex) of a cross-vertex lookup, the self pair of every
        # (epoch, vertex) of a same-vertex one, the core pair cells
        table = verts * 4 + ev * 8 + selfv * 8 + core * 8
        kinds = {"same_vertex": int(same.sum()),
                 "same_cluster": int((~same & (cl[sv] == cl[dv])).sum()),
                 "cross_cluster": int((cl[sv] != cl[dv]).sum())}
    else:
        V = int(world["lat"].shape[-1])
        table = torch.unique((e * V + sv) * V + dv).numel() * 8
        kinds = {"same_vertex": int((sv == dv).sum()),
                 "cross_vertex": int((sv != dv).sum())}
    rolled_n = int(rolled.sum())
    senders = torch.unique(src[rolled]).numel()
    return {"bytes": N * (K_JUDGE_IN + K_JUDGE_OUT) + hosts * 4 + table
            + T * 8,
            "ops": (2 * rolled_n + senders) * THREEFRY_OPS,
            "rolled": rolled, "lossy": rel < 1.0, "rolled_n": rolled_n,
            "hosts": hosts,
            "kinds": kinds, "T": T, "V": V, "hier": hier}


def judge_designs(torch, K, before, scratch, tables, boot_end, cols):
    """Max abs err of K10 (`scratch`) and of its design before
    (`before`) against judge_batch_plain on the columns `cols`, and
    the plain verdicts."""
    dp, tp = K.judge_batch_plain(tables.world, boot_end, *cols)
    err = 0.0
    for kk in (scratch, before):
        dk, tk = kk.judge_batch(tables, boot_end, *cols)
        torch.cuda.synchronize()
        err = max(err, max_abs_err({"d": dk.bool(), "t": tk},
                                   {"d": dp, "t": tp}, ["d", "t"]))
    return err, dp, tp


def judge_outside(torch, K, before, scratch, rng, tables, name):
    """K10 and its design before against the plain version on a batch
    of JUDGE_OUTSIDE_N packets, a quarter of whose senders and a
    quarter of whose destinations lie outside [0, H) (both ends of
    int32, -H - 1, -H, -2, -1, H and H + 1 among them, a third of the
    rest in [-H, -1]): an id in [-H, -1] reads host id + H, as the
    reference's gather reads it, the others clamp; the roll keys the raw
    sender; drops among those senders."""
    H = int(tables.world["host_vertex"].shape[0])
    N = JUDGE_OUTSIDE_N
    i32 = np.iinfo(np.int32)

    def outside(n):
        pick = rng.random(n)
        x = np.where(pick < 1 / 3, rng.integers(i32.min, -H, n),
                     np.where(pick < 2 / 3, rng.integers(-H, 0, n),
                              rng.integers(H, i32.max, n, endpoint=True)))
        x[:8] = [i32.min, -1, H, H + 1, i32.max, -2, -H, -H - 1]
        return x

    src, dst = rng.integers(0, H, N), rng.integers(0, H, N)
    out_s, out_d = rng.random(N) < 0.25, rng.random(N) < 0.25
    src[out_s] = outside(int(out_s.sum()))
    dst[out_d] = outside(int(out_d.sum()))
    now = rng.integers(JUDGE_BOOT_END, 2 * 10**9, N)
    seq = rng.integers(i32.min, i32.max, N, endpoint=True)
    dev = tables.world["host_vertex"].device
    cols = (torch.from_numpy(now.astype(np.int64)).to(dev),
            *(torch.from_numpy(a.astype(np.int32)).to(dev)
              for a in (src, dst, seq)))
    err, dp, _ = judge_designs(torch, K, before, scratch, tables,
                               JUDGE_BOOT_END, cols)
    check(err == 0.0, f"{name} (senders outside [0, H)) differs from its "
          f"plain version (max abs err {err})")
    dropped = int((~dp.cpu().numpy() & out_s).sum())
    check(dropped > 0, f"{name}: no packet of a sender outside [0, H) "
          "dropped")
    wrapped = int((out_s & (src >= -H) & (src < 0)).sum())
    check(wrapped > 0, f"{name}: no sender in [-H, -1]")
    return {"err": err, "packets": N, "senders_outside": int(out_s.sum()),
            "senders_in_minus_h_to_minus_1": wrapped,
            "dropped_of_those": dropped}


def judge_batch_case(torch, K, scratch, before, rng, world, boundaries):
    """K10 and its design before against judge_batch_plain on one batch
    of JUDGE_N packets, exact, timed, and on a batch with senders
    outside [0, H) (`judge_outside`); the bound is `judge_work`'s."""
    N = JUDGE_N
    now, src, dst, seq = judge_batch_inputs(torch, rng, world, N,
                                            boundaries)
    dev = now.device
    tables = K.judge_tables(world)
    out = (torch.empty(N, dtype=torch.int64, device=dev),
           torch.empty(N, dtype=torch.uint8, device=dev))
    err, dp, _ = judge_designs(torch, K, before, scratch, tables,
                               JUDGE_BOOT_END, (now, src, dst, seq))
    name = tables.name
    check(err == 0.0, f"{name} differs from its plain version (max abs "
          f"err {err})")
    check(scratch.launches[name] > 0 and before.launches[name] > 0,
          f"{name} never launched")
    w = judge_work(torch, K, world, now, src, dst, JUDGE_BOOT_END)
    rolled = w["rolled"]
    dropped = int((~dp).sum())
    check(dropped > 0 and int((rolled & dp).sum()) > 0,
          f"{name}: the batch rolled nothing or dropped nothing")
    check(bool(((now < JUDGE_BOOT_END) & w["lossy"]).any()),
          f"{name}: no lossy packet before the bootstrap end")
    for k, n in w["kinds"].items():
        check(n > 0, f"{name}: no {k} pair in the batch")

    def args():
        return (tables, JUDGE_BOOT_END, now, src, dst, seq, out)

    def plain_args():
        return (tables.world, JUDGE_BOOT_END, now, src, dst, seq)

    return finish({
        "err": err,
        "ms": time_median(torch, scratch.judge_batch, args, 7),
        "parent_ms": time_median(torch, before.judge_batch, args, 7),
        "plain_ms": time_median(torch, K.judge_batch_plain, plain_args, 3),
        "library_ms": None, "launch": name,
        "bytes": w["bytes"], "ops": w["ops"],
        "outside": judge_outside(torch, K, before, scratch, rng, tables,
                                 name),
        "shape": f"N={N} H={world['host_vertex'].shape[0]} V={w['V']} "
                 f"T={w['T']} rolled={w['rolled_n']} dropped={dropped} "
                 f"hosts={w['hosts']} "
                 + " ".join(f"{k}={v}" for k, v in w["kinds"].items())})


def judge_batch_kernels(torch, K, scratch, rng, dev):
    """K10 on its four views, each at JUDGE_N packets: phold.yaml's
    dense tables (2% loss) at the PHOLD shapes' 100,000 hosts; the
    factored tables of examples/tgen_1000000.yaml (hubs lossy as
    PHOLD_1M_HUB_LOSS) at its 1,000,000 hosts; phold_1m_hier_faults'
    six factored epochs; the dense tables stacked over EPOCH_TIMES
    (`stack_epochs`). Send times straddle the bootstrap end and every
    epoch start."""
    from shadow_tpu_torch.device.prng import seed_key

    key = torch.tensor([list(seed_key(7))], dtype=torch.int64, device=dev)
    H = 100_000
    dense = {
        "host_vertex": torch.from_numpy(
            rng.integers(0, 2, H).astype(np.int32)).to(dev),
        "lat": torch.tensor([[30_000_000, 50_000_000],
                             [50_000_000, 30_000_000]],
                            dtype=torch.int32, device=dev),
        "rel": torch.full((2, 2), 0.98, dtype=torch.float32, device=dev),
        "epoch_times": torch.zeros(1, dtype=torch.int64, device=dev),
        "seed_key": key}
    _, _, million = million_world(dev)
    _, faults = million_fault_world(dev)
    cases = (("judge_batch", dense, [JUDGE_BOOT_END]),
             ("judge_batch_hier", million(PHOLD_1M_HUB_LOSS),
              [JUDGE_BOOT_END]),
             ("judge_batch_ep_hier", faults,
              [JUDGE_BOOT_END] + faults["epoch_times"].tolist()),
             ("judge_batch_ep", stack_epochs(torch, dense, EPOCH_TIMES,
                                             dev),
              [JUDGE_BOOT_END] + EPOCH_TIMES))
    before = K.Kernels()       # the design before, on the same inputs
    before.designs_before = True
    out = {}
    for name, world, bounds in cases:
        world = {**world, "seed_key": key}
        out[name] = judge_batch_case(torch, K, scratch, before, rng, world,
                                     bounds)
        check(out[name]["launch"] == name,
              f"{name}: the tables launch {out[name]['launch']}")
    return out


def compact_inputs(torch, rng, H, OB, dev):
    """A judged outbox at [H, OB] for K11: each row 0 to OB live rows
    (uniform), at random columns, times from 64 values (ties), every
    twentieth live row a DROP_T marker, destinations from 64 hosts
    (ties), the rest INF; random k/s/v words; and x_overflow
    counters."""
    from shadow_tpu_torch.device.kernels import DROP_T, INF

    n_live = rng.integers(0, OB + 1, H)
    live = np.argsort(rng.random((H, OB)), axis=1) < n_live[:, None]
    t = rng.integers(10**9, 10**9 + 64, (H, OB))
    t = np.where(rng.random((H, OB)) < 0.05, DROP_T, t)
    t = np.where(live, t, INF).astype(np.int64)
    m = (rng.integers(0, 64, (H, OB)).astype(np.int64) << 32) | \
        (2 | (1 << 8))
    ob = {f: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
          for f, a in (("t", t), ("m", m))}
    for f in ("k", "s", "v"):
        ob[f] = torch.from_numpy(rng.integers(
            -2**63, 2**63 - 1, (H, OB), dtype=np.int64)).to(dev)
    state = {"x_overflow": torch.from_numpy(rng.integers(
        0, 1000, H).astype(np.int32)).to(dev)}
    return state, ob


def compact_params(K, OB, cx, rule):
    return K.PhaseParams(E=64, K=3, T=0, P=1, B=max(1, OB // 3), IN=64,
                         C=1, boot_end=0, seed=(0, 0), app=None, CX=cx,
                         CXG=rule)


def compact_designs(torch, K, kk, make, what):
    """K11 (kk) on `make()`'s inputs (state, outbox, params, ctl, pop
    counts, outbox words; the last three may be None) bit-equal to its
    plain version in both designs (the design before reads every row
    whatever the word); returns (ms, the design before's ms)."""
    times = {}
    for before in (False, True):
        kk.designs_before = before
        a, b = make(), make()
        kk.compact_outbox(*a)
        K.compact_plain(b[0], b[1], b[2].CX, b[2].CXG, b[3])
        torch.cuda.synchronize()
        err = max(max_abs_err(a[0], b[0], ["x_overflow"]),
                  max_abs_err(a[1], b[1], list(K.OB_FIELDS)))
        name = "compact_outbox" + ("_global" if a[2].CXG else "")
        check(err == 0.0, f"{name} ({what}, the design before {before}) "
              f"differs from its plain version (max abs err {err})")
        times[before] = time_median(torch, kk.compact_outbox, make, 7)
    kk.designs_before = False
    return times[False], times[True]


def compact_bytes(K, ob, pops, cx, rule, read_all: bool) -> tuple:
    """(bytes, rows read, overflowing rows, dropped rows) of K11 on these
    inputs: the pop counts of every host (where it skips by them), t of
    the rows read (those of the hosts that popped, or every row), m of
    the live columns of overflowing rows (window rule), t written for
    the dropped rows, x_overflow read and written for the overflowing
    senders: what any compaction of these inputs must move."""
    H, OB = ob["t"].shape
    live = (ob["t"] < K.DROP_T).sum(-1)
    over = live > cx
    rows = H if read_all else int((pops != 0).sum())
    dropped = int((live - cx).clamp(min=0).sum())
    lives = int(live[over].sum())
    nbytes = ((0 if pops is None else H * 4) + rows * OB * 8
              + (0 if rule else lives * 8) + dropped * 8
              + int(over.sum()) * 4 * 2)
    return nbytes, rows, int(over.sum()), dropped


def compact_kernels(torch, K, scratch, rng, dev):
    """K11 at the PHOLD shapes (H = 100,000, OB = 30) with CX 4 and 16,
    both rules, against compact_plain, exact on the outbox and
    x_overflow, in both designs (every row read: no pop counts), and on
    rows wider than 256 columns (the wide kernel); and each rule at R =
    REPLICAS against four R = 1 launches and the plain version, a
    replica whose control block stops it keeping every byte
    (`replica_check`), without and with pop counts and outbox words.
    Returns (the rows, at CX = 4 with the CX = 16 and wide cases beside
    it; the R = REPLICAS checks)."""
    H, OB = 100_000, 30
    state0, ob0 = compact_inputs(torch, rng, H, OB, dev)
    live = (ob0["t"] < K.DROP_T).sum(-1)
    # wider rows: 4 and 8 columns a lane, and the wide kernel
    wider = {ob: compact_inputs(torch, rng, 20_000, ob, dev)
             for ob in (100, 256, 300)}
    out, r4 = {}, {}
    for rule, name in ((False, "compact_outbox"),
                       (True, "compact_outbox_global")):
        rows = {}
        for cx, (st0, o0) in ((4, (state0, ob0)), (16, (state0, ob0)),
                              *((16, w) for w in wider.values())):
            p = compact_params(K, o0["t"].shape[1], cx, rule)
            sk, obk = clone(st0), clone(o0)
            scratch.compact_outbox(sk, obk, p)
            lv = (o0["t"] < K.DROP_T).sum(-1)
            over = int((lv - cx).clamp(min=0).sum())
            check(over > 0 and int((sk["x_overflow"].long()
                                    - st0["x_overflow"].long()).sum())
                  == over, f"{name} (CX={cx}): x_overflow is not the "
                  "live rows past CX")

            def args(p=p, st0=st0, o0=o0):
                return (clone(st0), clone(o0), p, None, None, None)

            Hx, OBx = o0["t"].shape
            ms, parent_ms = compact_designs(torch, K, K.Kernels(), args,
                                            f"H={Hx} OB={OBx} CX={cx}")
            nbytes, _, n_over, dropped = compact_bytes(K, o0, None, cx,
                                                       rule, True)
            rows[cx, OBx] = finish({
                "err": 0.0, "ms": ms, "parent_ms": parent_ms,
                "plain_ms": time_median(
                    torch, lambda s, o, q, *_: K.compact_plain(
                        s, o, q.CX, q.CXG), args, 3),
                "library_ms": None, "bytes": nbytes, "ops": 0,
                "shape": f"H={Hx} OB={OBx} CX={cx} overflowing_rows="
                         f"{n_over} dropped={dropped}; the design before "
                         f"{parent_ms:.4f} ms"})
        out[name] = rows[4, OB]
        out[name]["at_cx16"] = rows[16, OB]
        out[name]["wider_rows"] = {f"OB={ob}": rows[16, ob]
                                   for ob in wider}
        out[name]["wider_rows"]["err"] = 0.0
        run1 = K.control_block(dev, run=1)
        p4 = compact_params(K, OB, 4, rule)
        reps = [compact_inputs(torch, rng, H, OB, dev) for _ in
                range(REPLICAS)]

        def make(r, p4=p4):
            return (clone(reps[r][0]), clone(reps[r][1]), p4, run1.clone())

        def stop_run(block):
            block[K.CTL["run"]] = 0

        r4[name] = replica_check(
            torch, K, scratch, name, "compact_outbox",
            lambda s, o, q, c: K.compact_plain(s, o, q.CX, q.CXG, c),
            make, (0, 1), 3, stop_run)
        # again with pop counts and outbox words: replicas 0 and 2 with
        # the word clear on outboxes as the rule leaves them (only the
        # popped hosts' rows read), 1 and 3 with it set (every row read)
        pops = [torch.from_numpy(np.where(
            rng.random(H) < 0.4, rng.integers(1, 9, H), 0).astype(
                np.int32)).to(dev) for _ in range(REPLICAS)]
        kept = [rule_outbox(torch, reps[r][1], pops[r]) if r % 2 == 0
                else reps[r][1] for r in range(REPLICAS)]

        def word_make(r, p4=p4):
            return (clone(reps[r][0]), clone(kept[r]), p4, run1.clone(),
                    pops[r], torch.tensor([r % 2, 0], dtype=torch.int32,
                                          device=dev))

        r4[name + "_word"] = replica_check(
            torch, K, WordCompact(scratch), f"{name} with outbox words",
            "compact_outbox",
            lambda s, o, q, c, *_: K.compact_plain(s, o, q.CX, q.CXG, c),
            word_make, (0, 1), 3, stop_run)
    return out, r4


class WordCompact:
    """`compact_outbox` of a Kernels with the outbox word as its last
    argument in replica_check's stacking (as `WordTally`)."""

    def __init__(self, kernels):
        self.kernels = kernels

    def compact_outbox(self, state, ob, p, ctl, pops, word):
        w = word.view(2, 1) if word.dim() == 1 else word.t().contiguous()
        self.kernels.compact_outbox(state, ob, p, ctl, pops, w)


def compact_real_rows(torch, K, dev):
    """K11 on one real phase of each COMPACT_FULL run: the run under
    outbox_compact at the largest occ_ob of the same run uncompacted and
    paused at half its stop time (both by the graph loop), then one
    phase popped, judged and tallied on the engine's own buffers (pop
    counts and outbox word as the engine leaves them); K11 on that
    outbox at that CX with the word clear (only the popped hosts' rows
    read) and set (every row), and at half the phase's fullest row (rows
    overflow) under both rules, each in both designs, bit-equal to its
    plain version and timed."""
    from shadow_tpu_torch.device import runner

    out = {}
    for name, example, overrides, _ in COMPACT_FULL:
        cfg = full_config(example, overrides)
        engine, sim = runner.make_engine(cfg, device=dev.type)
        state = engine.init_state(sim.start_times, sim.stop_times)
        stop = int(engine.config.stop_time)
        engine.run(state, stop=stop // 2, final_stop=stop)
        cx = int(state["occ_ob"].max())
        del engine, state
        cfg = full_config(example, overrides + (
            f"experimental.outbox_compact={cx}",))
        engine, sim = runner.make_engine(cfg, device=dev.type)
        state = engine.init_state(sim.start_times, sim.stop_times)
        engine.run(state, stop=stop // 2, final_stop=stop)
        nt = engine.next_time(state)
        check(nt < K.INF, f"{name}: no event left half way")
        p = engine.params
        ctl = K.control_block(dev, run=1, win_end=nt + max(
            1, int(engine.config.lookahead)))
        ob, pops, _ = engine._buffers()
        word = engine._outside
        engine.kernels.pop(state, ob, pops, engine.world, ctl, p, word)
        engine.kernels.judge_outbox(state, ob, engine.world, ctl, p, pops,
                                    word)
        engine.kernels.phase_tally(state, ob, pops, p, ctl, word)
        torch.cuda.synchronize()
        check(not bool(word[0].any()), f"{name}: the pop left the outbox "
              "word set")
        t_live = ob["t"] < K.DROP_T
        check(not bool(t_live[pops == 0].any()), f"{name}: a host that "
              "popped nothing holds an exchangeable row")
        H, OB = ob["t"].shape
        popped = int((pops != 0).sum())
        st0 = {"x_overflow": state["x_overflow"]}
        set_word = K.outbox_word(dev)
        # a CX at which this phase's fullest rows overflow
        half = max(1, int(t_live.sum(-1).max()) // 2)
        for case, cxc, rule, w in (
                ("the word clear", cx, p.CXG, word),
                ("the word set", cx, p.CXG, set_word),
                ("rows overflowing, window rule", half, False, word),
                ("rows overflowing, global rule", half, True, word)):
            q = dataclasses.replace(p, CX=cxc, CXG=rule)
            kname = "compact_outbox_global" if rule else "compact_outbox"

            def make(q=q, w=w):
                return (clone(st0), clone(ob), q, ctl, pops, w.clone())

            what = f"{name}'s compacted phase at {nt} ns, CX={cxc}, {case}"
            ms, parent_ms = compact_designs(torch, K, K.Kernels(), make,
                                            what)
            read_all = w is set_word
            nbytes, rows, n_over, dropped = compact_bytes(
                K, ob, pops, cxc, rule, read_all)
            out.setdefault(f"{name} compacted, {case}", {})[kname] = finish({
                "err": 0.0, "ms": ms, "parent_ms": parent_ms,
                "plain_ms": time_median(
                    torch, lambda s, o, qq, c, *_: K.compact_plain(
                        s, o, qq.CX, qq.CXG, c), make, 3),
                "bytes": nbytes, "ops": 0,
                "shape": f"{what}: H={H} OB={OB} hosts popped {popped}, "
                         f"rows read {rows}, exchangeable rows "
                         f"{int(t_live.sum())}, overflowing rows {n_over}, "
                         f"dropped {dropped}"})
        del engine, state, ob
        torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------
# the host mesh's kernels: K12, K13, K5's new modes, K3's second block
# ----------------------------------------------------------------------
MESH_SHAPES = ((2, 50_000), (4, 25_000))    # (S, H_loc): phold.yaml's
MESH_OB = 30


def mesh_outbox(torch, rng, H_loc, S, shard, dev):
    """One rank's judged outbox at the PHOLD shapes: random_outbox's rows
    aimed over the mesh's S*H_loc hosts, a tenth at 16 hot hosts of
    another shard."""
    ob = random_outbox(rng, H_loc, MESH_OB, torch, dev)
    shape = (H_loc, MESH_OB)
    dst = rng.integers(0, S * H_loc, shape)
    hot = ((shard + 1) % S) * H_loc + rng.integers(0, 16, shape)
    dst = np.where(rng.random(shape) < 0.1, hot, dst)
    ob["m"] = (torch.from_numpy(dst.astype(np.int64)).to(dev) << 32) | \
        (ob["m"] & 0xFFFFFFFF)
    return ob


def _eq(a, b) -> float:
    return max_abs_err({"x": a}, {"x": b}, ["x"])


def mesh_state(torch, K, rng, H, S, dev):
    """random_state with the mesh's [1, S] occ_x and no x_overflow."""
    st = random_state(rng, H, 64, dev)
    st["occ_x"] = torch.zeros((1, S), dtype=torch.int32, device=dev)
    return st


def pack_case(torch, K, scratch, rng, S, H_loc, cap, dev, two_phase):
    """K12 (or K13's phase 1) on one rank's routed outbox at `cap`
    against its plain version: the send buffer, x_overflow and occ_x
    bit for bit."""
    from shadow_tpu_torch.device.capacity import group_split

    g, ng = group_split(S) if two_phase else (1, S)
    mp = K.MeshParams(S, 0, H_loc, "two_phase" if two_phase
                      else "all_to_all", cap, 0, g, ng)
    ob = mesh_outbox(torch, rng, H_loc, S, 0, dev)
    perm, starts, counts = K.route_rows_plain(K.Rows(ob), 0, S * H_loc)
    name = "pack_two_phase" if two_phase else "pack_remote"
    shape = (g, 6, cap) if two_phase else (S, 6, cap)
    state0 = {"x_overflow": torch.zeros(H_loc, dtype=torch.int32,
                                        device=dev),
              "occ_x": torch.zeros((1, S), dtype=torch.int32, device=dev)}
    outs = {}
    for who, fn in (("kernel", getattr(scratch, name)),
                    ("plain", getattr(K, name + "_plain"))):
        st = clone(state0)
        send = torch.empty(shape, dtype=torch.int64, device=dev)
        fn(st, ob, perm, starts, counts, mp, send)
        outs[who] = (send, st)
    torch.cuda.synchronize()
    err = max(_eq(outs["kernel"][0], outs["plain"][0]),
              max_abs_err(outs["kernel"][1], outs["plain"][1],
                          ["x_overflow", "occ_x"]))
    check(err == 0.0, f"{name} (S={S}, CAP={cap}) differs from its plain "
          f"version (max abs err {err})")
    lost = int(outs["plain"][1]["x_overflow"].sum())

    def args():
        return (clone(state0), ob, perm, starts, counts, mp,
                torch.empty(shape, dtype=torch.int64, device=dev))

    seg = counts.view(S, H_loc).sum(1)
    shipped = int(seg[1:].clamp(max=cap).sum())
    # the same copy as one PyTorch call: index_select of the shipped
    # rows' five fields (one [5, F] block) into [5, S*CAP]
    block = torch.stack([ob[f].view(-1) for f in K.OB_FIELDS])
    win = (starts.view(S, H_loc)[:, :1] + torch.arange(
        cap, device=dev)).clamp(max=perm.shape[0] - 1)
    idx = perm[win.view(-1)]
    return finish({
        "err": err, "lost": lost,
        "ms": time_median(torch, getattr(scratch, name), args, 7),
        "plain_ms": time_median(torch, getattr(K, name + "_plain"), args,
                                3),
        "library_ms": time_median(
            torch, lambda b, i: torch.index_select(b, 1, i),
            lambda: (block, idx), 7),
        # the shipped rows' five fields and their perm entries read, the
        # buffer written, the lost rows' perm entries read and their
        # counters written
        "bytes": shipped * 6 * 8 + int(np.prod(shape)) * 8
        + lost * (8 + 4) + S * 16,
        "ops": 0,
        "shape": f"S={S} H_loc={H_loc} OB={MESH_OB} CAP={cap} "
                 f"rows={int(counts.sum())} shipped={shipped} "
                 f"lost={lost}"})


def phase2_case(torch, K, scratch, rng, S, H_loc, cap, cap2, dev):
    """K13's phase 2 and K5's keyed route, on the phase-1 arrivals of a
    rank of a mesh of S = 4 (g = ng = 2): rank 0's own phase-1 buffers
    stand for what its group sent it."""
    from shadow_tpu_torch.device.capacity import group_split

    g, ng = group_split(S)
    mp = K.MeshParams(S, 0, H_loc, "two_phase", cap, cap2, g, ng)
    ob = mesh_outbox(torch, rng, H_loc, S, 0, dev)
    perm, starts, counts = K.route_rows_plain(K.Rows(ob), 0, S * H_loc)
    st = {"x_overflow": torch.zeros(H_loc, dtype=torch.int32, device=dev),
          "occ_x": torch.zeros((1, S), dtype=torch.int32, device=dev)}
    recv1 = torch.empty((g, 6, cap), dtype=torch.int64, device=dev)
    K.pack_two_phase_plain(st, ob, perm, starts, counts, mp, recv1)
    rows1 = K.Rows(recv1)
    # K5 keyed over the H_pad destinations
    routed = {}
    for who, fn in (("kernel", scratch.route_rows),
                    ("plain", K.route_rows_plain)):
        routed[who] = fn(rows1, 0, S * H_loc, True)
    torch.cuda.synchronize()
    L = int(routed["plain"][2].sum())
    rerr = max(_eq(routed["kernel"][0][:L], routed["plain"][0][:L]),
               _eq(routed["kernel"][1], routed["plain"][1]),
               _eq(routed["kernel"][2], routed["plain"][2]))
    check(rerr == 0.0, f"route_keyed (S={S}, {rows1.n} rows) differs "
          f"from its plain version (max abs err {rerr})")
    arr = routed["plain"]
    outs = {}
    for who, fn in (("kernel", scratch.pack_two_phase2),
                    ("plain", None)):
        send = torch.empty((ng - 1, 6, cap2), dtype=torch.int64, device=dev)
        hist = torch.empty(S * H_loc, dtype=torch.int32, device=dev)
        if fn is None:
            hist.zero_()
            K.pack_two_phase2_plain(rows1, *arr, mp, MESH_OB, send, hist)
        else:
            fn(rows1, *arr, mp, MESH_OB, send, hist)
        outs[who] = (send, hist)
    torch.cuda.synchronize()
    err = max(_eq(outs["kernel"][0], outs["plain"][0]),
              _eq(outs["kernel"][1], outs["plain"][1]))
    check(err == 0.0, f"pack_two_phase2 (S={S}, CAP2={cap2}) differs "
          f"from its plain version (max abs err {err})")
    lost = int(outs["plain"][1].sum())

    def p2_args():
        return (rows1, *arr, mp, MESH_OB,
                torch.empty((ng - 1, 6, cap2), dtype=torch.int64,
                            device=dev),
                torch.empty(S * H_loc, dtype=torch.int32, device=dev))

    def p2_plain(*a):
        a[-1].zero_()
        K.pack_two_phase2_plain(*a)

    kf = rows1.fields(("key",))["key"]
    tm = rows1.fields(("t",))["t"]
    live = int((tm < K.DROP_T).sum())
    # phase 2 forwards to shard (1, 0) = g
    shipped = int(min(cap2, int(arr[2].view(S, H_loc)[g].sum())))
    key_span = torch.arange(S * H_loc + 1, device=dev) * (
        S * H_loc * MESH_OB)
    p2 = finish({
        "err": err, "lost": lost,
        "ms": time_median(torch, scratch.pack_two_phase2, p2_args, 7),
        "plain_ms": time_median(torch, p2_plain, p2_args, 3),
        "library_ms": None,
        "bytes": shipped * 7 * 8 + (ng - 1) * 6 * cap2 * 8 + lost * 20
        + S * H_loc * 4,
        "ops": 0,
        "shape": f"S={S} g={g} ng={ng} CAP={cap} CAP2={cap2} "
                 f"arrivals={live} lost={lost}"})
    rk = finish({
        "err": rerr,
        "ms": time_median(torch, scratch.route_rows,
                          lambda: (rows1, 0, S * H_loc, True), 7),
        "plain_ms": time_median(torch, K.route_rows_plain,
                                lambda: (rows1, 0, S * H_loc, True), 3),
        "library_ms": time_median(
            torch, lambda k: torch.searchsorted(torch.sort(k)[0],
                                                key_span),
            lambda: (torch.where(tm < K.DROP_T, kf, K.IMAX),), 7),
        # t, m and key of every row, perm of live rows written, starts
        # and counts written
        "bytes": rows1.n * 3 * 8 + live * 8 + S * H_loc * 16,
        "ops": 0,
        "shape": f"S={S} rows={rows1.n} live={live} dst={S * H_loc}"})
    return p2, rk


def merge2_case(torch, K, scratch, rng, S, H_loc, cap, dev):
    """K5's window over one rank's received rows (the [S, 6, CAP]
    buffers of its peers' K12) and K3 merging them with its own
    self-shard rows, against the plain versions."""
    from shadow_tpu_torch.device.engine import STATE_DTYPES

    mp = K.MeshParams(S, 1, H_loc, "all_to_all", cap, 0, 1, S)
    recv = torch.empty((S, 6, cap), dtype=torch.int64, device=dev)
    for src in range(S):
        other = K.MeshParams(S, src, H_loc, "all_to_all", cap, 0, 1, S)
        # hot rows aim at shard 1, this rank
        ob = mesh_outbox(torch, rng, H_loc, S, 0, dev)
        pr, sr, cr = K.route_rows_plain(K.Rows(ob), 0, S * H_loc)
        send = torch.empty((S, 6, cap), dtype=torch.int64, device=dev)
        K.pack_remote_plain({"x_overflow": torch.zeros(
            H_loc, dtype=torch.int32, device=dev), "occ_x": torch.zeros(
            (1, S), dtype=torch.int32, device=dev)}, ob, pr, sr, cr, other,
            send)
        recv[src] = send[1]
    rows = K.Rows(recv)
    own = mesh_outbox(torch, rng, H_loc, S, 1, dev)
    po, so, co = K.route_rows_plain(K.Rows(own), 0, S * H_loc)
    lo = mp.g0
    second = (own, po, so[lo:lo + H_loc], co[lo:lo + H_loc])
    routed = {}
    for who, fn in (("kernel", scratch.route_rows),
                    ("plain", K.route_rows_plain)):
        routed[who] = fn(rows, lo, H_loc, False)
    torch.cuda.synchronize()
    L = int(routed["plain"][2].sum())
    rerr = max(_eq(routed["kernel"][0][:L], routed["plain"][0][:L]),
               _eq(routed["kernel"][1], routed["plain"][1]),
               _eq(routed["kernel"][2], routed["plain"][2]))
    check(rerr == 0.0, f"route_window (S={S}, {rows.n} rows) differs from "
          f"its plain version (max abs err {rerr})")
    arr = routed["plain"]
    from shadow_tpu_torch.device.apps import PholdDevice
    from shadow_tpu_torch.device.engine import EngineConfig, phase_params

    p = phase_params(EngineConfig(n_hosts=S * H_loc, event_capacity=64,
                                  outbox_capacity=MESH_OB),
                     PholdDevice(n_hosts_total=S * H_loc))
    state0 = mesh_state(torch, K, rng, H_loc, S, dev)
    ordered = lex_sorted(torch, K, state0)
    res = {}
    # every heap checked, then trusting the order of heaps in order
    for occ_sum, st0, fresh in ((False, state0, None),
                                (True, state0, None),
                                (False, ordered, trusted(K, dev)),
                                (True, ordered, trusted(K, dev))):
        sk, sp = clone(st0), clone(st0)
        scratch.merge_heaps(sk, rows, *arr, p, second=second,
                            occ_sum=occ_sum, fresh=fresh)
        K.merge_heaps_plain(sp, rows.fields(K.OB_FIELDS), *arr, p, None,
                            (own, *second[1:]), occ_sum)
        torch.cuda.synchronize()
        e = max_abs_err(sk, sp, list(STATE_DTYPES))
        check(e == 0.0, f"merge_heaps2 (occ_sum={occ_sum}, "
              f"{'checked' if fresh is None else 'trusting the order'}) "
              f"differs from its plain version (max abs err {e})")
        res[occ_sum] = max(res.get(occ_sum, 0.0), e)
    over = int((sk["overflow"].long() - state0["overflow"].long()).sum())
    check(over > 0, "merge_heaps2 overflowed nothing")

    fresh = trusted(K, dev)

    def k3_args():
        return (clone(ordered), rows, *arr, p, None, second, False, fresh)

    def k3_plain(st, r, *a):
        K.merge_heaps_plain(st, r.fields(K.OB_FIELDS), *a[:5],
                            (own, *second[1:]))

    E, IN = p.E, p.IN
    accepted = int(arr[2].clamp(max=IN).sum() + second[3].clamp(
        max=IN).sum())
    fm = rows.fields(("t", "m"))
    tm = fm["t"]
    live = int((tm < K.DROP_T).sum())
    c1 = merge_columns(torch, K, ordered, rows.fields(K.OB_FIELDS), *arr,
                       IN)
    c2 = merge_columns(torch, K, {**ordered, "head": torch.full_like(
        ordered["head"], E)}, own, *second[1:], IN)
    cols = tuple(torch.cat([a, b[:, E:]], 1) for a, b in zip(c1, c2))
    m2 = finish({
        "err": max(res.values()),
        "ms": time_median(torch, scratch.merge_heaps, k3_args, 7),
        "plain_ms": time_median(torch, k3_plain, k3_args, 3),
        "library_ms": time_median(torch, merge_library(torch, E),
                                  lambda: cols, 7),
        "bytes": merge_bytes(ordered, arr[2], E, IN, False, second[3]),
        "ops": 0,
        "shape": f"H_loc={H_loc} E={E} IN={IN} two blocks, accepted "
                 f"{accepted}, overflow {over}"})
    # the window's library: a sort of (destination, position) keys of
    # the live rows in the window, then searchsorted
    n = rows.n
    d = (fm["m"] >> 32) - lo
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    wkey = torch.where((tm < K.DROP_T) & (d >= 0) & (d < H_loc),
                       d * n + pos, K.IMAX)
    wb = torch.arange(H_loc + 1, dtype=torch.int64, device=dev) * n
    rw = finish({
        "err": rerr,
        "ms": time_median(torch, scratch.route_rows,
                          lambda: (rows, lo, H_loc, False), 7),
        "plain_ms": time_median(torch, K.route_rows_plain,
                                lambda: (rows, lo, H_loc, False), 3),
        "library_ms": time_median(
            torch, lambda x: torch.searchsorted(torch.sort(x)[0], wb),
            lambda: (wkey,), 7),
        "bytes": rows.n * 8 + live * 8 * 2 + H_loc * 16,
        "ops": 0,
        "shape": f"S={S} rows={rows.n} live={live} to H_loc={H_loc}"})
    return rw, m2


# K13 in one process on a rank's real inputs (`two_phase_real_rows`):
# phold.yaml at S = 4 (rank 0's rows of a one-device run), phases a
# sequence, an empty outbox at step TP_EMPTY_AT
TP_S = 4
TP_PHASES = 16
TP_EMPTY_AT = 8
# the small capacities of the sequence from boot, at which rows overflow
TP_SMALL_CAPS = (4096, 2048)


def tp_raw(K, mp, counts, half):
    """Rows each buffer of a K13 half holds before its capacity's cut:
    phase 1 a rank's [g] (its own shard ships nothing), phase 2 [ng-1]
    (shard (a', b) for the other groups a')."""
    cnt = counts.view(mp.S, mp.H_loc).sum(1).tolist()
    cnt[mp.shard] = 0
    if half == 1:
        return [sum(cnt[a * mp.G + b] for a in range(mp.NG))
                for b in range(mp.G)]
    my_g, my_b = divmod(mp.shard, mp.G)
    return [cnt[a * mp.G + my_b] for a in range(mp.NG) if a != my_g]


def tp_bytes(raw, prev, cap, half, S, H_pad) -> tuple:
    """(bytes, the bytes as counted before) of a K13 half whose buffers
    hold `raw` rows before the cut and whose last pack filled `prev`
    slots: each shipped row's perm entry and channels read (five, phase
    2 also the key), the slots written (six channels: the rows and the
    fills of the slots the last pack filled and this one does not),
    each lost row's perm entry (and key) read and its counter written,
    the segment bounds; phase 2 also zeroes its [H_pad] histogram. The
    count before wrote every slot."""
    read = 6 if half == 1 else 7
    lost_b = 12 if half == 1 else 20
    shipped = sum(min(r, cap) for r in raw)
    written = sum(min(max(r, p), cap) for r, p in zip(raw, prev))
    lost = sum(max(0, r - cap) for r in raw)
    fixed = S * 16 + (0 if half == 1 else H_pad * 4)
    rest = shipped * read * 8 + lost * lost_b + fixed
    return rest + written * 48, rest + len(raw) * cap * 48


class KeptRank:
    """A mesh rank's kept K13 send buffers and fill words (the engine's
    `_wire` and `_fills`), packed by `kk`."""

    def __init__(self, torch, K, mp, dev):
        self.send1 = torch.empty((mp.G, 6, mp.CAP), dtype=torch.int64,
                                 device=dev)
        self.send2 = torch.empty((mp.NG - 1, 6, mp.CAP2),
                                 dtype=torch.int64, device=dev)
        self.f1, self.f2 = K.fill_words(self.send1), K.fill_words(self.send2)


def tp_half(torch, K, kk, half, kept, args, what, timed):
    """One K13 half on the kept buffers of `kept`: bit-equal, after the
    pack, to the plain version's fresh buffer (and x_overflow and occ_x,
    or hist); timed (`timed`) on the buffers and words as the last pack
    left them, beside the design before on a fresh buffer, which must
    write the same. `args(send, filled)` gives the launch's arguments
    (the plain version's are its first ones)."""
    send, words = (kept.send1, kept.f1) if half == 1 else \
        (kept.send2, kept.f2)
    prev = (send.clone(), words.clone())
    name = "pack_two_phase" if half == 1 else "pack_two_phase2"
    n_plain = 7 if half == 1 else 8

    def outs(x):
        # the send buffer and the counters the half writes
        return x[6], (x[0] if half == 1 else {"hist": x[7]})

    def err_of(x, y):
        (s1, c1), (s2, c2) = outs(x), outs(y)
        return max(_eq(s1, s2), max_abs_err(c1, c2, list(c1)))

    def plain_of(x):
        x = x[:n_plain]
        if half == 2:
            x[7].zero_()
        return x

    a = args(send, words)
    getattr(kk, name)(*a)
    b = plain_of(args(torch.empty_like(send), None))
    getattr(K, name + "_plain")(*b)
    torch.cuda.synchronize()
    err = err_of(a, b)
    check(err == 0.0, f"{name} ({what}) on kept buffers differs from its "
          f"plain version's fresh buffer (max abs err {err})")
    row = {"err": err, "prev": prev[1].tolist(), "filled": words.tolist()}
    if not timed:
        return row
    before = K.Kernels()
    before.designs_before = True
    c = args(torch.empty_like(send), None)
    getattr(before, name)(*c)
    torch.cuda.synchronize()
    check(err_of(c, b) == 0.0, f"{name} ({what}): the design before "
          "differs from the plain version")
    row["ms"] = time_median(torch, getattr(kk, name), lambda: args(
        prev[0].clone(), prev[1].clone()), 5)
    row["parent_ms"] = time_median(torch, getattr(before, name), lambda: (
        args(torch.empty_like(send), None)), 5)
    row["plain_ms"] = time_median(torch, getattr(K, name + "_plain"),
                                  lambda: plain_of(args(
                                      torch.empty_like(send), None)), 3)
    if half == 1:
        # the copy half as one PyTorch call: index_select of as many of
        # the rank's rows (one [5, F] block) as the pack ships
        ob, perm = a[1], a[2]
        block = torch.stack([ob[f].reshape(-1) for f in K.OB_FIELDS])
        shipped = int(sum(min(r, send.shape[-1]) for r in words.tolist()))
        idx = perm[:shipped]
        row["library_ms"] = time_median(
            torch, lambda x, i: torch.index_select(x, 1, i),
            lambda: (block, idx), 5)
    return row


def tp_sequence(torch, K, kk, mp, phases, what, timed):
    """K13's two halves on rank 0 of the mesh `mp` over `phases` (each a
    one-device outbox whose rows of rank r are hosts [r*H_loc,
    (r+1)*H_loc)), the buffers kept from phase to phase: every rank of
    rank 0's group routes its rows over H_pad and packs phase 1
    into its kept buffers; rank 0's arrivals (buffer 0 of each) take the
    keyed route and phase 2 into its kept buffers (the routes plain);
    each pack checked
    against the plain version's fresh buffer (`tp_half`). Returns the
    phases' rows (rows before the cut, fills, and where `timed` ms
    beside the design before, bounds new and as counted before)."""
    dev = phases[0]["t"].device
    H_loc, S, g = mp.H_loc, mp.S, mp.G
    ranks = [dataclasses.replace(mp, shard=r) for r in range(g)]
    kept = [KeptRank(torch, K, m, dev) for m in ranks]
    rows = []
    for i, ob in enumerate(phases):
        step = {}
        for r, m in enumerate(ranks):
            ob_r = {f: ob[f][r * H_loc:(r + 1) * H_loc] for f in
                    K.OB_FIELDS}
            # the plain route: its perm past the live rows is defined,
            # which the plain pack's gathers read (masked)
            route = K.route_rows_plain(K.Rows(ob_r), 0, mp.H_pad)

            def state():
                return {"x_overflow": torch.zeros(H_loc, dtype=torch.int32,
                                                  device=dev),
                        "occ_x": torch.zeros((1, S), dtype=torch.int32,
                                             device=dev)}

            def args(send, words, ob_r=ob_r, route=route, m=m):
                return (state(), ob_r, *route, m, send, None, words)

            h1 = tp_half(torch, K, kk, 1, kept[r], args,
                         f"{what}, phase {i}, rank {r}", timed and r == 0)
            if r == 0:
                raw = tp_raw(K, m, route[2], 1)
                step["pack_two_phase"] = {**h1, "raw": raw}
        recv1 = torch.stack([k.send1[0] for k in kept])
        rows1 = K.Rows(recv1)
        arr = K.route_rows_plain(rows1, 0, mp.H_pad, True)

        def args2(send, words):
            return (rows1, *arr, mp, ob["t"].shape[-1], send,
                    torch.empty(mp.H_pad, dtype=torch.int32, device=dev),
                    None, words)

        h2 = tp_half(torch, K, kk, 2, kept[0], args2,
                     f"{what}, phase {i}, rank 0", timed)
        step["pack_two_phase2"] = {**h2, "raw": tp_raw(K, mp, arr[2], 2)}
        for half, name in ((1, "pack_two_phase"), (2, "pack_two_phase2")):
            r = step[name]
            cap = mp.CAP if half == 1 else mp.CAP2
            r["bytes"], r["bytes_before"] = tp_bytes(
                r["raw"], r["prev"], cap, half, S, mp.H_pad)
        rows.append(step)
    return rows


def tp_phases(torch, K, engine, state, n, empty_at):
    """`n` successive phases of a one-device engine from `state` (each
    window from the next head time, the engine's own pops and judge),
    each judged outbox copied; an all-INF outbox at step `empty_at`."""
    ob, _, _ = engine._buffers()
    out = []
    for i in range(n):
        if i == empty_at:
            out.append({f: (torch.full_like(ob[f], K.INF) if f == "t"
                            else torch.zeros_like(ob[f]))
                        for f in K.OB_FIELDS})
            continue
        nt = engine.next_time(state)
        check(nt < K.INF, "tp_phases: no event left")
        # the first step arms the engine (a state from outside)
        step = engine.phase if i == 0 else engine._phase
        step(state, K.control_block(
            state["head"].device, run=1,
            win_end=nt + max(1, int(engine.config.lookahead))))
        out.append({f: ob[f].clone() for f in K.OB_FIELDS})
    return out


def tp_summary(rows, name, what, cap, S, H_pad):
    """A kernel row of a timed K13 sequence: the median over its real
    phases (the empty step left out) of ms, the design before's and the
    bounds."""
    real = [r[name] for i, r in enumerate(rows) if i != TP_EMPTY_AT]

    def med(k):
        return statistics.median(x[k] for x in real)

    r = finish({"err": max(x[name]["err"] for x in rows),
                "ms": med("ms"), "parent_ms": med("parent_ms"),
                "plain_ms": med("plain_ms"),
                "library_ms": (med("library_ms") if "library_ms" in real[0]
                               else None),
                "bytes": int(med("bytes")), "ops": 0,
                "bound_ms_as_counted_before":
                    1e3 * med("bytes_before") / HBM_BYTES_PER_S,
                "shape": f"{what}: CAP={cap} S={S} H_pad={H_pad}, median "
                         f"of {len(real)} phases (rows before the cut "
                         f"{[x['raw'] for x in real]})",
                "phases": [{k: x[name][k] for k in (
                    "raw", "prev", "filled", "ms", "parent_ms", "bytes",
                    "bytes_before") if k in x[name]} for x in rows]})
    return r


def two_phase_real_rows(torch, K, dev):
    """K13 in one process on rank 0's real inputs at phold.yaml, S = 4
    (H_loc 25,000; the rows of hosts [r*H_loc, (r+1)*H_loc) of a
    one-device run are rank r's outbox, as the mesh's parity holds):
    TP_PHASES successive phases from half way at the auto capacities
    (timed, beside the design before), and TP_PHASES from boot at
    TP_SMALL_CAPS, at which rows overflow; an empty outbox at step
    TP_EMPTY_AT of each, so that the fills shrink to 0 and return. The
    buffers are kept from phase to phase and each checked after every
    pack against the plain version's fresh buffer."""
    from shadow_tpu_torch.device import runner
    from shadow_tpu_torch.device.capacity import exchange_caps, group_split

    _, example, ovr, _ = FULL_RUNS[0]
    out = {}
    for case, caps, half_way in (
            ("auto capacities, from half way", (0, 0), True),
            (f"CAP {TP_SMALL_CAPS[0]}, CAP2 {TP_SMALL_CAPS[1]}, from "
             "boot", TP_SMALL_CAPS, False)):
        engine, sim = runner.make_engine(full_config(example, ovr),
                                         device=dev.type)
        state = engine.init_state(sim.start_times, sim.stop_times)
        stop = int(engine.config.stop_time)
        if half_way:
            engine.run(state, stop=stop // 2, final_stop=stop)
        H, OB = engine._buffers()[0]["t"].shape
        H_loc = H // TP_S
        g, ng = group_split(TP_S)
        cap, cap2, _, _ = exchange_caps("two_phase", TP_S, H_loc, OB,
                                        engine.params.E, *caps)
        mp = K.MeshParams(TP_S, 0, H_loc, "two_phase", cap, cap2, g, ng)
        phases = tp_phases(torch, K, engine, state, TP_PHASES, TP_EMPTY_AT)
        del engine, state
        rows = tp_sequence(torch, K, K.Kernels(), mp, phases,
                           f"phold.yaml S={TP_S}, {case}", half_way)
        seen = {n: [r[n]["raw"] for r in rows]
                for n in ("pack_two_phase", "pack_two_phase2")}
        if half_way:
            key = f"phold.yaml S={TP_S}, rank 0, {case}"
            out[key] = {n: tp_summary(rows, n, key, c, TP_S, mp.H_pad)
                        for n, c in (("pack_two_phase", cap),
                                     ("pack_two_phase2", cap2))}
        else:
            check(any(max(x) > cap for x in seen["pack_two_phase"]) and
                  any(max(x) > cap2 for x in seen["pack_two_phase2"]),
                  "two_phase_real_rows: no row overflowed at the small "
                  "capacities")
            out[f"phold.yaml S={TP_S}, rank 0, {case}"] = {
                n: {"err": max(r[n]["err"] for r in rows),
                    "phases": [{"raw": r[n]["raw"], "prev": r[n]["prev"]}
                               for r in rows]}
                for n in seen}
        print(f"[kernels] K13 on kept buffers, phold.yaml S={TP_S} rank "
              f"0, {case}: {len(rows)} packs a half equal to the plain "
              f"version's fresh buffers; rows a buffer before the cut "
              f"(phase 1, phase 2): "
              + ", ".join(f"{a}/{b}" for a, b in zip(
                  seen["pack_two_phase"], seen["pack_two_phase2"])),
              flush=True)
        del phases
        torch.cuda.empty_cache()
    return out


def two_phase_adversarial(torch, K, rng, dev):
    """K13's kept buffers where the fills swing most: a rank's outbox at
    the PHOLD shapes (`mesh_outbox`, S = 4) at a small CAP and CAP2, so
    that every buffer fills to its capacity, then an empty outbox (every
    slot refilled), then full again, then a tenth of the rows, each pack
    of both halves against the plain version's fresh buffers."""
    from shadow_tpu_torch.device.capacity import exchange_caps, group_split

    S, H_loc = MESH_SHAPES[1]
    g, ng = group_split(S)
    cap, cap2, _, _ = exchange_caps("two_phase", S, H_loc, MESH_OB, 64)
    mp = K.MeshParams(S, 0, H_loc, "two_phase", max(64, cap // 64),
                      max(64, cap2 // 64), g, ng)
    phases = []
    for case in ("full", "empty", "full", "a tenth"):
        # the rows of rank 0's group, rank by rank
        parts = [mesh_outbox(torch, rng, H_loc, S, r, dev)
                 for r in range(g)]
        ob = {f: torch.cat([x[f] for x in parts]) for f in K.OB_FIELDS}
        if case == "empty":
            ob["t"].fill_(K.INF)
        elif case == "a tenth":
            keep = torch.from_numpy(rng.random(tuple(ob["t"].shape))
                                    < 0.1).to(dev)
            ob["t"] = torch.where(keep, ob["t"], K.INF)
        phases.append(ob)
    rows = tp_sequence(torch, K, K.Kernels(), mp, phases,
                       "fills CAP, 0, CAP, a tenth", False)
    raw = [r["pack_two_phase"]["raw"] for r in rows]
    check(max(raw[0]) > mp.CAP and max(raw[1]) == 0 and
          max(raw[2]) > mp.CAP, f"two_phase_adversarial: fills {raw}")
    return {"fills CAP, 0, CAP, a tenth": {
        n: {"err": max(r[n]["err"] for r in rows),
            "phases": [{"raw": r[n]["raw"], "prev": r[n]["prev"]}
                       for r in rows]}
        for n in ("pack_two_phase", "pack_two_phase2")}}


def mesh_kernels(torch, K, scratch, rng, dev):
    """K12 and K13 at the PHOLD shapes (H_loc 50,000 at S = 2, 25,000 at
    S = 4, OB = 30), each at dense_auto_cap (its two_phase counterpart)
    and at a CAP small enough to overflow; K5's window and keyed modes
    and K3's second arrival block."""
    from shadow_tpu_torch.device.capacity import exchange_caps

    packs = []
    for S, H_loc in MESH_SHAPES:
        cap, _, _, _ = exchange_caps("all_to_all", S, H_loc, MESH_OB, 64)
        r = pack_case(torch, K, scratch, rng, S, H_loc, cap, dev, False)
        small = pack_case(torch, K, scratch, rng, S, H_loc,
                          max(64, cap // 64), dev, False)
        check(small["lost"] > 0 and r["lost"] == 0,
              "pack_remote: the small CAP lost nothing, or the auto CAP "
              "lost rows")
        packs.append({**r, "overflowing": small})
    out = {"pack_remote": {**packs[0], "at_S4": packs[1]}}
    S, H_loc = MESH_SHAPES[1]
    cap, cap2, _, _ = exchange_caps("two_phase", S, H_loc, MESH_OB, 64)
    tp = pack_case(torch, K, scratch, rng, S, H_loc, cap, dev, True)
    tp_small = pack_case(torch, K, scratch, rng, S, H_loc,
                         max(64, cap // 64), dev, True)
    check(tp_small["lost"] > 0, "pack_two_phase: the small CAP lost "
          "nothing")
    out["pack_two_phase"] = {**tp, "overflowing": tp_small}
    p2, rk = phase2_case(torch, K, scratch, rng, S, H_loc, cap, cap2, dev)
    p2_small, _ = phase2_case(torch, K, scratch, rng, S, H_loc, cap,
                              max(64, cap2 // 64), dev)
    check(p2_small["lost"] > 0, "pack_two_phase2: the small CAP2 lost "
          "nothing")
    out["pack_two_phase2"] = {**p2, "overflowing": p2_small}
    out["route_keyed"] = rk
    S, H_loc = MESH_SHAPES[0]
    cap, _, _, _ = exchange_caps("all_to_all", S, H_loc, MESH_OB, 64)
    out["route_window"], out["merge_heaps2"] = merge2_case(
        torch, K, scratch, rng, S, H_loc, cap, dev)
    return out


# a mesh rank's place for the kernels of the audit, the model NIC and the
# path counters on the mesh (`mesh_state_kernels`): rank 1 of phold.yaml
# at S = 2, its H_loc hosts from g0 = H_loc on, of H_pad = S * H_loc
MESH_RANK = (2, 1, 50_000)


def audit_rank_case(torch, K, scratch, rng, dev):
    """K8 in a mesh rank's mode: two ranks' seeded states (`audit_inputs`
    at H_loc, E = 64), each audited by the streamed launch that writes
    its balance and decides nothing (`audit_round_rank`), the two words
    summed (the mesh's all_sum), then the conserve pass on the sum
    (`audit_conserve`), bit-equal to the plain versions (words and
    balances), with the ranks' ledgers balanced, moved between the ranks
    (non-zero balances summing to 0: no AUD_CONSERVE, where the
    one-launch K8 on either rank alone would set it) and broken (the sum
    off by one: AUD_CONSERVE on every host of both ranks). Returns the
    two rows, timed on the balanced state (the main path's), the conserve
    pass also on the broken one."""
    S, _, H = MESH_RANK
    E = 64
    ranks = [audit_inputs(torch, K, rng, H, E, dev) for _ in range(S)]

    def moved(deltas):
        out = []
        for st, d in zip(ranks, deltas):
            st = dict(st, aud_tx=st["aud_tx"].clone())
            st["aud_tx"][0] += d
            out.append(st)
        return out

    cases = {"balanced": moved((0, 0)), "zero sum": moved((5, -5)),
             "broken": moved((5, -4))}
    err = 0.0
    for case, sts in cases.items():
        words = []
        # the kernels, then the plain versions
        for audit, conserve in (
                (scratch.audit_round, scratch.audit_conserve),
                (K.audit_round_plain, K.audit_conserve_plain)):
            got = [clone(st) for st in sts]
            bal = [torch.zeros(1, dtype=torch.int64, device=dev)
                   for _ in sts]
            for st, b in zip(got, bal):
                audit(st, balance=b)
            total = sum(bal)
            for st in got:
                conserve(st, total)
            words.append((got, torch.cat(bal)))
        torch.cuda.synchronize()
        (gk, bk), (gp, bp) = words
        e = max([max_abs_err(a, b, list(a)) for a, b in zip(gk, gp)]
                + [max_abs_err({"b": bk}, {"b": bp}, ["b"])])
        check(e == 0.0, f"audit_round_rank/audit_conserve ({case}) differ "
              f"from their plain versions (max abs err {e})")
        err = max(err, e)
        marked = [((st["aud"] & K.AUD_CONSERVE) != 0) for st in gk]
        want = case == "broken"
        check(all(bool(c.all()) == want and bool(c.any()) == want
                  for c in marked), f"audit_conserve ({case}): "
              f"AUD_CONSERVE {'not ' if want else ''}on every host")
        if case == "zero sum":
            check(bool((bk != 0).all()) and int(bk.sum()) == 0,
                  f"audit_round_rank (zero sum): balances {bk.tolist()}")
            alone = clone(sts[0])
            scratch.audit_round(alone)
            check(bool(((alone["aud"] & K.AUD_CONSERVE) != 0).all()),
                  "audit_round on one rank alone: no AUD_CONSERVE where "
                  "its own balance is not 0")
    check(scratch.launches["audit_round_rank"] > 0 and
          scratch.launches["audit_conserve"] > 0,
          "audit_round_rank or audit_conserve never launched")
    first = cases["balanced"][0]

    def rank_args():
        return (clone(first), None,
                torch.zeros(1, dtype=torch.int64, device=dev))

    def conserve_args(case):
        def make():
            st = clone(cases[case][0])
            total = torch.tensor([0 if case == "balanced" else 1],
                                 dtype=torch.int64, device=dev)
            return (st, total)
        return make

    nbytes, tied, written = audit_bytes(torch, K, first)
    rank = finish({
        "err": err,
        "ms": time_median(torch, scratch.audit_round, rank_args, 7),
        "plain_ms": time_median(torch, K.audit_round_plain, rank_args, 3),
        "library_ms": None, "bytes": nbytes + 8, "ops": 0,
        "shape": f"a mesh rank's state: H_loc={H} E={E} tied_slots={tied} "
                 f"words_written={written}; the rank's balance written, "
                 "nothing decided; balanced, zero-sum and broken ledgers "
                 f"over {S} ranks"})
    broken_ms = time_median(torch, scratch.audit_conserve,
                            conserve_args("broken"), 7)
    cons = finish({
        "err": err,
        "ms": time_median(torch, scratch.audit_conserve,
                          conserve_args("balanced"), 7),
        "plain_ms": time_median(torch, K.audit_conserve_plain,
                                conserve_args("balanced"), 3),
        # the summed word; on a broken ledger every word read and
        # written
        "library_ms": None, "bytes": 8, "ops": 0,
        "broken": finish({
            "err": err, "ms": broken_ms,
            "plain_ms": time_median(torch, K.audit_conserve_plain,
                                    conserve_args("broken"), 3),
            "bytes": 8 + H * 4 * 2, "ops": 0,
            "shape": f"H_loc={H}, the sum not 0: every word ORed"}),
        "shape": f"H_loc={H}, the sum over {S} ranks 0 (the main path's); "
                 f"a broken sum {broken_ms:.4f} ms"})
    return rank, cons


def mesh_state_kernels(torch, K, scratch, rng, dev):
    """The kernels of the audit, the model NIC and the path counters as a
    mesh rank runs them (MESH_RANK: rank 1 of 2, H_loc 50,000 of H_pad
    100,000): K8's mode that writes the rank's balance and the conserve
    pass on the summed word (`audit_rank_case`); K1_nic on the rank's
    hosts at their global ids, the bandwidth columns [H_pad] whose
    first H_loc hosts sit at 1 Gbit/s and the rank's slice at random
    rates, so that a pop reading the wrong slice differs; K7 on the
    rank's outbox, its sources the rank's global ids, its destinations
    over [0, H_pad) and a few outside (clipped to H_pad as the
    reference clips them), into the rank's row. Each bit-equal to its
    plain version."""
    from shadow_tpu_torch.device.apps import PholdDevice
    from shadow_tpu_torch.device.prng import seed_key

    S, shard, H = MESH_RANK
    H_pad, g0 = S * H, shard * H
    out = {}
    out["audit_round_rank"], out["audit_conserve"] = audit_rank_case(
        torch, K, scratch, rng, dev)
    # K1_nic on the rank's hosts
    E, win_end = 64, 10**9
    world = {
        "host_vertex": torch.from_numpy(
            rng.integers(0, 2, H_pad).astype(np.int32)).to(dev),
        "lat": torch.tensor([[3_000_000, 5_000_000],
                             [5_000_000, 3_000_000]],
                            dtype=torch.int32, device=dev),
        "rel": torch.tensor([[0.98, 0.9], [0.9, 0.98]],
                            dtype=torch.float32, device=dev),
        "epoch_times": torch.zeros(1, dtype=torch.int64, device=dev)}
    state0, world = add_nic(torch, K, rng, random_state(rng, H, E, dev),
                            world, win_end, dev)
    for k in ("bw_up", "bw_down"):
        world[k] = torch.cat([torch.full((g0,), 10**9, dtype=torch.int64,
                                         device=dev), world[k]])
    app = PholdDevice(n_hosts_total=H_pad, msgload=3, size=512, selfloop=1)
    p = K.PhaseParams(E=E, K=3, T=0, P=1, B=32 // 4, IN=E, C=1,
                      boot_end=win_end // 2, seed=seed_key(7), app=app,
                      MB=True, CP=True, g0=g0)
    c = nic_pop_case(torch, K, scratch, "pop_phase_nic", state0, world, p,
                     win_end, dev)
    out["pop_phase_nic"] = nic_row(c, H, p, f"rank {shard} of {S}, g0={g0}"
                                   f", H_pad={H_pad}: ")
    # K7 on the rank's row
    OB, V = 39, 6
    ob, _, pops = paths_outbox(torch, K, rng, H, OB, V, dev)
    gid = torch.arange(g0, g0 + H, dtype=torch.int64, device=dev)
    ob["k"] = (gid[:, None] << 32) | (ob["k"] & K.U32)
    dst = torch.from_numpy(rng.integers(-4, H_pad + 4, (H, OB))).to(dev)
    ob["m"] = (dst << 32) | (ob["m"] & K.U32)
    world7 = {"host_vertex": torch.from_numpy(
        rng.integers(0, V, H_pad).astype(np.int32)).to(dev),
        "lat": torch.zeros((V, V), dtype=torch.int32, device=dev)}
    clear = K.outbox_word(dev)
    clear[0] = 0
    rows = {}
    for case, o, pc, w in (
            ("every row", ob, None, None),
            ("the popped hosts' rows, the word clear",
             rule_outbox(torch, ob, pops), pops, clear)):
        rows[case] = paths_row(
            torch, K, scratch, o, world7, pc, w,
            f"rank {shard} of {S} (g0={g0}, H_pad={H_pad}), {case}")
    r = rows.pop("every row")
    out["count_paths"] = {**r, "rows": rows,
                          "err": max([r["err"]] + [x["err"] for x in
                                                   rows.values()])}
    return out


# ----------------------------------------------------------------------
# the exchange's kernels with a replica axis: a campaign on the mesh
# ----------------------------------------------------------------------
def stack_at(torch, vals, axis=0):
    """One argument of a batched launch from the replicas' own, stacked
    on `axis` (None: replica 0's, shared): `stack_arg` on the leading
    axis; a campaign rank's wire buffers hold the replica inside their
    peer blocks (axis 1), and a Rows' wire regions stack on 1, its
    outbox regions on 0."""
    v = vals[0]
    if axis is None:
        return v
    if hasattr(v, "regions"):
        return type(v)(*(stack_at(
            torch, [x.regions[i] for x in vals],
            0 if isinstance(v.regions[i], dict) else 1)
            for i in range(len(v.regions))))
    if axis == 0:
        return stack_arg(torch, vals)
    if isinstance(v, dict):
        return {k: torch.stack([d[k] for d in vals], axis) for k in v}
    if isinstance(v, tuple):
        return tuple(torch.stack(x, axis) for x in zip(*vals))
    return torch.stack(vals, axis)


def slice_at(x, r, axis=0):
    """Replica r's view of an output stacked on `axis`."""
    if isinstance(x, dict):
        return {k: v.select(axis, r) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(v.select(axis, r) for v in x)
    return x.select(axis, r)


def mesh_replica_kernels(torch, K, scratch, rng, dev):
    """K12, both K13 halves, K5's window and keyed modes and K3's second
    block at R = REPLICAS on a campaign rank (`replica_check` with each
    argument's replica axis: the wire buffers' inside their peer blocks), at
    the shapes of mesh_kernels: K12, the window and K3 at S = 2 (H_loc
    50,000, OB 30, the auto CAP), K13 and the keyed route at S = 4 (H_loc
    25,000); each replica's outbox its own, the keyed route over both of
    two_phase's received regions (`recv1 | recv2`), K3 with each
    replica's own segment of its outbox's route over H_pad (a strided
    view); the library call of each on the four replicas at once; the
    bound over the four replicas' inputs."""
    from shadow_tpu_torch.device.apps import PholdDevice
    from shadow_tpu_torch.device.capacity import exchange_caps, group_split
    from shadow_tpu_torch.device.engine import (STATE_DTYPES, EngineConfig,
                                                phase_params)

    R, out = REPLICAS, {}

    def ctl1():
        return K.control_block(dev, run=1, win_end=K.INF)

    def stop_run(block):
        block[K.CTL["run"]] = 0

    def route_canon(o):
        perm, starts, counts = o
        live = torch.arange(perm.shape[-1], device=dev) < \
            counts.sum(-1, keepdim=True)
        return (torch.where(live, perm, -1), starts, counts)

    def check_r4(name, fn, plain, make, axes, outs, ctl_at, **kw):
        return replica_check(torch, K, scratch, name, fn, plain, make,
                             outs, ctl_at, stop_run, axes=axes, **kw)

    # K12 at S = 2
    S, H_loc = MESH_SHAPES[0]
    cap, _, _, _ = exchange_caps("all_to_all", S, H_loc, MESH_OB, 64)
    mp = K.MeshParams(S, 0, H_loc, "all_to_all", cap, 0, 1, S)
    obs = [mesh_outbox(torch, rng, H_loc, S, 0, dev) for _ in range(R)]
    routes = [K.route_rows_plain(K.Rows(ob), 0, S * H_loc) for ob in obs]

    def pack_make(r):
        return ({"x_overflow": torch.zeros(H_loc, dtype=torch.int32,
                                           device=dev),
                 "occ_x": torch.zeros((1, S), dtype=torch.int32,
                                      device=dev)},
                obs[r], *routes[r], mp,
                torch.full((S, 6, cap), -1, dtype=torch.int64, device=dev),
                ctl1())

    row = check_r4(
        "pack_remote", scratch.pack_remote, K.pack_remote_plain,
        pack_make, (0, 0, 0, 0, 0, None, 1, 0), (0, 6), 7)
    shipped = sum(int(c.view(S, H_loc).sum(1)[1:].clamp(max=cap).sum())
                  for _, _, c in routes)
    block = torch.cat([torch.stack([ob[f].view(-1) for f in K.OB_FIELDS])
                       for ob in obs], 1)
    F = H_loc * MESH_OB
    idx = torch.cat([perm[(st.view(S, H_loc)[:, :1] + torch.arange(
        cap, device=dev)).clamp(max=F - 1).view(-1)] + r * F
        for r, (perm, st, _) in enumerate(routes)])
    out["pack_remote"] = finish({
        **row, "ms": row["ms_r4"], "plain_ms": row["plain_ms_r4"],
        "library_ms": time_median(
            torch, lambda b, i: torch.index_select(b, 1, i),
            lambda: (block, idx), 7),
        "bytes": shipped * 6 * 8 + R * S * 6 * cap * 8 + R * S * 16,
        "ops": 0,
        "shape": f"R={R} S={S} H_loc={H_loc} OB={MESH_OB} CAP={cap}, the "
                 f"send buffer [S, R, 6, CAP], shipped {shipped}"})
    # K5's window over each replica's received rows, and K3 with its own
    # rows as the second block (rank 1 of 2)
    lo = H_loc
    recvs, owns = [], []
    for r in range(R):
        recv = torch.empty((S, 6, cap), dtype=torch.int64, device=dev)
        for src in range(S):
            ob = mesh_outbox(torch, rng, H_loc, S, 0, dev)
            pr, sr, cr = K.route_rows_plain(K.Rows(ob), 0, S * H_loc)
            send = torch.empty((S, 6, cap), dtype=torch.int64, device=dev)
            K.pack_remote_plain(
                {"x_overflow": torch.zeros(H_loc, dtype=torch.int32,
                                           device=dev),
                 "occ_x": torch.zeros((1, S), dtype=torch.int32,
                                      device=dev)}, ob, pr, sr, cr,
                K.MeshParams(S, src, H_loc, "all_to_all", cap, 0, 1, S),
                send)
            recv[src] = send[1]
        recvs.append(recv)
        own = mesh_outbox(torch, rng, H_loc, S, 1, dev)
        owns.append((own, *K.route_rows_plain(K.Rows(own), 0, S * H_loc)))

    def window_make(r):
        return (K.Rows(recvs[r]), lo, H_loc, False,
                tuple(torch.full((n,), -7, dtype=torch.int64, device=dev)
                      for n in (S * cap, H_loc, H_loc)), ctl1())

    row = check_r4(
        "route_window", scratch.route_rows,
        lambda *a: _plain_route(K, *a), window_make,
        (0, None, None, None, 0, 0), (4,), 5, canon=route_canon,
        frozen_canon=lambda o: o[:2])
    live = 0
    wkeys = []
    n = S * cap
    for recv in recvs:
        f = K.Rows(recv).fields(("t", "m"))
        d = (f["m"] >> 32) - lo
        ok = (f["t"] < K.DROP_T) & (d >= 0) & (d < H_loc)
        live += int(ok.sum())
        wkeys.append(torch.where(ok, d * n + torch.arange(
            n, dtype=torch.int64, device=dev), K.IMAX))
    wkey = torch.cat(wkeys)
    wb = torch.arange(H_loc + 1, dtype=torch.int64, device=dev) * n
    out["route_window"] = finish({
        **row, "ms": row["ms_r4"], "plain_ms": row["plain_ms_r4"],
        "library_ms": time_median(
            torch, lambda x: torch.searchsorted(
                torch.sort(x, dim=-1)[0], wb.expand(R, -1).contiguous()),
            lambda: (wkey.view(R, n),), 7),
        "bytes": R * n * 8 + live * 8 * 2 + R * H_loc * 16, "ops": 0,
        "shape": f"R={R} S={S} rows={n} a replica, [S, R, 6, CAP] "
                 f"received, live {live}, to H_loc={H_loc}"})
    # K3, two blocks
    p = phase_params(EngineConfig(n_hosts=S * H_loc, event_capacity=64,
                                  outbox_capacity=MESH_OB),
                     PholdDevice(n_hosts_total=S * H_loc))
    states = [lex_sorted(torch, K, mesh_state(torch, K, rng, H_loc, S, dev))
              for _ in range(R)]
    windows = [K.route_rows_plain(K.Rows(recvs[r]), lo, H_loc)
               for r in range(R)]

    def merge_make(r):
        own, po, so, co = owns[r]
        return (clone(states[r]), K.Rows(recvs[r]), *windows[r], p,
                ctl1(), own, po, so, co)

    def merge2(st, rows, perm, starts, counts, p_, ctl, own, po, so, co):
        scratch.merge_heaps(st, rows, perm, starts, counts, p_, ctl,
                            second=(own, po, so[..., lo:lo + H_loc],
                                    co[..., lo:lo + H_loc]))

    def merge2_plain(st, rows, perm, starts, counts, p_, ctl, own, po, so,
                     co):
        K.merge_heaps_plain(st, rows, perm, starts, counts, p_, ctl,
                            (own, po, so[..., lo:lo + H_loc],
                             co[..., lo:lo + H_loc]))

    row = check_r4(
        "merge_heaps2", merge2, merge2_plain, merge_make,
        (0, 0, 0, 0, 0, None, 0, 0, 0, 0, 0), (0,), 6,
        canon=lambda st: {k: st[k] for k in STATE_DTYPES if k in st})
    E, IN = p.E, p.IN
    nbytes, cols = 0, []
    for r in range(R):
        own, po, so, co = owns[r]
        sc = (so[lo:lo + H_loc], co[lo:lo + H_loc])
        nbytes += merge_bytes(states[r], windows[r][2], E, IN, False, sc[1])
        c1 = merge_columns(torch, K, states[r],
                           K.Rows(recvs[r]).fields(K.OB_FIELDS),
                           *windows[r], IN)
        c2 = merge_columns(torch, K, {**states[r], "head": torch.full_like(
            states[r]["head"], E)}, own, po, *sc, IN)
        cols.append(tuple(torch.cat([a, b[:, E:]], 1)
                          for a, b in zip(c1, c2)))
    cols = tuple(torch.cat(x) for x in zip(*cols))
    out["merge_heaps2"] = finish({
        **row, "ms": row["ms_r4"], "plain_ms": row["plain_ms_r4"],
        "library_ms": time_median(torch, merge_library(torch, E),
                                  lambda: cols, 7),
        "bytes": nbytes, "ops": 0,
        "shape": f"R={R} H_loc={H_loc} E={E} IN={IN}, two blocks: the "
                 "received [S, R, 6, CAP] rows and each replica's own "
                 "segment of its [R, H_pad] route"})
    # K13 and the keyed route at S = 4
    S, H_loc = MESH_SHAPES[1]
    g, ng = group_split(S)
    cap, cap2, _, _ = exchange_caps("two_phase", S, H_loc, MESH_OB, 64)
    mp = K.MeshParams(S, 0, H_loc, "two_phase", cap, cap2, g, ng)
    obs = [mesh_outbox(torch, rng, H_loc, S, 0, dev) for _ in range(R)]
    routes = [K.route_rows_plain(K.Rows(ob), 0, S * H_loc) for ob in obs]

    def tp_make(r):
        send = torch.full((g, 6, cap), -1, dtype=torch.int64, device=dev)
        return ({"x_overflow": torch.zeros(H_loc, dtype=torch.int32,
                                           device=dev),
                 "occ_x": torch.zeros((1, S), dtype=torch.int32,
                                      device=dev)},
                obs[r], *routes[r], mp, send, ctl1(), K.fill_words(send))

    row = check_r4(
        "pack_two_phase", scratch.pack_two_phase,
        lambda *a: K.pack_two_phase_plain(*a[:8]), tp_make,
        (0, 0, 0, 0, 0, None, 1, 0, 1), (0, 6), 7)
    shipped = 0
    recv1s = []
    for r in range(R):
        st = tp_make(r)
        K.pack_two_phase_plain(*st[:8])
        recv1s.append(st[6])
        shipped += int((st[6][:, 0] < K.INF).sum())
    block = torch.cat([torch.stack([ob[f].view(-1) for f in K.OB_FIELDS])
                       for ob in obs], 1)
    idx = torch.arange(shipped, device=dev) % (R * H_loc * MESH_OB)
    out["pack_two_phase"] = finish({
        **row, "ms": row["ms_r4"], "plain_ms": row["plain_ms_r4"],
        "library_ms": time_median(
            torch, lambda b, i: torch.index_select(b, 1, i),
            lambda: (block, idx), 7),
        "bytes": shipped * 6 * 8 + R * g * 6 * cap * 8 + R * S * 16,
        "ops": 0,
        "shape": f"R={R} S={S} g={g} ng={ng} H_loc={H_loc} CAP={cap}, "
                 f"buffers [g, R, 6, CAP], shipped {shipped}"})
    arr1s = [K.route_rows_plain(K.Rows(x), 0, S * H_loc, True)
             for x in recv1s]

    def p2_make(r):
        send = torch.full((ng - 1, 6, cap2), -1, dtype=torch.int64,
                          device=dev)
        return (K.Rows(recv1s[r]), *arr1s[r], mp, MESH_OB, send,
                torch.zeros(S * H_loc, dtype=torch.int32, device=dev),
                ctl1(), K.fill_words(send))

    row = check_r4(
        "pack_two_phase2", scratch.pack_two_phase2,
        lambda *a: _plain_p2(K, *a), p2_make,
        (0, 0, 0, 0, None, None, 1, 0, 0, 1), (6, 7), 8)
    fwd = sum(int(a[2].view(S, H_loc)[g].sum().clamp(max=cap2))
              for a in arr1s)
    out["pack_two_phase2"] = finish({
        **row, "ms": row["ms_r4"], "plain_ms": row["plain_ms_r4"],
        "library_ms": time_median(
            torch, lambda b, i: torch.index_select(b, 1, i),
            lambda: (block, torch.arange(fwd, device=dev)
                     % (R * H_loc * MESH_OB)), 7),
        "bytes": fwd * 7 * 8 + R * (ng - 1) * 6 * cap2 * 8
        + R * S * H_loc * 4, "ops": 0,
        "shape": f"R={R} S={S} CAP2={cap2}, buffers [ng-1, R, 6, CAP2], "
                 f"hist [R, H_pad], forwarded {fwd}"})
    # the keyed window over both received regions, recv1 | recv2, to
    # shard (1, 0)'s hosts, which both regions hold rows for (the phase-1
    # rows of buffer 0 and the rows phase 2 forwards)
    lo = g * H_loc
    recv2s = []
    for r in range(R):
        a = p2_make(r)
        _plain_p2(K, *a)
        recv2s.append(a[6])

    def keyed_make(r):
        rows = K.Rows(recv1s[r], recv2s[r])
        return (rows, lo, H_loc, True,
                tuple(torch.full((m,), -7, dtype=torch.int64, device=dev)
                      for m in (rows.n, H_loc, H_loc)), ctl1())

    row = check_r4(
        "route_keyed", scratch.route_rows,
        lambda *a: _plain_route(K, *a), keyed_make,
        (0, None, None, None, 0, 0), (4,), 5, canon=route_canon,
        frozen_canon=lambda o: o[:2])
    n = keyed_make(0)[0].n
    keys, live = [], 0
    for r in range(R):
        f = K.Rows(recv1s[r], recv2s[r]).fields(("t", "m", "key"))
        d = (f["m"] >> 32) - lo
        ok = (f["t"] < K.DROP_T) & (d >= 0) & (d < H_loc)
        live += int(ok.sum())
        keys.append(torch.where(ok, f["key"], K.IMAX))
    kb = (lo + torch.arange(H_loc + 1, dtype=torch.int64, device=dev)) * (
        S * H_loc * MESH_OB)
    out["route_keyed"] = finish({
        **row, "ms": row["ms_r4"], "plain_ms": row["plain_ms_r4"],
        "library_ms": time_median(
            torch, lambda x: torch.searchsorted(
                torch.sort(x, dim=-1)[0], kb.expand(R, -1).contiguous()),
            lambda: (torch.stack(keys),), 7),
        "bytes": R * n * 3 * 8 + live * 8 + R * H_loc * 16, "ops": 0,
        "shape": f"R={R} S={S} rows={n} a replica over two regions "
                 f"(recv1 [g, R, 6, CAP] | recv2 [ng-1, R, 6, CAP2]), "
                 f"live {live}, to shard {g}'s H_loc={H_loc}"})
    return out


class RankAudit:
    """K8's rank mode in replica_check's stacking: a replica's [1]
    balance word stacked [R, 1], the wrapper's [R]."""

    def __init__(self, kernels):
        self.kernels = kernels

    def audit_round(self, state, ctl, balance):
        self.kernels.audit_round(state, ctl, balance=balance.view(-1))


def rank_replica_kernels(torch, K, scratch, rng, dev):
    """The kernels a campaign already launches with the replica as a grid
    dimension, on a mesh rank at g0 > 0 (MESH_RANK: rank 1 of 2, H_loc
    50,000 of H_pad 100,000), at R = REPLICAS against four R = 1 launches
    and the plain versions (`replica_check`): K1 on the rank's hosts at
    their global ids over the world's [H_pad] vertices, K2 on each
    replica's K1 outbox, K7 on it (ids clipped to H_pad), K8's rank mode
    (the rank's [R] balance written, nothing decided); each replica its
    own tables and seed (`vary_world`)."""
    from shadow_tpu_torch.device.apps import PholdDevice
    from shadow_tpu_torch.device.prng import seed_key

    S, shard, H = MESH_RANK
    H_pad, g0 = S * H, shard * H
    R, E, out = REPLICAS, 64, {}

    def stop_run(block):
        block[K.CTL["run"]] = 0

    world = {
        "host_vertex": torch.from_numpy(
            rng.integers(0, 2, H_pad).astype(np.int32)).to(dev),
        "lat": torch.tensor([[30_000_000, 50_000_000],
                             [50_000_000, 30_000_000]],
                            dtype=torch.int32, device=dev),
        "rel": torch.tensor([[0.98, 0.9], [0.9, 0.98]],
                            dtype=torch.float32, device=dev),
        "epoch_times": torch.zeros(1, dtype=torch.int64, device=dev)}
    worlds = [vary_world(torch, world, r, dev) for r in range(R)]
    p = K.PhaseParams(E=E, K=3, T=0, P=1, B=10, IN=E, C=1,
                      boot_end=5 * 10**8, seed=seed_key(7),
                      app=PholdDevice(n_hosts_total=H_pad, msgload=3,
                                      size=512, selfloop=1), g0=g0)
    wins = [10**9 + 10**7 * r for r in range(R)]
    states = [random_state(rng, H, E, dev) for _ in range(R)]
    OB = p.OB

    def pop_make(r):
        return (clone(states[r]),
                {f: torch.empty((H, OB), dtype=torch.int64, device=dev)
                 for f in K.OB_FIELDS},
                torch.empty(H, dtype=torch.int32, device=dev), worlds[r],
                window_block(K, wins[r], dev), p)

    out["pop_phase"] = replica_check(
        torch, K, scratch, "pop_phase (a rank, g0 > 0)", "pop",
        K.pop_plain, pop_make, (0, 1, 2), 4, stop_run)
    popped = []
    # the bounds at R = REPLICAS: each replica's bytes and operations by
    # its R = 1 row's count (phold_kernels, judge_case, paths_bytes,
    # audit_bytes), summed over the replicas
    k1 = k2 = [0, 0]
    for r in range(R):
        a = pop_make(r)
        scratch.pop(*a)
        popped.append((a[0], a[1]))
        ob = a[1]
        sends = int((ob["t"] < K.INF).sum())
        is_send = (ob["t"] < K.INF) & ((ob["m"] & 0xFF) == 2)
        packets = int(torch.where(is_send, (ob["m"] & K.U32) >> 8,
                                  0).sum())
        k1 = [k1[0] + H * OB * 8 + sends * 4 * 8 + int(a[2].sum()) * 4 * 8
              + H * 8 + H * (7 * 4 + 8) * 2 + H * 4 * 2,
              k1[1] + (2 * H + 2 * sends) * THREEFRY_OPS]
        k2 = [k2[0] + H * OB * 8 + int(is_send.sum()) * (2 * 8 + 3 * 8 + 4)
              + H * 4 * 6, k2[1] + (2 * H + 2 * packets) * THREEFRY_OPS]
    shape = f"R={R} H_loc={H} E={E} OB={OB} g0={g0}"
    out["pop_phase"].update(bytes=k1[0], ops=k1[1], shape=shape)
    finish(out["pop_phase"])

    def judge_make(r):
        return (clone(popped[r][0]), clone(popped[r][1]), worlds[r],
                window_block(K, wins[r], dev), p)

    out["judge_outbox"] = replica_check(
        torch, K, scratch, "judge_outbox (a rank, g0 > 0)", "judge_outbox",
        K.judge_outbox_plain, judge_make, (0, 1), 3, stop_run)
    out["judge_outbox"].update(bytes=k2[0], ops=k2[1], shape=shape)
    finish(out["judge_outbox"])
    judged = []
    for r in range(R):
        a = judge_make(r)
        scratch.judge_outbox(*a)
        judged.append(a[1])

    def paths_make(r):
        return ({"path_cnt": torch.zeros((1, 4), dtype=torch.int64,
                                         device=dev)},
                clone(judged[r]), worlds[r], window_block(K, wins[r], dev))

    out["count_paths"] = replica_check(
        torch, K, scratch, "count_paths (a rank, g0 > 0)", "count_paths",
        K.count_paths_plain, paths_make, (0,), 3, stop_run)
    out["count_paths"].update(
        bytes=sum(paths_bytes(K, judged[r], worlds[r], None, True)[0]
                  for r in range(R)), ops=0, shape=shape)
    finish(out["count_paths"])
    aud = [audit_inputs(torch, K, rng, H, E, dev) for _ in range(R)]

    def audit_make(r):
        return (clone(aud[r]), K.control_block(dev, round_end=1, run=1),
                torch.zeros(1, dtype=torch.int64, device=dev))

    def stop_round(block):
        block[K.CTL["round_end"]] = 0

    out["audit_round_rank"] = replica_check(
        torch, K, RankAudit(scratch), "audit_round_rank (a rank)",
        "audit_round", lambda st, c, b: K.audit_round_plain(
            st, c, b.view(-1)), audit_make, (0, 2), 1, stop_round)
    out["audit_round_rank"].update(
        bytes=sum(audit_bytes(torch, K, aud[r])[0] for r in range(R)),
        ops=0, shape=f"R={R} H_loc={H} E={E}")
    finish(out["audit_round_rank"])
    return {f"{k} on a rank (g0={g0}, H_pad={H_pad})": v
            for k, v in out.items()}


def _plain_route(K, rows, lo, nd, keyed, out_, ctl):
    """K5's plain version into `out_`, for each replica whose control
    block runs (`Kernels.route_rows` on the CPU does the same)."""
    R = rows.replicas
    for r in range(R or 1):
        if int((ctl[r] if R else ctl)[K.CTL["run"]]):
            res = K.route_rows_plain(rows.at(r) if R else rows, lo, nd,
                                     keyed)
            for o, x in zip(out_, res):
                (o[r] if R else o).copy_(x)


def _plain_p2(K, rows, perm, starts, counts, mp, OB, send, hist, ctl,
              filled=None):
    hist.zero_()
    K.pack_two_phase2_plain(rows, perm, starts, counts, mp, OB, send, hist,
                            ctl)


def kernels_phase(torch, report, H=100_000, dev="cuda"):
    from shadow_tpu_torch.device import kernels as K

    dev = torch.device(dev)
    rng = np.random.default_rng(20261017)
    scratch = K.Kernels()      # comparison launches: not the main path's
    phold = phold_kernels(torch, K, scratch, rng, H, dev)
    tgen = tgen_kernels(torch, K, scratch, rng, H, dev)
    tor = tor_kernels(torch, K, scratch, rng, dev)
    route = {"phold": route_case(torch, K, scratch, rng, H, 30, 64, dev),
             "tgen": route_case(torch, K, scratch, rng, 10_000, 36, 48,
                                dev),
             "tor": route_case(torch, K, scratch, rng, 56_000, 36, 64,
                               dev)}
    hier = hier_kernels(torch, K, scratch, rng, dev)
    nic = nic_kernels(torch, K, scratch, rng, dev)
    epochs = epoch_kernels(torch, K, scratch, rng, dev)
    hier_faults = hier_fault_kernels(torch, K, scratch, rng, dev)
    paths = count_paths_case(torch, K, scratch, rng, dev)
    loop = loop_kernels(torch, K, scratch, rng, dev)
    replicas = replica_kernels(torch, K, scratch, rng, dev)
    judge = judge_batch_kernels(torch, K, scratch, rng, dev)
    compact, compact_r4 = compact_kernels(torch, K, scratch, rng, dev)
    replicas.update(compact_r4)
    mesh = mesh_kernels(torch, K, scratch, rng, dev)
    mesh_state = mesh_state_kernels(torch, K, scratch, rng, dev)
    replicas.update(mesh_replica_kernels(torch, K, scratch, rng, dev))
    replicas.update(rank_replica_kernels(torch, K, scratch, rng, dev))
    adversarial = flush_adversarial(torch, K, scratch, rng, dev)
    real, outbox_adv = real_phase_rows(torch, K, scratch, dev)
    real.update(audit_real_rows(torch, K, dev))
    real.update(compact_real_rows(torch, K, dev))
    real.update(paths_real_rows(torch, K, dev))
    real.update(two_phase_real_rows(torch, K, dev))
    adversarial.update(outbox_adv)
    adversarial.update(two_phase_adversarial(torch, K, rng, dev))
    flush = {}
    for where, cases in (("adversarial", adversarial),
                         ("on_real_phases", real)):
        for case, rows in cases.items():
            for kname, r in rows.items():
                if "ms" not in r:
                    # K13's untimed sequences: every pack checked
                    print(f"[kernels] {kname} ({where.replace('_', ' ')}: "
                          f"{case}): equal to plain on kept buffers (max "
                          f"abs err {r['err']}); fills (rows before the "
                          f"cut, the last pack's) "
                          + ", ".join(f"{x['raw']}<-{x['prev']}"
                                      for x in r["phases"]), flush=True)
                else:
                    report_line(f"{kname} ({where.replace('_', ' ')}: "
                                f"{case})", r)
                if "bound_ms_as_counted_before" in r:
                    print(f"[kernels] {kname} ({case}): bound as counted "
                          f"before {r['bound_ms_as_counted_before']:.4f} "
                          "ms", flush=True)
                if "shares" in r:
                    print(f"[kernels] {kname} ({case}): hosts left as "
                          f"they are {r['shares']['unchanged']:.4f}, "
                          f"merged {r['shares']['merged']:.4f}, sorted "
                          f"in full {r['shares']['full_sort']:.4f}; "
                          f"checking every heap {r['checked_ms']:.4f} ms "
                          f"(bound {1e3 * r['checked_bytes'] / HBM_BYTES_PER_S:.4f} ms)",
                          flush=True)
                if "tally_shares" in r or "parent_ms" in r:
                    print(f"[kernels] {kname} ({case}): "
                          + (f"hosts whose rows are read "
                             f"{r['tally_shares']['read']:.4f}; "
                             if "tally_shares" in r else "")
                          + ", ".join(f"{k.replace('_', ' ')} "
                                      f"{r[k]:.4f} ms" for k in (
                                          "parent_ms", "every_host_ms",
                                          "apart_ms", "by_pops_ms",
                                          "every_row_ms")
                                      if k in r), flush=True)
                if "outbox_shares" in r:
                    sh = r["outbox_shares"]
                    extra = ", ".join(
                        f"{k.replace('_', ' ')} {v:.4f} ms"
                        for k, v in r.items() if k.endswith("_ms")
                        and k not in ("ms", "plain_ms", "bound_ms"))
                    print(f"[kernels] {kname} ({case}): hosts popped "
                          f"{sh['popped']:.4f}, rows cleared "
                          f"{sh['cleared']:.4f}, left {sh['left']:.4f}; "
                          f"{extra}", flush=True)
                sub = flush.setdefault(kname, {}).setdefault(
                    where, {"err": 0.0, "rows": {}})
                sub["rows"][case] = r
                sub["err"] = max(sub["err"], r["err"])
    for name, r in phold.items():
        report_line(f"{name} (PHOLD shapes)", r)
    for name, r in tgen.items():
        report_line(f"{name} (tgen shapes)", r)
    for name, r in tor.items():
        report_line(f"{name} (Tor shapes)", r)
    for name, r in hier.items():
        report_line(f"{name} (examples/tgen_1000000.yaml's factored "
                    f"tables, hub loss {PHOLD_1M_HUB_LOSS})", r)
    for name, r in (("pop_tgen", tgen["pop_tgen"]),
                    ("pop_tor", tor["pop_tor"])):
        f = r["on_factored_tables"]
        print(f"[kernels] {name}{K.HIER}: equal to plain (max abs err "
              f"{f['err']}) at its shapes on a factored 6-vertex star; "
              f"kernel {f['ms']:.4f} ms, plain {f['plain_ms']:.4f} ms",
              flush=True)
    for shape, r in route.items():
        report_line(f"route ({shape} shape)", r)
    for name, r in nic.items():
        report_line(f"{name} (model NIC)", r)
    for name, r in epochs.items():
        report_line(f"{name} (tgen shapes, {len(EPOCH_TIMES)} epochs)", r)
    for name, r in hier_faults.items():
        report_line(f"{name} (phold_1m_hier_faults' tables, "
                    f"{len(EPOCH_TIMES)} epochs)", r)
    report_line("count_paths", paths)
    print(f"[kernels] count_paths: the design before "
          f"{paths['parent_ms']:.4f} ms", flush=True)
    for case, r in paths["synthetic"]["rows"].items():
        report_line(f"count_paths ({case})", r)
        print(f"[kernels] count_paths ({case}): the design before "
              f"{r['parent_ms']:.4f} ms, bound as counted before "
              f"{r['bound_ms_as_counted_before']:.4f} ms"
              + (f", by the pop counts {r['by_pops_ms']:.4f} ms, a "
                 f"thread a row {r['every_row_ms']:.4f} ms"
                 if "every_row_ms" in r else ""), flush=True)
    for name, r in loop.items():
        report_line(name, r)
    report_line("audit_round", loop["audit_round"]["at_1m_hosts"])
    for h, r in loop["audit_round"]["odd_e"].items():
        if h != "err":
            report_line(f"audit_round (one word a load, {h})", r)
    for name, r in judge.items():
        report_line(f"{name} (a batch of {JUDGE_N} packets)", r)
        o = r["outside"]
        print(f"[kernels] {name}: the design before {r['parent_ms']:.4f} "
              f"ms; {o['packets']} packets, {o['senders_outside']} of "
              f"their senders outside [0, H): both designs equal to plain "
              f"(max abs err {o['err']}), {o['dropped_of_those']} of "
              "those senders' packets dropped", flush=True)
    for name, r in compact.items():
        report_line(f"{name} (PHOLD shapes)", r)
        report_line(f"{name} (PHOLD shapes)", r["at_cx16"])
        for ob, w in r["wider_rows"].items():
            if ob != "err":
                report_line(f"{name} (rows of {ob})", w)
    for name, r in mesh.items():
        report_line(f"{name} (a mesh rank, PHOLD shapes)", r)
        for k, sub in r.items():
            if isinstance(sub, dict) and "err" in sub:
                report_line(f"{name} ({k})", sub)
                if isinstance(sub.get("overflowing"), dict):
                    report_line(f"{name} ({k}, overflowing)",
                                sub["overflowing"])
    for name, r in mesh_state.items():
        report_line(f"{name} (a mesh rank: the audit, the model NIC and "
                    f"the path counters)", r)
        for case, sub in (r.get("rows") or {}).items():
            report_line(f"{name} (a mesh rank, {case})", sub)
        if "broken" in r:
            report_line(f"{name} (a mesh rank, the sum not 0)", r["broken"])
    for name, r in replicas.items():
        print(f"[kernels] {name} at R={r['R']}: equal to {r['R']} "
              f"launches at R=1 and to its plain version (max abs err "
              f"{r['err']}); a replica whose control block stops it "
              f"keeps every byte; R=1 {r['ms_r1']:.4f} ms, R={r['R']} "
              f"{r['ms_r4']:.4f} ms, plain at R={r['R']} "
              f"{r['plain_ms_r4']:.4f} ms"
              + (f", bound at R={r['R']} {r['bound_ms']:.4f} ms (by "
                 f"{r.get('bound_by', 'bytes')}: {r.get('bytes')} B, "
                 f"{r.get('ops', 0)} integer operations)"
                 if "bound_ms" in r else "")
              + (f", library call at R={r['R']} {r['library_ms']:.4f} ms"
                 if r.get("library_ms") is not None else "")
              + (f"; {r['shape']}" if "shape" in r else ""), flush=True)
    report["_replicas"] = replicas
    report.update({**nic, **epochs, **hier_faults, **loop, **judge,
                   **compact, **mesh, "count_paths": paths})
    report.update({
        "pop_phase": phold["pop_phase"], "pop_tgen": tgen["pop_tgen"],
        "pop_tor": tor["pop_tor"], **hier,
        "pop_phase_aud": phold["pop_phase_aud"],
        "pop_tgen_aud": tgen["pop_tgen_aud"],
        "pop_tor_aud": tor["pop_tor_aud"],
        "judge_outbox": {**phold["judge_outbox"],
                         "at_tgen_shape": tgen["judge_outbox"],
                         "at_tor_shape": tor["judge_outbox"]},
        "merge_heaps": {**phold["merge_heaps"],
                        "at_tgen_shape": tgen["merge_heaps"],
                        "at_tor_shape": tor["merge_heaps"],
                        **flush["merge_heaps"]},
        "route": {**route["phold"], "at_tgen_shape": route["tgen"],
                  "at_tor_shape": route["tor"], **flush["route"]}})
    # the pops' and K2's real-phase and adversarial rows
    for kname, sub in flush.items():
        if kname.startswith(("pop_", "judge_outbox", "phase_tally",
                             "loop_control", "audit_round",
                             "compact_outbox", "count_paths",
                             "pack_two_phase")):
            report[kname].update(sub)
    report["route_keyed"]["adversarial"] = flush["route_keyed"][
        "adversarial"]
    # the audit, the model NIC and the path counters on a mesh rank
    report["audit_round_rank"] = mesh_state["audit_round_rank"]
    report["audit_conserve"] = mesh_state["audit_conserve"]
    for name in ("pop_phase_nic", "count_paths"):
        report[name]["on_a_mesh_rank"] = mesh_state[name]


def same_run(a, b, what, names=("card", "cpu")):
    for field in ("events_executed", "packets_sent", "packets_dropped",
                  "packets_delivered", "downloads_completed", "rounds",
                  "ok", "path_packets"):
        check(getattr(a, field) == getattr(b, field),
              f"parity ({what}): {field} {names[0]} {getattr(a, field)} "
              f"!= {names[1]} {getattr(b, field)}")
    check(np.array_equal(a.host_events_executed, b.host_events_executed),
          f"parity ({what}): per-host events_executed differ")
    check(np.array_equal(a.host_trace_checksum, b.host_trace_checksum),
          f"parity ({what}): per-host trace_checksum differ")
    check(a.ok and a.events_executed > 0, f"parity run ({what}) failed")


def same_leaves(a, b, what, names):
    """Every leaf of run `a`'s final state (a dict of numpy arrays)
    equal in run `b`'s (which may hold more: the audit's)."""
    for k, v in a.items():
        check(np.array_equal(v, b[k]),
              f"parity ({what}): state leaf {k} {names[0]} != {names[1]}")


def engine_run(cfg, device, loop="run", kernels=None):
    """(stats, final leaves as numpy arrays) of a config run by the
    engine's `loop` method: "run" (its own loop: the captured graph on
    the card) or "run_python" (the Python loop)."""
    from shadow_tpu_torch.device import runner
    from shadow_tpu_torch.device.engine import state_to_numpy

    engine, sim = runner.make_engine(cfg, device, kernels=kernels)
    state = engine.init_state(sim.start_times, sim.stop_times)
    t0 = time.perf_counter()
    state, rounds = getattr(engine, loop)(state)
    return (runner.summarize(cfg, engine, state, rounds, t0),
            state_to_numpy(state))


def cfg_from(source, pre=(), x=()):
    """A config from YAML text or a file under examples/, with the
    overrides `pre` then `x`; `functools.partial(cfg_from, source, pre)`
    is a loader that pickles, for the CPU oracles' worker processes."""
    from shadow_tpu_torch.config import load_config, load_config_str

    if "\n" not in source:
        return load_config(os.path.join(REPO, "examples", source),
                           [*pre, *x])
    return load_config_str(source, [*pre, *x])


def loader(source, *pre):
    return functools.partial(cfg_from, source, pre)


# ----------------------------------------------------------------------
# the CPU oracles: the CPU plain path's runs that the card's runs are
# held to, started before the build, in worker processes (the mesh's CPU
# ranks from threads of their own) at a lower priority, so that they run
# beside the build, the kernels phase and the parity phase (the kernels
# phase times its kernels behind a sleeping card, so the host's load does
# not reach a kernel's ms; its plain versions' host-bound ms may grow);
# a phase run without them (`--phases`) computes its own
# ----------------------------------------------------------------------
ORACLE_WORKERS = 4
ORACLES = None


def cpu_job(spec):
    """One CPU oracle: ("engine", loader) the engine's run (stats,
    leaves); ("campaign", loader) the campaign's stats, final leaves
    and loop records; ("controller", loader) a Controller run on the
    CPU (stats, the event trace); ("simulate", example, overrides)
    `cli.simulate` on the CPU; ("compact", key, loader) the
    compaction's runs (`compact_cpu`); ("mesh", S, [config]) the
    configs on S CPU ranks with their leaves."""
    from shadow_tpu_torch import cli
    from shadow_tpu_torch.device import runner

    kind, *args = spec
    if kind == "engine":
        return engine_run(args[0](), "cpu")
    if kind == "campaign":
        stats, er = run_config(args[0](), "cpu")
        return stats, {"final_state": er.final_state,
                       "rounds": er.loop_stats[0]["rounds"]}
    if kind == "controller":
        trace = []
        stats, _ = controller_run(args[0](), "cpu", trace=trace)
        return stats, trace
    if kind == "simulate":
        return cli.simulate(os.path.join(REPO, "examples", args[0]),
                            args[1], device="cpu")
    if kind == "compact":
        return compact_cpu(*args)
    if kind == "mesh":
        return runner.mesh_runs(["cpu"] * args[0], args[1], True)
    raise ValueError(f"unknown CPU oracle {kind}")


# the oracles' niceness (the lowest priority): the card's process keeps
# its cores
ORACLE_NICE = 19


def _oracle_worker():
    os.nice(ORACLE_NICE)
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    import torch

    torch.set_num_threads(1)


def timed_cpu_job(spec):
    """cpu_job(spec) with its start and end on the wall clock (seconds
    since the epoch, comparable across processes)."""
    t0 = time.time()
    out = cpu_job(spec)
    return t0, time.time(), out


def _oracle_thread_job(spec):
    # on Linux a thread's niceness is its own, and the rank processes
    # it starts inherit it
    os.nice(ORACLE_NICE)
    return timed_cpu_job(spec)


class Oracles:
    """CPU oracles running beside the card, at a lower priority: `start`
    submits one under a key, `result` waits for it (the seconds waited
    summed in `waited_s`; each read's times kept in `times`), `finish`
    for all; `close` stops what still runs."""

    def __init__(self, workers=ORACLE_WORKERS):
        import concurrent.futures as cf
        import multiprocessing as mp

        self.pool = cf.ProcessPoolExecutor(
            workers, mp_context=mp.get_context("spawn"),
            initializer=_oracle_worker)
        self.thread = cf.ThreadPoolExecutor(2)
        self.jobs = {}
        self.waited_s = 0.0
        # key -> (start, end, read, waited): seconds since the oracles
        # started, the seconds the reader waited
        self.times = {}
        self.t0 = time.time()

    def start(self, key, spec):
        if spec[0] == "mesh":
            self.jobs[key] = self.thread.submit(_oracle_thread_job, spec)
        else:
            self.jobs[key] = self.pool.submit(timed_cpu_job, spec)

    def finish(self) -> float:
        """Waits until every started oracle has ended (so that nothing
        runs beside the phases that time walls); the seconds waited."""
        import concurrent.futures as cf

        t0 = time.perf_counter()
        cf.wait(list(self.jobs.values()))
        return time.perf_counter() - t0

    def result(self, key):
        t0 = time.perf_counter()
        start, end, out = self.jobs.pop(key).result()
        waited = time.perf_counter() - t0
        self.waited_s += waited
        self.times[key] = (start - self.t0, end - self.t0,
                           time.time() - self.t0, waited)
        return out

    def report(self) -> None:
        """One line an oracle, in the order they were read: when it ran
        and how long the phase that read it waited for it."""
        for key, (start, end, read, waited) in self.times.items():
            print(f"[oracles] {key}: ran {end - start:.1f} s (+{start:.1f} "
                  f"to +{end:.1f} s), read at +{read:.1f} s, waited "
                  f"{waited:.1f} s", flush=True)

    def close(self):
        for f in self.jobs.values():
            f.cancel()
        procs = list((getattr(self.pool, "_processes", None) or {})
                     .values())
        self.pool.shutdown(wait=False, cancel_futures=True)
        for p in procs:
            if p.is_alive():
                p.terminate()
        self.thread.shutdown(wait=False, cancel_futures=True)


def oracle(key, spec):
    """The CPU oracle `spec` (`cpu_job`): from the background where it
    was started there, else run here."""
    if ORACLES is not None and key in ORACLES.jobs:
        return ORACLES.result(key)
    return cpu_job(spec)


def start_oracles(phases) -> None:
    """Start the CPU oracles of the selected phases, the mesh's first
    (in threads), then the compactions' (the longest: 106 and 175 s on
    an H100 80GB HBM3 host at 700 W beside the kernels phase, PERF.md),
    then in the order the phases read them. Every process started from
    here on takes one intra-op thread (OMP_NUM_THREADS): the oracles'
    tensors are small, and more threads only crowd the card's
    process."""
    global ORACLES
    jobs = []
    if "parity" in phases:
        jobs += [(f"loop:{key}", ("engine", load))
                 for key, _, load, _ in PARITY_LOOPS + STAR_LOOPS
                 + NIC_FAULT_LOOPS]
        jobs += [(f"campaign:{key}", ("campaign", load))
                 for key, _, load, _ in CAMPAIGN_PARITY]
        for key, _, source, overrides in HYBRID_PARITY:
            jobs += [(f"hybrid:{key}", ("controller", loader(
                         source, *overrides, MIN_BATCH_0))),
                     # the serial policy touches no device
                     (f"serial:{key}", ("controller", loader(
                         source, *overrides, *SERIAL_TWIN)))]
        jobs += [(f"compact:{key}", ("compact", key, load))
                 for key, _, load in COMPACT_LOADS]
    if "full" in phases:
        jobs.append(("serial:full_hybrid_phold", (
            "simulate", "phold.yaml", HYB_FULL_OVERRIDES + (SERIAL,))))
    if "mesh" in phases:
        jobs += [(f"mesh:{S}", ("mesh", S, list(cfgs.values())))
                 for S, cfgs in mesh_cpu_configs().items()]
    if not jobs:
        return
    os.environ["OMP_NUM_THREADS"] = "1"
    ORACLES = Oracles()
    for key, spec in sorted(jobs, key=lambda j: (
            not j[0].startswith("mesh:"), not j[0].startswith("compact:"))):
        ORACLES.start(key, spec)


def loop_parity(torch, report, key, what, load, path=()):
    """One parity config: the window loop captured on the card (the
    engine's own loop) against the Python loop on the card and the CPU
    plain path, on every statistic and every state leaf; then the
    audited graph run: the same, with a zero word. Records both graph
    runs' launches; checks the graph run launched `path`. Returns the
    four runs' stats and the graph run's Kernels."""
    from shadow_tpu_torch.device.kernels import Kernels

    kernels, aud_kernels = Kernels(), Kernels()
    # the Python loop in timing mode: each kernel's device ms over its
    # launches in this config
    py_kernels = Kernels(timing=True)
    gpu, gpu_leaves = engine_run(load(), "cuda", kernels=kernels)
    py, py_leaves = engine_run(load(), "cuda", "run_python",
                               kernels=py_kernels)
    cpu, cpu_leaves = oracle(f"loop:{key}", ("engine", load))
    aud, aud_leaves = engine_run(load([AUDIT]), "cuda", kernels=aud_kernels)
    check((gpu.loop, py.loop, aud.loop) == ("graph", "python", "graph"),
          f"parity ({what}): loops {gpu.loop}, {py.loop}, {aud.loop}")
    for other, leaves, names in (
            (cpu, cpu_leaves, ("card graph", "cpu")),
            (py, py_leaves, ("card graph", "card python")),
            (aud, aud_leaves, ("card graph", "card graph audited"))):
        same_run(gpu, other, what, names)
        same_leaves(gpu_leaves, leaves, what, names)
    check(not aud_leaves["aud"].any(), f"parity ({what}): the "
          "audited run's word is not zero")
    for k in path + ("loop_control_tally",):
        check(kernels.launches[k] > 0, f"parity ({what}): {k} never "
              "launched")
    check(aud_kernels.launches["audit_round"] > 0, f"parity ({what}): "
          "audit_round never launched")
    runs = report.setdefault("_parity", {})
    runs[f"parity_{key}"] = {"launches": dict(kernels.launches)}
    runs[f"parity_{key}_audit"] = {"launches": dict(aud_kernels.launches)}
    timed = {k: (n, v) for k, v in py_kernels.kernel_ms().items()
             if (n := py_kernels.launches[k])}
    runs[f"parity_{key}"]["python_loop_device_ms"] = {
        k: v for k, (_, v) in timed.items()}
    print(f"[parity] {what}: the Python loop's device ms (timing mode): "
          + ", ".join(f"{k} {v:.3f} over {n}" for k, (n, v) in sorted(
              timed.items(), key=lambda x: -x[1][1])), flush=True)
    print(f"[parity] {what}: card graph == card python == cpu plain "
          f"path == card graph audited (zero word): {gpu.summary()}; "
          f"card graph wall {gpu.wall_s:.3f} s ({gpu.phases} phases, "
          f"{gpu.host_syncs} host syncs), card python wall "
          f"{py.wall_s:.3f} s ({py.host_syncs} host syncs), audited "
          f"{aud.wall_s:.3f} s, cpu wall {cpu.wall_s:.3f} s", flush=True)
    return gpu, py, cpu, aud, kernels


# the model NIC, link faults and path counters: (key, what, loader,
# the kernels the card's run must launch)
NIC_FAULT_LOOPS = (
    ("nic_phold", "PHOLD 16 hosts, model NIC 2 Mbit, loss 0.05, "
     "count_paths, 3 s", loader(NIC_PHOLD_YAML),
     ("pop_phase_nic", "count_paths")),
    ("nic_tgen", "tgen 1 server + 20 clients, loss 0.1, model NIC, server "
     "uplink 20 Mbit, clients' downlink 2 Mbit, 3 s", loader(NIC_TGEN_YAML),
     ("pop_tgen_nic",)),
    ("nic_tor", "Tor 16 relays + 32 clients, loss 0.05, model NIC, "
     "clients' downlink 1 Mbit, 8 s", loader(NIC_TOR_YAML),
     ("pop_tor_nic",)),
    ("faults_dense", "tgen 1 server + 3 clients, link faults (degrade, "
     "link_down, link_up), count_paths, 8 s", loader(FAULT_YAML),
     ("pop_tgen_ep", "judge_outbox_ep", "count_paths")),
    ("faults_hier", "examples/tgen_faults_hier.yaml, its link faults "
     f"alone, {FAULTS_HIER_STOP}",
     loader("tgen_faults_hier.yaml", *FAULTS_HIER),
     ("pop_tgen_ep_hier", "judge_outbox_ep_hier")))


def nic_fault_parity(torch, report):
    """The model NIC, link faults and path counters, three ways and
    audited (`loop_parity`), and factored against dense tables."""
    from shadow_tpu_torch.device import runner

    for key, what, load, path in NIC_FAULT_LOOPS:
        gpu, _, _, _, kernels = loop_parity(torch, report, key, what, load,
                                            path)
        if key == "faults_hier":
            dense = runner.run(load([
                "network.topology.representation=dense"]), device="cuda")
            same_run(gpu, dense, what, ("card hierarchical", "card dense"))
            print(f"[parity] {what}: card hierarchical == card dense "
                  f"(wall {dense.wall_s:.3f} s)", flush=True)
        if gpu.path_packets is not None:
            print(f"[parity] {what}: {sum(gpu.path_packets.values())} "
                  f"packets on {len(gpu.path_packets)} vertex pairs",
                  flush=True)
        print(f"[parity] {what}: launches "
              + ", ".join(f"{k} {kernels.launches[k]}" for k in path),
              flush=True)
        check(gpu.packets_dropped > 0, f"parity ({what}): no drop")


def corrupt(name, arrays):
    """tests/test_torch_audit.py's `corrupt`: a copy of a paused
    state's leaves with one seeded corruption."""
    a = {k: np.array(v, copy=True) for k, v in arrays.items()}
    ht = a["ht"]
    E = ht.shape[1]
    inf = 1 << 62
    live = (ht < inf).sum(-1)
    busiest = int(np.argmax(live))
    if name == "counter":
        a["n_sent"][0] = -7
    elif name == "heap_swap":
        later = np.where((ht > ht[:, :1]) & (ht < inf), ht, inf)
        h, j = np.unravel_index(int(np.argmin(later)), ht.shape)
        for f in ("ht", "hk", "hm", "hv", "hw"):
            a[f][h, [0, j]] = a[f][h, [j, 0]]
    elif name == "head":
        a["head"][busiest] = E + 3
    elif name == "clock":
        a["aud_t"][busiest] = ht[busiest, 0] + 1
    elif name == "lost_row":
        j = int(live[busiest]) - 1
        a["ht"][busiest, j], a["hk"][busiest, j] = inf, (1 << 63) - 1
        for f in ("hm", "hv", "hw"):
            a[f][busiest, j] = 0
    return a


def audit_parity(torch, report):
    """The state audit on the card: BUSY_YAML paused at CORRUPT_PAUSE
    (windows clamped to its stop time) on the card and on the CPU, the
    paused states equal; each seeded corruption of it run on to
    CORRUPT_RESUME by the graph loop on the card and the Python loop on
    the CPU, every leaf and the words equal and each word tripping its
    invariant; and the card's paused run resumed to the stop time equal
    to an unpaused one."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner
    from shadow_tpu_torch.device.engine import (
        state_from_numpy,
        state_to_numpy,
    )
    from shadow_tpu_torch.device.kernels import Kernels
    from shadow_tpu_torch.device.supervise import decode_audit

    cfg = load_config_str(BUSY_YAML, [AUDIT])
    kernels = Kernels()
    card, sim = runner.make_engine(cfg, "cuda", kernels=kernels)
    cpu, _ = runner.make_engine(cfg, "cpu")

    def fresh(engine):
        return engine.init_state(sim.start_times, sim.stop_times)

    paused, r1 = card.run(fresh(card), CORRUPT_PAUSE, CORRUPT_STOP)
    mid = state_to_numpy(paused)
    cpu_mid, cpu_r1 = cpu.run(fresh(cpu), CORRUPT_PAUSE, CORRUPT_STOP)
    check(r1 == cpu_r1 and all(np.array_equal(v, cpu_mid[k].numpy())
                               for k, v in mid.items()),
          "audit parity: the paused states differ")
    words = {}
    for name, trips in CORRUPTIONS.items():
        arrays = corrupt(name, mid)
        g, rg = card.run(state_from_numpy(arrays, "cuda"), CORRUPT_RESUME,
                         CORRUPT_STOP)
        c, rc = cpu.run(state_from_numpy(arrays, "cpu"), CORRUPT_RESUME,
                        CORRUPT_STOP)
        check(card.loop_stats["loop"] == "graph", "audit parity: not the "
              "graph loop")
        g = state_to_numpy(g)
        for k, v in g.items():
            check(rg == rc and np.array_equal(v, c[k].numpy()),
                  f"audit parity ({name}): leaf {k} card != cpu")
        word = int(np.bitwise_or.reduce(g["aud"]))
        check(trips in decode_audit(word), f"audit parity ({name}): word "
              f"{word} does not name {trips}")
        words[name] = (int((g["aud"] != 0).sum()), decode_audit(word))
    resumed, r2 = card.run(paused, CORRUPT_STOP, CORRUPT_STOP)
    whole, rw = card.run(fresh(card), CORRUPT_STOP, CORRUPT_STOP)
    resumed, whole = state_to_numpy(resumed), state_to_numpy(whole)
    check(r1 + r2 == rw and all(np.array_equal(v, whole[k])
                                for k, v in resumed.items()),
          "audit parity: paused and resumed != unpaused")
    check(not whole["aud"].any(), "audit parity: unpaused word not zero")
    report.setdefault("_parity", {})["parity_corruptions"] = {
        "launches": dict(kernels.launches)}
    print(f"[parity] state audit, BUSY_YAML (16 hosts) paused at "
          f"{CORRUPT_PAUSE} ns: card == cpu; corruptions run on to "
          f"{CORRUPT_RESUME} ns, card graph == cpu plain path, words "
          + "; ".join(f"{k}: {n} host(s) {v}" for k, (n, v) in
                      words.items())
          + f"; paused at {CORRUPT_PAUSE} ns and resumed == unpaused "
          f"({rw} rounds, zero word)", flush=True)


# ----------------------------------------------------------------------
# the hybrid policy (K10) and the outbox compaction (K11) on the main
# path
# ----------------------------------------------------------------------
# tests/test_hybrid.py's lossy PHOLD: 8 + 8 hosts on a 2-vertex graph,
# loss 0.02, msgload 3, 2 s
HYB_PHOLD_YAML = """
general: {stop_time: 2s, seed: 7}
network:
  graph:
    type: gml
    inline: |
      graph [ directed 0
        node [ id 0 bandwidth_down "100 Mbit" bandwidth_up "100 Mbit" ]
        node [ id 1 bandwidth_down "100 Mbit" bandwidth_up "100 Mbit" ]
        edge [ source 0 target 0 latency "10 ms" packet_loss 0.02 ]
        edge [ source 0 target 1 latency "25 ms" packet_loss 0.02 ]
        edge [ source 1 target 1 latency "10 ms" packet_loss 0.02 ] ]
experimental: {scheduler_policy: hybrid}
hosts:
  left:
    quantity: 8
    network_node_id: 0
    processes: [{path: model:phold, args: msgload=3 size=64,
                 start_time: 10ms}]
  right:
    quantity: 8
    network_node_id: 1
    processes: [{path: model:phold, args: msgload=3 size=64,
                 start_time: 10ms}]
"""
# a PHOLD + tgen mix (no single device twin), lossy, 3 s
HYB_MIX_YAML = """
general: {stop_time: 3s, seed: 5}
network:
  graph:
    type: gml
    inline: |
      graph [ directed 0
        node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        node [ id 1 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        edge [ source 0 target 0 latency "10 ms" packet_loss 0.05 ]
        edge [ source 0 target 1 latency "20 ms" packet_loss 0.05 ]
        edge [ source 1 target 1 latency "10 ms" packet_loss 0.05 ] ]
experimental: {scheduler_policy: tpu}
hosts:
  peer:
    quantity: 12
    network_node_id: 0
    processes: [{path: model:phold, args: msgload=2, start_time: 10ms}]
  server:
    network_node_id: 0
    processes: [{path: model:tgen_server, start_time: 10ms}]
  client:
    quantity: 4
    network_node_id: 1
    processes:
    - {path: model:tgen_client, start_time: 100ms,
       args: server=server size=100KiB count=3 pause=50ms retry=300ms}
"""
# examples/tor_small.yaml cut to 10 s, relay_us3 down from 6 s to 8 s
HYB_TOR_OVERRIDES = (
    "general.stop_time=10s",
    "network.faults=[{kind: host_crash, time: 6s, host: relay_us3}, "
    "{kind: host_restart, time: 8s, host: relay_us3}]")
# (key, what, source: YAML text or an examples/ file, overrides); each
# runs on the card with K10 on every flush, on the CPU plain path, and
# on the port's serial policy
HYBRID_PARITY = (
    ("phold", "tests/test_hybrid.py's lossy PHOLD (16 hosts, 2 s)",
     HYB_PHOLD_YAML, ()),
    ("selfloop", "the same with selfloop=1 and a 100 ms runahead",
     HYB_PHOLD_YAML.replace("msgload=3 size=64", "msgload=3 size=64 "
                            "selfloop=1"), ("experimental.runahead=100ms",)),
    ("tgen_faults", "examples/tgen_faults.yaml under tpu (host faults: "
     "hybrid)", "tgen_faults.yaml", ("experimental.scheduler_policy=tpu",)),
    ("tgen_faults_hier", "examples/tgen_faults_hier.yaml under tpu",
     "tgen_faults_hier.yaml", ("experimental.scheduler_policy=tpu",)),
    # a mesh config's fall-back ignores the mesh (the reference's
    # warning), and runs as tgen_faults does
    ("tgen_faults_mesh", "examples/tgen_faults.yaml under tpu with "
     "mesh_shards 2 (host faults: hybrid, the mesh ignored)",
     "tgen_faults.yaml", ("experimental.scheduler_policy=tpu",
                          "experimental.mesh_shards=2")),
    ("tgen_hier_crash", "examples/tgen_faults_hier.yaml with its host "
     "faults alone (factored tables, one epoch)", "tgen_faults_hier.yaml",
     ("experimental.scheduler_policy=tpu",
      "network.faults=[{kind: host_crash, time: 3500ms, host: client0}, "
      "{kind: host_restart, time: 7500ms, host: client0}]")),
    ("mix", "PHOLD + tgen (no single twin: hybrid), 17 hosts, 3 s",
     HYB_MIX_YAML, ()),
    ("tor_crash", "examples/tor_small.yaml cut to 10 s, relay_us3 down "
     "6-8 s, under tpu", "tor_small.yaml", HYB_TOR_OVERRIDES),
)
# the full hybrid run: phold.yaml's network and args at 2 x 5,000
# hosts, 1 s, eight host crashes at 300 ms restarting at 700 ms, and
# the 0-1 link down from 400 ms to 500 ms
HYB_FULL_HOSTS = 5_000
HYB_FULL_OVERRIDES = (
    f"hosts.west.quantity={HYB_FULL_HOSTS}",
    f"hosts.east.quantity={HYB_FULL_HOSTS}",
    "general.stop_time=1s", "experimental.scheduler_policy=hybrid",
    "network.faults=["
    + ", ".join(f"{{kind: host_crash, time: 300ms, host: {g}{i}}}"
                for g in ("west", "east") for i in range(4)) + ", "
    + ", ".join(f"{{kind: host_restart, time: 700ms, host: {g}{i}}}"
                for g in ("west", "east") for i in range(4))
    + ", {kind: link_down, time: 400ms, source: 0, target: 1}, "
    "{kind: link_up, time: 500ms, source: 0, target: 1}]")
MIN_BATCH_0 = "experimental.hybrid_judge_min_batch=0"
SERIAL = "experimental.scheduler_policy=serial"
# a hybrid parity config's serial twin: the serial policy pins no device
# mesh (mesh_shards needs tpu)
SERIAL_TWIN = (SERIAL, "experimental.mesh_shards=0")
# the reference's warning where a mesh config falls back to hybrid
MESH_IGNORED = ("ignored — the hybrid fallback's CPU host emulation has "
                "no device mesh to pin")
JUDGE_KERNELS = ("judge_batch", "judge_batch_hier", "judge_batch_ep",
                 "judge_batch_ep_hier")


def controller_run(cfg, device, kernels=None, trace=None):
    from shadow_tpu_torch.core.controller import Controller

    c = Controller(cfg, trace=trace, device=device, kernels=kernels)
    return c.run(), c


HOST_LEAVES = ("host_events_executed", "host_trace_checksum",
               "host_packets_sent", "host_packets_dropped",
               "host_packets_delivered", "host_events_quarantined")


def same_cpu_run(a, b, what, names, paths=True):
    """Two runs of the CPU engine equal: totals, rounds, every per-host
    leaf and (with `paths`) the path counters."""
    for field in ("events_executed", "packets_sent", "packets_dropped",
                  "packets_delivered", "rounds") + (
                      ("path_packets",) if paths else ()):
        check(getattr(a, field) == getattr(b, field),
              f"hybrid ({what}): {field} {names[0]} {getattr(a, field)} "
              f"!= {names[1]} {getattr(b, field)}")
    for leaf in HOST_LEAVES:
        check(np.array_equal(getattr(a, leaf), getattr(b, leaf)),
              f"hybrid ({what}): per-host {leaf} {names[0]} != "
              f"{names[1]}")
    check(a.events_executed > 0, f"hybrid ({what}): nothing ran")


def hybrid_line(stats, prof=None):
    """The wall, events/s, device flushes against CPU rounds, the
    manager's flushes' share of the wall and, a device flush: packets,
    K10's device ms from torch.profiler (`prof` = (ms, kernels seen),
    where the run was profiled: over the kernels it saw, as CUPTI may
    drop records), the ms of the event pair around the launch, the
    copies' ms and the judge's host wall (judge_batch)."""
    j = stats.judge
    b = j["batches"]
    per = "no device flush"
    if b:
        per = (f"a device flush: {j['packets'] / b:.1f} packets, kernel "
               + (f"{prof[0] / max(prof[1], 1):.4f} device ms "
                  f"(torch.profiler, over the {prof[1]} of {b} launches "
                  "it saw), " if prof else "")
               + f"{j['kernel_ms'] / b:.4f} ms by its event pair, copies "
               f"{j['copy_ms'] / b:.4f} ms, judge wall "
               f"{1e3 * j['judge_s'] / b:.4f} ms")
    return (f"wall {stats.wall_s:.3f} s, "
            f"{stats.events_executed / stats.wall_s:.0f} events/s; "
            f"flushes on the card {b} ({j['packets']} packets) "
            f"against the CPU {j['cpu_batches']} ({j['cpu_packets']} "
            f"packets, min_batch {j['min_batch']}); the flushes' share of "
            f"the wall {j['flush_s'] / stats.wall_s:.4f}; {per}")


# K10's CUDA functions: the design, the design before
JUDGE_FUNCTIONS = ("judge_kernel", "judge_batch_before_kernel")


def judge_profiled(torch, run):
    """run() under torch.profiler (device activity only): (its result,
    (the summed device ms of K10's kernels, either design, the number
    of them the profiler saw))."""
    import re

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    ms, seen = 0.0, 0
    for e in prof.key_averages():
        m = re.search(r"(\w+_kernel)\b", e.key)
        if m and m.group(1) in JUDGE_FUNCTIONS:
            ms += e.self_device_time_total / 1e3
            seen += e.count
    return out, (ms, seen)


@contextlib.contextmanager
def recorded_flushes(flushes: list):
    """Inside, every DeviceJudge.judge_batch call appends (the judge,
    numpy copies of its four columns) to `flushes`."""
    from shadow_tpu_torch.device.judge import DeviceJudge

    judge_batch = DeviceJudge.judge_batch

    def recording(self, now, src, dst, pkt_seq):
        flushes.append((self, (np.array(now, np.int64),
                               np.array(src, np.int32),
                               np.array(dst, np.int32),
                               np.array(pkt_seq, np.int32))))
        return judge_batch(self, now, src, dst, pkt_seq)

    DeviceJudge.judge_batch = recording
    try:
        yield flushes
    finally:
        DeviceJudge.judge_batch = judge_batch


def judge_real_rows(torch, flushes, what, card):
    """K10 on the recorded flushes of one hybrid run: the design and the
    design before bit-equal to judge_batch_plain on every flush; K10
    alone (time_median of each flush's columns on the card, summed over
    the flushes), both designs; the judge's host wall a flush
    (DeviceJudge.judge_batch on the recorded columns, every flush in
    turn, in turns: the design before, the design, the design, the
    design before) and its kernel_ms a flush (its event pair: around the
    kernel node of the flush graph, around the Python wrapper before), both
    designs' verdicts equal; each design's K10 device ms a kernel over
    one such replay from torch.profiler (over the kernels it saw); the
    bound
    (`judge_work`, summed over the flushes)."""
    from shadow_tpu_torch.device import kernels as K

    judge = flushes[0][0]
    check(all(f[0] is judge for f in flushes),
          f"{what}: the flushes came from more than one judge")
    tables, boot = judge.tables, judge.boot_end
    dev = judge.device
    cols = [tuple(torch.from_numpy(a).to(dev) for a in f[1])
            for f in flushes]
    n = len(cols)
    new, before = K.Kernels(), K.Kernels()
    before.designs_before = True
    err, work = 0.0, {"bytes": 0, "ops": 0, "packets": 0, "rolled": 0}
    for c in cols:
        e, _, _ = judge_designs(torch, K, before, new, tables, boot, c)
        err = max(err, e)
        w = judge_work(torch, K, tables.world, c[0], c[1], c[2], boot)
        work["bytes"] += w["bytes"]
        work["ops"] += w["ops"]
        work["packets"] += int(c[0].shape[0])
        work["rolled"] += w["rolled_n"]
    name = tables.name
    check(err == 0.0, f"{what}: {name} differs from its plain version on "
          f"a real flush (max abs err {err})")
    check(new.launches[name] == n and before.launches[name] == n,
          f"{what}: {name} did not launch once a flush")
    outs = [(torch.empty(c[0].shape[0], dtype=torch.int64, device=dev),
             torch.empty(c[0].shape[0], dtype=torch.uint8, device=dev))
            for c in cols]

    def alone(kk):
        return sum(time_median(
            torch, kk.judge_batch,
            lambda c=c, o=o: (tables, boot, *c, o), 3)
            for c, o in zip(cols, outs))

    ms, parent_ms = alone(new), alone(before)
    plain_ms = sum(time_median(torch, K.judge_batch_plain,
                               lambda c=c: (tables.world, boot, *c), 1)
                   for c in cols)

    def replay():
        return [judge.judge_batch(*f[1]) for f in flushes]

    walls, events, verdicts = {True: [], False: []}, {True: [],
                                                       False: []}, {}
    for design in (True, False, False, True):
        judge.kernels.designs_before = design
        s0, k0 = judge.judge_s, judge.kernel_ms
        verdicts.setdefault(design, replay())
        walls[design].append(1e3 * (judge.judge_s - s0) / n)
        events[design].append((judge.kernel_ms - k0) / n)
    check(all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
              for a, b in zip(verdicts[True], verdicts[False])),
          f"{what}: the two designs' judges disagree on a real flush")
    profiled = {}
    for design in (False, True):
        judge.kernels.designs_before = design
        _, prof = judge_profiled(torch, replay)
        check(0 < prof[1] <= n, f"{what}: the profiler saw {prof[1]} K10 "
              f"kernels of {n} flushes")
        profiled[design] = (prof[0] / prof[1], prof[1])
    judge.kernels.designs_before = False
    r = finish({"err": err, "flushes": n, "packets": work["packets"],
                "rolled": work["rolled"], "ms": ms / n,
                "parent_ms": parent_ms / n, "plain_ms": plain_ms / n,
                "library_ms": None, "bytes": work["bytes"] / n,
                "ops": work["ops"] / n,
                "device_ms_profiled": profiled[False][0],
                "parent_device_ms_profiled": profiled[True][0],
                "judge_wall_ms": walls[False],
                "parent_judge_wall_ms": walls[True],
                "event_pair_ms": events[False],
                "parent_event_pair_ms": events[True]})
    print(f"[full:{what}] {name} on its {n} real flushes ("
          f"{work['packets'] / n:.1f} packets, {work['rolled'] / n:.1f} "
          f"rolled a flush): both designs equal to plain (max abs err "
          f"{err}); a flush: K10 alone {r['ms']:.4f} ms, the design before "
          f"{r['parent_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
          f"{r['bound_ms']:.4f} ms (by {r['bound_by']}); replayed through "
          f"DeviceJudge: device ms (torch.profiler) "
          f"{profiled[False][0]:.4f} ({profiled[False][1]} seen), the "
          f"design before {profiled[True][0]:.4f} ({profiled[True][1]} "
          f"seen); in turns before/new/new/before, the judge wall "
          + "/".join(f"{x:.4f}" for x in (walls[True][0], walls[False][0],
                                          walls[False][1], walls[True][1]))
          + " ms and its kernel_ms (event pair) "
          + "/".join(f"{x:.4f}" for x in (
              events[True][0], events[False][0], events[False][1],
              events[True][1]))
          + f" ms; card {card}", flush=True)
    return r


def hybrid_parity(torch, report):
    """Each HYBRID_PARITY config three ways: on the card with K10 on
    every flush (hybrid_judge_min_batch 0), on the CPU plain path, and
    on the port's serial policy: the (time, dst, src, kind) trace, every
    per-host leaf, the totals and the path counters equal; K10 launched
    on the card. A mesh config (mesh_shards) logs the reference's
    warning once and equals the same config's run without the mesh."""
    from shadow_tpu_torch.device.kernels import Kernels

    runs = report.setdefault("_extra", {})
    cards = {}
    for key, what, source, overrides in HYBRID_PARITY:
        kernels = Kernels()
        traces = [[], None, None]
        with counting(MESH_IGNORED) as warned:
            (card, c), prof = judge_profiled(torch, lambda: controller_run(
                cfg_from(source, overrides + (MIN_BATCH_0,)), "cuda",
                kernels, traces[0]))
        mesh = any(o.startswith("experimental.mesh_shards=")
                   for o in overrides)
        check(warned.counts[MESH_IGNORED] == int(mesh),
              f"hybrid ({what}): the mesh's warning logged "
              f"{warned.counts[MESH_IGNORED]} times")
        cards[key] = card
        # the serial policy touches no device: its run is a CPU oracle
        cpu, traces[1] = oracle(f"hybrid:{key}", ("controller", loader(
            source, *overrides, MIN_BATCH_0)))
        serial, traces[2] = oracle(f"serial:{key}", ("controller", loader(
            source, *overrides, *SERIAL_TWIN)))
        check((card.policy, cpu.policy, serial.policy)
              == ("hybrid", "hybrid", "serial"),
              f"hybrid ({what}): policies {card.policy}, {cpu.policy}, "
              f"{serial.policy}")
        check(traces[0] == traces[1] == traces[2] and traces[0],
              f"hybrid ({what}): the event traces differ")
        same_cpu_run(card, cpu, what, ("card", "cpu"))
        same_cpu_run(card, serial, what, ("card", "serial"))
        check(card.judge["batches"] > 0 and card.judge["cpu_batches"] == 0
              and sum(kernels.launches[k] for k in JUDGE_KERNELS)
              == card.judge["batches"],
              f"hybrid ({what}): K10 did not judge every flush")
        runs[f"hybrid_{key}"] = {"launches": dict(kernels.launches)}
        quarantined = int(card.host_events_quarantined.sum())
        print(f"[parity] hybrid {what}: card (K10 on every flush) == cpu "
              f"plain path == serial, trace of {len(traces[0])} events "
              f"and every per-host leaf: {card.summary()}, {quarantined} "
              f"events quarantined; card {hybrid_line(card, prof)}; serial "
              f"wall {serial.wall_s:.3f} s", flush=True)
    same_cpu_run(cards["tgen_faults_mesh"], cards["tgen_faults"],
                 "tgen_faults.yaml, mesh_shards 2 against none",
                 ("mesh_shards 2", "no mesh"))
    print("[parity] hybrid examples/tgen_faults.yaml with mesh_shards 2: "
          f"the reference's warning (\"experimental.mesh_shards=2 "
          f"{MESH_IGNORED}\") logged once, every per-host leaf equal to "
          "the run without the mesh", flush=True)


def compact_parity(torch, report):
    """The outbox compaction through the window loop: the parity PHOLD
    (2 x 1,000 hosts) and examples/tgen_10000.yaml cut to COMPACT_STOP,
    each at CX = the uncompacted run's largest occ_ob (nothing
    overflows: equal to the uncompacted run) and at half of it (rows
    overflow) by the global rule, the PHOLD also by the window rule (the
    CPU runs of tgen_10000 take about 14 s each), each three ways: graph loop on the card, Python loop on the card, CPU plain
    path, every statistic and state leaf equal."""
    from shadow_tpu_torch.device.kernels import Kernels

    runs = report.setdefault("_extra", {})
    for key, what, load in COMPACT_LOADS:
        base, base_leaves = engine_run(load(), "cuda")
        occ = int(base_leaves["occ_ob"].max())
        check(occ > 1, f"parity ({what}): the uncompacted run's largest "
              f"occ_ob is {occ}, nothing to compact")
        plain = oracle(f"compact:{key}", ("compact", key, load))
        check(plain["occ"] == occ, f"parity ({what}): the CPU's largest "
              f"occ_ob {plain['occ']}, the card's {occ}")
        for cx, rule in compact_variants(key, occ):
            x = (f"experimental.outbox_compact={cx}",
                 f"experimental.merge_strategy={rule}")
            kernels = Kernels()
            gpu, gl = engine_run(load(x), "cuda", kernels=kernels)
            py, pl = engine_run(load(x), "cuda", "run_python")
            cpu, cl = plain[(cx, rule)]
            name = "compact_outbox" + ("_global" if rule == "global"
                                       else "")
            label = f"{what}, outbox_compact {cx} ({rule} rule)"
            for other, leaves, names in ((cpu, cl, ("card graph", "cpu")),
                                         (py, pl, ("card graph",
                                                   "card python"))):
                for field in ("events_executed", "packets_sent",
                              "packets_dropped", "packets_delivered",
                              "rounds", "overflow", "x_overflow"):
                    check(getattr(gpu, field) == getattr(other, field),
                          f"parity ({label}): {field} differs, {names}")
                same_leaves(gl, leaves, label, names)
            check(kernels.launches[name] > 0,
                  f"parity ({label}): {name} never launched")
            if cx == occ:
                check(gpu.x_overflow == 0, f"parity ({label}): rows "
                      "overflowed at the largest occ_ob")
                same_run(base, gpu, label, ("uncompacted", "compacted"))
            else:
                check(gpu.x_overflow > 0 and gpu.overflow == 0,
                      f"parity ({label}): expected x_overflow only")
            runs[f"parity_compact_{key}_{cx}_{rule}"] = {
                "launches": dict(kernels.launches)}
            print(f"[parity] {label}: card graph == card python == cpu "
                  f"plain path, every leaf; x_overflow {gpu.x_overflow}; "
                  f"{gpu.summary()}; card graph wall {gpu.wall_s:.3f} s, "
                  f"cpu wall {cpu.wall_s:.3f} s", flush=True)


# examples/tgen_10000.yaml's stop_time cut for the compaction's card ==
# CPU parity (the plain path on the CPU): its clients start at 2 s
COMPACT_STOP = "2500ms"
COMPACT_LOADS = (
    ("phold", "PHOLD 2x1000 hosts, 1 s", loader(PARITY_YAML)),
    ("tgen_10000", f"examples/tgen_10000.yaml cut to {COMPACT_STOP}",
     loader("tgen_10000.yaml", f"general.stop_time={COMPACT_STOP}")))


def compact_variants(key, occ):
    """(CX, rule) of a compaction parity config whose uncompacted run's
    largest occ_ob is `occ`: nothing overflows at CX = occ, rows do at
    half of it."""
    return ((occ, "window"), (occ // 2, "global")) + (
        ((occ // 2, "window"),) if key == "phold" else ())


def compact_cpu(key, load):
    """The compaction's CPU runs: the uncompacted run's largest occ_ob
    (under "occ") and the run of each variant at it."""
    _, leaves = engine_run(load(), "cpu")
    occ = int(leaves["occ_ob"].max())
    out = {"occ": occ}
    for cx, rule in compact_variants(key, occ):
        out[(cx, rule)] = engine_run(load((
            f"experimental.outbox_compact={cx}",
            f"experimental.merge_strategy={rule}")), "cpu")
    return out


def hybrid_full(torch, card, report):
    """examples/tgen_faults.yaml and tgen_faults_hier.yaml as shipped
    under tpu (hybrid, the configured min_batch) through the CLI's entry
    function, and again with K10 on every flush; then the hybrid PHOLD
    at 2 x HYB_FULL_HOSTS hosts with host and link faults on the card,
    its per-host leaves against the port's serial run of the same
    config."""
    from shadow_tpu_torch import cli
    from shadow_tpu_torch.device.kernels import Kernels

    runs = report.setdefault("_extra", {})
    real = report.setdefault("_judge_real", {})
    for example in ("tgen_faults.yaml", "tgen_faults_hier.yaml"):
        shipped = None
        for extra in ((), (MIN_BATCH_0,)):
            kernels = Kernels()
            kernels.library()
            kernels.reset_counts()
            with recorded_flushes([]) as flushes:
                stats, prof = judge_profiled(torch, lambda: cli.simulate(
                    os.path.join(REPO, "examples", example),
                    ("experimental.scheduler_policy=tpu",) + extra,
                    device="cuda", kernels=kernels))
            check(stats.policy == "hybrid", f"full {example}: ran "
                  f"{stats.policy}, not hybrid")
            if shipped is None:
                shipped = stats
            else:
                same_cpu_run(shipped, stats, f"full {example}",
                             ("min_batch 192", "min_batch 0"), paths=False)
                check(stats.judge["batches"] > 0,
                      f"full {example}: no device flush")
            key = example[:-5] + ("_min_batch_0" if extra else "")
            runs[f"full_{key}"] = {"launches": dict(kernels.launches)}
            print(f"[full:{key}] {stats.summary()}; "
                  f"{int(stats.host_events_quarantined.sum())} events "
                  f"quarantined; {hybrid_line(stats, prof)}; card {card}",
                  flush=True)
            if example == "tgen_faults_hier.yaml" and extra:
                check(len(flushes) == stats.judge["batches"],
                      f"full {key}: {len(flushes)} flushes recorded of "
                      f"{stats.judge['batches']}")
                row = judge_real_rows(torch, flushes, key, card)
                real[flushes[0][0].tables.name] = {**row, "run": key}
    kernels = Kernels()
    kernels.library()
    kernels.reset_counts()
    with recorded_flushes([]) as flushes:
        stats, prof = judge_profiled(torch, lambda: cli.simulate(
            os.path.join(REPO, "examples", "phold.yaml"),
            HYB_FULL_OVERRIDES, device="cuda", kernels=kernels))
    launches = dict(kernels.launches)
    check(stats.policy == "hybrid" and stats.judge["batches"] > 0,
          "full hybrid_phold: no device flush")
    check(sum(launches[k] for k in JUDGE_KERNELS)
          == stats.judge["batches"] == launches["judge_batch_ep"],
          "full hybrid_phold: K10's launches are not its flushes")
    serial = oracle("serial:full_hybrid_phold", (
        "simulate", "phold.yaml", HYB_FULL_OVERRIDES + (SERIAL,)))
    # CPU-rolled rounds count into the path counters twice, as in the
    # reference, so those are not compared here (the parity runs, with
    # every flush on the card, compare them)
    same_cpu_run(stats, serial, "full hybrid_phold", ("hybrid", "serial"),
                 paths=False)
    check(int(stats.host_events_quarantined.sum()) > 0,
          "full hybrid_phold: no event was quarantined")
    runs["full_hybrid_phold"] = {"launches": launches}
    report["_hybrid_full"] = {"wall_s": stats.wall_s,
                              "serial_wall_s": serial.wall_s,
                              "judge": stats.judge}
    print(f"[full:hybrid_phold] {2 * HYB_FULL_HOSTS} hosts, 1 s, 8 host "
          f"crashes 300-700 ms, link 0-1 down 400-500 ms: "
          f"{stats.summary()}; {int(stats.host_events_quarantined.sum())} "
          f"events quarantined; hybrid == serial on every per-host leaf; "
          f"{hybrid_line(stats, prof)}; serial wall {serial.wall_s:.3f} s "
          f"({serial.events_executed / serial.wall_s:.0f} events/s); card "
          f"{card}", flush=True)
    check(len(flushes) == stats.judge["batches"],
          f"full hybrid_phold: {len(flushes)} flushes recorded of "
          f"{stats.judge['batches']}")
    row = judge_real_rows(torch, flushes, "hybrid_phold", card)
    real[flushes[0][0].tables.name] = {**row, "run": "hybrid_phold"}


# the compaction's full runs: (name, example, overrides, path)
COMPACT_FULL = (
    ("phold", "phold.yaml",
     (f"hosts.west.quantity={FULL_HOSTS_PER_GROUP}",
      f"hosts.east.quantity={FULL_HOSTS_PER_GROUP}",
      f"general.stop_time={FULL_STOP}"),
     ("pop_phase", "judge_outbox", "route", "merge_heaps")),
    ("tgen_10000", "tgen_10000.yaml", (),
     ("pop_tgen", "judge_outbox", "route", "merge_heaps")),
)


def compact_full(torch, card, report):
    """PHOLD at 100,000 hosts and examples/tgen_10000.yaml as shipped,
    each uncompacted (the engine's graph loop, its largest occ_ob read
    back) and then on the main path (the CLI's entry function) under
    outbox_compact at that occ_ob, the smallest CX that does not
    overflow: equal statistics and per-host leaves, both walls."""
    from shadow_tpu_torch.device.kernels import Kernels

    runs = report.setdefault("_extra", {})
    out = {}
    for name, example, overrides, path in COMPACT_FULL:
        cfg = full_config(example, overrides)
        kernels = Kernels()
        kernels.library()
        base, leaves = engine_run(cfg, "cuda", kernels=kernels)
        cx = int(leaves["occ_ob"].max())
        stats, launches, peak = main_path_run(
            torch, f"{name}_compact", example,
            overrides + (f"experimental.outbox_compact={cx}",),
            path + ("phase_tally", "loop_control", "compact_outbox"))
        same_run(base, stats, f"full {name} compacted",
                 ("uncompacted", "compacted"))
        runs[f"full_{name}_compact"] = {"launches": launches}
        # K11's device ms over its real launches: the graph run profiled
        device_ms, _ = profiled_graph_run(
            torch, card, f"{name}_compact", full_config(example, overrides + (
                f"experimental.outbox_compact={cx}",)),
            tuple(k for k, n in launches.items() if n), stats, launches)
        out[name] = {"cx": cx, "wall_s": stats.wall_s,
                     "uncompacted_wall_s": base.wall_s,
                     "compact_outbox_device_ms": device_ms["compact_outbox"]}
        print(f"[full:{name}_compact] outbox_compact {cx} (the "
              f"uncompacted run's largest occ_ob): {stats.summary()}; "
              f"graph loop wall {stats.wall_s:.3f} s against "
              f"{base.wall_s:.3f} s uncompacted; compact_outbox "
              f"{launches['compact_outbox']} launches, "
              f"{device_ms['compact_outbox']:.3f} device ms; peak {peak} "
              f"B; card {card}", flush=True)
    report["_compact_full"] = out


# the parity phase's PHOLD, tgen and cut tor_small: (key, what,
# loader, the kernels the card's run must launch)
PARITY_LOOPS = (
    ("phold", "PHOLD 2x1000 hosts, 1 s", loader(PARITY_YAML),
     ("pop_phase", "judge_outbox")),
    ("tgen", f"tgen 1 server + {TGEN_PARITY_CLIENTS} clients, loss 0.25, "
     "retry=120ms, 6 s", loader(TGEN_PARITY_YAML),
     ("pop_tgen", "judge_outbox")),
    ("tor", "examples/tor_small.yaml (250 hosts), stop_time cut from 60 s "
     f"to {TOR_PARITY_STOP}",
     loader("tor_small.yaml", f"general.stop_time={TOR_PARITY_STOP}"),
     ("pop_tor", "judge_outbox")))
STAR_WHAT = ("star_clusters tgen, 8 clusters x 120 spokes, 8 servers + "
             "952 clients, hub loss 0.02, 2 s")
STAR_LOOPS = tuple(
    (f"star_{rep}", f"{STAR_WHAT}, {rep}", loader(
        STAR_PARITY_YAML, f"network.topology.representation={rep}"), ())
    for rep in ("hierarchical", "dense"))


def parity_phase(torch, report):
    for key, what, load, path in PARITY_LOOPS:
        report.setdefault("_cpu_runs", {})[key] = loop_parity(
            torch, report, key, what, load, path)[2]
    star_parity(torch, report)
    nic_fault_parity(torch, report)
    audit_parity(torch, report)
    campaign_parity(torch, report)
    hybrid_parity(torch, report)
    compact_parity(torch, report)
    plan_parity(torch, report)
    campaign_plan_parity(torch, report)


def star_parity(torch, report):
    """The star_clusters tgen run four ways: card and CPU, hierarchical
    and dense tables (each three ways and audited, `loop_parity`); the
    card's hierarchical run goes through the `_hier` kernels and its
    dense run through the others."""
    from shadow_tpu_torch.device.kernels import HIER, TOPO_KERNELS

    what = STAR_WHAT
    runs = {}
    for (key, label, load, _), rep in zip(STAR_LOOPS,
                                          ("hierarchical", "dense")):
        gpu, _, cpu, _, kernels = loop_parity(torch, report, key, label,
                                              load)
        runs[("card", rep)], runs[("cpu", rep)] = gpu, cpu
        for n in TOPO_KERNELS:
            on, off = ((n + HIER, n) if rep == "hierarchical"
                       else (n, n + HIER))
            check(kernels.launches[off] == 0, f"parity ({what}, {rep}): "
                  f"{off} launched")
            if n in ("pop_tgen", "judge_outbox"):
                check(kernels.launches[on] > 0, f"parity ({what}, {rep}): "
                      f"{on} never launched")
    base = runs[("card", "hierarchical")]
    for key, other in runs.items():
        same_run(base, other, what, ("card hierarchical", " ".join(key)))
    check(base.packets_dropped > 0 and base.downloads_completed > 0,
          f"parity ({what}): no drop or no download")
    print(f"[parity] {what}: card hierarchical == card dense == cpu "
          f"hierarchical == cpu dense: {base.summary()}", flush=True)


# ----------------------------------------------------------------------
# ensemble campaigns: parity
# ----------------------------------------------------------------------
# a link-fault schedule on STAR_PARITY_YAML's 8 x 120 star: hubs 0-1
# degraded (x3 latency, +5% loss) over 300-800 ms, the access link of
# spoke 8 (hub 0's first) x2 over 400-700 ms, hubs 2-3 down from 900 ms
# to 1,200 ms (rerouted through another hub)
STAR_FAULTS = (
    "network.faults=["
    "{kind: degrade, time: 300ms, duration: 500ms, source: 0, target: 1,"
    " latency_multiplier: 3, extra_packet_loss: 0.05},"
    "{kind: degrade, time: 400ms, duration: 300ms, source: 0, target: 8,"
    " latency_multiplier: 2},"
    "{kind: link_down, time: 900ms, source: 2, target: 3},"
    "{kind: link_up, time: 1200ms, source: 2, target: 3}]")
STAR_CAMPAIGN = ("ensemble={replicas: 2, vary: {latency_scale: [1.0, 2.0],"
                 " fault_schedule: [base, none]}}")
SWEEP = os.path.join(REPO, "examples", "ensemble_seed_sweep.yaml")
# the campaigns held three ways: (key, what, loader, the kernels the
# card's run must launch)
CAMPAIGN_PARITY = (
    ("sweep", "examples/ensemble_seed_sweep.yaml as shipped (4 replicas, "
     "seeds 1, 7, 13, 42; 7 hosts, 3 s)", loader("ensemble_seed_sweep.yaml"),
     ("pop_tgen", "judge_outbox")),
    ("star", "STAR_PARITY_YAML (8 x 120 star, 960 hosts, 2 s) with link "
     "faults, latency_scale [1.0, 2.0], fault_schedule [base, none]",
     loader(STAR_PARITY_YAML, STAR_FAULTS, STAR_CAMPAIGN),
     ("pop_tgen_ep_hier", "judge_outbox_ep_hier")))


def run_config(cfg, device, kernels=None):
    """(stats, the campaign's runner or None) of a config: its ensemble
    campaign where it has one, else the standalone run."""
    from shadow_tpu_torch.device import runner
    from shadow_tpu_torch.ensemble.campaign import EnsembleRunner

    if cfg.ensemble is None:
        return runner.run(cfg, device, kernels=kernels), None
    er = EnsembleRunner(cfg, device, kernels)
    return er.run(), er


def same_replicas(a: dict, b: dict, what: str, names) -> None:
    """Every leaf of two campaigns' final states (numpy, [R, ...])."""
    check(set(a) == set(b), f"campaign parity ({what}): leaves differ")
    for k, v in a.items():
        check(np.array_equal(v, b[k]), f"campaign parity ({what}): leaf "
              f"{k} {names[0]} != {names[1]}")


def standalone_replicas(er, final, rounds, what, kernels=None) -> float:
    """Each replica of a campaign (final leaves `final`, [R] `rounds`)
    against its standalone run on the card (the graph loop, replica r's
    tables, seed and the campaign's lookahead), leaf by leaf; returns
    the standalone runs' summed walls."""
    from shadow_tpu_torch.device import runner
    from shadow_tpu_torch.device.engine import state_to_numpy

    walls = 0.0
    for r in range(er.worlds.R):
        engine = er.replica_engine(r, kernels)
        state = engine.init_state(er.sim.start_times, er.sim.stop_times)
        t0 = time.perf_counter()
        state, rr = engine.run(state)
        stats = runner.summarize(er.cfg, engine, state, rr, t0)
        check(stats.loop == "graph", f"{what}: standalone replica {r} "
              f"ran the {stats.loop} loop")
        walls += stats.wall_s
        leaves = state_to_numpy(state)
        check(rr == int(rounds[r]), f"{what}: replica {r} ran "
              f"{int(rounds[r])} rounds, its standalone run {rr}")
        for k, v in final.items():
            check(np.array_equal(v[r], leaves[k]), f"{what}: replica {r}"
                  f" != its standalone run on leaf {k}")
    return walls


def campaign_parity(torch, report):
    """Each campaign three ways, the captured graph loop on the card
    (the main path), the Python loop on the card and the CPU plain
    path, every replica's leaves and rounds equal, and each replica
    equal to its standalone graph run; examples/ensemble_seed_sweep.yaml
    as shipped and STAR_PARITY_YAML with STAR_FAULTS under
    STAR_CAMPAIGN (factored tables with the epoch axis, a scale and a
    padded fault-free replica); then the sweep with `replica_batch: 2`
    equal to the whole campaign."""
    from shadow_tpu_torch.config import load_config
    from shadow_tpu_torch.device.engine import state_to_numpy
    from shadow_tpu_torch.device.kernels import HEAP_FIELDS, Kernels

    runs = report.setdefault("_parity", {})
    for key, what, load, path in CAMPAIGN_PARITY:
        kernels = Kernels()
        gpu, card = run_config(load(), "cuda", kernels)
        check(gpu.loop == "graph" and gpu.ok, f"campaign parity ({what}):"
              f" the card ran the {gpu.loop} loop, ok {gpu.ok}")
        for k in path + ("route", "merge_heaps", "loop_control_tally"):
            check(kernels.launches[k] > 0, f"campaign parity ({what}): "
                  f"{k} never launched")
        rounds = card.loop_stats[0]["rounds"]
        cpu, plain = oracle(f"campaign:{key}", ("campaign", load))
        same_replicas(card.final_state, plain["final_state"], what,
                      ("card graph", "cpu"))
        check(plain["rounds"] == rounds, f"campaign parity "
              f"({what}): rounds differ")
        engine = card.engine()
        state = engine.init_ensemble_state(card.sim.start_times,
                                           card.sim.stop_times)
        t0 = time.perf_counter()
        state, py_rounds = engine.run_python(state)
        py_leaves = state_to_numpy(state)
        py_wall = time.perf_counter() - t0
        same_replicas(card.final_state, {k: v for k, v in py_leaves.items()
                                         if k not in HEAP_FIELDS}, what,
                      ("card graph", "card python"))
        check(list(py_rounds) == rounds, f"campaign parity ({what}): the "
              "python loop's rounds differ")
        walls = standalone_replicas(card, card.final_state, rounds, what)
        runs[f"campaign_{key}"] = {"launches": dict(kernels.launches)}
        print(f"[parity] campaign {what}: card graph == card python == "
              f"cpu plain path, replica by replica, and each replica == "
              f"its standalone graph run: rounds {rounds}, "
              f"{gpu.summary()}; card graph wall {gpu.wall_s:.3f} s "
              f"({gpu.host_syncs} host syncs), card python {py_wall:.3f} "
              f"s, cpu {cpu.wall_s:.3f} s, standalone graph runs "
              f"{walls:.3f} s in all", flush=True)
        if key == "sweep":
            whole = card
    batched, er = run_config(load_config(SWEEP, ["ensemble.replica_batch=2"]),
                             "cuda")
    same_replicas(whole.final_state, er.final_state, "replica_batch 2",
                  ("whole", "batched"))
    a, b = dict(whole.record), dict(er.record)
    check(b.pop("replica_batch") == 2 and len(er.loop_stats) == 2,
          "replica_batch 2: not two batches")
    for rec in (a, b):
        rec.pop("wall_s")
    check(a == b, "replica_batch 2: the record differs from the whole "
          "campaign's")
    print(f"[parity] campaign examples/ensemble_seed_sweep.yaml with "
          f"replica_batch 2: two batches == the whole campaign, record "
          f"and leaves; wall {batched.wall_s:.3f} s", flush=True)


# ----------------------------------------------------------------------
# ensemble campaigns: full runs
# ----------------------------------------------------------------------
CAMPAIGN_RUNS = (
    ("tgen_10000_x8", "tgen_10000.yaml",
     ("ensemble={replicas: 8, vary: {seed: [1, 2, 3, 4, 5, 6, 7, 8]}}",),
     ("pop_tgen", "judge_outbox", "route", "merge_heaps")),
    ("tor_small_x8", "tor_small.yaml",
     ("ensemble={replicas: 8, vary: {latency_scale: [1.0, 1.0, 1.25, "
      "1.25, 1.5, 1.5, 2.0, 2.0], packet_loss_delta: [0.0, 0.01, 0.0, "
      "0.01, 0.0, 0.01, 0.0, 0.01]}}",),
     ("pop_tor", "judge_outbox", "route", "merge_heaps")),
)


def campaign_full(torch, card, report):
    """Each CAMPAIGN_RUNS campaign on the main path (the CLI's entry
    function, the captured graph loop; `main_path_run`), its graph run
    under torch.profiler (device ms per kernel, the busy share), in
    timing mode (the Python loop), and each replica against its
    standalone graph run, whose walls are summed beside the
    campaign's."""
    runs = report["_full"]
    for name, example, overrides, path in CAMPAIGN_RUNS:
        print(f"[full:{name}] examples/{example} with {list(overrides)}",
              flush=True)
        path = path + ("loop_control_tally",)
        stats, launches, peak = main_path_run(torch, name, example,
                                              overrides, path)
        rec = stats.ensemble
        R = rec["workload"]["replicas"]
        cfg = full_config(example, overrides)
        device_ms, profiled = profiled_graph_run(
            torch, card, name, cfg, path, stats, launches)
        busy = sum(v for k, v in device_ms.items() if k != "other") / \
            (1e3 * stats.wall_s)
        entry = {"launches": launches, "wall_s": stats.wall_s,
                 "peak": peak, "phases": stats.phases,
                 "host_syncs": stats.host_syncs, "device_ms": device_ms,
                 "profiled": profiled, "replicas": R, "busy_share": busy}
        timed = python_loop_runs(torch, card, name, example, overrides,
                                 path + ("phase_tally",), stats, launches)
        er = timed.pop("runner")
        entry.update(timed)
        rounds = er.loop_stats[0]["rounds"]
        walls = standalone_replicas(er, er.final_state, rounds,
                                    f"full {name}")
        check(er.record["replicas"] == rec["replicas"], f"full {name}: "
              "the timed campaign's record differs from the graph run's")
        entry["standalone_walls_s"] = walls
        # the timed campaign's state and scratch go before the next
        # campaign's peak is measured
        del er, timed
        runs[name] = entry
        print(f"[full:{name}] {R} replicas, {len(stats.host_events_executed)}"
              f" hosts each: {stats.summary()}; rounds per replica "
              f"{rounds}; graph loop: {stats.phases} phases (the longest "
              f"replica), {stats.host_syncs} host syncs, wall "
              f"{stats.wall_s:.3f} s, busy share {busy:.3f} (device ms "
              f"{sum(v for k, v in device_ms.items() if k != 'other'):.1f}"
              f"); the {R} standalone graph runs {walls:.3f} s in all "
              f"({walls / stats.wall_s:.2f} x the campaign); every "
              f"replica == its standalone run; peak {peak} B; card {card}",
              flush=True)


FULL_RUNS = (
    ("phold", "phold.yaml",
     (f"hosts.west.quantity={FULL_HOSTS_PER_GROUP}",
      f"hosts.east.quantity={FULL_HOSTS_PER_GROUP}",
      f"general.stop_time={FULL_STOP}"),
     ("pop_phase", "judge_outbox", "route", "merge_heaps")),
    ("tgen_10000", "tgen_10000.yaml", (),
     ("pop_tgen", "judge_outbox", "route", "merge_heaps")),
    ("tgen_10000_x10", "tgen_10000.yaml",
     tuple(f"hosts.{g}.quantity={10 * q}"
           for g, q in TGEN_QUANTITY.items()),
     ("pop_tgen", "judge_outbox", "route", "merge_heaps")),
    ("tor_small", "tor_small.yaml", (),
     ("pop_tor", "judge_outbox", "route", "merge_heaps")),
    ("tor_large", "tor_large.yaml", (),
     ("pop_tor", "judge_outbox", "route", "merge_heaps")),
    # PHOLD_1M_YAML, written here (no example file holds it)
    ("phold_1m_hier", None, (),
     ("pop_phase_hier", "judge_outbox_hier", "route", "merge_heaps")),
    ("tgen_10000_nic", "tgen_10000.yaml", TGEN_NIC,
     ("pop_tgen_nic", "count_paths", "route", "merge_heaps")),
    ("phold_1m_hier_faults", None, (PHOLD_1M_FAULTS,),
     ("pop_phase_ep_hier", "judge_outbox_ep_hier", "route",
      "merge_heaps")),
)


# the full runs whose Python loop also runs untimed, for walls of both
# loops from one call
BOTH_LOOPS = ("phold", "tgen_10000", "tgen_10000_nic", "tor_small")
# the full run repeated with the state audit
AUDITED = "phold_1m_hier"


def full_config(example, overrides):
    from shadow_tpu_torch.config import load_config, load_config_str

    if example is None:
        return load_config_str(PHOLD_1M_YAML, list(overrides))
    return load_config(os.path.join(REPO, "examples", example),
                       list(overrides))


def main_path_run(torch, name, example, overrides, path):
    """One full run on the main path: the CLI's entry function on the
    card (the captured window loop), launch counts set to 0 just before
    and read just after; admission, peak memory, overflow and the
    kernels of `path` checked (`path` may be a function of the run's
    stats: a planned run's kernels follow its plan). Returns (stats,
    launches, peak)."""
    from shadow_tpu_torch import cli
    from shadow_tpu_torch.device import capacity, runner
    from shadow_tpu_torch.device.kernels import KERNEL_NAMES, Kernels

    kernels = Kernels()
    kernels.library()
    # an earlier run's tensors freed, so that the peak is this run's
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    if example is None:
        stats = runner.run(full_config(None, overrides), device="cuda",
                           kernels=kernels)
    else:
        stats = cli.simulate(os.path.join(REPO, "examples", example),
                             overrides, device="cuda", kernels=kernels)
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    est = stats.admission["estimate"]["per_device"]
    print(f"[full:{name}] {capacity.verdict_line(stats.admission)}; "
          f"measured peak {peak} B ({peak / est:.3f} x the estimate)",
          flush=True)
    check(stats.admission["action"] == "admit",
          f"full {name}: admission {stats.admission['action']}")
    check(est / capacity.FOOTPRINT_TOLERANCE <= peak
          <= est * capacity.FOOTPRINT_TOLERANCE,
          f"full {name}: peak {peak} B is not within "
          f"{capacity.FOOTPRINT_TOLERANCE}x of the estimate {est} B")
    check(stats.overflow == 0 and stats.x_overflow == 0,
          f"full {name}: overflow {stats.overflow}, x_overflow "
          f"{stats.x_overflow}")
    check(stats.ok and stats.loop == "graph",
          f"full {name}: run not ok, or not the graph loop ({stats.loop})")
    if callable(path):
        path = path(stats)
    for k in path:
        check(launches[k] > 0, f"full {name}: {k} never launched")
    for k in set(KERNEL_NAMES) - set(path):
        check(launches[k] == 0, f"full {name}: {k} launched off its path")
    return stats, launches, peak


def python_loop_runs(torch, card, name, example, overrides, path, stats,
                     launches) -> dict:
    """A full run's config again through the Python loop: untimed (for
    BOTH_LOOPS) and in timing mode, for a per-kernel breakdown of that
    loop; the counts equal the graph run's (`stats`). Their kernels are
    freed on return, before the next run's peak is measured."""
    from shadow_tpu_torch.device.kernels import Kernels

    entry = {}
    if name in BOTH_LOOPS:
        py, _ = engine_run(full_config(example, overrides), "cuda",
                           "run_python")
        same_run(stats, py, f"full {name}", ("graph loop", "python loop"))
        entry["python_wall_s"] = py.wall_s
        print(f"[full:{name}] python loop, untimed: wall "
              f"{py.wall_s:.3f} s, {py.host_syncs} host syncs; graph "
              f"loop {stats.wall_s:.3f} s ({stats.wall_s / py.wall_s:.3f}"
              f" x); card {card}", flush=True)
    timed_k = Kernels(timing=True)
    timed, er = run_config(full_config(example, overrides), "cuda",
                           timed_k)
    if er is not None:
        entry["runner"] = er
    check(timed.loop == "python", f"full {name}: timing mode ran the "
          f"{timed.loop} loop")
    same_run(stats, timed, f"full {name}", ("graph loop",
                                            "timed python loop"))
    kernel_ms = timed_k.kernel_ms()
    for k in path:
        print(f"[full:{name}] {k}: {launches[k]} launches in the graph "
              f"run; timed python loop {timed_k.launches[k]} launches, "
              f"{kernel_ms[k]:.3f} ms in total; card {card}", flush=True)
    print(f"[full:{name}] timed python loop: wall {timed.wall_s:.3f} s, "
          f"outside the kernels (the host loop, a remainder) "
          f"{1e3 * timed.wall_s - sum(kernel_ms.values()):.3f} ms; card "
          f"{card}", flush=True)
    entry.update(timed_ms={k: v if timed_k.launches[k] else None
                           for k, v in kernel_ms.items()},
                 timed_wall_s=timed.wall_s)
    return entry


# profiled graph runs made at most, until one sees every launch
PROFILE_ATTEMPTS = 2
# the CUDA functions of csrc/*.cu, by the kind of launch they belong
# to; a run's path holds one kernel row of each kind. A wrapper launch
# starts each of its functions once, K5's pass kernel once a pass.
FUNCTION_KIND = {
    "pop_kernel": "pop_", "judge_outbox_kernel": "judge_outbox",
    "judge_scan_kernel": "judge_outbox",
    "count_paths_kernel": "count_paths",
    "count_paths_rows_kernel": "count_paths",
    "count_paths_popped_kernel": "count_paths",
    "phase_tally_kernel": "phase_tally",
    **dict.fromkeys(("route_compact_kernel", "route_pass_kernel",
                     "route_bounds_kernel"), "route"),
    "merge_scan_kernel": "merge_heaps", "merge_heaps_kernel": "merge_heaps",
    "loop_control_kernel": "loop_control",
    "loop_control_tally_kernel": "loop_control_tally",
    "phase_tally_rows_kernel": "phase_tally",
    "head_min_kernel": "loop_control", "control_kernel": "loop_control",
    "audit_tiles_kernel": "audit_round",
    "audit_hosts_kernel": "audit_round",
    "audit_conserve_kernel": "audit_round",
    **dict.fromkeys(("compact_rows_kernel", "compact_wide_kernel",
                     "compact_outbox_kernel"), "compact_outbox")}


def profiled_graph_run(torch, card, name, cfg, path, stats, launches):
    """The main path's graph run once more under torch.profiler (CUPTI
    traces each kernel of a replayed graph). Returns ({row: summed
    device ms}, {row: kernels the profiler saw}) for the kernel rows of
    `path`, and under "other" every other device op (the state's upload,
    torch's fills and copies, the audit's memset, the engine's fresh
    word). Each wrapper launch starts each of its CUDA functions once
    (K5's pass kernel once a radix pass), so a row's functions are seen
    at most its launches and each row at least once. CUPTI may drop records of a run of many short kernels (one
    H100 run saw 2,425 of 2,625 head_min_kernel): the run is profiled
    again, at most PROFILE_ATTEMPTS times, until every launch is seen,
    and the attempt that saw the most is kept; its ms are the sums over
    the kernels it saw. The counts equal the unprofiled run's
    (`stats`)."""
    best = None
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        ms, seen, wall = _profile_once(torch, name, cfg, path, stats,
                                       launches)
        missing = sum(launches[k] - seen.get(k, 0) for k in path)
        if best is None or missing < best[0]:
            best = (missing, ms, seen, wall, attempt)
        if not missing:
            break
        print(f"[full:{name}] profiled graph run, attempt {attempt}: "
              f"the profiler dropped {missing} kernel records ("
              + ", ".join(f"{k} {seen.get(k, 0)}/{launches[k]}"
                          for k in path if seen.get(k, 0) < launches[k])
              + ")", flush=True)
    missing, ms, seen, wall, attempt = best
    for row in path:
        check(seen.get(row, 0) > 0, f"full {name}: the profiler saw no "
              f"kernel of {row} in {PROFILE_ATTEMPTS} profiled runs")
    print(f"[full:{name}] profiled graph run (attempt {attempt}; device "
          f"ms per kernel, torch.profiler): " + ", ".join(
              f"{k} {v:.3f}" for k, v in sorted(ms.items(),
                                                key=lambda x: -x[1]))
          + "; kernels seen of launched: " + ", ".join(
              f"{k} {n}/{launches[k]}" for k, n in seen.items())
          + f"; wall {wall:.3f} s; card {card}", flush=True)
    return ms, seen


def _profile_once(torch, name, cfg, path, stats, launches, kernels=None):
    """One profiled graph run (on `kernels`, default a new Kernels):
    ({row: device ms}, {row: kernels seen}, wall s), with the checks of
    `profiled_graph_run`."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from shadow_tpu_torch.device.kernels import Kernels

    kernels = Kernels() if kernels is None else kernels
    kernels.reset_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prof_stats, _ = run_config(cfg, "cuda", kernels)
        torch.cuda.synchronize()
    same_run(stats, prof_stats, f"full {name}", ("graph loop",
                                                 "profiled graph loop"))
    check(kernels.launches == launches, f"full {name}: the profiled run "
          "launched other counts")
    ms, seen = {}, {}
    for e in prof.key_averages():
        m = re.search(r"(\w+_kernel)\b", e.key)
        kind = FUNCTION_KIND.get(m.group(1)) if m else None
        row = next((k for k in path if kind and k.startswith(kind)),
                   "other")
        ms[row] = ms.get(row, 0.0) + e.self_device_time_total / 1e3
        if row != "other":
            # K5 starts its pass kernel once a radix pass, the same
            # number each launch of a run
            n = e.count
            if m.group(1) == "route_pass_kernel" and launches[row]:
                n = e.count // max(1, round(e.count / launches[row]))
            check(n <= launches[row], f"full {name}: the profiler "
                  f"saw {e.count} {m.group(1)} of {launches[row]} {row}")
            seen[row] = min(seen.get(row, n), n)
    return ms, seen, prof_stats.wall_s


def full_phase(torch, card, report):
    from shadow_tpu_torch.device.kernels import AUD

    runs, graph = {}, {}
    for name, example, overrides, path in FULL_RUNS:
        print(f"[full:{name}] "
              + (f"examples/{example}" if example else
                 "PHOLD_1M_YAML (chip_smoke.py)")
              + f" with {list(overrides)}", flush=True)
        path = path + ("loop_control_tally",)
        stats, launches, peak = main_path_run(torch, name, example,
                                              overrides, path)
        hosts = len(stats.host_events_executed)
        if stats.path_packets is not None:
            print(f"[full:{name}] path counters: "
                  f"{sum(stats.path_packets.values())} packets sent over "
                  f"{len(stats.path_packets)} vertex pairs", flush=True)
        print(f"[full:{name}] {hosts} hosts: {stats.summary()}; graph "
              f"loop: {stats.phases} phases, {stats.host_syncs} host "
              f"syncs, wall {stats.wall_s:.3f} s; "
              f"{stats.events_executed / stats.wall_s:.0f} events/s; "
              f"{stats.packets_sent / stats.wall_s:.0f} packets/s; peak "
              f"device memory {peak} B; card {card}", flush=True)
        graph[name] = stats
        entry = {"launches": launches, "wall_s": stats.wall_s,
                 "peak": peak, "phases": stats.phases,
                 "host_syncs": stats.host_syncs, "stats": stats}
        entry["device_ms"], entry["profiled"] = profiled_graph_run(
            torch, card, name, full_config(example, overrides), path,
            stats, launches)
        # the Python loop launches the standalone tally and no K9
        entry.update(python_loop_runs(torch, card, name, example,
                                      overrides, path + ("phase_tally",),
                                      stats, launches))
        runs[name] = entry
    # the audit's share of a million-host run's wall
    name, example, overrides, path = next(r for r in FULL_RUNS
                                          if r[0] == AUDITED)
    path = tuple(k + AUD if k.startswith("pop_") else k for k in path) + \
        ("loop_control_tally", "audit_round")
    stats, launches, peak = main_path_run(torch, f"{name}_audit", example,
                                          overrides + (AUDIT,), path)
    plain = runs[name]["wall_s"]
    same_run(graph[name], stats, f"full {name}", ("unaudited",
                                                  "audited"))
    device_ms, profiled = profiled_graph_run(
        torch, card, f"{name}_audit",
        full_config(example, overrides + (AUDIT,)), path, stats, launches)
    print(f"[full:{name}_audit] {stats.summary()}; graph loop: "
          f"{stats.phases} phases, {stats.host_syncs} host syncs, wall "
          f"{stats.wall_s:.3f} s against {plain:.3f} s unaudited: the "
          f"audit's share {(stats.wall_s - plain) / stats.wall_s:.4f} of "
          f"the wall; audit_round {launches['audit_round']} launches, "
          f"{device_ms['audit_round']:.3f} device ms; peak {peak} B; "
          f"card {card}", flush=True)
    runs[f"{name}_audit"] = {"launches": launches, "wall_s": stats.wall_s,
                             "peak": peak, "device_ms": device_ms,
                             "profiled": profiled}
    report["_full"] = runs
    campaign_full(torch, card, report)
    hybrid_full(torch, card, report)
    compact_full(torch, card, report)
    plan_full(torch, card, report)


# ----------------------------------------------------------------------
# the segmented advance and the capacity planner (device/supervise.py,
# device/capacity.py, device/runner.py DeviceRunner)
# ----------------------------------------------------------------------
# tests/test_capacity.py's PHOLD, as its planned-run oracles run it
PLAN_PHOLD_YAML = """
general: {{stop_time: 1s, seed: 9}}
network:
  graph:
    type: gml
    inline: |
      graph [
        directed 0
        node [ id 0 bandwidth_down "100 Mbit" bandwidth_up "100 Mbit" ]
        node [ id 1 bandwidth_down "100 Mbit" bandwidth_up "100 Mbit" ]
        edge [ source 0 target 0 latency "30 ms" packet_loss 0.0 ]
        edge [ source 0 target 1 latency "10 ms" packet_loss 0.0 ]
        edge [ source 1 target 1 latency "30 ms" packet_loss 0.0 ]
      ]
experimental:
  scheduler_policy: tpu
  event_capacity: 64
  outbox_capacity: 16
{extra}hosts:
  left:
    quantity: 3
    network_node_id: 0
    processes:
    - {{path: model:phold, args: msgload=2, start_time: 100ms}}
  right:
    quantity: 3
    network_node_id: 1
    processes:
    - {{path: model:phold, args: msgload=2, start_time: 150ms}}
"""
PLAN_WARM = "  capacity_plan: auto\n  capacity_warmup: 600ms\n"
PLAN_FORCED = "  capacity_plan: auto\n  capacity_warmup: 50ms\n"
# tests/test_device_heartbeats.py's config
HB_YAML = """
general: {{stop_time: 2s, seed: 5{hb}}}
network:
  graph:
    type: gml
    inline: |
      graph [ directed 0
        node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        node [ id 1 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
        edge [ source 0 target 0 latency "10 ms" packet_loss 0.0 ]
        edge [ source 0 target 1 latency "10 ms" packet_loss 0.01 ]
        edge [ source 1 target 1 latency "10 ms" packet_loss 0.0 ] ]
experimental: {{scheduler_policy: tpu}}
hosts:
  left:
    quantity: 4
    network_node_id: 0
    processes: [{{path: model:phold, args: msgload=2, start_time: 10ms}}]
  right:
    quantity: 4
    network_node_id: 1
    processes: [{{path: model:phold, args: msgload=2, start_time: 10ms}}]
"""
NODE_ROW = "[shadow-heartbeat] [node] "
# the gloo mesh's planned tgen: TGEN_PARITY_YAML planned from a 3 s
# warm-up in 1 s segments, `exchange: auto`
MESH_PLAN = ("experimental.exchange=auto", "experimental.capacity_plan=auto",
             "experimental.capacity_warmup=3s",
             "experimental.dispatch_segment=1s")
# examples/tgen_100000.yaml as shipped (planned from a 3 s warm-up, in
# 2.5 s segments), with heartbeats every 5 s, and its static
# unsegmented run
TGEN_100K = "tgen_100000.yaml"
TGEN_100K_HB = ("general.heartbeat_interval=5s",)
TGEN_100K_STATIC = ("experimental.capacity_plan=static",
                    "experimental.capacity_warmup=0",
                    "experimental.dispatch_segment=0")
TGEN_PATH = ("pop_tgen", "judge_outbox", "route", "merge_heaps",
             "loop_control_tally")
SEGMENT_PRICE = ("experimental.dispatch_segment=2500ms",)


class LineCount(logging.Handler):
    """Counts the port's log records that hold each needle (keeping the
    first `keep` of each), so that a run of 100,000 hosts' heartbeat rows
    is counted, not printed."""

    def __init__(self, needles, keep=0):
        super().__init__(logging.INFO)
        self.needles, self.keep = needles, keep
        self.counts = dict.fromkeys(needles, 0)
        self.kept = {n: [] for n in needles}

    def emit(self, record):
        # the needles lie in the format strings: a counted record is
        # formatted only where it is kept
        msg = str(record.msg)
        for n in self.needles:
            if n in msg:
                self.counts[n] += 1
                if len(self.kept[n]) < self.keep:
                    self.kept[n].append(record.getMessage())


@contextlib.contextmanager
def counting(*needles, keep=0):
    """The port's INFO records counted by `LineCount` while the block
    runs, and not printed."""
    lg = logging.getLogger("shadow_tpu_torch")
    old = (lg.level, lg.propagate)
    h = LineCount(needles, keep)
    lg.addHandler(h)
    lg.setLevel(logging.INFO)
    lg.propagate = False
    try:
        yield h
    finally:
        lg.removeHandler(h)
        lg.setLevel(old[0])
        lg.propagate = old[1]


def plan_line(stats) -> str:
    p = stats.pipeline or {}
    return (f"{p.get('segments')} segments ({p.get('replayed')} replayed), "
            f"{p.get('host_syncs')} host syncs, {p.get('graph_captures')} "
            f"graph captures over {p.get('engines')} engines, warm-up "
            f"{p.get('warmup_wall_s', 0.0):.3f} s, run wall "
            f"{stats.wall_s:.3f} s")


def plan_parity(torch, report):
    """tests/test_capacity.py's PHOLD on the card (exact): the static
    run; planned from a 600 ms warm-up (no re-plan, knobs unlike the
    static ones) against it and against the CPU plain path's planned
    run (the same plan); the forced overflow (a 50 ms warm-up before the
    first boot: at least one re-plan and replay, the static trace, the
    final marks clean); the planned run's OCC record replayed through
    `capacity_plan: <path>`. Then tests/test_device_heartbeats.py's
    config: 24 `[shadow-heartbeat] [node]` rows, equal to the CPU's row
    by row, the trace and rounds of the run without heartbeats."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner
    from shadow_tpu_torch.device.kernels import Kernels

    def cfg(extra=""):
        return load_config_str(PLAN_PHOLD_YAML.format(extra=extra))

    occ = os.environ["SHADOW_TPU_OCC_DIR"]
    static = runner.run(cfg(), "cuda")
    kernels = Kernels()
    planned = runner.run(cfg(PLAN_WARM), "cuda", kernels=kernels)
    cpu = runner.run(cfg(PLAN_WARM), "cpu")
    what = "planned PHOLD (capacity_warmup 600ms)"
    same_run(planned, static, what, ("planned card", "static card"))
    same_run(planned, cpu, what, ("card", "cpu"))
    rec = planned.occupancy
    check(planned.replans == 0 and rec["planned"] != rec["static"]
          and rec["planned"]["event_capacity"] < 64,
          f"{what}: replans {planned.replans}, plan {rec['planned']}")
    check(rec["planned"] == cpu.occupancy["planned"], f"{what}: the "
          "card's plan differs from the CPU's")
    path = [os.path.join(occ, f) for f in os.listdir(occ)
            if f.startswith("OCC_PholdDevice_6_")]
    check(len(path) == 1, f"{what}: no OCC record written ({path})")
    replay_path = os.path.join(occ, "replay.json")
    shutil.copy(path[0], replay_path)
    forced = runner.run(cfg(PLAN_FORCED), "cuda")
    same_run(forced, static, "forced overflow", ("forced card",
                                                 "static card"))
    fm = forced.occupancy["final_measured"]
    check(forced.replans >= 1 and fm["overflow"] == 0
          and fm["x_overflow"] == 0, f"forced overflow: replans "
          f"{forced.replans}, final marks {fm}")
    replay = runner.run(cfg(f"  capacity_plan: {replay_path}\n"), "cuda")
    same_run(replay, static, "record replay", ("replay card",
                                               "static card"))
    print(f"[parity] {what}: equal to the static card run and the CPU's "
          f"planned run; static {rec['static']} -> planned "
          f"{rec['planned']}, 0 replans; {plan_line(planned)}; forced "
          f"overflow (warm-up 50ms): {forced.replans} replans, applied "
          f"{forced.occupancy['applied']}, {plan_line(forced)}; the OCC "
          f"record replayed: equal, {plan_line(replay)}", flush=True)
    report.setdefault("_parity", {})["parity_plan_phold"] = {
        "launches": dict(kernels.launches)}

    rows = {}
    for dev in ("cuda", "cpu"):
        with counting(NODE_ROW, "[supervise-heartbeat]", keep=10**6) as c:
            rows[dev] = runner.run(load_config_str(HB_YAML.format(
                hb=", heartbeat_interval: 500ms")), dev), c
    hb, c = rows["cuda"]
    plain = runner.run(load_config_str(HB_YAML.format(hb="")), "cuda")
    same_run(hb, plain, "heartbeats", ("heartbeats", "without"))
    check(c.counts[NODE_ROW] == 24 and c.counts["[supervise-heartbeat]"]
          == 3, f"heartbeats: {c.counts}")
    check(c.kept[NODE_ROW] == rows["cpu"][1].kept[NODE_ROW],
          "heartbeats: the card's rows differ from the CPU's")
    print(f"[parity] heartbeats (test_device_heartbeats' config, 500 ms): "
          f"{c.counts[NODE_ROW]} [shadow-heartbeat] [node] rows equal to "
          f"the CPU's row by row, e.g. {c.kept[NODE_ROW][0]!r}; "
          f"{c.kept['[supervise-heartbeat]'][-1]!r}; checksums and "
          f"{hb.rounds} rounds equal to the run without heartbeats; "
          f"{plan_line(hb)}", flush=True)


def campaign_plan_parity(torch, report):
    """examples/ensemble_seed_sweep.yaml with `capacity_plan: auto` and
    heartbeats every second on the card: each replica's trace leaves and
    rounds equal to its standalone graph run (`standalone_replicas`, the
    occupancy marks aside: they count phases, which capacities may
    split), one `[ensemble-heartbeat]` line per replica per boundary."""
    from shadow_tpu_torch.config import load_config
    from shadow_tpu_torch.device.kernels import Kernels
    from shadow_tpu_torch.ensemble.campaign import EnsembleRunner

    kernels = Kernels()
    er = EnsembleRunner(load_config(SWEEP, [
        "experimental.capacity_plan=auto",
        "general.heartbeat_interval=1s"]), "cuda", kernels)
    with counting("[ensemble-heartbeat]", keep=100) as c:
        stats = er.run()
    what = "planned campaign (ensemble_seed_sweep.yaml, heartbeats 1s)"
    check(stats.ok, f"{what}: not ok")
    R = er.worlds.R
    check(c.counts["[ensemble-heartbeat]"] == 2 * R,
          f"{what}: {c.counts} heartbeat lines for {R} replicas")
    final = {k: v for k, v in er.final_state.items()
             if not k.startswith("occ_")}
    walls = standalone_replicas(er, final, er.loop_stats[0]["rounds"], what)
    rec = stats.occupancy
    print(f"[parity] {what}: every replica equal to its standalone "
          f"graph run ({walls:.3f} s summed); static {rec['static']} -> "
          f"planned {rec['planned']}, {stats.replans} replans; "
          f"{c.counts['[ensemble-heartbeat]']} [ensemble-heartbeat] "
          f"lines, e.g. {c.kept['[ensemble-heartbeat]'][0]!r}; "
          f"{plan_line(stats)}", flush=True)
    report.setdefault("_parity", {})["campaign_plan"] = {
        "launches": dict(kernels.launches)}


def mesh_plan_check(stats, one, S, label):
    """A planned mesh run (MESH_PLAN) against the one-device card run:
    the trace, its record's `exchange: auto` choice, the schedule it
    ran, and that schedule's kernels launched."""
    same_run(stats, one, label, ("planned mesh", "one device"))
    rec = stats.occupancy
    info = rec["exchange_auto"]
    check(stats.mesh["exchange"] == info["chosen"] and stats.replans == 0,
          f"{label}: ran {stats.mesh['exchange']}, chose {info}")
    for k in MESH_PATH[info["chosen"]]:
        check(stats.mesh["launches"].get(k, 0) > 0,
              f"{label}: {k} never launched")
    print(f"[mesh] {label}: equal to one device; exchange auto -> "
          f"{info['chosen']} (per-flush row estimates "
          f"{info['estimates']}, groups {info['group_split']}), CAP "
          f"{stats.mesh['cap']}, CAP2 {stats.mesh['cap2']}, plan "
          f"{rec['planned']}; {plan_line(stats)}", flush=True)


def planned_path(stats) -> tuple:
    """The kernels a planned tgen run launches: the warm-up's (the
    static engine: the graph loop folds the tallies into K9) and, where
    the plan compacts the outbox, the planned engine's K11, the phase's
    own tally and K9 alone (DeviceEngine._fold)."""
    if not stats.occupancy["planned"]["outbox_compact"]:
        return TGEN_PATH
    return TGEN_PATH + ("compact_outbox", "phase_tally", "loop_control")


def plan_full(torch, card, report):
    """examples/tgen_100000.yaml as shipped (100,000 hosts to its 30 s
    stop, planned from a 3 s warm-up, 2.5 s segments) with heartbeats
    every 5 s, on the main path, against its static unsegmented graph
    run: per-host checksums, totals and rounds equal; the build and
    warm-up walls, both plans, segments, host syncs and graph captures
    (one per engine, none per segment), both walls and peak memory
    against the admission estimate (`main_path_run`, within
    FOOTPRINT_TOLERANCE). Then tgen_10000.yaml in 2.5 s segments against
    its unsegmented graph run, in turns: the price of a boundary."""
    from shadow_tpu_torch.config import load_config
    from shadow_tpu_torch.core.build import build

    path = os.path.join(REPO, "examples", TGEN_100K)
    t0 = time.perf_counter()
    build(load_config(path, list(TGEN_100K_HB)))
    build_wall = time.perf_counter() - t0
    static, s_launches, s_peak = main_path_run(
        torch, "tgen_100000_static", TGEN_100K, TGEN_100K_STATIC, TGEN_PATH)
    with counting(NODE_ROW, "[supervise-heartbeat]", keep=3) as c:
        planned, launches, peak = main_path_run(
            torch, "tgen_100000", TGEN_100K, TGEN_100K_HB, planned_path)
    bare, b_launches, _ = main_path_run(torch, "tgen_100000_as_shipped",
                                        TGEN_100K, (), planned_path)
    report["_tgen_100000"] = bare
    what = "tgen_100000 (as shipped, heartbeats 5s)"
    same_run(planned, static, what, ("planned segmented",
                                     "static unsegmented"))
    same_run(bare, static, "tgen_100000 (as shipped)",
             ("planned segmented", "static unsegmented"))
    p, rec = planned.pipeline, planned.occupancy
    H = len(planned.host_events_executed)
    check(p["segments"] >= 12 and p["graph_captures"] <= p["engines"],
          f"{what}: {p}")
    check(c.counts[NODE_ROW] == 5 * H and
          c.counts["[supervise-heartbeat]"] == 5,
          f"{what}: heartbeat lines {c.counts}")
    est = planned.admission["estimate"]["per_device"]
    print(f"[full:tgen_100000] {H} hosts: build {build_wall:.3f} s; "
          f"warm-up {p['warmup_wall_s']:.3f} s; static {rec['static']} "
          f"-> planned {rec['planned']}, {planned.replans} replans; "
          f"{plan_line(planned)}; static unsegmented graph wall "
          f"{static.wall_s:.3f} s ({static.host_syncs} host syncs), "
          f"planned segmented wall {planned.wall_s:.3f} s; events/s "
          f"{planned.events_executed / planned.wall_s:.0f} planned, "
          f"{static.events_executed / static.wall_s:.0f} static; peak "
          f"{peak} B against the estimate {est} B ({peak / est:.3f} x), "
          f"static peak {s_peak} B; {c.counts[NODE_ROW]} heartbeat rows, "
          f"{c.kept['[supervise-heartbeat]'][-1]!r}; {planned.summary()}; "
          f"card {card}", flush=True)
    print(f"[full:tgen_100000_as_shipped] without heartbeats: "
          f"{plan_line(bare)}; {bare.events_executed / bare.wall_s:.0f} "
          f"events/s; the heartbeats' share of the run with them "
          f"{(planned.wall_s - bare.wall_s) / planned.wall_s:.3f}; card "
          f"{card}", flush=True)
    runs = report.setdefault("_extra", {})
    runs["full_tgen_100000"] = {"launches": launches}
    runs["full_tgen_100000_as_shipped"] = {"launches": b_launches}
    runs["full_tgen_100000_static"] = {"launches": s_launches}
    walls = {"unsegmented": [], "segmented": []}
    for turn in ("unsegmented", "segmented", "segmented", "unsegmented"):
        st, ln, _ = main_path_run(
            torch, f"tgen_10000_{turn}", "tgen_10000.yaml",
            SEGMENT_PRICE if turn == "segmented" else (), TGEN_PATH)
        walls[turn].append(st)
        runs[f"full_tgen_10000_{turn}_{len(walls[turn])}"] = {
            "launches": ln}
    seg, uns = walls["segmented"], walls["unsegmented"]
    same_run(seg[0], uns[0], "tgen_10000 in 2.5 s segments",
             ("segmented", "unsegmented"))
    n = seg[0].pipeline["segments"]
    ws = [x.wall_s for x in seg]
    wu = [x.wall_s for x in uns]
    print(f"[full:tgen_10000_segments] {n} segments of 2.5 s against one: "
          f"walls {', '.join(f'{w:.4f}' for w in ws)} s segmented, "
          f"{', '.join(f'{w:.4f}' for w in wu)} s unsegmented (in turns); "
          f"a boundary costs {(sum(ws) - sum(wu)) / 2 / (n - 1) * 1e3:.3f} "
          f"ms ({seg[0].host_syncs} against {uns[0].host_syncs} host "
          f"syncs, {seg[0].pipeline['graph_captures']} graph capture(s)); "
          f"card {card}", flush=True)


def plan_phase(torch, card, report):
    """Every check of the planner and the segmented advance alone (a
    short call after a change to them); the default run makes them in
    the parity, mesh and full phases."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner

    plan_parity(torch, report)
    campaign_plan_parity(torch, report)
    one = runner.run(load_config_str(TGEN_PARITY_YAML), "cuda")
    for S in (2, 4):
        cfg = load_config_str(TGEN_PARITY_YAML, [
            f"experimental.mesh_shards={S}", *MESH_PLAN])
        (stats, _), = runner.mesh_runs(["cuda:0"] * S, [cfg])
        mesh_plan_check(stats, one, S, f"planned tgen, S={S}")
    plan_full(torch, card, report)
    report.pop("_extra", None)
    report.pop("_parity", None)


# ----------------------------------------------------------------------
# supervision: checkpoints, the preemption drain, retry and failover
# (device/checkpoint.py, device/supervise.py, device/chaos.py)
# ----------------------------------------------------------------------
# examples/tgen_100000.yaml as shipped with rotating checkpoints
SUP_ROTATION = ("experimental.checkpoint_every=10s",
                "experimental.checkpoint_keep=2")
# the pause half way (phold.yaml's 10 s, the cut tor_small's 15 s)
SUP_PHOLD_PAUSE = "5s"
SUP_TOR_PAUSE = "7500ms"
# tgen_10000 x 8 in batches of 4 with 10 s segments and rotation every
# 10 s, drained after the fifth segment (the second batch's second: at
# 20 s of its 30)
SUP_CAMPAIGN = ("ensemble={replicas: 8, replica_batch: 4, vary: {seed: "
                "[1, 2, 3, 4, 5, 6, 7, 8]}}",
                "experimental.dispatch_segment=10s")
SUP_CAMPAIGN_DRAIN_AT = 5
# tgen_10000 in 2.5 s segments, a transient error at the fourth dispatch
# (segment 3), rotation every 7.5 s with its third entry (22.5 s, the
# newest) truncated: the resume lands on the second (15 s)
SUP_RETRY = ("experimental.dispatch_segment=2500ms",
             "experimental.dispatch_retries=2",
             "experimental.dispatch_retry_backoff=0",
             "experimental.checkpoint_every=7500ms",
             "experimental.checkpoint_keep=3",
             "experimental.chaos=[{kind: dispatch_error, segment: 3}, "
             "{kind: checkpoint_corrupt, entry: 2}]")
# the parity PHOLD failing over to hybrid at its third dispatch
SUP_FAILOVER = ("experimental.dispatch_segment=250ms",
                "experimental.dispatch_retries=0",
                "experimental.failover=hybrid",
                "experimental.chaos=[{kind: dispatch_error, segment: 2}]")


def resumed(part, res, full, what):
    """A paused (or drained) run `part` and its resume `res` against the
    uninterrupted run `full`: the resume's per-host events and
    checksums and totals equal, the pair's rounds summing to the
    uninterrupted run's (`part` may be a rounds count)."""
    rounds = part if isinstance(part, int) else part.rounds
    check(rounds + res.rounds == full.rounds,
          f"{what}: rounds {rounds} + {res.rounds} != {full.rounds}")
    res = dataclasses.replace(res, rounds=full.rounds)
    same_run(res, full, what, ("resumed", "uninterrupted"))


def io_line(io: dict) -> str:
    return f"{io['bytes']} B in {io['wall_s']:.3f} s"


def run_path(stats) -> tuple:
    """The kernels a tgen run's last engine launches: compacting (a
    planned or adopted `outbox_compact`) K11 with the tally and K9
    apart, else K9 with the tally folded in; a planned run also its
    static warm-up engine's (`planned_path`)."""
    eff = stats.occupancy["effective"]
    path = TGEN_PATH[:4]
    if 0 < eff["CX"] < eff["OB"]:
        path += ("compact_outbox", "phase_tally", "loop_control")
    else:
        path += ("loop_control_tally",)
    if "planned" in stats.occupancy:
        path = tuple(sorted(set(path) | set(planned_path(stats))))
    return path


def drain_child(base: str, overrides) -> tuple:
    """examples/tgen_100000.yaml through `python -m shadow_tpu_torch.cli`
    in a child process on the card, SIGTERM sent once its first rotation
    entry exists: (exit code, seconds from the signal to the exit, the
    rounds it ran, its output)."""
    import re
    import signal

    from shadow_tpu_torch.device import supervise

    cmd = [sys.executable, "-m", "shadow_tpu_torch.cli",
           os.path.join(REPO, "examples", TGEN_100K)]
    for o in overrides:
        cmd += ["-o", o]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 300
        while not supervise.rotation_entries(base):
            check(proc.poll() is None and time.monotonic() < deadline,
                  f"drain child: no rotation entry (rc {proc.poll()})")
            time.sleep(0.005)
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=300)
        wall = time.perf_counter() - t0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    m = re.search(r"simulation finished at \S+: .* (\d+) rounds", out)
    check(m is not None, f"drain child: no summary line\n{out[-3000:]}")
    return proc.returncode, wall, int(m.group(1)), out


def supervise_full(torch, card, report, work):
    """tgen_100000.yaml as shipped (planned, 2.5 s segments) with
    rotating checkpoints every 10 s, keep 2: two `.t` entries, the final
    state equal to its uninterrupted planned run, the captures, one
    save's and one load's wall and bytes, both walls; then the same
    config through the CLI in a child process on the card, SIGTERM once
    the first entry exists: exit 75, the signal-to-exit wall, and the
    resume from the base path equal to the uninterrupted run."""
    from shadow_tpu_torch.device import supervise

    runs = report.setdefault("_extra", {})
    base = report.get("_tgen_100000")
    if base is None:
        base, ln, _ = main_path_run(torch, "tgen_100000_as_shipped",
                                    TGEN_100K, (), planned_path)
        runs["supervise_tgen_100000"] = {"launches": ln}
    ck = os.path.join(work, "tgen_100000.npz")
    rot, ln, peak = main_path_run(
        torch, "tgen_100000_rotated", TGEN_100K,
        SUP_ROTATION + (f"experimental.checkpoint_save={ck}",),
        planned_path)
    runs["supervise_tgen_100000_rotated"] = {"launches": ln}
    what = "tgen_100000 rotated every 10 s, keep 2"
    same_run(rot, base, what, ("rotated", "uninterrupted"))
    entries = supervise.rotation_entries(ck)
    check([t for t, _ in entries] == [10**10, 2 * 10**10],
          f"{what}: rotation entries {entries}")
    io = rot.pipeline["checkpoint_io"]
    save = io["rotation"][0]
    print(f"[supervise:tgen_100000] {what}: equal to the uninterrupted "
          f"planned run; entries {[os.path.basename(p) for _, p in entries]}"
          f"; a rotation save {io_line(save)}, the end-of-run save "
          f"{io_line(io['save'])}; graph captures {rot.pipeline['graph_captures']}"
          f" (uninterrupted {base.pipeline['graph_captures']}) over "
          f"{rot.pipeline['engines']} engines; rotated wall "
          f"{rot.wall_s:.3f} s against {base.wall_s:.3f} s unrotated "
          f"(saves included); {rot.pipeline['segments']} segments; peak "
          f"{peak} B; card {card}", flush=True)
    dbase = os.path.join(work, "drain.npz")
    rc, wall, rounds, out = drain_child(
        dbase, SUP_ROTATION + (f"experimental.checkpoint_save={dbase}",))
    check(rc == 75, f"drain child: exit {rc}\n{out[-3000:]}")
    entries = supervise.rotation_entries(dbase)
    res, ln, _ = main_path_run(
        torch, "tgen_100000_resumed", TGEN_100K,
        (f"experimental.checkpoint_load={dbase}",), run_path)
    runs["supervise_tgen_100000_resumed"] = {"launches": ln}
    resumed(rounds, res, base, "tgen_100000 drained and resumed")
    load = res.pipeline["checkpoint_io"]["load"]
    print(f"[supervise:tgen_100000_drain] the CLI child exited 75 "
          f"{wall:.3f} s after SIGTERM, at "
          f"{entries[-1][0] / 1e9:.1f} s of simulated time ({rounds} "
          f"rounds); entries {[t / 1e9 for t, _ in entries]} s; the resume "
          f"from the base path: a load {io_line(load)}, {res.rounds} "
          f"rounds, wall {res.wall_s:.3f} s, graph captures "
          f"{res.pipeline['graph_captures']}; equal to the uninterrupted "
          f"run; card {card}", flush=True)


def supervise_pauses(torch, card, report, work):
    """`checkpoint_save_time` half way on phold.yaml (2 x 50,000 hosts)
    and on tor_small cut to TOR_PARITY_STOP, each resumed on the card
    and equal to its uninterrupted card run; the cut tor_small's pair
    also equal to the CPU plain path's uninterrupted run (the parity
    phase's, or one made here)."""
    from shadow_tpu_torch.config import load_config
    from shadow_tpu_torch.device import runner

    full = report.get("_full", {})
    runs = report.setdefault("_extra", {})
    name, example, overrides, path = FULL_RUNS[0]
    path = path + ("loop_control_tally",)
    one = (full["phold"]["stats"] if "phold" in full else
           main_path_run(torch, "phold", example, overrides, path)[0])
    ck = os.path.join(work, "phold.npz")
    part, ln, _ = main_path_run(
        torch, "phold_paused", example, overrides + (
            f"experimental.checkpoint_save={ck}",
            f"experimental.checkpoint_save_time={SUP_PHOLD_PAUSE}"), path)
    runs["supervise_phold_paused"] = {"launches": ln}
    res, ln, _ = main_path_run(torch, "phold_resumed", example, overrides
                               + (f"experimental.checkpoint_load={ck}",),
                               path)
    runs["supervise_phold_resumed"] = {"launches": ln}
    resumed(part, res, one, "phold.yaml paused at 5 s")
    io = part.pipeline["checkpoint_io"]["save"]
    print(f"[supervise:phold] phold.yaml (100,000 hosts) paused at "
          f"{SUP_PHOLD_PAUSE} ({part.rounds} rounds, {io_line(io)}) and "
          f"resumed (a load {io_line(res.pipeline['checkpoint_io']['load'])}"
          f", {res.rounds} rounds): equal to the uninterrupted run; card "
          f"{card}", flush=True)
    tor = os.path.join(REPO, "examples", "tor_small.yaml")
    stop = [f"general.stop_time={TOR_PARITY_STOP}"]
    tck = os.path.join(work, "tor.npz")

    def tor_run(device, *extra):
        return runner.run(load_config(tor, stop + list(extra)), device)

    card_full = tor_run("cuda")
    part = tor_run("cuda", f"experimental.checkpoint_save={tck}",
                   f"experimental.checkpoint_save_time={SUP_TOR_PAUSE}")
    res = tor_run("cuda", f"experimental.checkpoint_load={tck}")
    cpu = report.get("_cpu_runs", {}).get("tor") or tor_run("cpu")
    resumed(part, res, card_full, "cut tor_small paused")
    resumed(part, res, cpu, "cut tor_small paused, against the cpu")
    print(f"[supervise:tor_small] tor_small to {TOR_PARITY_STOP} paused at "
          f"{SUP_TOR_PAUSE} ({part.rounds} rounds) and resumed on the card "
          f"({res.rounds} rounds): equal to the card's and the CPU plain "
          f"path's uninterrupted runs; card {card}", flush=True)


def supervise_campaign(torch, card, report, work):
    """tgen_10000 x 8 in replica batches of 4 with rotating checkpoints,
    drained in its second batch (the guard's request after the sixth
    segment) and resumed from that batch's entry: the record's replicas
    (per-replica totals and checksums) equal to the uninterrupted
    batched campaign's."""
    from shadow_tpu_torch.config import load_config
    from shadow_tpu_torch.device.engine import DeviceEngine
    from shadow_tpu_torch.device.kernels import Kernels
    from shadow_tpu_torch.ensemble.campaign import EnsembleRunner

    path = os.path.join(REPO, "examples", "tgen_10000.yaml")
    base = os.path.join(work, "campaign.npz")
    rot = (f"experimental.checkpoint_save={base}",
           "experimental.checkpoint_every=10s")
    full = EnsembleRunner(load_config(path, list(SUP_CAMPAIGN)),
                          "cuda").run()
    er = EnsembleRunner(load_config(path, list(SUP_CAMPAIGN + rot)),
                        "cuda")
    orig, calls = DeviceEngine.run, [0]

    def counted(self, state, stop=None, final_stop=None):
        out = orig(self, state, stop=stop, final_stop=final_stop)
        calls[0] += 1
        if calls[0] == SUP_CAMPAIGN_DRAIN_AT:
            er.guard.request()
        return out

    DeviceEngine.run = counted
    try:
        pre = er.run()
    finally:
        DeviceEngine.run = orig
    check(pre.preempted and ".b1.t" in pre.resume_path,
          f"campaign drain: preempted {pre.preempted}, {pre.resume_path}")
    kernels = Kernels()
    res = EnsembleRunner(load_config(path, list(SUP_CAMPAIGN + rot) + [
        f"experimental.checkpoint_load={base}.b1"]), "cuda",
        kernels).run()
    check(res.ok and res.ensemble["replicas"] == full.ensemble["replicas"],
          "campaign drained and resumed: the replicas differ from the "
          "uninterrupted campaign's")
    report.setdefault("_extra", {})["supervise_campaign_resumed"] = {
        "launches": dict(kernels.launches)}
    saves = pre.pipeline["checkpoint_io"]["rotation"]
    print(f"[supervise:campaign] tgen_10000 x 8, replica_batch 4, drained "
          f"at {pre.end_time / 1e9:.1f} s of batch 1 ({pre.resume_path}, "
          f"{len(saves)} rotation saves, e.g. {io_line(saves[-1])}) and "
          f"resumed (a load {io_line(res.pipeline['checkpoint_io']['load'])}"
          f"): every replica equal to the uninterrupted campaign; walls "
          f"{full.wall_s:.3f} s uninterrupted, {pre.wall_s:.3f} + "
          f"{res.wall_s:.3f} s drained and resumed; card {card}", flush=True)


def supervise_retry(torch, card, report, work):
    """tgen_10000 in 2.5 s segments, a scripted transient error at
    segment 3 retried once from the validated copy (equal to the
    uninterrupted run, the replay's wall printed), its third rotation
    entry truncated by the chaos schedule: the base path resolves to the
    second, whose resume finishes equal. Then the parity PHOLD under
    `failover: hybrid` with one error and no retry: the hybrid rerun has
    the device run's traces, and its checkpoint resumes on the card to
    the same result."""
    from shadow_tpu_torch.config import load_config_str
    from shadow_tpu_torch.device import runner, supervise

    full = report.get("_full", {})
    path = TGEN_PATH[:4] + ("loop_control_tally",)
    one = (full["tgen_10000"]["stats"] if "tgen_10000" in full else
           main_path_run(torch, "tgen_10000", "tgen_10000.yaml", (),
                         path)[0])
    base = os.path.join(work, "retry.npz")
    st, ln, _ = main_path_run(torch, "tgen_10000_retry", "tgen_10000.yaml",
                              SUP_RETRY + (f"experimental.checkpoint_save="
                                           f"{base}",), path)
    report.setdefault("_extra", {})["supervise_tgen_10000_retry"] = {
        "launches": ln}
    p = st.pipeline
    check(st.retries == 1 and p["replayed"] == 1,
          f"retry: retries {st.retries}, replayed {p['replayed']}")
    same_run(st, one, "tgen_10000 retried", ("retried", "uninterrupted"))
    entries = supervise.rotation_entries(base)
    os.unlink(base)
    got = supervise.resolve_checkpoint(base)
    check([t for t, _ in entries] == [75 * 10**8, 15 * 10**9,
                                      225 * 10**8] and got == entries[1][1],
          f"corrupt entry: entries {entries}, resolved {got}")
    res, ln, _ = main_path_run(torch, "tgen_10000_corrupt_resume",
                               "tgen_10000.yaml",
                               (f"experimental.checkpoint_load={base}",),
                               path)
    report["_extra"]["supervise_tgen_10000_corrupt_resume"] = {
        "launches": ln}
    # the rounds before 15 s are not recorded apart: the resume's
    # totals and checksums against the uninterrupted run's
    same_run(dataclasses.replace(res, rounds=one.rounds), one,
             "tgen_10000 resumed past a corrupt entry",
             ("resumed", "uninterrupted"))
    print(f"[supervise:retry] tgen_10000 in 2.5 s segments, a scripted "
          f"UNAVAILABLE at segment 3: {st.retries} retry, the copy put "
          f"back in {p['recover_s'][0] * 1e3:.3f} ms, the replayed segment "
          f"{p['replay_s'][0] * 1e3:.3f} ms, graph captures "
          f"{p['graph_captures']}, wall {st.wall_s:.3f} s against "
          f"{one.wall_s:.3f} s; equal to the uninterrupted run. Entry 2 "
          f"truncated: {os.path.basename(got)} resolved and resumed equal "
          f"({res.rounds} rounds); card {card}", flush=True)
    fo_ck = os.path.join(work, "failover.npz")
    plain = runner.run(load_config_str(PARITY_YAML), "cuda")
    fo = runner.run(load_config_str(PARITY_YAML, list(SUP_FAILOVER) + [
        f"experimental.checkpoint_save={fo_ck}"]), "cuda")
    check(fo.policy == "hybrid" and fo.failover_checkpoint ==
          fo_ck + ".failover", f"failover: policy {fo.policy}, "
          f"checkpoint {fo.failover_checkpoint!r}")
    for f in ("events_executed", "packets_sent", "packets_dropped",
              "packets_delivered"):
        check(getattr(fo, f) == getattr(plain, f),
              f"failover: {f} {getattr(fo, f)} != {getattr(plain, f)}")
    check(np.array_equal(fo.host_trace_checksum, plain.host_trace_checksum),
          "failover: the hybrid rerun's checksums differ")
    res = runner.run(load_config_str(PARITY_YAML, [
        f"experimental.checkpoint_load={fo.failover_checkpoint}"]), "cuda")
    check(res.loop == "graph", "failover resume: not the graph loop")
    # the failed device run's rounds are not reported: totals and
    # checksums against the uninterrupted device run's
    same_run(dataclasses.replace(res, rounds=plain.rounds), plain,
             "the failover checkpoint resumed", ("resumed", "device"))
    print(f"[supervise:failover] the parity PHOLD, one scripted error, no "
          f"retry: the hybrid rerun ({fo.wall_s:.3f} s) equal to the "
          f"device run ({plain.wall_s:.3f} s); {fo.failover_checkpoint} "
          f"resumed on the card ({res.rounds} rounds) equal; card {card}",
          flush=True)


def supervise_phase(torch, card, report):
    """Checkpoints, the drain, retry and failover on the card; every
    check bit-equal in per-host events and checksums, totals and
    rounds (a resumed pair's rounds summed)."""
    work = tempfile.mkdtemp(prefix="chip_smoke_ck_")
    try:
        supervise_full(torch, card, report, work)
        supervise_pauses(torch, card, report, work)
        supervise_campaign(torch, card, report, work)
        supervise_retry(torch, card, report, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def mesh_supervise(torch, card, report, spawned):
    """phold.yaml (2 x 50,000 hosts) on 2 ranks, saved half way and
    resumed on 2 ranks (both in `mesh_card_runs`' S = 2 spawn), equal to
    one device (its one-device run kept for `mesh_shrink`); its
    checkpoint refused on a pool of one rank with the reference's
    message (a pool of 4 adopts its 2 shards since ROADMAP (a) 13.1,
    `mesh_shrink` checks that)."""
    from shadow_tpu_torch.device import runner

    name, example, overrides, _, _, _ = MESH_FULL[0]
    one = runner.run(full_config(example, overrides[:-1]), device="cuda")
    ck = os.path.join(spawned["work"], "phold_s2.npz")
    part, res = (spawned["supervise"][k] for k in ("save", "resume"))
    resumed(part, res, one, f"phold.yaml S = 2 paused at {MESH_SUP_PAUSE}")
    spawned["phold_one"] = one
    try:
        runner.mesh_runs(["cuda:0"], [full_config(
            example, overrides + (f"experimental.checkpoint_load={ck}",))])
        refused = ""
    except ValueError as e:
        refused = str(e)
    check("saved on 2 shard(s) but only 1 device(s) are available"
          in refused, f"mesh resume on a pool of one: {refused!r}")
    report.setdefault("_mesh_full", {})["phold_s2_resumed"] = {
        "launches": res.mesh["launches"]}
    whole = report.get("_mesh_full", {}).get(name, {}).get("wall_s")
    print(f"[mesh:supervise] phold.yaml at S = 2 saved at "
          f"{MESH_SUP_PAUSE} ({part.wall_s:.3f} s, the save "
          f"{io_line(part.pipeline['checkpoint_io']['save'])}, the "
          f"ranks' leaves gathered to rank 0) and resumed at S = 2 "
          f"({res.wall_s:.3f} s; uninterrupted "
          + (f"{whole:.3f} s" if whole else "not run in this call")
          + f"): equal to one device; on a pool of one rank refused: "
          f"{refused.split(' — ')[0]}; card {card}", flush=True)


# ----------------------------------------------------------------------
# the host mesh: S ranks on device 0 over gloo
# ----------------------------------------------------------------------
MESH_VARIANTS = tuple((x, m) for x in ("all_to_all", "two_phase",
                                       "all_gather")
                      for m in ("window", "global"))
# the kernels each schedule launches on a rank, besides the pops and K2
MESH_PATH = {"all_to_all": ("route", "pack_remote", "route_window",
                            "merge_heaps2"),
             "two_phase": ("route", "pack_two_phase", "route_keyed",
                           "pack_two_phase2", "merge_heaps2"),
             "all_gather": ("route_window", "merge_heaps")}
# per-host leaves a mesh run shares with the one-device run: all but
# occ_in, which the window merge takes per arrival block (the larger of
# the received and the self-shard block) where one device has one
MESH_SHARED = ("ht", "hk", "hm", "hv", "hw", "head", "event_seq",
               "packet_seq", "app_seq", "app", "n_exec", "n_sent",
               "n_drop", "n_deliv", "overflow", "x_overflow", "chk",
               "occ_heap", "occ_ob")
# the per-host leaves of the model NIC and the audit, which a mesh run
# shares with the one-device run where it holds them
STATE_LEAVES = ("tx_free", "rx_free", "cd_fa", "cd_next", "cd_cnt",
                "cd_last", "cd_drop", "aud", "aud_t", "aud_tx")
# the mesh's full runs: (name, example, overrides, S, the one-device
# full run it stands beside, the pops); exchange_capacity set by hand,
# as users do (docs/exchange.md:99-101): the auto CAP (all of a rank's
# H_loc*OB rows a pair) would move about 144 MB a rank a phase. The
# boot phase, where every PHOLD host sends its msgload rows at once,
# sets the size: 32,768 a pair lost rows there at S = 2. phold.yaml's runs
# are cut from its 10 s stop to MESH_PHOLD_STOP (and their one-device
# runs made here) to make room for the campaigns' runs
MESH_PHOLD_STOP = "5s"
MESH_SUP_PAUSE = "2500ms"
MESH_FULL = (
    ("phold_s2", "phold.yaml", FULL_RUNS[0][2] + (
        f"general.stop_time={MESH_PHOLD_STOP}",
        "experimental.exchange_capacity=98304",), 2, None, "pop_phase"),
    ("phold_s4", "phold.yaml", FULL_RUNS[0][2] + (
        f"general.stop_time={MESH_PHOLD_STOP}",
        "experimental.exchange_capacity=32768",), 4, None, "pop_phase"),
    # cut from its 30 s stop to 5 s to make room for the planner's runs
    # and the campaigns' (its one-device run is then made here, not taken
    # from the full phase)
    ("tgen_10000_s2", "tgen_10000.yaml", (
        "general.stop_time=5s", "experimental.exchange_capacity=16384"),
     2, None, "pop_tgen"),
)


# the audit, the model NIC and the path counters at full width on the
# mesh: (name, example, overrides, S, the kernels besides phase_tally and
# the schedule's); phold.yaml at 2 x 50,000 hosts audited, as phold_s2;
# examples/tgen_10000.yaml under the model NIC and the path counters cut
# from its 30 s stop to 3 s, past its clients' start at 2 s (its
# one-device graph run has 17,635 phases
# to 30 s, and a gloo phase of two ranks on one H100 80GB HBM3 at 700 W
# costs 4-7.5 ms: PERF.md), exchange_capacity as tgen_10000_s2's
MESH_STATE_FULL = (
    ("phold_s2_audited", "phold.yaml", MESH_FULL[0][2] + (AUDIT,), 2,
     ("pop_phase_aud", "judge_outbox", "audit_round_rank",
      "audit_conserve")),
    ("tgen_10000_nic_s2", "tgen_10000.yaml", TGEN_NIC + (
        "general.stop_time=3s", "experimental.exchange_capacity=16384"), 2,
     ("pop_tgen_nic", "count_paths")),
)


def mesh_parity_configs():
    """(key, what, loader(overrides), (pop, judge) kernels) of the mesh's
    parity configs: the parity phase's PHOLD, tgen and cut tor_small,
    and the star with link faults."""
    from shadow_tpu_torch.config import load_config, load_config_str

    tor_small = os.path.join(REPO, "examples", "tor_small.yaml")
    return (
        ("phold", "PHOLD 2x1000 hosts, loss 0.01, 1 s",
         lambda x: load_config_str(PARITY_YAML, list(x)),
         ("pop_phase", "judge_outbox")),
        ("tgen", f"tgen 1 server + {TGEN_PARITY_CLIENTS} clients, loss "
         "0.25, 6 s", lambda x: load_config_str(TGEN_PARITY_YAML, list(x)),
         ("pop_tgen", "judge_outbox")),
        ("tor", f"examples/tor_small.yaml cut to {TOR_PARITY_STOP}",
         lambda x: load_config(tor_small, [
             f"general.stop_time={TOR_PARITY_STOP}", *x]),
         ("pop_tor", "judge_outbox")),
        ("star_faults", "the 8 x 120 star with link faults (factored, "
         "four epochs)", lambda x: load_config_str(
             STAR_PARITY_YAML, [STAR_FAULTS, *x]),
         ("pop_tgen_ep_hier", "judge_outbox_ep_hier")),
        # the pops judge their own sends under the model NIC: no K2
        ("nic_phold", "the NIC PHOLD with the path counters (2 Mbit, loss "
         "0.05, 16 hosts, 3 s)",
         lambda x: load_config_str(NIC_PHOLD_YAML, list(x)),
         ("pop_phase_nic", "count_paths")),
        # the corruptions' PHOLD (16 hosts, several events a host
        # within a window), whose CPU ranks cost the oracles little
        ("audited_phold", "BUSY_YAML's PHOLD (16 hosts, msgload 4, self-"
         "sends, 2 s), audited",
         lambda x: load_config_str(BUSY_YAML, [AUDIT, *x]),
         ("pop_phase_aud", "judge_outbox", "audit_round_rank",
          "audit_conserve")))


# the mesh parity configs of the audit, the model NIC and the path
# counters: all_to_all at S = 2, all_to_all and two_phase at S = 4
MESH_STATE_PARITY = ("nic_phold", "audited_phold")


# ensemble campaigns on the mesh (ROADMAP (a) item 9c): (key, what,
# loader, the pop and judge kernels); the seed sweep at S = 2 and 4 under
# every schedule and merge, the star's factored tables and fault
# schedules at S = 2, and a PHOLD latency sweep whose undersized
# exchange_capacity loses rows in each replica (card against the CPU
# ranks: a loss changes the trace, so there is no one-device twin)
MESH_LAT_SWEEP = ("ensemble={replicas: 3, vary: {latency_scale: "
                  "[1.0, 1.5, 2.0]}}", "experimental.exchange_capacity=4")
MESH_CAMPAIGNS = (
    CAMPAIGN_PARITY[0], CAMPAIGN_PARITY[1],
    ("phold_lat", "PARITY_YAML's PHOLD (2 x 1000 hosts, loss 0.01, 1 s) "
     "over latency scales 1, 1.5 and 2 with exchange_capacity 4",
     loader(PARITY_YAML, *MESH_LAT_SWEEP), ("pop_phase", "judge_outbox")))
# the campaign at full width on the mesh: examples/tgen_10000.yaml x 8
# seeds (CAMPAIGN_RUNS[0]) at S = 2, all_to_all, cut from its 30 s stop
# to 5 s, exchange_capacity as tgen_10000_s2's
MESH_CAMPAIGN_FULL = ("tgen_10000_x8_s2", "tgen_10000.yaml",
                      CAMPAIGN_RUNS[0][2] + ("general.stop_time=5s",), 2,
                      ("pop_tgen", "judge_outbox"))
MESH_CAMPAIGN_PAUSE = "1500ms"


# the mesh shrink (`failover: shrink`, ROADMAP (a) 13.1): tests/
# test_chaos.py's YAML (6 PHOLD hosts, 800 ms) and SHRINK (4 ranks, 200 ms
# segments, audited, a device loss at dispatch 2 of shard 1, one retry),
# here under two_phase (K13's halves and K5's keyed mode at S = 3), and
# ENS (2 seeds); phold.yaml cut as MESH_FULL's at S = 4 with a device loss
# at its second 1 s segment, planned from a 1 s warm-up so that the
# survivors' exchange is re-planned from the record (the reference resets
# hand-set exchange capacities at a shrink), held to its one-device run
SHRINK_YAML = """
general:
  stop_time: 800ms
  seed: 9
network:
  graph:
    type: 1_gbit_switch
experimental:
  scheduler_policy: tpu
  event_capacity: 48
hosts:
  left:
    quantity: 3
    processes:
    - {path: model:phold, args: msgload=2, start_time: 10ms}
  right:
    quantity: 3
    processes:
    - {path: model:phold, args: msgload=2, start_time: 10ms}
"""
SHRINK_KNOBS = ("experimental.dispatch_segment=200ms",
                "experimental.state_audit=true")
SHRINK_LOSS = ("experimental.mesh_shards=4", "experimental.failover=shrink",
               "experimental.dispatch_retries=1",
               "experimental.dispatch_retry_backoff=0.0",
               "experimental.chaos=[{kind: device_loss, segment: 2, "
               "shard: 1}]")
SHRINK_ENS = "ensemble={replicas: 2, vary: {seed: [9, 11]}}"
SHRINK_POST = 600_000_000
SHRINK_PHOLD = ("shrink_phold_s4", "phold.yaml", MESH_FULL[1][2][:-1] + (
    "experimental.mesh_shards=4", "experimental.exchange=all_to_all",
    "experimental.exchange_capacity=32768",
    "experimental.capacity_plan=auto", "experimental.capacity_warmup=1s",
    "experimental.dispatch_segment=1s", "experimental.failover=shrink",
    "experimental.chaos=[{kind: device_loss, segment: 2, shard: 1}]"))


def shrink_jobs(work: str) -> dict:
    """The shrink's card runs, in the S = 4 spawn in this order: {name:
    (config, keep the leaves)}: SHRINK rotating (its entries stamp the
    shrunken geometry), the uninterrupted run on 3 of the 4 ranks (its
    mesh_shards), the entry at SHRINK_POST resumed without mesh_shards
    (adopted on 3 ranks), ENS shrinking, phold.yaml shrinking."""
    ck = os.path.join(work, "shrink.npz")
    two = ("experimental.exchange=two_phase",)
    return {
        "small": (cfg_from(SHRINK_YAML, SHRINK_KNOBS + SHRINK_LOSS + two + (
            f"experimental.checkpoint_save={ck}",
            "experimental.checkpoint_every=200ms",
            "experimental.checkpoint_keep=8")), True),
        "ref3": (cfg_from(SHRINK_YAML, SHRINK_KNOBS + two + (
            "experimental.mesh_shards=3",)), True),
        "resume": (cfg_from(SHRINK_YAML, (
            f"experimental.checkpoint_load={ck}.t{SHRINK_POST:015d}",
            "experimental.dispatch_segment=200ms")), True),
        "campaign": (cfg_from(SHRINK_YAML, SHRINK_KNOBS + SHRINK_LOSS + (
            SHRINK_ENS, "ensemble.record_path="
            + os.path.join(work, "shrink_ens.json"))), True),
        "phold": (full_config(SHRINK_PHOLD[1], SHRINK_PHOLD[2]), False),
    }


def shrink_walls(stats) -> str:
    w = stats.pipeline["reshards"]
    return ", ".join(f"{k} {1e3 * v:.1f} ms" for k, v in w[0].items()) \
        if w else "none"


def mesh_shrink(torch, card, report, spawned):
    """The mesh shrink on device 0 (`shrink_jobs`, in the S = 4 spawn):
    SHRINK's 4 -> 3 under two_phase equal to the uninterrupted run on 3
    card ranks (every per-host leaf) and to the same shrink on 4 CPU
    ranks (every leaf), one reshard, the health word zero, its entries
    stamping 3 shards; the resume adopting them on 3 ranks equal; ENS's
    shrink equal replica by replica to the one-device card campaign;
    phold.yaml's shrink at full width equal host for host to its
    one-device card run. Each run's wall, reshards and the shrink's
    walls (probe, gather, group, rebuild) printed, its launches counted
    into the kernel rows."""
    from shadow_tpu_torch.device import checkpoint, supervise
    from shadow_tpu_torch.ensemble.campaign import EnsembleRunner

    runs = spawned["shrink"]
    (small, sleaves), (ref3, rleaves) = runs["small"], runs["ref3"]
    (res, _), (camp, cleaves) = runs["resume"], runs["campaign"]
    phold = runs["phold"][0]
    cpu, cpu_leaves = spawned["cpu"]["shrink:small/4"]
    what = "SHRINK 4 -> 3 (two_phase, gloo on device 0)"
    for stats, name, n in ((small, what, 1), (camp, "ENS " + what, 1),
                           (phold, "phold.yaml 4 -> 3", 1), (cpu, what
                                                              + " cpu", 1)):
        check(stats.ok and stats.reshards == n and
              stats.mesh["shards"] == 3, f"shrink ({name}): ok {stats.ok}, "
              f"reshards {stats.reshards}, shards {stats.mesh['shards']}")
        check([r.get("left", False) for r in stats.mesh["ranks"]] ==
              [False, True, False, False], f"shrink ({name}): the ranks "
              f"left {stats.mesh['ranks']}")
    for stats, name in ((ref3, "3 of 4 ranks"), (res, "the resume")):
        check(stats.mesh["shards"] == 3 and [
            r.get("left", False) for r in stats.mesh["ranks"]] ==
            [False, False, False, True], f"shrink ({name}): ranks "
            f"{stats.mesh['ranks']}")
    same_run(small, ref3, what, ("shrunk", "3 ranks"))
    same_run(small, cpu, what, ("card", "cpu"))
    for leaf in MESH_SHARED + ("aud", "aud_t", "aud_tx"):
        check(np.array_equal(sleaves[leaf], rleaves[leaf]),
              f"shrink ({what}): leaf {leaf} differs from 3 ranks")
    same_leaves(sleaves, cpu_leaves, what, ("card", "cpu"))
    check(not sleaves["aud"].any(), f"shrink ({what}): health word")
    entries = supervise.rotation_entries(
        os.path.join(spawned["work"], "shrink.npz"))
    geoms = [checkpoint.peek_geometry(checkpoint.peek_meta(p))
             for _, p in entries]
    check(geoms[-1] == {"n_shards": 3, "h_pad": 6, "h_loc": 2} and
          geoms[0]["n_shards"] == 4, f"shrink: entries stamp {geoms}")
    same_run(dataclasses.replace(res, rounds=ref3.rounds), ref3,
             "SHRINK's entry resumed on 3 of 4 ranks", ("resumed", "3 ranks"))
    one = EnsembleRunner(cfg_from(SHRINK_YAML, SHRINK_KNOBS + (SHRINK_ENS,)),
                         "cuda")
    one.run()
    for leaf in ("chk", "n_exec", "n_sent", "n_drop", "n_deliv", "app"):
        check(np.array_equal(cleaves[leaf][:, :6],
                             one.final_state[leaf][:, :6]),
              f"shrink (ENS): leaf {leaf} differs from one device")
    same_run(phold, spawned["phold_one"], "phold.yaml 4 -> 3",
             ("shrunk", "one device"))
    check(phold.x_overflow == 0, "shrink (phold.yaml): x_overflow")
    mesh_launch_check(small, what, ("pop_phase_aud", "judge_outbox",
                                    "audit_round_rank", "audit_conserve"),
                      "two_phase")
    for stats in (ref3, phold):
        check(all(stats.mesh["launches"].get(k, 0) > 0 for k in
                  MESH_PATH[stats.mesh["exchange"]]),
              f"shrink: launches {stats.mesh['launches']}")
    full = report.setdefault("_mesh_full", {})
    for name, (stats, _) in runs.items():
        full[f"shrink_{name}"] = {"launches": stats.mesh["launches"],
                                  "wall_s": stats.wall_s}
        print(f"[mesh:shrink] {name}: wall {stats.wall_s:.3f} s, "
              f"{stats.mesh['shards']} shards at the end, reshards "
              f"{stats.reshards}, retries {stats.retries}, exchange "
              f"{stats.mesh['exchange']} (CAP {stats.mesh['cap']}, CAP2 "
              f"{stats.mesh['cap2']}); the shrink's walls on the lead "
              f"survivor: {shrink_walls(stats)}; launches "
              f"{json.dumps(stats.mesh['launches'], sort_keys=True)}; "
              f"card {card}", flush=True)
    print(f"[mesh:shrink] SHRINK 4 -> 3 == 3 ranks == 4 -> 3 on CPU ranks "
          f"(every leaf), entries stamp {geoms[-1]}, the resume adopted on "
          f"3 ranks equal; ENS 4 -> 3 == one-device campaign; phold.yaml "
          f"4 -> 3 ({phold.events_executed} events) == one device "
          f"({spawned['phold_one'].wall_s:.3f} s); card {card}", flush=True)


def mesh_campaign_jobs():
    """The mesh's campaign runs: {key: (config, what, pops, exchange)},
    key campaign:<name>/<exchange>/<merge>/<S>."""
    jobs = {}
    for key, what, load, pops in MESH_CAMPAIGNS:
        for S in (2, 4):
            variants = (MESH_VARIANTS if key == "sweep" else
                        (("all_to_all", "window"),) if S == 2 else ())
            for x, m in variants:
                jobs[f"campaign:{key}/{x}/{m}/{S}"] = (
                    load(mesh_overrides(S, x, m)), what, pops, x)
    return jobs


def mesh_overrides(S, exchange, merge, extra=()):
    return (f"experimental.mesh_shards={S}",
            f"experimental.exchange={exchange}",
            f"experimental.merge_strategy={merge}", *extra)


def mesh_launch_check(stats, what, app, exchange):
    """Every rank's launches (summed): the pop and the judge `app`
    names, the tallies and the schedule's kernels, each at least once,
    and nothing else."""
    got = stats.mesh["launches"]
    path = (*app, "phase_tally", *MESH_PATH[exchange])
    for k in path:
        check(got.get(k, 0) > 0, f"mesh ({what}): {k} never launched")
    stray = set(got) - set(path)
    check(not stray, f"mesh ({what}): {sorted(stray)} launched off the "
          "path")


def mesh_parity_jobs():
    """mesh_parity's configs: the card's runs {key: (config, what, (pop,
    judge), exchange)}, the CPU ranks' {key: config}, the undersized
    capacities {key: config} (card and CPU), the planned tgen {key:
    config} and the one-device runs {config key: config}."""
    cards = {}
    cpu = {}
    one = {}
    for key, what, load, pop in mesh_parity_configs():
        # every schedule and merge at S = 4 for the PHOLD and tgen; each
        # schedule once for the longer Tor and star runs (time); the
        # audit's and the NIC's configs under all_to_all and two_phase
        four = (MESH_VARIANTS if key in ("phold", "tgen") else
                (("all_to_all", "window"), ("two_phase", "global"))
                if key in MESH_STATE_PARITY else
                (("all_to_all", "window"), ("two_phase", "global"),
                 ("all_gather", "window")))
        for S, variants in ((4, four), (2, (("all_to_all", "window"),))):
            for x, m in variants:
                k = f"{key}/{x}/{m}/{S}"
                cards[k] = (load(mesh_overrides(S, x, m)), what, pop, x)
        for S, x, m in ((2, "all_to_all", "window"),
                        (4, "two_phase", "global")):
            cpu[f"{key}/{x}/{m}/{S}"] = load(mesh_overrides(S, x, m))
        one[key] = load(())
    phold = mesh_parity_configs()[0][2]
    over = {
        "over/all_to_all": phold(mesh_overrides(4, "all_to_all", "window", (
            "experimental.exchange_capacity=4",))),
        "over/two_phase_phase1": phold(mesh_overrides(
            4, "two_phase", "window", ("experimental.exchange_capacity=4",))),
        "over/two_phase_phase2": phold(mesh_overrides(
            4, "two_phase", "global", (
                "experimental.exchange_capacity2=4",)))}
    # the planned tgen (MESH_PLAN) rides each S's card spawn
    tgen_load = next(c[2] for c in mesh_parity_configs() if c[0] == "tgen")
    planned = {f"tgen_plan/{S}": tgen_load((f"experimental.mesh_shards={S}",
                                            *MESH_PLAN)) for S in (2, 4)}
    return cards, cpu, over, planned, one


def mesh_cpu_configs() -> dict:
    """{S: {key: config}} of the CPU ranks mesh_parity holds the card's
    ranks to (a CPU oracle: `start_oracles`)."""
    _, cpu, over, _, _ = mesh_parity_jobs()
    # every campaign run, on the CPU ranks too
    cpu = {**cpu, **{k: c[0] for k, c in mesh_campaign_jobs().items()}}
    # the mesh shrink's SHRINK (no rotation: its entries are the card's)
    cpu["shrink:small/4"] = cfg_from(SHRINK_YAML, SHRINK_KNOBS + SHRINK_LOSS
                                     + ("experimental.exchange=two_phase",))
    return {2: {k: c for k, c in cpu.items() if k.endswith("/2")},
            4: {**{k: c for k, c in cpu.items() if k.endswith("/4")},
                **over}}


def mesh_card_runs(torch, report) -> dict:
    """Every card run of the mesh phase in two spawns, one at S = 2 and
    one at S = 4 (a spawn's rank processes take about 20 s to reach the
    card): mesh_parity's runs (leaves kept), its K13 run in timing
    mode, MESH_FULL's runs untimed and in timing mode, and
    mesh_supervise's save half way and resume (S = 2, in this order, so
    that the resume finds the checkpoint), the mesh shrink's runs
    (`shrink_jobs`, S = 4). Returns {"card": {key: (stats, leaves)},
    "k13": stats, "full": {name: (stats, timed)}, "supervise": (saved,
    resumed), "shrink": {name: (stats, leaves)}, "work": the
    checkpoints' directory, "wall_s": the spawns' wall}."""
    from shadow_tpu_torch.device import runner

    cards, _, over, planned, _ = mesh_parity_jobs()
    phold = mesh_parity_configs()[0][2]
    name, example, overrides, _, _, _ = MESH_FULL[0]
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_ck_")
    ck = os.path.join(work, "phold_s2.npz")
    sup = {"save": full_config(example, overrides + (
               "experimental.mesh_shards=2",
               f"experimental.checkpoint_save={ck}",
               f"experimental.checkpoint_save_time={MESH_SUP_PAUSE}")),
           "resume": full_config(example, overrides + (
               "experimental.mesh_shards=2",
               f"experimental.checkpoint_load={ck}"))}
    camp_ck = os.path.join(work, "sweep_s2.npz")
    camp_sup = {}
    camp_sup["save"] = cfg_from("ensemble_seed_sweep.yaml", mesh_overrides(
        2, "all_to_all", "window", (
            f"experimental.checkpoint_save={camp_ck}",
            "experimental.checkpoint_save_time=" + MESH_CAMPAIGN_PAUSE)))
    camp_sup["resume"] = cfg_from("ensemble_seed_sweep.yaml",
                                  mesh_overrides(2, "all_to_all", "window", (
                                      "experimental.checkpoint_load="
                                      + camp_ck,)))
    out = {"card": {}, "full": {}, "work": work}
    t0 = time.perf_counter()
    for S in (2, 4):
        # (key, config, keep the leaves, timing mode)
        jobs = [(k, cards[k][0], True, False) for k in cards
                if k.endswith(f"/{S}")]
        jobs.append((f"tgen_plan/{S}", planned[f"tgen_plan/{S}"], True,
                     False))
        if S == 4:
            jobs += [(k, c, True, False) for k, c in over.items()]
            # K13's device ms over real launches: the PHOLD's
            # two_phase/global run again in timing mode
            jobs.append(("k13", phold(mesh_overrides(4, "two_phase",
                                                     "global")),
                         False, True))
        for fname, fexample, fover, fS, _, _ in MESH_FULL:
            if fS == S:
                cfg = full_config(fexample, fover + (
                    f"experimental.mesh_shards={S}",))
                jobs += [(("full", fname), cfg, False, False),
                         (("timed", fname), cfg, False, True)]
        for fname, fexample, fover, fS, _ in MESH_STATE_FULL:
            if fS == S:
                cfg = full_config(fexample, fover + (
                    f"experimental.mesh_shards={S}",))
                # the audited run's leaves, to hold every one
                jobs.append((("state", fname), cfg, "aud" in fname, False))
        if S == 2:
            jobs += [(("supervise", k), c, False, False)
                     for k, c in sup.items()]
        # the campaigns: parity (leaves kept), the sweep saved half way
        # and resumed (S = 2), the full-width campaign (no heaps kept)
        jobs += [(k, c[0], True, False) for k, c in
                 mesh_campaign_jobs().items() if k.endswith(f"/{S}")]
        if S == 4:
            jobs += [(("shrink", k), c, keep, False)
                     for k, (c, keep) in shrink_jobs(work).items()]
        if S == 2:
            jobs += [(("campaign_supervise", k), c, True, False)
                     for k, c in camp_sup.items()]
            name, example, cover, _, _ = MESH_CAMPAIGN_FULL
            jobs.append((("campaign_full", name), full_config(
                example, cover + (f"experimental.mesh_shards={S}",
                                  "experimental.exchange_capacity=16384")),
                False, False))
        res = runner.mesh_runs(["cuda:0"] * S, [j[1] for j in jobs],
                               [j[2] for j in jobs], [j[3] for j in jobs])
        for (key, *_), r in zip(jobs, res):
            if key == "k13":
                out["k13"] = r[0]
            elif isinstance(key, tuple) and key[0] in ("full", "timed"):
                out["full"].setdefault(key[1], {})[key[0]] = r[0]
            elif isinstance(key, tuple) and key[0] == "state":
                out.setdefault("state", {})[key[1]] = r
            elif isinstance(key, tuple) and (
                    key[0].startswith("campaign_") or key[0] == "shrink"):
                out.setdefault(key[0], {})[key[1]] = r
            elif isinstance(key, tuple):
                out.setdefault("supervise", {})[key[1]] = r[0]
            else:
                out["card"][key] = r
    out["wall_s"] = time.perf_counter() - t0
    print(f"[mesh] the card's runs: {sum(1 for _ in out['card'])} parity "
          f"runs (campaigns among them), the K13 timing run, "
          f"{2 * len(out['full'])} full runs, the full campaign, the "
          "campaign's save and resume, "
          f"{len(out.get('state', {}))} full runs "
          f"of the audit and the model NIC, the S = 2 save and resume "
          f"and {len(out['shrink'])} shrink runs "
          f"in two spawns (S = 2, 4), {out['wall_s']:.1f} s", flush=True)
    return out


def mesh_parity(torch, report, runs):
    """S = 2 and 4 ranks spawned on device 0 over gloo (`spawned`, from
    `mesh_card_runs`): the PHOLD and tgen configs under every schedule and
    merge at S = 4, the Tor and star configs under each schedule once,
    every config under all_to_all at S = 2, each held against the
    one-device card run (traces, totals, every per-host leaf but occ_in,
    the phases) and, for a2a/window at S = 2 and two_phase/global at
    S = 4, against the same ranks on the CPU plain path (every leaf);
    then an
    undersized capacity per schedule that has one (the PHOLD, S = 4:
    the direct pack, two_phase's phase 1 and its phase 2), card against
    CPU, x_overflow equal per sender and the run not ok."""
    cards, cpu, over, planned, one = mesh_parity_jobs()
    card = runs["card"]
    cpu_res = {}
    for S, cfgs in mesh_cpu_configs().items():
        cpu_res.update(zip(cfgs, oracle(f"mesh:{S}", ("mesh", S, list(
            cfgs.values())))))
    # the campaigns' CPU ranks, for mesh_campaign_parity
    runs["cpu"] = cpu_res
    singles = {key: engine_run(cfg, "cuda") for key, cfg in one.items()}
    for k, (cfg, what, pop, x) in cards.items():
        stats, leaves = card[k]
        key, _, m, S = k.split("/")
        base, bleaves = singles[key]
        label = f"{what}, S={S} {x}/{m}"
        check(stats.mesh["backend"] == "gloo" and stats.mesh["shards"]
              == int(S), f"mesh ({label}): backend {stats.mesh}")
        same_run(stats, base, label, ("mesh", "one device"))
        H = len(bleaves["n_exec"])
        for leaf in MESH_SHARED + (("occ_in",) if m == "global" else ()) \
                + tuple(k for k in STATE_LEAVES if k in bleaves):
            check(np.array_equal(leaves[leaf][:H], bleaves[leaf]),
                  f"mesh ({label}): leaf {leaf} differs from one device")
        if "path_cnt" in bleaves:
            check(leaves["path_cnt"].shape[0] == int(S) and np.array_equal(
                leaves["path_cnt"].sum(0), bleaves["path_cnt"][0]),
                  f"mesh ({label}): the ranks' path_cnt rows do not sum "
                  "to one device's")
        if "aud" in bleaves:
            check(not leaves["aud"].any(), f"mesh ({label}): a health "
                  "word set")
        check(int(leaves["occ_phases"].min()) == int(
            leaves["occ_phases"].max()) == int(bleaves["occ_phases"][0]),
              f"mesh ({label}): phases differ")
        mesh_launch_check(stats, label, pop, x)
        if k in cpu_res:
            same_leaves(leaves, cpu_res[k][1], label, ("card", "cpu"))
            same_run(stats, cpu_res[k][0], label)
    for S in (2, 4):
        stats, _ = card[f"tgen_plan/{S}"]
        mesh_plan_check(stats, singles["tgen"][0], S,
                        f"planned tgen parity config, S={S}")
    for k in over:
        (cs_, cl), (ps_, pl) = card[k], cpu_res[k]
        check(not cs_.ok and not ps_.ok and cs_.x_overflow > 0,
              f"mesh ({k}): the undersized capacity did not fail loudly")
        check(np.array_equal(cl["x_overflow"], pl["x_overflow"]),
              f"mesh ({k}): x_overflow per sender card != cpu")
        same_leaves(cl, pl, k, ("card", "cpu"))
    print(f"[mesh] parity: {len(cards)} card runs at S = 2 and 4 (gloo on "
          f"device 0) equal the one-device card runs (the NIC PHOLD's and "
          f"the audited PHOLD's NIC and audit leaves too, their path_cnt "
          f"rows summed, their health words zero); {len(cpu_res)} "
          f"equal the same ranks on the CPU plain path, every leaf; "
          f"undersized capacities " + ", ".join(
              f"{k[5:]} x_overflow {card[k][0].x_overflow} (senders "
              f"{np.flatnonzero(card[k][1]['x_overflow']).tolist()[:6]})"
              for k in over), flush=True)
    report["_mesh_parity"] = {k: {"launches": v[0].mesh["launches"]}
                              for k, v in card.items()}
    # K13's device ms over real launches: the PHOLD's two_phase/global S
    # = 4 run again in timing mode (every rank's launches summed; the
    # four rank processes share the card, which stretches each launch's
    # events: two_phase_real_rows times K13 in one process)
    timed = runs["k13"]
    same_run(timed, card["phold/two_phase/global/4"][0],
             "mesh two_phase/global S=4, timed", ("timed", "untimed"))
    k13 = {k: (timed.mesh["launches"].get(k, 0),
               sum(r["kernel_ms"].get(k, 0.0) for r in timed.mesh["ranks"]))
           for k in ("pack_two_phase", "pack_two_phase2")}
    check(all(n > 0 for n, _ in k13.values()), "mesh: K13 never launched "
          "in the timed two_phase run")
    report["_mesh_k13_ms"] = k13
    print("[mesh] K13 on real launches (PHOLD 2x1000, two_phase/global, "
          "S = 4, timing mode, every rank; four rank processes sharing "
          "one card, so that a launch's device time includes the others' "
          "time slices): " + ", ".join(
              f"{k} {v:.3f} device ms over {n} launches"
              for k, (n, v) in k13.items()), flush=True)


def per_flush(ranks) -> list:
    """Each rank's collectives a flush, by kind (mesh_stats' `calls`
    over its `flushes`)."""
    return [{k: n / max(1, r["flushes"]) for k, n in r["calls"].items()}
            for r in ranks]


def exchange_calls(ranks) -> set:
    """The exchange's collectives a flush (all_to_all and all_gather),
    over the ranks."""
    return {round(c["all_to_all"] + c["all_gather"], 6)
            for c in per_flush(ranks)}


def campaign_record(rec: dict) -> dict:
    """A campaign record without what differs between two runs of one
    campaign (its wall, the admission's byte model, the batching)."""
    rec = json.loads(json.dumps(rec, sort_keys=True, default=str))
    for k in ("wall_s", "admission", "replica_batch"):
        rec.pop(k, None)
    return rec


def one_device_campaign(load, x=()):
    """(stats, runner) of a campaign on one card (the captured graph
    loop), its final leaves with the heaps."""
    from shadow_tpu_torch.ensemble.campaign import EnsembleRunner

    er = EnsembleRunner(load(x) if callable(load) else load, "cuda")
    er.keep_heaps = True
    return er.run(), er


def mesh_campaign_parity(torch, card, report, runs):
    """The campaigns of `mesh_campaign_jobs` on 2 and 4 ranks of device 0
    (in `mesh_card_runs`' spawns): every replica's per-host leaves (all
    but occ_in), the record (each replica's checksums and the
    aggregates), the totals and rounds equal to the one-device campaign
    on the card; every run equal to the same ranks on the CPU in every
    leaf (the latency sweep's undersized capacity: its
    x_overflow per replica and sender, the campaign not ok); the
    launches of the schedule's kernels; the exchange's collectives a
    flush equal to the standalone parity runs' at the same S and
    schedule (one collective carries every replica); the sweep saved
    half way on 2 ranks and resumed equal to the uninterrupted one, its
    checkpoint refused on a pool of one rank."""
    from shadow_tpu_torch.device import runner

    card_runs, cpu = runs["card"], runs["cpu"]
    ones = {key: one_device_campaign(load) for key, _, load, _ in
            MESH_CAMPAIGNS if key != "phold_lat"}
    # the exchange's collectives a flush of a schedule (two_phase: one a
    # hop), as the standalone parity runs make them
    want = {"all_to_all": 1, "two_phase": 2, "all_gather": 1}
    standalone = {}
    for k, (stats, _) in card_runs.items():
        if not k.startswith(("campaign:", "over/", "tgen_plan/")):
            _, x, _, S = k.split("/")
            standalone.setdefault((x, S), set()).update(
                exchange_calls(stats.mesh["ranks"]))
    for (x, S), calls in standalone.items():
        check(calls == {want[x]}, f"mesh: the standalone {x} runs at "
              f"S={S} make {sorted(calls)} exchange collectives a flush")
    n, losses = 0, {}
    for k, (cfg, what, pops, x) in mesh_campaign_jobs().items():
        stats, leaves = card_runs[k]
        name, _, m, S = k[len("campaign:"):].split("/")
        label = f"campaign {what}, S={S} {x}/{m}"
        check(stats.mesh["backend"] == "gloo" and stats.mesh["shards"]
              == int(S), f"mesh ({label}): backend {stats.mesh}")
        mesh_launch_check(stats, label, pops, x)
        calls = exchange_calls(stats.mesh["ranks"])
        check(calls == {want[x]}, f"mesh ({label}): {sorted(calls)} "
              f"exchange collectives a flush, a standalone run "
              f"{want[x]}")
        if name in ones:
            one, er = ones[name]
            H = len(er.sim.host_vertex)
            for leaf in MESH_SHARED:
                check(np.array_equal(leaves[leaf][:, :H],
                                     er.final_state[leaf]),
                      f"mesh ({label}): leaf {leaf} differs from the "
                      "one-device campaign")
            check(campaign_record(stats.ensemble) == campaign_record(
                er.record), f"mesh ({label}): the record differs from "
                  "the one-device campaign's")
            same_run(stats, one, label, ("mesh", "one device"))
        cstats, cleaves = cpu[k]
        same_leaves(leaves, cleaves, label, ("card", "cpu"))
        if name == "phold_lat":
            check((stats.ok, stats.x_overflow, stats.events_executed)
                  == (cstats.ok, cstats.x_overflow, cstats.events_executed),
                  f"mesh ({label}): the totals differ card/cpu")
        else:
            same_run(stats, cstats, label)
        if name == "phold_lat":
            lost = leaves["x_overflow"].sum(1)
            check(not stats.ok and (lost > 0).all(), f"mesh ({label}): "
                  f"the undersized capacity lost {lost.tolist()} rows")
            losses[label] = lost.tolist()
        n += 1
    # the sweep saved at MESH_CAMPAIGN_PAUSE and resumed, on 2 ranks
    sup = runs["campaign_supervise"]
    (saved, _), (res, rleaves) = sup["save"], sup["resume"]
    whole = card_runs["campaign:sweep/all_to_all/window/2"][1]
    for leaf in rleaves:
        check(np.array_equal(rleaves[leaf], whole[leaf]), f"mesh campaign "
              f"resume: leaf {leaf} differs from the uninterrupted one")
    check(campaign_record(res.ensemble)["replicas"] == campaign_record(
        card_runs["campaign:sweep/all_to_all/window/2"][0].ensemble)[
        "replicas"], "mesh campaign resume: the replicas' checksums differ")
    ck = os.path.join(runs["work"], "sweep_s2.npz")
    try:
        runner.mesh_runs(["cuda:0"], [cfg_from(
            "ensemble_seed_sweep.yaml", (
                f"experimental.checkpoint_load={ck}",))])
        refused = ""
    except ValueError as e:
        refused = str(e)
    check("saved on 2 shard(s) but only 1 device(s)" in refused,
          f"mesh campaign resume on a pool of one: {refused!r}")
    print(f"[mesh] campaigns: {n} card runs at S = 2 and 4 (gloo on device "
          f"0), every replica equal to the one-device campaign on the "
          f"card (leaves, records, totals, rounds); "
          f"each equal to the same ranks on the CPU plain path, every "
          f"leaf; exchange collectives a flush equal to "
          f"the standalone runs' ("
          + ", ".join(f"{x} S={S}: {sorted(v)}" for (x, S), v in
                      sorted(standalone.items()))
          + "); per-replica rows lost under the undersized capacity "
          + json.dumps(losses) + f"; the sweep saved at "
          f"{MESH_CAMPAIGN_PAUSE} on 2 ranks ({saved.wall_s:.3f} s) and "
          f"resumed ({res.wall_s:.3f} s) equal to the uninterrupted one; "
          f"on a pool of one rank refused: {refused.split(' — ')[0]}; "
          f"card {card}",
          flush=True)


def mesh_campaign_full(torch, card, report, spawned):
    """MESH_CAMPAIGN_FULL on 2 ranks of device 0 beside the same campaign
    on one card (the captured graph loop, in this call): every replica's
    per-host leaves but the heaps and occ_in equal, the record equal,
    each rank's peak within FOOTPRINT_TOLERANCE of its admission
    estimate, the exchange's collectives a flush equal to the standalone
    tgen_10000_s2's (one all_to_all carries the 8 replicas); the wall,
    phases, rounds, the collectives' and the staging's seconds and the
    bytes a flush of each rank."""
    from shadow_tpu_torch.device import capacity

    name, example, overrides, S, pops = MESH_CAMPAIGN_FULL
    stats, leaves = spawned["campaign_full"][name]
    one, er = one_device_campaign(full_config(example, overrides))
    what = f"{name} ({S} ranks, gloo on device 0)"
    check(stats.ok and stats.x_overflow == 0 and stats.overflow == 0,
          f"mesh full {what}: overflow {stats.overflow}, x_overflow "
          f"{stats.x_overflow}")
    H = len(er.sim.host_vertex)
    for leaf in MESH_SHARED:
        if leaf in leaves:
            check(np.array_equal(leaves[leaf][:, :H], er.final_state[leaf]),
                  f"mesh full {what}: leaf {leaf} differs from the "
                  "one-device campaign")
    check(campaign_record(stats.ensemble) == campaign_record(er.record),
          f"mesh full {what}: the record differs from the one-device "
          "campaign's")
    same_run(stats, one, what, ("mesh", "one device"))
    mesh_launch_check(stats, what, pops, "all_to_all")
    ranks = stats.mesh["ranks"]
    peaks = [(r["peak_bytes"], r["estimate_bytes"]) for r in ranks]
    for r, (peak, est) in zip(ranks, peaks):
        check(est / capacity.FOOTPRINT_TOLERANCE <= peak
              <= est * capacity.FOOTPRINT_TOLERANCE,
              f"mesh full {what}: rank {r['rank']} peak {peak} B not "
              f"within {capacity.FOOTPRINT_TOLERANCE}x of {est} B")
    alone = spawned["full"].get("tgen_10000_s2", {}).get("full")
    calls = exchange_calls(ranks)
    if alone is not None:
        check(calls == exchange_calls(alone.mesh["ranks"]),
              f"mesh full {what}: {sorted(calls)} exchange collectives a "
              f"flush, tgen_10000_s2 "
              f"{sorted(exchange_calls(alone.mesh['ranks']))}")
    split = [{"rank": r["rank"], "flushes": r["flushes"],
              "calls_per_flush": c, "collective_s": r["collective_s"],
              "stage_s": r["stage_s"],
              "bytes_per_flush": r["moved_bytes"] / max(1, r["flushes"])}
             for r, c in zip(ranks, per_flush(ranks))]
    report.setdefault("_mesh_full", {})[name] = {
        "launches": stats.mesh["launches"], "wall_s": stats.wall_s,
        "one_device_wall_s": one.wall_s, "split": split, "peaks": peaks}
    print(f"[mesh:{name}] {stats.ensemble['workload']['replicas']} "
          f"replicas x {H} hosts on {S} ranks: wall {stats.wall_s:.3f} s "
          f"against the one-device campaign {one.wall_s:.3f} s (graph "
          f"loop, same call); {stats.events_executed} events, rounds "
          f"{stats.rounds} (the longest replica), {stats.phases} phases; "
          f"every replica equal to one device (leaves but the heaps and "
          f"occ_in, the record); CAP {stats.mesh['cap']}; exchange "
          f"collectives a flush {sorted(calls)}, tgen_10000_s2 "
          + (f"{sorted(exchange_calls(alone.mesh['ranks']))}"
             if alone is not None else "not run")
          + "; peak/estimate per rank "
          + ", ".join(f"{p / e:.3f}" for p, e in peaks)
          + "; per rank " + json.dumps(split) + f"; card {card}",
          flush=True)


def mesh_full(torch, card, report, spawned):
    """The mesh's full runs (MESH_FULL) on device 0 over gloo, each
    untimed for its wall beside the one-device graph wall of the same
    call, then in timing mode for the flush's split per rank: the pops
    and K2, the pack (K12 or K13), the staging copies, the collective,
    the second route (K5's window) and the merge (K3, two blocks).
    Counts equal the one-device run's, x_overflow 0, each rank's peak
    within FOOTPRINT_TOLERANCE of its admission estimate."""
    from shadow_tpu_torch.device import capacity, runner

    full = report.get("_full", {})
    runs = {}
    for name, example, overrides, S, single, pop in MESH_FULL:
        if single in full:
            base_wall, base = full[single]["wall_s"], full[single]["stats"]
        else:
            base = runner.run(full_config(example, overrides[:-1]),
                              device="cuda")
            base_wall = base.wall_s
        stats = spawned["full"][name]["full"]
        timed = spawned["full"][name]["timed"]
        what = f"{name} ({S} ranks, gloo on device 0)"
        check(stats.ok and stats.x_overflow == 0 and stats.overflow == 0,
              f"mesh full {what}: overflow {stats.overflow}, x_overflow "
              f"{stats.x_overflow}")
        same_run(stats, base, what, ("mesh", "one device"))
        same_run(timed, base, what + ", timed", ("mesh", "one device"))
        mesh_launch_check(stats, what, (pop, "judge_outbox"), "all_to_all")
        for r in stats.mesh["ranks"]:
            peak, est = r["peak_bytes"], r["estimate_bytes"]
            check(est / capacity.FOOTPRINT_TOLERANCE <= peak
                  <= est * capacity.FOOTPRINT_TOLERANCE,
                  f"mesh full {what}: rank {r['rank']} peak {peak} B not "
                  f"within {capacity.FOOTPRINT_TOLERANCE}x of {est} B")
        split = []
        for r in timed.mesh["ranks"]:
            ms = r["kernel_ms"]
            split.append({
                "rank": r["rank"],
                "pops_judge_ms": sum(v for k, v in ms.items()
                                     if k.startswith(("pop_", "judge_"))),
                "route_ms": ms.get("route", 0.0),
                "pack_ms": ms.get("pack_remote", 0.0),
                "stage_ms": 1e3 * r["stage_s"],
                "collective_ms": 1e3 * r["collective_s"],
                "second_route_ms": ms.get("route_window", 0.0),
                "merge_ms": ms.get("merge_heaps2", 0.0),
                "moved_bytes": r["moved_bytes"]})
        peaks = [(r["peak_bytes"], r["estimate_bytes"])
                 for r in stats.mesh["ranks"]]
        print(f"[mesh:{name}] wall {stats.wall_s:.3f} s against one "
              f"device {base_wall:.3f} s (graph loop, same call); timed "
              f"{timed.wall_s:.3f} s; {stats.events_executed} events, "
              f"{stats.rounds} rounds, {stats.phases} phases (as one "
              f"device); CAP {stats.mesh['cap']}; peak/estimate per rank "
              + ", ".join(f"{p / e:.3f}" for p, e in peaks)
              + "; per rank " + json.dumps(split), flush=True)
        runs[name] = {"launches": stats.mesh["launches"],
                      "wall_s": stats.wall_s, "one_device_wall_s": base_wall,
                      "split": split, "peaks": peaks}
    report["_mesh_full"] = runs


def mesh_state_full(torch, card, report, spawned):
    """MESH_STATE_FULL's runs on device 0 over gloo (in `mesh_card_runs`'
    spawns) beside their one-device graph runs in this call: the audited
    phold.yaml at S = 2, its health word zero and every per-host leaf
    equal (the NIC's and the audit's included; occ_in is the mesh's
    own), its K8 launches, the all_sum's host ms a round and the audit's
    cost a rank (the all_sum's seconds and K8's device ms over the mesh
    wall), the unaudited phold_s2's wall beside it;
    tgen_10000 under the model NIC and the path counters at S = 2, its
    traces, totals and summed path_cnt equal. Launches checked, every
    rank's peak within FOOTPRINT_TOLERANCE of its admission estimate."""
    from shadow_tpu_torch.device import capacity

    full = report.setdefault("_mesh_full", {})
    for name, example, overrides, S, app in MESH_STATE_FULL:
        stats, leaves = spawned["state"][name]
        one, bleaves = engine_run(full_config(example, overrides), "cuda")
        what = f"{name} ({S} ranks, gloo on device 0)"
        check(stats.ok and stats.x_overflow == 0 and stats.overflow == 0,
              f"mesh full {what}: overflow {stats.overflow}, x_overflow "
              f"{stats.x_overflow}")
        same_run(stats, one, what, ("mesh", "one device"))
        mesh_launch_check(stats, what, app, "all_to_all")
        if leaves is not None:
            H = len(bleaves["n_exec"])
            check(not leaves["aud"].any() and not bleaves["aud"].any(),
                  f"mesh full {what}: a health word set")
            for leaf in MESH_SHARED + tuple(k for k in STATE_LEAVES
                                            if k in bleaves):
                check(np.array_equal(leaves[leaf][:H], bleaves[leaf]),
                      f"mesh full {what}: leaf {leaf} differs from one "
                      "device")
        if "path_cnt" in bleaves:
            check(sum(stats.path_packets.values()) > 0,
                  f"mesh full {what}: no path counted")
        for r in stats.mesh["ranks"]:
            peak, est = r["peak_bytes"], r["estimate_bytes"]
            check(est / capacity.FOOTPRINT_TOLERANCE <= peak
                  <= est * capacity.FOOTPRINT_TOLERANCE,
                  f"mesh full {what}: rank {r['rank']} peak {peak} B not "
                  f"within {capacity.FOOTPRINT_TOLERANCE}x of {est} B")
        peaks = [(r["peak_bytes"], r["estimate_bytes"])
                 for r in stats.mesh["ranks"]]
        row = {"launches": stats.mesh["launches"], "wall_s": stats.wall_s,
               "one_device_wall_s": one.wall_s, "peaks": peaks}
        line = (f"[mesh:{name}] wall {stats.wall_s:.3f} s against one "
                f"device {one.wall_s:.3f} s (graph loop, same call); "
                f"{stats.events_executed} events, {stats.rounds} rounds, "
                f"{stats.phases} phases (as one device); CAP "
                f"{stats.mesh['cap']}; peak/estimate per rank "
                + ", ".join(f"{p / e:.3f}" for p, e in peaks))
        if "path_cnt" in bleaves:
            line += (f"; path_cnt summed over the ranks equal to one "
                     f"device's ({sum(stats.path_packets.values())} "
                     f"packets on {len(stats.path_packets)} pairs)")
        if "aud" in bleaves:
            base = spawned["full"].get("phold_s2", {}).get("full")
            sums = [(r["audit_sums"], r["audit_sum_s"])
                    for r in stats.mesh["ranks"]]
            check(all(n > 0 for n, _ in sums), f"mesh full {what}: the "
                  "balance was never summed")
            # the audit's cost a rank, from what was measured: the
            # slowest rank's all_sum seconds (its collective's host
            # clock) and K8's device ms (a rank's launches times the
            # kernels phase's ms at the same H_loc), over the mesh wall
            k8 = {k: report.get(k, {}).get("ms")
                  for k in ("audit_round_rank", "audit_conserve")}
            k8_ms = (None if None in k8.values() else sum(
                stats.mesh["launches"][k] / S * v for k, v in k8.items()))
            sum_ms = 1e3 * max(t for _, t in sums)
            cost = (None if k8_ms is None else
                    (sum_ms + k8_ms) / (1e3 * stats.wall_s))
            row.update({"unaudited_wall_s": None if base is None
                        else base.wall_s, "all_sums": sums,
                        "k8_device_ms": k8_ms, "audit_cost_share": cost})
            line += ("; K8 "
                     + ", ".join(f"{k} {stats.mesh['launches'][k]}"
                                 for k in ("audit_round_rank",
                                           "audit_conserve"))
                     + " launches; the balance's all_sum per rank "
                     + ", ".join(f"{n} sums in {1e3 * t:.1f} ms "
                                 f"({1e3 * t / max(n, 1):.4f} ms each)"
                                 for n, t in sums)
                     + "; the audit's cost a rank "
                     + (f"{sum_ms:.1f} ms of all_sum + {k8_ms:.1f} K8 "
                        f"device ms = {cost:.4f} of the mesh wall"
                        if cost is not None else "not measured (no "
                        "kernels phase)")
                     + "; unaudited phold_s2 wall "
                     + (f"{base.wall_s:.3f} s (another run: the "
                        "difference of the two walls is noise, not the "
                        "audit's cost)" if base is not None
                        else "not run"))
        print(line + f"; card {card}", flush=True)
        full[name] = row


def mesh_flush(torch, report):
    """`runner.flush_phases` (one flush of rows copied into each rank's
    outbox, pop counts 0, the outbox word set by the flush) on 2 ranks on
    device 0 against the same 2 ranks on the CPU plain path: every leaf
    equal, so K2 judged every host. The job: the mesh's PHOLD config
    paused at half its stop time on one card, popped once."""
    import concurrent.futures as cf

    from shadow_tpu_torch.device import kernels as K
    from shadow_tpu_torch.device import mesh, runner
    from shadow_tpu_torch.device.engine import state_to_numpy

    key, what, load, _ = mesh_parity_configs()[0]
    S = 2
    K.build_library()
    cfg = load(mesh_overrides(S, "all_to_all", "window"))
    engine, sim = runner.make_engine(load(()), device="cuda")
    state = engine.init_state(sim.start_times, sim.stop_times)
    stop = int(engine.config.stop_time)
    engine.run(state, stop=stop // 2, final_stop=stop)
    win_end = engine.next_time(state) + max(1, int(engine.config.lookahead))
    ob, pops, _ = engine._buffers()
    engine.kernels.pop(state, ob, pops, engine.world,
                       K.control_block(engine.device, run=1,
                                       win_end=win_end), engine.params)
    leaves = state_to_numpy(state)
    for k in ("occ_x", "occ_trips", "occ_phases"):
        v = leaves[k]
        leaves[k] = np.zeros((S, S) if v.ndim == 2 else (S,), v.dtype)
    rows = {f: v.cpu().numpy() for f, v in ob.items()}
    sends = int(((rows["t"] < K.INF) & ((rows["m"] & 0xFF) == 2)).sum())
    check(sends > 0, "mesh flush: no send row to judge")
    job = [(cfg, leaves, rows, win_end)]
    # the card's ranks and the CPU's side by side
    with cf.ThreadPoolExecutor(2) as pool:
        got = {dev: pool.submit(mesh.spawn, [dev] * S, runner.flush_phases,
                                (job,), timeout=300)
               for dev in ("cuda:0", "cpu")}
        got = {dev: f.result()[0] for dev, f in got.items()}
    err = max_abs_err({k: torch.from_numpy(v) for k, v in
                       got["cuda:0"].items()},
                      {k: torch.from_numpy(v) for k, v in
                       got["cpu"].items()}, list(got["cpu"]))
    check(err == 0.0, f"mesh flush ({what}, S={S}): card and CPU ranks "
          f"differ (max abs err {err})")
    print(f"[mesh] flush_phases ({what}, S={S}, {sends} send rows copied "
          f"in, pop counts 0): card ranks equal to CPU ranks in every "
          f"leaf", flush=True)
    if "judge_outbox" in report:
        report["judge_outbox"].setdefault("adversarial", {
            "err": 0.0, "rows": {}})["rows"]["mesh flush_phases"] = {
                "err": err, "sends": sends}


def mesh_phase(torch, card, report):
    import concurrent.futures as cf

    from shadow_tpu_torch.device.mesh import mesh_backend

    print(f"[mesh] torch.cuda.device_count() = {torch.cuda.device_count()}; "
          f"S ranks on device 0 take the {mesh_backend(['cuda:0'] * 2)} "
          "backend", flush=True)
    # the flush's check beside the first spawn's start-up and untimed
    # parity runs (a spawn's ranks take about 20 s to reach the card)
    with cf.ThreadPoolExecutor(1) as pool:
        flush = pool.submit(mesh_flush, torch, report)
        spawned = mesh_card_runs(torch, report)
        flush.result()
    try:
        mesh_parity(torch, report, spawned)
        mesh_campaign_parity(torch, card, report, spawned)
        mesh_full(torch, card, report, spawned)
        mesh_campaign_full(torch, card, report, spawned)
        mesh_state_full(torch, card, report, spawned)
        mesh_supervise(torch, card, report, spawned)
        mesh_shrink(torch, card, report, spawned)
    finally:
        shutil.rmtree(spawned["work"], ignore_errors=True)


def boot_phase(torch, card):
    """examples/tgen_1000000.yaml as shipped, booted on the card: the
    build (timed), the admission verdict, the engine and init_state;
    not run (its clients all ask server0, which overflows)."""
    from shadow_tpu_torch.config import load_config
    from shadow_tpu_torch.core.build import build
    from shadow_tpu_torch.device import capacity, runner

    path = os.path.join(REPO, "examples", "tgen_1000000.yaml")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = load_config(path)
    sim = build(cfg)
    t_build = time.perf_counter() - t0
    engine = runner.engine_from(cfg, sim, device="cuda")
    state = engine.init_state(sim.start_times, sim.stop_times)
    torch.cuda.synchronize()
    t_boot = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    top = sim.topology
    hosts = int(state["head"].shape[0])
    check(top.n_vertices == 1_000_200 and top.hier is not None
          and top.hier.n_clusters == 200, "tgen_1000000: not the "
          "1,000,200-vertex factored topology")
    check(hosts == 1_000_000 and engine.next_time(state) == 10**7,
          "tgen_1000000: boot state wrong")
    print(f"[boot:tgen_1000000] {hosts} hosts, V={top.n_vertices}, "
          f"C={top.hier.n_clusters}, table bytes {top.table_nbytes()}, "
          f"lookahead {sim.lookahead} ns; build {t_build:.3f} s, boot "
          f"(build + admission + engine + init_state on the card) "
          f"{t_boot:.3f} s; peak device memory {peak} B; "
          f"{capacity.verdict_line(engine.admission)}; card {card}",
          flush=True)


def kernels_line(report):
    full = report.pop("_full")
    runs = {**full, **report.pop("_parity", {}),
            **report.pop("_extra", {}),
            **{f"mesh:{k}": v for k, v in {
                **report.pop("_mesh_parity", {}),
                **report.pop("_mesh_full", {})}.items()}}
    replicas = report.pop("_replicas", {})
    # K10 on the real flushes of the full phase's hybrid runs
    for name, row in report.pop("_judge_real", {}).items():
        report[name]["on_real_flushes"] = row
    rows = []
    for n in ROWS:
        r = report[n]
        shapes = {k: r[k] for k in ("at_tgen_shape", "at_tor_shape",
                                    "on_factored_tables",
                                    "err_on_shipped_tables",
                                    "at_1m_hosts", "at_cx16",
                                    "wider_rows", "odd_e", "at_S4",
                                    "overflowing", "adversarial",
                                    "on_real_phases", "synthetic",
                                    "outside",
                                    "on_real_flushes", "on_a_mesh_rank",
                                    "broken")
                  if k in r}
        rows.append({
            "name": n, "route": "cuda", "source": SOURCES[n],
            "replaces": REPLACES[n],
            "launches": sum(run["launches"].get(n, 0)
                            for run in runs.values()),
            "max_abs_err": max([r["err"]] + [
                x["err"] if isinstance(x, dict) else x
                for x in shapes.values()]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"),
            "bytes": r["bytes"], "ops": r["ops"],
            "shape": r["shape"],
            **({"view": "shadow_tpu_torch/csrc/topo.cuh"}
               if "_hier" in n or "_ep" in n else {}),
            "launches_by_run": {k: run["launches"].get(n, 0)
                                for k, run in runs.items()},
            # device ms of the main path's kernels: the profiled graph
            # run of each full run (over the kernels the profiler saw);
            # and of the timed Python loop, which launches no K9 or K8
            # (null where a run did not launch the kernel)
            "graph_run_device_ms_by_run": {
                k: run["device_ms"].get(n) if run["launches"][n] else None
                for k, run in full.items()},
            "graph_run_profiled_launches_by_run": {
                k: run["profiled"].get(n) if run["launches"][n] else None
                for k, run in full.items()},
            "timed_python_loop_ms_by_run": {
                k: run["timed_ms"][n] for k, run in full.items()
                if "timed_ms" in run},
            **({"torch_sort_ms": r["torch_sort_ms"]}
               if "torch_sort_ms" in r else {}),
            **shapes,
            # the kernel at R = REPLICAS replicas against R = 1
            # (`replica_kernels`)
            **({"at_r4": replicas[n]} if n in replicas else {}),
            **({"at_r4_with_outbox_words": replicas[n + "_word"]}
               if n + "_word" in replicas else {}),
            # the design before this one, on the same inputs
            **({"parent_ms": r["parent_ms"]} if "parent_ms" in r else {}),
            **({"at_r4_on_factored_tables": replicas[n + "_hier"]}
               if n + "_hier" in replicas and "_hier" not in n else {}),
        })
    return json.dumps({"kernels": rows})


def pop_times(torch) -> dict:
    """Median device ms of 15 launches of each kernel of a standalone
    run (R = 1), on seeded inputs: the unaudited K1 at the PHOLD shapes
    (100,000 hosts on a 2-vertex dense world) and K2 on its outbox,
    K1_hier at examples/tgen_1000000.yaml's 1,000,000 hosts (hub loss
    PHOLD_1M_HUB_LOSS), K4 at tgen_10000's layout at 100,000 hosts
    (`tgen_inputs`), K6 at tor_large's (`tor_inputs`), K3, K5 and
    phase_tally at the PHOLD shapes (a random outbox), K8 at 100,000
    and 1,000,000 hosts and K9 at 1,000,000 (`audit_inputs`); where the
    package has outbox words, K1 and K1_hier again over rows already
    clear (the pop's own stores, without the clear); then the device ms
    per launch of K1_hier, K2_hier, K5, K3 and phase_tally on the main
    path's own data, phold_1m_hier in timing mode, and of the pop, K2,
    K5, K3 and phase_tally on phold (2 x 50,000 hosts), tgen_10000,
    tor_small and tor_large as shipped; then `graph_times`; through the
    API the window loop's control block brought, so that `--ab` can time
    another commit's package."""
    from shadow_tpu_torch.device import kernels as K
    from shadow_tpu_torch.device.apps import PholdDevice
    from shadow_tpu_torch.device.prng import seed_key

    dev = torch.device("cuda")
    rng = np.random.default_rng(20261017)
    scratch = K.Kernels()
    scratch.library()
    _, sim, million = million_world(dev)
    worlds = {"pop_phase": (100_000, {
        "host_vertex": torch.from_numpy(
            rng.integers(0, 2, 100_000).astype(np.int32)).to(dev),
        "lat": torch.tensor([[30_000_000, 50_000_000],
                             [50_000_000, 30_000_000]],
                            dtype=torch.int32, device=dev),
        "rel": torch.tensor([[0.98, 0.9], [0.9, 0.98]],
                            dtype=torch.float32, device=dev),
        "epoch_times": torch.zeros(1, dtype=torch.int64, device=dev)}),
        "pop_phase_hier": (len(sim.host_vertex),
                           million(PHOLD_1M_HUB_LOSS))}
    # the window end as each commit's pop takes it: from a control block
    # where there is one, by value before
    win = (window_block(K, 10**9, dev) if hasattr(K, "control_block")
           else 10**9)
    out = {}
    for name, (H, world) in worlds.items():
        E, KS = 64, 3
        B = 32 // KS
        state0 = random_state(rng, H, E, dev)
        p = K.PhaseParams(E=E, K=KS, T=0, P=1, B=B, IN=64, C=1,
                          boot_end=5 * 10**8, seed=seed_key(7),
                          app=PholdDevice(n_hosts_total=H, msgload=KS,
                                          size=512))

        def args():
            return (clone(state0), {f: torch.empty(
                (H, B * KS), dtype=torch.int64, device=dev)
                for f in K.OB_FIELDS},
                torch.empty(H, dtype=torch.int32, device=dev), world,
                win, p)

        out[name] = time_median(torch, scratch.pop, args, 15)
        check(scratch.launches[name] > 0, f"{name} never launched")
        if hasattr(K, "outbox_word"):
            # the same pops over rows already clear, no host popped
            # last phase: the pop's own stores alone, without the clear
            def unclear():
                a = args()
                for f in K.OB_FIELDS:
                    a[1][f].fill_(K.INF if f == "t" else 0)
                a[2].zero_()
                return (*a, K.outbox_word(dev).zero_())

            out[f"{name}, rows already clear"] = time_median(
                torch, scratch.pop, unclear, 15)
        if name == "pop_phase":
            # K2 on K1's outbox
            judged = args()
            scratch.pop(*judged)
            out["judge_outbox"] = time_median(
                torch, scratch.judge_outbox, lambda: (
                    clone(judged[0]), clone(judged[1]), world, win, p), 15)
    # K4, K6, K3, K5, the tallies, K8 and K9 (at R = 1, a standalone
    # run's launches)
    H = 100_000
    state0, world, pt, win_end = tgen_inputs(torch, K, rng, H, 48, dev)
    win_t = (window_block(K, win_end, dev) if hasattr(K, "control_block")
             else win_end)

    def tgen_args():
        return (clone(state0), {f: torch.empty(
            (H, pt.OB), dtype=torch.int64, device=dev)
            for f in K.OB_FIELDS},
            torch.empty(H, dtype=torch.int32, device=dev), world, win_t,
            pt)

    out["pop_tgen"] = time_median(torch, scratch.pop, tgen_args, 15)
    tor0, tor_world, pr, tor_end = tor_inputs(torch, K, rng, dev)
    win_r = (window_block(K, tor_end, dev) if hasattr(K, "control_block")
             else tor_end)
    Ht = tor0["head"].shape[0]
    out["pop_tor"] = time_median(torch, scratch.pop, lambda: (
        clone(tor0), {f: torch.empty((Ht, pr.OB), dtype=torch.int64,
                                     device=dev) for f in K.OB_FIELDS},
        torch.empty(Ht, dtype=torch.int32, device=dev), tor_world, win_r,
        pr), 15)
    state0 = random_state(rng, H, 64, dev)
    ob3 = random_outbox(rng, H, 30, torch, dev)
    seg = K.route_plain(ob3)
    p3 = K.PhaseParams(E=64, K=3, T=0, P=1, B=10, IN=64, C=1, boot_end=0,
                       seed=seed_key(7), app=PholdDevice(
                           n_hosts_total=H, msgload=3, size=512))
    out["merge_heaps"] = time_median(
        torch, scratch.merge_heaps,
        lambda: (clone(state0), ob3, *seg, p3), 15)
    out["route"] = time_median(torch, scratch.route, lambda: (ob3,), 15)
    pops = torch.from_numpy(rng.integers(0, 9, H).astype(np.int32)).to(dev)
    occ = {"occ_ob": torch.zeros(H, dtype=torch.int32, device=dev),
           "occ_trips": torch.zeros(1, dtype=torch.int32, device=dev),
           "occ_phases": torch.zeros(1, dtype=torch.int32, device=dev)}
    out["phase_tally"] = time_median(
        torch, scratch.phase_tally, lambda: (clone(occ), ob3, pops, p3),
        15)
    for hosts in (100_000, 1_000_000):
        aud = audit_inputs(torch, K, rng, hosts, 64, dev)
        out[f"audit_round {hosts} hosts"] = time_median(
            torch, scratch.audit_round, lambda: (clone(aud),), 15)
    m = int(K.head_min_plain(aud))
    words = {"stop": K.INF, "final_stop": K.INF, "lookahead": 10**6,
             "max_rounds": 1 << 40, "rounds": 5, "phases": 9, "run": 1,
             "win_end": m}
    out["loop_control 1000000 hosts"] = time_median(
        torch, scratch.loop_control,
        lambda: (aud, K.control_block(dev, **words)), 15)
    check(scratch.launches["pop_tgen"] > 0 and
          scratch.launches["merge_heaps"] > 0, "K4 or K3 never launched")
    # the main path's own data: phold_1m_hier in timing mode (the
    # Python loop in every commit), K1_hier's device ms per launch
    from shadow_tpu_torch.device import runner

    timed = K.Kernels(timing=True)
    stats = runner.run(full_config(None, ()), "cuda", kernels=timed)
    check(stats.ok and stats.rounds == PHOLD_1M_ROUNDS,
          f"phold_1m_hier: {stats.rounds} rounds")
    ms = timed.kernel_ms()
    for k in ("pop_phase_hier", "judge_outbox_hier", "route",
              "merge_heaps", "phase_tally"):
        out[f"{k} on phold_1m_hier, per launch"] = ms[k] / \
            timed.launches[k]
    out["pop_phase_hier on phold_1m_hier, launches"] = \
        timed.launches["pop_phase_hier"]
    # phold (2 x 50,000 hosts), tgen_10000, tor_small and tor_large as
    # shipped, in timing mode
    phold_ovr = next(r[2] for r in FULL_RUNS if r[0] == "phold")
    for example, pop, ovr in (("phold.yaml", "pop_phase", phold_ovr),
                              ("tgen_10000.yaml", "pop_tgen", ()),
                              ("tor_small.yaml", "pop_tor", ()),
                              ("tor_large.yaml", "pop_tor", ())):
        timed = K.Kernels(timing=True)
        runner.run(full_config(example, ovr), "cuda", kernels=timed)
        ms = timed.kernel_ms()
        for k in (pop, "judge_outbox", "route", "merge_heaps",
                  "phase_tally"):
            out[f"{k} on {example[:-5]}, per launch"] = ms[k] / \
                timed.launches[k]
    out.update(graph_times(torch, K))
    return out


# the full runs whose graph walls and K9 and tally device ms `--ab`
# compares: where the two weigh most (PERF.md)
AB_GRAPH_RUNS = ("tgen_10000_nic", "tor_large", "tgen_10000_x10")


def graph_times(torch, K) -> dict:
    """The main path of AB_GRAPH_RUNS through K's package: each run's
    graph loop untimed (its wall) and once more under torch.profiler
    (its K9 and tally device ms, summed, and K7's where the run counts
    paths); in a package whose K9 folds
    the tally (Kernels.fold_tally), the same without the fold and with
    the designs before it (Kernels.designs_before), the
    untimed runs in turns (a, b, c, c, b, a; each wall the mean of its
    two), for an A/B in one process. Counts equal between them."""
    from shadow_tpu_torch.device import runner

    out = {}
    variants = {"": {}}
    if hasattr(K.Kernels(), "fold_tally"):
        variants[", not folded"] = {"fold_tally": False}
        variants[", the designs before"] = {"designs_before": True}

    def kernels_of(label):
        kernels = K.Kernels()
        for a, v in variants[label].items():
            setattr(kernels, a, v)
        return kernels

    for name in AB_GRAPH_RUNS:
        _, example, ovr, path = next(r for r in FULL_RUNS if r[0] == name)
        cfg = full_config(example, ovr)
        order = list(variants) + list(reversed(variants))
        walls, first = {}, None
        for label in order:
            gc.collect()
            stats = runner.run(cfg, "cuda", kernels=kernels_of(label))
            check(stats.ok and stats.loop == "graph", f"{name}: not ok "
                  f"or not the graph loop ({stats.loop})")
            first = first or stats
            same_run(first, stats, f"ab {name}", ("", label))
            walls.setdefault(label, []).append(stats.wall_s)
        for label in variants:
            kernels = kernels_of(label)
            rows = (("loop_control_tally",)
                    if getattr(kernels, "fold_tally", False)
                    and not kernels.designs_before
                    else ("phase_tally", "loop_control"))
            stats = runner.run(cfg, "cuda", kernels=kernels)
            launches = dict(kernels.launches)
            ms, _, _ = _profile_once(torch, name, cfg, path + rows, stats,
                                     launches, kernels)
            out[f"graph wall {name}{label}, s"] = statistics.mean(
                walls[label])
            for k in rows:
                out[f"{k} on {name}{label}, device ms"] = ms[k]
                out[f"{k} on {name}{label}, per launch"] = \
                    ms[k] / launches[k]
            out[f"K9 and the tally on {name}{label}, device ms"] = sum(
                ms[k] for k in rows)
            if "count_paths" in path:
                out[f"count_paths on {name}{label}, device ms"] = \
                    ms["count_paths"]
                out[f"count_paths on {name}{label}, per launch"] = \
                    ms["count_paths"] / launches["count_paths"]
    out.update(audit_compact_times(torch, K))
    return out


def audit_compact_times(torch, K) -> dict:
    """The main path under the audit and the compaction through K's
    package: phold_1m_hier (AUDITED) unaudited and audited, each graph
    run untimed (walls in turns), the audited run once more under
    torch.profiler (K8's device ms), and the audit's share of the wall;
    the COMPACT_FULL runs under outbox_compact at the uncompacted run's
    largest occ_ob (walls in turns; K11's device ms, profiled). In a
    package whose Kernels.designs_before also covers K8 and K11 (its
    compact_outbox takes pop counts), both again with the designs
    before. Counts equal between them."""
    import inspect

    from shadow_tpu_torch.device import runner

    out = {}
    labels = [""]
    if "pops" in inspect.signature(K.Kernels.compact_outbox).parameters:
        labels.append(", the designs before")

    def kernels_of(label):
        kernels = K.Kernels()
        kernels.designs_before = bool(label)
        return kernels

    def turns(name, cfgs, first=None):
        """Each (label, cfg) run untimed in turns (a, b, ..., b, a), its
        kernels' design by the label's part after "|": {label: mean
        wall}, {label: (stats, launches) of its last run}."""
        order = list(cfgs) + list(reversed(cfgs))
        walls, last = {}, {}
        for label in order:
            gc.collect()
            kernels = kernels_of(label.split("|")[-1])
            stats = runner.run(cfgs[label], "cuda", kernels=kernels)
            check(stats.ok and stats.loop == "graph", f"{name}: not ok "
                  f"or not the graph loop ({stats.loop})")
            first = first or stats
            same_run(first, stats, f"ab {name}", ("", label))
            walls.setdefault(label, []).append(stats.wall_s)
            last[label] = (stats, dict(kernels.launches))
        return {k: statistics.mean(v) for k, v in walls.items()}, last

    def device_ms(name, cfg, label, stats, launches, row):
        path = tuple(k for k, n in launches.items() if n)
        ms, _, _ = _profile_once(torch, name, cfg, path, stats, launches,
                                 kernels_of(label))
        return ms[row], launches[row]

    _, example, ovr, _ = next(r for r in FULL_RUNS if r[0] == AUDITED)
    cfgs = {"unaudited|": full_config(example, ovr)}
    for label in labels:
        cfgs[f"audited|{label}"] = full_config(example, ovr + (AUDIT,))
    walls, last = turns(AUDITED, cfgs)
    for label in labels:
        key = f"audited|{label}"
        stats, launches = last[key]
        ms, n = device_ms(AUDITED, cfgs[key], label, stats, launches,
                          "audit_round")
        wall = walls[key]
        out[f"graph wall {AUDITED} audited{label}, s"] = wall
        out[f"audit_round on {AUDITED}{label}, device ms"] = ms
        out[f"audit_round on {AUDITED}{label}, per launch"] = ms / n
        out[f"the audit's share of {AUDITED}'s wall{label}"] = \
            (wall - walls["unaudited|"]) / wall
    out[f"graph wall {AUDITED}, s"] = walls["unaudited|"]
    for name, example, ovr, _ in COMPACT_FULL:
        kernels = K.Kernels()
        base, leaves = engine_run(full_config(example, ovr), "cuda",
                                  kernels=kernels)
        cx = int(leaves["occ_ob"].max())
        cfg = full_config(example, ovr + (
            f"experimental.outbox_compact={cx}",))
        walls, last = turns(f"{name}_compact",
                            {label: cfg for label in labels}, base)
        for label in labels:
            stats, launches = last[label]
            ms, n = device_ms(f"{name}_compact", cfg, label, stats,
                              launches, "compact_outbox")
            out[f"graph wall {name} compacted (CX={cx}){label}, s"] = \
                walls[label]
            out[f"compact_outbox on {name}{label}, device ms"] = ms
            out[f"compact_outbox on {name}{label}, per launch"] = ms / n
    return out


def ab_pops(other: str, card: str) -> None:
    """`pop_times` of the package in `other` (a checkout of another
    commit) and of this one, each in its own process, in turns: other,
    this, this, other."""
    for tree in (other, REPO, REPO, other):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--pop-times",
             "--package", tree], capture_output=True, text=True,
            timeout=900)
        check(proc.returncode == 0, f"--pop-times in {tree} failed:\n"
              f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
        times = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"[ab] {tree}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in times.items())
            + f"; card {card}", flush=True)


def result_line(kind: str) -> str:
    """The last line: the platform, the card's name, and the number of
    cards the run used, which is one (every phase runs on device 0,
    whatever else the machine holds)."""
    return json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": 1}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of " + ",".join(PHASES) + " (or "
                         "build,plan: the planner's and the segmented "
                         "advance's checks alone)")
    ap.add_argument("--ab", metavar="DIR",
                    help="only time every kernel of a standalone run (R = "
                         "1) of the package in DIR (a checkout of another "
                         "commit) and of this one, in turns, on seeded "
                         "inputs and on phold_1m_hier (`pop_times`), and "
                         "the main path's graph walls and K9, tally and "
                         "K7 device ms of AB_GRAPH_RUNS (`graph_times`)")
    ap.add_argument("--pop-times", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--package", default=REPO, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.package)
    if args.pop_times:
        print(json.dumps(pop_times(torch)), flush=True)
        return 0
    try:
        from shadow_tpu_torch.device.kernels import (
            build_library,
            toolkit_version,
        )
    except ImportError as e:
        print(f"chip_smoke: the shadow_tpu_torch package is missing "
              f"beside this script ({e})", file=sys.stderr)
        return 1
    # the campaigns' ENSEMBLE records land in a temporary directory
    records = tempfile.mkdtemp(prefix="chip_smoke_records_")
    os.environ["SHADOW_TPU_OCC_DIR"] = records
    try:
        card = card_line()
        print(f"card: {card}", flush=True)
        if args.ab:
            ab_pops(os.path.abspath(args.ab), card)
            return 0
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"python {sys.version.split()[0]}", flush=True)
        print(f"[build] {toolkit_version()}", flush=True)
        # the oracles run beside the build (nvcc keeps its priority)
        start_oracles(phases)
        t0 = time.perf_counter()
        lib, log = build_library(ptxas_verbose=True)
        print(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s",
              flush=True)
        for line in log.splitlines():
            if ("registers" in line or "Compiling entry" in line
                    or "spill" in line):
                print(f"[build] {line.strip()}", flush=True)
        report: dict = {}
        for phase, run in (("plan", lambda: plan_phase(torch, card, report)),
                           ("kernels", lambda: kernels_phase(torch, report)),
                           ("parity", lambda: parity_phase(torch, report)),
                           ("full", lambda: full_phase(torch, card, report)),
                           ("supervise",
                            lambda: supervise_phase(torch, card, report)),
                           ("mesh", lambda: mesh_phase(torch, card, report)),
                           ("boot", lambda: boot_phase(torch, card))):
            if phase not in phases:
                continue
            if phase == "full" and ORACLES is not None:
                print(f"[oracles] waited {ORACLES.finish():.1f} s for the "
                      "CPU oracles still running, so that none runs beside "
                      "the timed phases", flush=True)
            t1 = time.perf_counter()
            run()
            print(f"[{phase}] phase took "
                  f"{time.perf_counter() - t1:.1f} s", flush=True)
        if ORACLES is not None:
            check(not ORACLES.jobs, f"CPU oracles never read: "
                  f"{sorted(ORACLES.jobs)}")
            ORACLES.report()
            print(f"[oracles] the CPU oracles, started before the build, "
                  f"kept the phases that read them waiting "
                  f"{ORACLES.waited_s:.1f} s", flush=True)
        if "kernels" in phases and "full" in phases:
            print(kernels_line(report), flush=True)
        print(f"card: {card}", flush=True)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        if ORACLES is not None:
            ORACLES.close()
        shutil.rmtree(records, ignore_errors=True)
    print(result_line(torch.cuda.get_device_name(0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
