"""Command-line entry point of the port:

    python -m shadow_tpu_torch.cli cfg.yaml [-o key.path=value ...]
                                            [--device cpu]

Loads the config (with the reference's dotted overrides), runs it on
its policy (core/controller.py): the device engine on the card for
`tpu` (or, with --device cpu, its plain PyTorch path), the CPU engine
with the judge on the card (or on the CPU with --device cpu) for
`hybrid` and for a `tpu` config the device engine cannot run (host
faults, mixed model families), the CPU engine alone for `serial`, which
touches no device; and prints the reference CLI's "simulation finished"
summary line. A config with an `ensemble:` block runs its campaign
(ensemble/campaign.py; with `experimental.mesh_shards` on that many
ranks, each running the campaign's EnsembleRunner on its hosts) and
logs the reference's campaign line too, once. A
run the preemption drain stopped (SIGTERM or SIGINT under
`checkpoint_save` with segment boundaries, device/supervise.py) exits
75 after saving its resume checkpoint; rerun with
`-o experimental.checkpoint_load=<path>` to finish it.
"""

from __future__ import annotations

import argparse
import logging
import sys

from shadow_tpu_torch import simtime
from shadow_tpu_torch.config import load_config
from shadow_tpu_torch.device import capacity, runner
from shadow_tpu_torch.device.engine import NoCudaDevice
from shadow_tpu_torch.device.supervise import EXIT_PREEMPTED

log = logging.getLogger("shadow_tpu_torch")


def simulate(config_path: str, overrides=(), device="cuda",
             kernels=None) -> runner.SimStats:
    """Load a config file with dotted overrides and run it, or its
    ensemble campaign: what `main` does, for callers that want the
    stats (and may pass their own Kernels to read launch counts)."""
    cfg = load_config(config_path, overrides=overrides)
    if cfg.general.stop_time <= 0:
        raise ValueError("general.stop_time must be > 0")
    if cfg.ensemble is not None:
        from shadow_tpu_torch.core.build import check_slice
        from shadow_tpu_torch.ensemble.campaign import EnsembleRunner

        # its mesh_shards ranks, or as many as its checkpoint was saved
        # on (runner.adopted_devices)
        devices = runner.adopted_devices(cfg, runner.device_pool(cfg,
                                                                 device))
        if len(devices) > 1:
            # refused here as on the ranks (a host fault), before any
            # rank starts
            check_slice(cfg)
            return runner.run_mesh(cfg, devices)
        return EnsembleRunner(cfg, device=devices[0],
                              kernels=kernels).run()
    return runner.run(cfg, device=device, kernels=kernels)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="shadow-tpu-torch",
        description="discrete-event network simulator, PyTorch/CUDA "
                    "port of shadow-tpu")
    parser.add_argument("config", help="simulation config (YAML)")
    parser.add_argument("-o", "--option", action="append", default=[],
                        metavar="KEY=VALUE",
                        help="override a config value by dotted path, "
                             "e.g. -o general.stop_time=10s")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(name)s %(levelname)s: %(message)s")
    try:
        stats = simulate(args.config, args.option, device=args.device)
    except (OSError, ValueError, KeyError, NoCudaDevice) as e:
        print(f"shadow-tpu-torch: {e}", file=sys.stderr)
        return 1
    log.info("simulation finished at %s: %s",
             simtime.format_time(stats.end_time), stats.summary())
    if stats.path_packets is not None:
        log.info("path counters: %d packets sent over %d vertex pairs",
                 sum(stats.path_packets.values()),
                 len(stats.path_packets))
    if stats.ensemble is not None:
        # the per-replica breakdown and the aggregates live in the
        # ENSEMBLE record
        rec = stats.ensemble
        log.info("ensemble campaign %s: %d replicas, aggregate "
                 "packets %d; per-replica checksums + "
                 "mean/p5/p95/min/max in the ENSEMBLE record",
                 rec["campaign"], rec["workload"]["replicas"],
                 stats.packets_sent)
    if stats.stale_heartbeats:
        # the run finished, but some heartbeat gaps passed the
        # threshold (experimental.heartbeat_stale_after): it stalled
        log.warning("%d stale heartbeat gap(s) during the run "
                    "(gaps > %dx the expected cadence) — the run "
                    "stalled between segment boundaries; see the "
                    "STALE HEARTBEAT warnings above",
                    stats.stale_heartbeats,
                    load_config(args.config, args.option).experimental
                    .heartbeat_stale_after)
    if stats.admission is not None:
        log.info("%s", capacity.verdict_line(stats.admission))
    if stats.preempted:
        # a graceful preemption (device/supervise.py): incomplete but
        # resumable, a distinct rc (75, EX_TEMPFAIL)
        log.warning("preempted at %s — resume with "
                    "experimental.checkpoint_load: %s (rc %d)",
                    simtime.format_time(stats.end_time),
                    stats.resume_path, EXIT_PREEMPTED)
        return EXIT_PREEMPTED
    if not stats.ok:
        log.error("device engine overflow: %d events lost — raise "
                  "experimental.event_capacity/outbox_capacity/"
                  "exchange_in_capacity", stats.overflow)
    return 0 if stats.ok else 1


if __name__ == "__main__":
    sys.exit(main())
