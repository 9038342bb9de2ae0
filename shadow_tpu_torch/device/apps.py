"""Vectorized application models (the port of the reference package's
device/apps.py, cut to PHOLD).

`handle` processes one popped event for every host at once; inputs and
outputs are batched over the host dimension [H]. Decisions come only
from the counter-RNG `draws`, consumed in order, so the trace equals
the CPU model's (shadow_tpu/models/phold.py in the reference package).
This plain form serves the CPU path; the CUDA pop kernel
(csrc/pop_phase.cu) carries the same PHOLD decision fused in.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from shadow_tpu_torch.core.event import KIND_BOOT, KIND_PACKET
from shadow_tpu_torch.device.prng import M32


class AppOut(NamedTuple):
    send_dst: torch.Tensor       # [H,K] destination host id (int32)
    send_size: torch.Tensor      # [H,K] bytes (int32)
    send_d0: torch.Tensor        # [H,K] payload word 0 (int32)
    send_d1: torch.Tensor        # [H,K] payload word 1 (int32)
    send_valid: torch.Tensor     # [H,K] bool
    n_draws: torch.Tensor        # [H] app RNG draws consumed (int32)
    app_state: torch.Tensor      # [H,W] updated state (int32)


@dataclass
class PholdDevice:
    """Boot sends `msgload` messages to peers picked as
    (self + 1 + bits % (n-1)) % n, one draw per message; each received
    packet triggers one more send the same way."""

    n_hosts_total: int
    msgload: int = 1
    size: int = 64
    selfloop: int = 0

    n_state_words = 1            # [received_count]
    max_timers = 0
    max_train = 1

    @property
    def max_sends(self) -> int:
        return max(1, self.msgload)

    @property
    def max_draws(self) -> int:
        return max(1, self.msgload)

    def init_state(self, n_hosts: int, device) -> torch.Tensor:
        return torch.zeros((n_hosts, self.n_state_words),
                           dtype=torch.int32, device=device)

    def pick_peer(self, gid: torch.Tensor, bits: torch.Tensor):
        """bits: u32 values held in int64 (prng.random_bits32)."""
        n = self.n_hosts_total
        if self.selfloop or n == 1:
            return (bits % n).to(torch.int32)
        g = gid.to(torch.int64) & M32
        return (((g + 1 + bits % (n - 1)) & M32) % n).to(torch.int32)

    def handle(self, gid, now, kind, src, size, d0, d1, d2, app_state,
               draws) -> AppOut:
        H, K = draws.shape[0], self.max_sends
        boot = kind == KIND_BOOT
        pkt = kind == KIND_PACKET
        ks = torch.arange(K, device=draws.device)[None, :]
        valid = torch.where(boot[:, None], ks < self.msgload,
                            pkt[:, None] & (ks == 0))
        peers = self.pick_peer(gid[:, None], draws[:, :K])
        sizes = torch.full((H, K), self.size, dtype=torch.int32,
                           device=draws.device)
        zeros = torch.zeros((H, K), dtype=torch.int32, device=draws.device)
        n_draws = torch.where(boot, self.msgload,
                              torch.where(pkt, 1, 0)).to(torch.int32)
        new_state = app_state.clone()
        new_state[:, 0] += pkt.to(torch.int32)
        return AppOut(send_dst=peers, send_size=sizes, send_d0=zeros,
                      send_d1=zeros, send_valid=valid, n_draws=n_draws,
                      app_state=new_state)
