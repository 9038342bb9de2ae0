"""The packet-drop rule (the port of the reference package's
device/netsem.py).

A packet from `src` with per-source sequence `pkt_seq` is dropped iff
the path is lossy (reliability < 1), the simulation is past the
bootstrap phase, and the counter-RNG roll lands at or above the
reliability (compared in float32). The CUDA judge kernel
(csrc/judge_outbox.cu) applies the same rule per packet.
"""

from __future__ import annotations

import torch

from shadow_tpu_torch.device import prng
from shadow_tpu_torch.utils.rng import PURPOSE_PACKET_DROP


def packet_drop_mask(seed_pair, boot_end: int, now, src, pkt_seq,
                     reliability: torch.Tensor,
                     src_key=None) -> torch.Tensor:
    """Elementwise drop decision over broadcastable tensors: `now` the
    send time (int64), `reliability` the path value (float32).
    `src_key` is an optional precomputed
    prng.purpose_id_key(seed_pair, PURPOSE_PACKET_DROP, src).
    Returns a bool tensor, True = dropped."""
    if src_key is None:
        key = prng.chain_key(seed_pair, PURPOSE_PACKET_DROP, src,
                             pkt_seq)
    else:
        key = prng.fold_seq(src_key, pkt_seq)
    u = prng.uniform01(key)
    return (reliability < 1.0) & (now >= boot_end) & (u >= reliability)
