"""The state audit's verdict (the port's cut copy of the reference
package's device/supervise.py: `AUDIT_BIT_NAMES`, `AuditFailure`,
`decode_audit` and `check_audit`, with the reference's message text).

The segmented advance, heartbeats, checkpoints and the robustness layer
are not ported (ROADMAP.md queue (a) item 7): the runner checks the
health word once, at the run's end.
"""

from __future__ import annotations

import numpy as np

AUDIT_BIT_NAMES = {
    1: "heap-order/head-bounds",
    2: "clock-monotonicity",
    4: "counter-negativity",
    8: "packet-conservation",
}


class AuditFailure(RuntimeError):
    """The on-device invariant audit found a corrupted state. The run
    stops rather than writing (or running past) a checkpoint that a
    restart would trust."""


def decode_audit(word: int) -> list[str]:
    """Health-word bitmask -> the named invariants it violates."""
    return [name for bit, name in sorted(AUDIT_BIT_NAMES.items())
            if word & bit]


def check_audit(state, where: str = "", last_good: str = "") -> None:
    """Validate the health word of a state (its [H] `aud` tensor). No-op
    when the engine was built without the audit. Raises
    :class:`AuditFailure` naming the violated invariants, and the last
    validated checkpoint, if any, on a nonzero word."""
    if "aud" not in state:
        return
    aud = state["aud"].cpu().numpy()
    if not aud.any():
        return
    names = decode_audit(int(np.bitwise_or.reduce(aud, axis=None)))
    hint = (f"; last validated checkpoint: {last_good}" if last_good
            else "; no validated checkpoint exists yet")
    raise AuditFailure(
        f"state audit failed{f' at {where}' if where else ''}: "
        f"violated invariant(s) {names} on "
        f"{int((aud != 0).sum())} host slot(s) — the state is "
        f"corrupted and will not be checkpointed or run further"
        f"{hint}")
