"""Per-host trace checksums (copy of the reference's utils/checksum.py).

Both the port and the reference fold every executed event's
(time, src, kind, seq) into a 63-bit rolling hash per host; equal
checksums certify equal per-host schedules.
"""

MASK63 = (1 << 63) - 1
CHK_MUL = 1000003
CHK_SRC = 2654435761
CHK_KIND = 1315423911
CHK_SEQ = 2246822519


def chk_mix(chk: int, time: int, src: int, kind: int, seq: int) -> int:
    """Fold one executed event into a host's checksum."""
    mix = (time ^ (src * CHK_SRC) ^ (kind * CHK_KIND)
           ^ (seq * CHK_SEQ)) & MASK63
    return (chk * CHK_MUL + mix) & MASK63
