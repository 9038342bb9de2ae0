"""The Tor model's constants, route rule and client arguments (the
port's copy of the reference package's models/tor.py), which the
device twin (device/apps.py) and the CPU model (models/tor.py) share.

Clients pull `cells` cells through 3-hop onion circuits (guard ->
middle -> exit) in chunks of CHUNK_CELLS, `count` times, pausing
`pause` between downloads and re-requesting a chunk after `retry`
(0 = never). A circuit is a pure function of the client id: three
distinct relays drawn from the counter RNG keyed (TOR_ROUTE, client,
hop), so relays keep no circuit state. A relay takes no arguments.

d1 packs (circ << SEQ_BITS) | chunk start; circuits are client ids.
"""

from __future__ import annotations

from dataclasses import dataclass

from shadow_tpu_torch.config.units import parse_time_ns

TAG_TOR_REQ = 3
TAG_TOR_DATA = 4

CELL_BYTES = 512                # cell payload quantum
CHUNK_CELLS = 16                # cells per REQ round trip (window)
SEQ_BITS = 12                   # seq field width inside d1
SEQ_MASK = (1 << SEQ_BITS) - 1


def pick_route(bits3: tuple[int, int, int], n_relays: int
               ) -> tuple[int, int, int]:
    """Three distinct relay indices (guard, middle, exit) from three
    independent u32 draws."""
    r = n_relays
    g = bits3[0] % r
    m = bits3[1] % (r - 1)
    if m >= g:
        m += 1
    lo, hi = (g, m) if g < m else (m, g)
    e = bits3[2] % (r - 2)
    if e >= lo:
        e += 1
    if e >= hi:
        e += 1
    return g, m, e


@dataclass(frozen=True)
class TorClientArgs:
    cells: int                   # cells per download
    count: int                   # downloads
    pause_ns: int                # between downloads
    retry_ns: int                # chunk re-request timeout, 0 = off

    @classmethod
    def parse(cls, args: dict) -> "TorClientArgs":
        """From the process's parsed "k=v" args, with the reference
        client's defaults."""
        cells = int(args.get("cells", 64))
        if cells > SEQ_MASK:
            raise ValueError(f"cells > {SEQ_MASK} not encodable")
        return cls(cells=cells, count=int(args.get("count", 1)),
                   pause_ns=parse_time_ns(args.get("pause", "1 s")),
                   retry_ns=parse_time_ns(args.get("retry", 0)))
