"""Counter-RNG purpose ids: the stable tags that key every stochastic
decision (purpose -> host id -> seq), copied from the reference
package's utils/rng.py so both engines draw from the same domains."""

PURPOSE_PACKET_DROP = 1
PURPOSE_APP = 3
PURPOSE_TOR_ROUTE = 5
