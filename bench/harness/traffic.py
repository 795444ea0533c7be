"""The one traffic generator: the clients of a mix file, closed or open loop.

A mix (``bench/traffic/<name>.json``) gives ``loop`` and that loop's
parameters:

* ``"closed"``: a fixed set of clients, each sending its next request as
  soon as its previous one completes.
  - ``clients_per_lane``: clients per serving lane of the configuration;
  - ``stagger``: the share of a sample's schedule over which the
    clients' first requests spread: client i of n first sends at tick
    ⌊stagger · steps · i / n⌋, so 0 starts every client at once and 1
    spreads them over a whole schedule. Ticks before the last first
    request are set-up: the traffic needs them to put its lanes where it
    wants them.
* ``"open"``: requests arrive on a clock of their own, whatever the
  server has finished, from the window's start.
  - ``rate_per_s``: the mean arrival rate, requests per second;
  - ``burst`` (default 1): requests that arrive together. Bursts follow
    each other after gaps of mean ``burst / rate_per_s`` seconds, drawn
    as the exponential distribution's quantiles at (i + ½) / 256 in a
    seeded order, so every seed offers the same gaps in another order.

Every request's inputs come from its own seed, drawn from the run's
seed, the client (an open loop's client is its arrival) and the client's
request count; every run sends requests of the same size.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Dict, List

import numpy as np

LOOPS = ("closed", "open")
GAPS = 256           # gaps of an open loop, each block a seeded order


def load(path: Path) -> Dict:
    mix = json.loads(Path(path).read_text())
    loop = mix.get("loop")
    if loop not in LOOPS:
        raise ValueError(f"{path}: loop must be one of {LOOPS}")
    if loop == "closed":
        if not 0.0 <= float(mix["stagger"]) <= 1.0:
            raise ValueError(f"{path}: stagger must lie in [0, 1]")
        if int(mix["clients_per_lane"]) < 1:
            raise ValueError(f"{path}: clients_per_lane must be >= 1")
    else:
        if not float(mix["rate_per_s"]) > 0.0:
            raise ValueError(f"{path}: rate_per_s must be > 0")
        if int(mix.get("burst", 1)) < 1:
            raise ValueError(f"{path}: burst must be >= 1")
    return mix


def derive(*words: int) -> int:
    """A 63-bit seed from integers (any size, the run's seed first)."""
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(
        2, np.uint32)
    return int((int(state[0]) << 31) ^ int(state[1])) & (2 ** 63 - 1)


@dataclasses.dataclass
class Client:
    index: int
    first_tick: int
    sent: int = 0            # requests sent so far


class Clients:
    """The clients of one run: who sends at which tick or second, whether
    a completed request is followed by the client's next, and the seed of
    every request each sends."""

    def __init__(self, mix: Dict, lanes: int, steps: int, seed: int):
        self.seed = int(seed)
        self.closed = mix["loop"] == "closed"
        self.clients: List[Client] = []
        self._next_s = math.inf         # an open loop's next burst
        if self.closed:
            n = lanes * int(mix["clients_per_lane"])
            spread = float(mix["stagger"]) * steps
            self.clients = [Client(i, int(spread * i // n))
                            for i in range(n)]
        else:
            self.burst = int(mix.get("burst", 1))
            mean = self.burst / float(mix["rate_per_s"])
            q = (np.arange(GAPS) + 0.5) / GAPS
            self._gaps = -mean * np.log1p(-q)

    @property
    def setup_ticks(self) -> int:
        """Ticks to run before the window: every first request but those
        of the last first tick is sent, and served, before it."""
        return max((c.first_tick for c in self.clients), default=0)

    def due(self, tick: int) -> List[Client]:
        """The closed loop's clients that first send at set-up tick
        ``tick``."""
        return [c for c in self.clients if c.first_tick == tick]

    def start(self, t0: float) -> None:
        """The window opens at host time ``t0``: an open loop's first
        burst arrives after its first gap."""
        if not self.closed:
            self._next_s = t0 + self._gap(0)

    def _gap(self, k: int) -> float:
        order = np.random.default_rng(derive(self.seed, 7, k // GAPS)
                                      ).permutation(GAPS)
        return float(self._gaps[order[k % GAPS]])

    def arrivals(self, now: float) -> List[tuple]:
        """(client, arrival time) of every open-loop request due by host
        time ``now``, each a new client; none in a closed loop."""
        out = []
        while self._next_s <= now:
            for _ in range(self.burst):
                c = Client(len(self.clients), 0)
                self.clients.append(c)
                out.append((c, self._next_s))
            self._next_s += self._gap(len(self.clients) // self.burst)
        return out

    def next_arrival(self) -> float:
        """Host time of the next open-loop burst (inf in a closed loop)."""
        return self._next_s

    def next_seed(self, client: Client) -> int:
        """The seed of the client's next request (advances its count)."""
        s = derive(self.seed, 1 + client.index, client.sent)
        client.sent += 1
        return s
