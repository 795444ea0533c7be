"""Set-up and the measured window of one cell: the port's lifecycle engine
(``SpeCaEngine.submit`` / ``tick`` / ``poll`` / ``release``) serving the
clients of the cell's mix.

Set-up draws the tamed weights on the device from the seed, builds the
engine at the configuration's lane width, warms that width's lane step
(``SpeCaEngine.warmup``: the kernels are built into ``build/kernels/``
inside the checkout on the first run and loaded after) and runs the
ticks the mix needs to spread its lanes. The window then ticks the
engine until ``seconds`` have passed, sending each request the mix
makes due (``harness/traffic.py``: in a closed loop a client's next as
its last comes back, in an open loop every arrival by the clock; an idle
engine waits for the next). Work the window issued is waited for before
the window closes, so a rate counts it all.

Each request's inputs (initial noise, class label, text stub) come from
its own seed by :func:`request_inputs`, which the judge calls again.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from bench.harness import traffic as TR
from bench.harness import weights as WT


def port_configs(cfg: Dict):
    """The port's (ModelConfig, DiffusionConfig, SpeCaConfig) of a
    benchmark configuration."""
    from repro_torch.configs import DiffusionConfig, ModelConfig, \
        SpeCaConfig
    mc = ModelConfig(
        name=cfg["name"], num_layers=cfg["num_layers"],
        d_model=cfg["d_model"], num_heads=cfg["num_heads"],
        d_ff=cfg["d_ff"], act=cfg["act"], patch_size=cfg["patch_size"],
        in_channels=cfg["in_channels"], num_classes=cfg["num_classes"],
        cond_dim=cfg["cond_dim"], norm_eps=cfg["norm_eps"],
        dtype=cfg["dtype"], source=cfg["source"])
    dc = DiffusionConfig(
        num_train_timesteps=cfg["num_train_timesteps"],
        num_inference_steps=cfg["num_inference_steps"],
        schedule=cfg["schedule"], latent_size=cfg["latent_size"])
    sc = SpeCaConfig(taylor_order=cfg["taylor_order"],
                     max_draft=cfg["max_draft"], tau0=cfg["tau0"],
                     beta=cfg["beta"], verify_layer=cfg["verify_layer"],
                     eps=cfg["eps"])
    return mc, dc, sc


def make_weights(cfg: Dict, seed: int, device) -> Dict:
    """The configuration's tamed model, laid out in the order the run's
    seed draws (``harness/weights.py``)."""
    params = WT.make(cfg, int(cfg["weights_seed"]), int(cfg["taming_seed"]),
                     device)
    return WT.permute(params, cfg, TR.derive(seed, 0, 3), device)


def request_inputs(cfg: Dict, rseed: int, device) -> Dict:
    """``noise`` [1, H, W, C] f32, ``label`` (an int, or None) and
    ``text`` ([1, T_text, cond_dim], or None) of the request with seed
    ``rseed``, drawn on ``device``."""
    s, C = cfg["latent_size"], cfg["in_channels"]
    g = torch.Generator(device=device).manual_seed(TR.derive(rseed, 1))
    noise = torch.randn((1, s, s, C), generator=g, device=device)
    label = int(TR.derive(rseed, 2) % cfg["num_classes"]) \
        if cfg["num_classes"] else None
    text = None
    if cfg["cond_dim"]:
        g = torch.Generator(device=device).manual_seed(TR.derive(rseed, 3))
        text = torch.randn((1, cfg["text_tokens"], cfg["cond_dim"]),
                           generator=g, device=device) * cfg["text_scale"]
    return {"noise": noise, "label": label, "text": text}


def port_cond(inputs: Dict) -> Dict:
    cond = {}
    if inputs["label"] is not None:
        cond["labels"] = torch.tensor([inputs["label"]])
    if inputs["text"] is not None:
        cond["cond"] = inputs["text"]
    return cond


@dataclasses.dataclass
class Served:
    """One request completed in the window, as the client saw it."""
    client: int
    rseed: int
    submit_s: float
    done_s: float
    sample: torch.Tensor          # the served latent [1, H, W, C], CPU
    accepts: List[bool]
    num_full: int
    num_spec: int
    admit_tick: int


@dataclasses.dataclass
class Window:
    seconds: float = 0.0
    ticks: int = 0
    lane_steps: int = 0           # lanes in flight, summed over ticks
    host_syncs: int = 0
    first_tick: int = 0           # the engine's tick count at the start
    served: List[Served] = dataclasses.field(default_factory=list)


class Server:
    """The engine and its clients for one run."""

    def __init__(self, cfg: Dict, mix: Dict, seed: int, device,
                 params: Dict):
        from repro_torch.serving import Request, SpeCaEngine
        self._Request = Request
        self.cfg, self.device = cfg, device
        self.lanes = int(cfg["lanes"])
        self.steps = int(cfg["num_inference_steps"])
        mc, dc, sc = port_configs(cfg)
        self.engine = SpeCaEngine(
            mc, params, dc, sc, noise_fn=self._noise, lanes=self.lanes,
            device=device)
        self.loop = TR.Clients(mix, self.lanes, self.steps, seed)
        self.pending: Dict[int, tuple] = {}   # ticket -> client, seed, t

    def _noise(self, rseed: int) -> torch.Tensor:
        return request_inputs(self.cfg, rseed, self.device)["noise"]

    def warm(self) -> None:
        """Build and warm the lane step at the cell's width, then start
        the lifecycle session."""
        template = port_cond(request_inputs(self.cfg, 0, self.device))
        self.engine.warmup(template, lanes=self.lanes, mixed=True)
        self.engine.start(lanes=self.lanes)
        self._sync()

    def spread(self) -> None:
        """Send a closed loop's first requests, running the set-up ticks
        that spread the lanes between them."""
        for tick in range(self.loop.setup_ticks + 1):
            for c in self.loop.due(tick):
                self._send(c, time.perf_counter())
            if tick < self.loop.setup_ticks:
                self._collect(self.engine.tick())
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _send(self, client, now: float) -> None:
        rseed = self.loop.next_seed(client)
        req = self._Request(
            request_id=client.index * 1_000_000 + client.sent,
            cond=port_cond(request_inputs(self.cfg, rseed, self.device)),
            seed=rseed)
        ticket = self.engine.submit(req)
        self.pending[ticket.ticket_id] = (client, rseed, now)

    def _collect(self, done, resend: bool = True) -> List[Served]:
        """Record and release the completed requests; with ``resend``
        each client of a closed loop sends its next request."""
        now = time.perf_counter()
        out = []
        for res in done:
            client, rseed, t_sub = self.pending.pop(res.ticket_id)
            out.append(Served(
                client=client.index, rseed=rseed, submit_s=t_sub,
                done_s=now, sample=res.sample, accepts=list(res.accepts),
                num_full=res.num_full, num_spec=res.num_spec,
                admit_tick=res.timings.admit_tick))
            self.engine.release(res.ticket_id)
            if resend and self.loop.closed:
                self._send(client, now)
        return out

    def window(self, seconds: float,
               on_tick: Optional[Callable[[int], None]] = None,
               extend: Callable[[], bool] = lambda: False) -> Window:
        """Tick the engine for ``seconds``. Tracing only: ``on_tick(i)`` is
        called before the window's i-th tick, and the window runs on past
        ``seconds`` while ``extend()`` holds."""
        eng = self.engine
        win = Window(first_tick=eng.current_tick)
        syncs0 = eng.host_syncs
        t0 = time.perf_counter()
        self.loop.start(t0)
        while (now := time.perf_counter()) - t0 < seconds or extend():
            for client, t_arrive in self.loop.arrivals(now):
                self._send(client, t_arrive)
            if not (eng.in_flight() or eng.pending()):
                if self.loop.closed:
                    break           # no client left to send
                # an open loop between arrivals: nothing to tick
                end = t0 + seconds if now - t0 < seconds else math.inf
                time.sleep(max(0.0, min(self.loop.next_arrival(), end)
                               - now))
                continue
            if on_tick is not None:
                on_tick(win.ticks)
            done = eng.tick()
            win.ticks += 1
            win.lane_steps += eng.in_flight() + len(done)
            win.served += self._collect(done)
        self._sync()
        win.seconds = time.perf_counter() - t0
        win.host_syncs = eng.host_syncs - syncs0
        return win

    def drain(self) -> List[Served]:
        """Serve the requests in flight to their end, sending nothing new
        (tracing only: their decisions fill in the window's ticks)."""
        out: List[Served] = []
        while self.engine.in_flight():
            out += self._collect(self.engine.tick(), resend=False)
        return out

    def close(self) -> None:
        self.engine.shutdown()
        self.engine = None


def tick_table(cfg: Dict, served: List[Served], first: int,
               ticks: int) -> np.ndarray:
    """[ticks, 3] per window tick: lanes that drafted, accepted drafts,
    lanes served by the full forward, rebuilt from each request's accept
    trajectory (step i of a request admitted at tick a ran in tick a + i;
    a request drafts when its table holds more than m anchors and fewer
    than max_draft drafts in a row were accepted)."""
    m, K = cfg["taylor_order"], cfg["max_draft"]
    out = np.zeros((ticks, 3), dtype=np.int64)
    for r in served:
        anchors = since = 0
        for i, acc in enumerate(r.accepts):
            t = r.admit_tick + i - first
            want = anchors > m and since < K
            if 0 <= t < ticks:
                out[t, 0] += want
                out[t, 1] += acc
                out[t, 2] += not acc
            if acc:
                since += 1
            else:
                anchors += 1
                since = 0
    return out
