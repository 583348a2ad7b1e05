"""The measured window: steps dispatched ahead of the card by a bounded
number (none, in a closed loop), the host's clock read at the start and
after the card has finished the last step, and the device synchronised
nowhere in between but to keep that bound."""

from __future__ import annotations

import collections
import time


class Pacer:
    """Keep at most ``ahead`` steps in flight on the current stream: after
    each step ``mark()`` records an event and waits for the one recorded
    ``ahead`` steps earlier (``ahead`` 0: for the step's own). On the CPU
    every step is done when it returns."""

    def __init__(self, device, ahead: int):
        self.cuda = str(device).startswith("cuda")
        self.ahead = ahead
        self.events = collections.deque()

    def mark(self) -> None:
        if not self.cuda:
            return
        import torch
        ev = torch.cuda.Event()
        ev.record()
        self.events.append(ev)
        while len(self.events) > self.ahead:
            self.events.popleft().synchronize()

    def drain(self) -> None:
        if self.cuda:
            import torch
            torch.cuda.synchronize()
        self.events.clear()


def sync(device) -> None:
    if str(device).startswith("cuda"):
        import torch
        torch.cuda.synchronize()


def run_window(step, seconds: float, pacer: Pacer, tracer,
               begin=None) -> dict:
    """Call ``step(i, over)`` for i = 0, 1, ... until a step returns true,
    ``over`` saying whether ``seconds`` have passed on the host's clock,
    then wait for the card: {"steps", "seconds", "start_at"}, every step
    dispatched counted and the time until the last one finished. An open
    loop's step returns ``over``; a closed loop's reads on the host what
    decides, such as the ranks' all-reduced flag, and keeps ``ahead`` 0.
    ``begin`` runs under the tracer just before the clock starts (the
    ranks' barrier)."""
    n = 0
    with tracer:                    # a profiler starts before the clock
        if begin is not None:
            begin()
        t0 = time.perf_counter()
        while True:
            stop = step(n, time.perf_counter() - t0 >= seconds)
            n += 1
            pacer.mark()
            tracer.step()
            if stop:
                break
        pacer.drain()
    return {"steps": n, "seconds": time.perf_counter() - t0, "start_at": t0}
