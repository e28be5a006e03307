"""AdaptiveSampler — the active sample and its growth schedule (port
of `mpisppy_tpu/streaming/sampler.py`).

The active sample is the index prefix [0, active_n) of the universe:
scenario i's data comes from seed i, so a prefix is an i.i.d. sample,
and growing it keeps every scenario already streamed.  It grows along
the BM/BPL schedules of `confidence_intervals.seqsampling.SamplingRule`
as gap estimates are fed in.  Blocks are uniform draws without
replacement from the prefix, from a numpy PCG64 generator whose full
state round-trips through checkpoints as JSON: the draws equal the JAX
package's index for index, and a resumed run replays them.
"""

from __future__ import annotations

import json

import numpy as np

from .. import telemetry as _telemetry


class AdaptiveSampler:
    """Block draws from a growing active prefix of the universe."""

    def __init__(self, rule, total_scens, block_size, seed=0,
                 telemetry=None):
        self.rule = rule
        self.total_scens = int(total_scens)
        self.block_size = int(block_size)
        self._tel = (telemetry if telemetry is not None
                     else _telemetry.get())
        self._rng = np.random.Generator(np.random.PCG64(int(seed)))
        # first-round size from the rule's own schedule, clamped so that
        # at least one full block is active when the universe allows
        n1 = int(rule.sample_size(1, None, None, None))
        self.active_n = min(self.total_scens,
                            max(n1, min(self.block_size,
                                        self.total_scens)))
        self.est_rounds = 0        # completed gap-estimate rounds
        self.growth_events = 0
        self._gauge()

    def _gauge(self):
        if self._tel.enabled:
            self._tel.registry.gauge(
                "stream.active_sample_size").set(self.active_n)

    def draw_block(self):
        """Uniform draw without replacement from the active prefix,
        sorted ascending."""
        b = min(self.block_size, self.active_n)
        idx = self._rng.choice(self.active_n, size=b, replace=False)
        idx.sort()
        return idx.astype(np.int64)

    def observe(self, G, s):
        """Feed one gap estimate (G, s) of the current active sample.
        True when the rule says stop (certified); otherwise the prefix
        grows along the rule's schedule (monotone, capped at the
        universe) and the answer is False."""
        self.est_rounds += 1
        nk = self.active_n
        if not self.rule.should_continue(G, s, nk):
            return True
        new_n = int(self.rule.sample_size(self.est_rounds + 1, G, s, nk))
        new_n = min(max(new_n, nk), self.total_scens)
        if new_n > nk:
            self.active_n = new_n
            self.growth_events += 1
            self._gauge()
            if self._tel.enabled:
                self._tel.registry.counter(
                    "stream.sample_growth_events").inc()
                self._tel.event("stream.sample_growth", from_n=nk,
                                to_n=new_n, G=float(G), s=float(s))
        return False

    def state(self):
        """JSON-serializable state: active size, estimate rounds and the
        full PCG64 state."""
        return {
            "active_n": int(self.active_n),
            "est_rounds": int(self.est_rounds),
            "rng_state": json.dumps(self._rng.bit_generator.state),
        }

    def restore(self, state):
        self.active_n = int(state["active_n"])
        self.est_rounds = int(state["est_rounds"])
        self._rng.bit_generator.state = json.loads(state["rng_state"])
        self._gauge()
