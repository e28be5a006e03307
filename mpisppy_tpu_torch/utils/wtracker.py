"""WTracker — W-history statistics that flag dual-weight oscillation
(port of `mpisppy_tpu/utils/wtracker.py`).

Keeps a ring buffer of host copies of the last `wlen` iterations' W
(S, K) and reports per-slot moving mean and stdev; slots whose stdev
stays large relative to their mean indicate PH cycling.
"""

from __future__ import annotations

import collections

import numpy as np

from ..device import host


class WTracker:
    def __init__(self, ph, wlen=10):
        self.opt = ph
        self.wlen = int(wlen)
        # (iter, (S, K) array) entries; deque(maxlen) evicts the oldest
        self._hist = collections.deque(maxlen=self.wlen)

    def grab_local_Ws(self):
        """Record this iteration's W (one device-to-host copy)."""
        st = self.opt.state
        if st is None:
            return
        self._hist.append((int(st.it), host(st.W).copy()))

    def moving_stats(self):
        """(mean, std) arrays (S, K) over the window; None if empty."""
        if not self._hist:
            return None, None
        stack = np.stack([w for _, w in self._hist])
        return stack.mean(axis=0), stack.std(axis=0)

    def report_by_moving_stats(self, stdevthresh=None, file=None):
        """Flag slots with stdev above `stdevthresh` (default: the
        median |mean|).  Returns the count of flagged slots."""
        mean, std = self.moving_stats()
        if mean is None:
            return 0
        if stdevthresh is None:
            stdevthresh = float(np.median(np.abs(mean)) + 1e-12)
        flagged = std > stdevthresh
        n = int(flagged.sum())
        lines = [f"WTracker: window={len(self._hist)} iters, "
                 f"{n} W slots with stdev > {stdevthresh:g}"]
        if n:
            s_idx, k_idx = np.nonzero(flagged)
            names = self.opt.batch.tree.nonant_names
            for s, k in list(zip(s_idx, k_idx))[:10]:
                nm = names[k] if k < len(names) else str(k)
                lines.append(f"  scen {s} {nm}: mean {mean[s, k]:.4g} "
                             f"stdev {std[s, k]:.4g}")
        out = "\n".join(lines)
        if file is not None:
            print(out, file=file)
        else:
            print(out)
        return n
