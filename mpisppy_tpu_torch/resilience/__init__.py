"""Resilience of the port's wheel (mirror of `mpisppy_tpu/resilience`):

  * `supervisor.SpokeSupervisor` — multiproc-mode process supervision:
    dead children (`Popen.poll`) and hung ones (a stale window
    `write_id`), SIGTERM -> SIGKILL, restarts with capped backoff, and
    the prune of a spoke whose restart budget is spent;
  * `bounds` — payload checksums, `PayloadGuard`, and `BoundGuard` at
    the hub's window reads;
  * `checkpoint` — atomic PH run checkpoints with `resume_from=` on PH
    and WheelSpinner;
  * `chaos` — config- and env-driven fault injectors (crash at a step,
    hang, NaN bound, delayed or dropped writes, hub crash at an
    iteration, and the serve layer's replica crash, slow replica and
    poison request).

Not ported yet: the wheel-ensemble checkpoints (ROADMAP.md queue A
item 13).

The names below load on first use, so that the serve layer's front
door (which needs only `restart_delay`) imports no torch.
"""

import importlib

_LAZY = {
    "BoundGuard": "bounds", "PayloadGuard": "bounds",
    "payload_checksum": "bounds",
    "ChaosError": "chaos", "ChaosInjector": "chaos",
    "atomic_write": "checkpoint", "checkpoint_exists": "checkpoint",
    "load_run_checkpoint": "checkpoint", "restore_hub": "checkpoint",
    "save_run_checkpoint": "checkpoint",
    "SpokeSupervisor": "supervisor", "restart_delay": "supervisor",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(name)
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)


def wheel_counters(opt_or_hub):
    """Resilience counters: works on a bare optimizer (zeros), a Hub or
    a WheelSpinner."""
    hub = getattr(opt_or_hub, "spcomm", opt_or_hub)
    sup = getattr(hub, "supervisor", None)
    failed = len(getattr(hub, "failed_spokes", ()) or ())
    return {
        "spoke_restarts": int(getattr(sup, "spoke_restarts", 0)),
        "spokes_failed": failed,
    }


__all__ = [
    "BoundGuard", "ChaosError", "ChaosInjector", "PayloadGuard",
    "SpokeSupervisor", "atomic_write", "checkpoint_exists",
    "load_run_checkpoint", "payload_checksum", "restart_delay",
    "restore_hub", "save_run_checkpoint", "wheel_counters",
]
