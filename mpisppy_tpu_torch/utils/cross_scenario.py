"""Cross-scenario cut capacity (mirror of
`mpisppy_tpu/utils/cross_scenario.py`): not ported yet.  It comes with
the cross-scenario cut spoke, ROADMAP.md queue A item 11."""

from __future__ import annotations

from .. import not_ported


def add_cross_scenario_capacity(*args, **kwargs):
    raise not_ported("utils.cross_scenario (cross-scenario cut capacity)",
                     11)


def cross_meta(*args, **kwargs):
    raise not_ported("utils.cross_scenario (cross-scenario cut capacity)",
                     11)
