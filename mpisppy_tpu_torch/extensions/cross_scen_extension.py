"""CrossScenarioExtension (mirror of
`mpisppy_tpu/extensions/cross_scen_extension.py`): not ported yet.
It installs the cuts of the cross-scenario cut spoke, which comes with
ROADMAP.md queue A item 11, as does the hub's wiring of an extension
to its spoke's window."""

from __future__ import annotations

from .. import not_ported
from .extension import Extension


class CrossScenarioExtension(Extension):
    def __init__(self, ph):
        raise not_ported("CrossScenarioExtension (cross-scenario cuts)", 11)
