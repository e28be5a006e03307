"""aircondB — the pickle-bundle variant of aircond (counterpart of
`mpisppy_tpu/models/aircondB.py`).

Not ported yet: its batch is aircond's tree cut into proper bundles
(`utils/bundles.bundle_batch`) and round-tripped through bundle files
(`utils/pickle_bundle`), both ROADMAP.md queue A item 10.  The module
keeps the amalgamator contract so that a run through it reaches
`build_batch`, which refuses.
"""

from __future__ import annotations

from .. import not_ported
from . import aircond

MULTISTAGE = False   # bundled: two-stage by construction


def build_batch(*args, **kwargs):
    raise not_ported("models.aircondB (proper bundles: utils/bundles and "
                     "utils/pickle_bundle)", 10)


def scenario_names_creator(num_scens, start=0, bundles_per_rank=None,
                           scenarios_per_bundle=None):
    """Bundle names over the original scenario numbers (the reference's
    Bundle_first_last, aircondB.py:146)."""
    m = int(scenarios_per_bundle or 1)
    return [f"Bundle_{i}_{i + m - 1}"
            for i in range(start, start + num_scens, m)]


inparser_adder = aircond.inparser_adder
kw_creator = aircond.kw_creator
