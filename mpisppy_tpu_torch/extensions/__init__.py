"""PH extensions of the port (mirror of `mpisppy_tpu/extensions`).

Not ported yet: `cross_scen_extension` (it needs the cross-scenario
cut spoke, ROADMAP.md queue A item 11); constructing it raises."""

from .extension import Extension, MultiExtension  # noqa: F401
