"""PH extensions of the port (mirror of `mpisppy_tpu/extensions`),
`cross_scen_extension` included (the hub wires it to the
cross-scenario cut spoke)."""

from .extension import Extension, MultiExtension  # noqa: F401
