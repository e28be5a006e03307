"""PH convergers of the port (mirror of `mpisppy_tpu/convergers`)."""

from .converger import Converger  # noqa: F401
