"""Extension hook API (port of `mpisppy_tpu/extensions/extension.py`).

An Extension is constructed with the optimizer (`ph`) and called at
the hook points pre_iter0 / post_iter0 / post_iter0_after_sync /
miditer / enditer / enditer_after_sync / post_everything /
pre_solve_loop / post_solve_loop.  `MultiExtension` fans a hook out to
an ordered list of extensions.

The solve loop is one batched superstep, so the per-scenario
pre_solve / post_solve hooks collapse into the loop-level pair.
"""

from __future__ import annotations


class Extension:
    """Base class: every hook is a no-op."""

    def __init__(self, ph):
        self.opt = ph
        # alias matching the reference attribute name
        self.ph = ph

    def pre_iter0(self):
        pass

    def post_iter0(self):
        pass

    def post_iter0_after_sync(self):
        pass

    def miditer(self):
        pass

    def enditer(self):
        pass

    def enditer_after_sync(self):
        pass

    def post_everything(self):
        pass

    def pre_solve_loop(self):
        pass

    def post_solve_loop(self):
        pass


class MultiExtension(Extension):
    """Several extensions; hooks fire in list order.  Construct with the
    class list in `ext_classes`."""

    def __init__(self, ph, ext_classes=()):
        super().__init__(ph)
        self.extdict = {}
        self.extensions = []
        for cls in ext_classes:
            ext = cls(ph)
            self.extdict[cls.__name__] = ext
            self.extensions.append(ext)

    def add_extension(self, ext):
        self.extdict[type(ext).__name__] = ext
        self.extensions.append(ext)

    def _fan(self, hook):
        for ext in self.extensions:
            getattr(ext, hook)()

    def pre_iter0(self):
        self._fan("pre_iter0")

    def post_iter0(self):
        self._fan("post_iter0")

    def post_iter0_after_sync(self):
        self._fan("post_iter0_after_sync")

    def miditer(self):
        self._fan("miditer")

    def enditer(self):
        self._fan("enditer")

    def enditer_after_sync(self):
        self._fan("enditer_after_sync")

    def post_everything(self):
        self._fan("post_everything")

    def pre_solve_loop(self):
        self._fan("pre_solve_loop")

    def post_solve_loop(self):
        self._fan("post_solve_loop")
