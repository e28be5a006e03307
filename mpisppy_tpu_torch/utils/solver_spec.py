"""solver_spec — solver-option resolution of the cylinders (port of
`mpisppy_tpu/utils/solver_spec.py`).

For an ordered list of roots the JAX package returns the kernel knobs
(`{root}_solver_eps`, ... as pdhg_* options) of the first root that
sets any.  The port resolves the unprefixed root ("": `solver_eps`,
`solver_max_iters`, ...); a per-cylinder `{root}_solver_*` setting,
and the `solver_options` string, are not ported yet (ROADMAP.md queue
A item 5) and raise.
"""

from __future__ import annotations

from .. import not_ported

KNOBS = ("eps", "max_iters", "check_every", "restart_every",
         "restart_mode", "restart_beta_sufficient",
         "restart_beta_necessary", "compact_threshold",
         "hot_dtype", "sparse_threshold")


def solver_specification(cfg, prefix="", name_required=False):
    """(root, options): the root that set knobs (None if none did) and
    its knobs as pdhg_* optimizer options."""
    roots = list(prefix) if isinstance(prefix, (list, tuple)) else [prefix]

    def get(k):
        getter = getattr(cfg, "get", None)
        try:
            return getter(k) if getter is not None else cfg[k]
        except KeyError:
            return None

    def keyed(root, knob):
        return (f"solver_{knob}" if root == ""
                else f"{root}_solver_{knob}")

    checked = []
    for sroot in roots:
        set_here = [keyed(sroot, k) for k in KNOBS + ("options",)
                    if get(keyed(sroot, k)) not in (None, "")]
        if sroot != "" and set_here:
            raise not_ported(f"per-cylinder solver options ({set_here})",
                             5)
        if get(keyed(sroot, "options")):
            raise not_ported("the solver_options string", 5)
        hits = {}
        for knob in KNOBS:
            k = keyed(sroot, knob)
            checked.append(k)
            v = get(k)
            if v is not None:
                hits[f"pdhg_{knob}"] = v
        if hits:
            return sroot, hits
    if name_required:
        raise RuntimeError(
            f"no solver specification found; checked {checked}")
    return None, {}
