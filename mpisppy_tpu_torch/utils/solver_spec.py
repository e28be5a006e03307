"""solver_spec: solver-option resolution of the cylinders (port of
`mpisppy_tpu/utils/solver_spec.py`).

The solver is in-process, so the cascade resolves kernel knobs, not
solver names: for an ordered list of roots (e.g. ["lagrangian", ""])
the first root with any `{root}_solver_*` setting wins, and its knobs
are returned as optimizer options (pdhg_eps, pdhg_max_iters, ...); the
root "" is the unprefixed `solver_*` options.  Options may also come as
one string of space-separated key=value pairs
(`{root}_solver_options`, parsed by `option_string_to_dict`).
"""

from __future__ import annotations

KNOBS = ("eps", "max_iters", "check_every", "restart_every",
         "restart_mode", "restart_beta_sufficient",
         "restart_beta_necessary", "compact_threshold",
         "hot_dtype", "sparse_threshold")


def option_string_to_dict(ostr):
    """'eps=1e-6 max_iters=30000' -> {'eps': 1e-6, 'max_iters': 30000}:
    values parse as int, then float, else stay strings; a bare token is
    True."""
    if ostr is None or ostr == "":
        return None
    out = {}
    for tok in str(ostr).split():
        if "=" in tok:
            k, v = tok.split("=", 1)
            for cast in (int, float):
                try:
                    v = cast(v)
                    break
                except ValueError:
                    continue
        else:
            k, v = tok, True
        out[k] = v
    return out


def solver_specification(cfg, prefix="", name_required=False):
    """Resolve kernel options through a prefix cascade.

    Args:
        cfg: a Config or plain dict of options.
        prefix: one root string or an ordered list (first root with
            any `{root}_solver_*` key wins; "" = the unprefixed
            options).
        name_required: raise if no root matched.

    Returns:
        (sroot, options) — the winning root (None if none matched)
        and a dict of optimizer options ({"pdhg_eps": ..., ...}).
    """
    roots = list(prefix) if isinstance(prefix, (list, tuple)) else [prefix]

    def get(k):
        """.get when available, else item lookup; a missing knob is
        None either way."""
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
        hits = {}
        for knob in KNOBS:
            k = keyed(sroot, knob)
            checked.append(k)
            v = get(k)
            if v is not None:
                hits[f"pdhg_{knob}"] = v
        ostr = get(keyed(sroot, "options"))
        if ostr:
            for k, v in (option_string_to_dict(ostr) or {}).items():
                hits[k if k.startswith("pdhg_") else f"pdhg_{k}"] = v
        if hits:
            return sroot, hits
    if name_required:
        raise RuntimeError(
            f"no solver specification found; checked {checked}")
    return None, {}
