"""The MIP extensive form (counterpart of `mpisppy_tpu/opt/mip.py`).

Not ported yet (ROADMAP.md queue A item 10): `ExtensiveFormMIP`, the
LP-relaxation dive with its branch-and-bound certificate, refuses where
it is reached, e.g. by usar's integer model.  The LP relaxation of
every integer family (usar, sizes, netdes, sslp) runs through
`opt/ef.ExtensiveForm` and PH.
"""

from __future__ import annotations

from .. import not_ported


class ExtensiveFormMIP:
    def __init__(self, *args, **kwargs):
        raise not_ported("opt.mip.ExtensiveFormMIP (the MIP extensive "
                         "form, e.g. usar's integer model)", 10)
