"""The chunk kernel's occupancy on an NVIDIA H100 80GB HBM3 (700 W), as
the card reported it (`tests/h100_cluster_occupancy.json`, written by
`python tests/cluster_kernel_witness.py --occupancy FILE`): blocks per
SM and clusters held at once of every cluster variant that
`ops.pdhg_chunk.pick_variant` can weigh at the shapes the CPU tests
give it.  `pick` is pick_variant on that card, as `card_variant` runs
it there."""

import json
import os

from mpisppy_tpu_torch.ops import pdhg_chunk

_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "h100_cluster_occupancy.json")
with open(_PATH) as _fh:
    CARD = json.load(_fh)
#: the card's SM count and per-block shared-memory opt-in limit
SMS = CARD["sms"]
SMEM_OPTIN = CARD["smem_optin"]
#: (M, N, dtype name, source, cluster, stage rows) -> (blocks per SM,
#: clusters held at once)
TABLE = {tuple(r[:6]): (r[6], r[7]) for r in CARD["rows"]}


def occupancy_of(v, M, N, dtype):
    """The card's (blocks per SM, clusters held) of variant `v` at (M, N)
    in `dtype`; KeyError for a variant the table does not hold."""
    return TABLE[(M, N, str(dtype).replace("torch.", ""), v.source,
                  v.cluster, v.stage_rows)]


def pick(S, M, N, dtype):
    """pick_variant as the card runs it."""
    return pdhg_chunk.pick_variant(S, M, N, dtype, SMEM_OPTIN, SMS,
                                   occupancy_of)
