"""serve/net — the network front door over the replica-set serve core
(port of `mpisppy_tpu/serve/net/`; the same frames on the wire).

Three modules, none importing torch at module level (the gateway
process starts no CUDA context; device execution stays behind the
Router):

  * `protocol` — versioned length-prefixed wire frames (JSON header +
    npz payload, CRC32-checked) with the submit/poll/result/solve/
    health/drain/roll verbs and the one-namespace error-code matrix;
  * `gateway`  — threaded stdlib-socket server: bearer-token -> tenant
    auth, forwards into serve/router.py (quotas, brownout, hedging,
    idempotency come free), `drain()` and zero-downtime `roll()`;
  * `client`   — blocking client with connect/request timeouts and
    capped-jitter reconnect on `resilience.restart_delay`.

See doc/src/serve.md, "The network edge".
"""

from . import protocol
from .client import Client, ClientError, NetHandle
from .gateway import Gateway

__all__ = ["protocol", "Client", "ClientError", "NetHandle", "Gateway"]
