"""streaming — minibatch randomized PH for million-scenario problems
(port of `mpisppy_tpu/streaming/`).

The scenario universe never materializes, on the card or on the host:
a `ScenarioSource` builds scenario blocks on the host from their index
sets, a `ScenarioStream` double-buffers the block build and its copy to
the card behind the solves, an `AdaptiveSampler` grows the active
sample along a BM/BPL sequential-sampling schedule, and `StreamingPH`
runs randomized PH supersteps over sampled blocks with the full-S dual
weights on the host, stopping when the gap estimate certifies a
confidence interval.

At storage scale, `write_corpus` persists a source's universe as
checksummed fixed-width shard files and `ShardSource` streams sampled
blocks back off disk through a bounded readahead, with per-shard
retry and quarantine and certified-gap accounting for lost mass.

`StreamingPH` is loaded on first attribute access, as in the JAX
package.
"""

from .readahead import ReadaheadCache, ShardSource
from .sampler import AdaptiveSampler
from .source import (BatchSource, GeneratorSource, RetryingSource,
                     ScenarioSource, SourceBuildError, gather_block,
                     source_for_module)
from .store import (QuarantinedCorpusError, ShardIntegrityError,
                    ShardQuarantinedError, ShardStore, ShardStoreError,
                    write_corpus)
from .stream import BlockTransfer, ScenarioStream, StreamClosed

__all__ = [
    "AdaptiveSampler",
    "BatchSource",
    "BlockTransfer",
    "GeneratorSource",
    "QuarantinedCorpusError",
    "ReadaheadCache",
    "RetryingSource",
    "ScenarioSource",
    "ScenarioStream",
    "ShardIntegrityError",
    "ShardQuarantinedError",
    "ShardSource",
    "ShardStore",
    "ShardStoreError",
    "SourceBuildError",
    "StreamClosed",
    "StreamingPH",
    "gather_block",
    "source_for_module",
    "write_corpus",
]


def __getattr__(name):
    if name == "StreamingPH":
        from .streaming_ph import StreamingPH
        return StreamingPH
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
