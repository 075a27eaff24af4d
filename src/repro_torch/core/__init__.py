"""Core of the port: the metric cache (L1 session tier and its ops), the
exact metric index, the Eq. 1 embedding transform and quantized corpus
storage.

The counterparts of ``repro.core``'s exports that the port has.  Not yet
ported, so not exported: ``ClusterIndex`` and ``build_cluster_index``
(the offline clustering behind cluster prefetch) and ``SharedTier`` (the
L2 tier) -- ROADMAP queue 1, items 9-10.
"""

from repro_torch.core.cache import (BatchedMetricCache, CacheConfig,
                                    CacheState, MetricCache, init_cache)
from repro_torch.core.conversation import ConversationalSearcher, TurnRecord
from repro_torch.core.embedding import (distance_from_scores,
                                        pairwise_distances, pairwise_scores,
                                        transform_documents,
                                        transform_queries)
from repro_torch.core.metric_index import (MetricIndex, SearchResult,
                                           chunked_nn, exact_nn)
from repro_torch.core.quant import (DTYPES, QuantizedCorpus, dequantize,
                                    quantize)

__all__ = [
    "BatchedMetricCache", "CacheConfig", "CacheState", "MetricCache",
    "init_cache", "ConversationalSearcher", "TurnRecord",
    "distance_from_scores", "pairwise_distances", "pairwise_scores",
    "transform_documents", "transform_queries",
    "MetricIndex", "SearchResult", "chunked_nn", "exact_nn",
    "DTYPES", "QuantizedCorpus", "dequantize", "quantize",
]
