"""Core of the port: the metric cache (L1 session tier and its ops), the
shared L2 tier, the exact metric index and its topical clustering, the
Eq. 1 embedding transform and quantized corpus storage -- the
counterparts of ``repro.core``'s exports.
"""

from repro_torch.core.cache import (BatchedMetricCache, CacheConfig,
                                    CacheState, MetricCache, init_cache)
from repro_torch.core.cluster import (ClusterIndex, assign_clusters,
                                      build_cluster_index)
from repro_torch.core.conversation import ConversationalSearcher, TurnRecord
from repro_torch.core.embedding import (distance_from_scores,
                                        pairwise_distances, pairwise_scores,
                                        transform_documents,
                                        transform_queries)
from repro_torch.core.metric_index import (MetricIndex, SearchResult,
                                           chunked_nn, exact_nn)
from repro_torch.core.quant import (DTYPES, QuantizedCorpus, dequantize,
                                    quantize)
from repro_torch.core.shared import SharedTier

__all__ = [
    "BatchedMetricCache", "CacheConfig", "CacheState", "MetricCache",
    "init_cache", "ClusterIndex", "assign_clusters", "build_cluster_index",
    "ConversationalSearcher", "TurnRecord",
    "distance_from_scores", "pairwise_distances", "pairwise_scores",
    "transform_documents", "transform_queries",
    "MetricIndex", "SearchResult", "chunked_nn", "exact_nn",
    "DTYPES", "QuantizedCorpus", "dequantize", "quantize", "SharedTier",
]
