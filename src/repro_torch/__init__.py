"""PyTorch/CUDA port of the conversational-search metric cache.

The JAX package ``repro`` is the reference; this package mirrors its module
layout (``core``, ``kernels``, ``dist``, ``serve``, ``data``, ``models``,
``configs``, ``train``, ``checkpoint``) with PyTorch
idiom and hand-written CUDA kernels for an NVIDIA H100 (``csrc/``).  It
imports neither ``jax`` nor any ``repro`` module.

Entry points take ``device=None``, which means ``cuda``: without a card
they raise unless the caller passes ``device="cpu"``.  Kernel wrappers
dispatch on the tensor's device alone — a CUDA tensor launches the hand
written kernel (or raises), a CPU tensor takes the plain PyTorch version
beside it.
"""

from repro_torch.core.cache import MetricCache
from repro_torch.core.conversation import ConversationalSearcher, TurnRecord
from repro_torch.core.metric_index import MetricIndex
from repro_torch.models.egnn import EGNNConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.recsys import SeqRec, SeqRecConfig, candidate_index
from repro_torch.models.transformer import (MLAConfig, Transformer,
                                            TransformerConfig, decode_step,
                                            init_kv_caches)
from repro_torch.serve.engine import (ConversationalEngine,
                                      make_lm_query_encoder)

__all__ = ["MetricCache", "ConversationalSearcher", "TurnRecord",
           "MetricIndex", "ConversationalEngine", "Transformer",
           "TransformerConfig", "MLAConfig", "MoEConfig", "init_kv_caches",
           "decode_step", "make_lm_query_encoder", "SeqRec", "SeqRecConfig",
           "candidate_index", "EGNNConfig"]
