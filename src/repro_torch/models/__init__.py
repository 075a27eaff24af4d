"""Models of the port: the recsys family (``recsys``: DLRM-RM2, xDeepFM,
SASRec and BERT4Rec with the index scan over their item tables), the LM
transformer family (``common``, ``moe``, ``transformer``: the dense GQA
forward behind the query encoder, MLA, MoE with MTP, and the decode
path) and the equivariant GNN (``egnn``)."""

from repro_torch.models.egnn import EGNNConfig
from repro_torch.models.moe import MoEConfig, moe_ffn
from repro_torch.models.recsys import (DLRM, SeqRec, SeqRecConfig, XDeepFM,
                                       candidate_index)
from repro_torch.models.transformer import (MLAConfig, Transformer,
                                            TransformerConfig,
                                            active_param_count, decode_step,
                                            forward, hidden_states,
                                            init_kv_caches, init_params,
                                            mtp_logits, param_count)

__all__ = ["DLRM", "EGNNConfig", "MLAConfig", "MoEConfig", "SeqRec",
           "SeqRecConfig", "Transformer", "TransformerConfig", "XDeepFM",
           "active_param_count", "candidate_index", "decode_step", "forward",
           "hidden_states", "init_kv_caches", "init_params", "moe_ffn",
           "mtp_logits", "param_count"]
