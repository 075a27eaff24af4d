"""Models of the port: the recsys serving path (``recsys``) and the LM
transformer family (``common``, ``moe``, ``transformer``: the dense GQA
forward behind the query encoder, MLA, MoE with MTP, and the decode
path)."""

from repro_torch.models.moe import MoEConfig, moe_ffn
from repro_torch.models.transformer import (MLAConfig, Transformer,
                                            TransformerConfig,
                                            active_param_count, decode_step,
                                            forward, hidden_states,
                                            init_kv_caches, init_params,
                                            mtp_logits, param_count)

__all__ = ["MLAConfig", "MoEConfig", "Transformer", "TransformerConfig",
           "active_param_count", "decode_step", "forward", "hidden_states",
           "init_kv_caches", "init_params", "moe_ffn", "mtp_logits",
           "param_count"]
