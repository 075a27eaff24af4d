"""Models of the port: the recsys serving path (``recsys``) and the dense
LM transformer behind the query encoder (``common``, ``transformer``)."""

from repro_torch.models.transformer import (MLAConfig, Transformer,
                                            TransformerConfig, forward,
                                            hidden_states, init_params,
                                            param_count)

__all__ = ["MLAConfig", "Transformer", "TransformerConfig", "forward",
           "hidden_states", "init_params", "param_count"]
