"""Training of the port: the JAX-ordered tree walk (``tree``), AdamW and
Adafactor (``optimizer``), the losses and the accumulating train step
(``step``), and the STAR encoder's training script (``encoder``,
``python -m repro_torch.train.encoder``)."""

from repro_torch.train.optimizer import (OPTIMIZERS, Optimizer, OptState,
                                         adafactor, adamw, global_norm)
from repro_torch.train.step import (make_lm_train_step, make_train_step,
                                    value_and_grad)

__all__ = ["OPTIMIZERS", "Optimizer", "OptState", "adafactor", "adamw",
           "global_norm", "make_lm_train_step", "make_train_step",
           "value_and_grad"]
