"""Training: teacher-forced fine-tuning of the talker + code predictor
(the JAX package's training/), on one device or over a (pp, dp, tp)
mesh of ranks (``parallel/``).

Losses that mirror the inference decomposition (codebook-0 CE for the
talker, depth-transformer CE for the residual predictor), a train step with
AdamW and optax's global-norm clip, LoRA adapters, and checkpoint/resume.
Parameters are the port's dict trees of tensors; training runs dense, on
the CUDA device unless the trees lie on the CPU.
"""

from .loss import talker_loss, code_predictor_loss, joint_loss  # noqa: F401
from .train import (  # noqa: F401
    TrainState,
    default_optimizer,
    init_train_state,
    make_train_step,
)
from .lora import (  # noqa: F401
    LoraTrainState,
    add_lora,
    init_lora_train_state,
    make_lora_train_step,
    merge_lora,
    merge_trees,
    split_lora,
    split_subtree,
)
