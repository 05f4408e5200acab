from agents_tpu_torch.train.checkpointer import Checkpointer
from agents_tpu_torch.train.fused_loop import FusedTrainLoop, LoopState
from agents_tpu_torch.train.on_policy_loop import (OnPolicyLoopState,
                                                   OnPolicyTrainLoop)

__all__ = ["Checkpointer", "FusedTrainLoop", "LoopState", "OnPolicyLoopState",
           "OnPolicyTrainLoop"]
