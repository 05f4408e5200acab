from agents_tpu_torch.train.fused_loop import FusedTrainLoop, LoopState
from agents_tpu_torch.train.on_policy_loop import (OnPolicyLoopState,
                                                   OnPolicyTrainLoop)

__all__ = ["FusedTrainLoop", "LoopState", "OnPolicyLoopState",
           "OnPolicyTrainLoop"]
