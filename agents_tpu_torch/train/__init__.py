from agents_tpu_torch.train.actor import Actor, collect_metrics, eval_metrics
from agents_tpu_torch.train.async_host_device_loop import (
    AsyncHostDeviceTrainLoop)
from agents_tpu_torch.train.checkpointer import Checkpointer
from agents_tpu_torch.train.fused_loop import FusedTrainLoop, LoopState
from agents_tpu_torch.train.host_device_loop import (DeviceState,
                                                     HostDeviceTrainLoop)
from agents_tpu_torch.train.host_on_policy_loop import HostOnPolicyTrainLoop
from agents_tpu_torch.train.learner import JsonlSummaryWriter, Learner
from agents_tpu_torch.train.on_policy_loop import (OnPolicyLoopState,
                                                   OnPolicyTrainLoop)
from agents_tpu_torch.train.triggers import (IntervalTrigger,
                                             PolicyCheckpointTrigger,
                                             StepPerSecondLogTrigger,
                                             StepPerSecondTracker)
from agents_tpu_torch.utils.tb_writer import (MultiWriter,
                                              TensorBoardEventWriter)

__all__ = ["Actor", "AsyncHostDeviceTrainLoop", "Checkpointer",
           "DeviceState", "FusedTrainLoop", "HostDeviceTrainLoop",
           "HostOnPolicyTrainLoop", "IntervalTrigger", "JsonlSummaryWriter",
           "Learner", "LoopState", "MultiWriter", "OnPolicyLoopState",
           "OnPolicyTrainLoop", "PolicyCheckpointTrigger",
           "StepPerSecondLogTrigger", "StepPerSecondTracker",
           "TensorBoardEventWriter", "collect_metrics", "eval_metrics"]
