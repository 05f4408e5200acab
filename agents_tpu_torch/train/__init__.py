from agents_tpu_torch.train.async_host_device_loop import (
    AsyncHostDeviceTrainLoop)
from agents_tpu_torch.train.checkpointer import Checkpointer
from agents_tpu_torch.train.fused_loop import FusedTrainLoop, LoopState
from agents_tpu_torch.train.host_device_loop import (DeviceState,
                                                     HostDeviceTrainLoop)
from agents_tpu_torch.train.host_on_policy_loop import HostOnPolicyTrainLoop
from agents_tpu_torch.train.on_policy_loop import (OnPolicyLoopState,
                                                   OnPolicyTrainLoop)

__all__ = ["AsyncHostDeviceTrainLoop", "Checkpointer", "DeviceState",
           "FusedTrainLoop", "HostDeviceTrainLoop", "HostOnPolicyTrainLoop",
           "LoopState", "OnPolicyLoopState", "OnPolicyTrainLoop"]
