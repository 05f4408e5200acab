from agents_tpu_torch.trajectories import policy_step, time_step, trajectory
from agents_tpu_torch.trajectories.policy_step import PolicyInfo, PolicyStep
from agents_tpu_torch.trajectories.time_step import StepType, TimeStep
from agents_tpu_torch.trajectories.trajectory import Trajectory, Transition

__all__ = [
    "PolicyInfo", "PolicyStep", "StepType", "TimeStep", "Trajectory", "Transition",
    "policy_step", "time_step", "trajectory",
]
