from agents_tpu_torch.environments.classic.acrobot import Acrobot
from agents_tpu_torch.environments.classic.cartpole import CartPole
from agents_tpu_torch.environments.classic.catch import Catch
from agents_tpu_torch.environments.classic.mountain_car import (
    ContinuousMountainCar, MountainCar)
from agents_tpu_torch.environments.classic.pendulum import Pendulum
from agents_tpu_torch.environments.classic.synthetic_grasp import (
    SyntheticGrasp)
from agents_tpu_torch.environments.classic.synthetic_pixels import (
    SyntheticPixels)

__all__ = ["Acrobot", "CartPole", "Catch", "ContinuousMountainCar",
           "MountainCar", "Pendulum", "SyntheticGrasp", "SyntheticPixels"]
