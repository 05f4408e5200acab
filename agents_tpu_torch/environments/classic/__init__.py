from agents_tpu_torch.environments.classic.cartpole import CartPole
from agents_tpu_torch.environments.classic.catch import Catch
from agents_tpu_torch.environments.classic.pendulum import Pendulum
from agents_tpu_torch.environments.classic.synthetic_pixels import (
    SyntheticPixels)

__all__ = ["CartPole", "Catch", "Pendulum", "SyntheticPixels"]
