from agents_tpu_torch.environments.classic.cartpole import CartPole

__all__ = ["CartPole"]
