from agents_tpu_torch.environments.torch_environment import (BatchedTorchEnv,
                                                             TorchEnvironment)

__all__ = ["BatchedTorchEnv", "TorchEnvironment"]
