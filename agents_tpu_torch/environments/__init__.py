from agents_tpu_torch.environments.torch_environment import (BatchedTorchEnv,
                                                             TorchEnvironment)
from agents_tpu_torch.environments.torch_wrappers import (
    OneHotActionTorchWrapper, TorchEnvironmentWrapper)

__all__ = ["BatchedTorchEnv", "OneHotActionTorchWrapper", "TorchEnvironment",
           "TorchEnvironmentWrapper"]
