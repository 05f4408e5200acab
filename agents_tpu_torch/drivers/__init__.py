from agents_tpu_torch.drivers.torch_driver import (DriverState, TorchDriver,
                                                   TorchEpisodeDriver)

__all__ = ["DriverState", "TorchDriver", "TorchEpisodeDriver"]
