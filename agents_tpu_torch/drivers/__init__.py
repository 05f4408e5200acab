from agents_tpu_torch.drivers.py_driver import PyDriver
from agents_tpu_torch.drivers.torch_driver import (DriverState, TorchDriver,
                                                   TorchEpisodeDriver)

__all__ = ["DriverState", "PyDriver", "TorchDriver", "TorchEpisodeDriver"]
