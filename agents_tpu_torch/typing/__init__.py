from agents_tpu_torch.typing import types

__all__ = ["types"]
