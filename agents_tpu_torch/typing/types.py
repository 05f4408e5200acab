"""Common type aliases.

Port of ``agents_tpu/typing/types.py``. Nests are this package's own
(`agents_tpu_torch.utils.nest_utils`): frozen dataclasses, NamedTuples,
tuples, lists and dicts over tensor leaves.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence, Union

import numpy as np
import torch

Array = Union[torch.Tensor, np.ndarray]
Scalar = Union[int, float, bool]
Int = Union[int, np.integer, torch.Tensor]
Float = Union[float, np.floating, torch.Tensor]
Bool = Union[bool, np.bool_, torch.Tensor]

Shape = Sequence[int]
DType = Any
Device = Union[str, torch.device]

Nested = Any
NestedTensor = Any
NestedSpec = Any

LossFn = Callable[..., Any]
