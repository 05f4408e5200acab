from agents_tpu_torch.replay_buffers.prioritized_replay import (
    PrioritizedBufferInfo, PrioritizedReplay, PrioritizedReplayState)
from agents_tpu_torch.replay_buffers.rate_limiter import (MinSize,
                                                          RateLimiter,
                                                          SampleToInsertRatio)
from agents_tpu_torch.replay_buffers.uniform_replay import (BufferInfo,
                                                            ReplayState,
                                                            UniformReplay)

__all__ = [
    "BufferInfo",
    "MinSize",
    "PrioritizedBufferInfo",
    "PrioritizedReplay",
    "PrioritizedReplayState",
    "RateLimiter",
    "ReplayState",
    "SampleToInsertRatio",
    "UniformReplay",
]
