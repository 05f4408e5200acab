from agents_tpu_torch.replay_buffers.uniform_replay import (BufferInfo,
                                                            ReplayState,
                                                            UniformReplay)

__all__ = ["BufferInfo", "ReplayState", "UniformReplay"]
