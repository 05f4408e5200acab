from agents_tpu_torch.train.fused_loop import FusedTrainLoop, LoopState

__all__ = ["FusedTrainLoop", "LoopState"]
