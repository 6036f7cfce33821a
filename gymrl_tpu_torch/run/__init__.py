from gymrl_tpu_torch.run.loop import TrainLoop, run_benchmark

__all__ = ["TrainLoop", "run_benchmark"]
