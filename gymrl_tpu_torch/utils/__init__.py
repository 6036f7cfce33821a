from gymrl_tpu_torch.utils.checkpoint import checkpoint_path, restore_checkpoint, save_checkpoint
from gymrl_tpu_torch.utils.device import resolve_device
from gymrl_tpu_torch.utils.logging import MetricsWriter, get_logger, log_monitors

__all__ = [
    "get_logger",
    "MetricsWriter",
    "log_monitors",
    "save_checkpoint",
    "restore_checkpoint",
    "checkpoint_path",
    "resolve_device",
]
