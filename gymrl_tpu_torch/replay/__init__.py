from gymrl_tpu_torch.replay.uniform import (
    ReplayState,
    replay_init,
    replay_push_batch,
    replay_sample,
    replay_sample_no_replacement,
)

__all__ = [
    "ReplayState", "replay_init", "replay_push_batch", "replay_sample",
    "replay_sample_no_replacement",
]
