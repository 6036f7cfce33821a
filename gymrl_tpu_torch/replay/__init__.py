from gymrl_tpu_torch.replay.per import (
    PERState,
    per_init,
    per_push_batch,
    per_sample,
    per_update_priorities,
)
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
    "PERState", "per_init", "per_push_batch", "per_sample", "per_update_priorities",
]
