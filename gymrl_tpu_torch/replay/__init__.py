from gymrl_tpu_torch.replay.episode import (
    EpisodeBufferState,
    QueueState,
    StateRing,
    episode_buffer_clear,
    episode_buffer_init,
    episode_buffer_pack,
    episode_buffer_store,
    queue_init,
    queue_push,
    queue_sample,
    state_ring_init,
    state_ring_push,
    state_ring_sample,
)
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
    "EpisodeBufferState", "episode_buffer_init", "episode_buffer_store", "episode_buffer_pack",
    "episode_buffer_clear", "QueueState", "queue_init", "queue_push", "queue_sample",
    "StateRing", "state_ring_init", "state_ring_push", "state_ring_sample",
]
