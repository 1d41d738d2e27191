from repro_torch.train.optimizer import (
    AdamWConfig, OptState, adamw_update, clip_by_global_norm, cosine_schedule, init_opt_state,
)
from repro_torch.train.trainer import (
    TrainConfig, TrainState, init_train_state, make_train_step, train_loop,
)
