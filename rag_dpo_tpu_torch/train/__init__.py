from .contrastive import (  # noqa: F401
    TrainConfig,
    TrainState,
    create_train_state,
    make_sharded_train_step,
    make_train_step,
)
