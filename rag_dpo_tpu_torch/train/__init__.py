from .contrastive import (  # noqa: F401
    TrainConfig,
    TrainState,
    create_train_state,
    make_train_step,
)
