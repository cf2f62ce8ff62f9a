"""Training substrate: optimizers, train step, data pipeline, checkpointing
(the port of ``repro.train``)."""

from .checkpoint import CheckpointManager  # noqa: F401
from .data import SkyStoreShardSource, SyntheticTokens  # noqa: F401
from .optimizer import OptimizerConfig, make_optimizer  # noqa: F401
from .trainer import (  # noqa: F401
    TrainState,
    init_train_state,
    make_eval_step,
    make_train_step,
    train_state_from_reference,
)
