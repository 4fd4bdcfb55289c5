"""Training substrate: optimizer, train step, gradient compression."""
from repro_torch.train.optimizer import adamw_init, adamw_update  # noqa: F401
from repro_torch.train.step import make_train_step  # noqa: F401
