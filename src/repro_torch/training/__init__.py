"""Training substrate: optimizer, losses, train-step builder, trainer."""
from .loss import cross_entropy, lm_loss, IGNORE  # noqa: F401
from .optim import OptimConfig, apply_updates, init_state, lr_at  # noqa
from .train import (TrainConfig, Trainer, build_grad_fn,  # noqa: F401
                    build_train_step, init_train_state)
