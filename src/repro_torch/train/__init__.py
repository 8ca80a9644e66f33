"""Training of the port: AdamW with warmup and cosine/linear/constant
schedules, and the train step (loss, gradients through K1 and K1-bwd,
clipping, in-place update) built by ``make_train_step`` over the
``{params, opt, step}`` state that ``init_train_state`` builds — the unit
the checkpointer saves and restores."""
from repro_torch.train.optimizer import (OptimizerConfig, adamw_init,
                                         adamw_update, lr_at)
from repro_torch.train.step import (Plan, init_train_state, keep_input_state,
                                    make_train_step)

__all__ = ["OptimizerConfig", "Plan", "adamw_init", "adamw_update",
           "init_train_state", "keep_input_state", "lr_at", "make_train_step"]
