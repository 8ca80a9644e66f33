"""Training of the port: AdamW with warmup and cosine/linear/constant
schedules, error-feedback gradient compression, and the train step (loss,
gradients through K1 and K1-bwd, clipping, in-place update) built by
``make_train_step`` over the ``{params, opt, step}`` state that
``init_train_state`` builds — the unit the checkpointer saves and
restores — on one device or on a mesh (``make_train_artifacts``).
:class:`Plan` is ``repro_torch.parallel.Plan``."""
from repro_torch.train.optimizer import (OptimizerConfig, adamw_init,
                                         adamw_update, lr_at)
from repro_torch.train.step import (Plan, TrainArtifacts, init_train_state,
                                    keep_input_state, make_grad_fn,
                                    make_train_artifacts, make_train_step,
                                    shard_batch)

__all__ = ["OptimizerConfig", "Plan", "TrainArtifacts", "adamw_init",
           "adamw_update", "init_train_state", "keep_input_state", "lr_at",
           "make_grad_fn", "make_train_artifacts", "make_train_step",
           "shard_batch"]
