"""Training substrate of the port: optimizer, steps, loop, checkpointing."""
from repro_torch.train.checkpoint import load_config, restore, save
from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                         cosine_lr, global_norm,
                                         init_opt_state)
from repro_torch.train.trainer import (lm_loss, loss_and_grads,
                                       make_eval_step, make_loss_fn,
                                       make_train_step, train_loop)

__all__ = ["load_config", "restore", "save", "OptimizerConfig",
           "adamw_update", "cosine_lr", "global_norm", "init_opt_state",
           "lm_loss", "loss_and_grads", "make_eval_step", "make_loss_fn",
           "make_train_step", "train_loop"]
