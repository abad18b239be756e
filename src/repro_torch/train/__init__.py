"""Step functions of the LM: training, prefill and decode (port of
``repro.train``)."""
from .steps import (TrainState, init_train_state, loss_and_grads,
                    make_prefill_step, make_serve_step,
                    make_sharded_train_step, make_train_step)

__all__ = ["TrainState", "init_train_state", "loss_and_grads",
           "make_train_step", "make_sharded_train_step", "make_prefill_step", "make_serve_step"]
