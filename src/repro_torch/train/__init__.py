"""Training of the port on one device: the train state, gradient
accumulation over microbatches with a bf16 compute copy of float32
masters, and the AdamW step."""
from . import step
from .step import (TrainState, decay_mask, init_state, make_grads_fn,
                   make_train_step)
