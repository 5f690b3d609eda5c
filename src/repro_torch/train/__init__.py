"""Training of the port: the train state, gradient accumulation over
microbatches with a bf16 compute copy of float32 masters, the AdamW step,
the sharded step on a mesh and the int8 pod compression."""
from . import compress, step
from .step import (TrainState, decay_mask, init_state, make_grads_fn,
                   make_train_step, shard_state, state_axes)
