"""Training: states, the train step, the evaluator, the loop, hooks and
checkpoints (``zdcsim/train``'s public names)."""

from zdcsim_torch.train.state import (  # noqa: F401
    Component, MoETrainState, init_state, masked_expert_update,
)
from zdcsim_torch.train.step import build_train_step  # noqa: F401
from zdcsim_torch.train.evaluate import build_evaluator  # noqa: F401
from zdcsim_torch.train.loop import train  # noqa: F401
