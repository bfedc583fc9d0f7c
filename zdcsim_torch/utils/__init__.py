"""Shared utilities: seeded random streams and experiment IO
(``zdcsim/utils``'s public names)."""

from zdcsim_torch.utils.io import (  # noqa: F401
    DIR_INFO, DIR_MODELS, append_experiment_dir_to_cfg, create_dir, load_scales,
    load_train_test_indices, save_scales, save_train_test_indices,
)
from zdcsim_torch.utils.prng import fold_epoch_batch, key_iterator  # noqa: F401
