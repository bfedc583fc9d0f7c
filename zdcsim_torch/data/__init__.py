"""Data: the reference's pickles, the offline prep, scalers, the train/test
split and the device-resident loaders (``zdcsim/data``'s public names)."""

from zdcsim_torch.data.dataset import (  # noqa: F401
    SplitArrays, get_dataset, get_train_test_data, transform_data_for_training,
)
from zdcsim_torch.data.loader import DeviceLoader, make_loaders  # noqa: F401
from zdcsim_torch.data.scalers import MinMaxScaler, StandardScaler  # noqa: F401
from zdcsim_torch.data.synthetic import make_synthetic_dataset  # noqa: F401
