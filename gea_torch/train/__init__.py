"""The G-LIS trainer of the port: losses, train state, the alternating
train step and the host loop (`runner`) (`gea/train/` is the reference)."""

from gea_torch.train.state import GLISTrainState, create_glis_state, make_optimizer  # noqa: F401
from gea_torch.train.steps import build_glis_train_step  # noqa: F401
