"""The trainers of the port: losses, train states, the G-LIS alternating
step, the reverser steps (`steps_r`) and the host loop (`runner`)
(`gea/train/` is the reference)."""

from gea_torch.train.state import (  # noqa: F401
    GLISTrainState,
    RIterativeTrainState,
    RSeparateTrainState,
    create_glis_state,
    create_r_iterative_state,
    create_r_state,
    make_optimizer,
)
from gea_torch.train.steps import build_glis_train_step  # noqa: F401
from gea_torch.train.steps_r import build_r_iterative_step, build_r_separate_step  # noqa: F401
