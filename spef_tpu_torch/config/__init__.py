from spef_tpu_torch.config.node import CfgNode  # noqa: F401
from spef_tpu_torch.config.train_config import (  # noqa: F401
    default_config,
    discover_experiments,
    load_config,
    save_config,
)
