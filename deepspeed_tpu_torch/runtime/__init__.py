from .dataloader import DeepSpeedDataLoader, RepeatingLoader, default_collate  # noqa: F401
from .engine import DeepSpeedEngine  # noqa: F401
