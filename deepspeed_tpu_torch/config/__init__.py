from .base import ConfigError, ConfigModel  # noqa: F401
from .config import ChunkedPrefillConfig, KVPoolConfig, ServingConfig, SLOConfig  # noqa: F401
from .config import DeepSpeedConfig, load_config  # noqa: F401
