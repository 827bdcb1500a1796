from .base import ConfigError, ConfigModel  # noqa: F401
