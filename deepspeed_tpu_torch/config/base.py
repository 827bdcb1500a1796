"""Typed config models (copy of ``deepspeed_tpu/config/base.py``).

Plain dataclass-style annotations instead of pydantic: typed fields with
defaults, nested models, deprecated-field redirects and unknown-key warnings.
Kept identical to the JAX package so the same JSON resolves to the same
values and the same invalid JSON raises the same ``ConfigError``.
"""

import enum
import typing

from ..utils.logging import logger


class ConfigError(Exception):
    pass


_MISSING = object()


def _coerce(value, annot, field_name):
    """Coerce ``value`` to the annotated type, recursing into nested ConfigModels."""
    origin = typing.get_origin(annot)
    if annot is typing.Any or value is None:
        return value
    if origin is typing.Union:  # includes Optional
        args = [a for a in typing.get_args(annot) if a is not type(None)]
        last_err = None
        for a in args:
            try:
                return _coerce(value, a, field_name)
            except (TypeError, ValueError, ConfigError) as e:
                last_err = e
        raise ConfigError(f"{field_name}: cannot coerce {value!r} to {annot}: {last_err}")
    if origin in (list, tuple):
        args = typing.get_args(annot)
        elem = args[0] if args else typing.Any
        seq = [_coerce(v, elem, field_name) for v in value]
        return tuple(seq) if origin is tuple else seq
    if origin is dict:
        return dict(value)
    if isinstance(annot, type) and issubclass(annot, ConfigModel):
        if isinstance(value, annot):
            return value
        if isinstance(value, dict):
            return annot.from_dict(value)
        raise ConfigError(f"{field_name}: expected dict for {annot.__name__}, got {type(value)}")
    if isinstance(annot, type) and issubclass(annot, enum.Enum):
        if isinstance(value, annot):
            return value
        return annot(value)
    if annot is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            low = value.lower()
            if low in ("true", "1", "yes"):
                return True
            if low in ("false", "0", "no"):
                return False
        raise ConfigError(f"{field_name}: expected bool, got {value!r}")
    if annot is int:
        if isinstance(value, bool):
            raise ConfigError(f"{field_name}: expected int, got bool")
        if isinstance(value, int):
            return value
        if isinstance(value, float) and value.is_integer():
            return int(value)
        if isinstance(value, str):
            return int(value)
        raise ConfigError(f"{field_name}: expected int, got {value!r}")
    if annot is float:
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            return float(value)
        if isinstance(value, str):
            return float(value)
        raise ConfigError(f"{field_name}: expected float, got {value!r}")
    if annot is str:
        if isinstance(value, str):
            return value
        raise ConfigError(f"{field_name}: expected str, got {value!r}")
    return value


class ConfigModel:
    """Base for typed config sections.

    Subclasses declare fields via class annotations with defaults::

        class QuantizationConfig(ConfigModel):
            enabled: bool = False
            bits: int = 8

    ``deprecated_fields`` maps old key -> new key.
    """

    deprecated_fields: typing.ClassVar[dict] = {}

    def __init__(self, **kwargs):
        hints = typing.get_type_hints(type(self))
        hints = {k: v for k, v in hints.items() if not k.startswith("_") and k != "deprecated_fields"}
        for name, annot in hints.items():
            default = getattr(type(self), name, _MISSING)
            if name in kwargs:
                value = _coerce(kwargs.pop(name), annot, f"{type(self).__name__}.{name}")
            elif default is _MISSING:
                raise ConfigError(f"{type(self).__name__}: missing required field '{name}'")
            else:
                value = default() if isinstance(default, type) and issubclass(default, ConfigModel) else default
                if isinstance(value, (list, dict)):
                    value = type(value)(value)  # avoid shared mutable defaults
            setattr(self, name, value)
        if kwargs:
            raise ConfigError(f"{type(self).__name__}: unexpected fields {sorted(kwargs)}")
        self._validate()

    def _validate(self):
        """Subclass hook for cross-field validation."""

    @classmethod
    def from_dict(cls, d):
        d = dict(d or {})
        for old, new in cls.deprecated_fields.items():
            if old in d:
                logger.warning(f"Config field '{old}' is deprecated; use '{new}'")
                d.setdefault(new, d.pop(old))
        hints = typing.get_type_hints(cls)
        known = {k for k in hints if not k.startswith("_") and k != "deprecated_fields"}
        unknown = set(d) - known
        for k in sorted(unknown):
            logger.warning(f"{cls.__name__}: ignoring unknown config key '{k}'")
            d.pop(k)
        return cls(**d)

    def to_dict(self):
        out = {}
        hints = typing.get_type_hints(type(self))
        for name in hints:
            if name.startswith("_") or name == "deprecated_fields":
                continue
            value = getattr(self, name)
            if isinstance(value, ConfigModel):
                value = value.to_dict()
            elif isinstance(value, enum.Enum):
                value = value.value
            elif isinstance(value, tuple):
                value = list(value)
            out[name] = value
        return out

    def replace(self, **updates):
        d = self.to_dict()
        d.update(updates)
        return type(self).from_dict(d)

    def __repr__(self):
        fields = ", ".join(f"{k}={v!r}" for k, v in self.to_dict().items())
        return f"{type(self).__name__}({fields})"

    def __eq__(self, other):
        return type(self) is type(other) and self.to_dict() == other.to_dict()
