"""Process-wide flags (a copy of ``brpc_tpu/flags.py``).

Every tunable is defined near its use with :func:`define_flag`;
:func:`set_flag` edits the ones marked reloadable (``force=True`` edits
any).  Defined here: the rpcz flags (``rpcz_database_dir`` among
them); ``native_path.py`` defines the hot path's kill switch
``native_hot_path_enabled``.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Optional

_flags: dict[str, "Flag"] = {}
_mu = threading.Lock()


@dataclass
class Flag:
    name: str
    value: Any
    default: Any
    help: str = ""
    reloadable: bool = False
    validator: Optional[Callable[[Any], bool]] = None
    type_: type = str


def define_flag(name: str, default: Any, help: str = "",
                reloadable: bool = False,
                validator: Callable[[Any], bool] | None = None) -> Flag:
    with _mu:
        if name in _flags:
            return _flags[name]
        f = Flag(name, default, default, help, reloadable, validator,
                 type(default))
        _flags[name] = f
        return f


def get_flag(name: str, default: Any = None) -> Any:
    # lock-free: dict.get is atomic under the interpreter lock and a
    # flag is never removed; this runs per request and per token
    f = _flags.get(name)
    return f.value if f is not None else default


def set_flag(name: str, value: Any, *, force: bool = False) -> bool:
    with _mu:
        f = _flags.get(name)
        if f is None:
            return False
        if not f.reloadable and not force:
            return False
        try:
            if f.type_ is bool and isinstance(value, str):
                value = value.lower() in ("1", "true", "yes", "on")
            else:
                value = f.type_(value)
        except (TypeError, ValueError):
            return False
        if f.validator is not None and not f.validator(value):
            return False
        f.value = value
        return True


def list_flags() -> list[Flag]:
    with _mu:
        return sorted(_flags.values(), key=lambda f: f.name)


define_flag("rpcz_enabled", False, "Collect per-RPC spans (off by default "
            "like FLAGS_enable_rpcz; span objects are only built when on)",
            reloadable=True)
define_flag("rpcz_sample_rate", 1.0, "Fraction of spans kept",
            reloadable=True)
define_flag("rpcz_database_dir", "", "Persist collected spans to recordio "
            "segments under this directory; empty = in-memory only",
            reloadable=True)
