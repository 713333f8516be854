"""Service definition API (a copy of ``brpc_tpu/rpc/service.py``).

Services are plain Python classes whose RPC methods carry ``@method``,
naming their request and response serializers (``"raw"`` or
``"json"``, see serialization.py):

    class Echo(Service):
        @method(request="json", response="json")
        def Echo(self, cntl, req):
            return {"msg": req["msg"]}
"""
from __future__ import annotations

import inspect
from typing import Callable

from .serialization import get_serializer


class MethodSpec:
    __slots__ = ("name", "fn", "request_serializer", "response_serializer")

    def __init__(self, name, fn, request_serializer, response_serializer):
        self.name = name
        self.fn = fn
        self.request_serializer = request_serializer
        self.response_serializer = response_serializer


def method(request="raw", response="raw"):
    """Mark an RPC method; ``request``/``response`` name a serializer."""

    def deco(fn: Callable):
        fn.__rpc_spec__ = MethodSpec(fn.__name__, fn,
                                     get_serializer(request),
                                     get_serializer(response))
        return fn

    return deco


class Service:
    """Base class; NAME defaults to the class name."""

    NAME: str | None = None

    @classmethod
    def service_name(cls) -> str:
        return cls.NAME or cls.__name__

    def rpc_methods(self) -> dict[str, MethodSpec]:
        out = {}
        for name, member in inspect.getmembers(self, callable):
            spec = getattr(member, "__rpc_spec__", None)
            if spec is None:
                # an undecorated override still implements the rpc a base
                # class declared: inherit the base's spec, bind this one
                for klass in type(self).__mro__[1:]:
                    spec = getattr(klass.__dict__.get(name), "__rpc_spec__",
                                   None)
                    if spec is not None:
                        break
            if spec is not None:
                out[spec.name] = MethodSpec(spec.name, member,
                                            spec.request_serializer,
                                            spec.response_serializer)
        return out
