"""Build the native host core the port's RPC layer runs on.

The port compiles the repository's own C++ core (``src/cc``: IOBuf,
work-stealing executor, timers, epoll sockets, TRPC framing) itself,
with ``g++`` called directly -- one process per source, all started
together -- into ``build/torch_core/<hash>/`` at the repository root:

  libbrpc_core_torch.so   the core (the sources ``Makefile`` builds)
  _fastrpc.so             the CPython extension for the RPC hot
                          boundary (``src/cc/fastrpc_module.cc``),
                          linked against the library beside it
                          (``-Wl,-rpath,$ORIGIN``)

``<hash>`` digests the sources, the headers, the flags and the
compiler, so an edited source rebuilds and an unchanged one loads the
build already made.  Nothing here runs ``make`` or writes into
``src/cc``.

The flags are ``Makefile``'s, plus ``-fno-gnu-unique``: without it the
function-local statics of the core's templates (the socket resource
pool among them) become process-wide unique symbols, and a process
that also loads the JAX package's core would share one socket pool
between two cores.  With it each core keeps every object to itself.

Nothing here runs at import: the tests import every module.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sysconfig
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SRC = REPO / "src" / "cc"
BUILD_ROOT = REPO / "build" / "torch_core"
LIB_NAME = "libbrpc_core_torch.so"
EXT_NAME = "_fastrpc.so"
EXT_SOURCE = SRC / "fastrpc_module.cc"
# Makefile:8 (CXXFLAGS) and :15 (LDFLAGS); -fcoroutines is probed below
CXXFLAGS = ("-O2", "-g", "-std=c++20", "-fPIC", "-Wall", "-Wextra",
            "-Wno-unused-parameter", "-pthread", "-fno-gnu-unique")
LDFLAGS = ("-shared", "-pthread")

_mu = threading.Lock()
_built: Path | None = None
build_seconds: float | None = None   # wall time of this process's build


def sources() -> list[Path]:
    """The core's translation units, as ``Makefile:17-21`` lists them."""
    out = []
    for sub in ("butil", "bthread", "net", "bvar"):
        out += sorted((SRC / sub).glob("*.cc"))
    out += sorted(p for p in SRC.glob("*.cc") if p != EXT_SOURCE)
    return out


def _cxx() -> str:
    cxx = os.environ.get("CXX", "g++")
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(f"C++ compiler {cxx!r} not found (set CXX or "
                           f"PATH); the port's native core is built from "
                           f"src/cc at first use")
    return found


def _python_include() -> str:
    inc = sysconfig.get_paths()["include"]
    if not (Path(inc) / "Python.h").exists():
        raise RuntimeError(f"Python.h not found under {inc} (sysconfig); "
                           f"the _fastrpc extension needs the CPython "
                           f"headers")
    return inc


def _coroutine_flag(cxx: str) -> tuple:
    """``-fcoroutines`` where the compiler takes it (g++ 10 gates C++20
    coroutines behind it; Makefile:12-13 probes the same way)."""
    probe = subprocess.run(
        [cxx, "-std=c++20", "-fcoroutines", "-x", "c++", "-", "-o",
         os.devnull], input=b"int main(){}", capture_output=True)
    return ("-fcoroutines",) if probe.returncode == 0 else ()


def _digest(cxx: str, flags: tuple) -> str:
    h = hashlib.sha256()
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             check=True).stdout
    h.update(version + " ".join(flags).encode())
    files = [p for p in SRC.rglob("*")
             if p.suffix in (".cc", ".h", ".inc") and "test" not in p.parts]
    for p in sorted(files):
        h.update(str(p.relative_to(SRC)).encode() + p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list) -> None:
    """Start every command at once; raise with the output of any that
    failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n"
                          f"{log.decode(errors='replace')}")
    if failed:
        raise RuntimeError("native core build failed:\n" + "\n".join(failed))


def build() -> Path:
    """The directory holding ``libbrpc_core_torch.so`` and
    ``_fastrpc.so``, built first where missing.  Raises
    ``RuntimeError`` naming the missing piece (compiler, Python
    headers) or carrying the compiler's output."""
    global _built, build_seconds
    with _mu:
        if _built is not None:
            return _built
        cxx = _cxx()
        flags = CXXFLAGS + _coroutine_flag(cxx)
        out = BUILD_ROOT / _digest(cxx, flags)
        if not (out / EXT_NAME).exists():
            t0 = time.perf_counter()
            _build_into(cxx, flags, out)
            build_seconds = time.perf_counter() - t0
        _built = out
        return out


def _build_into(cxx: str, flags: tuple, out: Path) -> None:
    pyinc = _python_include()
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    inc = ("-I" + str(SRC),)
    objs, cmds = [], []
    for src in sources():
        obj = tmp / (str(src.relative_to(SRC)).replace("/", "_")[:-3] + ".o")
        objs.append(str(obj))
        cmds.append([cxx, *flags, *inc, "-c", "-o", str(obj), str(src)])
    ext_obj = tmp / "fastrpc_module.o"
    cmds.append([cxx, *flags, *inc, "-I" + pyinc, "-c", "-o", str(ext_obj),
                 str(EXT_SOURCE)])
    _run_all(cmds)
    _run_all([[cxx, *LDFLAGS, "-o", str(tmp / LIB_NAME), *objs]])
    # Makefile:40-41, against the port's library: NEEDED names it, and
    # $ORIGIN finds it beside the extension
    _run_all([[cxx, *LDFLAGS, "-o", str(tmp / EXT_NAME), str(ext_obj),
               "-L" + str(tmp), "-l:" + LIB_NAME, "-Wl,-rpath,$ORIGIN"]])
    for obj in [*objs, str(ext_obj)]:
        os.unlink(obj)
    try:
        os.rename(tmp, out)
    except OSError:
        # another process finished the same build first
        if not (out / EXT_NAME).exists():
            raise
        shutil.rmtree(tmp, ignore_errors=True)
