"""Always-on background sampling profiler (a copy of
``brpc_tpu/builtin/sampler.py``).

A low-rate wall-clock sampler over ``sys._current_frames()`` that runs
beside every started port Server and answers "where did the host CPU go
over the last minutes?":

  * each sampled thread stack is FOLDED (root;..;leaf) and tagged with
    its serving STAGE (``butil/stagetag.py``: frame pump, batch
    formation, prefill, decode step, emit fan-out, span submit, ...) as
    the root frame, so one folded profile attributes CPU per stage;
  * each sample is classified RUNNING, WAITING (a leaf inside a
    threading/queue/lockprof acquire or wait: a thread parked on a
    lock) or NATIVE (a leaf at a GIL-released native call of the hot
    path); waiting over all samples is the ``gil_wait_ratio`` bvar;
  * samples land in a bounded RING of time windows, so ``/hotspots``
    shows the last minutes without unbounded memory.

The rate is the flag ``hotspot_sampler_hz`` (10 by default);
``hotspot_sampler_enabled`` (reloadable on ``/flags``) flips it live.
``Server.start`` starts it; unlike the JAX package's, which runs for
the life of the process, the port's stops when the last port server
joins.  ``burst()`` is the synchronous high-rate variant behind
``/hotspots?seconds=N`` (same tagging, 100 Hz, bounded), whose output
feeds the pprof encoder (``pprof_proto.py``).
"""
from __future__ import annotations

import sys
import threading
import time
from collections import Counter, deque

from ..butil import stagetag
from ..flags import define_flag, get_flag

define_flag("hotspot_sampler_enabled", True,
            "run the always-on low-Hz stage-tagged sampling profiler "
            "(flip live on /flags)", reloadable=True)
define_flag("hotspot_sampler_hz", 10.0,
            "sampling rate of the always-on profiler", reloadable=True)

# leaf frames that mean "parked on a lock/queue, not running" — the
# lockprof entries matter most: a thread blocked inside an
# InstrumentedLock acquire is parked on exactly the hot locks this
# layer ledgers, and counting it as running would undercount
# gil_wait_ratio where it matters
_WAIT_MARKERS = frozenset([
    ("threading", "wait"), ("threading", "acquire"), ("threading", "join"),
    ("threading", "_wait_for_tstate_lock"), ("threading", "wait_for"),
    ("queue", "get"), ("queue", "put"),
    ("lockprof", "acquire"), ("lockprof", "_acquire_restore"),
])

# leaf frames that mean "inside a GIL-released native call": a ctypes
# foreign call adds NO Python frame, so a thread spending its time in
# the native hot path samples at the binding-layer call site.  Those
# stacks fold into a `;[native]` leaf and count as their own column:
# not interpreter-bound run time, not lock-wait.
_NATIVE_LEAF_PREFIXES = ("brpc_tpu_torch/_core/",
                         "brpc_tpu_torch/native_path")
# native calls issued directly from hot-path frames (the engine's
# batched token push runs the foreign call from its own frame)
_NATIVE_MARKERS = frozenset([
    ("engine", "_push_token_runs"),
])
# binding-layer call sites that deliberately HOLD the interpreter lock
# (the _fastrpc fast entries: a per-token release and reacquire costs
# more than the push): a thread sampled here is Python run time
_GIL_HELD_BINDING = frozenset([
    ("lib", "push"),            # TokenRing.push -> fb.tokring_push
    ("lib", "push_terminal"),   # cold, Python-mutex-held
])


def _is_native_leaf(leaf_code) -> bool:
    key = (_modname(leaf_code.co_filename), leaf_code.co_name)
    if key in _NATIVE_MARKERS:
        return True
    if key in _GIL_HELD_BINDING:
        return False
    return _short(leaf_code.co_filename).startswith(_NATIVE_LEAF_PREFIXES)


def _modname(filename: str) -> str:
    base = filename.rsplit("/", 1)[-1]
    return base[:-3] if base.endswith(".py") else base


def _short(path: str) -> str:
    for marker in ("/site-packages/", "/python3.", "/brpc_tpu_torch/"):
        i = path.find(marker)
        if i >= 0:
            return ("brpc_tpu_torch/" + path[i + len(marker):]
                    if marker == "/brpc_tpu_torch/" else path[i + 1:])
    return path


def _fold(frame, skip_tids=None) -> tuple[str, str]:
    """(folded root;..;leaf stack, class) for one thread frame — a raw
    f_back walk: no linecache, no source IO, cheap enough for an
    always-on path.  class is one of "run" (executing Python), "wait"
    (parked on a lock/queue) or "native" (inside a GIL-released
    foreign call in the de-GIL'd hot path)."""
    parts: list[str] = []
    f = frame
    while f is not None:
        code = f.f_code
        parts.append(f"{_short(code.co_filename)}:{code.co_name}")
        f = f.f_back
    parts.reverse()
    leaf = frame.f_code
    if (_modname(leaf.co_filename), leaf.co_name) in _WAIT_MARKERS:
        cls = "wait"
    elif _is_native_leaf(leaf):
        cls = "native"
    else:
        cls = "run"
    return ";".join(parts), cls


_CLS_SUFFIX = {"run": "", "wait": ";[lock-wait]", "native": ";[native]"}


def sample_once(exclude: frozenset = frozenset()) -> list[tuple]:
    """One pass over every live thread: [(stage, folded, class)].
    ``exclude`` filters thread idents (the sampler excludes itself)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in sys._current_frames().items():
        if tid in exclude:
            continue
        folded, cls = _fold(frame)
        stage_name = stagetag.stage_of(tid, names.get(tid, ""))
        out.append((stage_name, folded, cls))
    return out


class _Window:
    __slots__ = ("start", "samples", "run", "wait", "native",
                 "stage_run", "stage_wait", "stage_native")

    def __init__(self, start: float):
        self.start = start
        self.samples: Counter = Counter()   # "stage;folded[;class]"
        self.run = 0
        self.wait = 0
        self.native = 0
        self.stage_run: Counter = Counter()
        self.stage_wait: Counter = Counter()
        self.stage_native: Counter = Counter()


class HotspotSampler:
    """The always-on profiler singleton (see module docstring)."""

    _instance: "HotspotSampler | None" = None
    _instance_mu = threading.Lock()

    def __init__(self, window_s: float = 15.0, ring: int = 40):
        self.window_s = window_s
        self._ring: deque = deque(maxlen=ring)   # closed windows
        self._win = _Window(time.monotonic())
        self._mu = threading.Lock()   # guards ring/window swap + reads
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.samples_total = 0

    # ---- lifecycle ----

    @classmethod
    def instance(cls) -> "HotspotSampler":
        inst = cls._instance
        if inst is None:
            with cls._instance_mu:
                if cls._instance is None:
                    cls._instance = cls()
                inst = cls._instance
        return inst

    @classmethod
    def ensure_started(cls) -> "HotspotSampler":
        """Start (or restart) the sampler if the flag allows it."""
        inst = cls.instance()
        if get_flag("hotspot_sampler_enabled", True):
            inst.start()
        return inst

    def start(self) -> None:
        with self._mu:
            if self._thread is not None and self._thread.is_alive():
                return
            # a FRESH stop event per thread: a racing stop() can only
            # ever set the event of the thread it actually swapped out,
            # never strand or double-start a sampler
            self._stop = stop_ev = threading.Event()
            self._thread = threading.Thread(
                target=self._run, args=(stop_ev,), daemon=True,
                name="hotspot-sampler")
            self._thread.start()

    def stop(self, timeout_s: float = 5.0) -> None:
        """Stop and JOIN the sampler thread (clean removal — the
        disable path must leave no thread behind)."""
        with self._mu:
            self._stop.set()
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout_s)

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    # ---- the sampling loop ----

    def _run(self, stop_ev: threading.Event) -> None:
        me = frozenset((threading.get_ident(),))
        while not stop_ev.is_set():
            hz = max(0.2, min(200.0, float(
                get_flag("hotspot_sampler_hz", 10.0) or 10.0)))
            if not get_flag("hotspot_sampler_enabled", True):
                # flag flipped off under us: exit; the /flags side
                # effect (or the next Server.start) restarts us
                return
            t0 = time.monotonic()
            try:
                observed = sample_once(exclude=me)
            except Exception:
                observed = []   # a torn frame walk must not kill the loop
            with self._mu:
                win = self._win
                if t0 - win.start >= self.window_s:
                    self._ring.append(win)
                    win = self._win = _Window(t0)
                for stage_name, folded, cls in observed:
                    win.samples[
                        f"{stage_name};{folded}{_CLS_SUFFIX[cls]}"] += 1
                    if cls == "wait":
                        win.wait += 1
                        win.stage_wait[stage_name] += 1
                    elif cls == "native":
                        win.native += 1
                        win.stage_native[stage_name] += 1
                    else:
                        win.run += 1
                        win.stage_run[stage_name] += 1
                self.samples_total += len(observed)
            stop_ev.wait(max(0.0, 1.0 / hz - (time.monotonic() - t0)))

    # ---- reads ----

    def _windows(self) -> list[_Window]:
        with self._mu:
            return list(self._ring) + [self._win]

    def folded(self, last_s: float | None = None) -> Counter:
        """Merged stage-tagged folded stacks over the ring (or the last
        `last_s` seconds of it)."""
        now = time.monotonic()
        merged: Counter = Counter()
        for w in self._windows():
            if last_s is not None and now - w.start > last_s + self.window_s:
                continue
            merged.update(w.samples)
        return merged

    def gil_wait_ratio(self) -> float:
        # native samples stay in the denominator: a thread inside a
        # lock-released foreign call is making progress
        run = wait = 0
        for w in self._windows():
            run += w.run + w.native
            wait += w.wait
        total = run + wait
        return round(wait / total, 4) if total else 0.0

    def stage_table(self) -> dict[str, dict]:
        run: Counter = Counter()
        wait: Counter = Counter()
        native: Counter = Counter()
        for w in self._windows():
            run.update(w.stage_run)
            wait.update(w.stage_wait)
            native.update(w.stage_native)
        out = {}
        for stage_name in sorted(set(run) | set(wait) | set(native)):
            r, wt, nv = run[stage_name], wait[stage_name], \
                native[stage_name]
            total = r + wt + nv
            out[stage_name] = {
                "run": r, "wait": wt, "native": nv,
                "wait_ratio": round(wt / total, 4) if total else 0.0,
            }
        return out

    def snapshot(self) -> dict:
        return {
            "running": self.running,
            "hz": float(get_flag("hotspot_sampler_hz", 10.0) or 10.0),
            "window_s": self.window_s,
            "windows": len(self._windows()),
            "samples": self.samples_total,
            "gil_wait_ratio": self.gil_wait_ratio(),
            "stages": self.stage_table(),
        }


def burst(duration_s: float, hz: int = 100) -> Counter:
    """Synchronous high-rate stage-tagged collection (the
    ``/hotspots?seconds=N`` burst mode).  Returns the same folded
    Counter shape as :meth:`HotspotSampler.folded`."""
    me = frozenset((threading.get_ident(),))
    stacks: Counter = Counter()
    interval = 1.0 / max(1, hz)
    end = time.monotonic() + min(60.0, max(0.05, duration_s))
    while time.monotonic() < end:
        for stage_name, folded, cls in sample_once(exclude=me):
            stacks[f"{stage_name};{folded}{_CLS_SUFFIX[cls]}"] += 1
        time.sleep(interval)
    return stacks


def render_folded(stacks: Counter, title: str, top: int = 25) -> str:
    """Human view of a stage-tagged folded profile: per-stage totals
    then the hottest stacks."""
    total = sum(stacks.values())
    by_stage: Counter = Counter()
    wait_by_stage: Counter = Counter()
    native_by_stage: Counter = Counter()
    for s, n in stacks.items():
        stage_name = s.split(";", 1)[0]
        by_stage[stage_name] += n
        if s.endswith(";[lock-wait]"):
            wait_by_stage[stage_name] += n
        elif s.endswith(";[native]"):
            native_by_stage[stage_name] += n
    lines = [f"--- {title}: {total} samples, {len(stacks)} unique "
             f"stage-tagged stacks ---", "",
             f"{'samples':>8}  {'%':>6}  {'lock-wait%':>10}  "
             f"{'native%':>7}  stage"]
    for stage_name, n in by_stage.most_common():
        w = wait_by_stage[stage_name]
        nv = native_by_stage[stage_name]
        lines.append(f"{n:>8}  {100.0 * n / max(1, total):>5.1f}%  "
                     f"{100.0 * w / max(1, n):>9.1f}%  "
                     f"{100.0 * nv / max(1, n):>6.1f}%  {stage_name}")
    lines.append("")
    lines.append("hottest stacks (stage;root;..;leaf):")
    for s, n in stacks.most_common(top):
        lines.append(f"  [{n} samples]")
        for fr in s.split(";"):
            lines.append(f"    {fr}")
    return "\n".join(lines) + "\n"


# headline bvar: appears on /vars and /brpc_metrics as `gil_wait_ratio`
from ..bvar.reducer import PassiveStatus  # noqa: E402

PassiveStatus(
    lambda: HotspotSampler.instance().gil_wait_ratio(),
).expose("gil_wait_ratio")
