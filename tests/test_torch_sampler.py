"""The port's always-on stage-tagged sampler and pprof encoder, held
against the JAX package's.

The counterparts of test_hotspots.py's sampler tests (stage tags and a
clean stop, the ``gil_wait_ratio`` bvar, a burst, a blocked
``InstrumentedLock`` sampled as a lock wait, a native ring wait folded
to a ``[native]`` leaf), the sampler's life beside port servers (the
last server to join stops it), and the pprof encoder: on the same
folded stacks the port's ``encode_profile`` gives the JAX package's
profile bytes (the payload under gzip's time stamp).  Every test leaves
the port's sampler stopped.
"""
import gzip
import random
import threading
import time
from collections import Counter

import pytest

from brpc_tpu.builtin import pprof_proto as ref_pprof
from brpc_tpu.builtin import sampler as ref_sampler
import brpc_tpu_torch.rpc as rpc
from brpc_tpu_torch.builtin import pprof_proto, sampler
from brpc_tpu_torch.builtin.sampler import HotspotSampler
from brpc_tpu_torch.butil.lockprof import InstrumentedLock

from testutil import wait_until


@pytest.fixture(autouse=True)
def _sampler_stopped():
    yield
    HotspotSampler.instance().stop()
    assert not _sampler_threads()


def _sampler_threads():
    """The port's sampler threads (the JAX package's has the same
    name)."""
    mine = HotspotSampler.instance()
    return [t for t in threading.enumerate()
            if t.name == "hotspot-sampler" and t.is_alive()
            and getattr(getattr(t, "_target", None), "__self__", None)
            is mine]


def _busy(name):
    stop = threading.Event()

    def run():
        x = 0
        while not stop.is_set():
            x += 1

    t = threading.Thread(target=run, name=name)
    t.start()
    return stop, t


def test_sampler_stage_tags_stacks_and_stops_cleanly():
    samp = HotspotSampler.instance()
    stop, t = _busy("serving-engine-samplerprobe")
    samp.start()
    try:
        assert wait_until(lambda: any(k.startswith("decode_step;")
                                      for k in samp.folded()), 10), \
            "busy serving-engine thread never sampled under its stage"
        snap = samp.snapshot()
        assert snap["running"] and snap["samples"] > 0
        assert 0.0 <= snap["gil_wait_ratio"] <= 1.0
        assert "decode_step" in snap["stages"]
    finally:
        stop.set()
        t.join(5)
    samp.stop()
    assert not samp.running and not _sampler_threads()


def test_gil_wait_ratio_is_an_exposed_bvar():
    from brpc_tpu_torch.bvar.variable import find_exposed
    var = find_exposed("gil_wait_ratio")
    assert var is not None
    v = var.get_value()
    assert isinstance(v, float) and 0.0 <= v <= 1.0


def test_burst_collects_stage_tagged_stacks():
    stop, t = _busy("serving-batcher-burstprobe")
    try:
        stacks = sampler.burst(0.25, hz=100)
    finally:
        stop.set()
        t.join(5)
    assert sum(stacks.values()) > 0
    assert any(k.startswith("batch_formation;") for k in stacks)
    text = sampler.render_folded(stacks, "test burst")
    assert "batch_formation" in text and "lock-wait%" in text


def test_blocked_instrumented_lock_samples_as_lock_wait():
    lk = InstrumentedLock("test.torch_wait_marker")
    entered, release = threading.Event(), threading.Event()

    def holder():
        with lk:
            entered.set()
            release.wait(10)

    def blocked():
        entered.wait(10)
        with lk:
            pass

    th = threading.Thread(target=holder)
    tb = threading.Thread(target=blocked, name="serving-emit-waitprobe")
    th.start()
    tb.start()
    try:
        assert entered.wait(5)
        time.sleep(0.05)
        stacks = sampler.burst(0.2, hz=100)
    finally:
        release.set()
        th.join(5)
        tb.join(5)
    waiting = [k for k in stacks if k.startswith("emit_fanout;")
               and k.endswith(";[lock-wait]") and "lockprof" in k]
    assert waiting, "\n".join(k for k in stacks
                              if k.startswith("emit_fanout;"))


def test_native_ring_wait_folds_to_native_leaf():
    import ctypes
    from brpc_tpu_torch import native_path
    ring = native_path.token_ring(8)
    assert ring is not None
    out = (ctypes.c_int32 * 8)()
    stop = threading.Event()

    def consumer():
        while not stop.is_set():
            ring.pop_many(out, 0.2)

    t = threading.Thread(target=consumer, name="serving-emit-nativeprobe")
    t.start()
    try:
        time.sleep(0.05)
        stacks = sampler.burst(0.25, hz=100)
    finally:
        stop.set()
        t.join(5)
    native = [k for k in stacks if k.startswith("emit_fanout;")
              and k.endswith(";[native]") and "_core/lib" in k]
    assert native, "\n".join(k for k in stacks
                             if k.startswith("emit_fanout;"))


def test_fold_classifies_like_the_reference():
    """One frame walk, two classifiers: the port's and the JAX
    package's ``_fold`` agree on every live thread's class (they differ
    only in the package prefix of a file's short name)."""
    import sys
    stop, t = _busy("serving-engine-foldprobe")
    try:
        frames = sys._current_frames()
        for tid, frame in frames.items():
            mine = sampler._fold(frame)
            theirs = ref_sampler._fold(frame)
            assert mine[1] == theirs[1]
            assert len(mine[0].split(";")) == len(theirs[0].split(";"))
    finally:
        stop.set()
        t.join(5)


def test_server_start_runs_the_sampler_and_last_join_stops_it():
    from brpc_tpu_torch import flags
    srv_a, srv_b = rpc.Server(), rpc.Server()
    srv_a.start("127.0.0.1", 0)
    srv_b.start("127.0.0.1", 0)
    samp = HotspotSampler.instance()
    try:
        assert samp.running
        srv_a.stop()
        srv_a.join()
        assert samp.running          # srv_b still serves
        # live off and on through the flag's side effect
        from brpc_tpu_torch.builtin.services import _apply_flag_side_effects
        flags.set_flag("hotspot_sampler_enabled", False)
        _apply_flag_side_effects("hotspot_sampler_enabled")
        assert not samp.running
        flags.set_flag("hotspot_sampler_enabled", True)
        _apply_flag_side_effects("hotspot_sampler_enabled")
        assert samp.running
    finally:
        flags.set_flag("hotspot_sampler_enabled", True)
        srv_b.stop()
        srv_b.join()
    assert not samp.running and not _sampler_threads()


def _stacks(seed):
    rng = random.Random(seed)
    frames = [f"brpc/serving/engine.py:f{i}" for i in range(12)]
    out = Counter()
    for _ in range(60):
        depth = rng.randrange(1, 8)
        out[";".join(["decode_step"] + rng.sample(frames, depth))] += \
            rng.randrange(1, 50)
    out["emit_fanout;threading.py:wait;[lock-wait]"] += 7
    out[""] += 1                         # empty stacks are skipped
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_encode_profile_gives_the_reference_bytes(seed):
    stacks = _stacks(seed)
    mine = pprof_proto.encode_profile(stacks, period_ns=10_000_000,
                                      duration_ns=2_500_000_000)
    theirs = ref_pprof.encode_profile(stacks, period_ns=10_000_000,
                                      duration_ns=2_500_000_000)
    # gzip's header stamps the time; the profile under it is the same
    assert gzip.decompress(mine) == gzip.decompress(theirs)
    prof = pprof_proto.decode_profile(mine)
    assert prof == ref_pprof.decode_profile(theirs)
    assert prof["period"] == 10_000_000
    total = sum(v[0] for _, v in prof["samples"])
    assert total == sum(n for s, n in stacks.items() if s)
    with pytest.raises(ValueError):
        pprof_proto.decode_profile(gzip.compress(b"\x0a\x05ab"))
