"""Native runtime tests: C++ queue semantics (backpressure, clear, close),
status flags, and the threaded pipeline producing the same quality of
trajectory as the synchronous path."""

import os
import threading
import time

import numpy as np
import jax.numpy as jnp
import pytest

from hyslam_tpu.runtime import native
from hyslam_tpu.runtime.native import NativeQueue, ThreadStatus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestNativeBuild:
    def test_library_builds_into_ignored_dir(self):
        """The shared library is compiled from the committed source into
        <checkout>/build/, which .gitignore lists; nothing binary lives in
        the package."""
        native.load_library()
        lib = native.library_path()
        assert os.path.exists(lib)
        assert os.path.dirname(lib) == os.path.join(REPO, "build", "native")
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert "build/" in f.read().split()
        pkg_native = os.path.join(REPO, "hyslam_tpu", "native")
        assert not [f for f in os.listdir(pkg_native) if f.endswith(".so")]

    def test_build_keyed_on_source_content(self, tmp_path, monkeypatch):
        """An edited source builds a new library; an unchanged one (even
        with a new mtime) reuses the existing build."""
        monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
        src = tmp_path / "hyslam_rt.cpp"
        src.write_bytes(open(native._SRC, "rb").read())
        lib = native.build(str(src))
        assert os.path.exists(lib) and lib.startswith(str(tmp_path / "build"))
        mtime = os.path.getmtime(lib)
        os.utime(src, None)
        assert native.build(str(src)) == lib
        assert os.path.getmtime(lib) == mtime
        src.write_text(src.read_text() + "\n// edited\n")
        lib2 = native.library_path(str(src))
        assert lib2 != lib and not os.path.exists(lib2)
        assert native.build(str(src)) == lib2 and os.path.exists(lib2)
        assert not [f for f in os.listdir(tmp_path / "build")
                    if f.endswith(".tmp")]


class TestNativeQueue:
    def test_fifo(self):
        q = NativeQueue(8)
        for i in range(5):
            q.push(("item", i))
        assert q.size() == 5
        for i in range(5):
            assert q.pop() == ("item", i)

    def test_backpressure_blocks_until_pop(self):
        q = NativeQueue(2)
        assert q.push(1, timeout_ms=100)
        assert q.push(2, timeout_ms=100)
        t0 = time.time()
        assert not q.push(3, timeout_ms=200)  # full -> times out
        assert time.time() - t0 >= 0.15

        def consumer():
            time.sleep(0.1)
            q.pop()

        th = threading.Thread(target=consumer)
        th.start()
        assert q.push(3, timeout_ms=2000)  # unblocks after pop
        th.join()

    def test_clear_returns_dropped(self):
        q = NativeQueue(16)
        for i in range(7):
            q.push(i)
        assert q.clear() == 7
        assert q.size() == 0

    def test_close_unblocks_pop(self):
        q = NativeQueue(4)
        out = []

        def consumer():
            out.append(q.pop())

        th = threading.Thread(target=consumer)
        th.start()
        time.sleep(0.05)
        q.close()
        th.join(timeout=2)
        assert out == [None]

    def test_cross_thread_throughput(self):
        q = NativeQueue(32)
        n = 2000
        got = []

        def consumer():
            while True:
                x = q.pop()
                if x is None:
                    break
                got.append(x)

        th = threading.Thread(target=consumer)
        th.start()
        for i in range(n):
            q.push(i)
        q.close()
        th.join(timeout=10)
        assert got == list(range(n))


class TestThreadStatus:
    def test_flags(self):
        s = ThreadStatus()
        assert s.accepting_input == 1
        s.set("accepting_input", 0)
        assert s.accepting_input == 0
        s.set("queue_length", 7)
        assert s.queue_length == 7
        s.set("stop_requested", 1)
        assert s.stop_requested == 1


class TestPipelinedTracker:
    def test_matches_synchronous_quality(self, rng):
        from hyslam_tpu.core.mapstate import MapCaps
        from hyslam_tpu.geometry import se3
        from hyslam_tpu.runtime.pipeline import PipelinedTracker
        from hyslam_tpu.slam.keyframe_policy import KeyFramePolicyParams
        from hyslam_tpu.slam.tracker import State, Tracker

        from helpers import DEFAULT_CAM, make_world, synth_frame_features, pose_error

        cam = DEFAULT_CAM
        pts = make_world(rng, 1500, extent=(10.0, 7.0, 60.0), z_min=2.0)
        descs = rng.integers(0, 2**32, (len(pts), 8), dtype=np.uint32)
        tracker = Tracker(
            cam=cam, caps=MapCaps(K=64, L=8192, F=512, O=8),
            policy=KeyFramePolicyParams(max_kf_interval=10),
        )
        pipe = PipelinedTracker(tracker)
        T = np.eye(4, dtype=np.float32)
        Ts = []
        for i in range(25):
            Ts.append(T.copy())
            feats, _ = synth_frame_features(cam, T, pts, descs, rng, F=512)
            pipe.feed(feats, 0.1 * i, i)
            delta = np.asarray(se3.exp(jnp.asarray(
                [0, 0.004, 0, 0, 0, -0.12], dtype=jnp.float32)))
            T = (delta @ T).astype(np.float32)
        tels = pipe.join()
        assert len(tels) == 25
        assert tracker.state == State.NORMAL
        # re-anchor the trajectory to the FINAL keyframe poses before
        # scoring: how many local-BA refinements the tracker adopted
        # DURING the run depends on thread scheduling (machine load), but
        # the final map state does not (Trajectory::updatePoses semantics)
        from hyslam_tpu.core import trajectory as TJ

        tracker.traj = TJ.refresh(tracker.traj, tracker.ms.kf.Tcw,
                                  tracker.ms.kf.bad,
                                  tracker.ms.kf.span_parent,
                                  tracker.ms.kf.Tcp)
        n = int(tracker.traj.size)
        errs = [pose_error(np.asarray(tracker.traj.Tcw[i]), Ts[i])[1]
                for i in range(n)]
        assert np.sqrt(np.mean(np.square(errs))) < 0.08
