"""Entry-point plumbing: the System import path needs no PyYAML, the
compile-cache rule, and chip_smoke.py refusing to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

from hyslam_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code_or_args, cwd=REPO, timeout=240):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    args = (code_or_args if isinstance(code_or_args, list)
            else ["-c", code_or_args])
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_system_imports_without_yaml():
    """`import hyslam_tpu.slam.system` works with PyYAML unavailable; only
    load_config needs it."""
    r = _run(
        "import sys; sys.modules['yaml'] = None\n"
        "import hyslam_tpu.slam.system\n"
        "from hyslam_tpu.io.config import load_config\n"
        "try:\n"
        "    load_config('config/sample_config.yaml')\n"
        "except ImportError:\n"
        "    print('load_config needs yaml')\n")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "load_config needs yaml" in r.stdout


class TestCompileCache:
    @pytest.fixture(autouse=True)
    def _restore(self):
        before = jax.config.jax_compilation_cache_dir
        yield
        jax.config.update("jax_compilation_cache_dir", before)

    def test_honours_env_var(self, monkeypatch, tmp_path):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        before = jax.config.jax_compilation_cache_dir
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        # JAX reads the variable itself: nothing else is configured
        assert jax.config.jax_compilation_cache_dir == before

    def test_fixed_path_in_checkout(self, monkeypatch):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


class TestChipSmoke:
    def test_fails_without_gpu(self):
        """On a CPU-only JAX the script exits non-zero and prints no result
        line."""
        r = _run(["chip_smoke.py"])
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
        assert "no GPU" in r.stderr

    def test_fails_outside_the_checkout(self, tmp_path):
        """Copied alone into an empty directory, the script cannot run."""
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        r = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=tmp_path,
            env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
            | {"JAX_PLATFORMS": "cpu"},
            capture_output=True, text=True, timeout=240)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout

    @pytest.mark.parametrize("cards", [1, 4])
    def test_phases_and_last_line(self, monkeypatch, capsys, cards):
        """With a GPU present, the default run takes phases (a)-(c) and
        `--cards 4` only the distributed phase; the last line is exactly
        the JSON object the contract reads."""
        sys.path.insert(0, REPO)
        import chip_smoke

        class Card:
            platform = "gpu"
            device_kind = "NVIDIA H100 80GB HBM3"

        ran = []
        monkeypatch.setattr(jax, "devices", lambda: [Card()] * cards)
        for phase in ("phase_device", "phase_pose_lm", "phase_system",
                      "run_multicard"):
            monkeypatch.setattr(chip_smoke, phase,
                                lambda *a, _p=phase, **k: ran.append(_p))
        argv = ["--cards", "4"] if cards == 4 else []
        assert chip_smoke.main(argv) == 0
        expect = (["phase_device", "run_multicard"] if cards == 4 else
                  ["phase_device", "phase_pose_lm", "phase_system"])
        assert ran == expect
        last = capsys.readouterr().out.strip().splitlines()[-1]
        assert json.loads(last) == {"ok": True, "device": {
            "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
            "count": cards}}

    def test_phase_watchdog_ends_a_hung_phase(self):
        """A phase past its limit dumps the stacks and exits with code 1;
        its start line names it."""
        r = _run("import time, chip_smoke\n"
                 "with chip_smoke.phase('stuck', limit_s=1):\n"
                 "    time.sleep(30)\n"
                 "print('not reached')\n", timeout=60)
        assert r.returncode == 1
        assert r.stdout.strip().splitlines() == ["phase stuck: start"]
        assert "Timeout" in r.stderr and "time.sleep" not in r.stdout

    def test_phase_logs_and_cancels_the_watchdog(self):
        r = _run("import time, chip_smoke\n"
                 "with chip_smoke.phase('quick', limit_s=2):\n"
                 "    pass\n"
                 "time.sleep(3)\n"
                 "print('after')\n", timeout=60)
        assert r.returncode == 0, r.stderr[-2000:]
        lines = r.stdout.strip().splitlines()
        assert lines[0] == "phase quick: start"
        assert lines[1].startswith("phase quick: done in ")
        assert lines[2] == "after"

    def test_multicard_phase_on_virtual_devices(self):
        """The --cards 4 phase at a tiny size on four of the virtual CPU
        devices: the distributed solvers agree with the one-device ones."""
        sys.path.insert(0, REPO)
        import chip_smoke

        out = chip_smoke.run_multicard(n_dev=4, K=16, L=512, O=4,
                                       n_iters=2, reps=1)
        assert set(out) == {"ba_1card", "ba_1d", "ba_2d",
                            "pose_graph_1card", "pose_graph_dist"}
        for name in ("ba_1d", "ba_2d"):
            assert out[name]["d_t"] <= chip_smoke.DIST_POSE_TOL_M

    @pytest.mark.parametrize("n_dev", [4, 8])
    def test_pose_graph_problem_padding(self, n_dev):
        sys.path.insert(0, REPO)
        import chip_smoke

        g, fixed, ei, ej, meas, valid = chip_smoke.pose_graph_problem(
            128, n_dev)
        assert g.shape == (128, 8) and fixed.shape == (128,)
        assert ei.shape[0] % n_dev == 0
        assert ei.shape == ej.shape == valid.shape
        assert meas.shape == (ei.shape[0], 8)
        assert int(valid.sum()) == 127 + 1 + 1   # chain + every-64 + closure
