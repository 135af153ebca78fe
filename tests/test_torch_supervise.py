"""The port's supervisor (utils/supervise.py), on the CPU: a stall timeout
without a heartbeat is refused; stub children (a patched _spawn) show the
startup grace, the kill of a stalled child by its pid and the give-up
after max_restarts; one real `render --cpu` child (the scan engine,
config1 at width 16, 4 spp in batches of 1) crashed by --chaos crash:2
restarts once from its checkpoint and writes the straight run's PPM byte
for byte."""

import os
import subprocess
import sys
import time

import pytest

from distributed_raytracer_tpu_torch.utils.supervise import Supervisor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_stall_requires_heartbeat():
    with pytest.raises(ValueError, match="heartbeat"):
        Supervisor(["render"], stall_timeout=5.0)


def test_missing_checkpoint_warns():
    msgs = []
    Supervisor(["render"], log=msgs.append)
    assert any("no --checkpoint" in m for m in msgs)
    msgs.clear()
    sup = Supervisor(["render", "--checkpoint", "c"], heartbeat="hb", stall_timeout=2.0,
                     log=msgs.append)
    assert not msgs and sup.startup_grace == 8.0  # 4x the stall timeout


def test_gives_up_after_max_restarts(monkeypatch):
    msgs = []
    sup = Supervisor(["--checkpoint", "unused"], max_restarts=1, poll=0.05, log=msgs.append)
    monkeypatch.setattr(Supervisor, "_spawn",
                        lambda self: subprocess.Popen([sys.executable, "-c", "raise SystemExit(3)"]))
    res = sup.run()
    assert (res.exit_code, res.restarts, res.events) == (3, 1, ["exit:3", "exit:3"])
    assert any("giving up" in m for m in msgs)


def test_startup_grace_then_stall_kills_the_child(tmp_path, monkeypatch):
    """Silent for 1.2 s (inside the 10 s grace), then one beat, then a
    hang: killed about 0.5 s after the beat, by its pid."""
    hb = str(tmp_path / "beat")
    code = f"import time; time.sleep(1.2); open({hb!r}, 'w').write('x'); time.sleep(60)"
    children = []

    def spawn(self):
        children.append(subprocess.Popen([sys.executable, "-c", code]))
        return children[-1]

    monkeypatch.setattr(Supervisor, "_spawn", spawn)
    msgs = []
    sup = Supervisor(["--checkpoint", "unused"], heartbeat=hb, stall_timeout=0.5,
                     startup_grace=10.0, max_restarts=0, poll=0.05, log=msgs.append)
    t0 = time.time()
    res = sup.run()
    took = time.time() - t0
    assert res.events == ["stall"] and res.exit_code != 0, res
    assert 1.2 < took < 8.0, took
    assert children[0].poll() is not None
    assert any(f"killing pid {children[0].pid}" in m for m in msgs), msgs


def _cli(args, timeout=300):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "distributed_raytracer_tpu_torch.cli", *args],
                          env=env, cwd=ROOT, capture_output=True, text=True, timeout=timeout)


def test_supervised_crash_equals_straight_run(tmp_path):
    common = ["render", "--config", "config1", "--width", "16", "--spp", "4", "--batch", "1",
              "--engine", "scan", "--cpu", "--seed", "3"]
    ck = str(tmp_path / "c.ckpt")
    r = _cli(["supervise", "--max-restarts", "2", "--", *common, "--checkpoint", ck,
              "--heartbeat", str(tmp_path / "beat"), "--chaos", "crash:2",
              "--out", str(tmp_path / "crash.ppm")])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "exit:13" in r.stderr and "after 1 restart" in r.stderr, r.stderr[-800:]
    assert os.path.exists(ck + ".chaos")
    straight = _cli([*common, "--out", str(tmp_path / "straight.ppm")])
    assert straight.returncode == 0, straight.stderr[-2000:]
    assert (tmp_path / "crash.ppm").read_bytes() == (tmp_path / "straight.ppm").read_bytes()
