"""The port's operator (``volsync_tpu_torch/operator.py``, ``metrics.py``
and the stack under them) against the reference's, on the CPU.

``OperatorRuntime(device="cpu")`` reconciles CRs into Jobs that run the
port's entry points with the kernels' plain twins: a restic source and
destination round trip whose repository the reference's ``Repository``
opens to the same snapshots and trees, an rsync pair, two restic CRs and
an rclone pair through one bucket of the port's fake S3, and a syncthing
pair. These are ``chip_smoke.py``'s operator phase at a small size, with
no Job attempt failed. Then: the same metric operations on both
packages' ``Metrics`` expose equal parsed samples (``_created`` left
out), and ``python -m volsync_tpu_torch.operator`` in a subprocess
answers its probes and ``/metrics``, refuses a second manager on its
storage root, and stops on SIGTERM. The CPU twins slow down several-fold
when threads run them at once, so the runtimes here run one Job at a
time where the movers allow it (an rsync or syncthing pair needs two)
and back up and restore with one worker."""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest
import torch

import chip_smoke

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SEED = 5


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setenv("VOLSYNC_BACKUP_WORKERS", "1")
    monkeypatch.setenv("VOLSYNC_RESTORE_WORKERS", "1")


def _runtime(tmp_path, workers: int, movers: str):
    return chip_smoke.operator_runtime(tmp_path, runner_workers=workers,
                                       manager_workers=2,
                                       movers=movers).start()


def test_restic_round_trip_through_the_operator(cpu, tmp_path):
    from volsync_tpu.objstore.store import FsObjectStore as JFs
    from volsync_tpu.repo.repository import Repository as JRepo
    from volsync_tpu_torch.objstore.store import FsObjectStore
    from volsync_tpu_torch.repo.repository import Repository

    rt = _runtime(tmp_path, 1, "restic")
    try:
        with chip_smoke.JobFailures(rt.cluster) as failures:
            fleet = chip_smoke.operator_fleet(torch, rt, tmp_path, 2,
                                              700_000, 2, SEED, "cpu")
            chip_smoke.operator_restores(torch, rt, tmp_path,
                                         fleet["names"][:1], "cpu")
            chip_smoke.operator_listener(rt, fleet["names"], 2, "cpu")
        failures.check("restic")
    finally:
        rt.stop()
    assert [len(r["launches"]) > 0 for r in fleet["rounds"]] == [True] * 2
    for name in fleet["names"]:
        path = tmp_path / f"repo-{name}"
        port = Repository.open(FsObjectStore(path),
                               chip_smoke.OPERATOR_PASSWORD, device="cpu")
        ref = JRepo.open(JFs(path), chip_smoke.OPERATOR_PASSWORD)
        snaps = sorted(port.list_snapshots())
        assert len(snaps) == 2
        assert sorted(ref.list_snapshots()) == snaps
        for _, meta in snaps:
            assert ref.read_blob(meta["tree"]) == port.read_blob(
                meta["tree"])
        assert ref.check() == [] and port.check() == []


def test_rsync_pair_through_the_operator(cpu, tmp_path):
    rt = _runtime(tmp_path, 2, "rsync")
    try:
        with chip_smoke.JobFailures(rt.cluster) as failures:
            res = chip_smoke.operator_rsync(torch, rt, 300_000, SEED, "cpu")
        failures.check("rsync")
    finally:
        rt.stop()
    assert set(res) == {"first", "second"}


def test_two_restic_crs_and_rclone_through_fake_s3(cpu, tmp_path):
    rt = _runtime(tmp_path, 1, "restic,rclone")
    try:
        with chip_smoke.JobFailures(rt.cluster) as failures:
            res = chip_smoke.operator_s3(torch, rt, tmp_path, 600_000,
                                         200_000, SEED, "cpu")
        failures.check("s3")
    finally:
        rt.stop()
    assert set(res) == {"restic", "rclone_up", "rclone_down"}


def test_syncthing_pair_through_the_operator(cpu, tmp_path):
    rt = _runtime(tmp_path, 2, "syncthing")
    try:
        with chip_smoke.JobFailures(rt.cluster) as failures:
            chip_smoke.operator_syncthing(torch, rt, 200_000, SEED, "cpu")
        failures.check("syncthing")
    finally:
        rt.stop()


def test_a_failed_job_attempt_is_reported(cpu, tmp_path):
    """A restic CR whose repository secret names an unreachable store:
    the runner retries its Job, and ``JobFailures`` reports the attempt
    with the runner's traceback."""
    rt = _runtime(tmp_path, 1, "restic")
    try:
        with chip_smoke.JobFailures(rt.cluster) as failures:
            chip_smoke.secret(rt.cluster, "bad", {
                "RESTIC_REPOSITORY": "s3:http://127.0.0.1:9/bucket/x",
                "RESTIC_PASSWORD": "pw"})
            (chip_smoke.volume(rt.cluster, "v") / "f.bin").write_bytes(
                b"x" * 1000)
            chip_smoke.restic_source(rt.cluster, "cr", "v", "bad", "go")
            assert rt.cluster.wait_for(lambda: failures.failed,
                                       timeout=60, poll=0.05)
        with pytest.raises(AssertionError, match="failed Job attempts"):
            failures.check("bad")
    finally:
        rt.stop()


def _ops(m):
    b = m.for_object('cr "q"\\x\ny', "ns", "source", "restic")
    b.missed_intervals.inc()
    b.out_of_sync.set(1)
    for s in (0.05, 0.3, 7, 4000):
        b.sync_durations.observe(s)
    b.throughput.set(123.5)
    m.for_object("other", "ns", "destination", "rsync").out_of_sync.set(0)
    m.svc_stage_seconds.labels(tenant="t", stage="svc.admit").inc(0.25)
    m.retry_attempts.labels(site="s3.put", outcome="ok").inc(3)
    m.session_keepalives.labels(backend="torch", outcome="ok").inc()
    m.plan_regret.set(1.5)
    m.repo_takeovers_total.inc()
    m.breaker_state.labels(backend="s3").set(2)


def _parsed(text: str) -> set:
    from prometheus_client.parser import text_string_to_metric_families

    return {(s.name, tuple(sorted(s.labels.items())), s.value)
            for fam in text_string_to_metric_families(text)
            for s in fam.samples if not s.name.endswith("_created")}


def test_metrics_expose_equal_parsed_samples():
    from volsync_tpu.metrics import Metrics as JMetrics
    from volsync_tpu_torch.metrics import Metrics

    ref, port = JMetrics(), Metrics()
    _ops(ref)
    _ops(port)
    text = port.expose().decode()
    assert _parsed(text) == _parsed(ref.expose().decode())
    assert "_created" not in text
    # chip_smoke's own parser (the card machine has no prometheus_client)
    assert {(n, tuple(sorted(lb.items())), v) for n, lb, v in
            chip_smoke.parse_exposition(text)} == _parsed(text)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _manager_env(tmp_path: Path, port: int) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    env.update(VOLSYNC_DEVICE="cpu",
               VOLSYNC_STORAGE_PATH=str(tmp_path / "storage"),
               VOLSYNC_METRICS_ADDR="127.0.0.1",
               VOLSYNC_METRICS_PORT=str(port), VOLSYNC_MOVERS="rsync,restic")
    return env


def test_manager_process_probes_lock_and_sigterm(tmp_path):
    (tmp_path / "storage").mkdir()
    port = _free_port()
    cmd = [sys.executable, "-m", "volsync_tpu_torch.operator"]
    proc = subprocess.Popen(cmd, env=_manager_env(tmp_path, port),
                            cwd=str(tmp_path), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        base = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 90
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"manager died rc={proc.returncode}:\n"
                                     f"{proc.communicate()[1][-1500:]}")
            try:
                with urllib.request.urlopen(f"{base}/readyz",
                                            timeout=2) as r:
                    if r.status == 200:
                        break
            except OSError:
                assert time.monotonic() < deadline, "never became ready"
                time.sleep(0.2)
        with urllib.request.urlopen(f"{base}/healthz", timeout=5) as r:
            assert r.status == 200
        with urllib.request.urlopen(f"{base}/metrics", timeout=5) as r:
            body = r.read().decode()
        assert "# TYPE volsync_missed_intervals counter" in body
        assert "volsync_retry_attempts_total" in body
        with urllib.request.urlopen(f"{base}/debug/trace", timeout=5) as r:
            assert "traceEvents" in json.loads(r.read())

        second = subprocess.run(cmd, env=_manager_env(tmp_path, 0),
                                cwd=str(tmp_path), timeout=120,
                                capture_output=True, text=True)
        assert second.returncode != 0
        assert "already managed" in second.stderr + second.stdout

        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, proc.communicate()[1][-800:]
        assert "device=cpu" in proc.communicate()[1]
    finally:
        if proc.poll() is None:
            proc.kill()
