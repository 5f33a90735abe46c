"""Multi-host (multi-process) training-step tests.

Spawns 2 REAL processes, each owning 4 virtual CPU devices, joined by
`jax.distributed.initialize` into one 8-device global mesh; the train
step's gradient reduction crosses the process boundary through
XLA/Gloo collectives. This is the multi-host path exercised end-to-end
without accelerator hardware — the reference has no multi-device
support of any kind (SURVEY.md §2.3).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytestmark = pytest.mark.slow  # 2 processes x full step compile

WORKER = Path(__file__).parent / "_multihost_worker.py"
REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(nproc: int, model_axis: int, timeout_s: float = 1500.0):
    port = _free_port()
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(pid), str(nproc), str(port),
             str(model_axis)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=str(REPO), env=env)
        for pid in range(nproc)
    ]
    results = []
    for p in procs:
        out, _ = p.communicate(timeout=timeout_s)
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
        line = [l for l in out.splitlines() if l.startswith("MH_RESULT ")]
        assert line, f"no MH_RESULT in output:\n{out[-3000:]}"
        results.append(json.loads(line[-1][len("MH_RESULT "):]))
    return results


def test_two_process_data_parallel_step():
    r = _launch(nproc=2, model_axis=1)
    assert [x["global_devices"] for x in r] == [8, 8]
    assert [x["local_devices"] for x in r] == [4, 4]
    assert all(x["mesh"] == {"data": 8, "model": 1} for x in r)
    losses = [x["loss"] for x in r]
    assert np.isfinite(losses).all()
    # every process observes the same globally-reduced loss
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)
    assert all(x["eval_count"] == 16.0 for x in r)


def test_two_process_dp_x_tp_step():
    """data axis spans the processes, 'model' (tensor parallel) shards
    the BERT tower within each process (hosts on 'data', the devices of
    one host on 'model')."""
    r = _launch(nproc=2, model_axis=2)
    assert all(x["mesh"] == {"data": 4, "model": 2} for x in r)
    losses = [x["loss"] for x in r]
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)
    assert all("model" in x["qkv_spec"] for x in r)
