"""Multi-host (multi-process) execution smoke test.

Spawns 2 OS processes that each own 2 virtual CPU devices and join via
jax.distributed.initialize into one 4-device global mesh — the first actual
exercise of the DCN code path (cross-process collectives ride Gloo on CPU;
on a real cluster the identical program rides the interconnect). Covers data-parallel
batched solves, measurement-sharded dense products, and row-sharded
block-sparse JtJ with the sparse Cholesky (tests/multihost_worker.py legs
A-C), each asserted inside the workers against process-local single-device
references, and asserted here to agree between the two processes.

The reference has no multi-process capability at all (SURVEY.md section
2.2); this is the jax.distributed row of the parallelism table (SURVEY.md
section 5.8, parallel/mesh.py).
"""

import json
import pathlib
import socket
import subprocess
import sys

WORKER = pathlib.Path(__file__).parent / "multihost_worker.py"


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_distributed(tmp_path):
    port = _free_port()
    outs = [tmp_path / f"worker{i}.json" for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), "--pid", str(i), "--nproc", "2",
             "--port", str(port), "--out", str(outs[i])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)
    ]
    results = []
    for i, p in enumerate(procs):
        try:
            stdout, stderr = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, (
            f"worker {i} failed:\nstdout:\n{stdout}\nstderr:\n{stderr}")
        assert "MULTIHOST_WORKER_OK" in stdout
        results.append(json.loads(outs[i].read_text()))

    # both processes saw the full 4-device global mesh
    assert all(r["n_global_devices"] == 4 for r in results)
    # and computed identical global results (the multi-controller contract:
    # every process runs the same program and observes the same values)
    for leg in ("legA", "legB", "legC"):
        assert results[0][leg] == results[1][leg], leg
