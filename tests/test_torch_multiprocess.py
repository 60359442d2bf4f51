"""Two real OS processes, started with subprocess, join one gloo group
through a FileStore and run the port's in-situ epoch renderer; each checks
its own shard of the frame against a single-process render: the
counterpart of tests/test_multiprocess.py."""

import os
import subprocess
import sys
from pathlib import Path

WORKER = Path(__file__).parent / "torch_dist_worker.py"


def test_two_process_insitu_render(tmp_path):
    n = 2
    store = str(tmp_path / "store")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "JAX_PLATFORM_NAME")}
    procs = [
        subprocess.Popen([sys.executable, str(WORKER), str(i), str(n), store],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, env=env)
        for i in range(n)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-3000:]}"
        assert f"MP_OK {i}" in out, f"worker {i} no MP_OK:\n{out[-3000:]}"
        assert "jax_imported=False" in out, out[-3000:]
