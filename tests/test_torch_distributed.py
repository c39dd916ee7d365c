"""The port's multi-process search (the counterpart of
``tests/test_distributed.py``).

Two OS processes join a gloo process group with two frontier shards each
and run ``run_search`` SPMD over the global four-shard mesh, exchanging
rows through ``all_to_all_single`` and small vectors through
``all_gather``; each reads only scalars every process holds.  Both must
ACCEPT after the one-process run's layers, and each process's shards must
equal the matching blocks of the one-process final frontier, integer for
integer.  Each process has its own time limit, so a hang fails this test
instead of the suite.
"""

import os
import socket
import subprocess
import sys

import numpy as np

from s2_verification_tpu_torch.checker import device as pdev
from s2_verification_tpu_torch.checker.entries import prepare
from s2_verification_tpu_torch.collector.adversarial import adversarial_events
from s2_verification_tpu_torch.models.encode import encode_history

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = """
import sys
proc, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, {repo!r})
import numpy as np
from s2_verification_tpu_torch.parallel import frontier_mesh, init_distributed, multiprocess_supported
init_distributed(f"127.0.0.1:{{port}}", num_processes=2, process_id=proc, local_device_count=2)
assert multiprocess_supported() == (True, ""), multiprocess_supported()
from s2_verification_tpu_torch.checker.device import (
    STOP_ACCEPT, build_tables, init_frontier, place_frontier, run_search,
)
from s2_verification_tpu_torch.checker.entries import prepare
from s2_verification_tpu_torch.collector.adversarial import adversarial_events
from s2_verification_tpu_torch.models.encode import encode_history

enc = encode_history(prepare(adversarial_events(4, batch=3, seed=5)))
mesh = frontier_mesh()
assert (mesh.size, mesh.local, mesh.first) == (4, 2, 2 * proc), mesh
frontier = place_frontier(init_frontier(enc, 256, "cpu"), mesh)
out = run_search(build_tables(enc, "cpu"), frontier, enc.total_remaining + 2, allow_prune=False)
assert out.stop_code == STOP_ACCEPT, out.stop_code
np.savez(path, **{{f"{{s}}.{{k}}": getattr(b, k).numpy() for s, b in enumerate(out.frontier.blocks, mesh.first)
                  for k in b._fields}})
print(f"proc {{proc}}: ACCEPT after {{out.layers}} layers, max_live {{out.max_live}}, "
      f"expanded {{out.expanded}}", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_spmd_search(tmp_path):
    enc = encode_history(prepare(adversarial_events(4, batch=3, seed=5)))
    want = pdev.run_search(pdev.build_tables(enc, "cpu"), pdev.init_frontier(enc, 256, "cpu"),
                           enc.total_remaining + 2, allow_prune=False)
    assert want.stop_code == pdev.STOP_ACCEPT
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    outs = [str(tmp_path / f"proc{i}.npz") for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER.format(repo=REPO), str(i), str(port), outs[i]],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for i in range(2)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0].decode(errors="replace"))
    finally:
        for p in procs:
            p.kill()
    line = (f"ACCEPT after {want.layers} layers, max_live {want.max_live}, expanded {want.expanded}")
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"proc {i} failed:\n{log}"
        assert f"proc {i}: {line}" in log, log
    fs = want.frontier.capacity // 4
    for i, path in enumerate(outs):
        with np.load(path) as z:
            for s in (2 * i, 2 * i + 1):
                for k, full in zip(pdev.Frontier._fields, want.frontier):
                    np.testing.assert_array_equal(z[f"{s}.{k}"], full[s * fs : (s + 1) * fs].numpy(), err_msg=k)
