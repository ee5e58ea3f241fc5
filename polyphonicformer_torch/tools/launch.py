"""Job launcher of the port: starts ``--nproc`` ranks of ``python -m
<module>`` on this host, with the environment ``torchrun`` sets
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``); the counterpart of
``polyphonicformer_tpu/tools/launch.py``.  The launched module calls
``parallel.mesh.init_distributed()`` first.

    python -m polyphonicformer_torch.tools.launch --nproc 2 -- \\
        polyphonicformer_torch.tools.train --preset video_r50_1x ...
    python -m polyphonicformer_torch.tools.launch --nproc 2 --sim-cpu -- \\
        polyphonicformer_torch.tools.dist_check

A rank takes the card ``LOCAL_RANK % device_count``; ranks that share a
card meet over gloo, ranks with a card each over NCCL
(``parallel/mesh.py``).  ``torchrun --nproc-per-node N -m <module>`` starts
the same job, and jobs over several hosts (``--nnodes``, ``--node-rank``).
The launcher exits with the first non-zero exit code of a rank and then
stops the other ranks, so a failed rank cannot leave the others waiting
in a collective.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nproc", type=int, default=1, help="ranks to start on this host")
    ap.add_argument("--port", type=int, default=29500)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0; default localhost:--port")
    ap.add_argument("--store-file", default=None,
                    help="meet through a FileStore at this path instead of TCP (one host)")
    ap.add_argument("--sim-cpu", action="store_true",
                    help="every rank on the CPU over gloo.  There is no --devices-per-proc "
                         "(the JAX launcher's virtual devices): a torch rank has one device")
    ap.add_argument("module", help="python module to run (python -m ...)")
    ap.add_argument("args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    host, port = (args.coordinator or f"localhost:{args.port}").rsplit(":", 1)
    procs = []
    for rank in range(args.nproc):
        env = dict(os.environ, MASTER_ADDR=host, MASTER_PORT=port, WORLD_SIZE=str(args.nproc),
                   RANK=str(rank), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(args.nproc))
        if args.store_file:
            env["POLY_STORE_FILE"] = os.path.abspath(args.store_file)
        if args.sim_cpu:
            env["POLY_DEVICE"] = "cpu"
        procs.append(subprocess.Popen([sys.executable, "-m", args.module, *args.args],
                                      env=env))
    rc = 0
    try:
        while procs and rc == 0:
            for p in list(procs):
                code = p.poll()
                if code is not None:
                    procs.remove(p)
                    rc = rc or (128 - code if code < 0 else code)  # a signal: 128 + its number
            time.sleep(0.1)
    finally:
        for p in procs:  # a rank failed, or the launcher was stopped
            p.send_signal(signal.SIGTERM)
        deadline = time.time() + 10
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.time(), 0.1))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    return rc


if __name__ == "__main__":
    sys.exit(main())
