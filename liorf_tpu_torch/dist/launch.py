"""Start N local worker processes of the distributed modes and collect them.

Each worker is ``python -m MODULE`` (by default the pose-graph demo,
``liorf_tpu_torch.dist.multihost``) with the rendezvous flags of
``multihost.add_rendezvous_flags``: a ``file://`` store in a fresh temporary
directory (no port to collide with), the world size, its rank, the backend
and the device. Worker output goes to temporary files, not pipes: a worker
blocked on a full pipe while its peers sit in a collective would deadlock
the launch. When a worker fails, the others are killed at once (they would
otherwise wait in a collective until their timeout), and the launch raises
with that worker's stderr.

    python -m liorf_tpu_torch.dist.launch --num-processes 4 --backend gloo \\
        --device cpu -- --nodes-per-device 64

prints rank 0's JSON line. Without ``--device`` each worker takes one card
(``cuda:{rank}``) and NCCL.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

DEMO = "liorf_tpu_torch.dist.multihost"
_REPO = Path(__file__).resolve().parents[2]


def launch(
    num_processes: int,
    worker_args=(),
    *,
    module: str = DEMO,
    backend: str | None = None,
    device: str | None = None,
    timeout: float = 600.0,
) -> dict | None:
    """Run ``num_processes`` workers of ``module`` to the end; returns the
    last JSON line rank 0 printed (None if it printed none). Raises
    ``RuntimeError`` when a worker fails and ``TimeoutError`` when the
    launch outlasts ``timeout`` seconds; no worker outlives the call.

    ``device`` / ``backend`` as ``multihost.init_multihost`` takes them
    (None: one card a rank, NCCL); the tests pass ``device="cpu"``,
    ``backend="gloo"``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(_REPO), env.get("PYTHONPATH")]))
    flags = [*(["--backend", backend] if backend else []),
             *(["--device", device] if device else [])]
    with tempfile.TemporaryDirectory(prefix="liorf_dist_") as tmp:
        procs, files = [], []
        try:
            for rank in range(num_processes):
                cmd = [
                    sys.executable, "-m", module,
                    "--coordinator", f"file://{tmp}/rendezvous",
                    "--num-processes", str(num_processes), "--process-id", str(rank),
                    *flags, *map(str, worker_args),
                ]
                out = open(os.path.join(tmp, f"rank{rank}.out"), "w+", encoding="utf-8")
                err = open(os.path.join(tmp, f"rank{rank}.err"), "w+", encoding="utf-8")
                files.append((out, err))
                procs.append(subprocess.Popen(cmd, cwd=_REPO, env=env, stdout=out, stderr=err))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
                if failed:
                    r = failed[0]
                    files[r][1].seek(0)
                    raise RuntimeError(
                        f"{module} rank {r} failed (rc={procs[r].returncode}):\n"
                        f"{files[r][1].read()[-6000:]}"
                    )
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{module}: {num_processes} workers outlasted {timeout} s")
                time.sleep(0.05)
            for r, p in enumerate(procs):
                if p.returncode != 0:
                    files[r][1].seek(0)
                    raise RuntimeError(
                        f"{module} rank {r} failed (rc={p.returncode}):\n"
                        f"{files[r][1].read()[-6000:]}"
                    )
            files[0][0].seek(0)
            lines = [ln for ln in files[0][0].read().splitlines() if ln.startswith("{")]
            return json.loads(lines[-1]) if lines else None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for out, err in files:
                out.close()
                err.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--module", default=DEMO)
    ap.add_argument("--backend", choices=["gloo", "nccl"], default=None,
                    help="default: nccl on cuda, gloo on cpu")
    ap.add_argument("--device", default=None,
                    help="cpu, cuda or cuda:N (default: cuda, one card a process)")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("worker_args", nargs=argparse.REMAINDER,
                    help="after --: the worker's own flags")
    args = ap.parse_args(argv)
    rest = args.worker_args[1:] if args.worker_args[:1] == ["--"] else args.worker_args
    res = launch(args.num_processes, rest, module=args.module, backend=args.backend,
                 device=args.device, timeout=args.timeout)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
