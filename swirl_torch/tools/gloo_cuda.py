"""Which ``torch.distributed`` collectives gloo runs on CUDA tensors: the
source of ``parallel/sharded.py``'s ``GLOO_CUDA``. For each collective, two
gloo ranks on ``cuda:0`` (one process each, spawned anew, so that a
collective that aborts its process takes no other with it) run it once on
an int64 tensor and compare with the expected values. Prints one line a
collective (ok, or what was raised, or the exit codes) and the torch and
NCCL versions. Needs a CUDA card:

    python -m swirl_torch.tools.gloo_cuda
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile

WORLD = 2
TIMEOUT_S = 120
COLLECTIVES = ("all_to_all_single", "all_gather", "all_gather_into_tensor", "all_reduce", "broadcast",
               "batch_isend_irecv")


def _rank(name: str, rank: int, port: int, out: str) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=WORLD)
    x = torch.arange(4, dtype=torch.int64, device="cuda") + 100 * rank
    other = [torch.arange(4, dtype=torch.int64) + 100 * r for r in range(WORLD)]
    try:
        if name == "all_to_all_single":
            got = torch.empty_like(x)
            dist.all_to_all_single(got, x)
            want = torch.cat([o[2 * rank: 2 * rank + 2] for o in other])
        elif name == "all_gather":
            parts = [torch.empty_like(x) for _ in range(WORLD)]
            dist.all_gather(parts, x)
            got, want = torch.cat(parts), torch.cat(other)
        elif name == "all_gather_into_tensor":
            got = x.new_empty(WORLD * 4)
            dist.all_gather_into_tensor(got, x)
            want = torch.cat(other)
        elif name == "all_reduce":
            got = x.clone()
            dist.all_reduce(got)
            want = sum(other)
        elif name == "broadcast":
            got = x.clone()
            dist.broadcast(got, 0)
            want = other[0]
        else:
            got = torch.empty_like(x)
            ops = [dist.P2POp(dist.isend, x, (rank + 1) % WORLD), dist.P2POp(dist.irecv, got, (rank - 1) % WORLD)]
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            want = other[(rank - 1) % WORLD]
        torch.cuda.synchronize()
        result = "ok" if torch.equal(got.cpu(), want) else f"wrong values {got.tolist()}"
    except RuntimeError as err:
        result = f"{type(err).__name__}: {str(err).splitlines()[0][:160]}"
    with open(out, "w") as f:
        json.dump(result, f)
    dist.destroy_process_group()


def probe(name: str) -> str:
    """Two spawned ranks run ``name`` on CUDA tensors; their results, or
    their exit codes when a rank died."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(WORLD)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), name, str(r), str(port), outs[r]],
                                  stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL) for r in range(WORLD)]
        codes = []
        for proc in procs:
            try:
                codes.append(proc.wait(timeout=TIMEOUT_S))
            except subprocess.TimeoutExpired:
                proc.kill()
                codes.append(proc.wait())
        results = []
        for out in outs:
            if os.path.exists(out):
                with open(out) as f:
                    results.append(json.load(f))
    if len(results) == WORLD and all(r == "ok" for r in results):
        return "ok"
    return f"refused: {results}, exit codes {codes}"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gloo_cuda: no CUDA device", file=sys.stderr)
        return 2
    print(f"torch {torch.__version__}, NCCL {torch.cuda.nccl.version()}, {torch.cuda.get_device_name(0)}")
    for name in COLLECTIVES:
        print(f"gloo on CUDA int64, {WORLD} ranks on cuda:0, {name}: {probe(name)}", flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 5:  # one rank of probe()
        _rank(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    sys.exit(main())
