"""The smoke test: prints 42 (port of ``examples/plus.py``).

    python -m tfmesos_tpu_torch.plus [MASTER] [--device cpu]

Brings up a cluster of one ps task and one worker task, both Mode A
(no command), and dispatches :func:`compute` to them: rank 0 holds 24,
rank 1 holds 18, and an ``all_reduce`` over the data mesh (``fsdp``,
since the spec has a ps job) adds them on every rank.  The addends are
tensors on the card unless ``--device cpu``; two ranks sharing one card
reduce over gloo (``runtime.choose_backend``).  Prints rank 0's sum on
stdout, and each rank's device and the backend on stderr.
"""

from __future__ import annotations

import argparse
import sys

from tfmesos_tpu_torch import cluster


def compute(ctx):
    """Rank 0's 24 plus rank 1's 18 (further ranks add 0; a lone rank
    holds 42), summed over the mesh; runs on every rank."""
    import torch
    import torch.distributed as dist

    mesh = ctx.mesh()
    n = mesh.size()
    addends = [24.0, 18.0] + [0.0] * (n - 2) if n >= 2 else [42.0]
    total = torch.tensor([addends[ctx.rank]], device=ctx.device)
    if n > 1:
        dist.all_reduce(total, group=mesh.get_group())
    return {"sum": float(total.item()), "device": str(total.device),
            "backend": dist.get_backend() if n > 1 else None}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m tfmesos_tpu_torch.plus")
    p.add_argument("master", nargs="?", default=None,
                   help="Mesos master (host:port, http://... or zk://...); "
                        "default: the local backend")
    p.add_argument("--device", default=None,
                   help="device of the addends (default: cuda)")
    args = p.parse_args(argv)
    jobs = [dict(name="ps", num=1, cpus=0.5, mem=128.0),
            dict(name="worker", num=1, cpus=0.5, mem=128.0)]
    extra = {"device": args.device} if args.device else {}
    with cluster(jobs, master=args.master, quiet=True,
                 extra_config=extra) as c:
        ranks = c.run_all("tfmesos_tpu_torch.plus:compute")
    print(f"plus: {[r['device'] for r in ranks]} over "
          f"{ranks[0]['backend']}", file=sys.stderr)
    print(int(ranks[0]["sum"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
