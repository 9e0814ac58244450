"""Run ``parallel/dist_query.py``'s programs on a process group of ranks.

``run_group(cases, shard, time, workdir)`` starts ``shard × time``
processes (this module's ``main``, one a rank), which open a
``torch.distributed`` group through ``parallel/multiproc.
init_distributed`` (gloo on the CPU, NCCL where each rank has a card),
build ``make_query_mesh`` in the ``(shard, time)`` layout, and run every
case on their own blocks (``shard_batch_arrays``); each rank writes what
its programs returned to ``<workdir>/rank-<r>.pkl``, and ``run_group``
hands back the ranks' results in rank order. Every wait has a deadline:
a rank that has not finished by then is killed and ``run_group`` raises.

A case is a dict: ``name``; ``program``, one of ``sum_rate``, ``ring``,
``range_agg`` (``fn``, ``agg``, None for per-series rows), ``split``
(prepare → bounds → eval → group reduce for ``fn`` under ``agg``) or
``blocks`` (the rank's ``shard_batch_arrays`` blocks); ``num_groups``; and
the global host arrays, padded for the layout (``pad_for_mesh``): ``ts``,
``vals``, ``valid``, ``gids``, ``steps``, ``window``. ``run_case`` runs a
case over a ``LocalMesh`` too, in the calling process.

    python -m filodb_tpu_torch.testing.dist_run --cases cases.pkl \\
        --out results/ --rank 0 --world 8 --time-axis 2 --addr 127.0.0.1:PORT
"""

from __future__ import annotations

import argparse
import os
import pickle
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _split(mesh, dq, case, blocks):
    """The split pipeline of ``case["fn"]`` under ``case["agg"]``."""
    ts, vals, valid, gids = blocks
    steps, window, fn = case["steps"], int(case["window"]), case["fn"]
    lo, hi = dq.make_mesh_bounds(mesh)(ts, steps, window)
    if fn in dq.COUNTER_FNS:
        cv = dq.make_mesh_prepare(mesh, "counter")(vals, valid) \
            if dq.COUNTER_FNS[fn][1] else None
        rows = dq.make_mesh_eval_delta(mesh, fn)(ts, vals, valid, lo, hi,
                                                 steps, window, cv=cv)
    else:
        csum, cnt, csum2 = dq.make_mesh_prepare(mesh, "prefix")(vals, valid)
        rows = dq.make_mesh_eval_simple(mesh, fn)(
            ts, vals, valid, csum, cnt, csum2, lo, hi, steps, window)
    if case["agg"] is None:
        return rows
    return dq.make_mesh_group_reduce(mesh, case["num_groups"],
                                     case["agg"])(rows, gids)


def run_case(mesh, case):
    """One case on this rank: what its program returned, as numpy. Over a
    ``LocalMesh`` (one process drives every slot): an aggregate's [G, K],
    the shard rows' per-series rows joined in row order, or for
    ``blocks`` every slot's blocks in slot order."""
    import numpy as np
    import torch

    from filodb_tpu_torch.parallel import dist_query as dq

    local = isinstance(mesh, dq.LocalMesh)
    blocks = dq.shard_batch_arrays(mesh, case["ts"], case["vals"],
                                   case["valid"], case["gids"])
    if case["program"] == "blocks":
        if local:
            return [tuple(b[i].cpu().numpy() for b in blocks)
                    for i in range(len(mesh))]
        return tuple(b.numpy() for b in blocks)
    steps = torch.as_tensor(case["steps"]).to(
        mesh.root if local else blocks[0].device)
    case = dict(case, steps=steps)
    G, window = case["num_groups"], int(case["window"])
    prog = case["program"]
    if prog == "sum_rate":
        out = dq.make_distributed_sum_rate(mesh, G)(*blocks, steps, window)
    elif prog == "ring":
        out = dq.make_distributed_sum_rate_ring(mesh, G)(*blocks, steps,
                                                         window)
    elif prog == "range_agg":
        out = dq.make_distributed_range_agg(mesh, case["fn"], G,
                                            case["agg"])(*blocks, steps,
                                                         window)
    elif prog == "split":
        out = _split(mesh, dq, case, blocks)
    else:
        raise ValueError(f"unknown program {prog}")
    if isinstance(out, list):
        return np.concatenate([o.cpu().numpy() for o in out])
    return out.cpu().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dist_run")
    ap.add_argument("--cases", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--time-axis", type=int, required=True)
    ap.add_argument("--addr", required=True)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from filodb_tpu_torch.parallel import dist_query as dq
    from filodb_tpu_torch.parallel.multiproc import init_distributed

    torch.set_num_threads(1)
    with open(args.cases, "rb") as f:
        cases = pickle.load(f)
    init_distributed(args.addr, args.world, args.rank)
    try:
        mesh = dq.make_query_mesh(time_axis=args.time_axis)
        results = {"coords": tuple(int(c) for c in mesh.get_coordinate())}
        for case in cases:
            results[case["name"]] = run_case(mesh, case)
        path = os.path.join(args.out, f"rank-{args.rank}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(results, f)
        os.replace(path + ".tmp", path)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_group(cases: list, shard: int, time_axis: int, workdir: str,
              timeout_s: float = 120.0, env: dict | None = None) -> list:
    """Every case on a group of ``shard × time_axis`` ranks (processes);
    the ranks' result dicts in rank order (each also holds its mesh
    ``coords``)."""
    os.makedirs(workdir, exist_ok=True)
    cases_path = os.path.join(workdir, "cases.pkl")
    with open(cases_path, "wb") as f:
        pickle.dump(cases, f)
    world = shard * time_axis
    addr = f"127.0.0.1:{_free_port()}"
    run_env = dict(os.environ, FILODB_MESH_DISTRIBUTED="1",
                   OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [_ROOT, os.environ.get("PYTHONPATH", "")]))
    run_env.update(env or {})
    procs = [subprocess.Popen(
        [sys.executable, "-m", "filodb_tpu_torch.testing.dist_run",
         "--cases", cases_path, "--out", workdir, "--rank", str(r),
         "--world", str(world), "--time-axis", str(time_axis),
         "--addr", addr],
        env=run_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    deadline = time.monotonic() + timeout_s
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(),
                                               0.1))
            logs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"a rank of the {shard}x{time_axis} group did "
                           f"not finish within {timeout_s} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"ranks {bad} of the {shard}x{time_axis} group "
                           f"failed:\n{logs[bad[0]][-4000:]}")
    results = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank-{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


if __name__ == "__main__":
    sys.exit(main())
