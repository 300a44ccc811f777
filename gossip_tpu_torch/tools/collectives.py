"""Which collectives the node mesh's process groups carry, and what the
mesh's largest all_gather costs.

    python -m gossip_tpu_torch.tools.collectives [--device cpu]

It launches four groups through :func:`gossip_tpu_torch.parallel.group.launch`
on one card: one rank under NCCL, two and four ranks sharing the card
under gloo, and one rank under gloo (with ``--device cpu``: one, two and
four gloo ranks on the CPU).  Each rank runs every collective the
sharded drivers use, on CUDA tensors of the dtypes they send (int32
words, bool bytes, int64 counts, float32 partials, SWIM's int32 wires
through the ``max`` all-reduce, the sparse exchange's ``all_to_all`` of
int32 words and bool bytes, an ``all_to_all_single`` with uneven splits,
the halo exchange's ``ppermute`` by +1 and -1, and the fused planes'
``min`` all-reduce of int64 counts), then the sub-group collectives of a
hybrid mesh (``parallel/multislice.make_hybrid_mesh``: 2 x K/2 where K is
even, else 1 x K; a sum, a min and an all_gather along each axis), and
records each result or the error it raised; then it times ``all_gather`` of 10M
int32 words (40 MB, the packed table of ``BASELINE.json`` configuration
5) split over the ranks, and ``all_to_all`` of the same words: a
warm-up, then five calls on the host clock between synchronisations.
It prints one JSON line a group, after the card's name and power limit
as ``nvidia-smi`` gives them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from gossip_tpu_torch.parallel import group as GR

WORDS = 10_000_000          # the 40 MB table of 10M int32 words
REPS = 5


def _try(fn):
    try:
        out = fn()
        return out.tolist() if isinstance(out, torch.Tensor) else out
    except Exception as e:        # noqa: BLE001 - reported, not raised
        return f"{type(e).__name__}: {e}"[:300]


def probe_rank(group) -> dict:
    """One rank's results: each collective's output (or its error) and
    the 40 MB all_gather's ms."""
    dev = group.device
    r, size = group.rank, group.size
    x = torch.arange(8, dtype=torch.int32, device=dev) + 100 * r
    out = {
        "all_gather_int32": _try(lambda: group.all_gather(x)),
        "all_gather_bool": _try(lambda: group.all_gather(x % 2 == 0)),
        "reduce_scatter_int32": _try(lambda: group.reduce_scatter_sum(
            torch.full((8 * group.size,), r + 1, dtype=torch.int32,
                       device=dev))),
        "all_reduce_int64": _try(lambda: group.all_reduce_sum(
            torch.full((4,), r + 1, dtype=torch.int64, device=dev))),
        "all_reduce_max_int32": _try(lambda: group.all_reduce_max(
            x.reshape(2, 4))),
        "combine_float32": _try(lambda: group.combine_f32(
            torch.tensor([r + 0.5, 1.0], device=dev))),
        # x[d, j] = 100 r + 10 d + j goes to rank d
        "all_to_all_int32": _try(lambda: group.all_to_all(
            100 * r + 10 * torch.arange(size, dtype=torch.int32,
                                        device=dev)[:, None]
            + torch.arange(3, dtype=torch.int32, device=dev))),
        "all_to_all_bool": _try(lambda: group.all_to_all(
            (torch.arange(2 * size, device=dev) + r).reshape(size, 2)
            % 2 == 0)),
        "all_to_all_uneven": _try(lambda: _uneven(group)),
        "ppermute_plus1": _try(lambda: group.ppermute(x[:4], 1)),
        "ppermute_minus1": _try(lambda: group.ppermute(x[4:] % 2 == 0,
                                                       -1)),
        "all_reduce_min_int64": _try(lambda: group.all_reduce_min(
            torch.tensor([10 - r, r], dtype=torch.int64, device=dev))),
        "hybrid_mesh": _try(lambda: _hybrid(group)),
    }
    src = torch.ones(WORDS // size, dtype=torch.int32, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for name, fn in (("all_gather", lambda: group.all_gather(src)),
                     ("all_to_all", lambda: group.all_to_all(
                         src.reshape(size, -1)))):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        sync()
        out[f"{name}_40MB_ms"] = (time.perf_counter() - t0) * 1e3 / REPS
    return out


def _hybrid(group) -> dict:
    """This rank's coordinates in a hybrid mesh over the group's ranks and,
    along each axis, the sum and min of the ranks and the gathered
    ranks."""
    from gossip_tpu_torch.parallel.multislice import make_hybrid_mesh
    size = group.size
    shape = (2, size // 2) if size % 2 == 0 else (1, size)
    mesh = make_hybrid_mesh(*shape, device=group.device)
    mine = torch.tensor([group.rank], dtype=torch.int64, device=group.device)
    out = {"shape": list(shape), "coords": list(mesh.coords)}
    for axis in ("inner", "outer"):
        sub = getattr(mesh, axis)
        out[axis] = {"sum": sub.all_reduce_sum(mine).tolist(),
                     "min": sub.all_reduce_min(mine).tolist(),
                     "gather": sub.all_gather(mine).tolist()}
    return out


def _uneven(group) -> list:
    """``all_to_all_single`` with uneven splits: rank r sends ``r + d +
    1`` words ``100 r + 10 d + j`` to rank d, so it receives ``s + r + 1``
    words from rank s."""
    import torch.distributed as dist
    dev, r, size = group.device, group.rank, group.size
    send = [r + d + 1 for d in range(size)]
    recv = [s + r + 1 for s in range(size)]
    x = torch.cat([100 * r + 10 * d + torch.arange(c, dtype=torch.int32,
                                                    device=dev)
                   for d, c in enumerate(send)])
    out = torch.empty(sum(recv), dtype=torch.int32, device=dev)
    dist.all_to_all_single(out, x, recv, send)
    return out.tolist()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gossip_tpu_torch.tools.collectives")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("collectives: needs a CUDA device (--device cpu for the "
              "CPU's gloo groups)", file=sys.stderr)
        return 1
    if a.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "--id=0"], capture_output=True,
            text=True, check=True).stdout.strip(), flush=True)
        groups = ((1, False), (2, True), (4, True), (1, True))
    else:
        groups = ((1, False), (2, False), (4, False))
    for size, shared in groups:
        backend, _ = GR.plan(size, a.device, shared)
        t0 = time.perf_counter()
        ranks = GR.launch(probe_rank, size, device=a.device,
                          shared_card=shared)
        print(json.dumps({"ranks": size, "backend": backend,
                          "device": a.device,
                          "launch_s": time.perf_counter() - t0,
                          "results": ranks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
