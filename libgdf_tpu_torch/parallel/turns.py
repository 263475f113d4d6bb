"""Time the distributed path of this checkout and of another one in turns,
on one card.

    python -m libgdf_tpu_torch.parallel.turns OTHER [--rounds 1]
    python -m libgdf_tpu_torch.parallel.turns --cards [--rounds 2]

OTHER is an unpacked copy of another commit (for the parent:
`git archive HEAD`) in a git-ignored directory such as `build/parent`.
Each turn is a process of its own that puts a checkout's root first on
sys.path and runs that checkout's own `chip_smoke.run_dist_path`: the
distributed pipeline at P = 8 in-process shards on cuda:0 over
chip_smoke.py's 10M-row Zipf fact table (plain, salted and broadcast into
dist_groupby), one warm-up and two timed runs (fact rows/s per variant
and the exchange share), then one torch.profiler profile of the path
(device busy share: the sum of device times over the wall, and for this
checkout the union of device intervals over the wall).

This checkout runs in three modes: `streams` (a stream per shard, as it
ships), `one-stream` (every shard on the caller's stream,
`chip_smoke.one_stream` patched over `Mesh.shard_streams`) and `bare`
(one stream, and the communicator's events, stream waits and
`record_stream` calls skipped: on one stream they order nothing, so this
is the cost of the cross-stream synchronization alone; it is not safe
with a stream per shard). Each round runs OTHER, streams, one-stream,
bare, bare, one-stream, streams, OTHER.

--cards (this checkout, one process that also starts the workers): the
same path at P = 8 on cuda:0 and, on a node of C >= 2 cards, on
make_mesh(C) (one shard per card) and make_mesh(2C) (shard s on
cuda:(s % C)), each after a warm-up, its shards' devices checked; then
across processes, chip_smoke.run_processes (W = 1, L = 8 on one card,
and W = C, L = 1 and W = 2, L = C / 2 where the node has the cards). Each
round runs them all in turns; every run is held to the single-table
pipeline on cuda:0 (chip_smoke.check_dist_path), the layout W = 1,
L = 8 also shard by shard to the first in-process P = 8 run.

It prints the card lines and one line per run; it exits 1 without CUDA.
"""
from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
MODES = ("streams", "one-stream", "bare")


def run_turn(root: str, label: str, mode: str) -> None:
    """One process: `root`'s chip_smoke.py and package, in `mode`."""
    sys.path[0] = root
    from unittest import mock

    import torch
    import chip_smoke as cs

    if not torch.cuda.is_available():
        sys.exit("turns: CUDA is not available")
    dev = torch.device("cuda", 0)
    patches = contextlib.ExitStack()
    if mode in ("one-stream", "bare"):
        from libgdf_tpu_torch.parallel import comm
        from libgdf_tpu_torch.parallel.mesh import Mesh
        patches.enter_context(mock.patch.object(Mesh, "shard_streams",
                                                cs.one_stream))
        if mode == "bare":
            exchange = comm.ThreadComm._exchange

            def bare_exchange(self, rank, value, tensors=False):
                got = exchange(self, rank, value)
                return [(v, None) for v in got] if tensors else got
            patches.enter_context(mock.patch.object(
                comm.ThreadComm, "_exchange", bare_exchange))
    with patches:
        data = cs.make_dist_data(cs.N_DIST, 0)
        cs.run_dist_path(data, dev)
        for i in range(2):
            res, times = cs.run_dist_path(data, dev)
            print(f"turn {label} run {i}: " + " ".join(
                f"{k}_rows_per_s={r / s:.4e}" for k, (r, s) in times.items())
                + " exchange_share " + "/".join(
                    f"{res[v]['exchange_share']:.4f}"
                    for v in ("plain", "salted", "broadcast")), flush=True)
        prof = cs.profile_op(lambda: cs.run_dist_path(data, dev))
    wall, busy = prof[0], prof[1]
    union = f" union_share={prof[5] / wall:.4f}" if len(prof) > 5 else ""
    print(f"turn {label} profile: wall_us={wall:.1f} device_busy_us="
          f"{busy:.1f} share={busy / wall:.4f}{union}", flush=True)


def run_cards(rounds: int) -> None:
    """The path on one card, over the node's cards and across processes,
    in turns."""
    sys.path[0] = str(ROOT)
    import torch
    import chip_smoke as cs

    cards = torch.cuda.device_count()
    data = cs.make_dist_data(cs.N_DIST, 0)
    ref, absref = cs.dist_reference(data, torch.device("cuda", 0))
    meshes = {"one card, P = 8": (torch.device("cuda", 0), cs.DIST_P)}
    if cards >= 2:
        meshes[f"{cards} cards, P = {cards}"] = (None, cards)
        meshes[f"{cards} cards, P = {2 * cards}"] = (None, 2 * cards)
    inproc = None
    for _ in range(rounds):
        for label, (device, shards) in meshes.items():
            cs.run_dist_path(data, device, shards)
            res, times = cs.run_dist_path(data, device, shards)
            devs = [str(t.device) for t in res["plain"]["result"].shards]
            want = [str(device or torch.device("cuda", s % cards))
                    for s in range(shards)]
            if devs != want:
                sys.exit(f"{label}: shards on {devs}")
            err, _ = cs.check_dist_path(res, ref, absref, label)
            if inproc is None:
                inproc = cs.inproc_rows(res)
            print(f"{label}: " + cs.dist_rates(times) + " exchange_share "
                  + "/".join(f"{res[v]['exchange_share']:.4f}"
                             for v in cs.VARIANTS)
                  + f" (every variant equals the single-table pipeline, "
                  f"sum error {err}; shards on {devs})", flush=True)
            del res
        cs.run_processes(ref, absref, inproc)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", nargs="?")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--cards", action="store_true")
    ap.add_argument("--turn", nargs=3, metavar=("ROOT", "LABEL", "MODE"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn:
        run_turn(*args.turn)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("turns: CUDA is not available", file=sys.stderr)
        return 1
    print("; ".join(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()), flush=True)
    if args.cards:
        run_cards(args.rounds)
        return 0
    other = str(Path(args.other).resolve())
    order = [(other, "other", "streams")] + [
        (str(ROOT), m, m) for m in MODES]
    order += order[::-1]
    for _ in range(args.rounds):
        for root, label, mode in order:
            subprocess.run([sys.executable, __file__, "--turn", root, label,
                            mode], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
